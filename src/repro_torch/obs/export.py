"""Chrome-trace / Perfetto export of tracer events (``repro.obs.export``).

Renders the stable event schema of :mod:`repro_torch.obs.trace` into the Chrome
trace-event JSON format (``{"traceEvents": [...]}``, loadable in Perfetto
or chrome://tracing) with a fixed lane layout:

* ``pid 1`` — **measured: ranks**: one thread lane per rank (events with a
  ``rank``: the launcher's ``run.step`` slices), plus a ``host`` lane for
  rank-less schedule events (the channel, halo, router and tuner events,
  which the rank-stacked port stages on the host for every rank at once);
* ``pid 2`` — **measured: links**: one lane per directed link, fed by
  events carrying ``attrs["link"] = [a, b]``;
* ``pid 3`` / ``pid 4`` — the same two groups for **netsim (predicted)**
  events (``kind`` prefixed ``sim.``), so a predicted timeline rendered by
  :func:`sim_report_events` overlays the measured one in a single viewer —
  the paper's §5.4.2 overlap window, made visible.

Events with ``attrs["dur"]`` (seconds) become complete ("X") slices; the
rest become instants ("i").  Every viewer event embeds the source schema
event verbatim under ``args["event"]``, which is what makes
:func:`parse_chrome_trace` lossless (export → parse → identical, asserted
by ``tests/test_torch_obs.py``).  The pids, the lane layout and
:data:`HOST_TID` are the reference's, so the two packages' documents of
one event list are equal.
"""

from __future__ import annotations

import json

#: fixed process ids of the lane groups (stable across exports)
PID_RANKS = 1
PID_LINKS = 2
PID_SIM_RANKS = 3
PID_SIM_LINKS = 4

#: tid of the host lane inside a rank group (after any real rank tid)
HOST_TID = 10**6

_GROUP_NAMES = {
    PID_RANKS: "measured: ranks",
    PID_LINKS: "measured: links",
    PID_SIM_RANKS: "netsim (predicted): ranks",
    PID_SIM_LINKS: "netsim (predicted): links",
}


def _is_sim(ev) -> bool:
    return str(ev.get("kind", "")).startswith("sim.")


def _lane_of(ev, link_tids: dict):
    """(pid, tid) of one schema event under the fixed lane layout."""
    link = ev.get("attrs", {}).get("link")
    sim = _is_sim(ev)
    if link is not None:
        key = (int(link[0]), int(link[1]))
        if key not in link_tids:
            link_tids[key] = len(link_tids)
        return (PID_SIM_LINKS if sim else PID_LINKS), link_tids[key]
    if ev.get("rank") is not None:
        return (PID_SIM_RANKS if sim else PID_RANKS), int(ev["rank"])
    return (PID_SIM_RANKS if sim else PID_RANKS), HOST_TID


def _meta(pid, tid, what, name):
    return {"ph": "M", "pid": pid, "tid": tid, "name": what,
            "args": {"name": name}}


def chrome_events(events) -> list:
    """Viewer events (no metadata) for a list of schema events."""
    link_tids: dict = {}
    out = []
    for ev in events:
        pid, tid = _lane_of(ev, link_tids)
        attrs = ev.get("attrs", {})
        dur = attrs.get("dur")
        rec = {
            "name": ev["kind"],
            "cat": ev.get("tag") or "event",
            "pid": pid,
            "tid": tid,
            "ts": float(ev["ts"]) * 1e6,  # chrome trace time unit: us
            "args": {"event": ev},
        }
        if dur is not None:
            rec["ph"] = "X"
            rec["dur"] = float(dur) * 1e6
        else:
            rec["ph"] = "i"
            rec["s"] = "t"
        out.append(rec)
    return out


def to_chrome_trace(events) -> dict:
    """Full Chrome-trace document: viewer events + lane-naming metadata."""
    body = chrome_events(events)
    lanes = {}  # (pid, tid) -> label
    link_tids: dict = {}
    for ev in events:
        pid, tid = _lane_of(ev, link_tids)
        if (pid, tid) not in lanes:
            link = ev.get("attrs", {}).get("link")
            if link is not None:
                lanes[(pid, tid)] = f"link {int(link[0])}->{int(link[1])}"
            elif ev.get("rank") is not None:
                lanes[(pid, tid)] = f"rank {int(ev['rank'])}"
            else:
                lanes[(pid, tid)] = "host"
    meta = [
        _meta(pid, 0, "process_name", name)
        for pid, name in _GROUP_NAMES.items()
        if any(p == pid for p, _ in lanes)
    ]
    meta.extend(
        _meta(pid, tid, "thread_name", label)
        for (pid, tid), label in sorted(lanes.items())
    )
    return {"traceEvents": meta + body, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, events) -> int:
    """Write the trace document to ``path``; returns the event count."""
    events = list(events)
    with open(path, "w") as f:
        json.dump(to_chrome_trace(events), f, indent=1)
    return len(events)


def parse_chrome_trace(doc) -> list:
    """Recover the schema events from an exported document (lossless:
    every viewer event carries its source event under ``args["event"]``)."""
    if isinstance(doc, str):
        doc = json.loads(doc)
    return [
        rec["args"]["event"]
        for rec in doc.get("traceEvents", [])
        if rec.get("ph") != "M"
    ]


def lane_count(doc, pid) -> int:
    """Distinct thread lanes of one process group in a trace document."""
    if isinstance(doc, str):
        doc = json.loads(doc)
    return len({
        rec["tid"] for rec in doc.get("traceEvents", [])
        if rec.get("pid") == pid and rec.get("ph") != "M"
    })


# ---------------------------------------------------------------------------
# netsim adapter: SimReport -> schema events (the predicted overlay)
# ---------------------------------------------------------------------------


def directed_links(topo) -> list:
    """Every directed link of a topology, sorted (the link-lane universe)."""
    return sorted(
        (a, int(b)) for a, nbrs in enumerate(topo.links) for b in nbrs
    )


def sim_report_events(topo, reports, *, model=None, wire: str = "raw",
                      t0: float = 0.0) -> list:
    """Render barrier-separated :class:`~repro_torch.netsim.sim.SimReport` rounds
    (run with ``simulate(..., trace=True)``) into schema events.

    One ``sim.lane`` declaration per directed topology link anchors a lane
    for *every* link — idle links included, so the viewer's link-lane count
    always equals the topology's directed link count).  Each recorded move
    becomes one ``sim.flit`` slice whose duration is the round's tick
    period under ``model`` (the card's fit unless given; the same
    :meth:`~repro_torch.netsim.model.LinkModel.hop_time_wire` conversion
    every predicted time in the port uses); deliveries additionally emit a
    ``sim.deliver`` instant on the destination rank's lane.  Rounds are
    laid out back to back starting at ``t0`` seconds.
    """
    from ..netsim.model import LinkModel

    model = model or LinkModel()
    events = [
        {"ts": float(t0), "rank": None, "kind": "sim.lane", "tag": None,
         "port": None, "attrs": {"link": [a, b]}}
        for a, b in directed_links(topo)
    ]
    base = float(t0)
    for rep in reports:
        dt = model.hop_time_wire(rep.flit_bytes_max, wire)
        for tick, a, b, msg, delivered in rep.moves:
            ts = base + tick * dt
            events.append({
                "ts": ts, "rank": None, "kind": "sim.flit", "tag": None,
                "port": None,
                "attrs": {"link": [int(a), int(b)], "dur": dt,
                          "msg": int(msg)},
            })
            if delivered:
                events.append({
                    "ts": ts + dt, "rank": int(b), "kind": "sim.deliver",
                    "tag": None, "port": None, "attrs": {"msg": int(msg)},
                })
        base += rep.ticks * dt
    return events
