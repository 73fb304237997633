"""Counter/gauge registry + live TransportStats snapshots
(``repro.obs.metrics``).

A launcher registers every live transport backend under a name
(:meth:`MetricsRegistry.track`); :meth:`MetricsRegistry.snapshot` then
renders the registry into one JSON-safe dict — counters, gauges, and the
full :class:`~repro_torch.transport.base.TransportStats` of each tracked
backend, its ``by_tag`` splits and the packet router's overflow counter
included.  Snapshots read the *live* stats objects, so the numbers are the
counters the netsim predictions are held against.

Drift gauges turn the ``--validate-sim`` 2x gate into a sampled metric:
:meth:`MetricsRegistry.drift` records the symmetric prediction ratio
``max(pred/meas, meas/pred)`` — computed by the same
:func:`repro_torch.netsim.calibrate.drift_ratio` that ``validate`` gates
on, so the gauge and the gate cannot disagree — and
:meth:`MetricsRegistry.drift_from_records` samples a whole calibration-
record set, returning the worst ratio (== ``validate``'s).
"""

from __future__ import annotations


def _num(x):
    """A concrete number for a counter: the packet router's overflow is a
    ``(P,)`` int32 tensor on the transport's device, summed over the ranks
    and read with one ``int()`` (one host sync, at snapshot time only);
    None stays None."""
    if x is None:
        return None
    if hasattr(x, "sum"):
        x = x.sum()
    return int(x)


class MetricsRegistry:
    """Process-level metric store: monotonic counters, point-in-time
    gauges, and live transport references snapshotted on demand."""

    def __init__(self):
        self.counters: dict = {}
        self.gauges: dict = {}
        self._transports: dict = {}  # name -> live Transport

    # ---------------------------------------------------------- writers

    def inc(self, name: str, delta=1):
        self.counters[name] = self.counters.get(name, 0) + delta

    def gauge(self, name: str, value: float):
        self.gauges[name] = float(value)

    def track(self, name: str, transport):
        """Register a live transport; its stats are read at snapshot time
        (re-tracking a name replaces the previous instance)."""
        self._transports[name] = transport

    # ------------------------------------------------------------ drift

    def drift(self, name: str, *, predicted: float, measured: float) -> float:
        """Record ``drift/<name>`` = the symmetric prediction ratio (the
        ``--validate-sim`` gate's quantity; 1.0 = perfect)."""
        from ..netsim.calibrate import drift_ratio

        ratio = drift_ratio(predicted, measured)
        self.gauge(f"drift/{name}", ratio)
        return ratio

    def drift_from_records(self, label: str, records, *, model) -> float:
        """Sample drift gauges from netsim calibration records under a
        fitted :class:`~repro_torch.netsim.model.LinkModel`: one gauge per
        record (``drift/<label>/<name>``) plus the worst ratio under
        ``drift/<label>`` — the exact worst ratio
        :func:`repro_torch.netsim.calibrate.validate` computes for the same
        records and model."""
        worst = 1.0
        for i, r in enumerate(records):
            ratio = self.drift(f"{label}/{r.get('name') or i}",
                               predicted=model.predict(r), measured=r["seconds"])
            worst = max(worst, ratio)
        self.gauge(f"drift/{label}", worst)
        return worst

    # --------------------------------------------------------- snapshot

    @staticmethod
    def stats_dict(stats) -> dict:
        """One TransportStats as a JSON-safe dict (the snapshot's
        per-transport payload; ``by_tag`` copied, ``overflow`` summed over
        the ranks)."""
        return {
            "steps": int(stats.steps),
            "bytes": int(stats.bytes_moved),
            "overflow": _num(stats.overflow),
            "by_tag": {
                tag: {"steps": int(e["steps"]), "bytes": int(e["bytes"])}
                for tag, e in stats.by_tag.items()
            },
        }

    def snapshot(self) -> dict:
        """The whole registry as one JSON-safe dict."""
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "transports": {
                name: {"name": getattr(t, "name", "") or type(t).__name__,
                       **self.stats_dict(t.stats)}
                for name, t in self._transports.items()
            },
        }

    def clear(self):
        self.counters.clear()
        self.gauges.clear()
        self._transports.clear()


#: the process-default registry the launchers write into
REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY
