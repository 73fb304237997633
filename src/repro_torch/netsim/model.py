"""The analytic link cost model (``repro.netsim.model``): paper Tab. 3 /
Tab. 4 / Fig. 9 quantities.

One :class:`LinkModel` answers every "how long does this schedule take"
question of the port: the simulator (:mod:`.sim`) converts ticks to seconds
through it, the autotuner (:mod:`.tune`) scores candidate plans with it,
and the stencil app prints its model column from it.

Quantities, mapped to the paper:

* ``hop_latency`` — the cost of one schedule tick (Tab. 3: latency = hops x
  per-hop cost).  On the rank-stacked runtime a tick is one permute of the
  rank stack, so this is mostly the host's cost of issuing it;
* ``link_bw`` — bytes a second of one rank's payload through a tick
  (Fig. 9's plateau);
* ``injection_base`` — fixed overhead a transfer (opening, dispatch);
* ``switch_cycles`` — the router's polling-stickiness cost (Tab. 4): with
  stickiness R the arbiter spends ``switch_cycles / R`` extra ticks a
  packet acquiring a new input FIFO;
* ``quant_latency`` — the int8 wire's codec pass a tick
  (``transport/compressed.py``);
* ``unfused_add_latency`` — what the static backend pays a reduction tick
  for the separate add that the fused backend's kernel A folds into the
  receive.

The field defaults are not the reference's (a TPU's ICI figures): they are
the fit of ``chip_smoke.py`` phase 25 on an H100 (see the comment on the
fields).  numpy only: importable anywhere, no torch needed.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

#: scale-block size of the int8 compressed wire: one float32 scale per
#: ``WIRE_AXIS_ELEMS`` payload elements (``transport/compressed.py``)
WIRE_AXIS_ELEMS = 256


def int8_wire_nbytes(n_elems: int, axis_elems: int = WIRE_AXIS_ELEMS) -> int:
    """Exact wire bytes of ``n_elems`` float32 payload elements on the int8
    wire: a byte an element and a 4-byte scale a block.  The one source of
    the transport's accounting and the simulator's prediction."""
    n_elems = int(n_elems)
    axis_elems = max(int(axis_elems), 1)
    n_blocks = -(-n_elems // axis_elems) if n_elems else 0
    return n_elems + 4 * n_blocks


def clamp_chunks(n_chunks: int, leading_dim: int) -> int:
    """Largest divisor of ``leading_dim`` <= the chunk-count hint (the
    pipelined transports require n_chunks | leading dim; hints are never a
    correctness constraint)."""
    n = max(1, min(int(n_chunks), int(leading_dim)))
    while leading_dim % n:
        n -= 1
    return n


@dataclass(frozen=True)
class LinkModel:
    """Per-link cost parameters; times in seconds, sizes in bytes.

    The defaults are the card's fit: ``scripts/fit_link_model.py`` (which
    runs ``chip_smoke.py`` phases 1, 5, 9, 22 and 25) on an "NVIDIA H100
    80GB HBM3, 700.00 W", the run recorded in PERF.md §6.
    ``hop_latency``, ``link_bw`` and ``injection_base`` are :meth:`fit`'s
    over the static wire's Tab. 3 and Fig. 9 transfers on the 8-rank bus;
    ``unfused_add_latency`` comes from phase 5, ``quant_latency`` from
    phase 22 and ``switch_cycles`` from phase 9.  Refit with that script."""

    hop_latency: float = 9.421724227705136e-05       # s a tick (host-bound)
    link_bw: float = 144693356599.58917              # B/s of one rank's payload
    injection_base: float = 4.172488018705428e-05    # s a transfer
    switch_cycles: float = 0.48359240069084564       # ticks a packet at R = 1
    quant_latency: float = 3.8498484248666695e-05    # s a tick on the int8 wire
    unfused_add_latency: float = 2.2705532142857072e-05  # s a static reduction tick

    # -- primitive costs ---------------------------------------------------

    def serialization(self, nbytes: float) -> float:
        """Wire time of ``nbytes`` through one link (Fig. 9 plateau)."""
        return nbytes / self.link_bw

    def hop_time(self, flit_bytes: float) -> float:
        """One pipeline tick: forward a ``flit_bytes`` chunk one hop."""
        return self.hop_latency + self.serialization(flit_bytes)

    # -- wire formats --------------------------------------------------------

    def wire_bytes(self, nbytes: float, wire: str = "raw") -> float:
        """Bytes serialized for an ``nbytes`` float32 payload under the wire
        format (``"raw"`` | ``"int8"``)."""
        if wire == "raw":
            return float(nbytes)
        if wire == "int8":
            return float(int8_wire_nbytes(max(int(round(nbytes / 4.0)), 1)))
        raise ValueError(f"unknown wire format {wire!r}")

    def hop_time_wire(self, flit_bytes: float, wire: str = "raw") -> float:
        """One pipeline tick under a wire format: the raw tick, or the
        compressed bytes plus the codec pass."""
        if wire == "raw":
            return self.hop_time(flit_bytes)
        return (self.hop_latency + self.quant_latency
                + self.serialization(self.wire_bytes(flit_bytes, wire)))

    def injection_cycles(self, R: int) -> float:
        """Router ticks a packet as a function of polling stickiness R
        (Tab. 4: falling toward 1 as R grows)."""
        return 1.0 + self.switch_cycles / max(int(R), 1)

    # -- transfer-level costs ------------------------------------------------

    def p2p_time(self, nbytes: float, hops: int, n_chunks: int = 1) -> float:
        """Chunk-pipelined routed transfer: ``n_chunks + hops - 1`` ticks of
        one chunk each (Fig. 9 / Tab. 3 by construction)."""
        n_chunks = max(int(n_chunks), 1)
        if hops == 0:
            return 0.0
        ticks = n_chunks + max(int(hops), 0) - 1
        return self.injection_base + ticks * self.hop_time(nbytes / n_chunks)

    def staged_time(self, nbytes: float, hops: int) -> float:
        """Store-and-forward whole-message transfer: the full message
        completes each hop before the next (the host-staged path)."""
        return self.injection_base + hops * self.hop_time(nbytes)

    def bandwidth(self, nbytes: float, hops: int, n_chunks: int = 1) -> float:
        """Effective p2p bandwidth in B/s."""
        t = self.p2p_time(nbytes, hops, n_chunks)
        return nbytes / t if t > 0 else float("inf")

    # -- overlap window (the apps layer's pipelined steps) -------------------

    def overlapped_step_time(self, compute_s: float, comm_s: float) -> float:
        """One pipelined step: the exchange streams during the compute, so
        the step costs the longer of the two."""
        return max(compute_s, comm_s)

    def serial_step_time(self, compute_s: float, comm_s: float) -> float:
        """The non-overlapped step: the exchange, then the compute."""
        return compute_s + comm_s

    # -- construction --------------------------------------------------------

    def with_params(self, **kw) -> "LinkModel":
        return replace(self, **kw)

    # -- calibration ---------------------------------------------------------

    @staticmethod
    def fit(records, *, base: "LinkModel | None" = None):
        """Least-squares fit of (hop_latency, link_bw, injection_base) from
        schedule-cost records: dicts with ``steps`` and ``bytes`` (the
        :class:`~repro_torch.transport.base.TransportStats` convention) and
        measured ``seconds``.  Solves ``t = injection_base + steps *
        hop_latency + bytes / bw`` weighted by 1/t (relative error); a
        negative coefficient takes ``base``'s value (the default model's
        unless given)."""
        base = base or LinkModel()
        recs = list(records)
        if not recs:
            return base
        A = np.array([[1.0, r["steps"], r["bytes"]] for r in recs], float)
        t = np.array([r["seconds"] for r in recs], float)
        w = 1.0 / np.maximum(t, 1e-12)
        coef, *_ = np.linalg.lstsq(A * w[:, None], t * w, rcond=None)
        inj, hop, inv_bw = (float(c) for c in coef)
        if inj < 0:
            inj = 0.0
        if hop <= 0:
            hop = base.hop_latency
        bw = 1.0 / inv_bw if inv_bw > 0 else base.link_bw
        return base.with_params(injection_base=inj, hop_latency=hop, link_bw=bw)

    def predict(self, record) -> float:
        """Predicted seconds for one schedule-cost record (keys of
        :meth:`fit`)."""
        return (self.injection_base + record["steps"] * self.hop_latency
                + self.serialization(record["bytes"]))
