"""netsim: link-level network simulation and cost-model autotuning
(``repro.netsim``).

The paper's evaluation is a performance model made measurable: latency
against hops (Tab. 3), injection rate against polling stickiness R
(Tab. 4), bandwidth against message size (Fig. 9).  This package makes
that model executable:

* :mod:`.model` — :class:`LinkModel`, the analytic per-link cost model,
  its defaults fitted on an H100 (``chip_smoke.py`` phase 25);
* :mod:`.sim` — a tick-based link simulator replaying message schedules
  over any Topology and RouteTable with FIFO depths, R-sticky arbitration
  and backpressure;
* :mod:`.schedule` — schedule builders mirroring the transports, exact
  ``TransportStats`` prediction, and the serving decode step's per-tag
  ledger (``predict_decode_step_stats``) and a training step's
  (``predict_train_step_stats``);
* :mod:`.calibrate` — fit a LinkModel from measured runs and gate the
  drift between prediction and measurement;
* :mod:`.tune` — the autotuner and its cached :class:`TuningTable` s, which
  ``plan="auto"`` consults.

numpy and pure Python: no torch is needed to import it.
"""

from .calibrate import fit, record, record_from_stats, validate
from .model import WIRE_AXIS_ELEMS, LinkModel, clamp_chunks, int8_wire_nbytes
from .schedule import (
    HALO_DIRECTIONS,
    collective_rounds,
    compressed_reduce_scatter_rounds,
    halo_pairs,
    halo_rounds,
    halo_slab_elems,
    p2p_messages,
    packet_bounds,
    packet_n_packets,
    predict_channel_stats,
    predict_decode_step_stats,
    predict_halo_stats,
    predict_halo_time,
    predict_train_step_stats,
    predict_transport_stats,
    ring_perm_round,
)
from .sim import Message, SimReport, simulate, simulate_rounds
from .tune import (
    DEFAULT_PLAN,
    SIZE_GRID,
    WIRES,
    Plan,
    TuningTable,
    autotune,
    score_plan,
    tuned_plan,
    tuning_table_for,
)

__all__ = [
    "LinkModel",
    "WIRE_AXIS_ELEMS",
    "int8_wire_nbytes",
    "Message",
    "SimReport",
    "simulate",
    "simulate_rounds",
    "HALO_DIRECTIONS",
    "collective_rounds",
    "compressed_reduce_scatter_rounds",
    "halo_pairs",
    "halo_rounds",
    "halo_slab_elems",
    "p2p_messages",
    "packet_bounds",
    "packet_n_packets",
    "predict_channel_stats",
    "predict_decode_step_stats",
    "predict_halo_stats",
    "predict_halo_time",
    "predict_train_step_stats",
    "predict_transport_stats",
    "ring_perm_round",
    "fit",
    "record",
    "record_from_stats",
    "validate",
    "DEFAULT_PLAN",
    "Plan",
    "SIZE_GRID",
    "WIRES",
    "TuningTable",
    "autotune",
    "score_plan",
    "tuned_plan",
    "tuning_table_for",
]
