"""Fault tolerance (``repro.ft``): the straggler watchdog, the
checkpoint/restart driver and the elastic re-mesh."""

from .elastic import best_mesh_shape, elastic_restart_plan, reshard_state
from .watchdog import StepWatchdog, run_with_restarts

__all__ = ["StepWatchdog", "best_mesh_shape", "elastic_restart_plan", "reshard_state",
           "run_with_restarts"]
