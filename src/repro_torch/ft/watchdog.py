"""Straggler watchdog and checkpoint/restart driver (``repro.ft.watchdog``),
each emitting its ``ft.*`` trace event while tracing is on."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..obs import trace as obs


@dataclass
class StepWatchdog:
    """EMA step-time monitor: flags a straggler (a step slower than
    ``threshold`` times the running mean), recorded in ``events``."""

    threshold: float = 3.0
    alpha: float = 0.1
    ema: float | None = None
    events: list = field(default_factory=list)
    _last: float | None = None

    def start(self):
        self._last = time.monotonic()

    def lap(self, step: int) -> bool:
        """Close ``step``'s interval; True when it was a straggler.  A lap
        before :meth:`start` only arms the timer."""
        now = time.monotonic()
        if self._last is None:
            self._last = now
            return False
        dt = now - self._last
        self._last = now
        slow = self.ema is not None and dt > self.threshold * self.ema
        if slow:
            self.events.append({"step": step, "dt": dt, "ema": self.ema})
            if obs.TRACING:
                obs.emit("ft.straggler", tag="ft", step=step, dt=dt, ema=self.ema,
                         threshold=self.threshold)
        self.ema = dt if self.ema is None else (1 - self.alpha) * self.ema + self.alpha * dt
        return slow


def run_with_restarts(make_loop, checkpointer, state_like, *, max_restarts: int = 2):
    """Run ``make_loop(start_state, start_step) -> final_state`` with
    checkpoint/restart: a raise is a node failure, after which the latest
    checkpoint is restored (in the structure of ``state_like``, as host
    numpy arrays) and the loop resumes from its step.  Returns
    ``(final_state, n_restarts)``; the failure after ``max_restarts``
    restarts propagates."""
    restarts = 0
    state, step = state_like, 0
    while True:
        try:
            return make_loop(state, step), restarts
        except Exception:  # noqa: BLE001 -- any failure of the loop is a node failure
            restarts += 1
            if restarts > max_restarts:
                raise
            state, manifest = checkpointer.restore(state_like)
            step = manifest["step"]
            if obs.TRACING:
                obs.emit("ft.restart", tag="ft", restart=restarts, resume_step=step,
                         max_restarts=max_restarts)
