"""Calibration and prediction-against-measurement validation
(``repro.netsim.calibrate``).

A measurement runs a schedule whose cost in steps and bytes is known
exactly (read from a backend's :class:`~repro_torch.transport.base.
TransportStats`, or predicted by :func:`~repro_torch.netsim.schedule.
predict_transport_stats`) and times it.  Each (steps, bytes, seconds)
record is one calibration point; :meth:`LinkModel.fit` turns a set of them
into a model, and :func:`validate` asserts that the model predicts every
measurement within a factor (the ``--validate-sim`` drift gate: if the
simulator's schedule stopped matching what runs, the residuals pass the
gate).  ``chip_smoke.py`` phase 25 fits the port's default model this way.
"""

from __future__ import annotations

from .model import LinkModel


def drift_ratio(predicted: float, measured: float) -> float:
    """Symmetric prediction-against-measurement ratio (1.0 = perfect)."""
    pred = max(float(predicted), 1e-12)
    meas = max(float(measured), 1e-12)
    return max(pred / meas, meas / pred)


def record(steps: int, nbytes: float, seconds: float, name: str = ""):
    """One calibration point, in TransportStats' schedule-cost convention."""
    return {
        "steps": int(steps),
        "bytes": float(nbytes),
        "seconds": float(seconds),
        "name": name,
    }


def record_from_stats(stats, seconds: float, name: str = ""):
    """Calibration point straight from a backend's counters (delegates to
    :meth:`TransportStats.record`, the transport-side hook)."""
    return stats.record(seconds, name)


def fit(records, *, base: LinkModel | None = None) -> LinkModel:
    return LinkModel.fit(records, base=base)


def validate(records, *, tol: float = 2.0, label: str = "netsim",
             model: LinkModel | None = None):
    """Fit (unless ``model`` is given) and assert every prediction is within
    ``tol``x of its measurement.  Returns (model, worst_ratio)."""
    records = list(records)
    m = model if model is not None else fit(records)
    worst = 1.0
    lines = []
    for r in records:
        pred = max(m.predict(r), 1e-12)
        meas = max(r["seconds"], 1e-12)
        ratio = drift_ratio(pred, meas)
        worst = max(worst, ratio)
        lines.append(
            f"  {r.get('name', '?'):<32} measured={meas * 1e6:9.1f}us "
            f"predicted={pred * 1e6:9.1f}us ratio={ratio:5.2f}"
        )
    report = "\n".join(lines)
    assert worst <= tol, (
        f"[{label}] simulator/measurement drift: worst ratio {worst:.2f} "
        f"exceeds {tol:.1f}x\n{report}"
    )
    print(f"# [{label}] validate-sim OK: worst prediction ratio "
          f"{worst:.2f}x (<= {tol:.1f}x)\n{report}")
    return m, worst
