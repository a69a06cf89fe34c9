"""The per-step chip meter shared by the forward and the serve engine —
counterpart of ``_meter_chip_step`` in ``repro/core/continual.py``. The
continual-learning trainer itself is the next slice's work."""
from __future__ import annotations

from repro_torch.telemetry import meters


def _meter_chip_step(backend, cfg, B: int) -> None:
    """Per-time-step chip activity the software forward does not execute
    but the streaming hardware does (metered ×T by the enclosing scaled
    scope): the readout crossbar evaluates ŷᵗ every step (eq. 3) and the
    λ-interpolator blends every candidate state."""
    tele = backend.telemetry
    if not tele.enabled:
        return
    spec = backend.spec
    deltas = {f"{meters.MACS}/w_o": B * cfg.n_h * cfg.n_y,
              f"{meters.VMM_ROWS}/w_o": B,
              f"{meters.INTERP}/h": B * cfg.n_h,
              meters.SAMPLE_STEPS: B}
    if spec.input_bits:
        deltas[f"{meters.BIT_PULSES}/w_o"] = B * cfg.n_h * spec.input_bits
        deltas[f"{meters.WBS_PHASES}/w_o"] = B * spec.input_bits
    if spec.adc_bits is not None:
        deltas[f"{meters.ADC_CONVERSIONS}/out"] = B * cfg.n_y
    tele.record(deltas)
