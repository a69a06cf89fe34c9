"""Mid-rise ADC quantizer (§IV-B-1) — counterpart of
``repro/analog/adc.py``'s ``adc_quantize``."""
from __future__ import annotations

import torch


def adc_quantize(v: torch.Tensor, bits: int,
                 full_scale: float) -> torch.Tensor:
    """Mid-rise uniform quantizer over [-full_scale, +full_scale].
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    levels = 2 ** bits
    step = 2.0 * full_scale / levels
    q = torch.round(v / step)
    q = torch.clamp(q, -(levels // 2), levels // 2 - 1)
    return q * step
