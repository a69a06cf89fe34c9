"""Weighted-Bit Streaming (WBS) numerical model — §V-A, eqs. (11)-(19).

Counterpart of ``repro/analog/wbs.py``. Digital inputs are decomposed
sign-magnitude into n_b bit planes; plane k is weighted by the
memristor-ratio gain 2^{-k} and the integrator sums the gain-weighted
plane products, which equals the fixed-point product when the ratios are
ideal. The per-plane ratio noise is drawn from a :mod:`repro_torch.prng`
key, as the reference draws it from a ``jax.random`` key.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class WBSSpec:
    n_bits: int = 8              # input precision streamed bit-by-bit
    gain_sigma: float = 0.0      # per-plane (M_f/M_i) ratio variability
    adc_bits: Optional[int] = 8  # fused output ADC; None = no quantization
    adc_range: float = 4.0       # symmetric ADC full-scale (logical units)


def quantize_signed(x: torch.Tensor, n_bits: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sign-magnitude quantization of x∈[-1,1] to (sign int8 ∈ {-1,0,+1},
    code uint8 ∈ [0, 2^n−1]). ``torch.sign(0) == 0`` like ``jnp.sign``."""
    top = 2 ** n_bits - 1
    mag = torch.clamp(torch.round(torch.abs(x) * top), 0, top)
    return torch.sign(x).to(torch.int8), mag.to(torch.uint8)


def bit_planes(code: torch.Tensor, n_bits: int) -> torch.Tensor:
    """(…,) uint → (n_bits, …) float bit planes, MSB first (k=1 ⇒ 2^{-1})."""
    shifts = torch.arange(n_bits - 1, -1, -1, device=code.device)
    c = code.to(torch.int32)[None]
    planes = (c >> shifts.reshape(-1, *([1] * code.ndim))) & 1
    return planes.to(torch.float32)


def ideal_gains(n_bits: int, device=None) -> torch.Tensor:
    """(M_f/M_i)_k = 2^{-k}, k = 1..n_b (eq. 17), MSB first."""
    k = torch.arange(1, n_bits + 1, dtype=torch.float32, device=device)
    return torch.pow(2.0, -k)


def wbs_vmm(x: torch.Tensor, w: torch.Tensor, spec: WBSSpec,
            key=None) -> torch.Tensor:
    """WBS crossbar VMM: y = Σ_k g_k (B_k ⊙ s) @ W, rescaled by
    2^nb/(2^nb − 1), then the fused ADC. x (..., n_in) in [-1, 1], w
    (n_in, n_out); ``key`` (a :mod:`repro_torch.prng` key) draws the
    per-plane gain noise when ``spec.gain_sigma > 0``."""
    sign, code = quantize_signed(x, spec.n_bits)
    planes = bit_planes(code, spec.n_bits)                 # (nb, ..., n_in)
    signed_planes = planes * sign.to(torch.float32)[None]
    gains = ideal_gains(spec.n_bits)
    if key is not None and spec.gain_sigma > 0:
        from repro_torch import prng
        gains = gains * (1.0 + spec.gain_sigma
                         * prng.normal(key, gains.shape))
    gains = gains.to(x.device)
    y = torch.einsum("k,k...i,io->...o", gains, signed_planes, w)
    y = y * (2.0 ** spec.n_bits / (2.0 ** spec.n_bits - 1.0))
    if spec.adc_bits is not None:
        from repro_torch.analog.adc import adc_quantize
        y = adc_quantize(y, spec.adc_bits, spec.adc_range)
    return y
