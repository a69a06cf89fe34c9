"""ADC quantization and the integrator's retention model (§IV-B-1,
eqs. 8-10) — counterpart of ``repro/analog/adc.py``.

The shared high-speed ADC (1.28 GSps, ~2 ns a channel) scans all
bitlines of a crossbar; transmission gates isolate the integrator during
the hold phase, so its droop comes only from the Op-Amp's bias current
and the capacitor's dielectric leakage. The droop functions are plain
floats: they reproduce the paper's < 0.1 LSB budget check.
"""
from __future__ import annotations

import math

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


def integrator_droop(v_int: float, t_conv: float, tau: float) -> float:
    """ΔV = V_int · exp(−T_conv/τ) (eq. 8); returns the *droop* V − V'."""
    return v_int * (1.0 - math.exp(-t_conv / tau))


def droop_leakage(v_int: float, t_conv: float, r_leak: float,
                  c_f: float) -> float:
    """ΔV_l ≈ V_int · T_conv / (R_leak · C_f) (eq. 9, hold phase)."""
    return v_int * t_conv / (r_leak * c_f)


def droop_bias(i_b: float, t_conv: float, c_f: float) -> float:
    """ΔV_b = I_b · T_conv / C_f (eq. 10, the Op-Amp's input bias)."""
    return i_b * t_conv / c_f


def total_hold_droop(v_int: float = 0.5, t_conv: float = 200e-9,
                     c_f: float = 2e-12, i_b: float = 50e-12,
                     r_leak: float = 10e9) -> float:
    """Worst-case droop over one ADC scan with the paper's constants:
    < 10.5 µV (< 0.1 LSB) over 200 ns with C_f = 2 pF, I_b < 50 pA,
    R_leak > 10 GΩ."""
    return droop_leakage(v_int, t_conv, r_leak, c_f) \
        + droop_bias(i_b, t_conv, c_f)
