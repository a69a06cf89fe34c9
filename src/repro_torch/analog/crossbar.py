"""Memristive crossbar model (§IV-B-1) — counterpart of
``repro/analog/crossbar.py``.

Each synaptic weight is the conductance difference between a tunable
device and a fixed reference device biased at the midpoint of the
resistance window (R_on = 2 MΩ, R_off = 20 MΩ, §V-B):

    w_ji ∝ 1/M_ji − 1/M_ri                                   (eq. 7)

Non-idealities: 10 % cycle-to-cycle (read) variability, 10 %
device-to-device write variation, conductance clipping to the physical
window, optional finite write resolution (Ziksa pulse quantization), and
for the G⁺/G⁻ pairs programming variability and retention drift.

Noise is drawn from :mod:`repro_torch.prng` keys on the reference's key
chains. Conductances are ~5e-8 to 5e-7 S, so the last bit of a constant
reaches every weight: each scalar the reference writes as a Python float
(which JAX folds as a weakly typed float32) is computed here in Python,
rounded once to float32 (:func:`f32`) and applied in the reference's
operation order. The fleet's per-chip overrides (``prog_sigma=``,
``write_sigma=``, ``drift_rate=``) are float32 scalars (0-d tensors on
the pair's device, or numbers rounded to float32) that replace the
spec's value; with an override the noise or drift is applied even at a
zero value, as the reference's traced overrides are.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import prng


def f32(x: float) -> float:
    """``x`` rounded once to float32, as a Python float."""
    return float(np.float32(x))


def _scalar(x):
    """A float32 scalar operand: a tensor as it is, a number rounded
    once to float32."""
    return x if isinstance(x, torch.Tensor) else f32(x)


@dataclasses.dataclass(frozen=True)
class CrossbarSpec:
    r_on: float = 2e6            # Ω  (fully-SET resistance)
    r_off: float = 20e6          # Ω  (fully-RESET resistance)
    write_sigma: float = 0.10    # device-to-device write variability
    read_sigma: float = 0.10     # cycle-to-cycle read variability
    w_clip: float = 1.0          # |logical weight| mapped to full window
    write_levels: Optional[int] = None  # finite programming resolution
    prog_sigma: float = 0.0      # initial-programming variability (pairs)
    drift_rate: float = 0.0      # per-tick conductance relaxation → g_off
    # Retention-drift cadence: drift every ``drift_cadence`` updates, by
    # ``drift_cadence`` ticks at once — the same total relaxation
    # ((1−rate)^N after N updates), amortized. 1 = a tick every update.
    drift_cadence: int = 1

    @property
    def g_on(self) -> float:
        return 1.0 / self.r_on

    @property
    def g_off(self) -> float:
        return 1.0 / self.r_off

    @property
    def g_ref(self) -> float:
        """Reference device at the midpoint of the conductance window."""
        return 0.5 * (self.g_on + self.g_off)

    @property
    def g_half_range(self) -> float:
        return 0.5 * (self.g_on - self.g_off)


@dataclasses.dataclass
class CrossbarState:
    """Programmed conductances (same shape as the logical weight matrix)."""
    g: torch.Tensor        # tunable device conductances (S)
    spec: CrossbarSpec

    def to_weights(self) -> torch.Tensor:
        """Ideal read-back of logical weights."""
        s = self.spec
        return (self.g - f32(s.g_ref)) / f32(s.g_half_range) * f32(s.w_clip)


def _snap(g: torch.Tensor, spec: CrossbarSpec) -> torch.Tensor:
    """Snap to the ``write_levels`` programming grid over the window."""
    lo = f32(spec.g_off)
    step = f32((spec.g_on - spec.g_off) / (spec.write_levels - 1))
    return torch.round((g - lo) / step) * step + lo


def _target_conductance(w: torch.Tensor, spec: CrossbarSpec) -> torch.Tensor:
    wn = torch.clamp(w / f32(spec.w_clip), -1.0, 1.0)
    return f32(spec.g_ref) + wn * f32(spec.g_half_range)


def noise_factor(key: np.ndarray, sigma: float, like: torch.Tensor
                 ) -> torch.Tensor:
    """1 + σ·N(0, 1) of ``like``'s shape, drawn from ``key``; ``sigma`` a
    number or a float32 scalar tensor."""
    z = prng.normal(key, like.shape, device=like.device)
    return 1.0 + _scalar(sigma) * z


def program(key: np.ndarray, w: torch.Tensor, spec: CrossbarSpec
            ) -> CrossbarState:
    """Program logical weights into the crossbar: write variability and
    optional level quantization, then the clip to the physical window."""
    g_t = _target_conductance(w, spec)
    if spec.write_levels is not None:
        g_t = _snap(g_t, spec)
    g = torch.clamp(g_t * noise_factor(key, spec.write_sigma, w),
                    f32(spec.g_off), f32(spec.g_on))
    return CrossbarState(g=g, spec=spec)


def update(key: np.ndarray, state: CrossbarState, dw: torch.Tensor
           ) -> CrossbarState:
    """Incremental conductance update (in-situ training write): only
    nonzero dw entries receive write pulses."""
    spec = state.spec
    dg = dw / f32(spec.w_clip) * f32(spec.g_half_range)
    g = torch.where(dw != 0,
                    state.g + dg * noise_factor(key, spec.write_sigma, dw),
                    state.g)
    return CrossbarState(g=torch.clamp(g, f32(spec.g_off), f32(spec.g_on)),
                         spec=spec)


# ---------------------------------------------------------------------------
# Differential G⁺/G⁻ pairs — the conductance-domain state carried between
# steps by the ``analog_state`` backend. A logical weight is the scaled
# conductance difference of two tunable devices:
#
#     w = (G⁺ − G⁻) / (G_on − G_off) · w_clip
#
# Positive weights live on G⁺ (G⁻ parked at G_off), negative on G⁻. Pairs
# are plain ``{"g_pos", "g_neg"}`` dicts of tensors.
# ---------------------------------------------------------------------------

Pair = dict[str, torch.Tensor]


def pair_weights(pair: Pair, spec: CrossbarSpec) -> torch.Tensor:
    """Ideal (noiseless) read-back of logical weights from a pair."""
    g_range = spec.g_on - spec.g_off
    return (pair["g_pos"] - pair["g_neg"]) * f32(spec.w_clip / g_range)


def program_pair(key: Optional[np.ndarray], w: torch.Tensor,
                 spec: CrossbarSpec, *,
                 prog_sigma: Optional[float] = None) -> Pair:
    """Initial programming of logical weights onto G⁺/G⁻ pairs, with
    ``spec.prog_sigma`` device-to-device programming variability (none
    when ``key`` is None: the exact mirror of ``w``). ``prog_sigma``
    overrides the spec's value (a fleet chip's own)."""
    wn = torch.clamp(w / f32(spec.w_clip), -1.0, 1.0)
    g_range = f32(spec.g_on - spec.g_off)
    g_off = f32(spec.g_off)
    g_pos = g_off + torch.clamp(wn, min=0.0) * g_range
    g_neg = g_off + torch.clamp(-wn, min=0.0) * g_range
    sigma = prog_sigma if prog_sigma is not None else spec.prog_sigma
    if key is not None and (prog_sigma is not None or spec.prog_sigma > 0):
        kp, kn = prng.split(key)
        g_pos = g_pos * noise_factor(kp, sigma, g_pos)
        g_neg = g_neg * noise_factor(kn, sigma, g_neg)
    return {"g_pos": torch.clamp(g_pos, g_off, f32(spec.g_on)),
            "g_neg": torch.clamp(g_neg, g_off, f32(spec.g_on))}


def update_pair(key: np.ndarray, pair: Pair, dw: torch.Tensor,
                spec: CrossbarSpec, *,
                write_sigma: Optional[float] = None) -> Pair:
    """In-situ training write in the conductance domain. A positive
    logical delta potentiates G⁺, a negative one G⁻; only nonzero deltas
    cost pulses. Each landed delta carries multiplicative write noise,
    optionally snaps to the programming grid, and saturates at the
    window — repeated one-sided updates lose magnitude at the rails.
    ``write_sigma`` overrides the spec's value (a fleet chip's own)."""
    sigma = write_sigma if write_sigma is not None else spec.write_sigma
    dg = torch.abs(dw) / f32(spec.w_clip) * f32(spec.g_on - spec.g_off)
    dg = dg * noise_factor(key, sigma, dw)
    g_pos = torch.where(dw > 0, pair["g_pos"] + dg, pair["g_pos"])
    g_neg = torch.where(dw < 0, pair["g_neg"] + dg, pair["g_neg"])
    if spec.write_levels is not None:
        g_pos = torch.where(dw > 0, _snap(g_pos, spec), g_pos)
        g_neg = torch.where(dw < 0, _snap(g_neg, spec), g_neg)
    lo, hi = f32(spec.g_off), f32(spec.g_on)
    return {"g_pos": torch.clamp(g_pos, lo, hi),
            "g_neg": torch.clamp(g_neg, lo, hi)}


def drift_pair(pair: Pair, spec: CrossbarSpec, n_ticks: int = 1, *,
               drift_rate: Optional[float] = None) -> Pair:
    """Conductance relaxation toward G_off between updates: each tick
    shrinks the programmed excess by ``spec.drift_rate`` (retention
    loss). A zero rate returns the pair unchanged. ``drift_rate``
    overrides the spec's value (a fleet chip's own, in float32: ``1 −
    rate`` is rounded to float32 before the power, and a zero rate
    multiplies through)."""
    if drift_rate is None:
        if spec.drift_rate <= 0:
            return pair
        keep = f32((1.0 - spec.drift_rate) ** n_ticks)
    else:
        rate = torch.as_tensor(drift_rate, dtype=torch.float32,
                               device=pair["g_pos"].device)
        keep = (1.0 - rate) ** n_ticks
    g_off = f32(spec.g_off)
    return {k: g_off + (g - g_off) * keep for k, g in pair.items()}


def vmm(key: Optional[np.ndarray], x: torch.Tensor, state: CrossbarState
        ) -> torch.Tensor:
    """Analog vector-matrix multiply on the crossbar (eq. 7): x (…, n_in)
    dimensionless drive, returns (…, n_out) in logical-weight units. With
    ``key`` None the read is noiseless."""
    s = state.spec
    w_eff = state.to_weights()
    if key is not None and s.read_sigma > 0:
        # Read noise perturbs each device conductance per access.
        g_noisy = state.g * noise_factor(key, s.read_sigma, state.g)
        w_eff = (g_noisy - f32(s.g_ref)) / f32(s.g_half_range) \
            * f32(s.w_clip)
    return x @ w_eff
