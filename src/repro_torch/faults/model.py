"""Device-fault models: per-tile fault masks for the crossbar tiles —
counterpart of ``repro/faults/model.py``.

The paper's 12.2-year lifetime is an analytical projection from per-cell
write counts (``analog/endurance.lifespan_years``). This module supplies
the empirical half: what the network computes when devices fail. Faults
are per-tile masks carried in the device-state dict under ``"_faults"``,
next to the fleet overlay (``"_het"``) and the conductance pairs, so
they ride every train step, evaluation and fleet chip.

Fault taxonomy (independent per-cell/row/column Bernoulli rates, sampled
once per device from a key):

  SA0   stuck-at-G_off: the cell reads logical 0 and rejects writes.
  SA1   stuck-at-G_on: the cell reads ``±sa1_value`` (the logical
        dynamic range) with a random sign, and rejects writes.
  dead row / dead column: every cell on the line reads 0.
  transient read upsets: with probability ``upset_rate`` an output
        element of a step is replaced by a uniform draw over the ADC
        full scale. They leave no state and force the per-step
        recurrence (the fused scan draws no per-step upsets).
  wear-out: each cell carries a write counter and a lognormal endurance
        limit; a cell whose counter crosses its limit becomes stuck
        (``wearout_mode``), so a long run gives an accuracy-vs-age curve
        to hold against ``lifespan_years``.

Contract: ``DeviceSpec.faults is None`` builds no masks; a zero-rate
:class:`FaultSpec` gives all-False masks whose application is the
identity bit for bit; applying a mask is idempotent (a projection); the
same masked tensor feeds the per-step and fused recurrences, so they
stay bitwise equal under faults.

Every draw is :mod:`repro_torch.prng` on the reference's keys: the
uniform draws (and so ``stuck``, ``value``, the spares and the column
map) equal the reference's bit for bit; ``wear_limit`` comes from
``normal`` and ``exp``, within a few ulp. Masks are drawn on the host and
live as ``bool``/``float32`` tensors on the weights' device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import prng

# Key-derivation salt of the mask sampling (the reference's): folds the
# device-state key into a stream disjoint from the pairs' programming
# keys and the fleet overlays.
_FAULT_SALT = 0xFA17


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Fault-injection knobs for a
    :class:`repro_torch.backends.base.DeviceSpec`.

    Static-mask rates (sampled once per device at state init):
      sa0_rate        per-cell stuck-at-G_off probability.
      sa1_rate        per-cell stuck-at-G_on probability (random sign).
      dead_row_rate   per-row failure probability (a dead word line).
      dead_col_rate   per-column line-failure probability (spare columns
                      included: spares can be born dead).
      n_spare_cols    redundant columns per tile for the remap
                      mitigation (0 = none).

    Transient faults:
      upset_rate      per-access, per-element read-upset probability.

    Endurance wear-out:
      wearout             per-cell write counters and limits.
      wearout_endurance   mean endurance limit (writes per cell).
      wearout_spread      lognormal sigma of the per-cell limit.
      wearout_scale       age acceleration: one training write advances
                          the counter by this many physical writes.
      wearout_mode        what a worn cell reads: "sa0" (G_off), "sa1"
                          (±range, the sign of its last value) or
                          "freeze" (its last written value).

    Fleet propagation (read by ``repro_torch.fleet.heterogeneity``):
      rate_spread     lognormal sigma of a per-chip multiplier on the
                      static-mask rates (mean-preserving).
      dead_chip_rate  per-chip probability that the whole die is dead.
    """
    sa0_rate: float = 0.0
    sa1_rate: float = 0.0
    dead_row_rate: float = 0.0
    dead_col_rate: float = 0.0
    n_spare_cols: int = 0
    upset_rate: float = 0.0
    wearout: bool = False
    wearout_endurance: float = 1e9
    wearout_spread: float = 0.3
    wearout_scale: float = 1.0
    wearout_mode: str = "sa0"
    rate_spread: float = 0.0
    dead_chip_rate: float = 0.0

    def any_static(self) -> bool:
        return (self.sa0_rate > 0 or self.sa1_rate > 0
                or self.dead_row_rate > 0 or self.dead_col_rate > 0
                or self.wearout)


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def _f32(x) -> np.float32:
    return np.float32(x)


def _sample_tile(key: np.ndarray, shape: tuple[int, ...], spec: FaultSpec,
                 sa1_value: float, rate_scale, dead, device
                 ) -> dict[str, torch.Tensor]:
    """One tile's masks, in numpy on the host, in the reference's order
    of operations: every rate is a float32 product (``rate * scale``)
    and every comparison is against a float32 uniform."""
    n_in, n_out = shape
    n_sp = spec.n_spare_cols
    scale = _f32(1.0) if rate_scale is None else _f32(rate_scale)
    ku, ks, kr, kc, kw, kp, kq = prng.split(key, 7)
    u = prng.uniform_np(ku, shape)
    p0 = _f32(spec.sa0_rate) * scale
    p1 = _f32(spec.sa1_rate) * scale
    sa0 = u < p0
    sa1 = (u >= p0) & (u < p0 + p1)
    row_dead = prng.uniform_np(kr, (n_in, 1)) < _f32(spec.dead_row_rate) \
        * scale
    col_dead_all = prng.uniform_np(kc, (1, n_out + n_sp)) \
        < _f32(spec.dead_col_rate) * scale
    col_dead = col_dead_all[:, :n_out]
    line_dead = row_dead | col_dead
    sign = np.where(prng.uniform_np(ks, shape) < _f32(0.5), _f32(-1.0),
                    _f32(1.0))
    stuck = sa0 | sa1 | line_dead
    value = np.where(sa1 & ~line_dead, sign * _f32(sa1_value),
                     _f32(0.0)).astype(np.float32)
    d = bool(dead) if dead is not None else False
    if d:
        stuck = np.ones_like(stuck)
        value = np.zeros_like(value)
    tile = {"stuck": stuck, "value": value}
    if n_sp > 0:
        usp = prng.uniform_np(kp, (n_in, n_sp))
        sp_line = row_dead | col_dead_all[:, n_out:]
        sp1 = (usp >= p0) & (usp < p0 + p1)
        sp_stuck = (usp < p0 + p1) | sp_line
        sp_sign = np.where(prng.uniform_np(kq, (n_in, n_sp)) < _f32(0.5),
                           _f32(-1.0), _f32(1.0))
        sp_value = np.where(sp1 & ~sp_line, sp_sign * _f32(sa1_value),
                            _f32(0.0)).astype(np.float32)
        if d:
            sp_stuck = np.ones_like(sp_stuck)
            sp_value = np.zeros_like(sp_value)
        tile["spare_stuck"] = sp_stuck
        tile["spare_value"] = sp_value
        tile["colmap"] = np.arange(n_out, dtype=np.int32)
    if spec.wearout:
        s = spec.wearout_spread
        z = prng.normal(kw, shape).numpy()
        # Mean-preserving lognormal limits: s·z − s²/2 in float32 (XLA
        # does not contract it), exp in float64 rounded once.
        arg = (_f32(s) * z - _f32(0.5 * s * s)).astype(np.float32)
        lim = _f32(spec.wearout_endurance) \
            * np.exp(arg.astype(np.float64)).astype(np.float32)
        tile["wear_limit"] = lim.astype(np.float32)
        tile["wear_count"] = np.zeros(shape, np.float32)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in tile.items()}


def sample_fault_state(params: dict, key: np.ndarray, spec: FaultSpec, *,
                       sa1_value: float = 1.0, rate_scale=None,
                       dead=None) -> dict[str, dict[str, torch.Tensor]]:
    """Per-tile fault masks for every ≥2-D (crossbar) parameter, on its
    device. ``rate_scale`` (a per-chip scalar) multiplies the static-mask
    rates; ``dead`` (a per-chip bool) makes the whole device stuck at 0.
    Tile ``i`` in sorted name order draws from ``fold_in(fold_in(key,
    0xFA17), i)``."""
    names = sorted(n for n, p in params.items() if p.ndim >= 2)
    base = prng.fold_in(key, _FAULT_SALT)
    return {name: _sample_tile(prng.fold_in(base, i),
                               tuple(params[name].shape), spec, sa1_value,
                               rate_scale, dead, params[name].device)
            for i, name in enumerate(names)}


# ---------------------------------------------------------------------------
# Mask application
# ---------------------------------------------------------------------------

def fault_state(state: Any) -> Optional[dict]:
    """The fault-mask dict riding a device state, or None."""
    return state.get("_faults") if isinstance(state, dict) else None


def effective_masks(tile: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """(stuck, value) of a tile after column remapping: logical column j
    reads physical column ``colmap[j]``, which may be a spare. Without
    spares the primary masks apply directly."""
    stuck, value = tile["stuck"], tile["value"]
    cm = tile.get("colmap")
    if cm is None:
        return stuck, value
    cm = cm.long()
    stuck = torch.cat([stuck, tile["spare_stuck"]], dim=1)[:, cm]
    value = torch.cat([value, tile["spare_value"]], dim=1)[:, cm]
    return stuck, value


def apply_cell_faults(w: torch.Tensor, tile: Optional[dict]
                      ) -> torch.Tensor:
    """A logical weight matrix read through its stuck-cell mask.
    Idempotent; the identity when the mask is all-False."""
    if tile is None:
        return w
    stuck, value = effective_masks(tile)
    return torch.where(stuck, value.to(w.dtype), w)


def mask_updates(updates: dict, fstate: dict) -> dict:
    """Write pulses aimed at stuck cells zeroed: a stuck device rejects
    programming, so it advances no endurance counter either."""
    out = {}
    for name, u in updates.items():
        tile = fstate.get(name)
        if tile is None:
            out[name] = u
        else:
            stuck, _ = effective_masks(tile)
            out[name] = torch.where(stuck, torch.zeros((), dtype=u.dtype,
                                                       device=u.device), u)
    return out


def apply_read_upsets(pre: torch.Tensor, key: np.ndarray, rate: float,
                      scale: float) -> torch.Tensor:
    """Transient read upsets: each output element is replaced, with
    probability ``rate``, by a uniform draw over ``[-scale, scale]`` (a
    corrupted ADC latch). Both draws are the reference's, bit for bit."""
    ku, kv = prng.split(key)
    shape = tuple(pre.shape)
    hit = prng.uniform(ku, shape, device=pre.device) < _f32(rate)
    garbage = prng.uniform(kv, shape, -scale, scale, device=pre.device)
    return torch.where(hit, garbage.to(pre.dtype), pre)


# ---------------------------------------------------------------------------
# Endurance wear-out
# ---------------------------------------------------------------------------

def advance_wear(fstate: dict, applied: dict, spec: FaultSpec,
                 new_params: dict, *, sa1_value: float = 1.0) -> dict:
    """Advance the per-cell write counters by the nonzero applied updates
    (times ``wearout_scale``, in float32) and turn the cells whose
    counter reached its limit into stuck cells. A cell written at the
    mean per-update rate fails at the age ``lifespan_years`` projects
    for that rate: the acceleration factor cancels."""
    out = {}
    for name, tile in fstate.items():
        if "wear_count" not in tile or name not in applied:
            out[name] = tile
            continue
        wrote = (applied[name] != 0) & ~tile["stuck"]
        count = tile["wear_count"] \
            + float(_f32(spec.wearout_scale)) * wrote.to(torch.float32)
        newly = (count >= tile["wear_limit"]) & ~tile["stuck"]
        p = new_params[name]
        if spec.wearout_mode == "freeze":
            worn_value = p.to(torch.float32)
        elif spec.wearout_mode == "sa1":
            v = float(_f32(sa1_value))
            worn_value = torch.where(p >= 0, v, -v).to(torch.float32)
        else:  # "sa0"
            worn_value = torch.zeros_like(tile["value"])
        out[name] = {**tile,
                     "stuck": tile["stuck"] | newly,
                     "value": torch.where(newly, worn_value, tile["value"]),
                     "wear_count": count}
    return out


# ---------------------------------------------------------------------------
# Host-side reporting
# ---------------------------------------------------------------------------

def stuck_fraction(fstate: Optional[dict]) -> float:
    """Fraction of cells stuck across all tiles, after remapping (what
    the network reads through). One read-back a call."""
    if not fstate:
        return 0.0
    tot = 0
    bad = []
    for tile in fstate.values():
        stuck, _ = effective_masks(tile)
        tot += stuck.numel()
        bad.append(stuck.sum())
    return int(torch.stack(bad).sum()) / max(tot, 1)
