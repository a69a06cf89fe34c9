"""Per-device parameter draws for fleet simulation — counterpart of
``repro/fleet/heterogeneity.py``.

A fabricated population of M2RU chips is not M copies of one
:class:`~repro_torch.analog.crossbar.CrossbarSpec`: programming
variability, read noise, write variability and retention drift vary chip
to chip. This module makes that population data:

  FleetSpec            how many devices, which heterogeneity profile, the
                       fleet-level seed.
  device_seeds         per-device data-stream seeds from the paper's
                       Xorshift32 hardware RNG (exact).
  draw_heterogeneity   per-chip crossbar knobs, float32 arrays of shape
                       (n_devices,): the ``"_het"`` overlay the
                       ``analog_state`` backend reads and writes through.
  draw_fleet_faults    per-chip fault severity (a rate multiplier and a
                       dead-chip flag) for a :class:`FaultSpec`.

Draws are absolute per-chip values (lognormal around the profile mean),
from :mod:`repro_torch.prng` on the reference's keys (``normal`` within
a few ulp, ``uniform`` exact). The ``"none"`` profile attaches nothing:
each chip's run is then ``run_compiled``'s for its seed, bit for bit.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Optional

import numpy as np

from repro_torch import prng
from repro_torch.core.replay import Xorshift32

#: Domain separator folded into the fleet seed before the Xorshift32
#: chain of per-device data-stream seeds.
_SEED_STREAM_SALT = 0xF1EE7D0C

#: fold_in constant of the heterogeneity draw key.
_HET_FOLD = 0x48E7

#: fold_in constant of each device's re-programming key (a het overlay
#: re-programs the G⁺/G⁻ pairs under the chip's own prog_sigma).
_PROG_FOLD = 0xF1EE7

#: fold_in constant of the fleet-level fault draws and of each chip's
#: mask-sampling key.
_FAULT_FOLD = 0xFA11


@dataclasses.dataclass(frozen=True)
class HetProfile:
    """Population statistics for one crossbar knob set. Each field is
    ``(mean, rel_spread)``: per-chip values are ``mean · exp(rel_spread·z
    − rel_spread²/2)`` with ``z`` a unit normal — lognormal,
    mean-preserving, positive. ``None`` leaves the knob alone."""
    name: str
    prog_sigma: Optional[tuple[float, float]] = None
    read_sigma: Optional[tuple[float, float]] = None
    write_sigma: Optional[tuple[float, float]] = None
    drift_rate: Optional[tuple[float, float]] = None

    KNOBS = ("prog_sigma", "read_sigma", "write_sigma", "drift_rate")

    def fields(self) -> dict[str, tuple[float, float]]:
        return {k: getattr(self, k) for k in self.KNOBS
                if getattr(self, k) is not None}


#: The named profiles: "none" (no overlay), "mild" (a well-centred fab
#: corner), "harsh" (heavy chip-to-chip spread), the last two centred on
#: the analog_state default spec's noise scales.
HET_PROFILES: dict[str, HetProfile] = {
    "none": HetProfile("none"),
    "mild": HetProfile(
        "mild",
        prog_sigma=(0.10, 0.20),
        read_sigma=(0.02, 0.25),
        write_sigma=(0.10, 0.20),
        drift_rate=(1e-4, 0.50),
    ),
    "harsh": HetProfile(
        "harsh",
        prog_sigma=(0.15, 0.50),
        read_sigma=(0.05, 0.60),
        write_sigma=(0.15, 0.50),
        drift_rate=(1e-3, 1.00),
    ),
}


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """A simulated device population.

    n_devices     fleet size.
    het_profile   key into :data:`HET_PROFILES` (or "none").
    seed          fleet-level seed: the Xorshift32 chain of data-stream
                  seeds and the heterogeneity draws. Two fleets with the
                  same spec are bit-identical.
    mesh_axis     the reference's sharding-axis name (kept for the spec's
                  identity; the port runs the fleet on one device).
    """
    n_devices: int = 8
    het_profile: str = "none"
    seed: int = 0
    mesh_axis: str = "fleet"

    def __post_init__(self):
        if self.n_devices < 1:
            raise ValueError("FleetSpec.n_devices must be >= 1, got "
                             f"{self.n_devices}")
        if self.het_profile not in HET_PROFILES:
            raise ValueError(
                f"unknown het_profile {self.het_profile!r}; expected one "
                f"of {sorted(HET_PROFILES)}")

    @property
    def profile(self) -> HetProfile:
        return HET_PROFILES[self.het_profile]


def device_seeds(spec: FleetSpec) -> list[int]:
    """Per-device data-stream seeds: successive words of one Xorshift32
    chain keyed on the fleet seed; pairwise distinct for any fleet that
    fits the generator's period."""
    rng = Xorshift32((spec.seed ^ _SEED_STREAM_SALT) & 0xFFFFFFFF)
    return [int(rng.next()) for _ in range(spec.n_devices)]


def _lognormal(key: np.ndarray, n: int, mean: float,
               spread: float) -> np.ndarray:
    """``mean · exp(spread·z − spread²/2)`` in float32, z ~ N(0, 1) drawn
    from ``key``: the product and difference in float32, exp in float64
    rounded once."""
    z = prng.normal(key, (n,)).numpy()
    arg = (np.float32(spread) * z
           - np.float32(0.5 * spread * spread)).astype(np.float32)
    return (np.float32(mean)
            * np.exp(arg.astype(np.float64)).astype(np.float32)
            ).astype(np.float32)


def draw_heterogeneity(spec: FleetSpec) -> Optional[dict[str, np.ndarray]]:
    """The fleet's per-chip crossbar knobs, ``{knob: (n_devices,)
    float32}`` in sorted knob order, or None for the "none" profile."""
    fields = spec.profile.fields()
    if not fields:
        return None
    base = prng.fold_in(prng.PRNGKey(spec.seed), _HET_FOLD)
    return {name: _lognormal(prng.fold_in(base, i), spec.n_devices,
                             *fields[name])
            for i, name in enumerate(sorted(fields))}


def supports_heterogeneity(backend) -> bool:
    """Whether the backend's ``init_device_state`` takes the ``het``
    overlay (the conductance-domain ``analog_state`` substrate)."""
    try:
        sig = inspect.signature(backend.init_device_state)
    except (TypeError, ValueError):  # pragma: no cover - exotic callables
        return False
    return "het" in sig.parameters


def _require_het(backend) -> None:
    if not supports_heterogeneity(backend):
        raise ValueError(
            f"backend {getattr(backend, 'name', backend)!r} has no "
            "conductance-domain device state; heterogeneity profiles "
            "other than 'none' need the 'analog_state' backend")


def chip_device_state(backend, params: dict, seed: int,
                      het: dict[str, float]):
    """One chip's device state re-programmed under its own draw: the key
    is folded off the chip's data-stream seed (``fold_in(PRNGKey(seed),
    0xF1EE7)``), so its programming variation is as chip-local as its
    data; the overlay rides the state as ``"_het"``."""
    _require_het(backend)
    key = prng.fold_in(prng.PRNGKey(seed), _PROG_FOLD)
    return backend.init_device_state(params, key, het=het)


def overlay_device_states(backend, params_per_chip: list, seeds: list[int],
                          het: dict[str, np.ndarray]) -> list:
    """Every chip's G⁺/G⁻ pairs re-programmed under its own draw
    (:func:`chip_device_state`), one state a chip (the reference stacks
    them on a leading device axis)."""
    return [chip_device_state(backend, p, s,
                              {k: v[d] for k, v in het.items()})
            for d, (p, s) in enumerate(zip(params_per_chip, seeds))]


# ---------------------------------------------------------------------------
# Fleet-level fault draws (repro_torch.faults)
# ---------------------------------------------------------------------------

def draw_fleet_faults(fleet: FleetSpec, fspec):
    """Per-chip fault severity for a :class:`FaultSpec`: ``(rate_scale,
    dead)`` — a mean-preserving lognormal multiplier on the static-mask
    rates (``fspec.rate_spread``, float32) and a whole-chip death draw
    (``fspec.dead_chip_rate``, bool), each (n_devices,) — or ``(None,
    None)`` when the spec has no fleet-level spread."""
    if fspec is None or (fspec.rate_spread <= 0
                         and fspec.dead_chip_rate <= 0):
        return None, None
    base = prng.fold_in(prng.PRNGKey(fleet.seed), _FAULT_FOLD)
    k_rate, k_dead = prng.split(base)
    D = fleet.n_devices
    if fspec.rate_spread > 0:
        scale = _lognormal(k_rate, D, 1.0, fspec.rate_spread)
    else:
        scale = np.ones((D,), np.float32)
    if fspec.dead_chip_rate > 0:
        dead = prng.uniform_np(k_dead, (D,)) \
            < np.float32(fspec.dead_chip_rate)
    else:
        dead = np.zeros((D,), bool)
    return scale, dead


def chip_fault_state(backend, params: dict, seed: int, scale, dead,
                     fspec) -> dict:
    """One chip's fault masks re-sampled under its fleet-level draw, from
    a key folded off its data-stream seed (``fold_in(PRNGKey(seed),
    0xFA11)``), with its rate multiplier and dead-chip flag."""
    from repro_torch.faults.model import sample_fault_state
    key = prng.fold_in(prng.PRNGKey(seed), _FAULT_FOLD)
    return sample_fault_state(params, key, fspec,
                              sa1_value=backend._fault_value_scale(),
                              rate_scale=scale, dead=dead)


def overlay_fault_states(backend, params_per_chip: list, seeds: list[int],
                         scale: np.ndarray, dead: np.ndarray,
                         fspec) -> list:
    """Every chip's ``"_faults"`` re-sampled under its fleet-level draw
    (:func:`chip_fault_state`), one dict a chip."""
    return [chip_fault_state(backend, p, s, scale[d], dead[d], fspec)
            for d, (p, s) in enumerate(zip(params_per_chip, seeds))]
