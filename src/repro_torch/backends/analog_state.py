"""Conductance-domain crossbar substrate — stateful G⁺/G⁻ pairs.
Counterpart of ``repro/backends/analog_state.py``.

The ``analog`` backend models device noise as perturbations around the
logical weight matrix. This backend carries the programmed conductance
pairs themselves (``analog/crossbar.program_pair``) through the training
loop as device state:

  init_device_state  programs every ≥2-D weight onto G⁺/G⁻ pairs with
                     ``crossbar.prog_sigma`` programming variability.
  device_vmm         reads through the pairs (per-access read noise on
                     each device, drawn on the host; then WBS
                     bit-streaming + plane gains), always on the per-step
                     path: two ``wbs_matmul`` launches a time step.
  device_apply_update
                     drifts the pairs (``crossbar.drift_rate``, every
                     ``drift_cadence`` updates), lands the noisy write
                     pulses in the conductance domain (one-sided G⁺/G⁻
                     potentiation, window saturation, optional level
                     grid), and returns the read-back logical weights.

With all device noise and drift at zero the conductance map is exactly
affine, so the backend short-circuits to the parent's logical-weight
arithmetic: ``analog_state`` is then the ``analog`` program bit for bit,
and the pairs are kept as an exact mirror of the logical weights. Biases
(1-D params) live in digital registers and take the parent's write path.

Fault masks (``"_faults"``, sampled after the pairs from the same key
under their own salt) pin the pairs' read-back at the stuck cells, on the
hoisted and the per-call reads alike. A fleet chip's overlay (``"_het"``,
:mod:`repro_torch.fleet`) carries its own ``prog_sigma``, ``read_sigma``,
``write_sigma`` and ``drift_rate`` as float32 scalars on the card: it
turns off the ideal-device short-circuit (its sigmas apply even where the
spec's are zero), its read noise turns off the hoisted read-back, and its
drift rate drifts every update.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.analog.crossbar import (CrossbarSpec, drift_pair,
                                         noise_factor, pair_weights,
                                         program_pair, update_pair)
from repro_torch.backends.analog import AnalogBackend
from repro_torch.backends.base import DeviceSpec
from repro_torch.backends.registry import register_backend
from repro_torch.backends.wbs import WBSBackend, ste_matmul
from repro_torch.faults.model import apply_cell_faults, fault_state
from repro_torch.telemetry import meters


@register_backend("analog_state")
class AnalogStateBackend(AnalogBackend):
    name = "analog_state"

    @classmethod
    def default_spec(cls) -> DeviceSpec:
        return DeviceSpec(input_bits=8, adc_bits=8, adc_range=4.0,
                          gain_sigma=0.02, weight_clip=1.5,
                          crossbar=CrossbarSpec(write_sigma=0.10,
                                                read_sigma=0.0,
                                                w_clip=1.5,
                                                prog_sigma=0.10))

    # ------------------------------------------------------------------
    def _ideal_device(self) -> bool:
        """Zero noise and drift and no level grid: the conductance map is
        exactly affine, so the logical-weight arithmetic is the same
        computation (bit-identical to the ``analog`` backend)."""
        cb = self.crossbar
        return (cb.write_sigma == 0.0 and cb.read_sigma == 0.0
                and cb.prog_sigma == 0.0 and cb.drift_rate == 0.0
                and cb.write_levels is None)

    @staticmethod
    def _state_het(state) -> Optional[dict]:
        """The per-chip overlay riding the device state, or None."""
        return state.get("_het") if isinstance(state, dict) else None

    def forward_draws(self, state=None) -> bool:
        het = self._state_het(state)
        return self.draws_noise or (het is not None and "read_sigma" in het)

    def init_device_state(self, params, key: Optional[np.ndarray] = None,
                          *, het: Optional[dict] = None) -> dict[str, Any]:
        """Program every ≥2-D weight onto G⁺/G⁻ pairs, one key per weight
        in sorted name order. A drift cadence above 1 adds the update
        counter ``_ticks`` (an int32 scalar on the weights' device).
        ``het`` (a fleet chip's overlay: any of ``prog_sigma``,
        ``read_sigma``, ``write_sigma``, ``drift_rate``, as scalars)
        programs under the chip's ``prog_sigma`` and rides the state as
        ``"_het"``, float32 scalars on the weights' device. A
        :class:`~repro_torch.faults.FaultSpec` adds ``"_faults"``, sampled
        from the same key (``PRNGKey(0)`` without one) under its own
        salt."""
        cb = self.crossbar
        names = sorted(n for n, p in params.items() if p.ndim >= 2)
        device = params[names[0]].device if names else None
        keys = prng.split(key, len(names)) if key is not None \
            else [None] * len(names)
        het_t = ({k: torch.as_tensor(np.float32(v), device=device)
                  for k, v in het.items()} if het else None)
        prog_sigma = het_t.get("prog_sigma") if het_t else None
        state: dict[str, Any] = {name: program_pair(k, params[name], cb,
                                                    prog_sigma=prog_sigma)
                                 for k, name in zip(keys, names)}
        if cb.drift_rate > 0 and cb.drift_cadence > 1:
            state["_ticks"] = torch.zeros((), dtype=torch.int32,
                                          device=device)
        if het_t:
            state["_het"] = het_t
        if self.spec.faults is not None:
            state["_faults"] = self._sample_faults(params, key)
        return state

    # ------------------------------------------------------------------
    def _fused_recurrence_ok(self, state=None) -> bool:
        # The forward is defined by the per-step reads through the pairs;
        # the logical-weight fused scan never stands in for it.
        return False

    def _logical(self, state) -> bool:
        """Whether reads and writes take the parent's logical-weight
        arithmetic: no state, or the ideal device with no overlay."""
        return state is None or (self._state_het(state) is None
                                 and self._ideal_device())

    def _read_back(self, pair, state, tag) -> torch.Tensor:
        """A pair's read-back, pinned at the tile's stuck cells (the
        pairs may drift underneath; the column current does not)."""
        w_eff = pair_weights(pair, self.crossbar)
        fstate = fault_state(state)
        if fstate is not None and tag in fstate:
            w_eff = apply_cell_faults(w_eff, fstate[tag])
        return w_eff

    def prepare_weights(self, params, *, state=None) -> Optional[dict]:
        """Without per-access read noise every step reads the same pairs,
        so their read-back over the logical scale is hoisted (masked as
        the per-call read is), as the logical weights' are on the parent;
        with it, the spec's or the overlay's, nothing is."""
        if self._logical(state):
            return super().prepare_weights(params, state=state)
        het = self._state_het(state)
        if self.crossbar.read_sigma > 0 or (het is not None
                                            and "read_sigma" in het):
            return None
        scale = self._weight_scale()
        return {tag: self._read_back(pair, state, tag) / scale
                for tag, pair in state.items() if tag in params} or None

    def _vmm_impl(self, drive, weights, key, state, tag, prepared):
        if self._logical(state) or tag not in state:
            # Ideal limit or stateless call: the parent's logical path is
            # the exact same computation.
            return super()._vmm_impl(drive, weights, key, state, tag,
                                     prepared)
        cb = self.crossbar
        pair = state[tag]
        het = self._state_het(state)
        het_read = het.get("read_sigma") if het is not None else None
        if key is not None and (het_read is not None or cb.read_sigma > 0):
            sigma = het_read if het_read is not None else cb.read_sigma
            kp, kn, k_gain = prng.split(key, 3)
            pair = {"g_pos": pair["g_pos"]
                    * noise_factor(kp, sigma, pair["g_pos"]),
                    "g_neg": pair["g_neg"]
                    * noise_factor(kn, sigma, pair["g_neg"])}
            y = WBSBackend.vmm(self, drive.detach(),
                               self._read_back(pair, state, tag), k_gain)
        else:
            entry = prepared.get(tag) if prepared else None
            w_eff = self._read_back(pair, state, tag) if entry is None \
                else weights
            # The WBS product over the device read-back (plane gains from
            # the step's key), not the parent's read-noise path.
            y = WBSBackend.vmm(self, drive.detach(), w_eff.detach(), key,
                               prepared=entry)
        # The straight-through gradient goes to the trainer's logical
        # weights, not to the read-back.
        return ste_matmul(y, drive, weights)

    # ------------------------------------------------------------------
    def _apply_update_impl(self, params, updates, key, state):
        """Drift, then the noisy conductance-domain write, then the
        read-back; in the ideal limit the parent's logical write, with
        the pairs kept as its mirror. An overlay's ``write_sigma`` and
        ``drift_rate`` replace the spec's (its drift ticks every
        update)."""
        cb = self.crossbar
        if self._logical(state):
            new_params, applied = self.apply_update(params, updates, key)
            if state is not None:
                # Keep the pairs an exact mirror of the logical weights
                # (the cadence counter, when present, carries through).
                state = {n: (program_pair(None, new_params[n], cb)
                             if n in new_params else state[n])
                         for n in state}
            return new_params, applied, state
        if key is None:
            raise ValueError("analog_state apply_update needs a PRNG key "
                             "(write variability is stochastic)")
        # Retention-drift cadence: with drift_cadence == 1 every update
        # drifts one tick; with k > 1 the counter in the device state
        # fires every k-th update and applies k ticks at once (the same
        # total relaxation, amortized). Telemetry meters one tick per
        # update, exact whenever k divides the update count. The counter
        # stays on the device: the fire decision is a torch.where.
        cadence = max(int(cb.drift_cadence), 1)
        het = self._state_het(state) or {}
        het_write = het.get("write_sigma")
        het_drift = het.get("drift_rate")
        drifting = het_drift is not None or cb.drift_rate > 0
        fire = None
        new_state = dict(state)
        if drifting:
            if het_drift is None and cadence > 1:
                ticks = state["_ticks"] + 1
                fire = ticks >= cadence
                new_state["_ticks"] = torch.where(fire, 0, ticks)
            self.telemetry.record({meters.DRIFT_TICKS: 1})

        def _drift(pair):
            if not drifting:
                return pair
            if het_drift is not None:
                return drift_pair(pair, cb, drift_rate=het_drift)
            if cadence == 1:
                return drift_pair(pair, cb)
            drifted = drift_pair(pair, cb, n_ticks=cadence)
            return {k: torch.where(fire, drifted[k], pair[k]) for k in pair}

        keys = prng.split(key, len(params))
        new_params, applied = {}, {}
        for kw, (name, p) in zip(keys, sorted(params.items())):
            dw = updates[name]
            if name in state:
                pair = update_pair(kw, _drift(state[name]), dw, cb,
                                   write_sigma=het_write)
                w_read = pair_weights(pair, cb)          # device read-back
                # Unwritten devices carry the logical value through when
                # nothing drifts (the read-back would re-round it); with
                # drift the relaxation shows in the read-back, but is not
                # a write — ``applied`` stays exactly zero there.
                written = dw != 0
                w_new = w_read if drifting else torch.where(written, w_read,
                                                            p)
                new_state[name] = pair
                new_params[name] = w_new
                applied[name] = torch.where(written, w_new - p,
                                            torch.zeros_like(p))
            else:
                # Digital registers (biases): the parent's logical write.
                sub_p, sub_a = AnalogBackend.apply_update(
                    self, {name: p}, {name: dw}, kw)
                new_params[name] = sub_p[name]
                applied[name] = sub_a[name]
        return new_params, applied, new_state
