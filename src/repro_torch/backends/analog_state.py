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

    def init_device_state(self, params, key: Optional[np.ndarray] = None,
                          *, het: Optional[dict] = None) -> dict[str, Any]:
        """Program every ≥2-D weight onto G⁺/G⁻ pairs, one key per weight
        in sorted name order. A drift cadence above 1 adds the update
        counter ``_ticks`` (an int32 scalar on the weights' device). The
        fleet's per-chip overrides (``het``) are not ported and raise."""
        if het:
            raise NotImplementedError(
                "per-chip heterogeneity (het=) is not ported yet (ROADMAP "
                "queue A, fleet/)")
        cb = self.crossbar
        names = sorted(n for n, p in params.items() if p.ndim >= 2)
        keys = prng.split(key, len(names)) if key is not None \
            else [None] * len(names)
        state: dict[str, Any] = {name: program_pair(k, params[name], cb)
                                 for k, name in zip(keys, names)}
        if cb.drift_rate > 0 and cb.drift_cadence > 1:
            device = params[names[0]].device if names else None
            state["_ticks"] = torch.zeros((), dtype=torch.int32,
                                          device=device)
        return state

    # ------------------------------------------------------------------
    def _fused_recurrence_ok(self, state=None) -> bool:
        # The forward is defined by the per-step reads through the pairs;
        # the logical-weight fused scan never stands in for it.
        return False

    def prepare_weights(self, params, *, state=None) -> Optional[dict]:
        """Without per-access read noise every step reads the same pairs,
        so their read-back over the logical scale is hoisted, as the
        logical weights' are on the parent; with it, nothing is."""
        if state is None or self._ideal_device():
            return super().prepare_weights(params, state=state)
        if self.crossbar.read_sigma > 0:
            return None
        scale = self._weight_scale()
        return {tag: pair_weights(pair, self.crossbar) / scale
                for tag, pair in state.items() if tag in params} or None

    def _vmm_impl(self, drive, weights, key, state, tag, prepared):
        if state is None or tag not in state or self._ideal_device():
            # Ideal limit or stateless call: the parent's logical path is
            # the exact same computation.
            return super()._vmm_impl(drive, weights, key, state, tag,
                                     prepared)
        cb = self.crossbar
        pair = state[tag]
        if key is not None and cb.read_sigma > 0:
            kp, kn, k_gain = prng.split(key, 3)
            pair = {"g_pos": pair["g_pos"]
                    * noise_factor(kp, cb.read_sigma, pair["g_pos"]),
                    "g_neg": pair["g_neg"]
                    * noise_factor(kn, cb.read_sigma, pair["g_neg"])}
            y = WBSBackend.vmm(self, drive.detach(), pair_weights(pair, cb),
                               k_gain)
        else:
            entry = prepared.get(tag) if prepared else None
            w_eff = pair_weights(pair, cb) if entry is None else weights
            # The WBS product over the device read-back (plane gains from
            # the step's key), not the parent's read-noise path.
            y = WBSBackend.vmm(self, drive.detach(), w_eff.detach(), key,
                               prepared=entry)
        # The straight-through gradient goes to the trainer's logical
        # weights, not to the read-back.
        return ste_matmul(y, drive, weights)

    # ------------------------------------------------------------------
    def device_apply_update(self, params, updates, key=None, state=None):
        """Drift, then the noisy conductance-domain write, then the
        read-back; in the ideal limit the parent's logical write, with
        the pairs kept as its mirror."""
        cb = self.crossbar
        if state is None or self._ideal_device():
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
        drifting = cb.drift_rate > 0
        fire = None
        new_state = dict(state)
        if drifting:
            if cadence > 1:
                ticks = state["_ticks"] + 1
                fire = ticks >= cadence
                new_state["_ticks"] = torch.where(fire, 0, ticks)
            self.telemetry.record({meters.DRIFT_TICKS: 1})

        def _drift(pair):
            if not drifting:
                return pair
            if cadence == 1:
                return drift_pair(pair, cb)
            drifted = drift_pair(pair, cb, n_ticks=cadence)
            return {k: torch.where(fire, drifted[k], pair[k]) for k in pair}

        keys = prng.split(key, len(params))
        new_params, applied = {}, {}
        for kw, (name, p) in zip(keys, sorted(params.items())):
            dw = updates[name]
            if name in state:
                pair = update_pair(kw, _drift(state[name]), dw, cb)
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
