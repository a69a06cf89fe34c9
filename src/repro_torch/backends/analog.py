"""Mixed-signal crossbar substrate — the full M2RU accelerator model.
Counterpart of ``repro/backends/analog.py``.

Extends the WBS digital path with :class:`CrossbarSpec` device physics:

  forward  — per-plane memristor-ratio gain variability (``gain_sigma``),
             optional per-access conductance read noise
             (``crossbar.read_sigma``, drawn inside the WBS kernel),
             fused ADC readout.
  write    — §V-B device-to-device write variation on every programmed
             synapse (``crossbar.write_sigma``), optional finite
             programming resolution (``crossbar.write_levels``), clip to
             the crossbar's dynamic range.
  lifetime — per-device write counting through the endurance tracker;
             only nonzero updates cost write pulses.

The default spec mirrors the paper's §V-B calibration as the Fig. 4
hardware runs use it: 8-bit WBS drive, 8-bit ADC, 2 % plane-gain
variability, 10 % write variability, |w| ≤ 1.5. Read variability is
carried by the plane gains by default (``read_sigma=0``), which keeps the
fused recurrence; a ``crossbar.read_sigma > 0`` takes the per-step path.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.analog.crossbar import CrossbarSpec, f32
from repro_torch.backends.base import DeviceSpec, Params
from repro_torch.backends.registry import register_backend
from repro_torch.backends.wbs import WBSBackend


@register_backend("analog")
class AnalogBackend(WBSBackend):
    name = "analog"

    @classmethod
    def default_spec(cls) -> DeviceSpec:
        return DeviceSpec(input_bits=8, adc_bits=8, adc_range=4.0,
                          gain_sigma=0.02, weight_clip=1.5,
                          crossbar=CrossbarSpec(write_sigma=0.10,
                                                read_sigma=0.0,
                                                w_clip=1.5))

    @property
    def crossbar(self) -> CrossbarSpec:
        # Without a CrossbarSpec, read variability is carried by the plane
        # gains alone, as in default_spec.
        return self.spec.crossbar if self.spec.crossbar is not None \
            else CrossbarSpec(read_sigma=0.0, w_clip=self._weight_scale())

    def _weight_scale(self) -> float:
        # An explicit DeviceSpec.weight_clip wins, else the crossbar's own
        # w_clip.
        if self.spec.weight_clip:
            return self.spec.weight_clip
        if self.spec.crossbar is not None:
            return self.spec.crossbar.w_clip
        return 1.0

    @property
    def draws_noise(self) -> bool:
        return self.spec.gain_sigma > 0 or self.crossbar.read_sigma > 0

    # ------------------------------------------------------------------
    def _fused_recurrence_ok(self, state=None) -> bool:
        # Per-access read noise perturbs the weights afresh on every step,
        # so the fused scan engages only without it.
        return super()._fused_recurrence_ok(state) \
            and self.crossbar.read_sigma == 0

    # ------------------------------------------------------------------
    def vmm(self, drive: torch.Tensor, weights: torch.Tensor,
            key: Optional[np.ndarray] = None, read_sigma: float = 0.0,
            read_key: Optional[np.ndarray] = None,
            prepared: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The WBS product; with ``crossbar.read_sigma > 0`` and a key,
        each access reads perturbed weights: the key splits into the
        read-noise key and the plane-gain key, as the reference's does,
        so the plane gains stay the reference's bit for bit."""
        cb = self.crossbar
        if key is not None and cb.read_sigma > 0:
            k_read, k_gain = prng.split(key)
            return super().vmm(drive, weights, k_gain,
                               read_sigma=cb.read_sigma, read_key=k_read,
                               prepared=prepared)
        return super().vmm(drive, weights, key, prepared=prepared)

    # ------------------------------------------------------------------
    def apply_update(self, params: Params, updates: Params,
                     key: Optional[np.ndarray] = None
                     ) -> tuple[Params, Params]:
        """In-situ training write. Only nonzero update entries receive
        write pulses; each lands with multiplicative write noise,
        optionally snaps to the programming grid (``write_levels`` points
        over [-clip, clip]; untouched devices keep their value), and the
        result is clipped to the crossbar's dynamic range. The noise is
        drawn on the host, one key per parameter in sorted name order,
        on the reference's chain."""
        cb = self.crossbar
        clip = self._weight_scale()
        if key is None:
            raise ValueError("analog apply_update needs a PRNG key "
                             "(write variability is stochastic)")
        keys = prng.split(key, len(params))
        sigma = f32(cb.write_sigma)
        new_params, applied = {}, {}
        for kw, (name, p) in zip(keys, sorted(params.items())):
            dw = updates[name]
            noise = 1.0 + sigma * prng.normal(kw, dw.shape, device=dw.device)
            dw = torch.where(dw != 0, dw * noise, torch.zeros_like(dw))
            w = p + dw
            if cb.write_levels is not None:
                step = f32(2.0 * clip / (cb.write_levels - 1))
                w = torch.where(dw != 0, torch.round(w / step) * step, w)
            w = torch.clamp(w, -clip, clip)
            new_params[name] = w
            applied[name] = w - p
        return new_params, applied
