"""WBS digital substrate — quantized inputs + ADC, no device noise.

Counterpart of ``repro/backends/wbs.py`` (forward path). Drives are
sign-magnitude quantized to ``input_bits`` and bit-streamed (eqs. 11-19),
the readout is ADC-quantized, weights live in a finite logical dynamic
range (``weight_clip``).

Every crossbar product goes through ``kernels/ops.py``: the CUDA kernels
for CUDA tensors, their plain versions for CPU tensors. The fused
recurrence is one ``wbs_matmul`` for the hoisted input drive plus one
``wbs_miru_scan``; the per-step path is one ``wbs_matmul`` per tile per
step. The two are bitwise equal wherever the ADC is on.

``gain_sigma > 0`` draws each tile's plane gains from the step's
:mod:`repro_torch.prng` key, on the reference's per-step chain; the fused
path replays that chain up front and hands the scan its (T, n_bits)
gains. ``vmm(read_sigma=, read_key=)`` carries the analog substrate's
per-access read noise into the kernel. Not ported: fault masks.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.analog.adc import adc_quantize
from repro_torch.analog.wbs import ideal_gains
from repro_torch.backends.base import DeviceBackend, DeviceSpec, Params
from repro_torch.backends.registry import register_backend
from repro_torch.kernels import ops as kops


@register_backend("wbs")
class WBSBackend(DeviceBackend):
    name = "wbs"

    @classmethod
    def default_spec(cls) -> DeviceSpec:
        return DeviceSpec(input_bits=8, adc_bits=8, adc_range=4.0,
                          weight_clip=1.5)

    def _weight_scale(self) -> float:
        return self.spec.weight_clip if self.spec.weight_clip else 1.0

    @property
    def draws_noise(self) -> bool:
        return self.spec.gain_sigma > 0

    def _sample_gains(self, key: Optional[np.ndarray], device
                      ) -> Optional[torch.Tensor]:
        """Plane gains ideal·(1 + σ·N(0, 1)) drawn from ``key`` —
        (n_bits,) for one key, (T, n_bits) for a (T, 2) stack — or None
        (the ideal ratios) without noise."""
        if key is None or self.spec.gain_sigma <= 0:
            return None
        n_bits = self.spec.input_bits or 8
        noise = prng.normal(key, (n_bits,))
        g = ideal_gains(n_bits) * (1.0 + self.spec.gain_sigma * noise)
        return g.to(device)

    def prepare_weights(self, params: Params, *, state=None
                        ) -> Optional[dict]:
        """Hoist the once-per-forward logical-scale division of every ≥2-D
        weight out of the per-step loop. Each entry has the bits of the
        per-call division."""
        del state
        scale = self._weight_scale()
        prepared = {name: p / scale for name, p in params.items()
                    if p.ndim >= 2}
        return prepared or None

    def _vmm_impl(self, drive, weights, key, state, tag, prepared):
        w = prepared.get(tag) if prepared else None
        return self.vmm(drive, weights, key, prepared=w)

    def vmm(self, drive: torch.Tensor, weights: torch.Tensor,
            key: Optional[np.ndarray] = None, read_sigma: float = 0.0,
            read_key: Optional[np.ndarray] = None,
            prepared: Optional[torch.Tensor] = None) -> torch.Tensor:
        """WBS crossbar product. ``key`` draws the plane gains when
        ``gain_sigma > 0``; ``read_sigma``/``read_key`` carry per-access
        conductance read noise (the analog backend's
        ``crossbar.read_sigma``), drawn inside the kernel on the weight
        matrix over its logical scale — one draw per weight element per
        call (``kops.wbs_matmul``); ``prepared`` is this tile's
        :meth:`prepare_weights` entry."""
        n_bits = self.spec.input_bits or 8
        scale = self._weight_scale()
        w = prepared if prepared is not None else weights / scale
        y = kops.wbs_dense(drive, w.to(torch.float32), n_bits=n_bits,
                           adc_bits=None,
                           gains=self._sample_gains(key, drive.device),
                           read_sigma=read_sigma, read_key=read_key)
        return y * scale

    def _fused_recurrence_ok(self, state=None) -> bool:
        """The fused scan needs a WBS drive and the output ADC: the ADC
        re-quantizes the integrator every step, which is what makes the
        fused kernel bitwise equal to the per-step loop. It reads the
        logical weights, so a device state rules it out."""
        return (state is None and self.spec.input_bits is not None
                and self.spec.adc_bits is not None)

    def device_recurrence(self, params, cfg, x_seq, key=None, *, state=None,
                          fused=None, h0=None):
        """Fused WBS×MiRU recurrence: ONE batched crossbar product for the
        input projection (no sequential dependency) and one kernel for
        the sequential part; under ``gain_sigma > 0`` the per-step path's
        key chain is replayed up front, so both consume the same gains.
        Falls back to the per-step loop where the gate refuses or the
        caller asks (``fused=False``)."""
        if fused is False or not self._fused_recurrence_ok(state):
            return super().device_recurrence(params, cfg, x_seq, key,
                                             state=state, fused=fused, h0=h0)
        T = x_seq.shape[1]
        n_bits = self.spec.input_bits
        scale = self._weight_scale()
        gains_w = gains_u = None
        if key is not None and self.draws_noise:
            k1s, k2s = (np.stack(ks) for ks in zip(*self.step_keys(key, T)))
            gains_w = self._sample_gains(k1s, x_seq.device)
            gains_u = self._sample_gains(k2s, x_seq.device)
        drive = kops.wbs_input_drive(x_seq, params["w_h"], n_bits,
                                     weight_scale=scale, gains=gains_w)
        h_all, h_prev, pre = kops.wbs_miru_scan(
            drive, params["u_h"], params["b_h"], h0, beta=cfg.beta,
            lam=cfg.lam, n_bits=n_bits, adc_bits=self.spec.adc_bits,
            adc_range=self.spec.adc_range, weight_scale=scale,
            gains=gains_u)
        # Same counter keys and totals as the per-step path: the hoisted
        # drive is one (B·T)-row access of w_h; the scan is T per-step
        # accesses of u_h plus T ADC readouts.
        tele = self.telemetry
        tele.meter_vmm(x_seq, params["w_h"], n_bits, "w_h")
        with tele.scaled(T):
            tele.meter_vmm(h_all[:, 0, :], params["u_h"], n_bits, "u_h")
            tele.meter_adc(pre[:, 0, :], "hidden")
        return h_all, h_prev, pre

    def quantize_readout(self, pre: torch.Tensor) -> torch.Tensor:
        if self.spec.adc_bits is None:
            return pre
        return adc_quantize(pre, self.spec.adc_bits, self.spec.adc_range)

    def apply_update(self, params: Params, updates: Params,
                     key: Optional[np.ndarray] = None
                     ) -> tuple[Params, Params]:
        """Exact digital write, clipped to the logical dynamic range;
        ``applied`` is what landed after the clip."""
        clip = self.spec.weight_clip
        new_params, applied = {}, {}
        for name, p in params.items():
            w = p + updates[name]
            if clip is not None:
                w = torch.clamp(w, -clip, clip)
            new_params[name] = w
            applied[name] = w - p
        return new_params, applied
