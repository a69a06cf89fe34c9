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

Not ported: ``gain_sigma > 0`` (its per-plane noise comes from
jax.random; ROADMAP queue A1) and fault masks.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.analog.adc import adc_quantize
from repro_torch.backends.base import DeviceBackend, DeviceSpec, Params
from repro_torch.backends.registry import register_backend
from repro_torch.kernels import ops as kops


@register_backend("wbs")
class WBSBackend(DeviceBackend):
    name = "wbs"

    def __init__(self, spec: Optional[DeviceSpec] = None):
        super().__init__(spec)
        if self.spec.gain_sigma > 0:
            raise NotImplementedError(
                "gain_sigma > 0 needs bit-exact jax.random replay, which "
                "waits for the threefry port (ROADMAP queue A1)")

    @classmethod
    def default_spec(cls) -> DeviceSpec:
        return DeviceSpec(input_bits=8, adc_bits=8, adc_range=4.0,
                          weight_clip=1.5)

    def _weight_scale(self) -> float:
        return self.spec.weight_clip if self.spec.weight_clip else 1.0

    def prepare_weights(self, params: Params) -> Optional[dict]:
        """Hoist the once-per-forward logical-scale division of every ≥2-D
        weight out of the per-step loop. Each entry has the bits of the
        per-call division."""
        scale = self._weight_scale()
        prepared = {name: p / scale for name, p in params.items()
                    if p.ndim >= 2}
        return prepared or None

    def _vmm_impl(self, drive, weights, tag, prepared):
        w = prepared.get(tag) if prepared else None
        return self.vmm(drive, weights, prepared=w)

    def vmm(self, drive: torch.Tensor, weights: torch.Tensor,
            prepared: Optional[torch.Tensor] = None) -> torch.Tensor:
        """WBS crossbar product. ``prepared`` is this tile's
        :meth:`prepare_weights` entry."""
        n_bits = self.spec.input_bits or 8
        scale = self._weight_scale()
        w = prepared if prepared is not None else weights / scale
        y = kops.wbs_dense(drive, w.to(torch.float32), n_bits=n_bits,
                           adc_bits=None)
        return y * scale

    def _fused_recurrence_ok(self) -> bool:
        """The fused scan needs a WBS drive and the output ADC: the ADC
        re-quantizes the integrator every step, which is what makes the
        fused kernel bitwise equal to the per-step loop."""
        return (self.spec.input_bits is not None
                and self.spec.adc_bits is not None)

    def device_recurrence(self, params, cfg, x_seq, *, fused=None, h0=None):
        """Fused WBS×MiRU recurrence: ONE batched crossbar product for the
        input projection (no sequential dependency) and one kernel for
        the sequential part. Falls back to the per-step loop where the
        gate refuses or the caller asks (``fused=False``)."""
        if fused is False or not self._fused_recurrence_ok():
            return super().device_recurrence(params, cfg, x_seq,
                                             fused=fused, h0=h0)
        T = x_seq.shape[1]
        n_bits = self.spec.input_bits
        scale = self._weight_scale()
        drive = kops.wbs_input_drive(x_seq, params["w_h"], n_bits,
                                     weight_scale=scale)
        h_all, h_prev, pre = kops.wbs_miru_scan(
            drive, params["u_h"], params["b_h"], h0, beta=cfg.beta,
            lam=cfg.lam, n_bits=n_bits, adc_bits=self.spec.adc_bits,
            adc_range=self.spec.adc_range, weight_scale=scale)
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
