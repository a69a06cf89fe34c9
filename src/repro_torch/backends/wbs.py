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
per-access read noise into the kernel.

Fault masks (``state["_faults"]``) apply to the logical weights before
the scale division, on both paths: the fused recurrence reads ``w_h`` and
``u_h`` through them before the drive and the scan, so fused and
per-step stay bitwise equal under static faults. Read upsets draw a
fresh corruption every step and take the per-step path.

The quantizers round, so their gradient is zero almost everywhere. Under
autograd (BPTT + Adam) the products and the ADC are straight-through
estimators, as in the reference: the forward returns the quantized
value, computed on detached operands (the kernels never see an input
that requires grad), and the backward is that of the linear product with
the raw logical weights (:class:`SteMatmul`) or of the identity
(:class:`SteIdentity`).
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
from repro_torch.faults.model import apply_cell_faults, fault_state
from repro_torch.kernels import ops as kops


class SteMatmul(torch.autograd.Function):
    """``y_quant`` forward; backward that of ``drive @ weights``: (0,
    g @ Wᵀ, driveᵀ @ g), leading axes of ``drive`` folded into rows."""

    @staticmethod
    def forward(ctx, y_quant, drive, weights):
        ctx.save_for_backward(drive, weights)
        return y_quant

    @staticmethod
    def backward(ctx, g):
        drive, weights = ctx.saved_tensors
        g_drive = g @ weights.T if ctx.needs_input_grad[1] else None
        g_w = None
        if ctx.needs_input_grad[2]:
            d2 = drive.reshape(-1, drive.shape[-1])
            g_w = (d2.T @ g.reshape(-1, g.shape[-1])).to(weights.dtype)
        return None, g_drive, g_w


class SteIdentity(torch.autograd.Function):
    """``y_quant`` forward; the gradient passes to ``x`` unchanged."""

    @staticmethod
    def forward(ctx, y_quant, x):
        return y_quant

    @staticmethod
    def backward(ctx, g):
        return None, g


def ste_matmul(y_quant: torch.Tensor, drive: torch.Tensor,
               weights: torch.Tensor) -> torch.Tensor:
    """The quantized product ``y_quant`` with the straight-through
    gradient of ``drive @ weights`` where autograd tracks either operand;
    ``y_quant`` itself otherwise."""
    if not kops.tracks_grad(drive, weights):
        return y_quant
    return SteMatmul.apply(y_quant.detach(), drive, weights)


def ste_identity(y_quant: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y_quant`` with the identity's gradient to ``x`` where autograd
    tracks ``x``."""
    if not kops.tracks_grad(x):
        return y_quant
    return SteIdentity.apply(y_quant.detach(), x)


@register_backend("wbs")
class WBSBackend(DeviceBackend):
    name = "wbs"

    @classmethod
    def default_spec(cls) -> DeviceSpec:
        return DeviceSpec(input_bits=8, adc_bits=8, adc_range=4.0,
                          weight_clip=1.5)

    def _weight_scale(self) -> float:
        return self.spec.weight_clip if self.spec.weight_clip else 1.0

    def _fault_value_scale(self) -> float:
        # SA1 cells saturate at the logical dynamic range.
        return self._weight_scale()

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
        per-call division; fault masks apply before it, as
        ``device_vmm`` applies them per call."""
        fstate = fault_state(state)
        scale = self._weight_scale()
        prepared = {}
        for name, p in params.items():
            if p.ndim < 2:
                continue
            if fstate is not None and name in fstate:
                p = apply_cell_faults(p, fstate[name])
            prepared[name] = p / scale
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
        y = kops.wbs_dense(drive.detach(), w.detach().to(torch.float32),
                           n_bits=n_bits, adc_bits=None,
                           gains=self._sample_gains(key, drive.device),
                           read_sigma=read_sigma, read_key=read_key)
        return ste_matmul(y * scale, drive, weights)

    def _fused_recurrence_ok(self, state=None) -> bool:
        """The fused scan needs a WBS drive and the output ADC: the ADC
        re-quantizes the integrator every step, which is what makes the
        fused kernel bitwise equal to the per-step loop. It reads the
        logical weights, so a device state rules it out, except one that
        carries only fault masks (they apply to the weights before either
        path reads them). Read upsets draw inside the loop and rule it
        out."""
        masks_only = state is None or (isinstance(state, dict)
                                       and not set(state) - {"_faults"})
        return (masks_only and self.upset_rate(state) == 0
                and self.spec.input_bits is not None
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
        fstate = fault_state(state)
        if fstate is not None:
            # The masked weights the per-step path reads, up front.
            params = {n: (apply_cell_faults(p, fstate[n]) if n in fstate
                          else p) for n, p in params.items()}
        T = x_seq.shape[1]
        n_bits = self.spec.input_bits
        scale = self._weight_scale()
        gains_w = gains_u = None
        if key is not None and self.draws_noise:
            k1s, k2s, _ = (list(ks) for ks in zip(*self.step_keys(key, T)))
            k1s, k2s = np.stack(k1s), np.stack(k2s)
            gains_w = self._sample_gains(k1s, x_seq.device)
            gains_u = self._sample_gains(k2s, x_seq.device)
        drive = kops.wbs_input_drive(x_seq.detach(), params["w_h"].detach(),
                                     n_bits, weight_scale=scale,
                                     gains=gains_w)
        drive = ste_matmul(drive, x_seq, params["w_h"])
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
        q = adc_quantize(pre.detach(), self.spec.adc_bits,
                         self.spec.adc_range)
        return ste_identity(q, pre)

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
