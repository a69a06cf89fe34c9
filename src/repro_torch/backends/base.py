"""Device-backend protocol — the seam between algorithm and substrate.

Counterpart of ``repro/backends/base.py``:

  vmm(drive, weights, key)  forward matrix–vector product — where input
                            quantization, bit-streaming and plane-gain
                            noise live.
  quantize_readout(pre)     the fused output ADC, applied after the bias
                            add (identity for digital paths).
  prepare_weights(params)   per-forward weight preparation, hoisted out
                            of the per-step loop.
  device_recurrence(...)    the whole MiRU recurrence on this substrate.
  apply_update(params, dw)  the weight write (exact, or clipped to the
                            substrate's dynamic range).
  record_endurance(applied) host-side write counting into telemetry.

Every backend carries a :class:`~repro_torch.telemetry.Telemetry`
accumulator (disabled by default) that the ``device_*`` wrappers meter.

Stochastic substrates draw from :mod:`repro_torch.prng` keys, on the
reference's key chains. Substrates whose physical state is not the
logical weight matrix (the conductance-domain ``analog_state``) thread an
opaque dict through the train loop: ``init_device_state`` creates it,
``device_vmm`` reads through it, ``device_apply_update`` advances it;
stateless substrates return and ignore None. ``track_endurance``
attaches an :class:`~repro_torch.analog.endurance.EnduranceTracker`.
Fault injection (``FaultSpec``) is not ported yet: a spec that asks for
it raises.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.analog.crossbar import CrossbarSpec
from repro_torch.analog.endurance import EnduranceTracker
from repro_torch.kernels.ref import tanh_f32
from repro_torch.telemetry.meters import Telemetry

Params = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """Substrate description consumed by a :class:`DeviceBackend`.

      input_bits   sign-magnitude drive precision (None = full precision).
      adc_bits     fused readout ADC precision (None = no quantization).
      adc_range    symmetric ADC full scale, logical units.
      gain_sigma   WBS per-plane memristor-ratio variability (§V-A).
      weight_clip  logical dynamic range of a stored weight (None = ∞).
      crossbar     device physics (read/write/programming noise, levels,
                   drift) of the analog substrates.
      track_endurance  attach an :class:`EnduranceTracker`.
      faults       a fault model; only None is ported.
    """
    input_bits: Optional[int] = None
    adc_bits: Optional[int] = None
    adc_range: float = 4.0
    gain_sigma: float = 0.0
    weight_clip: Optional[float] = None
    crossbar: Optional[CrossbarSpec] = None
    track_endurance: bool = False
    faults: Optional[Any] = None


class DeviceBackend(abc.ABC):
    """Abstract substrate. Subclasses implement ``vmm``."""

    name: str = "abstract"

    def __init__(self, spec: Optional[DeviceSpec] = None):
        self.spec = spec if spec is not None else self.default_spec()
        if self.spec.faults is not None:
            raise NotImplementedError(
                "fault injection is not ported yet (ROADMAP queue A, "
                "faults/); use faults=None")
        self.tracker: Optional[EnduranceTracker] = \
            EnduranceTracker() if self.spec.track_endurance else None
        self.telemetry = Telemetry(enabled=False)

    @classmethod
    def default_spec(cls) -> DeviceSpec:
        return DeviceSpec()

    @abc.abstractmethod
    def vmm(self, drive: torch.Tensor, weights: torch.Tensor,
            key: Optional[np.ndarray] = None) -> torch.Tensor:
        """y = drive @ weights on this substrate. drive (..., n_in),
        weights (n_in, n_out). ``key`` feeds per-access noise; a backend
        is deterministic when it is None."""

    @property
    def draws_noise(self) -> bool:
        """Whether the forward consumes its PRNG keys. When it does not,
        the per-step key chain is not derived: no result depends on it."""
        return False

    @abc.abstractmethod
    def apply_update(self, params: Params, updates: Params,
                     key: Optional[np.ndarray] = None
                     ) -> tuple[Params, Params]:
        """Write ``updates`` (already lr-scaled and sparsified) into
        ``params``. Returns (new_params, applied), ``applied`` being the
        deltas that actually landed (after clipping)."""

    def record_endurance(self, applied: Params) -> None:
        """Write counting into the endurance tracker and the telemetry's
        write pulses (only nonzero applied updates cost one); a no-op
        unless either is on. The masks stay on their device: neither
        reads them back here."""
        if self.tracker is None and not self.telemetry.enabled:
            return
        masks = {k: v != 0 for k, v in applied.items() if v.ndim >= 2}
        self.telemetry.meter_writes(masks)
        if self.tracker is not None:
            self.tracker.record_update(masks)

    def init_device_state(self, params: Params,
                          key: Optional[np.ndarray] = None) -> Any:
        """The substrate's physical state for ``params``; None for the
        stateless substrates."""
        del params, key
        return None

    def device_apply_update(self, params: Params, updates: Params,
                            key: Optional[np.ndarray] = None,
                            state: Optional[Any] = None
                            ) -> tuple[Params, Params, Optional[Any]]:
        """``apply_update`` that also advances the device state (the
        stateless substrates carry it through). Write pulses are metered
        afterwards, in :meth:`record_endurance`."""
        new_params, applied = self.apply_update(params, updates, key)
        return new_params, applied, state

    def quantize_readout(self, pre: torch.Tensor) -> torch.Tensor:
        """Fused output ADC, applied after the bias add. Identity by
        default."""
        return pre

    def prepare_weights(self, params: Params, *, state: Optional[Any] = None
                        ) -> Optional[dict[str, Any]]:
        """Per-forward weight preparation keyed by crossbar tag
        (``w_h``/``u_h``/``w_o``), computed once before the per-step loop
        and passed to every :meth:`device_vmm`. None (the default) means
        each call derives what it needs, with the same bits."""
        del params, state
        return None

    def device_vmm(self, drive: torch.Tensor, weights: torch.Tensor,
                   key: Optional[np.ndarray] = None, *,
                   state: Optional[Any] = None, tag: str = "",
                   prepared: Optional[dict[str, Any]] = None
                   ) -> torch.Tensor:
        """``vmm`` + activity metering + the device-state read. ``tag``
        names the crossbar tile; ``prepared`` is a
        :meth:`prepare_weights` result for the same params and state."""
        y = self._vmm_impl(drive, weights, key, state, tag, prepared)
        self.telemetry.meter_vmm(drive, weights, self.spec.input_bits, tag)
        return y

    def _vmm_impl(self, drive, weights, key, state, tag,
                  prepared) -> torch.Tensor:
        return self.vmm(drive, weights, key)

    def device_readout(self, pre: torch.Tensor,
                       tag: str = "hidden") -> torch.Tensor:
        """``quantize_readout`` + ADC-conversion metering."""
        q = self.quantize_readout(pre)
        if self.spec.adc_bits is not None:
            self.telemetry.meter_adc(pre, tag)
        return q

    def step_keys(self, key: Optional[np.ndarray], T: int
                  ) -> list[tuple[Optional[np.ndarray], ...]]:
        """The per-step keys (k1, k2) of the reference's per-step scan,
        which splits its carried key three ways every step; all None when
        no key is given or the forward draws no noise."""
        if key is None or not self.draws_noise:
            return [(None, None)] * T
        out = []
        for _ in range(T):
            key, k1, k2 = prng.split(key, 3)
            out.append((k1, k2))
        return out

    def device_recurrence(self, params: Params, cfg, x_seq: torch.Tensor,
                          key: Optional[np.ndarray] = None, *,
                          state: Optional[Any] = None,
                          fused: Optional[bool] = None,
                          h0: Optional[torch.Tensor] = None
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
        """Run the MiRU hidden recurrence (eqs. 1-2) over x_seq
        (B, T, n_x). ``cfg`` carries beta, lam, n_h and dtype. ``key``
        feeds the per-step noise (the reference's chain: a 3-way split per
        step, one subkey per tile); ``state`` is the device state the
        reads go through. ``h0`` (B, n_h) resumes from a carried
        hidden state (the serve engine's slab); None starts from zeros.
        Returns (h_all, h_prev, pre), each (B, T, n_h).

        The default is the per-step loop: two ``device_vmm`` calls and
        one ``device_readout`` per step. Substrates with a fused path
        override this; ``fused`` lets a caller force the per-step path
        (False) and is otherwise ignored here. Metering happens once per
        step, so a fused override that meters once under ``scaled(T)``
        reaches the same totals."""
        del fused
        B, T, _ = x_seq.shape
        prepared = self.prepare_weights(params, state=state)
        keys = self.step_keys(key, T)
        h = h0 if h0 is not None else torch.zeros(
            (B, cfg.n_h), dtype=cfg.dtype, device=x_seq.device)
        h_all, h_prev, pre_all = [], [], []
        for t in range(T):
            k1, k2 = keys[t]
            pre = self.device_vmm(x_seq[:, t], params["w_h"], k1,
                                  state=state, tag="w_h",
                                  prepared=prepared) \
                + self.device_vmm(cfg.beta * h, params["u_h"], k2,
                                  state=state, tag="u_h",
                                  prepared=prepared) \
                + params["b_h"]
            pre = self.device_readout(pre)
            h_new = cfg.lam * h + (1.0 - cfg.lam) * tanh_f32(pre)
            h_all.append(h_new)
            h_prev.append(h)
            pre_all.append(pre)
            h = h_new
        return (torch.stack(h_all, 1), torch.stack(h_prev, 1),
                torch.stack(pre_all, 1))

    def __repr__(self) -> str:
        return f"<{type(self).__name__} name={self.name!r} spec={self.spec}>"
