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

Fault injection (``DeviceSpec(faults=FaultSpec(...))``,
:mod:`repro_torch.faults`): the sampled masks ride the device state
under ``"_faults"``; ``device_vmm`` reads the logical weights through
them, ``device_apply_update`` rejects the writes aimed at stuck cells and
advances wear-out, and transient read upsets corrupt the per-step
readout (on a 4-way key split a step, the reference's). ``faults=None``
builds no masks and runs the program it always ran.
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
from repro_torch.faults.model import (FaultSpec, advance_wear,
                                      apply_cell_faults, apply_read_upsets,
                                      fault_state, mask_updates,
                                      sample_fault_state)
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
      faults       a :class:`~repro_torch.faults.FaultSpec`: stuck cells,
                   dead lines, read upsets, endurance wear-out. None (the
                   default) builds no masks.
    """
    input_bits: Optional[int] = None
    adc_bits: Optional[int] = None
    adc_range: float = 4.0
    gain_sigma: float = 0.0
    weight_clip: Optional[float] = None
    crossbar: Optional[CrossbarSpec] = None
    track_endurance: bool = False
    faults: Optional[FaultSpec] = None


class DeviceBackend(abc.ABC):
    """Abstract substrate. Subclasses implement ``vmm``."""

    name: str = "abstract"

    def __init__(self, spec: Optional[DeviceSpec] = None):
        self.spec = spec if spec is not None else self.default_spec()
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
        """The substrate's physical state for ``params``: None for the
        stateless substrates, unless the spec carries a
        :class:`FaultSpec`: then ``{"_faults": masks}``, sampled from
        ``key`` (``PRNGKey(0)`` without one)."""
        if self.spec.faults is None:
            return None
        return {"_faults": self._sample_faults(params, key)}

    def _sample_faults(self, params: Params,
                       key: Optional[np.ndarray]) -> dict:
        fkey = key if key is not None else prng.PRNGKey(0)
        return sample_fault_state(params, fkey, self.spec.faults,
                                  sa1_value=self._fault_value_scale())

    def _fault_value_scale(self) -> float:
        """Logical magnitude a stuck-at-G_on (SA1) cell reads as."""
        return self.spec.weight_clip or 1.0

    def device_apply_update(self, params: Params, updates: Params,
                            key: Optional[np.ndarray] = None,
                            state: Optional[Any] = None
                            ) -> tuple[Params, Params, Optional[Any]]:
        """``apply_update`` that also advances the device state (the
        stateless substrates carry it through). Write pulses are metered
        afterwards, in :meth:`record_endurance`. Under fault masks the
        writes aimed at stuck cells are zeroed before they reach the
        substrate (no pulse, no endurance cost), and with wear-out on the
        per-cell counters advance on the applied updates."""
        fspec = self.spec.faults
        fstate = fault_state(state)
        if fstate is not None:
            updates = mask_updates(updates, fstate)
        new_params, applied, state = self._apply_update_impl(
            params, updates, key, state)
        if fstate is not None and fspec is not None and fspec.wearout:
            state = dict(state)
            state["_faults"] = advance_wear(
                fstate, applied, fspec, new_params,
                sa1_value=self._fault_value_scale())
        return new_params, applied, state

    def _apply_update_impl(self, params, updates, key, state):
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
        :meth:`prepare_weights` result for the same params and state.
        Under fault masks the logical weights are read through the tile's
        stuck-cell mask here: one masked tensor feeds the product and the
        straight-through gradient, so gradients at stuck cells vanish."""
        fstate = fault_state(state)
        if fstate is not None and tag in fstate:
            weights = apply_cell_faults(weights, fstate[tag])
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

    def forward_draws(self, state: Optional[Any] = None) -> bool:
        """Whether the forward's products consume their keys under
        ``state`` (:attr:`draws_noise`, or a per-chip overlay's read
        noise on the substrates that take one)."""
        return self.draws_noise

    def upset_rate(self, state: Optional[Any] = None) -> float:
        """The read-upset rate of a forward through ``state``: the spec's
        ``upset_rate`` when the state carries fault masks, else 0."""
        fspec = self.spec.faults
        if fspec is None or fault_state(state) is None:
            return 0.0
        return fspec.upset_rate

    def step_keys(self, key: Optional[np.ndarray], T: int,
                  state: Optional[Any] = None
                  ) -> list[tuple[Optional[np.ndarray], ...]]:
        """The per-step keys (k1, k2, k3) of the reference's per-step
        scan, which splits its carried key three ways every step, or four
        under read upsets (k3 draws the upsets; None otherwise). k1 and
        k2 are None when the products draw no noise; nothing is derived
        when neither they nor the upsets consume a key. Upsets need a
        key."""
        upsets = self.upset_rate(state) > 0
        if upsets and key is None:
            raise ValueError("read upsets (FaultSpec.upset_rate > 0) need "
                             "a PRNG key")
        draws = self.forward_draws(state)
        if key is None or not (draws or upsets):
            return [(None, None, None)] * T
        out = []
        for _ in range(T):
            if upsets:
                key, k1, k2, k3 = prng.split(key, 4)
            else:
                (key, k1, k2), k3 = prng.split(key, 3), None
            out.append((k1, k2, k3) if draws else (None, None, k3))
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
        reaches the same totals. Read upsets (``FaultSpec.upset_rate``)
        corrupt each step's readout after the ADC."""
        del fused
        B, T, _ = x_seq.shape
        prepared = self.prepare_weights(params, state=state)
        keys = self.step_keys(key, T, state)
        upset_rate = self.upset_rate(state)
        h = h0 if h0 is not None else torch.zeros(
            (B, cfg.n_h), dtype=cfg.dtype, device=x_seq.device)
        h_all, h_prev, pre_all = [], [], []
        for t in range(T):
            k1, k2, k3 = keys[t]
            pre = self.device_vmm(x_seq[:, t], params["w_h"], k1,
                                  state=state, tag="w_h",
                                  prepared=prepared) \
                + self.device_vmm(cfg.beta * h, params["u_h"], k2,
                                  state=state, tag="u_h",
                                  prepared=prepared) \
                + params["b_h"]
            pre = self.device_readout(pre)
            if upset_rate > 0:
                pre = apply_read_upsets(pre, k3, upset_rate,
                                        self.spec.adc_range)
            h_new = cfg.lam * h + (1.0 - cfg.lam) * tanh_f32(pre)
            h_all.append(h_new)
            h_prev.append(h)
            pre_all.append(pre)
            h = h_new
        return (torch.stack(h_all, 1), torch.stack(h_prev, 1),
                torch.stack(pre_all, 1))

    def __repr__(self) -> str:
        return f"<{type(self).__name__} name={self.name!r} spec={self.spec}>"
