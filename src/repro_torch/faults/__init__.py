"""Device-fault injection and graceful degradation — counterpart of
``repro/faults``.

Fault masks ride the device-state dict under ``"_faults"`` (next to the
fleet overlay ``"_het"``) through every step, evaluation and fleet chip.
Attach a :class:`FaultSpec` to a backend's ``DeviceSpec(faults=...)``;
leave it None and every program is the one without faults, bit for bit.
"""
from repro_torch.faults.mitigate import (calibration_drives,
                                         compensate_bias, march_recover,
                                         recalibrate, remap_columns)
from repro_torch.faults.model import (FaultSpec, advance_wear,
                                      apply_cell_faults, apply_read_upsets,
                                      effective_masks, fault_state,
                                      mask_updates, sample_fault_state,
                                      stuck_fraction)

__all__ = [
    "FaultSpec", "advance_wear", "apply_cell_faults", "apply_read_upsets",
    "calibration_drives", "compensate_bias", "effective_masks",
    "fault_state", "march_recover", "mask_updates", "recalibrate",
    "remap_columns", "sample_fault_state", "stuck_fraction",
]
