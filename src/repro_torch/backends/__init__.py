"""Device backends — one algorithm, many substrates.

- base:         the DeviceBackend protocol and the DeviceSpec record.
- registry:     name-keyed factory registry (register_backend /
                get_backend).
- ideal:        full-precision software substrate, exact writes.
- wbs:          WBS-quantized digital path — input quantization + ADC,
                fused one-kernel recurrence, plane-gain noise, clipped
                writes, optional in-kernel read noise.
- analog:       the mixed-signal crossbar: wbs + read noise, write noise,
                programming levels.
- analog_state: conductance-domain G⁺/G⁻ pairs carried as device state.
- cmos:         the digital-CMOS baseline of the 29× comparison.

Fault injection arrives with a later slice (ROADMAP queue A).
"""
from repro_torch.backends.base import DeviceBackend, DeviceSpec
from repro_torch.backends.registry import (available_backends, get_backend,
                                           register_backend,
                                           unregister_backend)
from repro_torch.backends.ideal import IdealBackend
from repro_torch.backends.wbs import WBSBackend
from repro_torch.backends.analog import AnalogBackend
from repro_torch.backends.analog_state import AnalogStateBackend
from repro_torch.backends.cmos import CMOSBackend

__all__ = [
    "DeviceBackend", "DeviceSpec",
    "available_backends", "get_backend", "register_backend",
    "unregister_backend", "IdealBackend", "WBSBackend", "AnalogBackend",
    "AnalogStateBackend", "CMOSBackend",
]
