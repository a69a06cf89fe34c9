"""Device backends — one algorithm, many substrates.

- base:     the DeviceBackend protocol and the DeviceSpec record.
- registry: name-keyed factory registry (register_backend / get_backend).
- ideal:    full-precision software substrate.
- wbs:      WBS-quantized digital path — input quantization + ADC, fused
            one-kernel recurrence.

The ``analog``, ``analog_state`` and ``cmos`` substrates, fault
injection and the write path arrive with later slices (ROADMAP queue A).
"""
from repro_torch.backends.base import DeviceBackend, DeviceSpec
from repro_torch.backends.registry import (available_backends, get_backend,
                                           register_backend,
                                           unregister_backend)
from repro_torch.backends.ideal import IdealBackend
from repro_torch.backends.wbs import WBSBackend

__all__ = [
    "DeviceBackend", "DeviceSpec",
    "available_backends", "get_backend", "register_backend",
    "unregister_backend", "IdealBackend", "WBSBackend",
]
