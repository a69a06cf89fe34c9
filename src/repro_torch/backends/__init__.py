"""Device backends — one algorithm, many substrates.

- base:     the DeviceBackend protocol and the DeviceSpec record.
- registry: name-keyed factory registry (register_backend / get_backend).
- ideal:    full-precision software substrate, exact writes.
- wbs:      WBS-quantized digital path — input quantization + ADC, fused
            one-kernel recurrence, plane-gain noise, clipped writes.

The ``analog``, ``analog_state`` and ``cmos`` substrates and fault
injection arrive with later slices (ROADMAP queue A).
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
