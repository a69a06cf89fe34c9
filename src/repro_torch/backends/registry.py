"""Name-keyed registry of device backends — counterpart of
``repro/backends/registry.py``.

    @register_backend("my_device")
    class MyBackend(DeviceBackend):
        ...

    backend = get_backend("my_device", spec=DeviceSpec(adc_bits=6))
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Union

from repro_torch.backends.base import DeviceBackend, DeviceSpec

_REGISTRY: dict[str, Callable[..., DeviceBackend]] = {}


def register_backend(name: str,
                     factory: Optional[Callable[..., DeviceBackend]] = None):
    """Register a backend factory (usable as a class decorator). The
    factory is called as ``factory(spec=..., **kwargs)``. Re-registering
    a name overwrites it and drops its shared :func:`inference_backend`
    instance."""
    def _do(f):
        _REGISTRY[name] = f
        inference_backend.cache_clear()
        return f
    return _do if factory is None else _do(factory)


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_backend(name: Union[str, DeviceBackend],
                spec: Optional[DeviceSpec] = None,
                spec_overrides: Optional[dict[str, Any]] = None,
                **kwargs) -> DeviceBackend:
    """Instantiate a registered backend by name (a fresh instance per
    call). ``spec_overrides`` replaces fields of ``spec``, or of the
    backend's own default spec when ``spec`` is None. An existing
    :class:`DeviceBackend` is returned unchanged."""
    if isinstance(name, DeviceBackend):
        if spec is not None or spec_overrides or kwargs:
            raise ValueError("cannot override the configuration of an "
                             "instantiated backend; construct a new one "
                             "instead")
        return name
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown device backend {name!r}; "
            f"available: {', '.join(available_backends()) or '(none)'}"
        ) from None
    if spec_overrides:
        if spec is None:
            spec = factory.default_spec()
        spec = dataclasses.replace(spec, **spec_overrides)
    return factory(spec=spec, **kwargs)


@functools.lru_cache(maxsize=None)
def inference_backend(name: str) -> DeviceBackend:
    """The shared backend instance of a registered name for inference-mode
    model layers (``models/layers.dense``, the miru mixer, the LM serve
    engine): the substrate's own spec with the inference overrides, an
    8-bit quantized drive, no readout ADC and a unit weight scale (the
    layers normalise their activations instead); gain noise and crossbar
    physics stay the backend's. One instance per name keeps one
    telemetry accumulator across every projection of a serving run."""
    return get_backend(name, spec_overrides=dict(input_bits=8,
                                                 adc_bits=None,
                                                 weight_clip=None))


def unregister_backend(name: str) -> None:
    """Remove a registered backend (test teardown helper)."""
    _REGISTRY.pop(name, None)
    inference_backend.cache_clear()
