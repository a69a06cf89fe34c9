"""Name-keyed registry of device backends — counterpart of
``repro/backends/registry.py``.

    @register_backend("my_device")
    class MyBackend(DeviceBackend):
        ...

    backend = get_backend("my_device", spec=DeviceSpec(adc_bits=6))
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

from repro_torch.backends.base import DeviceBackend, DeviceSpec

_REGISTRY: dict[str, Callable[..., DeviceBackend]] = {}


def register_backend(name: str,
                     factory: Optional[Callable[..., DeviceBackend]] = None):
    """Register a backend factory (usable as a class decorator). The
    factory is called as ``factory(spec=..., **kwargs)``."""
    def _do(f):
        _REGISTRY[name] = f
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


def unregister_backend(name: str) -> None:
    """Remove a registered backend (test teardown helper)."""
    _REGISTRY.pop(name, None)
