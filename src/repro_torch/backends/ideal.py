"""Ideal software substrate — full-precision matmuls. Counterpart of
``repro/backends/ideal.py`` (forward path). Recurrences use the base
per-step loop."""
from __future__ import annotations

import torch

from repro_torch.backends.base import DeviceBackend
from repro_torch.backends.registry import register_backend


@register_backend("ideal")
class IdealBackend(DeviceBackend):
    name = "ideal"

    def vmm(self, drive: torch.Tensor, weights: torch.Tensor
            ) -> torch.Tensor:
        return drive @ weights
