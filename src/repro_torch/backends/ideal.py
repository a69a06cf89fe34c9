"""Ideal software substrate — full-precision matmuls, exact writes.
Counterpart of ``repro/backends/ideal.py``. Recurrences use the base
per-step loop (the ideal float fused path is ``miru_forward(use_fused=
True)``, as in the reference)."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.backends.base import DeviceBackend, Params
from repro_torch.backends.registry import register_backend


@register_backend("ideal")
class IdealBackend(DeviceBackend):
    name = "ideal"

    def vmm(self, drive: torch.Tensor, weights: torch.Tensor,
            key: Optional[np.ndarray] = None) -> torch.Tensor:
        return drive @ weights

    def apply_update(self, params: Params, updates: Params,
                     key: Optional[np.ndarray] = None
                     ) -> tuple[Params, Params]:
        """The exact write ``p + u`` (the reference's
        ``optim.apply_updates``); every update lands as given."""
        return ({k: p + updates[k].to(p.dtype) for k, p in params.items()},
                updates)
