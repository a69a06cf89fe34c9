"""Move parameters between the packages as numpy arrays."""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from repro_torch.utils import resolve_device


def params_from_numpy(params: dict[str, np.ndarray],
                      device: Union[str, torch.device] = "cuda"
                      ) -> dict[str, torch.Tensor]:
    """``{name: array}`` → ``{name: tensor}`` on ``device``, same dtype and
    bits — e.g. ``{k: np.asarray(v) for k, v in jax_params.items()}``, so
    both packages compute with the same weights."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, copy=True)).to(dev)
            for k, v in params.items()}
