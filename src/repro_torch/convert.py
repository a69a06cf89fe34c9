"""Move parameters, run state and device state between the packages as
numpy arrays."""
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


def run_state_from_numpy(key: np.ndarray, params: dict[str, np.ndarray],
                         psi: np.ndarray,
                         device: Union[str, torch.device] = "cuda"
                         ) -> tuple[np.ndarray, dict[str, torch.Tensor],
                                    torch.Tensor]:
    """A training run's initial state — (key, params, Ψ), e.g. the
    reference's ``_init_run`` output as numpy — as the port's
    ``run_continual(init=...)`` takes it: the key as a uint32 pair, the
    params and Ψ as tensors on ``device`` with the same bits."""
    dev = resolve_device(device)
    return (np.asarray(key, np.uint32).copy(), params_from_numpy(params, dev),
            torch.from_numpy(np.array(psi, copy=True)).to(dev))


def device_state_from_numpy(state, device: Union[str, torch.device] = "cuda"):
    """A device state as numpy — nested dicts of arrays, e.g. the
    reference ``analog_state``'s ``{"w_h": {"g_pos", "g_neg"}, ...,
    "_ticks"}`` — as tensors on ``device`` with the same bits and dtypes
    (None stays None), for ``run_continual(init=(key, params, Ψ,
    state))``."""
    if state is None:
        return None
    dev = resolve_device(device)
    if isinstance(state, dict):
        return {k: device_state_from_numpy(v, dev) for k, v in state.items()}
    return torch.from_numpy(np.array(state, copy=True)).to(dev)
