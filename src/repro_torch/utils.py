"""Small shared helpers: integer tiling arithmetic, the Glorot
initializer, and device resolution."""
from __future__ import annotations

import math
from typing import Union

import torch


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return ceil_div(a, b) * b


def glorot_uniform(generator: torch.Generator, shape: tuple[int, ...],
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Glorot/Xavier uniform over the last two axes (fan_in, fan_out),
    drawn on the generator's device."""
    limit = math.sqrt(6.0 / (shape[-2] + shape[-1]))
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    return out.uniform_(-limit, limit, generator=generator)


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``torch.device(device)``, refusing CUDA where no card is present:
    a CUDA entry point never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev
