"""Small shared helpers: integer tiling arithmetic, the initializers,
and device resolution."""
from __future__ import annotations

import math
from typing import Union

import numpy as np
import torch

from repro_torch import prng

#: A ``torch.Generator`` or a :mod:`repro_torch.prng` key.
Seed = Union[torch.Generator, np.ndarray]


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return ceil_div(a, b) * b


def glorot_uniform(generator: Seed, shape: tuple[int, ...],
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Glorot/Xavier uniform over the last two axes (fan_in, fan_out).
    From a ``torch.Generator``: drawn on the generator's device. From a
    :mod:`repro_torch.prng` key: the reference's draw bit for bit, on the
    CPU."""
    limit = math.sqrt(6.0 / (shape[-2] + shape[-1]))
    if not isinstance(generator, torch.Generator):
        return prng.uniform(generator, shape, -limit, limit).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    return out.uniform_(-limit, limit, generator=generator)


def normal_init(key: np.ndarray, shape: tuple[int, ...], stddev: float,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """stddev · N(0, 1) from a :mod:`repro_torch.prng` key, on the CPU:
    the reference's ``normal_init`` to within 3 ulp of its normal draw."""
    return (float(np.float32(stddev)) * prng.normal(key, shape)).to(dtype)


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``torch.device(device)``, refusing CUDA where no card is present:
    a CUDA entry point never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                          ) -> torch.Tensor:
    """Mean cross-entropy; ``labels`` are integer class ids (B,)."""
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - ll)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Fraction of rows whose arg-max logit is the label."""
    return torch.mean((torch.argmax(logits, dim=-1) == labels)
                      .to(torch.float32))
