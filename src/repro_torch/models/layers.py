"""Primitive layers shared by every architecture — counterpart of
``repro/models/layers.py``.

``dense`` with a ``quant_mode`` other than ``"none"`` runs the
projection on a device substrate: the registered backend of that name,
through its shared inference instance (``backends.inference_backend``).
On ``"wbs"`` that is one launch of the bit-plane crossbar kernel
(``kernels/ops.wbs_dense``) a projection on the card.
"""
from __future__ import annotations

import functools
from typing import Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.backends.registry import inference_backend
from repro_torch.distributed.context import is_sharded, replicated
from repro_torch.utils import Seed, truncated_normal_init


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """x·rsqrt(mean(x²) + eps)·scale, in fp32, cast back to x's dtype."""
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.to(torch.float32)
            ).to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
          quant_mode: str = "none") -> torch.Tensor:
    """Linear layer x @ w (+ b) in x's dtype. Any ``quant_mode`` other
    than ``"none"`` names a registered device backend: the activations
    are normalised into the crossbar's [-1, 1] drive range by their
    absmax ``s`` over the whole tensor (every row shares it), streamed
    through the backend's ``device_vmm`` in fp32 (tag ``"dense"``,
    metered on the shared instance's telemetry when it is on) and scaled
    back by ``s``. No PRNG key is threaded: reads are the deterministic
    expectation. Under autograd the product's gradient is the
    straight-through one of the backend (``backends/wbs.ste_matmul``),
    and ``s`` is differentiated as autograd takes it. Under a sharding
    context a quantized product runs on whole tensors gathered to every
    rank (``context.replicated``): its absmax spans the whole tensor and
    its kernels take no DTensor."""
    if quant_mode != "none" and is_sharded(x):
        return replicated(lambda x, w, *b: dense(x, w, *b,
                                                quant_mode=quant_mode),
                          x, w, *(() if b is None else (b,)))
    if quant_mode != "none":
        backend = inference_backend(quant_mode)
        s = torch.clamp_min(torch.max(torch.abs(x)), 1e-6)
        y = backend.device_vmm((x / s).to(torch.float32),
                               w.to(torch.float32), tag="dense") * s
        y = y.to(x.dtype)
    else:
        y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def init_dense(key: Seed, d_in: int, d_out: int, dtype: torch.dtype,
               bias: bool = False, stddev: Optional[float] = None,
               device: Union[str, torch.device] = "cuda") -> dict:
    if stddev is None:
        stddev = d_in ** -0.5
    p = {"w": truncated_normal_init(key, (d_in, d_out), stddev, dtype,
                                    device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def promote(*ts: torch.Tensor) -> list[torch.Tensor]:
    """The operands cast to their promoted dtype (JAX's implicit
    promotion in a mixed einsum, made explicit)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def pos_index(pos, device: Union[str, torch.device]) -> torch.Tensor:
    """A decode position as a (1,) int64 tensor on ``device``: an int, or
    a tensor already there (the serve engine's, which a captured CUDA
    graph reads)."""
    if torch.is_tensor(pos):
        return pos.reshape(1).to(device=device, dtype=torch.long)
    return torch.full((1,), int(pos), dtype=torch.long, device=device)


def select_rows(write_rows: Optional[torch.Tensor], new: torch.Tensor,
                old: torch.Tensor) -> torch.Tensor:
    """``new`` in the batch rows ``write_rows`` (indices or a bool mask
    over the first axis; None: every row) and ``old`` elsewhere. The
    shapes stay static and nothing is read back to the host, so a decode
    that writes its caches through this can be captured in a CUDA
    graph."""
    if write_rows is None:
        return new
    if write_rows.dtype != torch.bool:
        write_rows = torch.zeros(new.shape[0], dtype=torch.bool,
                                 device=new.device).index_fill_(
            0, write_rows.to(new.device), True)
    return torch.where(write_rows.reshape((-1,) + (1,) * (new.ndim - 1)),
                       new, old)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def rope_freqs(head_dim: int, theta: float = 1e4,
               device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """θ^(-2i/hd), fp32; cached per (head_dim, θ, device) — the decode
    path asks for it in every layer of every step. Do not modify."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float = 1e4
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of positions × :func:`rope_freqs`, fp32, (..., S, hd/2)."""
    ang = positions.to(torch.float32)[..., None] * rope_freqs(
        head_dim, theta, positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: Optional[torch.Tensor],
               theta: float = 1e4,
               angles: Optional[tuple[torch.Tensor, torch.Tensor]] = None
               ) -> torch.Tensor:
    """x (..., S, H, hd) or (..., S, hd); positions (..., S), or their
    :func:`rope_angles` given as ``angles`` (computed once for every layer
    that shares them). The rotation is fp32; the result is cast back."""
    cos, sin = angles if angles is not None else rope_angles(
        positions, x.shape[-1], theta)
    if x.ndim == cos.ndim + 1:                               # (..., S, H, hd)
        cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, quant_mode: str = "none") -> torch.Tensor:
    h = F.silu(dense(x, w_gate, quant_mode=quant_mode)) \
        * dense(x, w_up, quant_mode=quant_mode)
    return dense(h, w_down, quant_mode=quant_mode)


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
             b_up=None, b_down=None, quant_mode: str = "none"
             ) -> torch.Tensor:
    """jax.nn.gelu's default is the tanh approximation; so is this."""
    h = F.gelu(dense(x, w_up, b_up, quant_mode=quant_mode),
               approximate="tanh")
    return dense(h, w_down, b_down, quant_mode=quant_mode)
