"""Layer blocks and stacks, the dense part — counterpart of
``repro/models/blocks.py``.

Layer = pre-norm GQA attention + pre-norm SwiGLU FFN. The layers' tensors
are stacked along a leading L axis, so the parameter tree is the
reference's; where the reference scans over that axis, the port loops
over it in Python (eager PyTorch has no scan to compile). With
``cfg.remat`` (the default) a layer run under autograd saves only its
input and recomputes its forward in the backward
(``torch.utils.checkpoint``, the counterpart of the reference's
``jax.checkpoint`` around the scan body).

Not ported yet, each raising with its ROADMAP item (queue A, LM zoo):
MoE FFNs, MLA, SSM (mamba2) and hybrid (jamba) layers, cross-attention
(encoder-decoder) and the ``miru`` mixer.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import rms_norm, rope_angles, swiglu
from repro_torch.utils import (Seed, split_seed, tree_leaves,
                               truncated_normal_init as tn)

PyTree = Any


def require_dense(cfg: ModelConfig, is_ssm: bool = False,
                  is_moe: bool = False, cross_attn: bool = False) -> None:
    """Raise for every layer kind the port does not run yet."""
    missing = [name for name, on in (
        ("SSM (mamba2) layers", is_ssm or cfg.layer_pattern == "ssm"),
        ("hybrid (jamba) superblocks", cfg.layer_pattern == "hybrid"),
        ("MoE FFNs", is_moe or cfg.n_experts > 0),
        ("MLA attention", cfg.use_mla),
        ("encoder-decoder cross-attention",
         cross_attn or cfg.is_encoder_decoder),
        ("modality frontends", cfg.frontend != "none"),
        ("the miru mixer", cfg.mixer == "miru"),
        (f"quant_mode={cfg.quant_mode!r}", cfg.quant_mode != "none"),
    ) if on]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (ROADMAP "
            "queue A, LM zoo); the port runs the dense family")


# ---------------------------------------------------------------------------
# Single layer
# ---------------------------------------------------------------------------

def init_ffn_params(key: Seed, cfg: ModelConfig, is_moe: bool = False,
                    device: Union[str, torch.device] = "cuda") -> dict:
    require_dense(cfg, is_moe=is_moe)
    D, Fd = cfg.d_model, cfg.d_ff
    k1, k2, k3 = split_seed(key, 3)
    return {"w_gate": tn(k1, (D, Fd), D ** -0.5, cfg.dtype, device),
            "w_up": tn(k2, (D, Fd), D ** -0.5, cfg.dtype, device),
            "w_down": tn(k3, (Fd, D), Fd ** -0.5, cfg.dtype, device)}


def init_layer_params(key: Seed, cfg: ModelConfig, is_ssm: bool = False,
                      is_moe: bool = False, cross_attn: bool = False,
                      device: Union[str, torch.device] = "cuda") -> dict:
    require_dense(cfg, is_ssm, is_moe, cross_attn)
    ks = split_seed(key, 4)
    D = cfg.d_model
    p: dict = {"norm1": torch.ones((D,), dtype=cfg.dtype, device=device),
               "mixer": attn.init_gqa_params(ks[0], cfg, device)}
    if cfg.d_ff > 0:
        p["norm2"] = torch.ones((D,), dtype=cfg.dtype, device=device)
        p["ffn"] = init_ffn_params(ks[2], cfg, device=device)
    return p


def _ffn(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if "ffn" not in p:
        return x
    h = rms_norm(x, p["norm2"], cfg.rmsnorm_eps)
    f = p["ffn"]
    return x + swiglu(h, f["w_gate"], f["w_up"], f["w_down"],
                      cfg.quant_mode).to(x.dtype)


def layer_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, is_ssm: bool = False,
                  is_moe: bool = False, causal: bool = True,
                  memory: Optional[torch.Tensor] = None,
                  memory_positions: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    require_dense(cfg, is_ssm, is_moe, cross_attn=memory is not None)
    h = rms_norm(x, p["norm1"], cfg.rmsnorm_eps)
    x = x + attn.gqa_attention(p["mixer"], cfg, h, positions,
                               causal).to(x.dtype)
    return _ffn(p, cfg, x)


# ---------------------------------------------------------------------------
# Stacked layers
# ---------------------------------------------------------------------------

def layer_slice(stacked: PyTree, i: int) -> PyTree:
    """Layer ``i`` of a stacked (L, …) tree (views, no copies)."""
    if isinstance(stacked, dict):
        return {k: layer_slice(v, i) for k, v in stacked.items()}
    return stacked[i]


def n_stacked(stacked: PyTree) -> int:
    while isinstance(stacked, dict):
        stacked = next(iter(stacked.values()))
    return stacked.shape[0]


def _stack(trees: list) -> PyTree:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_stack(key: Seed, cfg: ModelConfig, n_layers: int,
               is_ssm: bool = False, is_moe: bool = False,
               cross_attn: bool = False,
               device: Union[str, torch.device] = "cuda") -> PyTree:
    keys = split_seed(key, n_layers)
    return _stack([init_layer_params(k, cfg, is_ssm, is_moe, cross_attn,
                                     device) for k in keys])


def stack_forward(stacked: PyTree, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, is_ssm: bool = False,
                  is_moe: bool = False, causal: bool = True, memory=None,
                  memory_positions=None) -> torch.Tensor:
    for i in range(n_stacked(stacked)):
        lp = layer_slice(stacked, i)
        args = (lp, cfg, x, positions, is_ssm, is_moe, causal, memory,
                memory_positions)
        if cfg.remat and torch.is_grad_enabled() and (x.requires_grad or any(
                t.requires_grad for t in tree_leaves(lp))):
            x = checkpoint(layer_forward, *args, use_reentrant=False)
        else:
            x = layer_forward(*args)
    return x


def stack_decode(stacked: PyTree, caches: PyTree, cfg: ModelConfig,
                 x: torch.Tensor, pos: int, is_ssm: bool = False,
                 write_rows: Optional[torch.Tensor] = None
                 ) -> tuple[torch.Tensor, PyTree]:
    """One-token decode through the stack; caches are stacked (L, …) and
    written in place (``write_rows`` as in ``attention.cache_insert``)."""
    require_dense(cfg, is_ssm)
    # Every layer rotates by the same position: its rope angles once.
    angles = rope_angles(torch.full((x.shape[0], 1), pos, device=x.device),
                         cfg.hd(), cfg.rope_theta)
    for i in range(n_stacked(stacked)):
        lp = layer_slice(stacked, i)
        h = rms_norm(x, lp["norm1"], cfg.rmsnorm_eps)
        mixed, _ = attn.gqa_decode(lp["mixer"], cfg, h,
                                   layer_slice(caches, i), pos, angles,
                                   write_rows)
        x = _ffn(lp, cfg, x + mixed.to(x.dtype))
    return x, caches
