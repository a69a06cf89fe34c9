"""Top-level language models, the dense family: init, loss value,
prefill, decode — counterpart of ``repro/models/lm.py``.

A dense model is a decoder-only transformer: token embedding, a stack of
GQA + SwiGLU layers, a final RMSNorm and a tied or separate LM head. The
prefill's attention takes the flash-attention kernel when the prompt is
longer than ``cfg.attn_chunk``; decode reads a bf16 KV cache through
full attention. The other families (MoE, MLA, SSM, hybrid,
encoder-decoder, modality frontends, the ``miru`` mixer) and
``quant_mode != "none"`` raise with their ROADMAP item.

Parameters are a dict of tensors with the reference's tree (layers
stacked along a leading L axis); ``convert.lm_params_from_numpy`` brings
the reference's across. :func:`loss_fn` differentiates (``train/trainer``
takes its gradients), through the flash kernels on the flash branch and
with each layer recomputed in the backward when ``cfg.remat`` is set;
prefill and decode run without autograd.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import blocks
from repro_torch.models.layers import dense, rms_norm
from repro_torch.utils import (Seed, resolve_device, softmax_cross_entropy_masked,
                               split_seed, truncated_normal_init as tn)

PyTree = Any


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(key: Seed, cfg: ModelConfig,
                device: Union[str, torch.device] = "cuda") -> dict:
    """The parameter tree. From a :mod:`repro_torch.prng` key the draws
    are the reference's (fp32: within a few ulp) and take seconds per
    million parameters on the host; from a ``torch.Generator`` they are
    drawn on its device (use one on the card for a full-size model)."""
    blocks.require_dense(cfg)
    dev = device if torch.device(device).type == "meta" \
        else resolve_device(device)
    ks = split_seed(key, 8)
    D = cfg.d_model
    p: dict = {"embed": tn(ks[0], (cfg.vocab, D), 0.02, cfg.dtype, dev),
               "final_norm": torch.ones((D,), dtype=cfg.dtype, device=dev)}
    if not cfg.tie_embeddings:
        p["lm_head"] = tn(ks[1], (D, cfg.vocab), D ** -0.5, cfg.dtype, dev)
    p["layers"] = blocks.init_stack(ks[3], cfg, cfg.n_layers, device=dev)
    return p


def param_shapes(cfg: ModelConfig) -> PyTree:
    """The parameter tree on the ``meta`` device: shapes and dtypes, no
    allocation."""
    return init_params(None, cfg, device="meta")


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def _embed_tokens(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["embed"][tokens.to(p["embed"].device).long()]


def _lm_logits(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, p["final_norm"], cfg.rmsnorm_eps)
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, p["embed"].to(x.dtype))
    return dense(x, p["lm_head"], quant_mode=cfg.quant_mode)


# ---------------------------------------------------------------------------
# Forward / loss
# ---------------------------------------------------------------------------

def forward(p: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """batch {"tokens": (B, S) int}. Returns logits (B, S, V)."""
    blocks.require_dense(cfg)
    x = _embed_tokens(p, batch["tokens"])
    pos = torch.arange(x.shape[1], device=x.device)
    x = blocks.stack_forward(p["layers"], cfg, x, pos)
    return _lm_logits(p, cfg, x)


def loss_fn(p: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Token-masked cross-entropy, differentiable in ``p``. batch adds
    "labels" (B, S) and "mask" (B, S)."""
    logits = forward(p, cfg, batch)
    return softmax_cross_entropy_masked(
        logits.to(torch.float32), batch["labels"].to(logits.device),
        batch["mask"].to(logits.device))


def prefill(p: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Inference prefill: forward logits over the prompt, no autograd."""
    with torch.no_grad():
        return forward(p, cfg, batch)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Union[str, torch.device] = "cuda") -> PyTree:
    """Stacked (L, batch, max_len, Kh·hd) bf16 K/V caches, zeroed."""
    blocks.require_dense(cfg)
    dev = resolve_device(device)
    one = attn.init_kv_cache(cfg, attn.CacheSpec(batch, max_len,
                                                 cfg.kv_cache_dtype), dev)
    return {k: torch.zeros((cfg.n_layers,) + v.shape, dtype=v.dtype,
                           device=dev) for k, v in one.items()}


def decode_step(p: dict, cfg: ModelConfig, caches: PyTree,
                tokens: torch.Tensor, pos: int,
                write_rows: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, PyTree]:
    """One new token for every sequence: tokens (B, 1) at write position
    ``pos`` (the same for every row, as in the reference). The caches are
    written in place, in the rows ``write_rows`` (None: every row, the
    reference's behaviour). Returns (logits (B, 1, V), caches)."""
    blocks.require_dense(cfg)
    with torch.no_grad():
        x = _embed_tokens(p, tokens)
        x, caches = blocks.stack_decode(p["layers"], caches, cfg, x, int(pos),
                                        write_rows=write_rows)
        return _lm_logits(p, cfg, x), caches


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
