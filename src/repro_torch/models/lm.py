"""Top-level language models: init, loss value, prefill, decode —
counterpart of ``repro/models/lm.py`` for the dense, moe (MLA included),
ssm and hybrid families.

A decoder-only model: token embedding, a stack of layers, a final
RMSNorm and a tied or separate LM head. The stack is GQA + SwiGLU
(dense), GQA + MoE (moe, after ``first_dense_layers`` dense layers), the
mamba2 SSD mixer with no FFN (ssm) or jamba's superblocks (hybrid); with
``cfg.use_mla`` (deepseek-v3) the attention is MLA. The prefill's
attention takes the flash-attention kernel when the prompt is longer than
``cfg.attn_chunk``; decode reads a bf16 or int8 KV cache through full
attention (MLA: its bf16 latent cache through the absorbed form) and
steps the SSM state. With
``cfg.quant_mode`` naming a device backend every projection but the
router and a tied head runs on that substrate (``layers.dense``); with
``cfg.mixer == "miru"`` the layers' mixer is the MiRU recurrence
(``blocks.miru_mixer``), which has no decode, as in the reference.
Encoder-decoder models and modality frontends raise with their ROADMAP
item.

Parameters are a dict of tensors with the reference's tree (layers
stacked along a leading L axis, superblocks along theirs);
``convert.lm_params_from_numpy`` brings the reference's across.
:func:`loss_fn` differentiates (``train/trainer`` takes its gradients),
through the flash kernels on the flash branch and with each layer (each
superblock) recomputed in the backward when ``cfg.remat`` is set;
prefill and decode run without autograd.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import blocks
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import dense, rms_norm
from repro_torch.utils import (Seed, resolve_device,
                               softmax_cross_entropy_masked, split_seed,
                               tree_leaves, truncated_normal_init as tn)

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
    blocks.require_ported(cfg)
    dev = device if torch.device(device).type == "meta" \
        else resolve_device(device)
    ks = split_seed(key, 8)
    D = cfg.d_model
    p: dict = {"embed": tn(ks[0], (cfg.vocab, D), 0.02, cfg.dtype, dev),
               "final_norm": torch.ones((D,), dtype=cfg.dtype, device=dev)}
    if not cfg.tie_embeddings:
        p["lm_head"] = tn(ks[1], (D, cfg.vocab), D ** -0.5, cfg.dtype, dev)
    if cfg.layer_pattern == "hybrid":
        p["layers"] = blocks.init_hybrid_stack(ks[3], cfg, dev)
    elif cfg.layer_pattern == "ssm":
        p["layers"] = blocks.init_stack(ks[3], cfg, cfg.n_layers,
                                        is_ssm=True, device=dev)
    elif cfg.n_experts > 0:
        if cfg.first_dense_layers:
            p["dense_layers"] = blocks.init_stack(
                ks[3], cfg, cfg.first_dense_layers, device=dev)
        p["layers"] = blocks.init_stack(
            ks[4], cfg, cfg.n_layers - cfg.first_dense_layers, is_moe=True,
            device=dev)
    else:
        p["layers"] = blocks.init_stack(ks[3], cfg, cfg.n_layers,
                                        device=dev)
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
    blocks.require_ported(cfg)
    x = _embed_tokens(p, batch["tokens"])
    pos = torch.arange(x.shape[1], device=x.device)
    if cfg.layer_pattern == "hybrid":
        x = blocks.hybrid_forward(p["layers"], cfg, x, pos)
    else:
        if "dense_layers" in p:
            x = blocks.stack_forward(p["dense_layers"], cfg, x, pos)
        x = blocks.stack_forward(p["layers"], cfg, x, pos,
                                 is_ssm=cfg.layer_pattern == "ssm",
                                 is_moe=cfg.n_experts > 0)
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
    """The decode caches, zeroed: stacked (L, batch, max_len, Kh·hd) K/V
    in ``cfg.kv_cache_dtype`` (bf16, or int8 with its scales), MLA's bf16
    latent caches (``c_kv`` and ``k_rope``, (L, batch, max_len, ·)), the
    SSM states (L, batch, …) of an ssm model, each superblock slot's of a
    hybrid one, and ``{"dense", "moe"}`` where an MoE model has
    ``first_dense_layers``. A ``mixer="miru"`` model has no decode
    (:func:`blocks.require_decodable`)."""
    blocks.require_decodable(cfg)
    dev = resolve_device(device)
    if cfg.layer_pattern == "hybrid":
        return blocks.init_hybrid_caches(cfg, batch, max_len, dev)
    spec = attn.CacheSpec(batch, max_len, cfg.kv_cache_dtype)
    if cfg.layer_pattern == "ssm":
        one = ssm_mod.init_ssm_cache(cfg, batch, dev)
    elif cfg.use_mla:
        one = attn.init_mla_cache(cfg, spec, dev)
    else:
        one = attn.init_kv_cache(cfg, spec, dev)

    def stacked(n):
        return {k: torch.zeros((n,) + v.shape, dtype=v.dtype, device=dev)
                for k, v in one.items()}
    if cfg.n_experts > 0 and cfg.first_dense_layers:
        return {"dense": stacked(cfg.first_dense_layers),
                "moe": stacked(cfg.n_layers - cfg.first_dense_layers)}
    return stacked(cfg.n_layers)


def clear_cache_rows(caches: PyTree, rows) -> PyTree:
    """Zero the batch rows ``rows`` of every cache tensor (batch is each
    tensor's second axis), in place: a slot given to a new request
    starts from a fresh cache's state. The SSM state needs it (a decode
    reads all of it); a KV cache's and MLA's latent cache's stale entries
    are masked by position anyway. Returns ``caches``."""
    for t in tree_leaves(caches):
        t[:, rows] = 0
    return caches


def decode_step(p: dict, cfg: ModelConfig, caches: PyTree,
                tokens: torch.Tensor, pos,
                write_rows: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, PyTree]:
    """One new token for every sequence: tokens (B, 1) at write position
    ``pos`` (an int or a 0-d tensor; the same for every row, as in the
    reference). The caches (K/V and SSM state) are written in place, in
    the rows ``write_rows`` (indices or a bool mask; None: every row, the
    reference's behaviour). With a tensor ``pos`` and a mask the step
    reads nothing back to the host and can be captured in a CUDA graph.
    Returns (logits (B, 1, V), caches)."""
    blocks.require_decodable(cfg)
    with torch.no_grad():
        x = _embed_tokens(p, tokens)
        if cfg.layer_pattern == "hybrid":
            x, caches = blocks.hybrid_decode(p["layers"], caches, cfg, x,
                                             pos, write_rows)
        elif "dense_layers" in p:
            x, _ = blocks.stack_decode(p["dense_layers"], caches["dense"],
                                       cfg, x, pos, write_rows=write_rows)
            x, _ = blocks.stack_decode(p["layers"], caches["moe"], cfg, x,
                                       pos, write_rows=write_rows)
        else:
            x, caches = blocks.stack_decode(
                p["layers"], caches, cfg, x, pos,
                is_ssm=cfg.layer_pattern == "ssm", write_rows=write_rows)
        return _lm_logits(p, cfg, x), caches


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
