"""Top-level language models: init, loss value, prefill, decode —
counterpart of ``repro/models/lm.py`` for every family of the zoo: dense,
moe (MLA included), ssm, hybrid, encoder-decoder and the modality
prefixes.

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

Encoder-decoder (``cfg.is_encoder_decoder``, seamless): the batch's
``frames`` (B, T_enc, D), precomputed frame embeddings, go through
``frontend_proj``, a bidirectional encoder stack and ``enc_norm``
(:func:`_encode`); the decoder stack runs causal self-attention and
cross-attention over that memory. Its decode cache holds the decoder's
self K/V plus the memory's cross K/V, bf16 whatever
``kv_cache_dtype`` is, and each row's ``enc_len``; :func:`init_cache`
leaves the cross memory empty (``enc_len=0``), as the reference's
engine serves it.

A vision prefix (``cfg.frontend == "vision"``, llava): the batch's
``patches`` (B, n_img, D) go through ``frontend_proj`` in front of the
token embeddings, rope positions run over prefix and text, and the
prefix is sliced off before the head; without ``patches`` the model is
text-only, and its decode has no prefix, as in the reference.

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
from repro_torch.distributed.context import act_constraint, whole_dim
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
    dev = _device(device)
    ks = split_seed(key, 8)
    D = cfg.d_model
    p: dict = {"embed": tn(ks[0], (cfg.vocab, D), 0.02, cfg.dtype, dev),
               "final_norm": torch.ones((D,), dtype=cfg.dtype, device=dev)}
    if not cfg.tie_embeddings:
        p["lm_head"] = tn(ks[1], (D, cfg.vocab), D ** -0.5, cfg.dtype, dev)
    if cfg.frontend != "none":
        p["frontend_proj"] = tn(ks[2], (D, D), D ** -0.5, cfg.dtype, dev)
    if cfg.is_encoder_decoder:
        p["encoder"] = blocks.init_stack(ks[3], cfg, cfg.n_enc_layers,
                                         device=dev)
        p["enc_norm"] = torch.ones((D,), dtype=cfg.dtype, device=dev)
        p["decoder"] = blocks.init_stack(ks[4], cfg, cfg.n_layers,
                                         cross_attn=True, device=dev)
    elif cfg.layer_pattern == "hybrid":
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


def _device(device: Union[str, torch.device]) -> torch.device:
    """``resolve_device``, with the ``meta`` device let through (shapes
    and dtypes, no allocation)."""
    dev = torch.device(device)
    return dev if dev.type == "meta" else resolve_device(dev)


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


def _frontend(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Precomputed frame or patch embeddings (B, T, D) on the params'
    device in ``cfg.dtype``, through ``frontend_proj`` (a plain product:
    no quant_mode, as the reference)."""
    x = x.to(p["embed"].device, cfg.dtype)
    return dense(x, p["frontend_proj"]) if cfg.frontend != "none" else x


def _prefix_embeds(p: dict, cfg: ModelConfig, batch: dict
                   ) -> Optional[torch.Tensor]:
    """The modality prefix of a decoder-only model: the batch's
    ``frames`` (audio) or ``patches`` (vision) through ``frontend_proj``;
    None without a frontend or without its key in the batch."""
    key = {"audio": "frames", "vision": "patches"}.get(cfg.frontend)
    if key is None or key not in batch:
        return None
    return _frontend(p, cfg, batch[key])


# ---------------------------------------------------------------------------
# Forward / loss
# ---------------------------------------------------------------------------

def _encode(p: dict, cfg: ModelConfig, frames: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """An encoder-decoder model's memory: ``frames`` (B, T_enc, D) through
    ``frontend_proj``, the bidirectional encoder stack at positions
    ``arange(T_enc)`` and ``enc_norm``. Returns (memory (B, T_enc, D),
    its positions (T_enc,)). The decoder's cross-attention reads it; a
    decode's cross cache holds each layer's ``cross.wk`` / ``wv`` of
    it."""
    mem = _frontend(p, cfg, frames)
    mem_pos = torch.arange(mem.shape[1], device=mem.device)
    mem = blocks.stack_forward(p["encoder"], cfg, mem, mem_pos,
                               causal=False)
    return rms_norm(mem, p["enc_norm"], cfg.rmsnorm_eps), mem_pos


def forward(p: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """batch {"tokens": (B, S) int}, plus "frames" (B, T_enc, D) for an
    encoder-decoder model and, optionally, "patches" (B, n_img, D) for a
    vision one. Returns the text's logits (B, S, V). Under a sharding
    context with DTensor parameters the residual stream is laid out
    ``btd`` after the embedding and before the head, and the logits
    ``btv``, where the reference constrains them."""
    x = act_constraint(_embed_tokens(p, batch["tokens"]), "btd")
    if cfg.is_encoder_decoder:
        mem, mem_pos = _encode(p, cfg, batch["frames"])
        pos = torch.arange(x.shape[1], device=x.device)
        x = blocks.stack_forward(p["decoder"], cfg, x, pos, memory=mem,
                                 memory_positions=mem_pos)
        return _lm_logits(p, cfg, x)
    prefix = _prefix_embeds(p, cfg, batch)
    if prefix is not None:
        x = torch.cat([prefix, x], dim=1)
    pos = torch.arange(x.shape[1], device=x.device)
    if cfg.layer_pattern == "hybrid":
        x = blocks.hybrid_forward(p["layers"], cfg, x, pos)
    else:
        if "dense_layers" in p:
            x = blocks.stack_forward(p["dense_layers"], cfg, x, pos)
        x = blocks.stack_forward(p["layers"], cfg, x, pos,
                                 is_ssm=cfg.layer_pattern == "ssm",
                                 is_moe=cfg.n_experts > 0)
    if prefix is not None:
        x = x[:, prefix.shape[1]:]
    x = act_constraint(x, "btd")
    return act_constraint(_lm_logits(p, cfg, x), "btv")


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
               device: Union[str, torch.device] = "cuda",
               enc_len: int = 0) -> PyTree:
    """The decode caches, zeroed: stacked (L, batch, max_len, Kh·hd) K/V
    in ``cfg.kv_cache_dtype`` (bf16, or int8 with its scales), MLA's bf16
    latent caches (``c_kv`` and ``k_rope``, (L, batch, max_len, ·)), the
    SSM states (L, batch, …) of an ssm model, each superblock slot's of a
    hybrid one, and ``{"dense", "moe"}`` where an MoE model has
    ``first_dense_layers``. An encoder-decoder model's is ``{"self",
    "cross_k", "cross_v", "enc_len"}``: the decoder's self K/V, the
    memory's K and V (L, batch, ``enc_len``, Kh·hd) in bf16 whatever
    ``kv_cache_dtype`` is, and each row's memory length (batch,) int32,
    0. A ``mixer="miru"`` model has no decode
    (:func:`blocks.require_decodable`). ``device="meta"`` gives shapes
    and dtypes only."""
    blocks.require_decodable(cfg)
    dev = _device(device)
    if cfg.is_encoder_decoder:
        cross = (cfg.n_layers, batch, enc_len, cfg.n_kv_heads * cfg.hd())
        return {"self": _stacked(attn.init_kv_cache(
                    cfg, attn.CacheSpec(batch, max_len, cfg.kv_cache_dtype),
                    dev), cfg.n_layers, dev),
                "cross_k": torch.zeros(cross, dtype=torch.bfloat16,
                                       device=dev),
                "cross_v": torch.zeros(cross, dtype=torch.bfloat16,
                                       device=dev),
                "enc_len": torch.zeros((batch,), dtype=torch.int32,
                                       device=dev)}
    if cfg.layer_pattern == "hybrid":
        return blocks.init_hybrid_caches(cfg, batch, max_len, dev)
    spec = attn.CacheSpec(batch, max_len, cfg.kv_cache_dtype)
    if cfg.layer_pattern == "ssm":
        one = ssm_mod.init_ssm_cache(cfg, batch, dev)
    elif cfg.use_mla:
        one = attn.init_mla_cache(cfg, spec, dev)
    else:
        one = attn.init_kv_cache(cfg, spec, dev)

    if cfg.n_experts > 0 and cfg.first_dense_layers:
        return {"dense": _stacked(one, cfg.first_dense_layers, dev),
                "moe": _stacked(one, cfg.n_layers - cfg.first_dense_layers,
                                dev)}
    return _stacked(one, cfg.n_layers, dev)


def _stacked(one: dict, n: int, dev: torch.device) -> dict:
    """``one`` layer's cache tensors, zeroed, stacked along a leading n."""
    return {k: torch.zeros((n,) + v.shape, dtype=v.dtype, device=dev)
            for k, v in one.items()}


def clear_cache_rows(caches: PyTree, rows) -> PyTree:
    """Zero the batch rows ``rows`` of every cache tensor, in place: a
    slot given to a new request starts from a fresh cache's state. Batch
    is each stacked tensor's second axis and the encoder-decoder's
    ``enc_len``'s first (found by its key): a cleared row has an empty
    cross memory. The SSM state needs it (a decode reads all of it); a KV
    cache's and MLA's latent cache's stale entries are masked by position
    anyway. Returns ``caches``."""
    enc_len = caches.get("enc_len") if isinstance(caches, dict) else None
    for t in tree_leaves(caches):
        if t is enc_len:
            t[rows] = 0
        else:
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
    reference's behaviour); an encoder-decoder model's cross K/V and
    ``enc_len`` are read, never written. With a tensor ``pos`` and a mask
    the step reads nothing back to the host and can be captured in a
    CUDA graph. Returns (logits (B, 1, V), caches)."""
    blocks.require_decodable(cfg)
    with torch.no_grad():
        x = _embed_tokens(p, tokens)
        if cfg.is_encoder_decoder:
            x, _ = blocks.stack_decode(
                p["decoder"], caches["self"], cfg, x, pos,
                write_rows=write_rows,
                cross_kv=(caches["cross_k"], caches["cross_v"]),
                enc_len=caches["enc_len"])
        elif cfg.layer_pattern == "hybrid":
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


def encode_cross_kv(p: dict, cfg: ModelConfig, frames: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The cross K and V an encoder-decoder decode reads, from ``frames``
    (B, T_enc, D): the memory of :func:`_encode` through each decoder
    layer's ``cross.wk`` and ``cross.wv`` (their biases where the config
    has them), rounded to bf16. Returns two (L, B, T_enc, Kh·hd) tensors
    to copy into an :func:`init_cache` tree built with ``enc_len`` ≥
    T_enc (and the rows' ``enc_len`` set). The reference's engine has no
    encoder pass; this is for checks and callers that fill the cache."""
    with torch.no_grad():
        mem, _ = _encode(p, cfg, frames)
        cross = p["decoder"]["cross"]
        kv = [torch.stack([dense(mem, cross[w][i], cross[b][i]
                                 if b in cross else None).to(torch.bfloat16)
                           for i in range(cfg.n_layers)])
              for w, b in (("wk", "bk"), ("wv", "bv"))]
    return kv[0], kv[1]


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    """The last position's argmax. Sharded logits gather their vocab
    first: DTensor's own sharded argmax fails where two mesh dims shard
    the vocab."""
    return torch.argmax(whole_dim(logits[:, -1, :], -1), dim=-1).to(
        torch.int32)
