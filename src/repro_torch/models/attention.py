"""Attention: full, chunked and flash attention, the GQA block with
qk-norm and biases, the bf16 and int8 KV caches, and MLA (multi-head
latent attention, deepseek-v3) with its latent cache — counterpart of
``repro/models/attention.py``.

The flash branch (KV longer than ``cfg.attn_chunk``) runs the
hand-written flash-attention forward kernel through
``kernels.ops.flash_attention_fwd``, which folds the GQA head map into
the kernel instead of repeating K/V. It computes what the reference's
Pallas ``flash_attention_fwd_pallas`` computes; the reference's model
runs the same schedule in pure JAX (``_flash``), which in bf16 rounds
the scores and probabilities to bf16 where the kernels keep fp32, so the
port is held to the reference in fp32. The branch is differentiable: its
gradient is the hand-written flash backward (the dq and dk/dv kernels of
the Pallas ``flash_attention_bwd_pallas``, the GQA fold in the kernel)
behind a ``torch.autograd.Function``, where the reference's model
differentiates its ``_flash`` custom VJP (which, in bf16, also rounds p
and ds to bf16).

MLA's prefill and training (:func:`mla_attention`) expand the latents to
per-head keys of ``qk_nope + qk_rope`` columns and values of
``v_head_dim``, and take the flash kernels past ``attn_chunk`` at that
(dh, dv) pair (192 / 128 at deepseek-v3's widths, a pair the kernels are
built for). Its decode (:func:`mla_decode`) is the reference's absorbed
form, einsums over the bf16 latent cache (no kernel there, as in the
reference).

Under a sharding context (``distributed/context.py``) with DTensor
activations, self-attention takes one of two sharded branches, each
running :func:`sdpa` on every rank's local tensors under ``local_map``
(the flash kernel on the card, never DTensor's own attention):

- Ulysses (``attn_mode="ulysses"``, the heads dividing the model axis):
  GQA's K/V are repeated to the query heads, q, k and v resharded from
  sequence to heads (``bshd``, an all-to-all over the model axis), and
  each rank attends over the whole sequence with its heads.
- Gathered (``attn_mode="gather"``, or Ulysses with the heads not
  dividing the axis, where K/V are constrained ``bshd_full`` as the
  reference does): K/V whole on every rank, q kept sequence-sharded,
  each rank's causal mask offset by its model rank × S_local. A
  non-zero offset sends ``sdpa`` to :func:`full_attention`, not to the
  flash kernel (which takes no query offset); at one rank the offset is
  0, and without a mask (cross-attention) there is none. When the
  sequence does not divide the axis, q is gathered whole too (offset 0).

Cross-attention under a context takes the gathered branch (no mask).
Without a context every path is as before and takes no DTensor.

The int8 cache (``CacheSpec(dtype="int8")``, jamba's
``kv_cache_dtype``) stores each token's K and V as int8 codes with one
fp32 scale a token, stochastically rounded (:func:`_quantize_kv`). The
reference's decode passes no rng, so every insert draws from
``PRNGKey(0)`` split in two: the draws depend only on the (B, 1, kvd)
shape, and the port draws them once per shape and device
(:func:`_kv_draws`, ``prng.uniform``, bit for bit ``jax.random``'s) and
keeps them there. Codes, scales and the dequantised bf16 K/V are the
reference's bit for bit on the same inputs.

JAX promotes mixed bf16/fp32 einsums implicitly (an fp32 model's queries
against the bf16 cache); every einsum here casts both operands to their
promoted dtype, which is the same dtype.

The decode path writes the cache in place: :func:`cache_insert` updates
the cache tensors it is given and returns the same dict. ``write_rows``
picks the batch rows it writes; None writes every row, as the reference
does. The position may be a 0-d tensor and the rows a bool mask, and the
write reads nothing back to the host, so the serve engine captures the
whole decode in a CUDA graph.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Union

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.context import (act_constraint, current_context,
                                             is_sharded, partial, run_local,
                                             split_last, ulysses_enabled)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import (apply_rope, dense, pos_index,
                                      promote, rms_norm, select_rows)
from repro_torch.utils import Seed, split_seed, truncated_normal_init as tn


# ---------------------------------------------------------------------------
# Core softmax attention (full and chunked)
# ---------------------------------------------------------------------------

def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool, q_offset: int = 0,
                   kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B,Sq,H,dh), k/v (B,Sk,Kh,dh). Returns (B,Sq,H,dv) in q's dtype.

    GQA as grouped einsums (q reshaped to (…,Kh,G,dh)), never repeating
    K/V."""
    B, Sq, H, dh = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, Kh, H // Kh, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", *promote(qg, k)
                          ).to(torch.float32) * dh ** -0.5
    si = torch.arange(Sk, device=q.device)
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
        scores = torch.where(si[None, :] <= qi, scores, NEG_INF)
    if kv_len is not None:
        mask = si[None, :] < kv_len.to(q.device)[:, None]       # (B, Sk)
        scores = torch.where(mask[:, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", *promote(probs, v))
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool, chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV chunks (the flash schedule in
    plain PyTorch, as the reference's ``lax.scan``)."""
    B, Sq, H, dh = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    if Sk % chunk:
        pad = chunk - Sk % chunk
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    k = _repeat_kv(k, H // Kh)
    v = _repeat_kv(v, H // Kh)
    dv = v.shape[-1]
    qi = torch.arange(Sq, device=q.device)[:, None]
    acc = torch.zeros((B, H, Sq, dv), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    for j in range(k.shape[1] // chunk):
        kj = k[:, j * chunk:(j + 1) * chunk]
        vj = v[:, j * chunk:(j + 1) * chunk]
        scores = torch.einsum("bqhd,bkhd->bhqk", *promote(q, kj)
                              ).to(torch.float32) * dh ** -0.5
        ki = j * chunk + torch.arange(chunk, device=q.device)[None, :]
        valid = ki < Sk
        if causal:
            valid = valid & (ki <= qi)
        scores = torch.where(valid[None, None], scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", *promote(p.to(q.dtype), vj)).to(torch.float32)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)                    # (B,Sq,H,dv)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, chunk: int = 1024) -> torch.Tensor:
    """(B,Sq,H,dh) layout, through the flash kernel
    (``ops.flash_attention_fwd``, GQA folded, K/V not repeated).

    KV is padded to a chunk multiple and the padding masked by the true
    length (``sk_true``), as the reference's schedule does. The kernel
    needs no padding (it takes any Sk, and skips the tiles past
    ``sk_true``, so the output is the unpadded call's): the padding stays
    only so that a prompt off the chunk (the 1,100-token prefill twin)
    drives the kernel's ``sk_true`` mask as the reference's path does. A
    prompt on a chunk multiple, such as the 2,048-token prefill, pads
    nothing. Differentiable in q, k and v through the flash backward
    kernels (``ops.flash_attention_fwd``'s autograd Function); the
    padded keys get zero gradients, sliced away with the padding."""
    Sk = k.shape[1]
    if Sk % chunk:
        pad = chunk - Sk % chunk
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    out, _ = ops.flash_attention_fwd(q, k, v, causal=causal, sk_true=Sk)
    return out


def sdpa(q, k, v, causal: bool, chunk: int, q_offset: int = 0,
         kv_len=None) -> torch.Tensor:
    """Dispatch: the flash kernel for long KV, full attention otherwise."""
    if k.shape[1] > chunk and kv_len is None and q_offset == 0:
        return flash_attention(q, k, v, causal, chunk)
    return full_attention(q, k, v, causal, q_offset, kv_len)


def _ulysses_sdpa(q, k, v, causal: bool, chunk: int) -> torch.Tensor:
    """Ulysses: q, k, v (the same head count) resharded sequence → heads
    (``bshd``), :func:`sdpa` on each rank's heads over the whole
    sequence, the output head-sharded."""
    ctx = current_context()
    q, k, v = (act_constraint(t, "bshd") for t in (q, k, v))
    bshd = ctx.placements("bshd")
    out = run_local(lambda q, k, v: sdpa(q, k, v, causal=causal,
                                         chunk=chunk),
                    (bshd,), (bshd, bshd, bshd), q, k, v)
    return act_constraint(out, "bshd")


def _gathered_sdpa(q, k, v, causal: bool, chunk: int) -> torch.Tensor:
    """K/V whole on every rank, q sequence-sharded under sequence
    parallelism (whole when S does not divide the model axis), each
    rank's causal mask offset by the queries before its own."""
    ctx = current_context()
    n = ctx.size(ctx.model_axis)
    seq = ctx.sequence_parallel and q.shape[1] % n == 0
    full = ctx.placements("bshd_full")
    qp = ctx.placements("bshd_seq") if seq else full
    s_loc = q.shape[1] // n

    def local(q, k, v):
        off = ctx.mesh.get_local_rank(ctx.model_axis) * s_loc \
            if seq and causal else 0
        return sdpa(q, k, v, causal=causal, chunk=chunk, q_offset=off)

    kv_grad = partial(full) if seq else full
    return run_local(local, (qp,), (qp, full, full), q, k, v,
                     grad_placements=(qp, kv_grad, kv_grad))


# ---------------------------------------------------------------------------
# GQA block-level attention with projections
# ---------------------------------------------------------------------------

def init_gqa_params(key: Seed, cfg: ModelConfig,
                    device: Union[str, torch.device] = "cuda") -> dict:
    hd, D = cfg.hd(), cfg.d_model
    ks = split_seed(key, 6)
    std = D ** -0.5
    p = {
        "wq": tn(ks[0], (D, cfg.n_heads * hd), std, cfg.dtype, device),
        "wk": tn(ks[1], (D, cfg.n_kv_heads * hd), std, cfg.dtype, device),
        "wv": tn(ks[2], (D, cfg.n_kv_heads * hd), std, cfg.dtype, device),
        "wo": tn(ks[3], (cfg.n_heads * hd, D), std, cfg.dtype, device),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                        ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros((n * hd,), dtype=cfg.dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=cfg.dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=cfg.dtype, device=device)
    return p


def _qkv(p: dict, cfg: ModelConfig, x: torch.Tensor, src: torch.Tensor):
    """Projected q (B,S,H,hd), k and v (B,S_src,Kh,hd), qk-normed."""
    q = split_last(dense(x, p["wq"], p.get("bq"), cfg.quant_mode),
                   cfg.n_heads)
    k = split_last(dense(src, p["wk"], p.get("bk"), cfg.quant_mode),
                   cfg.n_kv_heads)
    v = split_last(dense(src, p["wv"], p.get("bv"), cfg.quant_mode),
                   cfg.n_kv_heads)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rmsnorm_eps)
        k = rms_norm(k, p["k_norm"], cfg.rmsnorm_eps)
    return q, k, v


def gqa_attention(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, causal: bool = True,
                  kv: Optional[tuple] = None,
                  kv_positions: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Self-attention (kv=None) or cross-attention (kv=(keys_src,)).
    x (B,S,D); positions (B,S) or (S,). Under a sharding context, the
    Ulysses or the gathered branch (module docstring)."""
    B, S, _ = x.shape
    src = x if kv is None else kv[0]
    q, k, v = _qkv(p, cfg, x, src)
    if kv is None:                       # rope only for self-attention
        q = apply_rope(q, torch.broadcast_to(positions, (B, S)),
                       cfg.rope_theta)
        k = apply_rope(k, torch.broadcast_to(positions, (B, S)),
                       cfg.rope_theta)
    ctx = current_context()
    if ctx is not None and is_sharded(q):
        if kv is None and ulysses_enabled(cfg.n_heads):
            rep = cfg.n_heads // cfg.n_kv_heads
            out = _ulysses_sdpa(q, _repeat_kv(k, rep), _repeat_kv(v, rep),
                                causal, cfg.attn_chunk)
        else:
            if kv is None and ctx.attn_mode == "ulysses":
                k = act_constraint(k, "bshd_full")
                v = act_constraint(v, "bshd_full")
            out = _gathered_sdpa(q, k, v, causal and kv is None,
                                 cfg.attn_chunk)
    else:
        out = sdpa(q, k, v, causal=causal and kv is None,
                   chunk=cfg.attn_chunk)
    return dense(out.reshape(B, S, cfg.n_heads * cfg.hd()), p["wo"],
                 quant_mode=cfg.quant_mode)


# ---------------------------------------------------------------------------
# KV cache (decode path)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CacheSpec:
    batch: int
    max_len: int
    dtype: str = "bf16"     # bf16 | int8


def init_kv_cache(cfg: ModelConfig, spec: CacheSpec,
                  device: Union[str, torch.device] = "cuda") -> dict:
    """Zeroed (batch, max_len, Kh·hd) K and V: bf16 whatever the model's
    dtype (as the reference: an fp32 model's decode reads K/V rounded to
    bf16), or int8 codes with (batch, max_len, 1) fp32 scales."""
    if spec.dtype not in ("bf16", "int8"):
        raise ValueError(f"KV cache dtype {spec.dtype!r}: bf16 or int8")
    shape = (spec.batch, spec.max_len, cfg.n_kv_heads * cfg.hd())
    if spec.dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:2] + (1,), dtype=torch.float32,
                                       device=device),
                "v_scale": torch.zeros(shape[:2] + (1,), dtype=torch.float32,
                                       device=device)}
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


@functools.lru_cache(maxsize=None)
def _kv_draws(shape: tuple[int, ...], device: torch.device
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The uniform draws of K's and V's stochastic rounding at ``shape``:
    ``jax.random.uniform`` of ``split(PRNGKey(0))``'s two keys, the keys
    the reference's rng-less insert takes. Drawn once per shape and
    device and kept there. Do not modify."""
    r1, r2 = prng.split(prng.PRNGKey(0))
    return (prng.uniform(r1, shape, device=device),
            prng.uniform(r2, shape, device=device))


def _quantize_kv(x: torch.Tensor, r: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token int8 with stochastic rounding (the paper's replay-buffer
    quantizer, eq. 4-6): fp32 ``x`` (…, kvd) and its uniform draws ``r``
    → int8 codes and (…, 1) fp32 scales."""
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    # A tensor divisor: CUDA turns division by a Python scalar into a
    # product with its reciprocal, which is not the reference's rounding.
    scale = amax / torch.full_like(amax, 127.0)
    z = x / torch.where(scale == 0, 1.0, scale)
    fl = torch.floor(z)
    q = torch.where(r < z - fl, fl + 1.0, fl)
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def cache_insert(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                 pos, write_rows: Optional[torch.Tensor] = None) -> dict:
    """Write one token's k/v (B, 1, kvd) at position ``pos`` (an int or a
    0-d tensor), in place, in the rows ``write_rows`` (indices or a bool
    mask over B; None: every row, as the reference); the other rows keep
    what they held there. An int8 cache takes the codes and the scales of
    :func:`_quantize_kv`, each row with the reference's draws for that
    row. Returns ``cache``."""
    if "k_scale" in cache:
        rk, rv = _kv_draws(tuple(k_new.shape), k_new.device)
        kq, ks = _quantize_kv(k_new.to(torch.float32), rk)
        vq, vs = _quantize_kv(v_new.to(torch.float32), rv)
        new = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        new = {"k": k_new, "v": v_new}
    _write_at(cache, new, pos_index(pos, k_new.device), write_rows)
    return cache


def _write_at(cache: dict, new: dict, idx: torch.Tensor,
              write_rows: Optional[torch.Tensor]) -> None:
    """Each ``new[name]`` (B, 1, ·) into ``cache[name]`` at position
    ``idx`` (a (1,) tensor), in place, in the rows ``write_rows`` (None:
    every row); the other rows keep what they held there."""
    for name, val in new.items():
        buf = cache[name]
        val = select_rows(write_rows, val.to(buf.dtype),
                          buf.index_select(1, idx))
        buf.index_copy_(1, idx, val)


def cache_read(cache: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """K and V as bf16: an int8 cache's codes times their scales, each
    rounded to bf16 first, as the reference."""
    if "k_scale" in cache:
        return tuple(cache[n].to(torch.bfloat16)
                     * cache[f"{n}_scale"].to(torch.bfloat16)
                     for n in ("k", "v"))
    return cache["k"], cache["v"]


def gqa_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict,
               pos, angles: tuple[torch.Tensor, torch.Tensor],
               write_rows: Optional[torch.Tensor] = None
               ) -> tuple[torch.Tensor, dict]:
    """One-token decode: x (B,1,D) at position ``pos`` (an int or a 0-d
    tensor), cache over max_len (written in place at ``pos`` in
    ``write_rows``). ``angles``:
    the rope (cos, sin) of ``pos`` (``layers.rope_angles``), computed once
    by the caller for every layer. Returns (out, cache)."""
    B, S, _ = x.shape
    hd = cfg.hd()
    q, k, v = _qkv(p, cfg, x, x)
    q = apply_rope(q, None, angles=angles)
    k = apply_rope(k, None, angles=angles)
    cache = cache_insert(cache, k.reshape(B, S, -1), v.reshape(B, S, -1),
                         pos, write_rows)
    k_all, v_all = cache_read(cache)
    L = k_all.shape[1]
    out = full_attention(q, k_all.reshape(B, L, cfg.n_kv_heads, hd),
                         v_all.reshape(B, L, cfg.n_kv_heads, hd),
                         causal=False,
                         kv_len=(pos_index(pos, x.device) + 1).expand(B))
    return dense(out.reshape(B, S, cfg.n_heads * hd), p["wo"],
                 quant_mode=cfg.quant_mode), cache


# ---------------------------------------------------------------------------
# MLA — Multi-head Latent Attention (deepseek-v3)
# ---------------------------------------------------------------------------

def init_mla_params(key: Seed, cfg: ModelConfig,
                    device: Union[str, torch.device] = "cuda") -> dict:
    D, H = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    ks = split_seed(key, 6)
    return {
        "q_down": tn(ks[0], (D, qr), D ** -0.5, cfg.dtype, device),
        "q_norm": torch.ones((qr,), dtype=cfg.dtype, device=device),
        "q_up": tn(ks[1], (qr, H * (dn + dr)), qr ** -0.5, cfg.dtype,
                   device),
        "kv_down": tn(ks[2], (D, kvr + dr), D ** -0.5, cfg.dtype, device),
        "kv_norm": torch.ones((kvr,), dtype=cfg.dtype, device=device),
        "kv_up": tn(ks[3], (kvr, H * (dn + dv)), kvr ** -0.5, cfg.dtype,
                    device),
        "wo": tn(ks[4], (H * dv, D), (H * dv) ** -0.5, cfg.dtype, device),
    }


def _mla_query(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """q through ``q_down``, its norm and ``q_up``: (q_nope, q_rope), each
    (B, S, H, ·)."""
    dn = cfg.qk_nope_head_dim
    q = dense(rms_norm(dense(x, p["q_down"], quant_mode=cfg.quant_mode),
                       p["q_norm"], cfg.rmsnorm_eps),
              p["q_up"], quant_mode=cfg.quant_mode)
    q = split_last(q, cfg.n_heads)
    return q[..., :dn], q[..., dn:]


def mla_attention(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, causal: bool = True
                  ) -> torch.Tensor:
    """Training/prefill MLA: the latents expanded to per-head keys (the
    nope part from ``kv_up``, the rope part shared by every head) and
    values, then :func:`sdpa` at (dh, dv) = (nope + rope, v): the flash
    kernels past ``attn_chunk``, scale (nope + rope)^-0.5. x (B, S, D);
    positions (B, S) or (S,)."""
    B, S, _ = x.shape
    H, kvr = cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_query(p, cfg, x)
    kv = dense(x, p["kv_down"], quant_mode=cfg.quant_mode)
    c_kv, k_rope = kv[..., :kvr], kv[..., kvr:]
    kv_up = dense(rms_norm(c_kv, p["kv_norm"], cfg.rmsnorm_eps),
                  p["kv_up"], quant_mode=cfg.quant_mode)
    kv_up = split_last(kv_up, H)
    k_nope, v = kv_up[..., :dn], kv_up[..., dn:]
    posb = torch.broadcast_to(positions, (B, S))
    q_rope = apply_rope(q_rope, posb, cfg.rope_theta)
    k_rope = apply_rope(k_rope, posb, cfg.rope_theta)       # (B,S,dr) shared
    k_rope = k_rope[:, :, None, :].expand(B, S, H, dr)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    kf = torch.cat([k_nope, k_rope], dim=-1)
    if current_context() is not None and is_sharded(qf):
        out = (_ulysses_sdpa if ulysses_enabled(H) else _gathered_sdpa)(
            qf, kf, v, causal, cfg.attn_chunk)
    else:
        out = sdpa(qf, kf, v, causal=causal, chunk=cfg.attn_chunk)
    return dense(out.reshape(B, S, H * dv), p["wo"],
                 quant_mode=cfg.quant_mode)


def init_mla_cache(cfg: ModelConfig, spec: CacheSpec,
                   device: Union[str, torch.device] = "cuda") -> dict:
    """The latent cache, zeroed: ``c_kv`` (batch, max_len, kv_lora_rank)
    and the roped key ``k_rope`` (batch, max_len, qk_rope_head_dim), in
    bf16 whatever the model's dtype (as the reference; ``spec.dtype`` is
    not read)."""
    shape = (spec.batch, spec.max_len)
    return {"c_kv": torch.zeros(shape + (cfg.kv_lora_rank,),
                                dtype=torch.bfloat16, device=device),
            "k_rope": torch.zeros(shape + (cfg.qk_rope_head_dim,),
                                  dtype=torch.bfloat16, device=device)}


def mla_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict,
               pos, angles: tuple[torch.Tensor, torch.Tensor],
               write_rows: Optional[torch.Tensor] = None
               ) -> tuple[torch.Tensor, dict]:
    """Absorbed-matrix MLA decode: x (B, 1, D) at position ``pos`` (an int
    or a 0-d tensor); ``angles`` the rope (cos, sin) of ``pos`` at the
    rope head dim (``layers.rope_angles``). The normed latent and the
    roped key are written into the bf16 cache at ``pos`` in place, in the
    rows ``write_rows`` (None: every row, as the reference; the other rows
    keep their bits). Attention then runs in the latent space: W_UK
    folded into q, scores = the latent part + the rope part times
    (nope + rope)^-0.5, positions past ``pos`` masked, the probabilities
    cast to x's dtype, W_UV applied after. Reads nothing back to the host
    (capturable in a CUDA graph). Returns (out, cache)."""
    B, S, _ = x.shape
    H, kvr = cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_query(p, cfg, x)
    q_rope = apply_rope(q_rope, None, angles=angles)
    kv = dense(x, p["kv_down"], quant_mode=cfg.quant_mode)
    c_new = rms_norm(kv[..., :kvr], p["kv_norm"], cfg.rmsnorm_eps)
    kr_new = apply_rope(kv[..., kvr:], None, angles=angles)
    idx = pos_index(pos, x.device)
    _write_at(cache, {"c_kv": c_new, "k_rope": kr_new}, idx, write_rows)

    w = p["kv_up"].reshape(kvr, H, dn + dv)
    q_abs = torch.einsum("bshd,khd->bshk", q_nope,
                         w[..., :dn].to(q_nope.dtype))      # (B,S,H,kvr)
    c_all, kr_all = cache["c_kv"], cache["k_rope"]
    scores = (torch.einsum("bshk,blk->bhsl", q_abs, c_all.to(q_abs.dtype))
              + torch.einsum("bshr,blr->bhsl", q_rope,
                             kr_all.to(q_rope.dtype))
              ).to(torch.float32) * (dn + dr) ** -0.5
    kv_len = (idx + 1).expand(B)
    mask = torch.arange(c_all.shape[1], device=x.device)[None, :] \
        < kv_len[:, None]
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    lat = torch.einsum("bhsl,blk->bshk", probs, c_all.to(x.dtype))
    out = torch.einsum("bshk,khv->bshv", lat, w[..., dn:].to(lat.dtype))
    return dense(out.reshape(B, S, H * dv), p["wo"],
                 quant_mode=cfg.quant_mode), cache
