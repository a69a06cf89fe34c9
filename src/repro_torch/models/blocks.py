"""Layer blocks, stacks and the hybrid superblock — counterpart of
``repro/models/blocks.py``.

Layer = pre-norm mixer (GQA attention, MLA or the mamba2 SSD mixer) +
pre-norm FFN (SwiGLU, or the MoE of ``models/moe.py``). The layers'
tensors are stacked along a leading L axis, so the parameter tree is the
reference's;
where the reference scans over that axis, the port loops over it in
Python (eager PyTorch has no scan to compile). With ``cfg.remat`` (the
default) a layer run under autograd saves only its input and recomputes
its forward in the backward (``torch.utils.checkpoint``, the counterpart
of the reference's ``jax.checkpoint`` around the scan body).

Hybrid (jamba): superblocks of ``attn_every`` layers whose slot structure
is static (SSD mixers, one attention slot mid-period, MoE on the slots
``cfg.is_moe_layer`` names), stacked along a leading axis; under remat a
whole superblock is recomputed in the backward, as the reference's
checkpoint around the superblock body.

Encoder-decoder (seamless): a decoder layer (``cross_attn=True``) adds
``norm_x`` and a GQA ``cross`` block; its forward runs cross-attention
over the encoder's memory (no rope, no causal mask: past ``attn_chunk``
keys the flash kernels, with Sq != Sk) after the self mixer and before
the FFN. Its decode reads the cross K/V cached once per request (bf16,
(L, B, enc, Kh·hd)) through full attention masked by each row's
``enc_len``, with ``wq`` and ``wo`` as plain products (no quant_mode, no
bias), as the reference's decode does; nothing is written there.

Under a sharding context (``distributed/context.py``) the residual
stream is laid out ``btd`` after every layer (every superblock), as the
reference's scan body constrains it; without one that is the identity.

Decode writes the caches in place, the KV caches, MLA's latent caches
and the SSM states alike, in the rows ``write_rows`` (None: every row,
the reference's behaviour).

The ``miru`` mixer (``cfg.mixer == "miru"``, the paper's cell as a
sequence mixer) runs in the forward only, as in the reference, whose
decode has no miru branch. With ``cfg.quant_mode != "none"`` every
projection runs on that device substrate (``layers.dense``) and the
miru mixer's recurrence through the substrate's ``device_recurrence``;
each layer meters on the shared instance's telemetry as it runs, which
is what the reference's scanned stack reaches by scaling one traced
layer's counts by the layer count.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import prng
from repro_torch.backends.registry import inference_backend
from repro_torch.configs.base import ModelConfig
from repro_torch.core.miru import MiRUConfig
from repro_torch.distributed.context import (act_constraint, is_sharded,
                                             replicated)
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (dense, pos_index, rms_norm,
                                      rope_angles, swiglu)
from repro_torch.utils import (Seed, split_seed, tree_leaves,
                               truncated_normal_init as tn)

PyTree = Any


def require_decodable(cfg: ModelConfig) -> None:
    """Raise for a model with the miru mixer, which the reference does not
    decode either (its ``stack_decode`` has no miru branch and would run
    ``gqa_decode`` on the mixer's parameters)."""
    if cfg.mixer == "miru":
        raise NotImplementedError(
            f"{cfg.name}: the miru mixer has no decode; the reference has "
            "none either (its stack_decode has no miru branch), so the "
            "port runs mixer='miru' in the forward and prefill only")


# ---------------------------------------------------------------------------
# MiRU mixer
# ---------------------------------------------------------------------------

def init_miru_mixer(key: Seed, cfg: ModelConfig,
                    device: Union[str, torch.device] = "cuda") -> dict:
    D = cfg.d_model
    k1, k2, k3 = split_seed(key, 3)
    return {"w_h": tn(k1, (D, D), D ** -0.5, cfg.dtype, device),
            "u_h": tn(k2, (D, D), D ** -0.5, cfg.dtype, device),
            "b_h": torch.zeros((D,), dtype=cfg.dtype, device=device),
            "w_out": tn(k3, (D, D), D ** -0.5, cfg.dtype, device)}


def miru_mixer(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The MiRU recurrence (β 0.8, λ 0.5, h0 = 0) over the sequence of x
    (B, S, D), then the ``w_out`` projection.

    Float (``quant_mode == "none"``): the hoisted x @ w_h + b_h, then the
    ideal fused scan (``kops.miru_scan``: the CUDA kernel on the card, at
    H = D) in fp32; forward values only, as the reference's Pallas scan.
    Quantized: the whole recurrence through the shared inference
    backend's ``device_recurrence`` (on ``wbs`` without an ADC, the
    per-step path: two crossbar products a step), on x / s with ``w_h``
    pre-scaled by the absmax s, so that the drive stays in the crossbar's
    [-1, 1] range (β·h is tanh-bounded and needs no rescale); the key is
    pinned to ``PRNGKey(0)``, so a stochastic spec draws the reference's
    fixed realisation. Under a sharding context it runs on whole tensors
    gathered to every rank (its scan kernels take no DTensor)."""
    if is_sharded(x):
        return replicated(lambda x, *ps: miru_mixer(dict(zip(p, ps)), cfg, x),
                          x, *p.values())
    B, S, D = x.shape
    if cfg.quant_mode != "none":
        backend = inference_backend(cfg.quant_mode)
        mcfg = MiRUConfig(n_x=D, n_h=D, n_y=2, beta=0.8, lam=0.5)
        s = torch.clamp_min(torch.max(torch.abs(x)), 1e-6).to(torch.float32)
        mp = {"w_h": p["w_h"].to(torch.float32) * s,
              "u_h": p["u_h"].to(torch.float32),
              "b_h": p["b_h"].to(torch.float32)}
        h_all, _, _ = backend.device_recurrence(
            mp, mcfg, x.to(torch.float32) / s, prng.PRNGKey(0))
    else:
        xw = (x.reshape(-1, D) @ p["w_h"].to(x.dtype)).reshape(B, S, D) \
            + p["b_h"].to(x.dtype)
        h0 = torch.zeros((B, D), dtype=torch.float32, device=x.device)
        h_all, _ = kops.miru_scan(xw.to(torch.float32),
                                  p["u_h"].to(torch.float32), h0,
                                  beta=0.8, lam=0.5)
    return dense(h_all.to(x.dtype), p["w_out"], quant_mode=cfg.quant_mode)


# ---------------------------------------------------------------------------
# Single layer
# ---------------------------------------------------------------------------

def init_ffn_params(key: Seed, cfg: ModelConfig, is_moe: bool = False,
                    device: Union[str, torch.device] = "cuda") -> dict:
    if is_moe:
        return init_moe(key, cfg, device)
    D, Fd = cfg.d_model, cfg.d_ff
    k1, k2, k3 = split_seed(key, 3)
    return {"w_gate": tn(k1, (D, Fd), D ** -0.5, cfg.dtype, device),
            "w_up": tn(k2, (D, Fd), D ** -0.5, cfg.dtype, device),
            "w_down": tn(k3, (Fd, D), Fd ** -0.5, cfg.dtype, device)}


def init_moe(key: Seed, cfg: ModelConfig,
             device: Union[str, torch.device] = "cuda") -> dict:
    return moe_mod.init_moe_params(key, cfg, device)


def init_layer_params(key: Seed, cfg: ModelConfig, is_ssm: bool = False,
                      is_moe: bool = False, cross_attn: bool = False,
                      device: Union[str, torch.device] = "cuda") -> dict:
    ks = split_seed(key, 4)
    D = cfg.d_model
    if is_ssm:
        mixer = ssm_mod.init_ssm_params(ks[0], cfg, device)
    elif cfg.mixer == "miru":
        mixer = init_miru_mixer(ks[0], cfg, device)
    elif cfg.use_mla:
        mixer = attn.init_mla_params(ks[0], cfg, device)
    else:
        mixer = attn.init_gqa_params(ks[0], cfg, device)
    p: dict = {"norm1": torch.ones((D,), dtype=cfg.dtype, device=device),
               "mixer": mixer}
    if cross_attn:
        p["norm_x"] = torch.ones((D,), dtype=cfg.dtype, device=device)
        p["cross"] = attn.init_gqa_params(ks[1], cfg, device)
    if cfg.d_ff > 0 or is_moe:
        p["norm2"] = torch.ones((D,), dtype=cfg.dtype, device=device)
        p["ffn"] = init_ffn_params(ks[2], cfg, is_moe, device)
    return p


def _ffn(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The residual FFN: MoE where the layer has a router, else SwiGLU."""
    if "ffn" not in p:
        return x
    h = rms_norm(x, p["norm2"], cfg.rmsnorm_eps)
    f = p["ffn"]
    if "router" in f:
        return x + moe_mod.moe_ffn(f, cfg, h).to(x.dtype)
    return x + swiglu(h, f["w_gate"], f["w_up"], f["w_down"],
                      cfg.quant_mode).to(x.dtype)


def layer_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, is_ssm: bool = False,
                  is_moe: bool = False, causal: bool = True,
                  memory: Optional[torch.Tensor] = None,
                  memory_positions: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """One layer; with ``memory`` (B, T_enc, D) a decoder layer, whose
    cross-attention over it follows the self mixer."""
    h = rms_norm(x, p["norm1"], cfg.rmsnorm_eps)
    if is_ssm:
        mixed = ssm_mod.mamba2_forward(p["mixer"], cfg, h)
    elif cfg.mixer == "miru":
        mixed = miru_mixer(p["mixer"], cfg, h)
    elif cfg.use_mla:
        mixed = attn.mla_attention(p["mixer"], cfg, h, positions, causal)
    else:
        mixed = attn.gqa_attention(p["mixer"], cfg, h, positions, causal)
    x = x + mixed.to(x.dtype)
    if memory is not None:
        h = rms_norm(x, p["norm_x"], cfg.rmsnorm_eps)
        x = x + attn.gqa_attention(p["cross"], cfg, h, positions,
                                   causal=False, kv=(memory,),
                                   kv_positions=memory_positions
                                   ).to(x.dtype)
    return _ffn(p, cfg, x)


def _cross_decode(lp: dict, cfg: ModelConfig, x: torch.Tensor,
                  k_m: torch.Tensor, v_m: torch.Tensor,
                  enc_len: torch.Tensor) -> torch.Tensor:
    """The decoder's cross-attention step over the cached memory K/V
    (B, enc, Kh·hd), each row masked past its ``enc_len``: ``wq`` and
    ``wo`` as plain products (no quant_mode, no bias), as the
    reference's ``stack_decode``. Returns the residual stream."""
    B, hd = x.shape[0], cfg.hd()
    h = rms_norm(x, lp["norm_x"], cfg.rmsnorm_eps)
    q = dense(h, lp["cross"]["wq"]).reshape(B, 1, cfg.n_heads, hd)
    o = attn.full_attention(q, k_m.reshape(B, -1, cfg.n_kv_heads, hd),
                            v_m.reshape(B, -1, cfg.n_kv_heads, hd),
                            causal=False, kv_len=enc_len)
    return x + dense(o.reshape(B, 1, -1), lp["cross"]["wo"]).to(x.dtype)


def _decode_mixer(lp: dict, cfg: ModelConfig, h: torch.Tensor, cache: dict,
                  pos, angles, is_ssm: bool,
                  write_rows: Optional[torch.Tensor]) -> torch.Tensor:
    if is_ssm:
        return ssm_mod.mamba2_decode(lp["mixer"], cfg, h, cache,
                                     write_rows)[0]
    if cfg.use_mla:
        return attn.mla_decode(lp["mixer"], cfg, h, cache, pos, angles,
                               write_rows)[0]
    return attn.gqa_decode(lp["mixer"], cfg, h, cache, pos, angles,
                           write_rows)[0]


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


def _recompute(cfg: ModelConfig, x: torch.Tensor, p: PyTree) -> bool:
    """Whether a layer (or superblock) runs under checkpoint: remat on and
    autograd recording through it."""
    return cfg.remat and torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in tree_leaves(p)))


def stack_forward(stacked: PyTree, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, is_ssm: bool = False,
                  is_moe: bool = False, causal: bool = True, memory=None,
                  memory_positions=None) -> torch.Tensor:
    for i in range(n_stacked(stacked)):
        lp = layer_slice(stacked, i)
        args = (lp, cfg, x, positions, is_ssm, is_moe, causal, memory,
                memory_positions)
        if _recompute(cfg, x, lp):
            x = checkpoint(layer_forward, *args, use_reentrant=False)
        else:
            x = layer_forward(*args)
        x = act_constraint(x, "btd")
    return x


def _angles(cfg: ModelConfig, x: torch.Tensor, pos):
    """The rope (cos, sin) of ``pos`` (an int or a 0-d tensor): every
    attention layer of a decode rotates by the same position, so once a
    step; at the rope head dim (MLA's ``qk_rope_head_dim``, else the
    head dim)."""
    dim = cfg.qk_rope_head_dim if cfg.use_mla else cfg.hd()
    return rope_angles(pos_index(pos, x.device).expand(x.shape[0], 1),
                       dim, cfg.rope_theta)


def stack_decode(stacked: PyTree, caches: PyTree, cfg: ModelConfig,
                 x: torch.Tensor, pos, is_ssm: bool = False,
                 write_rows: Optional[torch.Tensor] = None,
                 cross_kv: Optional[tuple] = None,
                 enc_len: Optional[torch.Tensor] = None
                 ) -> tuple[torch.Tensor, PyTree]:
    """One-token decode through the stack; caches are stacked (L, …) and
    written in place (``write_rows`` as in ``attention.cache_insert`` and
    ``ssm.mamba2_decode``). A decoder stack takes ``cross_kv`` (K and V,
    each (L, B, enc, Kh·hd)) and ``enc_len`` (B,): each layer's
    cross-attention reads them and writes nothing."""
    require_decodable(cfg)
    angles = None if is_ssm else _angles(cfg, x, pos)
    for i in range(n_stacked(stacked)):
        lp = layer_slice(stacked, i)
        h = rms_norm(x, lp["norm1"], cfg.rmsnorm_eps)
        mixed = _decode_mixer(lp, cfg, h, layer_slice(caches, i), pos,
                              angles, is_ssm, write_rows)
        x = x + mixed.to(x.dtype)
        if cross_kv is not None:
            x = _cross_decode(lp, cfg, x, cross_kv[0][i], cross_kv[1][i],
                              enc_len)
        x = _ffn(lp, cfg, x)
    return x, caches


# ---------------------------------------------------------------------------
# Hybrid (jamba) superblock
# ---------------------------------------------------------------------------

def init_superblock(key: Seed, cfg: ModelConfig,
                    device: Union[str, torch.device] = "cuda") -> dict:
    """One period of ``attn_every`` layers with a static slot structure."""
    ks = split_seed(key, cfg.attn_every)
    return {f"slot{j}": init_layer_params(
        ks[j], cfg, is_ssm=cfg.is_ssm_layer(j), is_moe=cfg.is_moe_layer(j),
        device=device) for j in range(cfg.attn_every)}


def init_hybrid_stack(key: Seed, cfg: ModelConfig,
                      device: Union[str, torch.device] = "cuda") -> PyTree:
    if cfg.n_layers % cfg.attn_every:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                         f"multiple of attn_every {cfg.attn_every}")
    keys = split_seed(key, cfg.n_layers // cfg.attn_every)
    return _stack([init_superblock(k, cfg, device) for k in keys])


def _superblock_forward(sb: dict, cfg: ModelConfig, x: torch.Tensor,
                        positions: torch.Tensor) -> torch.Tensor:
    for j in range(cfg.attn_every):
        x = layer_forward(sb[f"slot{j}"], cfg, x, positions,
                          is_ssm=cfg.is_ssm_layer(j),
                          is_moe=cfg.is_moe_layer(j))
    return x


def hybrid_forward(stacked: PyTree, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    for i in range(n_stacked(stacked)):
        sb = layer_slice(stacked, i)
        if _recompute(cfg, x, sb):
            x = checkpoint(_superblock_forward, sb, cfg, x, positions,
                           use_reentrant=False)
        else:
            x = _superblock_forward(sb, cfg, x, positions)
        x = act_constraint(x, "btd")
    return x


def init_hybrid_caches(cfg: ModelConfig, batch: int, max_len: int,
                       device: Union[str, torch.device] = "cuda") -> dict:
    """Each slot's cache (the SSM state, or the KV cache in
    ``cfg.kv_cache_dtype``), stacked over the superblocks, zeroed."""
    n_super = cfg.n_layers // cfg.attn_every
    spec = attn.CacheSpec(batch, max_len, cfg.kv_cache_dtype)
    caches = {}
    for j in range(cfg.attn_every):
        one = ssm_mod.init_ssm_cache(cfg, batch, device) \
            if cfg.is_ssm_layer(j) else attn.init_kv_cache(cfg, spec, device)
        caches[f"slot{j}"] = {k: torch.zeros((n_super,) + v.shape,
                                             dtype=v.dtype, device=device)
                              for k, v in one.items()}
    return caches


def hybrid_decode(stacked: PyTree, caches: dict, cfg: ModelConfig,
                  x: torch.Tensor, pos,
                  write_rows: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, dict]:
    """One-token decode through the superblocks, the caches written in
    place in the rows ``write_rows``."""
    require_decodable(cfg)
    angles = _angles(cfg, x, pos)
    for i in range(n_stacked(stacked)):
        sb = layer_slice(stacked, i)
        for j in range(cfg.attn_every):
            lp = sb[f"slot{j}"]
            h = rms_norm(x, lp["norm1"], cfg.rmsnorm_eps)
            mixed = _decode_mixer(lp, cfg, h,
                                  layer_slice(caches[f"slot{j}"], i), pos,
                                  angles, cfg.is_ssm_layer(j), write_rows)
            x = _ffn(lp, cfg, x + mixed.to(x.dtype))
    return x, caches
