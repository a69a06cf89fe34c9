"""Mixture-of-Experts: top-k routing with sort-based capacity dispatch —
counterpart of ``repro/models/moe.py``, its global path.

Dispatch (GShard-style capacity over the whole token set, as the
reference computes it on one device):

  1. router logits (fp32) → softmax → top-k (weights, expert ids) a token
  2. the (token, k) slots stably sorted by expert id
  3. each slot's position in its expert from the group starts
     (``searchsorted``); a slot past the capacity C is dropped
  4. each expert's first C slots gathered into an (E, C, D) buffer
  5. the experts' SwiGLU as batched products over the expert axis
  6. each token's K slots, weighted by their router weights, summed in a
     fixed order (k ascending) over a (T, K, D) gather

Steps 4 and 6 are gathers where the reference scatters (``.at[].add``):
each buffer row and each token's K slots are read from the slot that
feeds them, so no atomics decide a sum's order and the card gives the
same bits on every run. Shared experts (deepseek) bypass the routing.

The top-k tie rule is the reference's: among equal probabilities the
lower expert id comes first (a stable descending sort, which
``jax.lax.top_k`` also gives). Capacity is shared by every token of the
call, earlier tokens (row-major over (B, S)) first: at decode, T is the
engine's batch of slots, so which other rows are in a decode can change
a row's output (the reference's semantics, kept).

Under a sharding context (``distributed/context.py``) with DTensor
activations:

- ``moe_mode="ep"``, when the experts divide the model axis or the bank
  is at most 2.5e8 bytes (:func:`_ep_eligible`) and the step has enough
  tokens whose block dims divide the mesh (:func:`_ep_divisible`): the
  expert-parallel path (:func:`_moe_ffn_ep`, the reference's
  ``shard_map``), each rank's block under ``local_map``. A rank routes
  and dispatches its own tokens with the capacity C of its own T (the
  same :func:`route` and :func:`dispatch`, so at one rank it is the
  global path bit for bit); in exchange mode (E divides the axis) the
  buffers go to the experts' owners by an all-to-all over the model axis
  and back by another, the banks gathered over ``data`` in their dtype
  inside the block (FSDP; not where ``data`` has one rank, whose banks
  are whole); in replicated mode every rank holds every
  expert and exchanges nothing. The combine stays a gather in k order.
  Functional collectives carry the gradients. Without sequence
  parallelism the ranks of the model axis route the same tokens: as
  the reference's ``shard_map`` does for an axis its specs leave out,
  the output's cotangent is divided by the axis size and the inputs'
  gradients summed over it, so the banks' and the router's gradients
  count each token once.
- Otherwise (``moe_mode="global"``, a decode step, a step too small for
  EP): the global path on whole tensors gathered to every rank first
  (``context.replicated``): its sort, ``searchsorted`` and gathers have
  no DTensor sharding rule. That keeps the values; it costs the gathers.

Without a context the global path runs as it always has.
"""
from __future__ import annotations

import math
from typing import Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.context import (all_gather, collectives,
                                             current_context, is_sharded,
                                             partial, replicated, run_local)
from repro_torch.distributed.sharding import P, mesh_shape, to_placements
from repro_torch.models.layers import dense
from repro_torch.utils import (Seed, ceil_div, flatten_dict, split_seed,
                               unflatten_dict,
                               truncated_normal_init as tn)


def init_moe_params(key: Seed, cfg: ModelConfig,
                    device: Union[str, torch.device] = "cuda") -> dict:
    D, Fd, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    ks = split_seed(key, 5)
    p = {"router": tn(ks[0], (D, E), D ** -0.5, torch.float32, device),
         "w_gate": tn(ks[1], (E, D, Fd), D ** -0.5, cfg.dtype, device),
         "w_up": tn(ks[2], (E, D, Fd), D ** -0.5, cfg.dtype, device),
         "w_down": tn(ks[3], (E, Fd, D), Fd ** -0.5, cfg.dtype, device)}
    if cfg.n_shared_experts:
        Fs = cfg.moe_d_ff * cfg.n_shared_experts
        k1, k2, k3 = split_seed(ks[4], 3)
        p["shared"] = {
            "w_gate": tn(k1, (D, Fs), D ** -0.5, cfg.dtype, device),
            "w_up": tn(k2, (D, Fs), D ** -0.5, cfg.dtype, device),
            "w_down": tn(k3, (Fs, D), Fs ** -0.5, cfg.dtype, device)}
    return p


def capacity(cfg: ModelConfig, T: int) -> int:
    """Slots an expert takes from T tokens: the reference's integer
    ``max(1, int(ceil(T·K / E) · capacity_factor))``."""
    return max(1, int(ceil_div(T * cfg.top_k, cfg.n_experts)
                      * cfg.capacity_factor))


def route(router: torch.Tensor, xt: torch.Tensor, k: int
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(probs (T, E), top_w (T, K), top_e (T, K)): the fp32 router's
    softmax, its k largest (ties: lower id first) and their weights
    normalised to sum to one."""
    probs = torch.softmax(dense(xt.to(torch.float32), router), dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :k], top_e[:, :k]
    return probs, top_w / torch.clamp_min(top_w.sum(-1, keepdim=True),
                                          1e-9), top_e


def dispatch(top_e: torch.Tensor, E: int, C: int) -> dict:
    """The capacity dispatch of (T, K) expert ids, as index tensors:

    - ``order``, ``keep``: the reference's stable sort of the T·K flat
      slots by expert, and which sorted slots fit (position < C);
    - ``src`` (E, C): the flat slot feeding each buffer row, ``filled``
      whether one does;
    - ``row`` (T·K,): each flat slot's buffer row (e·C + position),
      ``kept`` whether it fits."""
    n = top_e.numel()
    dev = top_e.device
    flat_e = top_e.reshape(n)
    se, order = torch.sort(flat_e, stable=True)
    start = torch.searchsorted(se, torch.arange(E, device=dev), side="left")
    end = torch.searchsorted(se, torch.arange(E, device=dev), side="right")
    pos_sorted = torch.arange(n, device=dev) - start[se]
    c = torch.arange(C, device=dev)
    sorted_idx = start[:, None] + c[None, :]
    filled = sorted_idx < end[:, None]
    src = order[torch.clamp_max(sorted_idx, n - 1)]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    kept = pos < C
    return {"order": order, "keep": pos_sorted < C, "src": src,
            "filled": filled, "row": flat_e * C + torch.where(kept, pos, 0),
            "kept": kept}


def _slots(xt: torch.Tensor, d: dict, K: int) -> torch.Tensor:
    """The (E, C, D) buffer: each expert's first C slots, zeros past its
    count."""
    return torch.where(d["filled"][..., None], xt[d["src"] // K],
                       torch.zeros((), dtype=xt.dtype, device=xt.device))


def _experts(xb: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU as batched products over the expert axis."""
    h = F.silu(torch.bmm(xb, w_gate.to(xb.dtype))) \
        * torch.bmm(xb, w_up.to(xb.dtype))
    return torch.bmm(h, w_down.to(xb.dtype))


def _combine(yb: torch.Tensor, d: dict, top_w: torch.Tensor, T: int,
             K: int) -> torch.Tensor:
    """Each token's K slots of the (E·C, D) outputs, weighted, k
    ascending."""
    w = top_w.reshape(T * K).to(yb.dtype)
    out = torch.where(d["kept"][:, None], yb[d["row"]] * w[:, None],
                      torch.zeros((), dtype=yb.dtype, device=yb.device))
    return out.reshape(T, K, yb.shape[-1]).sum(dim=1)


def _shared_expert(p: dict, cfg: ModelConfig, xt: torch.Tensor
                   ) -> torch.Tensor:
    sp = p["shared"]
    return (F.silu(dense(xt, sp["w_gate"], quant_mode=cfg.quant_mode))
            * dense(xt, sp["w_up"], quant_mode=cfg.quant_mode)
            ) @ sp["w_down"].to(xt.dtype)


def moe_ffn(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) → (B, S, D): the global sort-based path, or under a
    sharding context the expert-parallel one (module docstring)."""
    ctx = current_context()
    if ctx is None or not is_sharded(x):
        return _moe_ffn_global(p, cfg, x)
    if ctx.moe_mode == "ep" and _ep_eligible(p, cfg, x, ctx) \
            and _ep_divisible(x, ctx):
        y = _moe_ffn_ep(p, cfg, x, ctx)
        if cfg.n_shared_experts:
            y = y + _shared_expert(p, cfg, x.reshape(-1, x.shape[-1])
                                   ).reshape(x.shape).to(y.dtype)
        return y.to(x.dtype)
    flat = flatten_dict(p)
    return replicated(lambda x, *ts: _moe_ffn_global(
        unflatten_dict(dict(zip(flat, ts))), cfg, x), x, *flat.values())


def _moe_ffn_global(p: dict, cfg: ModelConfig, x: torch.Tensor
                    ) -> torch.Tensor:
    """The reference's global sort-based path over the whole token set."""
    B, S, D = x.shape
    T, E, K = B * S, cfg.n_experts, cfg.top_k
    xt = x.reshape(T, D)
    _, top_w, top_e = route(p["router"], xt, K)
    d = dispatch(top_e, E, capacity(cfg, T))
    yb = _experts(_slots(xt, d, K), p["w_gate"], p["w_up"], p["w_down"])
    y = _combine(yb.reshape(-1, D), d, top_w, T, K)
    if cfg.n_shared_experts:
        y = y + _shared_expert(p, cfg, xt).to(y.dtype)
    return y.reshape(B, S, D).to(x.dtype)


# Expert banks at most this many bytes may be replicated on every device
# (granite: 40 experts × 63 MB/bank): dispatch is then fully local, no
# MoE collectives. Larger banks need E % model_axis == 0 for the
# all-to-all exchange.
_REPLICATE_BANK_BYTES = 2.5e8


def _bank_bytes(p: dict) -> int:
    w = p["w_gate"]
    return int(w.numel()) * w.element_size()


def _ep_eligible(p: dict, cfg: ModelConfig, x: torch.Tensor, ctx) -> bool:
    if cfg.n_experts % ctx.size(ctx.model_axis) == 0:
        return True
    return _bank_bytes(p) <= _REPLICATE_BANK_BYTES


def _ep_divisible(x: torch.Tensor, ctx) -> bool:
    """EP needs the token block dims to divide the mesh axes, and enough
    tokens a step to pay for the banks' gathers and the all-to-alls: a
    decode step takes the global path."""
    shape = mesh_shape(ctx.mesh)
    if x.shape[0] * x.shape[1] < 16 * math.prod(shape.values()):
        return False
    if x.shape[0] % math.prod(shape[a] for a in ctx.batch_axes) != 0:
        return False
    if ctx.sequence_parallel and \
            x.shape[1] % shape[ctx.model_axis] != 0:
        return False
    return True


def _local_dispatch(xt: torch.Tensor, router: torch.Tensor, E: int, K: int,
                    C: int) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Route T local tokens into an (E, C, D) buffer. Returns (buffer,
    the (T, K) router weights, the dispatch of :func:`dispatch`)."""
    _, top_w, top_e = route(router, xt, K)
    d = dispatch(top_e, E, C)
    return _slots(xt, d, K), top_w, d


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Row block i of ``t`` to the group's rank i; row block i of the
    result from rank i. Differentiable."""
    import torch.distributed._functional_collectives as funcol

    collectives["all_to_all"] += 1
    return funcol.all_to_all_single_autograd(t.contiguous(), None, None,
                                             group)


def _moe_ffn_ep(p: dict, cfg: ModelConfig, x: torch.Tensor, ctx
                ) -> torch.Tensor:
    """Expert-parallel dispatch under ``local_map`` (module docstring)."""
    mesh, axis = ctx.mesh, ctx.model_axis
    shape = mesh_shape(mesh)
    n_ep = shape[axis]
    E, K = cfg.n_experts, cfg.top_k
    exchange = E % n_ep == 0
    E_loc = E // n_ep if exchange else E
    b = ctx.batch_axes if len(ctx.batch_axes) > 1 else ctx.batch_axes[0]
    x_spec = P(b, axis if ctx.sequence_parallel else None, None)
    # The banks' FSDP gather over ``data``: none where the axis has one
    # rank, whose bank is whole (it would copy every bank on the card).
    fsdp_axis = "data" if exchange and shape.get("data", 1) > 1 and \
        p["w_gate"].shape[1] % shape["data"] == 0 else None

    def block(x_blk, router, w_gate, w_up, w_down):
        if fsdp_axis is not None:
            group = mesh.get_group(fsdp_axis)
            w_gate = all_gather(w_gate, 1, group)
            w_up = all_gather(w_up, 1, group)
            w_down = all_gather(w_down, 2, group)
        Bb, Sb, D = x_blk.shape
        T = Bb * Sb
        xt = x_blk.reshape(T, D)
        C = capacity(cfg, T)
        buf, top_w, d = _local_dispatch(xt, router, E, K, C)
        if exchange:
            # (E, C, D) → (n_ep, E_loc, C, D); dim 0 ↔ rank all-to-all,
            # then expert-major (E_loc, n_ep·C, D).
            recv = _all_to_all(buf.reshape(n_ep, E_loc, C, D),
                               mesh.get_group(axis))
            xb = recv.movedim(0, 1).reshape(E_loc, n_ep * C, D)
        else:
            xb = buf                                   # fully local
        yb = _experts(xb, w_gate, w_up, w_down)
        if exchange:
            back = yb.reshape(E_loc, n_ep, C, D).movedim(1, 0)
            got = _all_to_all(back, mesh.get_group(axis)).reshape(E * C, D)
        else:
            got = yb.reshape(E * C, D)
        y = _combine(got, d, top_w, T, K).reshape(Bb, Sb, D).to(
            x_blk.dtype)
        if n_rep > 1 and y.requires_grad:
            y.register_hook(lambda g: g / n_rep)
        return y

    if exchange:
        wg_spec, wd_spec = P(axis, fsdp_axis, None), P(axis, None, fsdp_axis)
    else:
        wg_spec = wd_spec = P(None, None, None)
    xp, rp, gp, dp = (to_placements(s, mesh) for s in
                      (x_spec, P(None, None), wg_spec, wd_spec))
    # The mesh dims x is whole on (the model axis without sequence
    # parallelism): their ranks route the same tokens, and an expert's
    # owner takes each token once from each of them. As the reference's
    # shard_map does for the axes its specs leave out, the output's
    # cotangent is divided by their size and every input's gradient
    # summed over them.
    n_rep = math.prod(n for n, pl in zip(shape.values(), xp)
                      if pl.is_replicate())
    return run_local(block, (xp,), (xp, rp, gp, gp, dp), x, p["router"],
                     p["w_gate"], p["w_up"], p["w_down"],
                     grad_placements=(partial(xp) if n_rep > 1 else xp,
                                      partial(rp), partial(gp),
                                      partial(gp), partial(dp)))


def moe_load_stats(p: dict, cfg: ModelConfig, x: torch.Tensor) -> dict:
    """Router balance diagnostics: each expert's share of the top-k slots
    and the largest share over the mean."""
    D = x.shape[-1]
    _, _, top_e = route(p["router"], x.reshape(-1, D), cfg.top_k)
    counts = torch.bincount(top_e.reshape(-1), minlength=cfg.n_experts)
    frac = counts / counts.sum()
    return {"frac_per_expert": frac,
            "max_over_mean": float(frac.max() * cfg.n_experts)}
