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

Not ported: the expert-parallel ``shard_map`` path (the reference's
``_moe_ffn_ep``), which waits for ``distributed/`` (ROADMAP queue A, the
last item). Without a sharding context the reference takes the global
path, as the port always does.
"""
from __future__ import annotations

from typing import Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense
from repro_torch.utils import (Seed, ceil_div, split_seed,
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


def moe_ffn(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) → (B, S, D), the reference's global sort-based path."""
    B, S, D = x.shape
    T, E, K = B * S, cfg.n_experts, cfg.top_k
    C = capacity(cfg, T)
    xt = x.reshape(T, D)
    _, top_w, top_e = route(p["router"], xt, K)
    d = dispatch(top_e, E, C)

    # Each expert's first C slots, zeros past its count.
    xb = torch.where(d["filled"][..., None], xt[d["src"] // K],
                     torch.zeros((), dtype=x.dtype, device=x.device))
    h = F.silu(torch.bmm(xb, p["w_gate"].to(x.dtype))) \
        * torch.bmm(xb, p["w_up"].to(x.dtype))
    yb = torch.bmm(h, p["w_down"].to(x.dtype)).reshape(E * C, D)

    # Each token's K slots, k ascending.
    w = top_w.reshape(T * K).to(yb.dtype)
    out = torch.where(d["kept"][:, None], yb[d["row"]] * w[:, None],
                      torch.zeros((), dtype=yb.dtype, device=yb.device))
    y = out.reshape(T, K, D).sum(dim=1)

    if cfg.n_shared_experts:
        sp = p["shared"]
        y = y + (F.silu(dense(xt, sp["w_gate"], quant_mode=cfg.quant_mode))
                 * dense(xt, sp["w_up"], quant_mode=cfg.quant_mode)
                 ) @ sp["w_down"].to(y.dtype)
    return y.reshape(B, S, D).to(x.dtype)


def moe_load_stats(p: dict, cfg: ModelConfig, x: torch.Tensor) -> dict:
    """Router balance diagnostics: each expert's share of the top-k slots
    and the largest share over the mean."""
    D = x.shape[-1]
    _, _, top_e = route(p["router"], x.reshape(-1, D), cfg.top_k)
    counts = torch.bincount(top_e.reshape(-1), minlength=cfg.n_experts)
    frac = counts / counts.sum()
    return {"frac_per_expert": frac,
            "max_over_mean": float(frac.max() * cfg.n_experts)}
