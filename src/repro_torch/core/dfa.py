"""Direct Feedback Alignment through time — Algorithm 1.

Counterpart of ``repro/core/dfa.py``. The output error is computed once
per sequence (at t = n_T), projected to the hidden layer through the
fixed random matrix Ψ, and re-used at every time step:

    δ_o   = ∂ℓ/∂(h^{n_T} W_o + b_o)                (softmax CE ⇒ p − y)
    ∇W_o  = (h^{n_T})ᵀ δ_o
    e     = δ_o Ψ                                   (line 13)
    δ_hᵗ  = λ · e ⊙ tanh′(preactᵗ)                  (line 14)
    ∇W_h += (xᵗ)ᵀ δ_hᵗ                              (line 15)
    ∇U_h += (β hᵗ⁻¹)ᵀ δ_hᵗ                          (line 16)

Because e is time-invariant, the accumulation is a pair of contractions
over time (``torch.einsum``, as the reference leaves them to XLA) — no
backward scan and no backward kernel. ``bptt_grads`` (true gradients by
autograd through the per-step forward) is the software baseline.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.kwta import kwta_global
from repro_torch.core.miru import MiRUConfig, miru_forward
from repro_torch.utils import softmax_cross_entropy

Params = dict[str, torch.Tensor]
HIDDEN = ("w_h", "u_h", "b_h")


def miru_loss(params: Params, cfg: MiRUConfig, x_seq: torch.Tensor,
              labels: torch.Tensor, use_fused: bool = False) -> torch.Tensor:
    logits, _ = miru_forward(params, cfg, x_seq, use_fused=use_fused)
    return softmax_cross_entropy(logits, labels)


def dfa_grads(params: Params, psi: torch.Tensor, cfg: MiRUConfig,
              x_seq: torch.Tensor, labels: torch.Tensor,
              use_fused: bool = False, forward_fn=None,
              time_norm: bool = True,
              row_valid: Optional[torch.Tensor] = None,
              lengths: Optional[torch.Tensor] = None,
              ) -> tuple[torch.Tensor, Params]:
    """DFA-through-time gradients (Algorithm 1).

    psi (n_y, n_h) is the fixed feedback matrix; x_seq (B, T, n_x),
    labels (B,) int. ``forward_fn(params, cfg, x_seq)`` replaces the
    software forward (the device backends' forward goes here).
    ``time_norm`` scales the projected error by 1/n_T (the reference's
    calibration of Ψ). ``row_valid`` (B,) bool drops padded rows from the
    loss and the error, dividing by Σvalid; ``lengths`` (B,) int reads
    the error at each row's own last step, masks the accumulation past
    it and normalizes by 1/length per row.

    Returns (loss, grads) with grads keyed like params.
    """
    B, T = x_seq.shape[0], x_seq.shape[1]
    fwd = forward_fn if forward_fn is not None else (
        lambda p, c, x: miru_forward(p, c, x, use_fused=use_fused))
    logits, aux = fwd(params, cfg, x_seq)

    # Output layer (lines 9-10), mean-reduced over the (valid) batch.
    y = torch.nn.functional.one_hot(labels.long(), cfg.n_y).to(logits.dtype)
    probs = torch.softmax(logits, dim=-1)
    if row_valid is None:
        loss = softmax_cross_entropy(logits, labels)
        delta_o = (probs - y) / B
    else:
        m = row_valid.to(logits.dtype)
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[:, None].long())[:, 0]
        denom = torch.clamp(torch.sum(m), min=1.0)
        loss = torch.sum((logz - ll) * m) / denom
        delta_o = (probs - y) * m[:, None] / denom
    h_all = aux["h_all"]
    if lengths is None:
        h_T = h_all[:, -1, :]
    else:
        idx = (lengths.long() - 1)[:, None, None].expand(B, 1,
                                                         h_all.shape[-1])
        h_T = torch.gather(h_all, 1, idx)[:, 0, :]
    g_wo = h_T.T @ delta_o
    g_bo = torch.sum(delta_o, dim=0)

    # Hidden layer (lines 12-17); e is shared across time.
    e = delta_o @ psi
    if time_norm:
        e = e / (T if lengths is None
                 else lengths.to(e.dtype)[:, None])
    dtanh = 1.0 - torch.tanh(aux["pre"]) ** 2
    delta_h = cfg.lam * e[:, None, :] * dtanh
    if lengths is not None:
        tmask = (torch.arange(T, device=x_seq.device)[None, :]
                 < lengths[:, None]).to(delta_h.dtype)
        delta_h = delta_h * tmask[:, :, None]
    g_wh = torch.einsum("btx,bth->xh", x_seq, delta_h)
    g_uh = torch.einsum("bth,btk->hk", cfg.beta * aux["h_prev"], delta_h)
    g_bh = torch.sum(delta_h, dim=(0, 1))
    return loss, {"w_h": g_wh, "u_h": g_uh, "b_h": g_bh,
                  "w_o": g_wo, "b_o": g_bo}


def bptt_grads(params: Params, cfg: MiRUConfig, x_seq: torch.Tensor,
               labels: torch.Tensor, use_fused: bool = False
               ) -> tuple[torch.Tensor, Params]:
    """True gradients (BPTT) by autograd through the per-step forward —
    the paper's software baseline. The fused scan has no backward: the
    reference cannot differentiate its own fused float scan either, so
    ``use_fused=True`` raises."""
    if use_fused:
        raise NotImplementedError(
            "bptt_grads(use_fused=True): the miru_scan kernel has no "
            "backward (the reference's fused scan is not differentiable "
            "either); use the per-step forward")
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss = miru_loss(leaves, cfg, x_seq, labels)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def grad_alignment(g_dfa: Params, g_bp: Params,
                   key: str = "w_h") -> torch.Tensor:
    """Cosine similarity between the DFA and the true gradient."""
    a, b = g_dfa[key].reshape(-1), g_bp[key].reshape(-1)
    return torch.dot(a, b) / (torch.linalg.norm(a) * torch.linalg.norm(b)
                              + 1e-12)


def scaled_sparse_updates(grads: Params, lr: float,
                          keep_frac: Optional[float] = None,
                          hidden_lr_scale: float = 1.0) -> Params:
    """Lines 19-21: dW = −lr·s·ζ(∇W), with ζ on every matrix and s =
    ``hidden_lr_scale`` on the DFA-driven hidden weights (a per-layer
    shift in hardware), 1 on the readout."""
    updates = {}
    for name, g in grads.items():
        if keep_frac is not None and g.ndim >= 2:
            g = kwta_global(g, keep_frac)
        s = hidden_lr_scale if name in HIDDEN else 1.0
        updates[name] = (-lr * s) * g
    return updates


def sgd_kwta_update(params: Params, grads: Params, lr: float,
                    keep_frac: Optional[float] = None,
                    hidden_lr_scale: float = 1.0
                    ) -> tuple[Params, dict[str, torch.Tensor]]:
    """W ← W + dW for the ζ-sparsified DFA step. Returns (new_params,
    write_masks): which synapses were written, for endurance counting."""
    updates = scaled_sparse_updates(grads, lr, keep_frac, hidden_lr_scale)
    new_params = {name: p + updates[name] for name, p in params.items()}
    return new_params, {name: u != 0 for name, u in updates.items()}
