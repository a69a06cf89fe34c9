"""Minion Recurrent Unit (MiRU) — the paper's cell, eqs. (1)-(3).

Counterpart of ``repro/core/miru.py``:

    h̃ᵗ = tanh(xᵗ W_h + (β ⊙ hᵗ⁻¹) U_h + b_h)          (1)
    hᵗ  = λ ⊙ hᵗ⁻¹ + (1 − λ) ⊗ h̃ᵗ                     (2)
    ŷᵗ  = softmax(hᵗ W_o + b_o)                         (3)

Parameters are a ``dict[str, Tensor]`` keyed like the JAX pytree
(``w_h``, ``u_h``, ``b_h``, ``w_o``, ``b_o``): the device backends address
crossbar tiles by those names.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch import prng
from repro_torch.kernels import ops as kops
from repro_torch.utils import Seed, glorot_uniform, normal_init, resolve_device


@dataclasses.dataclass(frozen=True)
class MiRUConfig:
    """Configuration of a (input → MiRU hidden → readout) network."""
    n_x: int                  # input features per time step
    n_h: int                  # hidden MiRU units
    n_y: int                  # readout classes
    beta: float = 0.8         # reset coefficient β ∈ (0, 1]
    lam: float = 0.5          # update coefficient λ ∈ [0, 1)
    dtype: torch.dtype = torch.float32
    # K-WTA readout (the voltage-mode circuit approximating softmax).
    readout_k: Optional[int] = None

    def __post_init__(self):
        if not (0.0 < self.beta <= 1.0):
            raise ValueError(f"beta must be in (0,1], got {self.beta}")
        if not (0.0 <= self.lam < 1.0):
            raise ValueError(f"lam must be in [0,1), got {self.lam}")


def init_miru_params(generator: Seed, cfg: MiRUConfig,
                     device: Union[str, torch.device] = "cuda"
                     ) -> dict[str, torch.Tensor]:
    """Glorot matrices and zero biases, placed on ``device``. From a CPU
    ``torch.Generator`` the draws depend only on the generator, so one
    seed gives the same weights on every device; from a
    :mod:`repro_torch.prng` key they are the reference's
    ``init_miru_params(key, cfg)`` bit for bit (the key split three ways,
    one per matrix)."""
    dev = resolve_device(device)
    if isinstance(generator, torch.Generator):
        seeds = (generator,) * 3
    else:
        seeds = tuple(prng.split(generator, 3))
    return {
        "w_h": glorot_uniform(seeds[0], (cfg.n_x, cfg.n_h), cfg.dtype).to(dev),
        "u_h": glorot_uniform(seeds[1], (cfg.n_h, cfg.n_h), cfg.dtype).to(dev),
        "b_h": torch.zeros((cfg.n_h,), dtype=cfg.dtype, device=dev),
        "w_o": glorot_uniform(seeds[2], (cfg.n_h, cfg.n_y), cfg.dtype).to(dev),
        "b_o": torch.zeros((cfg.n_y,), dtype=cfg.dtype, device=dev),
    }


def init_dfa_feedback(key: np.ndarray, cfg: MiRUConfig,
                      scale: Optional[float] = None,
                      device: Union[str, torch.device] = "cuda"
                      ) -> torch.Tensor:
    """The fixed random feedback matrix Ψ (n_y, n_h) of Algorithm 1, line
    13, from a :mod:`repro_torch.prng` key: N(0, scale²) with scale =
    1/√n_y by default, as the reference draws it (to within 3 ulp of its
    normal draw). Ψ is not trained."""
    dev = resolve_device(device)
    if scale is None:
        scale = float(np.float32(1.0) / np.sqrt(np.float32(cfg.n_y)))
    return normal_init(key, (cfg.n_y, cfg.n_h), float(scale),
                       cfg.dtype).to(dev)


def miru_cell(params: dict[str, torch.Tensor], cfg: MiRUConfig,
              h_prev: torch.Tensor, x_t: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One MiRU step. Returns (h_t, preact_t)."""
    pre = x_t @ params["w_h"] + (cfg.beta * h_prev) @ params["u_h"] \
        + params["b_h"]
    h_t = cfg.lam * h_prev + (1.0 - cfg.lam) * torch.tanh(pre)
    return h_t, pre


def miru_forward(params: dict[str, torch.Tensor], cfg: MiRUConfig,
                 x_seq: torch.Tensor, h0: Optional[torch.Tensor] = None,
                 use_fused: bool = False,
                 ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The full recurrence over x_seq (B, T, n_x). Returns the logits of
    the final hidden state and {h_all, h_prev, pre}, each (B, T, n_h).

    ``use_fused`` runs the recurrence as one ``miru_scan`` kernel (its
    plain version on the CPU) after the input projection, computed as one
    (B·T, n_x) product outside it, as the reference does: xw = x@W_h,
    then + b_h, then pre_t = xw_t + (β·h)@U inside the scan."""
    B, T, _ = x_seq.shape
    h = h0 if h0 is not None else torch.zeros(
        (B, cfg.n_h), dtype=cfg.dtype, device=x_seq.device)
    if use_fused:
        xw = x_seq.reshape(B * T, cfg.n_x) @ params["w_h"]
        xw = xw.reshape(B, T, cfg.n_h) + params["b_h"]
        h_all, pre = kops.miru_scan(xw, params["u_h"], h, beta=cfg.beta,
                                    lam=cfg.lam)
        h_prev = torch.cat([h[:, None, :], h_all[:, :-1, :]], dim=1)
        inter = {"h_all": h_all, "h_prev": h_prev, "pre": pre}
        return miru_apply_readout(params, cfg, h_all[:, -1, :]), inter
    h_all, h_prev, pre = [], [], []
    for t in range(T):
        h_new, p = miru_cell(params, cfg, h, x_seq[:, t])
        h_all.append(h_new)
        h_prev.append(h)
        pre.append(p)
        h = h_new
    inter = {"h_all": torch.stack(h_all, 1), "h_prev": torch.stack(h_prev, 1),
             "pre": torch.stack(pre, 1)}
    return miru_apply_readout(params, cfg, h), inter


def miru_apply_readout(params: dict[str, torch.Tensor], cfg: MiRUConfig,
                       h: torch.Tensor) -> torch.Tensor:
    """Readout logits, (h @ w_o) + b_o through the row-exact readout
    (``kernels/ops.miru_readout``: the kernel on the card, its plain
    version on the CPU), so a row's logits do not depend on how many rows
    share the call. With ``readout_k`` set, only the k largest logits
    survive; the others are pinned to -30 (the k-WTA softmax circuit)."""
    logits = kops.miru_readout(h, params["w_o"], params["b_o"])
    if cfg.readout_k is not None and cfg.readout_k < cfg.n_y:
        from repro_torch.core.kwta import kwta_mask
        mask = kwta_mask(logits, cfg.readout_k, by_magnitude=False)
        logits = torch.where(mask, logits, torch.full_like(logits, -30.0))
    return logits
