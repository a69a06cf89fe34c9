"""Mamba-2 (SSD, state-space duality) sequence mixer — counterpart of
``repro/models/ssm.py``.

Training and prefill: the chunked SSD algorithm (Dao & Gu 2024, §6), an
intra-chunk quadratic, attention-like term plus a recurrence over the
chunk states, which the port runs as a Python loop over the chunks (the
reference's ``lax.scan``) in fp32. Decode: the linear recurrence
h ← dA·h + dBx, one token a step, its state in fp32.

Layer I/O follows mamba2: in_proj → [z | x | B | C | dt], a depthwise
causal conv over [x|B|C], SSD over heads of ``ssm_head_dim``, a gated
RMSNorm, out_proj. The dtypes follow the reference's: ``dt`` is cast to
the activations' dtype before the scan, the inter-chunk recurrence runs
in fp32 and its states go back to the activations' dtype.

Under a sharding context (``distributed/context.py``) with DTensor
activations: with ``attn_mode="ulysses"`` and the heads dividing the
model axis, x is anchored sequence-sharded (``bshd_seq``) and resharded
to heads (``bshd``, an all-to-all), dt to ``bsh``, B and C gathered
(``bs__``), and each rank runs :func:`ssd_chunked` over the whole
sequence for its heads under ``local_map`` (the reference's Ulysses for
SSM). Otherwise the chunk scan (a Python loop over the chunks, each
reading the state before it, whose indexing DTensor does not shard)
runs on whole tensors gathered to every rank first
(``context.replicated``): that keeps the values and costs the gathers.
The depthwise causal conv (a pad and shifted slices over the sequence,
which DTensor does not shard) runs on each rank's sequence shard under
``local_map``, with the dconv − 1 rows before the shard gathered from the
rank before it (:func:`_sharded_causal_conv`).

:func:`mamba2_decode` takes ``write_rows`` as the KV cache does: the conv
and SSD state of every row outside it stay as they were, bit for bit
(the reference advances every row's state in every decode, so a prompt
prefilled token by token in one slot moves the state of the slots
already decoding). None writes every row, the reference's function.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.context import (act_constraint, all_gather,
                                             current_context, is_sharded,
                                             partial, replicated, run_local,
                                             ulysses_enabled)
from repro_torch.distributed.sharding import P, to_placements
from repro_torch.models.layers import dense, promote, rms_norm, select_rows
from repro_torch.utils import Seed, split_seed, truncated_normal_init as tn


def _dims(cfg: ModelConfig) -> dict:
    d_in = cfg.ssm_expand * cfg.d_model
    return {"d_in": d_in, "nheads": d_in // cfg.ssm_head_dim,
            "ngroups": cfg.ssm_groups, "dstate": cfg.ssm_state,
            "hd": cfg.ssm_head_dim, "dconv": cfg.ssm_conv}


def init_ssm_params(key: Seed, cfg: ModelConfig,
                    device: Union[str, torch.device] = "cuda") -> dict:
    d = _dims(cfg)
    D = cfg.d_model
    conv_dim = d["d_in"] + 2 * d["ngroups"] * d["dstate"]
    proj_out = 2 * d["d_in"] + 2 * d["ngroups"] * d["dstate"] + d["nheads"]
    ks = split_seed(key, 4)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": tn(ks[0], (D, proj_out), D ** -0.5, cfg.dtype, device),
        "conv_w": tn(ks[1], (d["dconv"], conv_dim), 0.1, cfg.dtype, device),
        "conv_b": torch.zeros((conv_dim,), dtype=cfg.dtype, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, d["nheads"],
                                          dtype=torch.float32)).to(device),
        "dt_bias": torch.zeros((d["nheads"],), **f32),
        "d_skip": torch.ones((d["nheads"],), **f32),
        "norm": torch.ones((d["d_in"],), dtype=cfg.dtype, device=device),
        "out_proj": tn(ks[2], (d["d_in"], D), d["d_in"] ** -0.5, cfg.dtype,
                       device),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + eˣ) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


# ---------------------------------------------------------------------------
# Chunked SSD scan
# ---------------------------------------------------------------------------

def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., l) → (..., l, l) with out[..., i, j] = Σ_{j<k<=i} x[k],
    −inf above the diagonal (the lower-triangular decay matrix)."""
    l = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    ii = torch.arange(l, device=x.device)
    return torch.where(ii[:, None] >= ii[None, :], diff,
                       torch.tensor(-torch.inf, dtype=x.dtype,
                                    device=x.device))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int = 128,
                h0: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD over a full sequence.

    x (b, l, h, p); dt (b, l, h) softplus-ed step; a_log (h,) decay;
    B, C (b, l, g, n) with heads grouped g | h. Returns (y (b, l, h, p),
    promoted with fp32 as the reference's, final_state (b, h, p, n) in
    x's dtype)."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    if l % chunk:
        pad = chunk - l % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    lp = x.shape[1]
    c = lp // chunk

    xc = x.reshape(b, c, chunk, h, p)
    dtc = dt.reshape(b, c, chunk, h)
    Br = torch.repeat_interleave(B.reshape(b, c, chunk, g, n), rep, dim=3)
    Cr = torch.repeat_interleave(C.reshape(b, c, chunk, g, n), rep, dim=3)
    dA = -torch.exp(a_log) * dtc                        # (b,c,l,h) ≤ 0
    dA = torch.movedim(dA, -1, 1)                       # (b,h,c,l)
    dA_cs = torch.cumsum(dA, dim=-1)

    # 1. Intra-chunk (quadratic, attention-like) term.
    L = torch.exp(_segsum(dA))                          # (b,h,c,l,l)
    scores = torch.einsum("bclhn,bcshn->bhcls", *promote(Cr, Br))
    M = scores * L
    xdt = xc * dtc[..., None]                           # (b,c,l,h,p)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", *promote(M, xdt))

    # 2. Each chunk's final state: decay-to-end ⊗ B ⊗ x.
    decay_end = torch.exp(dA_cs[..., -1:] - dA_cs)      # (b,h,c,l)
    states = torch.einsum("bhcl,bclhn,bclhp->bchpn",
                          *promote(decay_end, Br, xdt))

    # 3. The recurrence over the chunk states, in fp32; each chunk
    # reads the state before it.
    chunk_decay = torch.exp(dA_cs[..., -1]).to(torch.float32)   # (b,h,c)
    s = (h0 if h0 is not None else torch.zeros(
        (b, h, p, n), dtype=x.dtype, device=x.device)).to(torch.float32)
    states = states.to(torch.float32)
    prev = []
    for j in range(c):
        prev.append(s)
        s = states[:, j] + chunk_decay[:, :, j, None, None] * s
    prev_states = torch.stack(prev, dim=1).to(x.dtype)  # (b,c,h,p,n)

    # 4. State → output within each chunk.
    decay_in = torch.exp(dA_cs)                         # (b,h,c,l)
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp",
                         *promote(Cr, prev_states, decay_in))
    y = (y_diag + y_off).reshape(b, lp, h, p)[:, :l]
    return y, s.to(x.dtype)


def ssd_recurrent_step(state: torch.Tensor, x_t: torch.Tensor,
                       dt_t: torch.Tensor, a_log: torch.Tensor,
                       B_t: torch.Tensor, C_t: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step. state (b,h,p,n); x_t (b,h,p); dt_t (b,h);
    B_t, C_t (b,g,n). Returns (y_t (b,h,p), new_state)."""
    rep = x_t.shape[1] // B_t.shape[1]
    Br = torch.repeat_interleave(B_t, rep, dim=1)       # (b,h,n)
    Cr = torch.repeat_interleave(C_t, rep, dim=1)
    dA = torch.exp(-torch.exp(a_log)[None, :] * dt_t)   # (b,h)
    dBx = torch.einsum("bhn,bhp->bhpn", *promote(Br, x_t * dt_t[..., None]))
    new_state = dA[..., None, None] * state + dBx
    y = torch.einsum("bhpn,bhn->bhp", *promote(new_state, Cr))
    return y, new_state


# ---------------------------------------------------------------------------
# Full mamba2 layer
# ---------------------------------------------------------------------------

def _split_proj(zxbcdt: torch.Tensor, d: dict):
    d_in, g, n, nh = d["d_in"], d["ngroups"], d["dstate"], d["nheads"]
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in:2 * d_in + 2 * g * n],
            zxbcdt[..., -nh:])


def _split_xbc(xBC: torch.Tensor, d: dict):
    """[x | B | C] → x (…, nheads, hd), B and C (…, ngroups, dstate)."""
    d_in, gn = d["d_in"], d["ngroups"] * d["dstate"]
    lead = xBC.shape[:-1]
    return (xBC[..., :d_in].reshape(*lead, d["nheads"], d["hd"]),
            xBC[..., d_in:d_in + gn].reshape(*lead, d["ngroups"],
                                             d["dstate"]),
            xBC[..., d_in + gn:].reshape(*lead, d["ngroups"], d["dstate"]))


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 halo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The depthwise causal conv over [x|B|C] (B, S, conv_dim), its
    (dconv, conv_dim) taps summed in order, then the bias and SiLU.
    ``halo`` is the dconv − 1 rows before ``xBC`` (zeros when None)."""
    s = xBC.shape[1]
    pad = F.pad(xBC, (0, 0, w.shape[0] - 1, 0)) if halo is None \
        else torch.cat([halo, xBC], dim=1)
    conv = pad[:, 0:s, :] * w[0]
    for i in range(1, w.shape[0]):
        conv = conv + pad[:, i:i + s, :] * w[i]
    return F.silu(conv + b)


def _sharded_causal_conv(xBC, w, b) -> torch.Tensor:
    """The causal conv on each rank's ``btd`` shard of [x|B|C]: under
    sequence parallelism the dconv − 1 rows before a rank's shard come
    from the rank before it on the model axis (an all-gather of each
    shard's last rows; zeros on the first rank), so every output is the
    same sum of the same values as on whole tensors. A sequence that does
    not divide the axis into shards of at least dconv − 1 rows is
    convolved whole on every rank (``context.replicated``)."""
    ctx = current_context()
    axis, halo = ctx.model_axis, w.shape[0] - 1
    n = ctx.size(axis)
    if ctx.sequence_parallel and n > 1 and (
            xBC.shape[1] % n or xBC.shape[1] // n < halo):
        return replicated(_causal_conv, xBC, w, b)
    btd = ctx.placements("btd")
    rep = to_placements(P(), ctx.mesh)

    def local(x, w, b):
        if n == 1 or not ctx.sequence_parallel or halo == 0:
            return _causal_conv(x, w, b)
        tails = all_gather(x[:, -halo:], 0, ctx.mesh.get_group(axis))
        r = ctx.mesh.get_local_rank(axis)
        # Every rank's output reads the gather, so that every rank runs
        # its backward (a reduce-scatter) too.
        before = torch.where(
            torch.tensor(r > 0, device=x.device),
            tails.reshape(n, x.shape[0], halo, x.shape[2])[r - 1],
            torch.zeros((), dtype=x.dtype, device=x.device))
        return _causal_conv(x, w, b, before)

    return run_local(local, (btd,), (btd, rep, rep), xBC, w, b,
                     grad_placements=(btd, partial(rep, btd),
                                      partial(rep, btd)))


def _ulysses_ssd(x, dt, a_log, Bm, Cm) -> torch.Tensor:
    """SSD with the heads sharded over the model axis: each rank's heads'
    whole-sequence :func:`ssd_chunked`, y head-sharded (``bshd``). B and
    C are whole on every rank; with more than one group each rank takes
    its heads' rows of them, repeated to a head each."""
    ctx = current_context()
    x = act_constraint(act_constraint(x, "bshd_seq"), "bshd")
    dt = act_constraint(dt, "bsh")
    Bm, Cm = act_constraint(Bm, "bs__"), act_constraint(Cm, "bs__")
    h, g = x.shape[2], Bm.shape[2]

    def local(x, dt, a_log, Bm, Cm):
        hl = x.shape[2]
        lo = ctx.mesh.get_local_rank(ctx.model_axis) * hl
        if g > 1:
            Bm, Cm = (torch.repeat_interleave(t, h // g, dim=2)[
                :, :, lo:lo + hl] for t in (Bm, Cm))
        return ssd_chunked(x, dt, a_log[lo:lo + hl], Bm, Cm)[0]

    bshd, bsh = ctx.placements("bshd"), ctx.placements("bsh")
    bs, rep = ctx.placements("bs__"), to_placements(P(), ctx.mesh)
    y = run_local(local, (bshd,), (bshd, bsh, rep, bs, bs),
                  x, dt, a_log, Bm, Cm,
                  grad_placements=(bshd, bsh, partial(rep), partial(bs),
                                   partial(bs)))
    return act_constraint(y, "bshd")


def mamba2_forward(p: dict, cfg: ModelConfig, u: torch.Tensor
                   ) -> torch.Tensor:
    """u (B, S, D) → (B, S, D). The training and prefill path (chunked
    SSD); under a sharding context the Ulysses or the gathered scan
    (module docstring)."""
    d = _dims(cfg)
    b, s, _ = u.shape
    z, xBC, dt = _split_proj(dense(u, p["in_proj"],
                                   quant_mode=cfg.quant_mode), d)

    if current_context() is None or not is_sharded(xBC):
        xBC = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    else:
        xBC = _sharded_causal_conv(xBC, p["conv_w"], p["conv_b"])
    x, Bm, Cm = _split_xbc(xBC, d)
    dt = softplus(dt.to(torch.float32) + p["dt_bias"])
    if current_context() is None or not is_sharded(x):
        y, _ = ssd_chunked(x, dt.to(x.dtype), p["a_log"], Bm, Cm)
    elif ulysses_enabled(d["nheads"]):
        y = _ulysses_ssd(x, dt.to(x.dtype), p["a_log"], Bm, Cm)
    else:
        y = replicated(lambda *a: ssd_chunked(*a)[0], x, dt.to(x.dtype),
                       p["a_log"], Bm, Cm)
    y = y.to(u.dtype) + x.to(u.dtype) \
        * p["d_skip"][None, None, :, None].to(u.dtype)
    y = y.reshape(b, s, d["d_in"])
    y = rms_norm(y * F.silu(z.to(u.dtype)), p["norm"], cfg.rmsnorm_eps)
    return dense(y, p["out_proj"], quant_mode=cfg.quant_mode)


def init_ssm_cache(cfg: ModelConfig, batch: int,
                   device: Union[str, torch.device] = "cuda") -> dict:
    d = _dims(cfg)
    conv_dim = d["d_in"] + 2 * d["ngroups"] * d["dstate"]
    return {"conv": torch.zeros((batch, d["dconv"] - 1, conv_dim),
                                dtype=cfg.dtype, device=device),
            "ssm": torch.zeros((batch, d["nheads"], d["hd"], d["dstate"]),
                               dtype=torch.float32, device=device)}


def mamba2_decode(p: dict, cfg: ModelConfig, u: torch.Tensor, cache: dict,
                  write_rows: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, dict]:
    """One-token decode, u (B, 1, D). The conv and SSD state are written
    in place, in the rows ``write_rows`` (indices or a bool mask over B;
    None: every row, as the reference). Returns (out (B, 1, D), cache)."""
    d = _dims(cfg)
    b = u.shape[0]
    z, xBC, dt = _split_proj(dense(u[:, 0, :], p["in_proj"],
                                   quant_mode=cfg.quant_mode), d)

    conv_buf = torch.cat([cache["conv"], xBC[:, None, :].to(
        cache["conv"].dtype)], dim=1)
    conv = torch.einsum("btc,tc->bc", *promote(conv_buf, p["conv_w"]))
    x_t, B_t, C_t = _split_xbc(F.silu(conv + p["conv_b"]), d)
    dt_t = softplus(dt.to(torch.float32) + p["dt_bias"][None, :])

    y, new_ssm = ssd_recurrent_step(
        cache["ssm"], x_t.to(torch.float32), dt_t, p["a_log"],
        B_t.to(torch.float32), C_t.to(torch.float32))
    y = y.to(u.dtype) + x_t * p["d_skip"][None, :, None].to(u.dtype)
    y = rms_norm(y.reshape(b, d["d_in"]) * F.silu(z), p["norm"],
                 cfg.rmsnorm_eps)
    out = dense(y, p["out_proj"], quant_mode=cfg.quant_mode)
    for name, new in (("conv", conv_buf[:, 1:]), ("ssm", new_ssm)):
        cache[name].copy_(select_rows(write_rows, new, cache[name]))
    return out[:, None, :], cache
