"""The arithmetic of the bf16 tensor-core flash kernels
(``csrc/flash_attention_fwd_sm90.cu``, ``csrc/flash_attention_bwd_dq_sm90
.cu``, ``csrc/flash_attention_bwd_dkv_sm90.cu``) emulated in plain
PyTorch on the CPU, against the reference's Pallas kernels in interpret
mode.

Tensor cores take bf16 operands. The kernels feed them the bf16 inputs as
they are (q·kᵀ, dO·vᵀ, k·qᵀ: products of bf16 values are exact in fp32,
the sums fp32) and split the fp32 operand of the second product into
bf16 terms t0 = bf16(x), t1 = bf16(x − t0), ..., one product each into
one fp32 sum: p in p·V in three terms, ds in ds·K, pᵀ and dsᵀ in pᵀ·dO
and dsᵀ·Q in two (hi and lo). The emulation repeats that per tile of 64
keys (forward: the online softmax, acc·corr + tile; dq: each tile's ds·K
added to the running sum, dq·scale rounded to bf16 once) or 64 queries
(dk/dv: each query head's partial summed per tile, the rep partials
folded in query-head order, rounded to bf16 once). The kernels cannot
run here; this shows that the design meets the bounds ``chip_smoke.py``
holds the kernels to (``testing.bf16_within`` on ``out``, lse at atol
1e-5, ``testing.grads_close`` on dq, dk and dv), and that p or ds
rounded to bf16 alone (one term) does not. (The card's tensor cores sum in another order than
this emulation: two terms for p·V, which pass here, left one element of
``out`` outside its bound on the card, so the forward takes three.)

Inputs are bf16 values made from a seed with numpy; the reference runs in
fp32 on the same values (the Pallas backward on K/V repeated to the query
heads, its dk/dv summed over each KV head's group).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd_pallas, flash_attention_fwd_pallas)
from repro_torch import testing  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

TILE = 64                # keys (forward) or queries (dk/dv) a tile
LSE_ATOL = 1e-5


FWD_TERMS, DQ_TERMS, DKV_TERMS = 3, 2, 2      # the kernels' kTerms


def _split_product(x, b, terms):
    """x (fp32) @ b (bf16 values) as the kernels' wgmma products: the sum
    of t_n·b over the bf16 terms t0 = bf16(x), t1 = bf16(x − t0), ..."""
    out = 0.0
    for _ in range(terms):
        t = x.to(torch.bfloat16).float()
        out = out + t @ b
        x = x - t
    return out


def _mask(rows, cols, sk_true, causal, keys_are_rows):
    """True where (row, col) is a valid (query, key) pair."""
    qi, kj = (cols, rows) if keys_are_rows else (rows, cols)
    ok = kj < sk_true
    return ok & (kj <= qi) if causal else ok


def fwd_split(q, k, v, causal, sk_true, H, Kh, terms=FWD_TERMS):
    """The sm90 forward's arithmetic: q (B·H, Sq, dh), k/v (B·Kh, Sk, ·)
    bf16 → (out bf16, lse f32)."""
    k, v = ref._kv_for_queries(k, v, q.shape[0], H, Kh)
    BH, Sq, dh = q.shape
    scale = dh ** -0.5
    qf = q.float()
    m = torch.full((BH, Sq), ref.NEG_INF)
    l = torch.zeros(BH, Sq)
    acc = torch.zeros(BH, Sq, v.shape[2])
    rows = torch.arange(Sq)[:, None]
    for k0 in range(0, sk_true, TILE):
        kt, vt = k[:, k0:k0 + TILE].float(), v[:, k0:k0 + TILE].float()
        s = (qf @ kt.transpose(1, 2)) * scale
        cols = k0 + torch.arange(kt.shape[1])[None, :]
        s = torch.where(_mask(rows, cols, sk_true, causal, False), s,
                        ref.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + _split_product(p, vt, terms)
        m = m_new
    lc = torch.clamp_min(l, 1e-30)
    return (acc / lc[..., None]).to(torch.bfloat16), m + torch.log(lc)


def dq_split(q, k, v, out, lse, dout, causal, sk_true, H, Kh,
             terms=DQ_TERMS):
    """The sm90 dq kernel: per query head, key tiles of 64 up to sk_true
    (and the diagonal, causal); S and dP in fp32 from the bf16 operands,
    ds·K with ds split into bf16 terms, each tile's product added to the
    running fp32 sum; dq·scale rounded to bf16 once."""
    BH, Sq, dh = q.shape
    scale = dh ** -0.5
    kr, vr = ref._kv_for_queries(k, v, BH, H, Kh)
    delta = torch.sum(dout.float() * out.float(), -1)
    qf, dof = q.float(), dout.float()
    rows = torch.arange(Sq)[:, None]
    dq = torch.zeros(BH, Sq, dh)
    for k0 in range(0, sk_true, TILE):
        kt, vt = kr[:, k0:k0 + TILE].float(), vr[:, k0:k0 + TILE].float()
        cols = k0 + torch.arange(kt.shape[1])[None, :]
        s = (qf @ kt.transpose(1, 2)) * scale
        p = torch.where(_mask(rows, cols, sk_true, causal, False),
                        torch.exp(s - lse[..., None]), 0.0)
        ds = p * (dof @ vt.transpose(1, 2) - delta[..., None])
        dq = dq + _split_product(ds, kt, terms)
    return (dq * scale).to(torch.bfloat16)


def dkv_split(q, k, v, out, lse, dout, causal, sk_true, H, Kh,
              terms=DKV_TERMS):
    """The sm90 dk/dv kernel and its fold: per query head and key tile,
    query tiles of 64 from the diagonal on (causal), pᵀ·dO and dsᵀ·Q
    split into hi and lo; the rep partials summed in query-head order in
    fp32 and rounded to bf16."""
    BH, Sq, dh = q.shape
    Sk = k.shape[1]
    scale = dh ** -0.5
    kr, vr = ref._kv_for_queries(k, v, BH, H, Kh)
    delta = torch.sum(dout.float() * out.float(), -1)
    dk_part = torch.zeros(BH, Sk, dh)
    dv_part = torch.zeros(BH, Sk, v.shape[2])
    for k0 in range(0, sk_true, TILE):
        kt, vt = kr[:, k0:k0 + TILE].float(), vr[:, k0:k0 + TILE].float()
        keys = k0 + torch.arange(kt.shape[1])[:, None]
        dk_t = torch.zeros(BH, kt.shape[1], dh)
        dv_t = torch.zeros(BH, kt.shape[1], v.shape[2])
        for q0 in range(k0 if causal else 0, Sq, TILE):
            qt = q[:, q0:q0 + TILE].float()
            dot = dout[:, q0:q0 + TILE].float()
            queries = q0 + torch.arange(qt.shape[1])[None, :]
            st = (kt @ qt.transpose(1, 2)) * scale
            p = torch.exp(st - lse[:, None, q0:q0 + TILE])
            p = torch.where(_mask(keys, queries, sk_true, causal, True), p,
                            0.0)
            ds = p * (vt @ dot.transpose(1, 2)
                      - delta[:, None, q0:q0 + TILE])
            dv_t = dv_t + _split_product(p, dot, terms)
            dk_t = dk_t + _split_product(ds, qt, terms)
        dk_part[:, k0:k0 + TILE] = dk_t * scale
        dv_part[:, k0:k0 + TILE] = dv_t
    rep = H // Kh
    fold = lambda t: sum(t.reshape(-1, rep, Sk, t.shape[2])[:, g]
                         for g in range(rep))
    return fold(dk_part).to(torch.bfloat16), fold(dv_part).to(torch.bfloat16)


def _inputs(seed, B, Sq, Sk, H, Kh, dh):
    """bf16 q (B·H, Sq, dh), k, v (B·Kh, Sk, dh), dO (B·H, Sq, dh)."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(rng.normal(0, 1, s).astype(
        np.float32)).to(torch.bfloat16)
    return (mk(B * H, Sq, dh), mk(B * Kh, Sk, dh), mk(B * Kh, Sk, dh),
            mk(B * H, Sq, dh))


def _j(t):
    return jnp.asarray(t.float().numpy())


CASES = [
    # (B, Sq, Sk, H, Kh, dh, causal, sk_true)
    (1, 128, 128, 14, 2, 64, True, 128),     # qwen2-0.5B's heads, rep 7
    (2, 64, 160, 4, 4, 64, False, 130),      # rep 1, keys past sk_true
    (1, 96, 96, 4, 2, 128, True, 96),        # head dim 128
    (1, 64, 128, 7, 1, 128, False, 100),     # rep 7, dh 128, sk_true
    (1, 96, 128, 14, 2, 64, True, 100),      # causal with sk_true < Sk
]


def _pallas_fwd(q, k, v, causal, sk_true, H, Kh):
    out, lse = flash_attention_fwd_pallas(
        _j(q), _j(k), _j(v), causal=causal, bq=32, bk=32, sk_true=sk_true,
        q_heads=H, kv_heads=Kh, interpret=True)
    return torch.from_numpy(np.asarray(out)), torch.from_numpy(
        np.asarray(lse))


@pytest.mark.parametrize("B,Sq,Sk,H,Kh,dh,causal,sk_true", CASES)
def test_fwd_split_meets_the_kernel_bounds_against_pallas(
        B, Sq, Sk, H, Kh, dh, causal, sk_true):
    q, k, v, _ = _inputs(B * Sq + Sk + dh, B, Sq, Sk, H, Kh, dh)
    out, lse = fwd_split(q, k, v, causal, sk_true, H, Kh)
    want, want_lse = _pallas_fwd(q, k, v, causal, sk_true, H, Kh)
    assert out.dtype == torch.bfloat16 and out.shape == want.shape
    ok, err = testing.bf16_within(out, want)
    assert ok, err
    assert float((lse - want_lse).abs().max()) <= LSE_ATOL


def _pallas_bwd(q, k, v, out, lse, dout, causal, sk_true, H, Kh):
    """The Pallas backward in interpret mode on K/V repeated to the query
    heads: (dq, dk, dv), dk and dv summed over each KV head's group."""
    B = q.shape[0] // H
    Sk, dh = k.shape[1:]
    rep = H // Kh
    kr, vr = (np.repeat(t.float().numpy().reshape(B, Kh, Sk, dh), rep, 1)
              .reshape(B * H, Sk, dh) for t in (k, v))
    dq, dk, dv = flash_attention_bwd_pallas(
        _j(q), jnp.asarray(kr), jnp.asarray(vr), _j(out), jnp.asarray(
            lse.numpy()), _j(dout), causal=causal, bq=32, bk=32,
        sk_true=sk_true, interpret=True)
    fold = lambda t: torch.from_numpy(np.asarray(t)).reshape(
        B * Kh, rep, Sk, dh).sum(1)
    return torch.from_numpy(np.asarray(dq)), fold(dk), fold(dv)


# Sq not a multiple of the kernel's 64-row tile (the Pallas kernel takes
# multiples of its 32-row block), with a ragged sk_true.
DQ_CASES = CASES + [(1, 96, 96, 14, 2, 64, True, 90),
                    (1, 160, 224, 4, 2, 64, False, 170)]


@pytest.mark.parametrize("B,Sq,Sk,H,Kh,dh,causal,sk_true", DQ_CASES)
def test_dq_split_meets_the_kernel_bounds_against_pallas(
        B, Sq, Sk, H, Kh, dh, causal, sk_true):
    q, k, v, dout = _inputs(B * Sq + Sk + dh + 2, B, Sq, Sk, H, Kh, dh)
    out, lse = fwd_split(q, k, v, causal, sk_true, H, Kh)
    dq = dq_split(q, k, v, out, lse, dout, causal, sk_true, H, Kh)
    want = _pallas_bwd(q, k, v, out, lse, dout, causal, sk_true, H, Kh)[0]
    assert dq.dtype == torch.bfloat16 and dq.shape == want.shape
    assert testing.grads_close(dq, want), float(
        (dq.float() - want).abs().max())


@pytest.mark.parametrize("B,Sq,Sk,H,Kh,dh,causal,sk_true", CASES)
def test_dkv_split_meets_the_kernel_bounds_against_pallas(
        B, Sq, Sk, H, Kh, dh, causal, sk_true):
    q, k, v, dout = _inputs(B * Sq + Sk + dh + 1, B, Sq, Sk, H, Kh, dh)
    out, lse = fwd_split(q, k, v, causal, sk_true, H, Kh)
    dk, dv = dkv_split(q, k, v, out, lse, dout, causal, sk_true, H, Kh)
    _, want_dk, want_dv = _pallas_bwd(q, k, v, out, lse, dout, causal,
                                      sk_true, H, Kh)
    for got, want in ((dk, want_dk), (dv, want_dv)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert testing.grads_close(got, want), float(
            (got.float() - want).abs().max())
        assert not got[:, sk_true:].any()      # keys past sk_true


def test_p_rounded_to_bf16_alone_misses_the_bounds():
    """The split is needed: with p (and ds) rounded to bf16 once, the
    forward's out and the dk/dv fall outside the bounds the split meets
    (the reach of the checks that hold the kernels)."""
    B, Sq, Sk, H, Kh, dh, causal, skt = CASES[0]
    q, k, v, dout = _inputs(7, B, Sq, Sk, H, Kh, dh)
    want, _ = _pallas_fwd(q, k, v, causal, skt, H, Kh)
    out, lse = fwd_split(q, k, v, causal, skt, H, Kh, terms=1)
    assert not testing.bf16_within(out, want)[0]
    out, lse = fwd_split(q, k, v, causal, skt, H, Kh)
    want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                       out.float(), lse, dout.float(),
                                       causal, skt, H, Kh)
    got = dkv_split(q, k, v, out, lse, dout, causal, skt, H, Kh, terms=1)
    assert not all(testing.grads_close(g, w) for g, w in zip(got, want[1:]))


def test_ds_rounded_to_bf16_alone_misses_the_dq_bound():
    """dq's split is needed too: with ds rounded to bf16 once, dq falls
    outside the bound that two terms meet (the training shape's heads)."""
    B, Sq, Sk, H, Kh, dh, causal, skt = CASES[0]
    q, k, v, dout = _inputs(7, B, Sq, Sk, H, Kh, dh)
    out, lse = fwd_split(q, k, v, causal, skt, H, Kh)
    want = _pallas_bwd(q, k, v, out, lse, dout, causal, skt, H, Kh)[0]
    one = dq_split(q, k, v, out, lse, dout, causal, skt, H, Kh, terms=1)
    two = dq_split(q, k, v, out, lse, dout, causal, skt, H, Kh)
    assert testing.grads_close(two, want)
    assert not testing.grads_close(one, want)
