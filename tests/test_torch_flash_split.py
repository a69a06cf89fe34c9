"""The arithmetic of the tensor-core flash kernels emulated in plain
PyTorch on the CPU, against the reference's Pallas kernels in interpret
mode: the bf16 route's ``csrc/flash_attention_fwd_sm90.cu``,
``csrc/flash_attention_bwd_dq_sm90.cu`` and ``csrc/flash_attention_bwd_
dkv_sm90.cu``, and the fp32 route's backward, ``csrc/flash_attention_bwd_
dq_f32_sm90.cu`` and ``csrc/flash_attention_bwd_dkv_f32_sm90.cu``.

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

The fp32 backward splits its fp32 inputs too: q, k, v and dO each into
three bf16 terms (a pre-pass), and p and ds into three, and computes
every product a·b as the sum of the cross terms t_i(a)·t_j(b) with i + j
< 3 (six of nine; the three left out weigh 2^-24 and less), lightest
first into one fp32 sum per tile. Its results stay fp32 (dk/dv's fold in
fp32). The emulation runs on fp32 inputs against the Pallas backward in
fp32, from the fp32 forward's out and lse (``ref.flash_attention_fwd_
ref``, the CUDA-core forward's plain version: its s rounds differently
from the backward's, so p may pass 1 by an ulp, as on the card), at
``testing.grads_close``'s fp32 bounds; q and k in two terms miss them.
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
# The fp32 kernels: p and ds in three terms; (q, k) and (v, dO) in three.
F32 = dict(terms=3, in_terms=(3, 3))


def _terms(x, n):
    """x (fp32) as n bf16 terms t0 = bf16(x), t1 = bf16(x − t0), ..."""
    out = []
    for _ in range(n):
        out.append(x.to(torch.bfloat16).float())
        x = x - out[-1]
    return out


def _split_product(x, b, terms, b_terms=None):
    """x (fp32) @ b as the kernels' wgmma products. bf16 route (b_terms
    None, b bf16 values): the sum of t_n·b over the bf16 terms of x,
    heaviest first. fp32 route: b split into b_terms terms too, the sum of
    the cross terms t_i(x)·t_j(b) with i + j < b_terms, lightest first."""
    if b_terms is None:
        return sum((t @ b for t in _terms(x, terms)), 0.0)
    a, bb = _terms(x, terms), _terms(b, b_terms)
    pairs = sorted(((i, j) for i in range(len(a)) for j in range(b_terms)
                    if i + j < b_terms), key=lambda ij: -sum(ij))
    return sum((a[i] @ bb[j] for i, j in pairs), 0.0)


def _products(in_terms):
    """The first products (s and dP) of a route: bf16 inputs exact, fp32
    inputs (in_terms = (q/k terms, v/dO terms)) split."""
    if in_terms is None:
        return (lambda a, b: a @ b), (lambda a, b: a @ b)
    qk, vo = in_terms
    return (lambda a, b: _split_product(a, b, qk, qk),
            lambda a, b: _split_product(a, b, vo, vo))


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
             terms=DQ_TERMS, in_terms=None):
    """The sm90 dq kernel: per query head, key tiles of 64 up to sk_true
    (and the diagonal, causal); S and dP in fp32 from the bf16 operands,
    ds·K with ds split into bf16 terms, each tile's product added to the
    running fp32 sum; dq·scale rounded to bf16 once. With ``in_terms``
    the fp32 kernel on fp32 inputs: every product over split operands
    (``_products``; ds·K with K in k's terms), dq·scale kept fp32."""
    mm_qk, mm_vo = _products(in_terms)
    k_terms = None if in_terms is None else in_terms[0]
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
        s = mm_qk(qf, kt.transpose(1, 2)) * scale
        p = torch.where(_mask(rows, cols, sk_true, causal, False),
                        torch.exp(s - lse[..., None]), 0.0)
        ds = p * (mm_vo(dof, vt.transpose(1, 2)) - delta[..., None])
        dq = dq + _split_product(ds, kt, terms, k_terms)
    return (dq * scale).to(q.dtype)


def dkv_split(q, k, v, out, lse, dout, causal, sk_true, H, Kh,
              terms=DKV_TERMS, in_terms=None):
    """The sm90 dk/dv kernel and its fold: per query head and key tile,
    query tiles of 64 from the diagonal on (causal), pᵀ·dO and dsᵀ·Q
    split into hi and lo; the rep partials summed in query-head order in
    fp32 and rounded to bf16. With ``in_terms`` the fp32 kernel on fp32
    inputs, as in :func:`dq_split`; the fold's sums stay fp32."""
    mm_qk, mm_vo = _products(in_terms)
    qk_t, vo_t = (None, None) if in_terms is None else in_terms
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
            st = mm_qk(kt, qt.transpose(1, 2)) * scale
            p = torch.exp(st - lse[:, None, q0:q0 + TILE])
            p = torch.where(_mask(keys, queries, sk_true, causal, True), p,
                            0.0)
            ds = p * (mm_vo(vt, dot.transpose(1, 2))
                      - delta[:, None, q0:q0 + TILE])
            dv_t = dv_t + _split_product(p, dot, terms, vo_t)
            dk_t = dk_t + _split_product(ds, qt, terms, qk_t)
        dk_part[:, k0:k0 + TILE] = dk_t * scale
        dv_part[:, k0:k0 + TILE] = dv_t
    rep = H // Kh
    fold = lambda t: sum(t.reshape(-1, rep, Sk, t.shape[2])[:, g]
                         for g in range(rep))
    return fold(dk_part).to(k.dtype), fold(dv_part).to(v.dtype)


def _inputs(seed, B, Sq, Sk, H, Kh, dh, dtype=torch.bfloat16, qk_sd=1.0):
    """q (B·H, Sq, dh), k, v (B·Kh, Sk, dh), dO (B·H, Sq, dh) in dtype; q
    and k at standard deviation qk_sd, v and dO at 1."""
    rng = np.random.default_rng(seed)
    mk = lambda sd, *s: torch.from_numpy(rng.normal(0, sd, s).astype(
        np.float32)).to(dtype)
    return (mk(qk_sd, B * H, Sq, dh), mk(qk_sd, B * Kh, Sk, dh),
            mk(1.0, B * Kh, Sk, dh), mk(1.0, B * H, Sq, dh))


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


def _f32_case(seed, B, Sq, Sk, H, Kh, dh, causal, sk_true, qk_sd=1.0):
    """fp32 inputs, the fp32 forward's out and lse (its plain version),
    and the Pallas backward's (dq, dk, dv) on them."""
    q, k, v, dout = _inputs(seed, B, Sq, Sk, H, Kh, dh, torch.float32,
                            qk_sd)
    out, lse = ref.flash_attention_fwd_ref(q, k, v, causal, sk_true, H, Kh)
    want = _pallas_bwd(q, k, v, out, lse, dout, causal, sk_true, H, Kh)
    return (q, k, v, out, lse, dout), want


@pytest.mark.parametrize("B,Sq,Sk,H,Kh,dh,causal,sk_true", DQ_CASES)
def test_dq_split_f32_meets_the_fp32_bounds_against_pallas(
        B, Sq, Sk, H, Kh, dh, causal, sk_true):
    """The fp32 dq kernel's arithmetic (every operand in three bf16
    terms, six cross terms a product) within ``grads_close``'s fp32
    bounds of the Pallas backward in fp32."""
    args, want = _f32_case(B * Sq + Sk + dh + 3, B, Sq, Sk, H, Kh, dh,
                           causal, sk_true)
    dq = dq_split(*args, causal, sk_true, H, Kh, **F32)
    assert dq.dtype == torch.float32 and dq.shape == want[0].shape
    assert testing.grads_close(dq, want[0]), float(
        (dq - want[0]).abs().max())


@pytest.mark.parametrize("B,Sq,Sk,H,Kh,dh,causal,sk_true", CASES)
def test_dkv_split_f32_meets_the_fp32_bounds_against_pallas(
        B, Sq, Sk, H, Kh, dh, causal, sk_true):
    """The fp32 dk/dv kernel's arithmetic and its fp32 fold within
    ``grads_close``'s fp32 bounds of the Pallas backward in fp32."""
    args, want = _f32_case(B * Sq + Sk + dh + 4, B, Sq, Sk, H, Kh, dh,
                           causal, sk_true)
    dk, dv = dkv_split(*args, causal, sk_true, H, Kh, **F32)
    for got, w in zip((dk, dv), want[1:]):
        assert got.dtype == torch.float32 and got.shape == w.shape
        assert testing.grads_close(got, w), float((got - w).abs().max())
        assert not got[:, sk_true:].any()      # keys past sk_true


def test_qk_in_two_terms_misses_the_fp32_bounds():
    """Three terms on q and k are needed: s = q·kᵀ·scale feeds exp, so an
    error ε·|s| in s moves p by that fraction. With q and k in two terms
    (2^-17 of each product) and everything else as the kernels have it,
    dq, dk and dv fall outside the fp32 bounds at scores of a few units
    (q and k at standard deviation 2, the training shape's heads), where
    three terms stay well inside them."""
    B, Sq, Sk, H, Kh, dh, causal, skt = 1, 256, 256, 14, 2, 64, True, 256
    args, want = _f32_case(9, B, Sq, Sk, H, Kh, dh, causal, skt, qk_sd=2.0)
    for in_terms, ok in (((3, 3), True), ((2, 3), False)):
        got = (dq_split(*args, causal, skt, H, Kh, terms=3,
                        in_terms=in_terms),
               *dkv_split(*args, causal, skt, H, Kh, terms=3,
                          in_terms=in_terms))
        close = [testing.grads_close(g, w) for g, w in zip(got, want)]
        assert all(close) if ok else not any(close), (in_terms, close)
