"""The torch port's attention against the JAX reference: the flash
forward and backward (``ops.flash_attention_fwd``/``_bwd``: their plain
versions on the CPU, the reference's Pallas kernels in interpret mode),
full, chunked and flash attention and the ``sdpa`` dispatch, their
gradients, the KV cache and the GQA decode.

Inputs are made from a seed with numpy and handed to both packages. The
comparisons are in fp32 at rtol 2e-5 / atol 2e-6 (the flash ``out`` and
``lse``) or at the port's fp32 tolerance: the two sides sum in other
orders (XLA's dots and the Pallas kernel's tiles against one
``torch.matmul`` over all keys). Gradients agree at rtol 1e-5 with an
absolute floor of 1e-6 of the largest gradient (they sum up to 128 keys,
or rep × 64 queries). bf16 gradients are held to the reference run in
fp32 on the same bf16 inputs, within one bf16 ulp plus that tolerance:
the Pallas kernel rounds each repeated head's dk/dv to bf16 before the
group sum, where the port sums in fp32 and rounds once.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd_pallas, flash_attention_fwd_pallas)
from repro.models import attention as jattn  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.kernels import flash_attention as kflash  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.layers import rope_angles  # noqa: E402

RTOL, ATOL = 2e-5, 2e-6


def _qkv(seed, B, Sq, Sk, H, Kh, dh):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, Sq, H, dh)).astype(np.float32),
            rng.normal(0, 1, (B, Sk, Kh, dh)).astype(np.float32),
            rng.normal(0, 1, (B, Sk, Kh, dh)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Sq,Sk,H,Kh,dh", [
    (1, 40, 40, 14, 2, 8),      # qwen2-0.5B's head layout, GQA rep 7
    (2, 64, 64, 4, 2, 16),      # kernel_bench's heads
    (2, 24, 24, 3, 3, 8),       # rep 1
    (1, 40, 37, 4, 2, 8),       # Sk not a tile multiple, Sq != Sk
    (1, 17, 50, 4, 1, 8),       # Sq < Sk, one KV head
])
def test_flash_fwd_matches_reference_ops(B, Sq, Sk, H, Kh, dh, causal):
    q, k, v = _qkv(B * Sq + Sk + H, B, Sq, Sk, H, Kh, dh)
    want_o, want_l = jops.flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        bq=16, bk=16)
    got_o, got_l = ops.flash_attention_fwd(*_t(q, k, v), causal=causal)
    assert got_o.shape == (B, Sq, H, dh) and got_l.shape == (B, H, Sq)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_ref_matches_pallas_kernel_with_sk_true(causal):
    """The plain version in the Pallas kernel's own layout, with padded
    keys masked by ``sk_true`` and the GQA head map, against the Pallas
    kernel in interpret mode."""
    rng = np.random.default_rng(3)
    B, H, Kh, S, Skp, dh = 2, 6, 2, 32, 48, 8
    q = rng.normal(0, 1, (B * H, S, dh)).astype(np.float32)
    k = rng.normal(0, 1, (B * Kh, Skp, dh)).astype(np.float32)
    v = rng.normal(0, 1, (B * Kh, Skp, dh)).astype(np.float32)
    want_o, want_l = flash_attention_fwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        bq=16, bk=16, sk_true=40, q_heads=H, kv_heads=Kh, interpret=True)
    got_o, got_l = ref.flash_attention_fwd_ref(*_t(q, k, v), causal, 40,
                                               H, Kh)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                               rtol=RTOL, atol=ATOL)


def test_flash_ref_gqa_map_is_the_pallas_index_map():
    """Query head b reads KV head (b // H)·Kh + (b % H) // rep: with each
    KV head's values constant, the output names the head it read."""
    B, H, Kh, S, dh = 2, 14, 2, 8, 4
    q = torch.zeros(B * H, S, dh)
    k = torch.zeros(B * Kh, S, dh)
    v = torch.arange(B * Kh, dtype=torch.float32)[:, None, None].expand(
        B * Kh, S, dh).contiguous()
    out, _ = ref.flash_attention_fwd_ref(q, k, v, True, S, H, Kh)
    b = torch.arange(B * H)
    want = (b // H) * Kh + (b % H) // (H // Kh)
    assert torch.equal(out[:, 0, 0], want.float())


def test_flash_fwd_bf16_out_is_the_f32_result_rounded():
    q, k, v = _qkv(5, 1, 40, 40, 4, 2, 8)
    qb, kb, vb = (x.to(torch.bfloat16) for x in _t(q, k, v))
    got, lse = ops.flash_attention_fwd(qb, kb, vb)
    want, want_lse = ops.flash_attention_fwd(qb.float(), kb.float(),
                                             vb.float())
    assert got.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert torch.equal(got, want.to(torch.bfloat16))
    assert torch.equal(lse, want_lse)


def test_flash_refuses_gradients_and_cpu_tensors_in_the_kernel_wrapper():
    """Gradients now flow through ``ops.flash_attention_fwd`` (its
    autograd Function, the backward's plain version on the CPU) and match
    torch.autograd through ``full_attention``, with and without autograd
    the same values; the kernel wrappers still refuse CPU tensors."""
    q, k, v = _t(*_qkv(1, 1, 8, 8, 2, 1, 8))
    q.requires_grad_()
    out, lse = ops.flash_attention_fwd(q, k, v)
    assert out.requires_grad and not lse.requires_grad
    (dq,) = torch.autograd.grad(out.square().sum(), q)
    (want,) = torch.autograd.grad(
        attn.full_attention(q, k, v, True).square().sum(), q)
    np.testing.assert_allclose(dq.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    with torch.no_grad():
        assert torch.equal(ops.flash_attention_fwd(q, k, v)[0], out)
    for fn, extra in ((kflash.flash_attention_fwd, ()),
                      (kflash.flash_attention_bwd_dq, (torch.zeros(2, 8, 64),
                                                       torch.zeros(2, 8),
                                                       torch.zeros(2, 8))),
                      (kflash.flash_attention_bwd_dkv, (
                          torch.zeros(2, 8, 64), torch.zeros(2, 8),
                          torch.zeros(2, 8))),
                      (kflash.flash_attention_bwd_dq_sm90, (
                          torch.zeros(2, 8, 64), torch.zeros(2, 8),
                          torch.zeros(2, 8)))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(torch.zeros(2, 8, 64), torch.zeros(1, 8, 64),
               torch.zeros(1, 8, 64), *extra, causal=True, sk_true=8,
               q_heads=2, kv_heads=1, scale=0.125)


GRAD_RTOL = 1e-5


def _grads_close(got, want, rtol=GRAD_RTOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("causal,Sq,Sk,sk_true,H,Kh,dtype", [
    (True, 32, 32, None, 4, 4, "float32"),
    (False, 32, 32, None, 4, 4, "float32"),
    (True, 64, 128, None, 4, 2, "float32"),     # GQA, Sq != Sk
    (False, 64, 128, 100, 4, 2, "float32"),     # keys past sk_true
    (True, 32, 64, 40, 6, 2, "float32"),        # rep 3 and sk_true
    (True, 32, 32, None, 4, 2, "bfloat16"),
    (False, 64, 128, 100, 4, 4, "bfloat16"),
])
def test_flash_bwd_matches_pallas_kernel(causal, Sq, Sk, sk_true, H, Kh,
                                         dtype):
    """``ops.flash_attention_bwd`` (the plain version on the CPU) against
    ``flash_attention_bwd_pallas`` in interpret mode, on the same q, k, v,
    out, lse and dO. The Pallas kernels have no GQA fold: the reference
    gets K/V repeated to the query heads, and its dk/dv are summed over
    each KV head's group."""
    B, dh = 2, 8
    rng = np.random.default_rng(Sq + Sk + H)
    q, k, v = _qkv(rng.integers(1 << 16), B, Sq, Sk, H, Kh, dh)
    dout = rng.normal(0, 1, (B, Sq, H, dh)).astype(np.float32)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo = (t.to(tdt) for t in _t(q, k, v, dout))
    out, lse = ops.flash_attention_fwd(tq, tk, tv, causal, sk_true)
    got = ops.flash_attention_bwd(tq, tk, tv, out, lse, tdo, causal, sk_true)

    f32 = lambda t: t.float().numpy()
    heads = lambda a: jnp.asarray(a).swapaxes(1, 2).reshape(
        -1, a.shape[1], a.shape[3])
    rep = lambda t: np.repeat(f32(t), H // Kh, axis=2)
    want = flash_attention_bwd_pallas(
        heads(f32(tq)), heads(rep(tk)), heads(rep(tv)), heads(f32(out)),
        jnp.asarray(f32(lse).reshape(-1, Sq)), heads(f32(tdo)),
        causal=causal, bq=16, bk=16, sk_true=sk_true, interpret=True)
    want = [np.asarray(w).reshape(B, H, -1, dh).swapaxes(1, 2)
            for w in want]
    for i in (1, 2):                      # sum each KV head's group
        want[i] = want[i].reshape(B, Sk, Kh, H // Kh, dh).sum(3)
    for g, w in zip(got, want):
        assert g.dtype == tdt
        if dtype == "float32":
            _grads_close(f32(g), w)
        else:
            assert testing.bf16_within(
                g, torch.tensor(w), rtol=GRAD_RTOL,
                atol=1e-6 * float(np.abs(w).max()))[0]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_gradients_match_full_attention_and_gradcheck(causal):
    """Through the autograd Function against torch.autograd through
    ``full_attention`` (fp32, GQA rep 7, keys padded past ``sk_true``
    get no gradient), and ``gradcheck`` in float64."""
    q, k, v = (t.requires_grad_() for t in _t(*_qkv(8, 2, 20, 20, 14, 2,
                                                    8)))
    g = torch.from_numpy(np.random.default_rng(9).normal(
        0, 1, (2, 20, 14, 8)).astype(np.float32))
    got = torch.autograd.grad(ops.flash_attention_fwd(q, k, v, causal)[0],
                              (q, k, v), g)
    want = torch.autograd.grad(attn.full_attention(q, k, v, causal),
                               (q, k, v), g)
    for a, b in zip(got, want):
        _grads_close(a.numpy(), b.numpy())
    kp, vp = (torch.cat([t.detach(), torch.full_like(t[:, :5], 3.0)], 1)
              .requires_grad_() for t in (k, v))
    padded = torch.autograd.grad(
        ops.flash_attention_fwd(q, kp, vp, causal, sk_true=20)[0],
        (q, kp, vp), g)
    for a, b in zip(padded, got):
        _grads_close(a[:, :20].numpy(), b.numpy())
    assert not padded[1][:, 20:].any() and not padded[2][:, 20:].any()
    q64 = q.detach()[:1, :4, :2, :4].double().requires_grad_()
    k64, v64 = (t.detach()[:1, :6, :1, :4].double().requires_grad_()
                for t in (k, v))
    assert torch.autograd.gradcheck(
        lambda a, b, c: ops.flash_attention_fwd(a, b, c, causal, 5)[0],
        (q64, k64, v64))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_gradients_match_reference(causal):
    """``attention.flash_attention`` (KV padded to the chunk, the kernels'
    plain versions) against ``jax.vjp`` of the reference's pure-JAX
    ``_flash`` custom VJP, fp32, GQA rep 2."""
    q, k, v = _qkv(21, 2, 40, 40, 4, 2, 8)
    g = np.random.default_rng(22).normal(0, 1, q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jattn.flash_attention(a, b, c, causal,
                                                           16),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    got = torch.autograd.grad(attn.flash_attention(tq, tk, tv, causal, 16),
                              (tq, tk, tv), torch.from_numpy(g))
    for a, b in zip(got, want):
        _grads_close(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kv_len", [None, [5, 9]])
@pytest.mark.parametrize("causal,q_offset", [(True, 0), (False, 0),
                                             (True, 3)])
def test_full_attention_matches_reference(causal, q_offset, kv_len):
    q, k, v = _qkv(11, 2, 6, 12, 4, 2, 8)
    kl = None if kv_len is None else np.asarray(kv_len, np.int32)
    want = jattn.full_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal, q_offset,
                                None if kl is None else jnp.asarray(kl))
    got = attn.full_attention(*_t(q, k, v), causal, q_offset,
                              None if kl is None else torch.from_numpy(kl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_full_attention_promotes_a_bf16_cache_as_jax_does():
    """An fp32 model's queries against the bf16 cache: fp32 throughout."""
    q, k, v = _qkv(12, 1, 1, 16, 4, 2, 8)
    kb = jnp.asarray(k).astype(jnp.bfloat16)
    vb = jnp.asarray(v).astype(jnp.bfloat16)
    want = jattn.full_attention(jnp.asarray(q), kb, vb, False)
    got = attn.full_attention(torch.from_numpy(q),
                              *lm_params_from_numpy(
                                  {"k": np.asarray(kb), "v": np.asarray(vb)},
                                  "cpu").values(), False)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,chunk", [(40, 16), (32, 16)])
def test_chunked_and_flash_attention_match_reference(S, chunk, causal):
    q, k, v = _qkv(S + chunk, 2, S, S, 4, 2, 8)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    tq, tk, tv = _t(q, k, v)
    for jfn, tfn in ((jattn.chunked_attention, attn.chunked_attention),
                     (jattn.flash_attention, attn.flash_attention)):
        want = jfn(jq, jk, jv, causal, chunk)
        got = tfn(tq, tk, tv, causal, chunk)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("Sk", [16, 40])
def test_sdpa_dispatch_matches_reference(Sk, monkeypatch):
    """KV longer than the chunk takes the flash branch (the kernel's
    plain version on the CPU), otherwise full attention."""
    q, k, v = _qkv(Sk, 1, Sk, Sk, 4, 2, 8)
    calls = []
    real = ops.flash_attention_fwd
    monkeypatch.setattr(ops, "flash_attention_fwd",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    want = jattn.sdpa(*(jnp.asarray(x) for x in (q, k, v)), True, 16)
    got = attn.sdpa(*_t(q, k, v), True, 16)
    assert len(calls) == (Sk > 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("name", ["qwen2-0.5b", "qwen3-4b"])
def test_gqa_attention_and_decode_match_reference(name):
    jcfg, cfg = jax_smoke(name), get_smoke_config(name)
    rng = np.random.default_rng(7)
    jp = jattn.init_gqa_params(jax.random.PRNGKey(2), jcfg)
    jp = {k: v + jnp.asarray(rng.normal(0, 0.1, v.shape), v.dtype)
          for k, v in jp.items()}                 # non-trivial biases, norms
    tp = lm_params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                              "cpu")
    x = rng.normal(0, 1, (2, 5, cfg.d_model)).astype(np.float32)
    want = jattn.gqa_attention(jp, jcfg, jnp.asarray(x), jnp.arange(5))
    got = attn.gqa_attention(tp, cfg, torch.from_numpy(x), torch.arange(5))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    spec = jattn.CacheSpec(2, 8)
    jcache = jattn.init_kv_cache(jcfg, spec)
    tcache = attn.init_kv_cache(cfg, attn.CacheSpec(2, 8), "cpu")
    for pos in range(3):
        xt = x[:, pos:pos + 1]
        want, jcache = jattn.gqa_decode(jp, jcfg, jnp.asarray(xt), jcache,
                                        jnp.int32(pos))
        angles = rope_angles(torch.full((2, 1), pos), cfg.hd(),
                             cfg.rope_theta)
        got, tcache = attn.gqa_decode(tp, cfg, torch.from_numpy(xt), tcache,
                                      pos, angles)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
        # The caches hold bf16 K/V rounded from fp32 values that agree to
        # fp32 tolerance, so an entry may sit one bf16 ulp (at most 2^-7 relative) away.
        for key in ("k", "v"):
            np.testing.assert_allclose(
                tcache[key].float().numpy(),
                np.asarray(jcache[key], np.float32), rtol=2 ** -7, atol=1e-6)


def test_cache_insert_writes_only_the_given_rows():
    cfg = get_smoke_config("qwen2-0.5b")
    cache = attn.init_kv_cache(cfg, attn.CacheSpec(3, 4), "cpu")
    kvd = cache["k"].shape[-1]
    new = torch.arange(3 * kvd, dtype=torch.float32).reshape(3, 1, kvd)
    attn.cache_insert(cache, new, -new, 2, torch.tensor([1]))
    assert cache["k"][[0, 2]].abs().sum() == 0
    assert torch.equal(cache["k"][1, 2], new[1, 0].to(torch.bfloat16))
    assert torch.equal(cache["v"][1, 2], -new[1, 0].to(torch.bfloat16))
    attn.cache_insert(cache, new, new, 0)          # None: every row
    assert torch.equal(cache["k"][:, 0], new[:, 0].to(torch.bfloat16))


def test_int8_cache_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="int8"):
        attn.init_kv_cache(get_smoke_config("qwen2-0.5b"),
                           attn.CacheSpec(1, 4, "int8"))
