"""The torch port's attention against the JAX reference: the flash
forward (``ops.flash_attention_fwd``: its plain version on the CPU, the
reference's Pallas kernel in interpret mode), full, chunked and flash
attention and the ``sdpa`` dispatch, the KV cache and the GQA decode.

Inputs are made from a seed with numpy and handed to both packages. The
comparisons are in fp32 at rtol 2e-5 / atol 2e-6 (the flash ``out`` and
``lse``) or at the port's fp32 tolerance: the two sides sum in other
orders (XLA's dots and the Pallas kernel's tiles against one
``torch.matmul`` over all keys).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention_fwd_pallas  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
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
    q, k, v = _t(*_qkv(1, 1, 8, 8, 2, 1, 8))
    with pytest.raises(NotImplementedError, match="slice 5"):
        ops.flash_attention_fwd(q.requires_grad_(), k, v)
    with torch.no_grad():
        ops.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        kflash.flash_attention_fwd(
            torch.zeros(2, 8, 64), torch.zeros(1, 8, 64),
            torch.zeros(1, 8, 64), causal=True, sk_true=8, q_heads=2,
            kv_heads=1, scale=0.125)


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
