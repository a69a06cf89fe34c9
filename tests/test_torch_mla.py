"""The torch port's MLA (multi-head latent attention, deepseek-v3) and
the deepseek smoke model against the JAX reference, on the CPU.

The same numpy inputs and seeds go through ``repro.models.attention``'s
MLA functions and ``repro_torch.models.attention``'s, with the
reference's parameters carried across by ``convert.lm_params_from_numpy``
(norm scales perturbed from a seed so that every parameter acts). fp32
throughout: the MLA functions at rtol 2e-5 / atol 1e-6, the LM end to end
at ``tests/test_torch_lm.py``'s rtol 1e-5 / atol 1e-5, gradients at rtol
1e-5 with a floor of 1e-5 of each tensor's largest. With ``attn_chunk``
cut to 16 a 40-token prompt takes the flash branch, whose plain version
runs here at (dh, dv) = (nope + rope, v), unequal. The flash wrappers are
held to the reference's Pallas kernels in interpret mode at MLA's
published (192, 128) and at the smoke (12, 8); the pair rule that pads
the head dims on the card is pinned on its own.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd_pallas)
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import qstate as jqstate  # noqa: E402
from repro_torch import configs, optim, prng  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.layers import rope_angles  # noqa: E402
from repro_torch.utils import (flatten_dict, tree_leaves,  # noqa: E402
                               tree_map)

NAME = "deepseek-v3-671b"
RTOL, ATOL = 2e-5, 1e-6          # one module
LM_RTOL, LM_ATOL = 1e-5, 1e-5    # the LM end to end


def _cfgs(chunk: int = 16):
    return (dataclasses.replace(jconfigs.get_smoke_config(NAME),
                                attn_chunk=chunk),
            dataclasses.replace(configs.get_smoke_config(NAME),
                                attn_chunk=chunk))


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a)
        if "norm" in path[-1].key:
            return a + rng.normal(0, 0.1, a.shape).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(perturb, tree)


def _mla_pair(seed: int = 0, chunk: int = 16):
    """(jax cfg, jax MLA params, port cfg, port MLA params)."""
    jcfg, cfg = _cfgs(chunk)
    jp = _perturbed(jattn.init_mla_params(jax.random.PRNGKey(seed), jcfg),
                    seed)
    return jcfg, jax.tree.map(jnp.asarray, jp), cfg, \
        lm_params_from_numpy(jp, "cpu")


def _lm_pair(seed: int = 1, chunk: int = 16):
    """(jax cfg, jax LM params, port cfg, port LM params)."""
    jcfg, cfg = _cfgs(chunk)
    jp = _perturbed(jlm.init_params(jax.random.PRNGKey(seed), jcfg), seed)
    return jcfg, jax.tree.map(jnp.asarray, jp), cfg, \
        lm_params_from_numpy(jp, "cpu")


def _x(cfg, B, S, seed=3):
    return np.random.default_rng(seed).normal(
        0, 1, (B, S, cfg.d_model)).astype(np.float32)


def _tokens(vocab, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# The four MLA functions
# ---------------------------------------------------------------------------

def test_init_mla_params_follow_the_reference_key_tree():
    """From a prng key the port draws the reference's MLA parameters:
    truncated normals within a few fp32 ulp, the norms' ones exactly."""
    jcfg, cfg = _cfgs()
    want = jax.tree.map(np.asarray, jattn.init_mla_params(
        jax.random.PRNGKey(4), jcfg))
    got = attn.init_mla_params(prng.PRNGKey(4), cfg, "cpu")
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape and \
            got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=2e-6, atol=1e-9,
                                   err_msg=k)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [12, 40])        # full attention, flash
def test_mla_attention_matches_reference(S, causal, monkeypatch):
    """At S 40 past ``attn_chunk`` 16 both sides take their flash branch
    (the reference's pure-JAX ``_flash``, the port's kernel's plain
    version) with dh = 8 + 4 against dv = 8."""
    jcfg, jp, cfg, tp = _mla_pair()
    x = _x(cfg, 2, S)
    pos = np.arange(S, dtype=np.int32)
    want = jattn.mla_attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                               causal)
    calls = []
    real = ops.flash_attention_fwd
    monkeypatch.setattr(ops, "flash_attention_fwd", lambda *a, **kw: (
        calls.append(a[0].shape[-1] - a[2].shape[-1]) or real(*a, **kw)))
    got = attn.mla_attention(tp, cfg, torch.from_numpy(x),
                             torch.from_numpy(pos), causal)
    assert calls == ([4] if S > cfg.attn_chunk else [])   # dh - dv
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_init_mla_cache_is_the_reference_latent_cache_in_bf16():
    """``c_kv`` (B, L, kv_lora_rank) and ``k_rope`` (B, L, rope) zeroed,
    bf16 whatever the model's dtype (fp32 here), as the reference's."""
    jcfg, cfg = _cfgs()
    want = jattn.init_mla_cache(jcfg, jattn.CacheSpec(3, 10))
    got = attn.init_mla_cache(cfg, attn.CacheSpec(3, 10, "int8"), "cpu")
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape
        assert got[k].dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        assert not got[k].any()


def test_mla_decode_matches_reference():
    """Six absorbed decode steps from an empty cache: each step's output
    at the module tolerance and the bf16 latent rows written at ``pos``
    equal to the reference's, the rest of the cache untouched."""
    jcfg, jp, cfg, tp = _mla_pair(seed=2)
    B, L = 2, 8
    xs = _x(cfg, B, 6, seed=5)
    jcache = jattn.init_mla_cache(jcfg, jattn.CacheSpec(B, L))
    tcache = attn.init_mla_cache(cfg, attn.CacheSpec(B, L), "cpu")
    for pos in range(6):
        x = xs[:, pos:pos + 1]
        want, jcache = jattn.mla_decode(jp, jcfg, jnp.asarray(x), jcache,
                                        jnp.int32(pos))
        ang = rope_angles(torch.full((B, 1), pos), cfg.qk_rope_head_dim,
                          cfg.rope_theta)
        got, tcache = attn.mla_decode(tp, cfg, torch.from_numpy(x), tcache,
                                      pos, ang)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL, err_msg=f"pos {pos}")
        for k in ("c_kv", "k_rope"):
            w = np.asarray(jcache[k], np.float32)
            g = tcache[k].float().numpy()
            np.testing.assert_allclose(g, w, rtol=2 ** -7, atol=1e-6)
            assert not g[:, pos + 1:].any()


def test_mla_decode_writes_only_the_write_rows():
    """Rows outside ``write_rows`` (indices or a bool mask) keep every bit
    of both latent caches; the rows written hold what an all-rows write
    holds; the step reads nothing back to the host (a 0-d position)."""
    _, _, cfg, tp = _mla_pair(seed=6)
    B, L = 4, 6
    rng = np.random.default_rng(7)
    start = {k: torch.from_numpy(rng.normal(0, 1, (B, L, d)).astype(
        np.float32)).to(torch.bfloat16)
        for k, d in (("c_kv", cfg.kv_lora_rank),
                     ("k_rope", cfg.qk_rope_head_dim))}
    x = torch.from_numpy(_x(cfg, B, 1, seed=8))
    pos = torch.tensor(3)
    ang = rope_angles(pos.reshape(1, 1).expand(B, 1), cfg.qk_rope_head_dim,
                      cfg.rope_theta)
    everyone = {k: v.clone() for k, v in start.items()}
    attn.mla_decode(tp, cfg, x, everyone, pos, ang)
    for rows in (torch.tensor([1, 3]),
                 torch.tensor([True, False, False, True])):
        cache = {k: v.clone() for k, v in start.items()}
        attn.mla_decode(tp, cfg, x, cache, pos, ang, write_rows=rows)
        written = torch.zeros(B, dtype=torch.bool)
        written[rows] = True
        for k in cache:
            assert torch.equal(cache[k][~written], start[k][~written])
            assert torch.equal(cache[k][written], everyone[k][written])
            assert not torch.equal(cache[k][written], start[k][written])


# ---------------------------------------------------------------------------
# The smoke deepseek model end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [40, 12])
def test_smoke_forward_matches_reference(S):
    """Logits and the prefill of the 3-layer smoke model (one dense MLA
    layer, two MoE ones with a shared expert) at the LM tolerance."""
    jcfg, jp, cfg, tp = _lm_pair()
    toks = _tokens(cfg.vocab, 2, S)
    want = np.asarray(jlm.forward(jp, jcfg, {"tokens": jnp.asarray(toks)}))
    got = lm.forward(tp, cfg, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, S, cfg.vocab)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=LM_RTOL,
                               atol=LM_ATOL)
    np.testing.assert_allclose(
        lm.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)}).numpy(),
        want, rtol=LM_RTOL, atol=LM_ATOL)


def test_smoke_train_step_matches_reference():
    """One ``loss_fn`` step through the flash branch (40 tokens, chunk
    16): the loss, every gradient, then ``adam_8bit``'s update of the
    reference's gradients, on both sides: the int8 codes and scales
    equal, the new parameters at the LM tolerance."""
    jcfg, jp, cfg, tp = _lm_pair()
    toks = _tokens(cfg.vocab, 2, 40)
    labels = _tokens(cfg.vocab, 2, 40, seed=9)
    mask = (np.arange(40)[None, :] < np.array([[30], [40]])).astype(
        np.float32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
          "mask": jnp.asarray(mask)}
    want, jg = jax.value_and_grad(lambda p: jlm.loss_fn(p, jcfg, jb))(jp)
    p = tree_map(lambda t: t.detach().requires_grad_(), tp)
    got = lm.loss_fn(p, cfg, {"tokens": torch.from_numpy(toks),
                              "labels": torch.from_numpy(labels),
                              "mask": torch.from_numpy(mask)})
    flat = flatten_dict(p)
    grads = dict(zip(flat, torch.autograd.grad(got, list(flat.values()))))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    jflat = flatten_dict(jax.tree.map(np.asarray, jg))
    assert set(jflat) == set(grads)
    for k, w in jflat.items():
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=k)
    # adam_8bit on the reference's gradients, on both sides.
    jopt, topt = jqstate.adam_8bit(1e-3), optim.adam_8bit(1e-3)
    ju, js = jopt.update(jg, jopt.init(jp), jp)
    tg = lm_params_from_numpy(jax.tree.map(np.asarray, jg), "cpu")
    tu, ts = topt.update(tg, topt.init(tp), tp)
    jmom, tmom = jax.tree.leaves(js[1]), tree_leaves(ts[1])
    assert len(jmom) == len(tmom)
    for a, b in zip(jmom, tmom):
        assert np.array_equal(np.asarray(a), b.numpy())
    new_j = flatten_dict(jax.tree.map(np.asarray, jax.tree.map(
        lambda a, b: a + b, jp, ju)))
    new_t = flatten_dict(optim.apply_updates(tp, tu))
    for k, w in new_j.items():
        np.testing.assert_allclose(new_t[k].numpy(), w, rtol=LM_RTOL,
                                   atol=LM_ATOL, err_msg=k)


def test_smoke_decode_matches_reference():
    """Six decode steps of the smoke model from the latent caches: logits
    at the LM tolerance, the same greedy tokens, the bf16 latent caches
    within one bf16 ulp."""
    jcfg, jp, cfg, tp = _lm_pair()
    toks = _tokens(cfg.vocab, 2, 6, seed=3)
    jcache = jlm.init_cache(jcfg, 2, 8)
    tcache = lm.init_cache(cfg, 2, 8, "cpu")
    for pos in range(6):
        t = toks[:, pos:pos + 1]
        want, jcache = jlm.decode_step(jp, jcfg, jcache, jnp.asarray(t),
                                       jnp.int32(pos))
        got, tcache = lm.decode_step(tp, cfg, tcache, torch.from_numpy(t),
                                     pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=LM_RTOL, atol=LM_ATOL)
        assert torch.equal(lm.greedy_token(got), torch.from_numpy(
            np.array(jlm.greedy_token(want))))
    for part in ("dense", "moe"):
        for k in ("c_kv", "k_rope"):
            np.testing.assert_allclose(
                tcache[part][k].float().numpy(),
                np.asarray(jcache[part][k], np.float32), rtol=2 ** -7,
                atol=1e-6)


def test_prefill_decode_consistency():
    """Token-by-token decode reproduces the full forward in the port up
    to the bf16 rounding of the latent cache (the reference's own test's
    bound, 5e-2), and the flash branch equals full attention. The MoE
    capacity is made ample: past it a prefill drops tokens that a
    one-token decode never drops (the reference's model, at the smoke
    config's 1.25, differs by 0.81 there, and by 0.016 at 8)."""
    _, _, cfg, tp = _lm_pair()
    cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    B, S = 2, 9
    toks = (torch.arange(B * S).reshape(B, S) * 7) % cfg.vocab
    full = lm.prefill(tp, cfg, {"tokens": toks})
    cache = lm.init_cache(cfg, B, S, "cpu")
    dec = torch.stack([lm.decode_step(tp, cfg, cache, toks[:, t:t + 1],
                                      t)[0][:, 0] for t in range(S)], 1)
    assert float((full - dec).abs().max()) < 5e-2
    short = dataclasses.replace(cfg, attn_chunk=4)
    np.testing.assert_allclose(lm.prefill(tp, short, {"tokens": toks}),
                               full, rtol=LM_RTOL, atol=LM_ATOL)


def test_engine_serves_the_smoke_model_and_clears_latent_rows():
    """The serve engine drives the MLA decode (latent caches, one slot a
    request) and a slot given to a new request starts from zeroed latent
    rows (``lm.clear_cache_rows``)."""
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    _, _, cfg, tp = _lm_pair()
    eng = ServeEngine(cfg, ServeConfig(batch_slots=2, max_len=24,
                                       eos_token=-1, torch_device="cpu"),
                      tp)
    rng = np.random.default_rng(11)
    reqs = [eng.submit(rng.integers(0, cfg.vocab, 5).tolist(), 4)
            for _ in range(3)]
    eng.run_until_drained()
    assert all(r.done and len(r.tokens) == 4 for r in reqs)
    assert set(eng.caches["dense"]) == {"c_kv", "k_rope"}
    caches = lm.init_cache(cfg, 2, 4, "cpu")
    for part in caches.values():
        for t in part.values():
            t.fill_(1.0)
    lm.clear_cache_rows(caches, torch.tensor([1]))
    for part in caches.values():
        for t in part.values():
            assert not t[:, 1].any() and t[:, 0].all()


def test_published_config_meta_tree_matches_reference():
    """deepseek-v3-671b at its published widths: the port's parameter tree
    on the meta device has the reference's shapes and dtypes leaf for
    leaf (the reference's through ``jax.eval_shape``)."""
    jcfg, cfg = jconfigs.get_config(NAME), configs.get_config(NAME)
    want = flatten_dict(jax.eval_shape(
        lambda: jlm.init_params(jax.random.PRNGKey(0), jcfg)))
    got = flatten_dict(lm.param_shapes(cfg))
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert str(got[k].dtype).replace("torch.", "") == str(w.dtype), k
    assert tuple(got["layers/mixer/kv_up"].shape) == (58, 512, 128 * 256)


# ---------------------------------------------------------------------------
# The flash wrappers at MLA's head dims, and the pair rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh,dv", [(192, 128), (12, 8)])
def test_flash_fwd_at_mla_head_dims_matches_reference_ops(dh, dv, causal):
    """``ops.flash_attention_fwd`` (its plain version here) against the
    reference's ``ops.flash_attention_fwd`` (the Pallas kernel in
    interpret mode) with dh != dv, Sk off the reference's blocks."""
    B, Sq, Sk, H = 1, 40, 37, 3
    rng = np.random.default_rng(dh + dv)
    q = rng.normal(0, 1, (B, Sq, H, dh)).astype(np.float32)
    k = rng.normal(0, 1, (B, Sk, H, dh)).astype(np.float32)
    v = rng.normal(0, 1, (B, Sk, H, dv)).astype(np.float32)
    want_o, want_l = jops.flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        bq=16, bk=16)
    got_o, got_l = ops.flash_attention_fwd(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    assert got_o.shape == (B, Sq, H, dv)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=RTOL,
                               atol=2e-6)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=RTOL,
                               atol=2e-6)


@pytest.mark.parametrize("causal,sk_true", [(True, None), (False, 50)])
@pytest.mark.parametrize("dh,dv", [(192, 128), (12, 8)])
def test_flash_bwd_at_mla_head_dims_matches_pallas_kernel(dh, dv, causal,
                                                          sk_true):
    """``ops.flash_attention_bwd`` against ``flash_attention_bwd_pallas``
    in interpret mode (which takes dh and dv apart) on the same inputs:
    dq and dk of dh columns, dv of dv, at rtol 1e-5 with a floor of 1e-6
    of the largest gradient."""
    B, Sq, Sk, H = 1, 32, 64, 2
    rng = np.random.default_rng(dh * dv + Sk)
    q = rng.normal(0, 1, (B, Sq, H, dh)).astype(np.float32)
    k = rng.normal(0, 1, (B, Sk, H, dh)).astype(np.float32)
    v = rng.normal(0, 1, (B, Sk, H, dv)).astype(np.float32)
    dout = rng.normal(0, 1, (B, Sq, H, dv)).astype(np.float32)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, dout))
    out, lse = ops.flash_attention_fwd(tq, tk, tv, causal, sk_true)
    got = ops.flash_attention_bwd(tq, tk, tv, out, lse, tdo, causal, sk_true)
    heads = lambda a: jnp.asarray(a).swapaxes(1, 2).reshape(
        -1, a.shape[1], a.shape[3])
    want = flash_attention_bwd_pallas(
        heads(q), heads(k), heads(v), heads(out.numpy()),
        jnp.asarray(lse.numpy().reshape(-1, Sq)), heads(dout),
        causal=causal, bq=16, bk=16, sk_true=sk_true, interpret=True)
    for g, w, t in zip(got, want, (tq, tk, tv)):
        w = np.asarray(w).reshape(B, H, -1, w.shape[-1]).swapaxes(1, 2)
        assert g.shape == t.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(w).max()))


@pytest.mark.parametrize("dh,dv,pair", [
    ((12, 8, (64, 64))), ((100, 64, (128, 128))), ((64, 100, (128, 128))),
    ((192, 128, (192, 128))), ((150, 100, (192, 128))),
    ((64, 64, (64, 64))), ((128, 128, (128, 128)))])
def test_head_dims_pad_to_the_first_pair_that_holds_them(dh, dv, pair):
    """The kernels' (DQK, DV) for (dh, dv): the first of (64, 64), (128,
    128), (192, 128) with DQK >= dh and DV >= dv; equal head dims take the
    pair they took before MLA's was added."""
    assert ops._head_dim(dh, dv) == pair


@pytest.mark.parametrize("dh,dv", [(192, 192), (256, 128), (193, 64)])
def test_head_dims_past_every_pair_raise(dh, dv):
    with pytest.raises(ValueError, match=r"fit none.*\(192, 128\)"):
        ops._head_dim(dh, dv)
