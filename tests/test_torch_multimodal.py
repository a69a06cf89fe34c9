"""The torch port's encoder-decoder family (seamless-m4t-medium), the
vision prefix (llava-next-34b) and ``configs/shapes.py`` against the JAX
reference, on the CPU.

The same numpy inputs and seeds go through ``repro.models.lm`` and
``repro_torch.models.lm``, with the reference's parameters carried across
by ``convert.lm_params_from_numpy`` (norm scales perturbed from a seed so
that every parameter acts). fp32 smoke configs throughout, at
``tests/test_torch_lm.py``'s rtol 1e-5 / atol 1e-5; gradients at rtol
1e-5 with a floor of 1e-5 of each tensor's largest. With ``attn_chunk``
cut to 4 the encoder's self-attention (not causal), the decoder's (causal)
and the cross-attention (not causal, Sq != Sk) all take the flash branch:
the port's plain flash version against the reference's pure-JAX
``_flash``. The flash wrappers at Sq != Sk, not causal, are held to the
reference's Pallas kernels in interpret mode.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd_pallas, flash_attention_fwd_pallas)
from repro.models import lm as jlm  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine  # noqa: E402
from repro_torch.utils import flatten_dict, tree_leaves, tree_map  # noqa

SEAMLESS, LLAVA = "seamless-m4t-medium", "llava-next-34b"
RTOL, ATOL = 1e-5, 1e-5


def _pair(name: str, chunk: int = 1024, seed: int = 1, **kw):
    """(jax cfg, jax params, port cfg, port params)."""
    kw = dict(kw, attn_chunk=chunk)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(name), **kw)
    cfg = dataclasses.replace(configs.get_smoke_config(name), **kw)
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a)
        if "norm" in path[-1].key:
            return a + rng.normal(0, 0.1, a.shape).astype(a.dtype)
        return a

    jp = jax.tree_util.tree_map_with_path(
        perturb, jlm.init_params(jax.random.PRNGKey(seed), jcfg))
    return jcfg, jax.tree.map(jnp.asarray, jp), cfg, \
        lm_params_from_numpy(jp, "cpu")


def _batch(cfg, B: int, S: int, n_prefix: int, seed: int = 0) -> dict:
    """numpy tokens, labels, a ragged mask and, for n_prefix > 0, frames
    (encoder-decoder) or patches (vision) of n_prefix rows."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    b = {"tokens": toks,
         "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "mask": (np.arange(S)[None] < np.array([[S], [S - 3]])[:B]
                  ).astype(np.float32)}
    if n_prefix:
        key = "frames" if cfg.is_encoder_decoder else "patches"
        b[key] = rng.normal(0, 1, (B, n_prefix, cfg.d_model)).astype(
            np.float32)
    return b


def _j(b: dict) -> dict:
    return {k: jnp.asarray(a) for k, a in b.items()}


def _t(b: dict) -> dict:
    return {k: torch.from_numpy(a) for k, a in b.items()}


def _value_and_grad(cfg, tp, batch):
    p = tree_map(lambda t: t.detach().requires_grad_(), tp)
    loss = lm.loss_fn(p, cfg, _t(batch))
    flat = flatten_dict(p)
    grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
    return loss, {k: torch.zeros_like(t) if g is None else g
                  for (k, t), g in zip(flat.items(), grads)}


def _check_grads(jcfg, jp, cfg, tp, batch):
    """The loss and every gradient against the reference's (under
    ``jax.jit``, which runs its scans and checkpoints in a few seconds
    where eager dispatch takes many)."""
    want, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, jcfg, b)))(jp, _j(batch))
    got, grads = _value_and_grad(cfg, tp, batch)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    jflat = flatten_dict(jax.tree.map(np.asarray, jg))
    assert set(jflat) == set(grads)
    for k, w in jflat.items():
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=k)
    return grads


# ---------------------------------------------------------------------------
# seamless: the encoder-decoder
# ---------------------------------------------------------------------------

def test_seamless_init_follows_the_reference_key_tree():
    """From a prng key the port draws the reference's encoder-decoder tree:
    ``frontend_proj``, the encoder, ``enc_norm`` and the decoder with
    ``norm_x`` and ``cross`` a layer, within a few fp32 ulp."""
    from repro_torch import prng
    jcfg, _, cfg, _ = _pair(SEAMLESS)
    want = flatten_dict(jax.tree.map(np.asarray, jlm.init_params(
        jax.random.PRNGKey(4), jcfg)))
    got = flatten_dict(lm.init_params(prng.PRNGKey(4), cfg, "cpu"))
    assert set(got) == set(want)
    assert {"frontend_proj", "enc_norm", "decoder/norm_x",
            "decoder/cross/wq", "encoder/mixer/wk"} <= set(got)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=2e-6, atol=1e-9,
                                   err_msg=k)


@pytest.mark.parametrize("remat", [True, False])
def test_seamless_forward_loss_and_gradients_match_reference(remat):
    """Logits, the prefill, the loss and every gradient on 12 frames and 9
    tokens (full attention everywhere); under remat the encoder's
    gradients arrive through both decoder layers' recomputed
    cross-attention."""
    jcfg, jp, cfg, tp = _pair(SEAMLESS, remat=remat)
    batch = _batch(cfg, 2, 9, 12)
    want = np.asarray(jlm.forward(jp, jcfg, _j(batch)))
    got = lm.forward(tp, cfg, _t(batch))
    assert got.shape == (2, 9, cfg.vocab)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(lm.prefill(tp, cfg, _t(batch)).numpy(), want,
                               rtol=RTOL, atol=ATOL)
    grads = _check_grads(jcfg, jp, cfg, tp, batch)
    for k in ("frontend_proj", "encoder/mixer/wq", "enc_norm",
              "decoder/cross/wk"):
        assert grads[k].abs().max() > 0, k


def test_seamless_flash_branches_match_reference(monkeypatch):
    """With ``attn_chunk`` 4 below T_enc 12 and S 10 every attention takes
    the flash branch (the port's plain flash version, the reference's
    ``_flash``): the encoder's not causal, the decoder's causal, the
    cross-attention not causal at Sq 10 against Sk 12, six calls; the
    logits, loss and every gradient at the LM tolerance."""
    jcfg, jp, cfg, tp = _pair(SEAMLESS, chunk=4)
    batch = _batch(cfg, 2, 10, 12, seed=3)
    calls = []
    real = ops.flash_attention_fwd
    monkeypatch.setattr(ops, "flash_attention_fwd", lambda *a, **kw: (
        calls.append((a[0].shape[1], a[1].shape[1], kw["causal"]))
        or real(*a, **kw)))
    want = np.asarray(jlm.forward(jp, jcfg, _j(batch)))
    got = lm.forward(tp, cfg, _t(batch))
    # keys padded to the chunk: 12 stays 12, 10 becomes 12
    assert sorted(calls) == sorted([(12, 12, False)] * 2
                                   + [(10, 12, True)] * 2
                                   + [(10, 12, False)] * 2)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    _check_grads(jcfg, jp, cfg, tp, batch)


def _cross_cache(jcfg, cfg, B, max_len, enc, seed):
    """The same zeroed caches on both sides with random bf16 cross K/V of
    ``enc`` frames and row lengths (enc, enc - 3, …)."""
    rng = np.random.default_rng(seed)
    kvd = cfg.n_kv_heads * cfg.hd()
    kv = {n: jnp.asarray(rng.normal(0, 1, (cfg.n_layers, B, enc, kvd)),
                         jnp.bfloat16) for n in ("cross_k", "cross_v")}
    lens = np.array([enc - 3 * i for i in range(B)], np.int32)
    jc = dict(jlm.init_cache(jcfg, B, max_len, enc_len=enc), **kv,
              enc_len=jnp.asarray(lens))
    tc = lm.init_cache(cfg, B, max_len, "cpu", enc_len=enc)
    for n, a in lm_params_from_numpy(
            {n: np.asarray(a) for n, a in kv.items()}, "cpu").items():
        assert a.dtype == torch.bfloat16
        tc[n].copy_(a)
    tc["enc_len"].copy_(torch.from_numpy(lens))
    return jc, tc


def test_seamless_decode_matches_reference():
    """Six decode steps from a filled bf16 cross cache with per-row memory
    lengths (8 and 5 of 8), each step from the same caches on both sides
    (the reference's self cache copied into the port's: a K rounded to
    bf16 one ulp apart, where fp32 K lies near a rounding boundary, would
    otherwise carry into the later steps): logits at the LM tolerance,
    the same greedy tokens, the self K/V written within one bf16 ulp, the
    cross cache and ``enc_len`` unwritten."""
    jcfg, jp, cfg, tp = _pair(SEAMLESS)
    jc, tc = _cross_cache(jcfg, cfg, 2, 8, 8, seed=5)
    cross = {n: tc[n].clone() for n in ("cross_k", "cross_v", "enc_len")}
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 6)).astype(
        np.int32)
    for pos in range(6):
        t = toks[:, pos:pos + 1]
        for k, a in lm_params_from_numpy(jax.tree.map(
                np.asarray, jc["self"]), "cpu").items():
            tc["self"][k].copy_(a)
        want, jc = jlm.decode_step(jp, jcfg, jc, jnp.asarray(t),
                                   jnp.int32(pos))
        got, tc = lm.decode_step(tp, cfg, tc, torch.from_numpy(t), pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL, err_msg=f"pos {pos}")
        assert torch.equal(lm.greedy_token(got), torch.from_numpy(
            np.array(jlm.greedy_token(want))))
        for k in ("k", "v"):
            np.testing.assert_allclose(tc["self"][k].float().numpy(),
                                       np.asarray(jc["self"][k], np.float32),
                                       rtol=2 ** -7, atol=1e-6)
    for n, t in cross.items():
        assert torch.equal(tc[n], t), n


def test_seamless_decode_follows_its_forward():
    """Token-by-token decode from a cross cache filled by
    ``lm.encode_cross_kv`` reproduces the forward within 5e-2 (the
    reference's own bound for bf16-cached attention): row 0 over 10
    frames, row 1 over 6 frames with the cache's rows past its
    ``enc_len`` holding junk, against the forward of its 6 frames."""
    _, _, cfg, tp = _pair(SEAMLESS)
    b = _batch(cfg, 2, 9, 10, seed=7)
    toks, frames = torch.from_numpy(b["tokens"]), \
        torch.from_numpy(b["frames"])
    full = [lm.prefill(tp, cfg, {"tokens": toks[:1], "frames": frames[:1]}),
            lm.prefill(tp, cfg, {"tokens": toks[1:],
                                 "frames": frames[1:, :6]})]
    cache = lm.init_cache(cfg, 2, 9, "cpu", enc_len=10)
    for row, n in ((0, 10), (1, 6)):
        k, v = lm.encode_cross_kv(tp, cfg, frames[row:row + 1, :n])
        assert k.dtype == torch.bfloat16 and k.shape == (
            cfg.n_layers, 1, n, cfg.n_kv_heads * cfg.hd())
        cache["cross_k"][:, row, :n], cache["cross_v"][:, row, :n] = \
            k[:, 0], v[:, 0]
        cache["enc_len"][row] = n
    cache["cross_k"][:, 1, 6:] = 3.0
    cache["cross_v"][:, 1, 6:] = -3.0
    dec = torch.stack([lm.decode_step(tp, cfg, cache, toks[:, t:t + 1],
                                      t)[0][:, 0] for t in range(9)], 1)
    assert float((torch.cat(full) - dec).abs().max()) < 5e-2


def test_clear_cache_rows_on_an_encdec_cache():
    """Every leaf of the encoder-decoder cache loses the cleared rows: the
    self K/V and the cross K/V along their batch axis (the second),
    ``enc_len`` along its first; the other rows keep their values."""
    _, _, cfg, _ = _pair(SEAMLESS)
    caches = lm.init_cache(cfg, 3, 4, "cpu", enc_len=5)
    for t in tree_leaves(caches):
        t.fill_(1)
    lm.clear_cache_rows(caches, torch.tensor([0, 2]))
    assert not caches["enc_len"][[0, 2]].any() and caches["enc_len"][1] == 1
    for t in tree_leaves({k: v for k, v in caches.items()
                          if k != "enc_len"}):
        assert not t[:, [0, 2]].any() and t[:, 1].all()


# ---------------------------------------------------------------------------
# llava: the vision prefix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("patches", [True, False])
def test_llava_forward_and_gradients_match_reference(patches):
    """With its 8 patches in front of 12 tokens (rope over all 20, the
    prefix sliced off before the head) and text-only without them: the
    logits, the loss and every gradient (``frontend_proj``'s zero without
    patches, as the reference's)."""
    jcfg, jp, cfg, tp = _pair(LLAVA)
    batch = _batch(cfg, 2, 12, cfg.n_frontend_tokens if patches else 0,
                   seed=8)
    want = np.asarray(jlm.forward(jp, jcfg, _j(batch)))
    got = lm.prefill(tp, cfg, _t(batch))
    assert got.shape == (2, 12, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    grads = _check_grads(jcfg, jp, cfg, tp, batch)
    assert bool(grads["frontend_proj"].abs().max() > 0) == patches


def test_llava_prefix_takes_the_flash_branch():
    """8 patches + 12 tokens past ``attn_chunk`` 16: the causal flash
    branch over the whole 20, against the reference's ``_flash``."""
    jcfg, jp, cfg, tp = _pair(LLAVA, chunk=16)
    batch = _batch(cfg, 2, 12, cfg.n_frontend_tokens, seed=9)
    np.testing.assert_allclose(
        lm.prefill(tp, cfg, _t(batch)).numpy(),
        np.asarray(jlm.forward(jp, jcfg, _j(batch))), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# The engine: one request against the reference engine's tokens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [SEAMLESS, LLAVA])
def test_one_slot_engine_serves_the_reference_engines_tokens(name):
    """seamless over the engine's empty cross memory (``init_cache``'s
    ``enc_len`` 0, as the reference's engine builds it) and llava
    text-only through its int8 cache: one request, the reference engine's
    tokens."""
    jcfg, jp, cfg, tp = _pair(name)
    kw = dict(batch_slots=1, max_len=24, eos_token=-1)
    prompt = [5, 9, 17, 3, 44, 2]
    ref = JServeEngine(jcfg, JServeConfig(**kw), jp)
    port = ServeEngine(cfg, ServeConfig(torch_device="cpu", **kw), tp)
    r1, r2 = ref.submit(prompt, 8), port.submit(prompt, 8)
    ref.run_until_drained()
    port.run_until_drained()
    assert len(r2.tokens) == 8 and r2.tokens == r1.tokens
    if cfg.is_encoder_decoder:
        assert port.caches["cross_k"].shape[2] == 0
    else:
        assert port.caches["k"].dtype == torch.int8


# ---------------------------------------------------------------------------
# Published configs and configs/shapes.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [SEAMLESS, LLAVA])
def test_published_config_meta_tree_matches_reference(name):
    """The published config's parameter tree on the meta device: the
    reference's shapes and dtypes leaf for leaf (``param_shapes``)."""
    jcfg, cfg = jconfigs.get_config(name), configs.get_config(name)
    want = flatten_dict(jlm.param_shapes(jcfg))
    got = flatten_dict(lm.param_shapes(cfg))
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert str(got[k].dtype).replace("torch.", "") == str(w.dtype), k
        assert got[k].device.type == "meta"


@pytest.mark.parametrize("shape_name", list(jshapes.SHAPES))
@pytest.mark.parametrize("name", configs.list_archs())
def test_input_specs_match_reference(name, shape_name):
    """``shapes.input_specs`` against the reference's for every arch and
    shape: the same tree, shapes and dtypes (meta tensors against
    ``ShapeDtypeStruct``s), and the same ``skip_reason``."""
    jcfg, cfg = jconfigs.get_config(name), configs.get_config(name)
    assert shapes.skip_reason(cfg, shape_name) == \
        jshapes.skip_reason(jcfg, shape_name)
    assert shapes.SHAPES[shape_name].__dict__ == \
        jshapes.SHAPES[shape_name].__dict__
    want = {"/".join(str(getattr(k, "key", k)) for k in path): a
            for path, a in jax.tree_util.tree_flatten_with_path(
                jshapes.input_specs(jcfg, shape_name))[0]}
    got = flatten_dict(shapes.input_specs(cfg, shape_name))
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].device.type == "meta", k
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert str(got[k].dtype).replace("torch.", "") == str(w.dtype), k


# ---------------------------------------------------------------------------
# The flash wrappers at Sq != Sk, not causal (the cross-attention's)
# ---------------------------------------------------------------------------

def _heads(a: np.ndarray):
    return jnp.asarray(a).swapaxes(1, 2).reshape(-1, a.shape[1], a.shape[3])


@pytest.mark.parametrize("sk_true", [None, 60])
@pytest.mark.parametrize("H,Kh", [(4, 4), (4, 2)])
def test_flash_fwd_cross_shape_matches_pallas_kernel(H, Kh, sk_true):
    """``ops.flash_attention_fwd`` (its plain version here), not causal,
    Sq 40 against Sk 72 (keys past ``sk_true`` padding), against
    ``flash_attention_fwd_pallas`` in interpret mode: out and lse at rtol
    2e-5 / atol 2e-6."""
    B, Sq, Sk, dh = 1, 40, 72, 64
    rng = np.random.default_rng(H + Kh)
    q = rng.normal(0, 1, (B, Sq, H, dh)).astype(np.float32)
    k, v = (rng.normal(0, 1, (B, Sk, Kh, dh)).astype(np.float32)
            for _ in range(2))
    want_o, want_l = flash_attention_fwd_pallas(
        _heads(q), _heads(k), _heads(v), causal=False, bq=8, bk=8,
        sk_true=sk_true or Sk, q_heads=H, kv_heads=Kh, interpret=True)
    got_o, got_l = ops.flash_attention_fwd(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=False,
        sk_true=sk_true)
    want_o = np.asarray(want_o).reshape(B, H, Sq, dh).swapaxes(1, 2)
    np.testing.assert_allclose(got_o.numpy(), want_o, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got_l.numpy(),
                               np.asarray(want_l).reshape(B, H, Sq),
                               rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("sk_true", [None, 60])
@pytest.mark.parametrize("H,Kh", [(4, 4), (4, 2)])
def test_flash_bwd_cross_shape_matches_pallas_kernel(H, Kh, sk_true):
    """``ops.flash_attention_bwd``, not causal, Sq 40 against Sk 72,
    against ``flash_attention_bwd_pallas`` in interpret mode (the GQA
    fold summed over each KV head's query heads): dq, dk, dv at rtol 1e-5
    with a floor of 1e-6 of the largest gradient; keys past ``sk_true``
    get none."""
    B, Sq, Sk, dh = 1, 40, 72, 64
    rng = np.random.default_rng(10 * H + Kh)
    q, dout = (rng.normal(0, 1, (B, Sq, H, dh)).astype(np.float32)
               for _ in range(2))
    k, v = (rng.normal(0, 1, (B, Sk, Kh, dh)).astype(np.float32)
            for _ in range(2))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, dout))
    out, lse = ops.flash_attention_fwd(tq, tk, tv, False, sk_true)
    got = ops.flash_attention_bwd(tq, tk, tv, out, lse, tdo, False, sk_true)
    rep = H // Kh
    kr, vr = (np.repeat(a, rep, axis=2) for a in (k, v))
    want = flash_attention_bwd_pallas(
        _heads(q), _heads(kr), _heads(vr), _heads(out.numpy()),
        jnp.asarray(lse.numpy().reshape(-1, Sq)), _heads(dout),
        causal=False, bq=8, bk=8, sk_true=sk_true or Sk, interpret=True)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w).reshape(B, H, -1, dh).swapaxes(1, 2)
        if i:          # dk, dv: each KV head's sum over its query heads
            w = w.reshape(B, -1, Kh, rep, dh).sum(3)
        assert g.shape == (tq, tk, tv)[i].shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(w).max()))
    if sk_true is not None:
        assert not got[1][:, sk_true:].any() and \
            not got[2][:, sk_true:].any()
