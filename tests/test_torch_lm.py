"""The torch port's dense LM (``models/lm.py``, ``models/blocks.py``,
``models/layers.py``, ``configs/``) against the JAX reference.

The smoke configs of ``qwen2-0.5b`` (QKV bias, tied embeddings),
``internlm2-1.8b`` (untied head) and ``qwen3-4b`` (qk-norm) run in fp32
(the reference's own smoke dtype; in bf16 the reference's pure-JAX flash
rounds scores and probabilities to bf16 where the kernels keep fp32). The
parameters come across through ``convert.lm_params_from_numpy``; with
``attn_chunk=16`` a 40-token prompt takes the flash branch (the kernel's
plain version on the CPU) with its keys padded to 48, and a 12-token one
full attention. Logits agree at rtol 1e-5 / atol 1e-5 (measured: at most
2.5e-6 apart, on logits up to 3.2).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import configs, prng  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import layers, lm  # noqa: E402

DENSE = ["qwen2-0.5b", "internlm2-1.8b", "qwen3-4b"]
RTOL, ATOL = 1e-5, 1e-5


def _pair(name: str, chunk: int = 16, seed: int = 1):
    """(jax cfg, jax params, port cfg, port params): the reference's
    initial parameters with seeded noise on the norms and biases, so every
    parameter is exercised."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(name),
                               attn_chunk=chunk)
    cfg = dataclasses.replace(configs.get_smoke_config(name),
                              attn_chunk=chunk)
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a)
        name = path[-1].key
        if "norm" in name or name in ("bq", "bk", "bv"):
            return a + rng.normal(0, 0.1, a.shape).astype(a.dtype)
        return a

    jp = jax.tree_util.tree_map_with_path(
        perturb, jlm.init_params(jax.random.PRNGKey(seed), jcfg))
    return jcfg, jax.tree.map(jnp.asarray, jp), cfg, \
        lm_params_from_numpy(jp, "cpu")


def _tokens(vocab, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("S", [40, 12])
@pytest.mark.parametrize("name", DENSE)
def test_forward_and_prefill_match_reference(name, S):
    jcfg, jp, cfg, tp = _pair(name)
    toks = _tokens(cfg.vocab, 2, S)
    want = np.asarray(jlm.forward(jp, jcfg, {"tokens": jnp.asarray(toks)}))
    got = lm.forward(tp, cfg, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, S, cfg.vocab)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(
        lm.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)}).numpy(),
        np.asarray(jlm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)})),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", DENSE)
def test_decode_step_matches_reference(name):
    jcfg, jp, cfg, tp = _pair(name)
    toks = _tokens(cfg.vocab, 2, 6, seed=3)
    jcache = jlm.init_cache(jcfg, 2, 8)
    tcache = lm.init_cache(cfg, 2, 8, "cpu")
    for pos in range(6):
        t = toks[:, pos:pos + 1]
        want, jcache = jlm.decode_step(jp, jcfg, jcache, jnp.asarray(t),
                                       jnp.int32(pos))
        got, tcache = lm.decode_step(tp, cfg, tcache, torch.from_numpy(t),
                                     pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
        assert torch.equal(lm.greedy_token(got),
                           torch.from_numpy(np.array(
                               jlm.greedy_token(want))))
    # The caches hold bf16 K/V rounded from fp32 values that agree to
    # fp32 tolerance, so an entry may sit one bf16 ulp (at most 2^-7 relative) away.
    for key in ("k", "v"):
        np.testing.assert_allclose(
            tcache[key].float().numpy(),
            np.asarray(jcache[key], np.float32), rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("name", DENSE)
def test_prefill_and_decode_agree_inside_the_port(name):
    """Decoding a prompt token by token gives the prefill's logits at
    every position, up to the bf16 rounding of the cached K/V."""
    _, _, cfg, tp = _pair(name)
    toks = torch.from_numpy(_tokens(cfg.vocab, 2, 20, seed=4))
    full = lm.prefill(tp, cfg, {"tokens": toks})
    cache = lm.init_cache(cfg, 2, 24, "cpu")
    for pos in range(20):
        step, cache = lm.decode_step(tp, cfg, cache, toks[:, pos:pos + 1],
                                     pos)
        np.testing.assert_allclose(step[:, 0].numpy(), full[:, pos].numpy(),
                                   rtol=0, atol=0.05)
    # The kernel's branch and full attention agree in the port too.
    long = dataclasses.replace(cfg, attn_chunk=8)
    np.testing.assert_allclose(
        lm.prefill(tp, long, {"tokens": toks}).numpy(), full.numpy(),
        rtol=RTOL, atol=ATOL)


def test_bf16_parameters_cross_bit_for_bit():
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("qwen2-0.5b"),
                               dtype=jnp.bfloat16)
    jp = jlm.init_params(jax.random.PRNGKey(5), jcfg)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    wq = tp["layers"]["mixer"]["wq"]
    assert wq.dtype == torch.bfloat16
    jwq = np.asarray(jp["layers"]["mixer"]["wq"])
    assert np.array_equal(wq.view(torch.int16).numpy().view(np.uint16),
                          jwq.view(np.uint16))
    cfg = dataclasses.replace(configs.get_smoke_config("qwen2-0.5b"),
                              dtype=torch.bfloat16, attn_chunk=16)
    toks = torch.from_numpy(_tokens(cfg.vocab, 1, 40))
    logits = lm.prefill(tp, cfg, {"tokens": toks})
    assert logits.dtype == torch.bfloat16 and torch.isfinite(logits).all()
    # Against the same weights widened to fp32: bf16 activations only.
    tp32 = jax.tree.map(lambda a: torch.from_numpy(
        np.asarray(a, np.float32)), jax.tree.map(np.asarray, jp))
    ref32 = lm.prefill(tp32, dataclasses.replace(cfg, dtype=torch.float32),
                       {"tokens": toks})
    np.testing.assert_allclose(logits.float().numpy(), ref32.numpy(),
                               atol=0.08)


def test_init_params_follow_the_reference_key_tree():
    """From a prng key the port draws the reference's parameters (fp32
    truncated normals within a few ulp; ones and zeros exactly)."""
    jcfg = jconfigs.get_smoke_config("internlm2-1.8b")
    cfg = configs.get_smoke_config("internlm2-1.8b")
    want = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(7),
                                                    jcfg))
    got = lm.init_params(prng.PRNGKey(7), cfg, "cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_w) == len(jax.tree.leaves(
        jax.tree.map(lambda t: t.numpy(), got)))
    for path, w in flat_w:
        g = got
        for p in path:
            g = g[p.key]
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-6, atol=1e-9)


def test_param_counts_and_shapes_match_reference():
    for name in jconfigs.list_archs():
        jcfg, cfg = jconfigs.get_config(name), configs.get_config(name)
        assert cfg.param_counts() == jcfg.param_counts(), name
        assert cfg.hd() == jcfg.hd()
    assert configs.list_archs() == jconfigs.list_archs()
    for name in DENSE + ["yi-34b"]:
        cfg = configs.get_config(name)
        shapes = lm.param_shapes(cfg)
        n = sum(t.numel() for t in jax.tree.leaves(
            jax.tree.map(lambda t: t, shapes)))
        biases_norms = cfg.n_layers * (2 * cfg.d_model + (
            (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd()
            if cfg.qkv_bias else 0) + (2 * cfg.hd() if cfg.qk_norm else 0)) \
            + cfg.d_model
        assert n == cfg.param_counts()["total"] + biases_norms, name
        assert shapes["embed"].device.type == "meta"
    q = lm.param_shapes(configs.get_config("qwen2-0.5b"))
    assert q["layers"]["mixer"]["wk"].shape == (24, 896, 128)
    assert q["embed"].dtype == torch.bfloat16 and "lm_head" not in q


def test_loss_value_matches_reference():
    jcfg, jp, cfg, tp = _pair("internlm2-1.8b")
    toks = _tokens(cfg.vocab, 2, 40)
    labels = _tokens(cfg.vocab, 2, 40, seed=9)
    mask = (np.arange(40)[None, :] < np.array([[30], [40]])).astype(
        np.float32)
    want = jlm.loss_fn(jp, jcfg, {"tokens": jnp.asarray(toks),
                                  "labels": jnp.asarray(labels),
                                  "mask": jnp.asarray(mask)})
    with torch.no_grad():
        got = lm.loss_fn(tp, cfg, {"tokens": torch.from_numpy(toks),
                                   "labels": torch.from_numpy(labels),
                                   "mask": torch.from_numpy(mask)})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("remat", [True, False])
def test_loss_gradients_match_reference(remat, monkeypatch):
    """``lm.loss_fn``'s value and every parameter's gradient against
    ``jax.value_and_grad`` of the reference's, on the qwen2-0.5b smoke
    config at ``attn_chunk=16`` (a 40-token batch takes the flash branch
    on both sides: the port's autograd Function around the flash kernels'
    plain versions, the reference's ``_flash`` custom VJP), fp32, with and
    without remat. Gradients agree at rtol 1e-5 with an absolute floor of
    1e-5 of each tensor's largest gradient (measured: at most 2.2e-7
    apart, 1.5e-6 of a tensor's largest, on gradients up to 0.21)."""
    jcfg, jp, cfg, tp = _pair("qwen2-0.5b")
    jcfg = dataclasses.replace(jcfg, remat=remat)
    cfg = dataclasses.replace(cfg, remat=remat)
    toks = _tokens(cfg.vocab, 2, 40)
    labels = _tokens(cfg.vocab, 2, 40, seed=9)
    mask = (np.arange(40)[None, :] < np.array([[30], [40]])).astype(
        np.float32)
    want, jg = jax.value_and_grad(lambda p: jlm.loss_fn(
        p, jcfg, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
                  "mask": jnp.asarray(mask)}))(jp)
    from repro_torch.kernels import ops
    from repro_torch.utils import flatten_dict, tree_map
    calls = []
    real = ops.flash_attention_bwd
    monkeypatch.setattr(ops, "flash_attention_bwd",
                        lambda *a: calls.append(1) or real(*a))
    p = tree_map(lambda t: t.detach().requires_grad_(), tp)
    got = lm.loss_fn(p, cfg, {"tokens": torch.from_numpy(toks),
                              "labels": torch.from_numpy(labels),
                              "mask": torch.from_numpy(mask)})
    flat = flatten_dict(p)
    grads = dict(zip(flat, torch.autograd.grad(got, list(flat.values()))))
    assert len(calls) == cfg.n_layers            # one backward a layer
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    jflat = flatten_dict(jax.tree.map(np.asarray, jg))
    assert set(jflat) == set(grads)
    for k, w in jflat.items():
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=k)


def test_remat_recomputes_each_layer_in_the_backward(monkeypatch):
    """Under ``cfg.remat`` each layer's forward runs again in the backward
    (two flash forwards a layer a step), without it once; the gradients
    are the same bits."""
    from repro_torch.kernels import ops
    from repro_torch.utils import tree_map
    _, _, cfg, tp = _pair("qwen2-0.5b")
    toks = torch.from_numpy(_tokens(cfg.vocab, 1, 40))
    batch = {"tokens": toks, "labels": toks, "mask": torch.ones(1, 40)}
    real = ops.flash_attention_fwd
    out = {}
    for remat in (True, False):
        calls = []
        monkeypatch.setattr(ops, "flash_attention_fwd",
                            lambda *a, **kw: calls.append(1) or real(*a, **kw))
        p = tree_map(lambda t: t.detach().requires_grad_(), tp)
        loss = lm.loss_fn(p, dataclasses.replace(cfg, remat=remat), batch)
        out[remat] = torch.autograd.grad(loss, [p["embed"]])[0]
        assert len(calls) == cfg.n_layers * (2 if remat else 1)
    assert torch.equal(out[True], out[False])


def test_layers_match_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 5, 3, 8)).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)[None].repeat(2, 0)
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                          1e6).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                      1e6)), rtol=1e-5, atol=1e-6)
    s = rng.normal(1, 0.1, 8).astype(np.float32)
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(x), torch.from_numpy(s)).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(s))),
        rtol=1e-6, atol=1e-6)
    w1, w2 = (rng.normal(0, 0.3, sh).astype(np.float32)
              for sh in ((8, 16), (16, 8)))
    np.testing.assert_allclose(
        layers.gelu_mlp(*(torch.from_numpy(a) for a in (x, w1, w2))).numpy(),
        np.asarray(jlayers.gelu_mlp(*(jnp.asarray(a) for a in (x, w1, w2)))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["seamless-m4t-medium", "llava-next-34b"])
def test_unported_families_raise(name):
    """The encoder-decoder (item 11b) and vision-prefix (11c) families,
    which raised before they were ported, run: each smoke config
    initialises, prefills with its frames or patches, decodes and gives a
    finite loss (against the reference in
    ``tests/test_torch_multimodal.py``)."""
    cfg = configs.get_smoke_config(name)
    tp = lm.init_params(prng.PRNGKey(0), cfg, "cpu")
    assert tuple(tp["frontend_proj"].shape) == (cfg.d_model,) * 2
    toks = torch.from_numpy(_tokens(cfg.vocab, 2, 7))
    key, n = ("frames", 6) if cfg.is_encoder_decoder \
        else ("patches", cfg.n_frontend_tokens)
    batch = {"tokens": toks, key: torch.ones(2, n, cfg.d_model),
             "labels": toks, "mask": torch.ones(2, 7)}
    logits = lm.prefill(tp, cfg, batch)
    assert logits.shape == (2, 7, cfg.vocab) and torch.isfinite(logits).all()
    cache = lm.init_cache(cfg, 2, 8, "cpu")
    logits, _ = lm.decode_step(tp, cfg, cache, toks[:, :1], 0)
    assert logits.shape == (2, 1, cfg.vocab) and torch.isfinite(logits).all()
    assert torch.isfinite(lm.loss_fn(tp, cfg, batch))


def test_deepseek_smoke_config_initialises_and_runs():
    """deepseek-v3 (MLA, item 11a) is ported: its smoke config
    initialises, prefills, decodes from the latent cache and gives a
    finite loss (against the reference in ``tests/test_torch_mla.py``)."""
    cfg = configs.get_smoke_config("deepseek-v3-671b")
    tp = lm.init_params(prng.PRNGKey(0), cfg, "cpu")
    assert set(tp["layers"]["mixer"]) == {"q_down", "q_norm", "q_up",
                                          "kv_down", "kv_norm", "kv_up",
                                          "wo"}
    toks = torch.from_numpy(_tokens(cfg.vocab, 2, 7))
    assert torch.isfinite(lm.prefill(tp, cfg, {"tokens": toks})).all()
    cache = lm.init_cache(cfg, 2, 8, "cpu")
    assert cache["moe"]["c_kv"].shape == (cfg.n_layers - 1, 2, 8,
                                          cfg.kv_lora_rank)
    logits, _ = lm.decode_step(tp, cfg, cache, toks[:, :1], 0)
    assert logits.shape == (2, 1, cfg.vocab) and torch.isfinite(logits).all()
    loss = lm.loss_fn(tp, cfg, {"tokens": toks, "labels": toks,
                                "mask": torch.ones(2, 7)})
    assert torch.isfinite(loss)


def test_unported_options_raise():
    """``quant_mode``, the int8 cache and the ``miru`` mixer run (against
    the reference in ``tests/test_torch_lm_quant.py``), the mixer without
    a decode, as in the reference, which is the one refusal left; MLA runs
    (``tests/test_torch_mla.py``), and so do the encoder-decoder and
    vision families (``tests/test_torch_multimodal.py``)."""
    cfg = configs.get_smoke_config("qwen2-0.5b")
    tp = lm.init_params(prng.PRNGKey(0), cfg, "cpu")
    toks = {"tokens": torch.zeros(1, 4, dtype=torch.int64)}
    assert torch.isfinite(lm.forward(
        tp, dataclasses.replace(cfg, quant_mode="wbs"), toks)).all()
    miru = dataclasses.replace(cfg, mixer="miru")
    mp = lm.init_params(prng.PRNGKey(0), miru, "cpu")
    assert torch.isfinite(lm.forward(mp, miru, toks)).all()
    with pytest.raises(NotImplementedError, match="no decode"):
        lm.init_cache(miru, 1, 4, "cpu")
    int8 = lm.init_cache(dataclasses.replace(cfg, kv_cache_dtype="int8"),
                         1, 4, "cpu")
    assert int8["k"].dtype == torch.int8 and "k_scale" in int8
    assert attn.CacheSpec(1, 4, "int8").dtype == "int8"
    y = layers.dense(torch.ones(1, 2), torch.eye(2), quant_mode="wbs")
    assert torch.allclose(y, torch.ones(1, 2))
    with pytest.raises(ValueError, match="unknown device backend"):
        layers.dense(torch.zeros(1, 2), torch.zeros(2, 2), quant_mode="nope")
    assert attn.CacheSpec(1, 4).dtype == "bf16"


def test_entry_points_ask_for_the_card_by_default(monkeypatch):
    cfg = configs.get_smoke_config("qwen2-0.5b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_params(prng.PRNGKey(0), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_cache(cfg, 1, 4)
