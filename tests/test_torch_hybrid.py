"""The slice as a whole: the port's LM on the moe, ssm and hybrid families
(``models/{lm,blocks}.py``), the int8 KV cache (``models/attention.py``)
and the engine serving them, against the JAX reference.

The smoke configs of granite-moe-3b-a800m, mamba2-370m and
jamba-1.5-large-398b (and granite with ``first_dense_layers=1``) run in
fp32 at ``attn_chunk=16``, so a 40-token prompt takes the flash branch in
the attention layers (the kernel's plain version on the CPU). The
parameters are the reference's initial ones, the norms, conv biases and
SSM vectors perturbed by seeded noise, carried across bit for bit.
Logits agree at rtol 1e-5 / atol 1e-5, as the dense family's, and
gradients at rtol 1e-5 with a floor of 5e-5 of each tensor's largest
(measured: at most 1.6e-5 of it, on mamba2's ``a_log``, whose gradient
sums the decays of every chunk with cancellations; 1.4e-6 elsewhere). The int8
cache's codes, scales and dequantised K/V equal the reference's bit for
bit on the same inputs.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import configs, prng  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import blocks, lm  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine  # noqa: E402
from repro_torch.utils import flatten_dict, tree_map  # noqa: E402

RTOL, ATOL = 1e-5, 1e-5
FAMILIES = {"granite": ("granite-moe-3b-a800m", {}),
            "granite_first_dense": ("granite-moe-3b-a800m",
                                    {"first_dense_layers": 1}),
            "mamba2": ("mamba2-370m", {}),
            "jamba": ("jamba-1.5-large-398b", {}),
            "jamba_int8": ("jamba-1.5-large-398b",
                           {"kv_cache_dtype": "int8"})}
PERTURB = ("norm", "bq", "bk", "bv", "conv_b", "dt_bias", "d_skip")


def _pair(family: str, seed: int = 1, chunk: int = 16):
    name, kw = FAMILIES[family]
    kw = dict(kw, attn_chunk=chunk)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(name), **kw)
    cfg = dataclasses.replace(configs.get_smoke_config(name), **kw)
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a)
        if any(s in path[-1].key for s in PERTURB):
            return a + rng.normal(0, 0.1, a.shape).astype(a.dtype)
        return a

    jp = jax.tree_util.tree_map_with_path(
        perturb, jlm.init_params(jax.random.PRNGKey(seed), jcfg))
    return jcfg, jax.tree.map(jnp.asarray, jp), cfg, \
        lm_params_from_numpy(jp, "cpu")


def _tokens(vocab, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _batch(vocab, B=2, S=40):
    mask = (np.arange(S)[None, :] < np.array([[S - 10], [S]])).astype(
        np.float32)
    return {"tokens": _tokens(vocab, B, S), "labels": _tokens(vocab, B, S, 9),
            "mask": mask}


# ---------------------------------------------------------------------------
# The int8 KV cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_cache_is_the_references_bit_for_bit(dtype):
    """Codes, scales and the dequantised bf16 K/V of three inserts, one
    of them a zero row (scale 0), equal the reference's bits; the
    ``write_rows`` insert writes the reference's row and leaves the
    others."""
    cfg = configs.get_smoke_config("jamba-1.5-large-398b")
    jcfg = jconfigs.get_smoke_config("jamba-1.5-large-398b")
    spec = attn.CacheSpec(3, 5, "int8")
    tc = attn.init_kv_cache(cfg, spec, "cpu")
    jc = jattn.init_kv_cache(jcfg, jattn.CacheSpec(3, 5, "int8"))
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in tc.items()} == \
        {k: (v.shape, f"torch.{v.dtype}") for k, v in jc.items()}
    rng = np.random.default_rng(0)
    kvd = cfg.n_kv_heads * cfg.hd()
    for pos in range(3):
        k, v = (rng.normal(0, 2, (3, 1, kvd)).astype(np.float32)
                for _ in range(2))
        k[1] = 0.0
        jk, jv = (jnp.asarray(a).astype(dtype) for a in (k, v))
        tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            getattr(torch, dtype)) for a in (jk, jv))
        jc = jattn.cache_insert(jc, jk, jv, jnp.int32(pos))
        tc = attn.cache_insert(tc, tk, tv, pos)
    for key in tc:
        assert np.array_equal(tc[key].numpy(), np.asarray(jc[key])), key
    jk, jv = jattn.cache_read(jc)
    tk, tv = attn.cache_read(tc)
    for t, j in ((tk, jk), (tv, jv)):
        assert t.dtype == torch.bfloat16
        assert np.array_equal(t.view(torch.int16).numpy(),
                              np.asarray(j).view(np.int16))
    # write_rows: row 2 gets the reference's codes, rows 0 and 1 stay.
    before = {k: v.clone() for k, v in tc.items()}
    k, v = (rng.normal(0, 1, (3, 1, kvd)).astype(np.float32)
            for _ in range(2))
    jc = jattn.cache_insert(jc, jnp.asarray(k), jnp.asarray(v),
                            jnp.int32(3))
    tc = attn.cache_insert(tc, torch.from_numpy(k), torch.from_numpy(v), 3,
                           write_rows=torch.tensor([2]))
    for key in tc:
        assert np.array_equal(tc[key][2].numpy(), np.asarray(jc[key][2]))
        assert torch.equal(tc[key][:2], before[key][:2])


# ---------------------------------------------------------------------------
# The model on each family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", list(FAMILIES))
def test_forward_and_loss_gradients_match_reference(family):
    jcfg, jp, cfg, tp = _pair(family)
    b = _batch(cfg.vocab)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    np.testing.assert_allclose(
        lm.prefill(tp, cfg, tb).numpy(),
        np.asarray(jlm.forward(jp, jcfg, jb)), rtol=RTOL, atol=ATOL)
    want, jg = jax.value_and_grad(lambda p: jlm.loss_fn(p, jcfg, jb))(jp)
    p = tree_map(lambda t: t.detach().requires_grad_(), tp)
    got = lm.loss_fn(p, cfg, tb)
    flat = flatten_dict(p)
    grads = dict(zip(flat, torch.autograd.grad(got, list(flat.values()))))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    jflat = flatten_dict(jax.tree.map(np.asarray, jg))
    assert set(jflat) == set(grads)
    for k, w in jflat.items():
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=1e-5,
                                   atol=5e-5 * float(np.abs(w).max()),
                                   err_msg=k)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_decode_step_matches_reference(family):
    jcfg, jp, cfg, tp = _pair(family)
    toks = _tokens(cfg.vocab, 2, 6, seed=3)
    jcache = jlm.init_cache(jcfg, 2, 8)
    tcache = lm.init_cache(cfg, 2, 8, "cpu")
    assert jax.tree.structure(jcache) == jax.tree.structure(
        jax.tree.map(lambda t: 0, tcache))
    for pos in range(6):
        t = toks[:, pos:pos + 1]
        want, jcache = jlm.decode_step(jp, jcfg, jcache, jnp.asarray(t),
                                       jnp.int32(pos))
        got, tcache = lm.decode_step(tp, cfg, tcache, torch.from_numpy(t),
                                     pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_decode_step_can_be_captured(family):
    """With a 0-d tensor position and a bool row mask, a decode step runs
    no op that reads a value back to the host or sizes a tensor from
    data (what a CUDA graph cannot capture), and gives the bits of the
    step with an int position and row indices."""
    from torch.utils._python_dispatch import TorchDispatchMode
    _, _, cfg, tp = _pair(family)
    toks = torch.from_numpy(_tokens(cfg.vocab, 3, 1, seed=5))
    syncing = ("_local_scalar_dense", "nonzero", "masked_select",
               "unique", "item")

    class Watch(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bad = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(n in func.__name__ for n in syncing):
                self.bad.append(func.__name__)
            return func(*args, **(kwargs or {}))

    a, b = (lm.init_cache(cfg, 3, 8, "cpu") for _ in range(2))
    for pos in range(2):                    # a cache that is not zero
        lm.decode_step(tp, cfg, a, toks, pos)
        lm.decode_step(tp, cfg, b, toks, pos)
    with Watch() as w:
        got, a = lm.decode_step(tp, cfg, a, toks, torch.tensor(2),
                                write_rows=torch.tensor([True, False, True]))
    assert w.bad == []
    want, b = lm.decode_step(tp, cfg, b, toks, 2,
                             write_rows=torch.tensor([0, 2]))
    assert torch.equal(got, want)
    for (k, x), y in zip(flatten_dict(a).items(), flatten_dict(b).values()):
        assert torch.equal(x, y), k


def test_hybrid_blocks_match_reference():
    """``hybrid_forward`` and ``hybrid_decode`` on jamba's superblocks,
    and the slot structure of the cache (SSM slots and one attention slot
    a superblock, stacked over the superblocks)."""
    jcfg, jp, cfg, tp = _pair("jamba_int8")
    x = np.random.default_rng(4).normal(0, 1, (2, 12, cfg.d_model)).astype(
        np.float32)
    pos = np.arange(12)
    np.testing.assert_allclose(
        blocks.hybrid_forward(tp["layers"], cfg, torch.from_numpy(x),
                              torch.from_numpy(pos)).detach().numpy(),
        np.asarray(jblocks.hybrid_forward(jp["layers"], jcfg,
                                          jnp.asarray(x), jnp.asarray(pos))),
        rtol=RTOL, atol=ATOL)
    jc = jblocks.init_hybrid_caches(jcfg, 2, 4)
    tc = blocks.init_hybrid_caches(cfg, 2, 4, "cpu")
    assert sorted(tc) == [f"slot{j}" for j in range(cfg.attn_every)]
    assert sorted(tc["slot2"]) == ["k", "k_scale", "v", "v_scale"]
    for t in range(3):
        xt = x[:, t:t + 1]
        want, jc = jblocks.hybrid_decode(jp["layers"], jc, jcfg,
                                         jnp.asarray(xt), jnp.int32(t))
        got, tc = blocks.hybrid_decode(tp["layers"], tc, cfg,
                                       torch.from_numpy(xt), t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
    for j in range(cfg.attn_every):
        for k, w in jc[f"slot{j}"].items():
            np.testing.assert_allclose(tc[f"slot{j}"][k].float().numpy(),
                                       np.asarray(w, np.float32), rtol=RTOL,
                                       atol=ATOL, err_msg=f"slot{j}/{k}")


@pytest.mark.parametrize("family", ["mamba2", "jamba"])
def test_remat_recomputes_in_the_backward(family, monkeypatch):
    """Under remat a layer (mamba2) or a whole superblock (jamba) runs
    its forward again in the backward; the gradients are the same bits
    without it."""
    from repro_torch.models import ssm
    _, _, cfg, tp = _pair(family)
    tb = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab, 1, 12).items()}
    real = ssm.mamba2_forward
    out = {}
    for remat in (True, False):
        calls = []
        monkeypatch.setattr(ssm, "mamba2_forward",
                            lambda *a: calls.append(1) or real(*a))
        p = tree_map(lambda t: t.detach().requires_grad_(), tp)
        loss = lm.loss_fn(p, dataclasses.replace(cfg, remat=remat), tb)
        out[remat] = torch.autograd.grad(loss, [p["embed"]])[0]
        n_ssm = sum(cfg.is_ssm_layer(i) for i in range(cfg.n_layers))
        assert len(calls) == n_ssm * (2 if remat else 1)
    assert torch.equal(out[True], out[False])


def test_init_params_follow_the_reference_key_tree():
    for family in ("granite_first_dense", "mamba2", "jamba"):
        name, kw = FAMILIES[family]
        jcfg = dataclasses.replace(jconfigs.get_smoke_config(name), **kw)
        cfg = dataclasses.replace(configs.get_smoke_config(name), **kw)
        want = flatten_dict(jax.tree.map(np.asarray, jlm.init_params(
            jax.random.PRNGKey(7), jcfg)))
        got = flatten_dict(lm.init_params(prng.PRNGKey(7), cfg, "cpu"))
        assert set(got) == set(want), family
        for k, w in want.items():
            assert tuple(got[k].shape) == w.shape, k
            np.testing.assert_allclose(got[k].numpy(), w, rtol=2e-6,
                                       atol=1e-9, err_msg=k)


def test_convert_carries_the_superblock_tree_and_expert_banks_in_bf16():
    """``lm_params_from_numpy`` carries jamba's ``slot{j}`` tree and the
    stacked (n_super, E, D, F) expert banks bit for bit, bf16 included."""
    jcfg = dataclasses.replace(
        jconfigs.get_smoke_config("jamba-1.5-large-398b"), dtype=jnp.bfloat16)
    want = flatten_dict(jax.tree.map(np.asarray, jlm.init_params(
        jax.random.PRNGKey(3), jcfg)))
    got = flatten_dict(lm_params_from_numpy(
        jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(3),
                                                 jcfg)), "cpu"))
    assert set(got) == set(want)
    assert tuple(got["layers/slot1/ffn/w_gate"].shape) == (1, 4, 32, 32)
    for k, w in want.items():
        g = got[k]
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16, k
            assert np.array_equal(g.view(torch.int16).numpy(),
                                  w.view(np.int16)), k
        else:
            assert np.array_equal(g.numpy(), w), k


def _extras(cfg) -> int:
    """Parameters ``param_counts`` leaves out: the norms, the mamba2
    conv and its fp32 vectors."""
    D = cfg.d_model
    d_in = cfg.ssm_expand * D
    nh = d_in // cfg.ssm_head_dim
    conv_dim = d_in + 2 * cfg.ssm_groups * cfg.ssm_state
    n = D                                                   # final norm
    for i in range(cfg.n_layers):
        n += D                                              # norm1
        if cfg.is_ssm_layer(i):
            n += cfg.ssm_conv * conv_dim + conv_dim + 3 * nh + d_in
        if cfg.d_ff or cfg.is_moe_layer(i):
            n += D                                          # norm2
    return n


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "mamba2-370m",
                                  "jamba-1.5-large-398b"])
def test_param_shapes_and_counts_match_reference(name):
    """The published configs' meta trees: the reference's shapes and
    dtypes leaf for leaf, and ``param_counts`` plus the norms and SSM
    vectors it leaves out."""
    cfg, jcfg = configs.get_config(name), jconfigs.get_config(name)
    assert cfg.param_counts() == jcfg.param_counts()
    got = flatten_dict(lm.param_shapes(cfg))
    want = flatten_dict(jlm.param_shapes(jcfg))
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert str(got[k].dtype).split(".")[1] == str(w.dtype), k
        assert got[k].device.type == "meta"
    n = sum(t.numel() for t in got.values())
    assert n == cfg.param_counts()["total"] + _extras(cfg)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["granite", "mamba2", "jamba_int8"])
def test_one_request_decodes_the_reference_engines_tokens(family):
    """One request in a 3-slot engine: the port's greedy tokens are the
    reference engine's (its slot 0 comes first in every expert's
    capacity, so the idle rows cannot drop its slots)."""
    jcfg, jp, cfg, tp = _pair(family, chunk=1024)
    kw = dict(batch_slots=3, max_len=24, eos_token=-1)
    prompt = [5, 9, 17, 3, 44, 2]
    ref = JServeEngine(jcfg, JServeConfig(**kw), jp)
    port = ServeEngine(cfg, ServeConfig(torch_device="cpu", **kw), tp)
    r1, r2 = ref.submit(prompt, 10), port.submit(prompt, 10)
    ref.run_until_drained()
    port.run_until_drained()
    assert len(r2.tokens) == 10 and r2.tokens == r1.tokens


def test_mamba2_batch_composition_contract():
    """A mamba2 request decodes the tokens it decodes alone, whatever the
    other slots serve, and whenever it is admitted: ``write_rows`` keeps
    the SSM state of the slots a decode does not step."""
    _, _, cfg, tp = _pair("mamba2", chunk=1024)
    prompts = [[5, 9, 17, 3], [7, 8, 2, 11, 4, 6], [1, 2], [42, 43, 44]]

    def serve(ps, delay=0):
        eng = ServeEngine(cfg, ServeConfig(batch_slots=3, max_len=32,
                                           eos_token=-1, torch_device="cpu"),
                          tp)
        reqs = [eng.submit(ps[0], 6)]
        for _ in range(delay):
            eng.step()
        reqs += [eng.submit(p, 6) for p in ps[1:]]
        eng.run_until_drained()
        return [r.tokens for r in reqs]
    alone = [serve([p])[0] for p in prompts]
    assert serve(prompts) == alone
    assert serve(prompts, delay=3) == alone


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def _train_cfg(cls, tmp=None):
    return cls(steps=10, lr=1e-3, warmup_steps=2, log_every=1000,
               checkpoint_every=1000,
               checkpoint_dir=None if tmp is None else str(tmp))


@pytest.mark.parametrize("family", ["granite", "mamba2", "jamba_int8"])
def test_trainer_follows_the_reference_trainer(family):
    """Five AdamW steps on 2 × 24-token batches (the flash branch at
    ``attn_chunk=16``) from the same parameters and batches: losses at
    rtol 1e-5, grad norms at rtol 1e-4, as the dense family's."""
    from repro.data.pipeline import ShardedBatcher as JBatcher
    from repro.data.synthetic import lm_token_batch as j_batch
    from repro.train import TrainConfig as JTrainConfig
    from repro.train import Trainer as JTrainer
    from repro_torch.data.pipeline import ShardedBatcher
    from repro_torch.data.synthetic import lm_token_batch
    from repro_torch.train import TrainConfig, Trainer
    jcfg, jp, cfg, tp = _pair(family)
    jt = JTrainer(jcfg, _train_cfg(JTrainConfig),
                  JBatcher(lambda rng, s: j_batch(rng, 2, 24, jcfg.vocab)),
                  params=jp)
    want = jt.run(steps=5)
    t = Trainer(cfg, _train_cfg(TrainConfig),
                ShardedBatcher(lambda rng, s: lm_token_batch(rng, 2, 24,
                                                             cfg.vocab)),
                params=tp, device="cpu")
    got = t.run(steps=5)
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in want], rtol=1e-5)
    np.testing.assert_allclose([h["grad_norm"] for h in got],
                               [h["grad_norm"] for h in want], rtol=1e-4)


def test_hybrid_checkpoint_restores_the_nested_tree(tmp_path):
    """jamba's superblock tree (``layers/slot{j}/…``) and its AdamW state
    save and restore; the restored run continues the uninterrupted one
    bit for bit."""
    from repro_torch.data.pipeline import ShardedBatcher
    from repro_torch.data.synthetic import lm_token_batch
    from repro_torch.train import TrainConfig, Trainer
    _, _, cfg, tp = _pair("jamba_int8")

    def trainer():
        return Trainer(cfg, _train_cfg(TrainConfig, tmp_path),
                       ShardedBatcher(lambda rng, s: lm_token_batch(
                           rng, 2, 24, cfg.vocab)), params=tp, device="cpu")
    a = trainer()
    a.run(steps=2)
    a.save(async_=False)
    a.run(steps=2)
    b = trainer()
    assert b.maybe_restore() and b.step == 2
    assert set(flatten_dict(b.params)) == set(flatten_dict(tp))
    assert any(k.startswith("layers/slot3/ffn/w_gate")
               for k in flatten_dict(b.params))
    b.run(steps=2)
    assert [h["loss"] for h in b.history] == \
        [h["loss"] for h in a.history[2:]]
    for k, v in flatten_dict(a.params).items():
        assert torch.equal(v, flatten_dict(b.params)[k]), k
