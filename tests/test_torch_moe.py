"""The torch port's MoE FFN (``models/moe.py``) against the JAX
reference's global sort-based path, on granite-moe's smoke config (4
experts, top-2, D 32) and variants of it.

Inputs are drawn from a seed with numpy; the parameters are the
reference's initial ones carried across bit for bit. fp32 throughout:
``moe_ffn`` at rtol 2e-5 / atol 1e-6, the routing ids, the capacity and
the ``keep`` mask (which sorted slots fit) exactly. The inputs hold no
exact ties among a token's router probabilities; the tie rule the port
takes (lower expert id first, as ``jax.lax.top_k``) is pinned on its own.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs, prng  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import moe  # noqa: E402

NAME = "granite-moe-3b-a800m"
RTOL, ATOL = 2e-5, 1e-6
VARIANTS = {"plain": {}, "shared": {"n_shared_experts": 1},
            "ample": {"capacity_factor": 8.0},
            "tight": {"capacity_factor": 0.5}}


def _pair(variant: str, seed: int = 0):
    kw = VARIANTS[variant]
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(NAME), **kw)
    cfg = dataclasses.replace(configs.get_smoke_config(NAME), **kw)
    jp = jmoe.init_moe_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, cfg, lm_params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu")


def _x(cfg, B=2, S=12, seed=1):
    return np.random.default_rng(seed).normal(
        0, 1, (B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("S", [12, 1])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_moe_ffn_matches_reference(variant, S):
    jcfg, jp, cfg, tp = _pair(variant)
    x = _x(cfg, S=S)
    want = np.asarray(jmoe.moe_ffn(jp, jcfg, jnp.asarray(x)))
    got = moe.moe_ffn(tp, cfg, torch.from_numpy(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_routing_and_keep_mask_equal_the_reference(variant):
    """The top-k ids, the capacity and the sorted slots' keep mask are
    the reference's exactly; the tight config drops slots, the ample one
    none."""
    jcfg, jp, cfg, tp = _pair(variant)
    x = _x(cfg, B=4, S=12, seed=2)
    T, E, K = 48, cfg.n_experts, cfg.top_k
    C = moe.capacity(cfg, T)
    assert C == max(1, int(-(-T * K // E) * jcfg.capacity_factor))
    xt = jnp.asarray(x.reshape(T, -1))
    jprobs = jax.nn.softmax(xt @ jp["router"], axis=-1)
    _, _, _, jkeep, jslot = jmoe._local_dispatch(xt, jprobs, E, K, C)
    jw, je = jax.lax.top_k(jprobs, K)
    probs, top_w, top_e = moe.route(tp["router"],
                                    torch.from_numpy(x.reshape(T, -1)), K)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs),
                               rtol=1e-6, atol=1e-7)
    assert np.array_equal(top_e.numpy(), np.asarray(je))
    np.testing.assert_allclose(
        top_w.numpy(), np.asarray(jw / jw.sum(-1, keepdims=True)),
        rtol=1e-6)
    d = moe.dispatch(top_e, E, C)
    assert np.array_equal(d["keep"].numpy(), np.asarray(jkeep))
    kept = np.asarray(jkeep)
    assert np.array_equal(d["row"][d["order"]].numpy()[kept],
                          np.asarray(jslot)[kept])
    assert np.array_equal(d["kept"][d["order"]].numpy(), kept)
    assert int(d["filled"].sum()) == int(kept.sum())
    if variant == "tight":
        assert not kept.all()
    if variant == "ample":
        assert kept.all()


def test_top_k_ties_take_the_lower_expert_id_first():
    """The tie rule the port pins: among equal router probabilities the
    lower expert id comes first, as in ``jax.lax.top_k``."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.1, 0.4, 0.1]], np.float32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(probs), 2)[1])
    # route() takes logits through a softmax: log(probs) gives back ties.
    logits = torch.from_numpy(np.log(probs))
    eye = torch.eye(4)
    _, _, top_e = moe.route(eye, logits, 2)
    assert top_e.tolist() == [[0, 1], [1, 2], [0, 2]]
    assert np.array_equal(top_e.numpy(), want)


def test_moe_load_stats_match_reference():
    jcfg, jp, cfg, tp = _pair("plain")
    x = _x(cfg, B=4, S=16, seed=3)
    want = jmoe.moe_load_stats(jp, jcfg, jnp.asarray(x))
    got = moe.moe_load_stats(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got["frac_per_expert"].numpy(),
                               np.asarray(want["frac_per_expert"]),
                               rtol=1e-7)
    assert got["max_over_mean"] == pytest.approx(want["max_over_mean"],
                                                 rel=1e-6)


def test_gradients_match_reference():
    """d(Σ y·g)/d(x, router, experts) against ``jax.grad`` at fp32
    tolerance (rtol 1e-5, a floor of 1e-6 of each tensor's largest)."""
    jcfg, jp, cfg, tp = _pair("shared")
    x = _x(cfg, S=8, seed=4)
    g = np.random.default_rng(5).normal(0, 1, x.shape).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jmoe.moe_ffn(p, jcfg, xx) * g)
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    from repro_torch.utils import flatten_dict, tree_map
    p = tree_map(lambda t: t.detach().requires_grad_(), tp)
    xx = torch.from_numpy(x).requires_grad_()
    loss = torch.sum(moe.moe_ffn(p, cfg, xx) * torch.from_numpy(g))
    flat = flatten_dict(p)
    grads = torch.autograd.grad(loss, [xx] + list(flat.values()))
    want = {"x": np.asarray(jgx), **flatten_dict(
        jax.tree.map(np.asarray, jgp))}
    for k, gr in zip(["x"] + list(flat), grads):
        w = want[k]
        np.testing.assert_allclose(gr.numpy(), w, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(w).max()),
                                   err_msg=k)


def test_init_follows_the_reference_key_tree():
    for variant in ("plain", "shared"):
        jcfg, jp, cfg, _ = _pair(variant, seed=7)
        got = moe.init_moe_params(prng.PRNGKey(7), cfg, "cpu")
        from repro_torch.utils import flatten_dict
        want = flatten_dict(jax.tree.map(np.asarray, jp))
        flat = flatten_dict(got)
        assert set(flat) == set(want)
        for k, w in want.items():
            assert tuple(flat[k].shape) == w.shape
            assert flat[k].dtype == torch.float32
            np.testing.assert_allclose(flat[k].numpy(), w, rtol=2e-6,
                                       atol=1e-9, err_msg=k)

