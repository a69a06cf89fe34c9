"""The torch port's mamba2 SSD mixer (``models/ssm.py``) against the JAX
reference, on mamba2's smoke config (D 32, state 16, heads of 8) and on
raw SSD inputs drawn from a seed with numpy.

fp32 throughout, each comparison at rtol 1e-5 / atol 1e-5 (the chunked
scan's einsums contract in another order than XLA's); the decode state
likewise. Port-internal: the chunked scan equals the recurrence, a
prompt decoded token by token gives the prefill's outputs, and a decode
with ``write_rows`` leaves every other row's conv and SSD state bit for
bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs, prng  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.utils import flatten_dict  # noqa: E402

NAME = "mamba2-370m"
RTOL, ATOL = 1e-5, 1e-5


def _ssd_inputs(b=2, l=20, h=4, p=8, g=2, n=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(0, 1, (b, l, h, p)).astype(np.float32),
            "dt": rng.uniform(0.05, 0.5, (b, l, h)).astype(np.float32),
            "a_log": np.log(np.linspace(1, 8, h)).astype(np.float32),
            "B": rng.normal(0, 1, (b, l, g, n)).astype(np.float32),
            "C": rng.normal(0, 1, (b, l, g, n)).astype(np.float32)}


def _pair(seed=0, **kw):
    """(jax cfg, jax mixer params, port cfg, port mixer params), the norm,
    the conv bias and the fp32 vectors perturbed so every one counts."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(NAME), **kw)
    cfg = dataclasses.replace(configs.get_smoke_config(NAME), **kw)
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(np.asarray, jssm.init_ssm_params(
        jax.random.PRNGKey(seed), jcfg))
    for k in ("norm", "conv_b", "dt_bias", "d_skip"):
        jp[k] = jp[k] + rng.normal(0, 0.1, jp[k].shape).astype(jp[k].dtype)
    return jcfg, jax.tree.map(jnp.asarray, jp), cfg, \
        lm_params_from_numpy(jp, "cpu")


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("l,chunk", [(20, 8), (16, 8), (5, 8)])
def test_ssd_chunked_matches_reference(l, chunk, with_h0):
    a = _ssd_inputs(l=l)
    h0 = np.random.default_rng(1).normal(0, 1, (2, 4, 8, 16)).astype(
        np.float32) if with_h0 else None
    jy, jf = jssm.ssd_chunked(*(jnp.asarray(a[k]) for k in
                                ("x", "dt", "a_log", "B", "C")),
                              chunk=chunk,
                              h0=None if h0 is None else jnp.asarray(h0))
    y, f = ssm.ssd_chunked(*(torch.from_numpy(a[k]) for k in
                             ("x", "dt", "a_log", "B", "C")), chunk=chunk,
                           h0=None if h0 is None else torch.from_numpy(h0))
    assert y.shape == (2, l, 4, 8) and f.shape == (2, 4, 8, 16)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=RTOL,
                               atol=ATOL)


def test_ssd_recurrent_step_matches_reference():
    a = _ssd_inputs(l=1)
    state = np.random.default_rng(2).normal(0, 1, (2, 4, 8, 16)).astype(
        np.float32)
    args = (state, a["x"][:, 0], a["dt"][:, 0], a["a_log"], a["B"][:, 0],
            a["C"][:, 0])
    jy, js = jssm.ssd_recurrent_step(*map(jnp.asarray, args))
    y, s = ssm.ssd_recurrent_step(*map(torch.from_numpy, args))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("l,chunk", [(20, 8), (7, 4)])
def test_chunked_equals_recurrent(l, chunk):
    """Inside the port: the chunked scan's outputs and final state are
    the token-by-token recurrence's (from the same initial state)."""
    a = {k: torch.from_numpy(v) for k, v in _ssd_inputs(l=l, seed=3).items()}
    h0 = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1, (2, 4, 8, 16)).astype(np.float32))
    y, f = ssm.ssd_chunked(a["x"], a["dt"], a["a_log"], a["B"], a["C"],
                           chunk=chunk, h0=h0)
    s, ys = h0, []
    for t in range(l):
        yt, s = ssm.ssd_recurrent_step(s, a["x"][:, t], a["dt"][:, t],
                                       a["a_log"], a["B"][:, t],
                                       a["C"][:, t])
        ys.append(yt)
    np.testing.assert_allclose(y.numpy(), torch.stack(ys, 1).numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(f.numpy(), s.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("S", [20, 130])
def test_mamba2_forward_matches_reference(S):
    """S 130 pads the default 128-token chunk."""
    jcfg, jp, cfg, tp = _pair()
    u = np.random.default_rng(5).normal(0, 1, (2, S, cfg.d_model)).astype(
        np.float32)
    want = np.asarray(jssm.mamba2_forward(jp, jcfg, jnp.asarray(u)))
    got = ssm.mamba2_forward(tp, cfg, torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_mamba2_decode_matches_reference():
    jcfg, jp, cfg, tp = _pair(seed=1)
    u = np.random.default_rng(6).normal(0, 1, (3, 6, cfg.d_model)).astype(
        np.float32)
    jc = jssm.init_ssm_cache(jcfg, 3)
    tc = ssm.init_ssm_cache(cfg, 3, "cpu")
    for t in range(6):
        jo, jc = jssm.mamba2_decode(jp, jcfg, jnp.asarray(u[:, t:t + 1]), jc)
        o, tc = ssm.mamba2_decode(tp, cfg, torch.from_numpy(u[:, t:t + 1]),
                                  tc)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=RTOL,
                                   atol=ATOL)
    for k in ("conv", "ssm"):
        assert tc[k].dtype == {"conv": torch.float32,
                               "ssm": torch.float32}[k]
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=RTOL, atol=ATOL)


def test_prefill_equals_token_by_token_decode():
    """Inside the port: decoding a prompt token by token gives the
    prefill's outputs within the reference's own 1e-4."""
    _, _, cfg, tp = _pair(seed=2)
    u = torch.from_numpy(np.random.default_rng(7).normal(
        0, 1, (2, 9, cfg.d_model)).astype(np.float32))
    full = ssm.mamba2_forward(tp, cfg, u)
    cache = ssm.init_ssm_cache(cfg, 2, "cpu")
    steps = []
    for t in range(9):
        o, cache = ssm.mamba2_decode(tp, cfg, u[:, t:t + 1], cache)
        steps.append(o[:, 0])
    assert float((full - torch.stack(steps, 1)).abs().max()) < 1e-4


@pytest.mark.parametrize("rows", [[1], [0, 2], "mask"])
def test_write_rows_leave_the_other_rows_state_bit_for_bit(rows):
    _, _, cfg, tp = _pair(seed=3)
    rng = np.random.default_rng(8)
    cache = ssm.init_ssm_cache(cfg, 3, "cpu")
    for t in range(3):                       # a state that is not zero
        cache = ssm.mamba2_decode(tp, cfg, torch.from_numpy(rng.normal(
            0, 1, (3, 1, cfg.d_model)).astype(np.float32)), cache)[1]
    before = {k: v.clone() for k, v in cache.items()}
    u = torch.from_numpy(rng.normal(0, 1, (3, 1, cfg.d_model)).astype(
        np.float32))
    full = {k: v.clone() for k, v in before.items()}
    want_out, full = ssm.mamba2_decode(tp, cfg, u, full)
    write = torch.tensor([False, True, True]) if rows == "mask" \
        else torch.tensor(rows)
    out, cache = ssm.mamba2_decode(tp, cfg, u, cache, write_rows=write)
    assert torch.equal(out, want_out)
    written = torch.zeros(3, dtype=torch.bool)
    written[write] = True
    for k in cache:
        assert torch.equal(cache[k][~written], before[k][~written])
        assert torch.equal(cache[k][written], full[k][written])


def test_init_follows_the_reference_key_tree():
    jcfg = jconfigs.get_smoke_config(NAME)
    cfg = configs.get_smoke_config(NAME)
    want = flatten_dict(jax.tree.map(np.asarray, jssm.init_ssm_params(
        jax.random.PRNGKey(3), jcfg)))
    got = flatten_dict(ssm.init_ssm_params(prng.PRNGKey(3), cfg, "cpu"))
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape and got[k].dtype == \
            torch.float32
        np.testing.assert_allclose(got[k].numpy(), w, rtol=2e-6, atol=1e-9,
                                   err_msg=k)
    shapes = ssm.init_ssm_params(None, configs.get_config(NAME), "meta")
    assert shapes["in_proj"].shape == (1024, 2 * 2048 + 2 * 128 + 32)
    assert shapes["a_log"].device.type == "meta"
