"""The port's training math against the JAX reference: ζ (k-WTA), the
fused MiRU scan and forward, DFA-through-time gradients, the sparsified
SGD write and BPTT.

Tolerances: float tensors at the repo's fp32 standard, rtol 2e-5 and
atol 1e-6 (sums taken in another order by XLA and ATen); k-WTA masks and
the write masks exactly. The write-mask comparison feeds ζ the
reference's own gradients: an ulp of difference in a gradient can move
the k-th magnitude, which is not a fault of ζ.
"""
import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import dfa as jdfa  # noqa: E402
from repro.core import miru as jmiru  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402

# repro.core re-exports the function ``kwta`` under the module's name.
jkwta = importlib.import_module("repro.core.kwta")
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import dfa, kwta, miru  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

RTOL, ATOL = 2e-5, 1e-6
N_X, N_H, N_Y, T, B = 6, 24, 5, 8, 8


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _setup(seed=0, n_h=N_H):
    jcfg = jmiru.MiRUConfig(n_x=N_X, n_h=n_h, n_y=N_Y)
    cfg = miru.MiRUConfig(n_x=N_X, n_h=n_h, n_y=N_Y)
    jp = jmiru.init_miru_params(jax.random.PRNGKey(seed), jcfg)
    jp = {k: v + 0.05 if v.ndim == 1 else v for k, v in jp.items()}
    jpsi = jmiru.init_dfa_feedback(jax.random.PRNGKey(seed + 1), jcfg)
    p = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    psi = torch.from_numpy(np.asarray(jpsi).copy())
    rng = np.random.default_rng(seed + 2)
    x = rng.uniform(0, 1, (B, T, N_X)).astype(np.float32)
    y = rng.integers(0, N_Y, B).astype(np.int32)
    return jcfg, cfg, jp, p, jpsi, psi, x, y


# ---------------------------------------------------------------------------
# ζ
# ---------------------------------------------------------------------------

def _tied(seed, shape):
    return np.random.default_rng(seed).integers(-3, 4, shape).astype(
        np.float32)


@pytest.mark.parametrize("k,keep_frac", [(1, None), (4, None), (9, None),
                                         (None, 0.57), (None, 0.1)])
@pytest.mark.parametrize("by_magnitude", [True, False])
def test_kwta_exact_with_ties(k, keep_frac, by_magnitude):
    x = _tied(k or 3, (6, 10))
    got = kwta.kwta(torch.from_numpy(x), k=k, keep_frac=keep_frac,
                    by_magnitude=by_magnitude).numpy()
    want = np.asarray(jkwta.kwta(jnp.asarray(x), k=k, keep_frac=keep_frac,
                                 by_magnitude=by_magnitude))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("keep_frac", [0.57, 0.3, 1.0])
@pytest.mark.parametrize("shape", [(24, 24), (6, 24), (5,)])
def test_kwta_global_exact_with_ties(shape, keep_frac):
    x = _tied(len(shape), shape)
    got = kwta.kwta_global(torch.from_numpy(x), keep_frac).numpy()
    want = np.asarray(jkwta.kwta_global(jnp.asarray(x), keep_frac))
    np.testing.assert_array_equal(got, want)
    y = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    np.testing.assert_array_equal(
        kwta.kwta_global(torch.from_numpy(y), keep_frac).numpy(),
        np.asarray(jkwta.kwta_global(jnp.asarray(y), keep_frac)))


@pytest.mark.parametrize("k", [1, 3, 5])
def test_kwta_softmax(k):
    x = _tied(k, (7, 5))
    got = kwta.kwta_softmax(torch.from_numpy(x), k).numpy()
    want = np.asarray(jkwta.kwta_softmax(jnp.asarray(x), k))
    np.testing.assert_array_equal(got > 0, want > 0)
    _close(got, want)


def test_kwta_needs_one_of_k_and_keep_frac():
    with pytest.raises(ValueError, match="exactly one"):
        kwta.kwta(torch.zeros(4), k=1, keep_frac=0.5)


# ---------------------------------------------------------------------------
# The fused scan and forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,t,h", [(8, 8, 24), (5, 3, 12), (16, 4, 32)])
def test_ops_miru_scan_matches_reference(b, t, h, with_h0):
    rng = np.random.default_rng(b * t + h)
    xw = rng.normal(0, 0.6, (b, t, h)).astype(np.float32)
    u = (rng.uniform(-1, 1, (h, h)) * np.sqrt(3.0 / h)).astype(np.float32)
    h0 = (rng.uniform(-0.5, 0.5, (b, h)) if with_h0
          else np.zeros((b, h))).astype(np.float32)
    got = ops.miru_scan(*(torch.from_numpy(a) for a in (xw, u, h0)),
                        beta=0.8, lam=0.5)
    # The Pallas kernel in interpret mode, through the reference's wrapper.
    want = jops.miru_scan(jnp.asarray(xw), jnp.asarray(u), jnp.asarray(h0),
                          beta=0.8, lam=0.5)
    for a, c in zip(got, want):
        _close(a.numpy(), c)


def test_miru_scan_ref_order_is_the_kernels():
    """k ascending, products and sums rounded to fp32, tanh in float64:
    the plain version equals a hand-written loop bit for bit."""
    rng = np.random.default_rng(3)
    xw, u, h0 = (torch.from_numpy(rng.normal(0, 0.5, s).astype(np.float32))
                 for s in ((3, 4, 6), (6, 6), (3, 6)))
    h_all, pre = ref.miru_scan_ref(xw, u, h0, 0.8, 0.5)
    h = h0.clone()
    for t in range(4):
        bh = 0.8 * h
        acc = torch.zeros(3, 6)
        for k in range(6):
            acc = acc + bh[:, k:k + 1] * u[k]
        p = xw[:, t] + acc
        assert torch.equal(pre[:, t], p)
        h = 0.5 * h + 0.5 * torch.tanh(p.double()).float()
        assert torch.equal(h_all[:, t], h)


@pytest.mark.parametrize("with_h0", [False, True])
def test_fused_forward_matches_reference_and_unfused(with_h0):
    jcfg, cfg, jp, p, _, _, x, _ = _setup()
    h0 = np.random.default_rng(9).uniform(-0.5, 0.5, (B, N_H)).astype(
        np.float32) if with_h0 else None
    th0 = None if h0 is None else torch.from_numpy(h0)
    logits, inter = miru.miru_forward(p, cfg, torch.from_numpy(x), th0,
                                      use_fused=True)
    jlogits, jinter = jmiru.miru_forward(
        jp, jcfg, jnp.asarray(x), None if h0 is None else jnp.asarray(h0),
        use_fused=True)
    _close(logits.numpy(), jlogits)
    for k in ("h_all", "h_prev", "pre"):
        _close(inter[k].numpy(), jinter[k])
    ulogits, uinter = miru.miru_forward(p, cfg, torch.from_numpy(x), th0)
    _close(logits.numpy(), ulogits.numpy())
    for k in ("h_all", "h_prev", "pre"):
        _close(inter[k].numpy(), uinter[k].numpy())


# ---------------------------------------------------------------------------
# DFA gradients and the write
# ---------------------------------------------------------------------------

def _masks(y_len, b=B):
    rng = np.random.default_rng(5)
    row_valid = np.ones(b, bool)
    row_valid[[1, 6]] = False
    lengths = rng.integers(1, y_len + 1, b).astype(np.int32)
    return row_valid, lengths


@pytest.mark.parametrize("case", ["plain", "row_valid", "lengths", "both",
                                  "no_time_norm"])
@pytest.mark.parametrize("use_fused", [False, True])
def test_dfa_grads_match_reference(use_fused, case):
    jcfg, cfg, jp, p, jpsi, psi, x, y = _setup()
    row_valid, lengths = _masks(T)
    kw, jkw = {}, {}
    if case in ("row_valid", "both"):
        kw["row_valid"] = torch.from_numpy(row_valid)
        jkw["row_valid"] = jnp.asarray(row_valid)
    if case in ("lengths", "both"):
        kw["lengths"] = torch.from_numpy(lengths)
        jkw["lengths"] = jnp.asarray(lengths)
    if case == "no_time_norm":
        kw["time_norm"] = jkw["time_norm"] = False
    loss, g = dfa.dfa_grads(p, psi, cfg, torch.from_numpy(x),
                            torch.from_numpy(y), use_fused=use_fused, **kw)
    jloss, jg = jdfa.dfa_grads(jp, jpsi, jcfg, jnp.asarray(x),
                               jnp.asarray(y), use_fused=use_fused, **jkw)
    _close(loss.numpy(), jloss)
    assert set(g) == set(jg)
    for k in g:
        _close(g[k].numpy(), jg[k])


def test_dfa_all_valid_masks_equal_no_masks():
    _, cfg, _, p, _, psi, x, y = _setup()
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    loss, g = dfa.dfa_grads(p, psi, cfg, xt, yt)
    loss2, g2 = dfa.dfa_grads(p, psi, cfg, xt, yt,
                              row_valid=torch.ones(B, dtype=torch.bool),
                              lengths=torch.full((B,), T, dtype=torch.int32))
    _close(loss.numpy(), loss2.numpy())
    for k in g:
        _close(g[k].numpy(), g2[k].numpy())


@pytest.mark.parametrize("keep_frac,hidden_lr_scale", [(0.57, 0.3),
                                                       (None, 1.0),
                                                       (0.2, 0.5)])
def test_sgd_kwta_update_matches_reference(keep_frac, hidden_lr_scale):
    jcfg, _, jp, p, jpsi, _, x, y = _setup()
    _, jg = jdfa.dfa_grads(jp, jpsi, jcfg, jnp.asarray(x), jnp.asarray(y))
    g = params_from_numpy({k: np.asarray(v) for k, v in jg.items()}, "cpu")
    new, masks = dfa.sgd_kwta_update(p, g, 0.2, keep_frac, hidden_lr_scale)
    jnew, jmasks = jdfa.sgd_kwta_update(jp, jg, 0.2, keep_frac,
                                        hidden_lr_scale)
    for k in new:
        np.testing.assert_array_equal(masks[k].numpy(), np.asarray(jmasks[k]))
        _close(new[k].numpy(), jnew[k])
    upd = dfa.scaled_sparse_updates(g, 0.2, keep_frac, hidden_lr_scale)
    jupd = jdfa.scaled_sparse_updates(jg, 0.2, keep_frac, hidden_lr_scale)
    for k in upd:
        np.testing.assert_array_equal(upd[k].numpy() != 0,
                                      np.asarray(jupd[k]) != 0)
        _close(upd[k].numpy(), jupd[k])


def test_bptt_and_alignment_match_reference():
    jcfg, cfg, jp, p, jpsi, psi, x, y = _setup()
    loss, g = dfa.bptt_grads(p, cfg, torch.from_numpy(x),
                             torch.from_numpy(y))
    jloss, jg = jdfa.bptt_grads(jp, jcfg, jnp.asarray(x), jnp.asarray(y))
    _close(loss.numpy(), jloss)
    for k in g:
        _close(g[k].numpy(), jg[k])
    _, gd = dfa.dfa_grads(p, psi, cfg, torch.from_numpy(x),
                          torch.from_numpy(y))
    _, jgd = jdfa.dfa_grads(jp, jpsi, jcfg, jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(dfa.grad_alignment(gd, g).numpy(),
                               np.asarray(jdfa.grad_alignment(jgd, jg)),
                               rtol=1e-4, atol=1e-6)
    _close(dfa.miru_loss(p, cfg, torch.from_numpy(x),
                         torch.from_numpy(y)).numpy(),
           jdfa.miru_loss(jp, jcfg, jnp.asarray(x), jnp.asarray(y)))


def test_bptt_through_the_fused_scan_raises_in_both_packages():
    """The fused float scan has no backward in either package: the
    reference's Pallas call fails under autodiff (AssertionError), the
    port refuses up front."""
    jcfg, cfg, jp, p, _, _, x, y = _setup()
    with pytest.raises(NotImplementedError, match="backward"):
        dfa.bptt_grads(p, cfg, torch.from_numpy(x), torch.from_numpy(y),
                       use_fused=True)
    with pytest.raises(AssertionError):
        jdfa.bptt_grads(jp, jcfg, jnp.asarray(x), jnp.asarray(y),
                        use_fused=True)


def test_fused_scan_refuses_grad():
    xw = torch.zeros(2, 3, 4, requires_grad=True)
    with pytest.raises(NotImplementedError, match="forward values only"):
        ops.miru_scan(xw, torch.zeros(4, 4), torch.zeros(2, 4), 0.8, 0.5)


def test_dfa_training_step_learns_with_the_fused_scan():
    """The reference's integration check (a DFA step through the fused
    scan lowers the loss) on the port, and its final fused forward
    against the reference's trained the same way."""
    jcfg, cfg, jp, p, jpsi, psi, x, y = _setup()
    losses = []
    jq = jp
    for _ in range(10):
        loss, g = dfa.dfa_grads(p, psi, cfg, torch.from_numpy(x),
                                torch.from_numpy(y), use_fused=True)
        p, _ = dfa.sgd_kwta_update(p, g, 0.2, 0.57, 0.3)
        losses.append(float(loss))
        _, jg = jdfa.dfa_grads(jq, jpsi, jcfg, jnp.asarray(x),
                               jnp.asarray(y), use_fused=True)
        jq, _ = jdfa.sgd_kwta_update(jq, jg, 0.2, 0.57, 0.3)
    assert losses[-1] < losses[0]
    lf, _ = miru.miru_forward(p, cfg, torch.from_numpy(x), use_fused=True)
    jlf, _ = jmiru.miru_forward(jq, jcfg, jnp.asarray(x), use_fused=True)
    np.testing.assert_allclose(lf.numpy(), np.asarray(jlf), rtol=1e-4,
                               atol=1e-4)
