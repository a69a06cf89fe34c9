"""The MiRU's BPTT + Adam baseline in the port against the reference.

The quantized substrates backpropagate through straight-through
estimators (``backends/wbs.py``): the forward is the quantized value, the
backward that of the linear product with the raw logical weights (or of
the identity, for the ADC). The fused WBS scan's backward is the
reference's reverse loop over T. Held here, on identical numpy-seeded
inputs, at fp32 tolerance (rtol 2e-5, atol 1e-6) unless stated:

* the two estimators, forward (exact) and backward (against ``jax.vjp``);
* the scan's backward on identical residuals and cotangents;
* a CE loss's gradients through ``miru_forward_device`` on ``wbs``, fused
  and per-step (rows whose forward flips an ADC or input code on a
  rounding tie, ``testing.compare_scan``, are left out of the loss on
  both sides);
* fused against per-step inside the port (the reference's own
  ``rtol 1e-4, atol 1e-6``), with nonzero hidden gradients;
* one Adam step from the reference's carried state, and whole Adam runs
  (R within 2 test examples and MA within 0.01 on ``ideal``; within
  ``chip_smoke.R_TOLERANCE["wbs"]``, 4 examples and 0.01, on ``wbs``);
* the legacy ``ContinualConfig`` shim.
"""
import dataclasses
import importlib
import warnings

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.backends import get_backend as jget_backend  # noqa: E402
from repro.backends import wbs as jwbs  # noqa: E402
from repro.core.miru import MiRUConfig as JMiRUConfig  # noqa: E402
from repro.data.synthetic import make_permuted_tasks as jtasks  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.optim.optimizers import AdamState as JAdamState  # noqa: E402
from repro.utils import softmax_cross_entropy as jce  # noqa: E402
from repro_torch import prng, testing  # noqa: E402
from repro_torch.backends import get_backend  # noqa: E402
from repro_torch.backends import wbs  # noqa: E402
from repro_torch.convert import (params_from_numpy,  # noqa: E402
                                 run_state_from_numpy)
from repro_torch.core import continual  # noqa: E402
from repro_torch.core.miru import MiRUConfig  # noqa: E402
from repro_torch.data.synthetic import make_permuted_tasks  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.optim.optimizers import AdamState  # noqa: E402

jcontinual = importlib.import_module("repro.core.continual")

TOL = dict(rtol=2e-5, atol=1e-6)
SIDE, N_H = 8, 32
# The Adam runs' test sets: chip_smoke.py's size, the scale its
# R_TOLERANCE (test examples an entry, MA) is set for.
RUN_TEST = 200


def _cfgs(n_x=SIDE, n_h=N_H, n_y=10):
    return MiRUConfig(n_x=n_x, n_h=n_h, n_y=n_y), \
        JMiRUConfig(n_x=n_x, n_h=n_h, n_y=n_y)


def _leaves(params):
    return {k: torch.from_numpy(np.array(v)).requires_grad_(True)
            for k, v in params.items()}


# ---------------------------------------------------------------------------
# The straight-through estimators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lead", [(6,), (3, 5)])
def test_ste_matmul_forward_and_vjp_match_the_reference(lead):
    rng = np.random.default_rng(len(lead))
    drive = rng.uniform(-1, 1, lead + (7,)).astype(np.float32)
    w = rng.normal(0, 0.4, (7, 4)).astype(np.float32)
    yq = rng.normal(size=lead + (4,)).astype(np.float32)
    g = rng.normal(size=lead + (4,)).astype(np.float32)
    d_t = torch.from_numpy(drive).requires_grad_(True)
    w_t = torch.from_numpy(w).requires_grad_(True)
    out = wbs.ste_matmul(torch.from_numpy(yq), d_t, w_t)
    assert torch.equal(out.detach(), torch.from_numpy(yq))
    gd, gw = torch.autograd.grad(out, (d_t, w_t), torch.from_numpy(g))
    jout, vjp = jax.vjp(jwbs._ste_matmul, jnp.asarray(yq), jnp.asarray(drive),
                        jnp.asarray(w))
    jgy, jgd, jgw = vjp(jnp.asarray(g))
    np.testing.assert_array_equal(np.asarray(jout), yq)
    assert not np.asarray(jgy).any()
    np.testing.assert_allclose(gd.numpy(), np.asarray(jgd), **TOL)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), **TOL)


def test_ste_identity_forward_and_vjp_match_the_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 9)).astype(np.float32)
    yq = np.round(x * 4) / 4
    g = rng.normal(size=(5, 9)).astype(np.float32)
    x_t = torch.from_numpy(x).requires_grad_(True)
    out = wbs.ste_identity(torch.from_numpy(yq), x_t)
    assert torch.equal(out.detach(), torch.from_numpy(yq))
    (gx,) = torch.autograd.grad(out, (x_t,), torch.from_numpy(g))
    _, vjp = jax.vjp(jwbs._ste_identity, jnp.asarray(yq), jnp.asarray(x))
    jgy, jgx = vjp(jnp.asarray(g))
    assert not np.asarray(jgy).any()
    np.testing.assert_array_equal(gx.numpy(), np.asarray(jgx))


def test_estimators_are_the_plain_value_without_autograd():
    y, d, w = torch.ones(2, 3), torch.ones(2, 4), torch.ones(4, 3)
    assert wbs.ste_matmul(y, d, w) is y
    assert wbs.ste_identity(y, d) is y
    with torch.no_grad():
        assert wbs.ste_matmul(y, d.requires_grad_(True), w) is y


def test_the_adc_has_a_gradient_through_the_backend():
    """Without the estimator ``adc_quantize``'s rounding would give zero:
    the backend's readout passes the gradient through."""
    be = get_backend("wbs")
    pre = torch.linspace(-5, 5, 41).requires_grad_(True)
    q = be.quantize_readout(pre)
    (g,) = torch.autograd.grad(q.sum(), (pre,))
    assert torch.equal(g, torch.ones_like(g))
    assert (q.detach() * 32 == torch.round(q.detach() * 32)).all()


# ---------------------------------------------------------------------------
# The fused scan's backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,T,H,with_gains", [(4, 7, 16, False),
                                              (3, 5, 32, True)])
def test_scan_backward_on_identical_residuals(B, T, H, with_gains):
    """The port's reverse loop against the reference's
    ``_wbs_miru_scan_bwd``, on the same residuals and cotangents."""
    rng = np.random.default_rng(B * T + H)
    u = rng.normal(0, 0.5, (H, H)).astype(np.float32)
    h_prev = rng.uniform(-1, 1, (B, T, H)).astype(np.float32)
    pre = rng.uniform(-4, 4, (B, T, H)).astype(np.float32)
    cts = [rng.normal(size=(B, T, H)).astype(np.float32) for _ in range(3)]
    gains = (rng.uniform(0.4, 0.6, (T, 8)).astype(np.float32)
             if with_gains else None)
    static = jops._FusedStatic(beta=0.8, lam=0.5, n_bits=8, adc_bits=8,
                               adc_range=4.0, weight_scale=1.5,
                               use_kernel=False)
    jd = jops._wbs_miru_scan_bwd(
        static, (jnp.asarray(u), jnp.asarray(h_prev), jnp.asarray(pre),
                 None if gains is None else jnp.asarray(gains)),
        tuple(jnp.asarray(c) for c in cts))
    before = ops.scan_backward_calls
    got = ops.wbs_miru_scan_bwd(
        torch.from_numpy(u), torch.from_numpy(h_prev), torch.from_numpy(pre),
        *(torch.from_numpy(c) for c in cts), beta=0.8, lam=0.5)
    assert ops.scan_backward_calls == before + 1
    for a, b in zip(got, jd[:4]):               # d_drive, d_u, d_h0, d_b
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert jd[4] is None or not np.asarray(jd[4]).any()


def test_scan_forward_under_autograd_is_the_no_grad_forward():
    rng = np.random.default_rng(0)
    drive = torch.from_numpy(rng.normal(0, 1, (3, 6, 16)).astype(np.float32))
    u = torch.from_numpy(rng.normal(0, 0.4, (16, 16)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.1, 16).astype(np.float32))
    kw = dict(beta=0.8, lam=0.5, n_bits=8, adc_bits=8, weight_scale=1.5)
    with torch.no_grad():
        want = ops.wbs_miru_scan(drive, u, b, **kw)
    got = ops.wbs_miru_scan(drive.requires_grad_(True),
                            u.requires_grad_(True), b, **kw)
    assert all(g.requires_grad for g in got)
    for g, w in zip(got, want):
        assert torch.equal(g.detach(), w)


def test_direct_products_still_refuse_grad():
    """``ops.wbs_matmul``/``wbs_dense`` with a grad-requiring weight raise,
    as the reference's Pallas product has no VJP."""
    w = torch.zeros(4, 3, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no_grad"):
        ops.wbs_dense(torch.zeros(2, 4), w, adc_bits=None)


# ---------------------------------------------------------------------------
# End-to-end gradients
# ---------------------------------------------------------------------------

def _e2e_setup(n_x=12, n_h=32, n_y=5, B=6, T=7, seed=1):
    cfg, jcfg = _cfgs(n_x, n_h, n_y)
    jp = jcontinual._init_run(jcfg, jcontinual.TrainerSpec(seed=seed),
                              jget_backend("ideal"))[1]
    jp = {k: np.asarray(v) for k, v in jp.items()}
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (B, T, n_x)).astype(np.float32)
    y = rng.integers(0, n_y, B).astype(np.int32)
    return cfg, jcfg, jp, x, y


def _port_grads(cfg, params, x, y, fused, backend="wbs", keep=None):
    leaves = _leaves(params)
    logits, aux = continual.miru_forward_device(
        leaves, cfg, torch.from_numpy(x), prng.PRNGKey(0),
        get_backend(backend), fused=fused)
    m = torch.ones(len(y)) if keep is None else torch.from_numpy(keep)
    logz = torch.logsumexp(logits, -1)
    ll = torch.gather(logits, -1, torch.from_numpy(y)[:, None].long())[:, 0]
    loss = torch.sum((logz - ll) * m) / len(y)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads)), aux


def _ref_grads(jcfg, params, x, y, fused, backend="wbs", keep=None):
    jb = jget_backend(backend)
    m = jnp.ones(len(y)) if keep is None else jnp.asarray(keep)

    def loss_fn(p):
        logits, aux = jcontinual.miru_forward_device(
            p, jcfg, jnp.asarray(x), jax.random.PRNGKey(0), jb, fused=fused)
        logz = jax.nn.logsumexp(logits, -1)
        ll = jnp.take_along_axis(logits, jnp.asarray(y)[:, None], -1)[:, 0]
        return jnp.sum((logz - ll) * m) / len(y), aux

    (loss, aux), g = jax.value_and_grad(loss_fn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()})
    return loss, g, aux


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("seed", [1, 2])
def test_end_to_end_gradients_match_the_reference(fused, seed):
    cfg, jcfg, jp, x, y = _e2e_setup(seed=seed)
    _, _, aux = _port_grads(cfg, jp, x, y, fused)
    _, _, jaux = _ref_grads(jcfg, jp, x, y, fused)
    # Rows whose forward flips a code on a rounding tie are left out.
    drive = ops.wbs_input_drive(torch.from_numpy(x),
                                torch.from_numpy(jp["w_h"].copy()), 8,
                                weight_scale=1.5)
    report = testing.compare_scan(
        [aux[k].detach() for k in ("h_all", "h_prev", "pre")],
        [np.asarray(jaux[k]) for k in ("h_all", "h_prev", "pre")],
        drive=drive, u_scaled=jp["u_h"] / np.float32(1.5), b_h=jp["b_h"],
        beta=cfg.beta, n_bits=8, w_scale=1.5, adc_bits=8).check(0.5)
    keep = np.ones(len(y), np.float32)
    keep[[b for b, _, _ in report.flips]] = 0.0
    loss, g, _ = _port_grads(cfg, jp, x, y, fused, keep=keep)
    jloss, jg, _ = _ref_grads(jcfg, jp, x, y, fused, keep=keep)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    for k in g:
        np.testing.assert_allclose(g[k].numpy(), np.asarray(jg[k]),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("backend", ["wbs", "analog"])
def test_fused_and_per_step_gradients_agree_in_the_port(backend):
    """The reference's ``test_fused_adam_gradients_close`` on the port:
    the same linearized graph summed in another order, so rtol 1e-4,
    atol 1e-6; every gradient nonzero (the reference exempts ``b_h``)."""
    cfg, _, jp, x, y = _e2e_setup(B=4, T=7)
    x = x * 2 - 1
    y = np.zeros_like(y)
    _, fused, _ = _port_grads(cfg, jp, x, y, True, backend)
    _, step, _ = _port_grads(cfg, jp, x, y, False, backend)
    for k in fused:
        assert float(fused[k].abs().max()) > 0 or k == "b_h", k
        np.testing.assert_allclose(fused[k].numpy(), step[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert float(fused["w_h"].abs().max()) > 0
    assert float(fused["u_h"].abs().max()) > 0


def test_analog_state_gradients_go_to_the_logical_weights():
    """``analog_state`` reads through its pairs; the outer estimator
    sends the gradient to the trainer's logical weights, as the
    reference's does."""
    cfg, jcfg, jp, x, y = _e2e_setup(n_h=16, B=4, T=5)
    be, jbe = get_backend("analog_state"), jget_backend("analog_state")
    key = np.asarray(jax.random.PRNGKey(5))
    jstate = jbe.init_device_state({k: jnp.asarray(v) for k, v in jp.items()},
                                   jax.random.PRNGKey(5))
    state = be.init_device_state(params_from_numpy(jp, "cpu"), key)
    leaves = _leaves(jp)
    logits, _ = continual.miru_forward_device(
        leaves, cfg, torch.from_numpy(x), prng.PRNGKey(0), be, state)
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y)
                                             .long())
    g = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    def jloss(p):
        lg, _ = jcontinual.miru_forward_device(
            p, jcfg, jnp.asarray(x), jax.random.PRNGKey(0), jbe, jstate)
        return jce(lg, jnp.asarray(y))

    jg = jax.grad(jloss)({k: jnp.asarray(v) for k, v in jp.items()})
    for k in g:
        np.testing.assert_allclose(g[k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------

def _adam_state_to_port(jstate):
    adam_state, rest = jstate
    return (AdamState(torch.from_numpy(np.array(adam_state.count)),
                      params_from_numpy({k: np.asarray(v) for k, v
                                         in adam_state.mu.items()}, "cpu"),
                      params_from_numpy({k: np.asarray(v) for k, v
                                         in adam_state.nu.items()}, "cpu")),
            rest)


@pytest.mark.parametrize("device", ["ideal", "wbs"])
def test_one_adam_step_from_the_reference_state(device):
    """Three reference steps, then the fourth on both sides from the
    reference's carried params and Adam state: loss, params, moments and
    count."""
    cfg, jcfg = _cfgs()
    tasks = jtasks(0, n_tasks=1, n_train=64, n_test=8, side=SIDE)
    tr = dict(algo="adam", batch_size=16, epochs_per_task=1)
    jtrainer = jcontinual.TrainerSpec(**tr)
    jb, be = jget_backend(device), get_backend(device)
    sched = jcontinual.build_batch_schedule(
        jtrainer, jcontinual.ReplaySpec(capacity=16), tasks)
    jstep, _, jopt = jcontinual._make_raw_steps(jcfg, jtrainer, jb)
    key, jp, _, _ = jcontinual._init_run(jcfg, jtrainer, jb)
    jstate = jopt.init(jp)
    for s in range(3):
        key, k = jax.random.split(key)
        jp, jstate, _, _, _ = jstep(jp, jstate, k, jnp.asarray(
            sched.x[0][s]), jnp.asarray(sched.y[0][s]), None)
    key, k = jax.random.split(key)
    x, y = sched.x[0][3], sched.y[0][3]
    p = params_from_numpy({k_: np.asarray(v) for k_, v in jp.items()}, "cpu")
    state = _adam_state_to_port(jstate)
    step, _, _ = continual._make_raw_steps(
        cfg, continual.TrainerSpec(**tr), be)
    with torch.no_grad():
        p2, state2, loss, _, _ = step(p, state, np.asarray(k),
                                      torch.from_numpy(x),
                                      torch.from_numpy(y), None)
    jp2, jstate2, jloss, _, _ = jstep(jp, jstate, k, jnp.asarray(x),
                                      jnp.asarray(y), None)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    for k_ in p2:
        np.testing.assert_allclose(p2[k_].numpy(), np.asarray(jp2[k_]),
                                   err_msg=k_, **TOL)
        np.testing.assert_allclose(state2[0].mu[k_].numpy(),
                                   np.asarray(jstate2[0].mu[k_]), **TOL)
        np.testing.assert_allclose(state2[0].nu[k_].numpy(),
                                   np.asarray(jstate2[0].nu[k_]),
                                   rtol=2e-5, atol=1e-9)
    assert int(state2[0].count) == int(jstate2[0].count) == 4
    assert isinstance(jstate2[0], JAdamState)


def _run_both(device, n_train=64, epochs=12):
    cfg, jcfg = _cfgs()
    kw = dict(n_tasks=2, n_train=n_train, n_test=RUN_TEST, side=SIDE)
    tasks, jt = make_permuted_tasks(0, **kw), jtasks(0, **kw)
    tr = dict(algo="adam", epochs_per_task=epochs, batch_size=16,
              adam_lr=1e-2)
    jtrainer = jcontinual.TrainerSpec(**tr)
    jb = jget_backend(device)
    key, p, psi, _ = jcontinual._init_run(jcfg, jtrainer, jb)
    want = jcontinual.run_continual(jcfg, jtrainer, jt,
                                    replay=jcontinual.ReplaySpec(capacity=64),
                                    device=jb)
    got = continual.run_continual(
        cfg, continual.TrainerSpec(**tr), tasks,
        replay=continual.ReplaySpec(capacity=64), device=device,
        torch_device="cpu",
        init=run_state_from_numpy(np.asarray(key),
                                  {k: np.asarray(v) for k, v in p.items()},
                                  np.asarray(psi), "cpu"))
    return got, want


@pytest.mark.parametrize("device,n_examples", [("ideal", 2), ("wbs", 4)])
def test_adam_run_matches_the_reference(device, n_examples):
    """``run_continual(algo="adam")`` from the reference's initial state
    (2 tasks × 64 examples, 12 epochs, lr 1e-2): R within ``n_examples``
    of 200 test examples an entry, MA within 0.01, the leading losses at
    1e-4. On ``wbs`` the 8-bit quantizers amplify last-bit differences
    and the runs drift apart after a few steps, as the DFA runs do."""
    got, want = _run_both(device)
    R, jR = got["R"], np.asarray(want["R"])
    assert np.abs(R - jR).max() <= n_examples / RUN_TEST + 1e-9, (R, jR)
    assert abs(got["MA"] - want["MA"]) <= 0.01 + 1e-9
    assert R[0, 0] > 0.3           # learns (chance is 0.1)
    assert len(got["losses"]) == len(want["losses"])
    np.testing.assert_allclose(got["losses"][:3], want["losses"][:3],
                               rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# The legacy ContinualConfig
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trainer", ["adam", "dfa", "dfa_hw"])
def test_continual_config_specs_match_the_reference(trainer):
    kw = dict(trainer=trainer, epochs_per_task=3, batch_size=8, seed=4,
              replay_capacity=16, replay_ratio=0.25, replay_bits=6)
    tr, rp, be = continual.ContinualConfig(**kw).specs()
    jtr, jrp, jbe = jcontinual.ContinualConfig(**kw).specs()
    assert dataclasses.asdict(tr) == dataclasses.asdict(jtr)
    assert dataclasses.asdict(rp) == dataclasses.asdict(jrp)
    assert be.name == jbe.name
    assert (continual.TRAINER_ALIASES[trainer]
            == jcontinual.TRAINER_ALIASES[trainer])
    for f in ("input_bits", "adc_bits", "adc_range", "gain_sigma",
              "weight_clip", "track_endurance"):
        assert getattr(be.spec, f) == getattr(jbe.spec, f), f
    assert (be.spec.crossbar is None) == (jbe.spec.crossbar is None)
    if be.spec.crossbar is not None:
        for f in ("write_sigma", "read_sigma", "w_clip"):
            assert getattr(be.spec.crossbar, f) == getattr(
                jbe.spec.crossbar, f)


@pytest.mark.parametrize("trainer", ["adam", "dfa", "dfa_hw"])
def test_continual_config_runs_with_a_deprecation_warning(trainer):
    cfg, _ = _cfgs()
    tasks = make_permuted_tasks(0, n_tasks=1, n_train=32, n_test=8,
                                side=SIDE)
    ccfg = continual.ContinualConfig(trainer=trainer, batch_size=16,
                                     replay_capacity=8)
    with pytest.warns(DeprecationWarning, match="ContinualConfig"):
        out = continual.run_continual(cfg, ccfg, tasks, torch_device="cpu")
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    with pytest.raises(ValueError, match="not both"):
        continual.run_continual(cfg, ccfg, tasks, device="wbs",
                                torch_device="cpu")
    with pytest.raises(ValueError, match="not both"):
        continual.run_continual(cfg, ccfg, tasks, torch_device="cpu",
                                replay=continual.ReplaySpec())
    with pytest.raises(ValueError, match="unknown trainer"):
        continual.ContinualConfig(trainer="sgd").specs()
    with pytest.raises(TypeError, match="TrainerSpec"):
        continual.run_continual(cfg, object(), tasks, torch_device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        continual.run_continual(cfg, continual.TrainerSpec(batch_size=16),
                                tasks, torch_device="cpu")
