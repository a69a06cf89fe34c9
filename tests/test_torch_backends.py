"""The torch port's device backends against the JAX reference.

``wbs`` and ``ideal`` ``device_recurrence`` (fused and per-step, with and
without an ``h0`` resume) on the same weights and inputs as
``repro.backends.get_backend(...)``; inside the port, fused and per-step
are bitwise equal on the CPU with the ADC on, and meter the same
counters.
"""
import numpy as np
import pytest
import torch

# The JAX reference; a GPU machine without JAX still collects the
# CUDA-marked tests (tests/test_torch_cuda.py).
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.backends import get_backend as jget_backend  # noqa: E402
from repro.core.miru import MiRUConfig as JMiRUConfig  # noqa: E402
from repro.core.miru import init_miru_params as jinit  # noqa: E402
from repro_torch import prng, testing  # noqa: E402
from repro_torch.backends import (DeviceSpec, WBSBackend, available_backends,
                                  get_backend, register_backend,
                                  unregister_backend)
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.miru import MiRUConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def _setup(n_x=6, n_h=12, seed=0):
    jcfg = JMiRUConfig(n_x=n_x, n_h=n_h, n_y=4)
    cfg = MiRUConfig(n_x=n_x, n_h=n_h, n_y=4)
    jp = jinit(jax.random.PRNGKey(seed), jcfg)
    jp["b_h"] = jp["b_h"] + 0.05
    p = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    return jcfg, cfg, jp, p


def _xs(b, t, n_x, n_h, seed, with_h0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (b, t, n_x)).astype(np.float32)
    h0 = rng.uniform(-0.5, 0.5, (b, n_h)).astype(np.float32) if with_h0 \
        else None
    return x, h0


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("fused", [True, False])
def test_wbs_recurrence_matches_reference(fused, with_h0):
    jcfg, cfg, jp, p = _setup()
    x, h0 = _xs(5, 9, 6, 12, 1, with_h0)
    got = get_backend("wbs").device_recurrence(p, cfg, _t(x), fused=fused,
                                               h0=_t(h0))
    want = jget_backend("wbs").device_recurrence(
        jp, jcfg, jnp.asarray(x), jax.random.PRNGKey(0), fused=fused,
        h0=_j(h0))
    drive = ops.wbs_input_drive(_t(x), p["w_h"], 8, weight_scale=1.5)
    testing.compare_scan(got, want, drive=drive, u_scaled=p["u_h"] / 1.5,
                         b_h=p["b_h"], beta=cfg.beta, n_bits=8, w_scale=1.5,
                         adc_bits=8).check()


@pytest.mark.parametrize("with_h0", [False, True])
def test_ideal_recurrence_matches_reference(with_h0):
    jcfg, cfg, jp, p = _setup()
    x, h0 = _xs(4, 7, 6, 12, 2, with_h0)
    got = get_backend("ideal").device_recurrence(p, cfg, _t(x), h0=_t(h0))
    want = jget_backend("ideal").device_recurrence(
        jp, jcfg, jnp.asarray(x), jax.random.PRNGKey(0), h0=_j(h0))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("b,t,n_x,n_h", [(1, 1, 3, 5), (5, 9, 6, 12),
                                         (9, 4, 28, 37), (3, 6, 7, 130)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_fused_equals_per_step_bitwise(b, t, n_x, n_h, with_h0):
    _, cfg, _, p = _setup(n_x, n_h, seed=b + t)
    x, h0 = _xs(b, t, n_x, n_h, 3, with_h0)
    backend = get_backend("wbs")
    fused = backend.device_recurrence(p, cfg, _t(x), fused=True, h0=_t(h0))
    step = backend.device_recurrence(p, cfg, _t(x), fused=False, h0=_t(h0))
    for a, c in zip(fused, step):
        assert torch.equal(a, c)


@pytest.mark.parametrize("adc_bits", [4, 6, 8])
def test_fused_equals_per_step_adc_widths(adc_bits):
    _, cfg, _, p = _setup()
    x, h0 = _xs(4, 6, 6, 12, adc_bits, True)
    backend = get_backend("wbs", spec_overrides=dict(adc_bits=adc_bits))
    fused = backend.device_recurrence(p, cfg, _t(x), fused=True, h0=_t(h0))
    step = backend.device_recurrence(p, cfg, _t(x), fused=False, h0=_t(h0))
    for a, c in zip(fused, step):
        assert torch.equal(a, c)


def test_fused_gate_needs_adc(monkeypatch):
    _, cfg, _, p = _setup()
    x, _ = _xs(2, 3, 6, 12, 0, False)

    def boom(*a, **k):
        raise AssertionError("fused scan used without an ADC")
    monkeypatch.setattr(ops, "wbs_miru_scan", boom)
    backend = get_backend("wbs", spec_overrides=dict(adc_bits=None))
    assert not backend._fused_recurrence_ok()
    backend.device_recurrence(p, cfg, _t(x))
    assert not WBSBackend().device_recurrence(
        p, cfg, _t(x), fused=False)[0].isnan().any()


def test_fused_and_per_step_meter_the_same_counters():
    _, cfg, _, p = _setup()
    B, T = 4, 7
    x, _ = _xs(B, T, 6, 12, 5, False)
    snaps = {}
    for fused in (True, False):
        backend = get_backend("wbs")
        backend.telemetry.enable()
        backend.device_recurrence(p, cfg, _t(x), fused=fused)
        snaps[fused] = backend.telemetry.snapshot()
    assert snaps[True] == snaps[False]
    assert snaps[True]["vmm_rows/w_h"] == B * T
    assert snaps[True]["macs/u_h"] == B * T * 12 * 12
    assert snaps[True]["bit_pulses/w_h"] == B * T * 6 * 8
    assert snaps[True]["adc_conversions/hidden"] == B * T * 12


def test_prepared_weights_are_the_per_call_ones():
    _, cfg, _, p = _setup()
    backend = get_backend("wbs")
    prep = backend.prepare_weights(p)
    assert set(prep) == {"w_h", "u_h", "w_o"}
    assert torch.equal(prep["u_h"], p["u_h"] / 1.5)
    drive = torch.rand(3, 12) * 2 - 1
    assert torch.equal(
        backend.device_vmm(drive, p["u_h"], tag="u_h", prepared=prep),
        backend.device_vmm(drive, p["u_h"], tag="u_h"))


def test_unported_substrate_options_raise():
    # The endurance tracker is ported now: the option attaches one.
    assert get_backend("wbs", spec_overrides=dict(
        track_endurance=True)).tracker is not None
    assert get_backend("wbs").tracker is None
    with pytest.raises(NotImplementedError, match="fault"):
        get_backend("ideal", spec=DeviceSpec(faults=object()))
    with pytest.raises(NotImplementedError, match="het"):
        get_backend("analog_state").init_device_state(
            {"w": torch.zeros(2, 2)}, prng.PRNGKey(0),
            het={"prog_sigma": 0.1})


def test_registry():
    assert {"ideal", "wbs"} <= set(available_backends())
    with pytest.raises(ValueError, match="unknown device backend"):
        get_backend("nope")
    wbs = get_backend("wbs")
    assert get_backend(wbs) is wbs
    with pytest.raises(ValueError):
        get_backend(wbs, spec=DeviceSpec())
    assert wbs.spec == DeviceSpec(input_bits=8, adc_bits=8, adc_range=4.0,
                                  weight_clip=1.5)
    assert get_backend("wbs", spec_overrides=dict(adc_bits=6)).spec.adc_bits \
        == 6

    @register_backend("_test_double")
    class Double(WBSBackend):
        name = "_test_double"
    try:
        assert isinstance(get_backend("_test_double"), Double)
    finally:
        unregister_backend("_test_double")
    assert "_test_double" not in available_backends()


@pytest.mark.parametrize("with_h0", [False, True])
def test_gain_noise_fused_equals_per_step_and_reference(with_h0):
    """``gain_sigma > 0``: the fused path replays the per-step key chain,
    so it equals the per-step path bit for bit, and both follow the
    reference's draws (fp32 tolerance: the gains' normal draw is within
    3 ulp of jax's)."""
    jcfg, cfg, jp, p = _setup()
    x, h0 = _xs(5, 6, 6, 12, 4, with_h0)
    spec = dict(gain_sigma=0.05)
    backend = get_backend("wbs", spec_overrides=spec)
    fused = backend.device_recurrence(p, cfg, _t(x), prng.PRNGKey(3),
                                      fused=True, h0=_t(h0))
    step = backend.device_recurrence(p, cfg, _t(x), prng.PRNGKey(3),
                                     fused=False, h0=_t(h0))
    for a, c in zip(fused, step):
        assert torch.equal(a, c)
    ideal = backend.device_recurrence(p, cfg, _t(x), fused=True, h0=_t(h0))
    assert not torch.equal(ideal[2], fused[2])
    want = jget_backend("wbs", spec_overrides=spec).device_recurrence(
        jp, jcfg, jnp.asarray(x), jax.random.PRNGKey(3), fused=True,
        h0=_j(h0))
    for g, w in zip(fused, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)
