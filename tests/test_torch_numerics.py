"""The torch port's numeric primitives against the JAX reference.

Inputs are made once with numpy and handed to both packages. Integer
quantities (sign-magnitude codes, bit planes, ADC codes, k-WTA masks)
must match exactly; float tensors at fp32 tolerance.
"""
import numpy as np
import pytest
import torch

# The JAX reference; a GPU machine without JAX still collects the
# CUDA-marked tests (tests/test_torch_cuda.py).
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.analog import adc as jadc  # noqa: E402
from repro.analog import wbs as jwbs  # noqa: E402
from repro.core.kwta import kwta_mask as jkwta_mask  # noqa: E402
from repro.core import miru as jmiru  # noqa: E402
from repro.obs.hist import Histogram as JHistogram  # noqa: E402
from repro.telemetry.meters import Telemetry as JTelemetry  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.analog import adc, wbs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import kwta, miru  # noqa: E402
from repro_torch.obs import Histogram  # noqa: E402
from repro_torch.telemetry import Telemetry  # noqa: E402
from repro_torch.utils import ceil_div, glorot_uniform, round_up  # noqa: E402

RTOL = ATOL = 2e-5


def _inputs(shape, seed, lo=-1.2, hi=1.2):
    """Uniform values plus the awkward ones: zeros of both signs, the
    range ends, and exact rounding ties of the 8-bit quantizer."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, size=shape).astype(np.float32)
    flat = x.reshape(-1)
    special = np.array([0.0, -0.0, 1.0, -1.0, 0.5 / 255, -2.5 / 255,
                        127.5 / 255, 1.5, -1.5], np.float32)
    flat[:special.size] = special
    return x


@pytest.mark.parametrize("n_bits", [1, 4, 8])
def test_quantize_signed_exact(n_bits):
    x = _inputs((33, 17), n_bits)
    s, c = wbs.quantize_signed(torch.from_numpy(x), n_bits)
    js, jc = jwbs.quantize_signed(jnp.asarray(x), n_bits)
    assert s.dtype == torch.int8 and c.dtype == torch.uint8
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


@pytest.mark.parametrize("n_bits", [3, 8])
def test_bit_planes_and_gains_exact(n_bits):
    code = np.random.default_rng(0).integers(0, 2 ** n_bits, (5, 9)).astype(
        np.uint8)
    np.testing.assert_array_equal(
        wbs.bit_planes(torch.from_numpy(code), n_bits).numpy(),
        np.asarray(jwbs.bit_planes(jnp.asarray(code), n_bits)))
    np.testing.assert_array_equal(wbs.ideal_gains(n_bits).numpy(),
                                  np.asarray(jwbs.ideal_gains(n_bits)))


@pytest.mark.parametrize("bits,full_scale", [(8, 4.0), (4, 1.0), (6, 3.0)])
def test_adc_quantize_exact(bits, full_scale):
    step = 2.0 * full_scale / 2 ** bits
    x = _inputs((40, 11), bits, -1.3 * full_scale, 1.3 * full_scale)
    # Exact half-step ties: round half to even on both sides.
    x.reshape(-1)[-8:] = (np.arange(-4, 4) + 0.5) * np.float32(step)
    got = adc.adc_quantize(torch.from_numpy(x), bits, full_scale).numpy()
    want = np.asarray(jadc.adc_quantize(jnp.asarray(x), bits, full_scale))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("adc_bits", [None, 8])
@pytest.mark.parametrize("shape", [(4, 28), (3, 5, 12)])
def test_wbs_vmm_matches_reference(shape, adc_bits):
    rng = np.random.default_rng(len(shape))
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    w = rng.normal(0, 0.3, (shape[-1], 9)).astype(np.float32)
    spec = wbs.WBSSpec(n_bits=8, adc_bits=adc_bits)
    got = wbs.wbs_vmm(torch.from_numpy(x), torch.from_numpy(w), spec)
    want = np.asarray(jwbs.wbs_vmm(jnp.asarray(x), jnp.asarray(w),
                                   jwbs.WBSSpec(n_bits=8, adc_bits=adc_bits)))
    sign, code = wbs.quantize_signed(torch.from_numpy(x), 8)
    testing.compare_matmul(
        got.reshape(-1, 9), want.reshape(-1, 9),
        sign=sign.reshape(-1, shape[-1]), code=code.reshape(-1, shape[-1]),
        w=w, gains=wbs.ideal_gains(8), adc_bits=adc_bits).check()


def test_wbs_vmm_gain_noise_not_ported():
    """Plane-gain noise used to raise until the threefry port; it now
    draws from the same key as the reference and agrees at rtol = atol =
    2e-5 (the gains' normal draw is within 3 ulp, not bit-exact)."""
    from repro_torch import prng
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (5, 11)).astype(np.float32)
    w = rng.normal(0, 0.3, (11, 9)).astype(np.float32)
    spec = dict(n_bits=8, adc_bits=None, gain_sigma=0.1)
    got = wbs.wbs_vmm(torch.from_numpy(x), torch.from_numpy(w),
                      wbs.WBSSpec(**spec), key=prng.PRNGKey(3)).numpy()
    want = np.asarray(jwbs.wbs_vmm(jnp.asarray(x), jnp.asarray(w),
                                   jwbs.WBSSpec(**spec),
                                   key=jax.random.PRNGKey(3)))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    ideal = wbs.wbs_vmm(torch.from_numpy(x), torch.from_numpy(w),
                        wbs.WBSSpec(**spec)).numpy()
    assert not np.allclose(got, ideal, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("by_magnitude", [True, False])
@pytest.mark.parametrize("k", [0, 1, 3, 7, 10])
def test_kwta_mask_exact_with_ties(k, by_magnitude):
    # Small integers force ties at the threshold: positional tie-break.
    x = np.random.default_rng(k).integers(-3, 4, (6, 10)).astype(np.float32)
    got = kwta.kwta_mask(torch.from_numpy(x), k, by_magnitude).numpy()
    want = np.asarray(jkwta_mask(jnp.asarray(x), k, by_magnitude))
    np.testing.assert_array_equal(got, want)


def test_kwta_mask_axis0():
    x = np.random.default_rng(1).normal(size=(7, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        kwta.kwta_mask(torch.from_numpy(x), 3, axis=0).numpy(),
        np.asarray(jkwta_mask(jnp.asarray(x), 3, axis=0)))


def _miru_setup(readout_k=None, seed=0):
    jcfg = jmiru.MiRUConfig(n_x=5, n_h=12, n_y=6, readout_k=readout_k)
    cfg = miru.MiRUConfig(n_x=5, n_h=12, n_y=6, readout_k=readout_k)
    jp = jmiru.init_miru_params(jax.random.PRNGKey(seed), jcfg)
    jp = {k: v + 0.05 if v.ndim == 1 else v for k, v in jp.items()}
    p = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    return jcfg, cfg, jp, p


@pytest.mark.parametrize("with_h0", [False, True])
def test_miru_forward_matches_reference(with_h0):
    jcfg, cfg, jp, p = _miru_setup()
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (4, 7, 5)).astype(np.float32)
    h0 = rng.uniform(-0.5, 0.5, (4, 12)).astype(np.float32) if with_h0 \
        else None
    logits, inter = miru.miru_forward(
        p, cfg, torch.from_numpy(x),
        None if h0 is None else torch.from_numpy(h0))
    jlogits, jinter = jmiru.miru_forward(
        jp, jcfg, jnp.asarray(x), None if h0 is None else jnp.asarray(h0))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=RTOL, atol=ATOL)
    for k in ("h_all", "h_prev", "pre"):
        np.testing.assert_allclose(inter[k].numpy(), np.asarray(jinter[k]),
                                   rtol=RTOL, atol=ATOL)


def test_miru_fused_not_ported():
    """``use_fused=True`` used to raise until the miru_scan kernel was
    ported; it now runs the fused scan (its plain version on the CPU) and
    matches the reference's fused forward at fp32 tolerance."""
    jcfg, cfg, jp, p = _miru_setup()
    x = np.random.default_rng(4).uniform(-1, 1, (2, 3, 5)).astype(np.float32)
    logits, inter = miru.miru_forward(p, cfg, torch.from_numpy(x),
                                      use_fused=True)
    jlogits, jinter = jmiru.miru_forward(jp, jcfg, jnp.asarray(x),
                                         use_fused=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=RTOL, atol=ATOL)
    for k in ("h_all", "h_prev", "pre"):
        np.testing.assert_allclose(inter[k].numpy(), np.asarray(jinter[k]),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("readout_k", [None, 3])
def test_readout_matches_reference(readout_k):
    jcfg, cfg, jp, p = _miru_setup(readout_k)
    h = np.random.default_rng(5).uniform(-1, 1, (9, 12)).astype(np.float32)
    got = miru.miru_apply_readout(p, cfg, torch.from_numpy(h)).numpy()
    want = np.asarray(jmiru.miru_apply_readout(jp, jcfg, jnp.asarray(h)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if readout_k is not None:
        np.testing.assert_array_equal(got == -30.0, want == -30.0)


def test_miru_config_validation():
    with pytest.raises(ValueError):
        miru.MiRUConfig(n_x=1, n_h=1, n_y=1, beta=0.0)
    with pytest.raises(ValueError):
        miru.MiRUConfig(n_x=1, n_h=1, n_y=1, lam=1.0)


def test_init_miru_params_seeded_and_bounded():
    cfg = miru.MiRUConfig(n_x=28, n_h=100, n_y=10)
    a = miru.init_miru_params(torch.Generator().manual_seed(0), cfg, "cpu")
    b = miru.init_miru_params(torch.Generator().manual_seed(0), cfg, "cpu")
    assert set(a) == {"w_h", "u_h", "b_h", "w_o", "b_o"}
    for k in a:
        assert torch.equal(a[k], b[k]) and a[k].dtype == torch.float32
    assert a["u_h"].abs().max() <= np.sqrt(6.0 / 200)
    assert not a["b_h"].any()
    g = glorot_uniform(torch.Generator().manual_seed(1), (3, 5))
    assert g.shape == (3, 5) and g.abs().max() <= np.sqrt(6.0 / 8)


def test_cuda_entry_point_refuses_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = miru.MiRUConfig(n_x=2, n_h=3, n_y=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        miru.init_miru_params(torch.Generator(), cfg)      # default: cuda
    with pytest.raises(RuntimeError):
        params_from_numpy({"w": np.zeros(2, np.float32)}, "cuda")


def test_round_up_ceil_div():
    assert [round_up(a, 8) for a in (1, 8, 9)] == [8, 8, 16]
    assert [ceil_div(a, 3) for a in (0, 1, 3, 4)] == [0, 1, 1, 2]


@pytest.mark.parametrize("max_samples", [4, 65536])
def test_histogram_matches_reference(max_samples):
    vals = np.random.default_rng(0).exponential(3.0, 50)
    a, b = Histogram(max_samples), JHistogram(max_samples)
    a.extend(vals)
    b.extend(vals)
    assert a.summary() == b.summary()
    assert len(a) == 50


def test_telemetry_counts_like_reference():
    drive, w = np.zeros((4, 7, 12), np.float32), np.zeros((12, 32))
    mine, ref = Telemetry().enable(), JTelemetry().enable()
    for t in (mine, ref):
        t.meter_vmm(drive, w, 8, "w_h")
        with t.scaled(7):
            t.meter_vmm(drive[:, 0], w, 8, "u_h")
            t.meter_adc(drive[:, 0], "hidden")
        t.record({"sequences": 1})
    assert mine.snapshot() == ref.snapshot()
    assert mine.total("macs") == ref.total("macs") == 2 * 4 * 7 * 12 * 32
    off = Telemetry()
    off.meter_vmm(drive, w, 8)
    assert off.snapshot() == {}
