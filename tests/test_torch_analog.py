"""The torch port's analog substrates against the JAX reference, on the
CPU: the crossbar, G⁺/G⁻ pair and drift functions, the endurance
tracker, the ``analog`` / ``analog_state`` / ``cmos`` backends, and the
read-noise variant of the WBS product (its plain version).

Noise comes from the same key in both packages: the port's
:mod:`repro_torch.prng` normal is within 3 ulp of ``jax.random.normal``,
so the comparisons are at fp32 tolerance (rtol 1e-5). The read noise is
the exception: the port draws it with Philox4x32-10, the reference with
threefry (CPU) or the TPU's PRNG, so there the two agree in distribution
only — exact at σ = 0, and in the moments of y_noisy − y_clean.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.analog import crossbar as jxb  # noqa: E402
from repro.analog import endurance as jend  # noqa: E402
from repro.backends import DeviceSpec as JDeviceSpec  # noqa: E402
from repro.backends import get_backend as jget_backend  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import prng, testing  # noqa: E402
from repro_torch.analog import crossbar as xb  # noqa: E402
from repro_torch.analog import endurance as end  # noqa: E402
from repro_torch.analog.wbs import ideal_gains, quantize_signed  # noqa: E402
from repro_torch.backends import DeviceSpec, get_backend  # noqa: E402
from repro_torch.convert import (device_state_from_numpy,  # noqa: E402
                                 params_from_numpy)
from repro_torch.kernels import ops, ref  # noqa: E402

RTOL = 1e-5
SPEC = dict(write_sigma=0.1, read_sigma=0.1, w_clip=1.5, prog_sigma=0.1)


def _w(shape, seed, scale=0.8):
    return np.random.default_rng(seed).uniform(
        -scale, scale, shape).astype(np.float32)


def _both(spec_kw):
    return xb.CrossbarSpec(**spec_kw), jxb.CrossbarSpec(**spec_kw)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=atol)


# ---------------------------------------------------------------------------
# Crossbar, pairs, drift
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("levels", [None, 33])
def test_program_update_vmm_match_reference(levels):
    spec, jspec = _both(dict(SPEC, write_levels=levels))
    w, dw = _w((6, 5), 0), _w((6, 5), 1, 0.1)
    dw[::2] = 0.0
    key = prng.PRNGKey(4)
    st = xb.program(key, torch.from_numpy(w), spec)
    jst = jxb.program(jnp.asarray(key), jnp.asarray(w), jspec)
    _close(st.g, jst.g, 1e-13)
    _close(st.to_weights(), jst.to_weights(), 1e-6)
    up = xb.update(prng.PRNGKey(5), st, torch.from_numpy(dw))
    jup = jxb.update(jnp.asarray(prng.PRNGKey(5)), jst, jnp.asarray(dw))
    _close(up.g, jup.g, 1e-13)
    x = _w((3, 6), 2, 1.0)
    for k in (None, prng.PRNGKey(6)):
        _close(xb.vmm(k, torch.from_numpy(x), up),
               jxb.vmm(None if k is None else jnp.asarray(k),
                       jnp.asarray(x), jup), 1e-5)


@pytest.mark.parametrize("levels", [None, 65])
@pytest.mark.parametrize("with_key", [False, True])
def test_pair_functions_match_reference(levels, with_key):
    spec, jspec = _both(dict(SPEC, write_levels=levels, drift_rate=0.02))
    w, dw = _w((7, 9), 3, 1.8), _w((7, 9), 4, 0.2)
    dw[:, ::3] = 0.0
    key = prng.PRNGKey(8) if with_key else None
    pair = xb.program_pair(key, torch.from_numpy(w), spec)
    jpair = jxb.program_pair(None if key is None else jnp.asarray(key),
                             jnp.asarray(w), jspec)
    for k in ("g_pos", "g_neg"):
        _close(pair[k], jpair[k], 1e-13)
    _close(xb.pair_weights(pair, spec), jxb.pair_weights(jpair, jspec),
           1e-6)
    for n in (1, 5):
        d, jd = xb.drift_pair(pair, spec, n), jxb.drift_pair(jpair, jspec, n)
        for k in ("g_pos", "g_neg"):
            _close(d[k], jd[k], 1e-13)
    up = xb.update_pair(prng.PRNGKey(9), pair, torch.from_numpy(dw), spec)
    jup = jxb.update_pair(jnp.asarray(prng.PRNGKey(9)), jpair,
                          jnp.asarray(dw), jspec)
    for k in ("g_pos", "g_neg"):
        _close(up[k], jup[k], 1e-13)


def test_pair_program_roundtrip_is_exact_enough_and_bounded():
    spec = xb.CrossbarSpec(write_sigma=0.0, prog_sigma=0.0, w_clip=1.5)
    w = torch.tensor([[0.7, -1.2, 0.0]])
    pair = xb.program_pair(None, w, spec)
    np.testing.assert_allclose(xb.pair_weights(pair, spec).numpy(),
                               w.numpy(), rtol=1e-6, atol=1e-9)
    # Saturation at the rail: repeated one-sided potentiation pins G_on.
    spec = xb.CrossbarSpec(write_sigma=0.0, prog_sigma=0.0, w_clip=1.0)
    pair = xb.program_pair(None, torch.tensor([0.95]), spec)
    for i in range(10):
        pair = xb.update_pair(prng.PRNGKey(i), pair, torch.tensor([0.5]),
                              spec)
    assert float(xb.pair_weights(pair, spec)[0]) == pytest.approx(
        1.0, abs=1e-6)
    with pytest.raises(NotImplementedError, match="fleet"):
        xb.drift_pair(pair, spec, drift_rate=0.1)


def test_crossbar_scalars_are_the_reference_float32_constants():
    """The f32 folding of each Python-float constant: the mirror of a
    logical weight reads back to the reference's bits."""
    spec, jspec = _both(dict(SPEC, prog_sigma=0.0))
    w = _w((64, 50), 11, 1.5)
    got = xb.pair_weights(xb.program_pair(None, torch.from_numpy(w), spec),
                          spec)
    want = jxb.pair_weights(jxb.program_pair(None, jnp.asarray(w), jspec),
                            jspec)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Endurance tracker
# ---------------------------------------------------------------------------

def test_endurance_tracker_matches_reference():
    rng = np.random.default_rng(0)
    masks = [{"a": rng.random((4, 5)) < 0.5, "b": rng.random((3,)) < 0.3}
             for _ in range(7)]
    tr, jtr = end.EnduranceTracker(), jend.EnduranceTracker()
    for m in masks:
        tr.record_update({k: torch.from_numpy(v) for k, v in m.items()})
        jtr.record_update(m)
    np.testing.assert_array_equal(tr.all_counts(), jtr.all_counts())
    assert tr.mean_writes() == jtr.mean_writes()
    for a, b in zip(tr.write_cdf(16), jtr.write_cdf(16)):
        np.testing.assert_array_equal(a, b)
    assert tr.overstressed_fraction(3e9) == jtr.overstressed_fraction(3e9)
    # Accumulated maps: the same totals as per-update records.
    tr2 = end.EnduranceTracker()
    tr2.record_counts({k: sum(torch.from_numpy(m[k]).long() for m in masks)
                       for k in ("a", "b")}, len(masks))
    np.testing.assert_array_equal(tr2.all_counts(), tr.all_counts())
    assert tr2.updates_applied == tr.updates_applied
    back = end.EnduranceTracker.from_state_dict(tr.state_dict())
    np.testing.assert_array_equal(back.all_counts(), tr.all_counts())
    assert back.updates_applied == 7
    for rate in (0.0, 0.57, 1.0):
        assert end.lifespan_years(rate) == jend.lifespan_years(rate)
    assert end.paper_lifespan_check() == jend.paper_lifespan_check()


# ---------------------------------------------------------------------------
# The read-noise variant's plain version
# ---------------------------------------------------------------------------

def test_philox_known_answers_and_int64_products():
    """Random123's known-answer vectors for Philox4x32-10, and the split
    16-bit product against numpy's uint64 one."""
    kat = [((0, 0, 0, 0), (0, 0),
            (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
           ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
            (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
           ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
            (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in kat:
        got = ref.philox4x32_10(
            tuple(torch.tensor([c], dtype=torch.int64) for c in ctr), key)
        assert tuple(int(g) for g in got) == want
    b = np.random.default_rng(0).integers(0, 2 ** 32, 1000, dtype=np.uint64)
    hi, lo = ref._mulhilo(0xD2511F53, torch.from_numpy(b.astype(np.int64)))
    p = np.uint64(0xD2511F53) * b
    np.testing.assert_array_equal(hi.numpy(), (p >> np.uint64(32)))
    np.testing.assert_array_equal(lo.numpy(), p & np.uint64(0xFFFFFFFF))


def _matmul_case(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (m, k)).astype(np.float32)
    w = rng.normal(0, 0.3, (k, n)).astype(np.float32)
    sign, code = quantize_signed(torch.from_numpy(x), 8)
    return x, w, sign, code


@pytest.mark.parametrize("adc_bits", [8, None])
def test_read_noise_at_zero_sigma_is_the_reference_product(adc_bits):
    x, w, sign, code = _matmul_case(32, 28, 100, 0)
    g = ideal_gains(8)
    got = ops.wbs_matmul(sign, code, torch.from_numpy(w), g, adc_bits,
                         read_sigma=0.0, read_key=prng.PRNGKey(1))
    jsign, jcode = jops.quantize_inputs(jnp.asarray(x), 8)
    want = jops.wbs_matmul(jsign, jcode, jnp.asarray(w), jnp.asarray(
        g.numpy()), adc_bits, read_sigma=0.0)
    testing.compare_matmul(got, want, sign=sign, code=code,
                           w=torch.from_numpy(w), gains=g, adc_bits=adc_bits,
                           adc_range=4.0).check()
    assert torch.equal(got, ref.wbs_matmul_ref(sign, code,
                                               torch.from_numpy(w), g,
                                               adc_bits))


def test_read_noise_moments_match_the_reference_and_the_analysis():
    """Over 256 keys, y_noisy − y_clean (no ADC) has mean 0 and variance
    σ²·Σ_k (x_k·w_kn)² per output, x the quantized drive; the port's
    Philox draws and the reference's threefry draws (its CPU path, one
    normal per weight element per call) both meet it. Bounds: the mean
    of r = d/σ_analytic within 5/√256 (5 sd even were all outputs of a
    key fully correlated), the mean of r² within 0.1 of 1 (over 25,600
    independent column draws its sd is 0.009)."""
    m, k, n, sigma, n_keys = 16, 28, 100, 0.1, 256
    x, w, sign, code = _matmul_case(m, k, n, 3)
    g = ideal_gains(8)
    wt = torch.from_numpy(w)
    clean = ops.wbs_matmul(sign, code, wt, g, None).numpy()
    xq = (sign.double() * code.double() / 255.0).numpy()
    var = sigma ** 2 * (xq ** 2) @ (w.astype(np.float64) ** 2)
    ok = var > 0
    keys = prng.split(prng.PRNGKey(7), n_keys)
    port = np.stack([ops.wbs_matmul(sign, code, wt, g, None,
                                    read_sigma=sigma, read_key=kk).numpy()
                     for kk in keys]) - clean
    jsign, jcode = jops.quantize_inputs(jnp.asarray(x), 8)
    jclean = np.asarray(jops.wbs_matmul(jsign, jcode, jnp.asarray(w),
                                        jnp.asarray(g.numpy())))
    jrun = jax.jit(jax.vmap(lambda kk: jops.wbs_matmul(
        jsign, jcode, jnp.asarray(w), jnp.asarray(g.numpy()),
        read_sigma=sigma, read_key=kk)))
    jref = np.asarray(jrun(jnp.asarray(keys))) - jclean
    stats = {}
    for name, d in (("port", port), ("reference", jref)):
        r = d[:, ok] / np.sqrt(var[ok])
        stats[name] = (float(r.mean()), float((r ** 2).mean()))
        assert abs(stats[name][0]) < 5 / np.sqrt(n_keys), (name, stats)
        assert abs(stats[name][1] - 1.0) < 0.1, (name, stats)
    assert abs(stats["port"][1] - stats["reference"][1]) < 0.1, stats


def test_read_noise_is_one_draw_per_weight_per_call():
    """Identical rows of one call give identical outputs, even 128 or
    more rows apart (the TPU draws per 128-row block: a by-design
    difference, ROADMAP queue C); the draw is a function of the key."""
    _, w, sign, code = _matmul_case(300, 28, 40, 5)
    sign[200], code[200] = sign[3], code[3]
    g, wt = ideal_gains(8), torch.from_numpy(w)
    key = prng.PRNGKey(2)
    y = ops.wbs_matmul(sign, code, wt, g, None, read_sigma=0.1, read_key=key)
    assert torch.equal(y[3], y[200])
    assert torch.equal(y, ops.wbs_matmul(sign, code, wt, g, None,
                                         read_sigma=0.1, read_key=key))
    assert not torch.equal(y, ops.wbs_matmul(sign, code, wt, g, None,
                                             read_sigma=0.1,
                                             read_key=prng.PRNGKey(3)))
    z = ref.read_noise(ops.read_key_words(key), (28, 40))
    assert torch.equal(y[3], ref.wbs_matmul_ref(
        sign[3:4], code[3:4], wt * (1.0 + 0.1 * z), g)[0])


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------

def _params(seed=0, n_x=6, n_h=12, n_y=4):
    rng = np.random.default_rng(seed)
    return {"w_h": rng.uniform(-0.6, 0.6, (n_x, n_h)).astype(np.float32),
            "u_h": rng.uniform(-0.4, 0.4, (n_h, n_h)).astype(np.float32),
            "b_h": rng.normal(0, 0.1, n_h).astype(np.float32),
            "w_o": rng.uniform(-0.6, 0.6, (n_h, n_y)).astype(np.float32),
            "b_o": rng.normal(0, 0.1, n_y).astype(np.float32)}


def _updates(params, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in params.items():
        u = rng.normal(0, 0.05, v.shape).astype(np.float32)
        u[rng.random(v.shape) < 0.4] = 0.0
        out[k] = u
    return out


@pytest.mark.parametrize("levels", [None, 255])
def test_analog_apply_update_matches_reference(levels):
    from repro.analog.crossbar import CrossbarSpec as JCB
    cb = dict(write_sigma=0.1, read_sigma=0.0, w_clip=1.5,
              write_levels=levels)
    spec = dict(input_bits=8, adc_bits=8, gain_sigma=0.02, weight_clip=1.5)
    be = get_backend("analog", spec=DeviceSpec(crossbar=xb.CrossbarSpec(**cb),
                                               **spec))
    jbe = jget_backend("analog", spec=JDeviceSpec(crossbar=JCB(**cb), **spec))
    p, u = _params(), _updates(_params(), 1)
    new, applied = be.apply_update(params_from_numpy(p, "cpu"),
                                   params_from_numpy(u, "cpu"),
                                   prng.PRNGKey(3))
    jnew, japplied = jbe.apply_update({k: jnp.asarray(v) for k, v in
                                       p.items()},
                                      {k: jnp.asarray(v) for k, v in
                                       u.items()},
                                      jnp.asarray(prng.PRNGKey(3)))
    for k in p:
        _close(new[k], jnew[k], 1e-6)
        assert torch.equal(applied[k] != 0, torch.from_numpy(
            np.asarray(japplied[k]) != 0))


def test_analog_vmm_read_noise_splits_the_key_as_the_reference():
    """With read noise the key splits into (read, gain): the plane gains
    are the reference's (so at σ_read → 0⁺ the product is the
    reference's), and the read noise moves it."""
    cb = dict(write_sigma=0.1, w_clip=1.5)
    from repro.analog.crossbar import CrossbarSpec as JCB
    kw = dict(input_bits=8, adc_bits=8, gain_sigma=0.05, weight_clip=1.5)
    be = get_backend("analog", spec=DeviceSpec(
        crossbar=xb.CrossbarSpec(read_sigma=1e-30, **cb), **kw))
    jbe = jget_backend("analog", spec=JDeviceSpec(
        crossbar=JCB(read_sigma=1e-30, **cb), **kw))
    p = _params()
    x = _w((5, 6), 4, 1.0)
    key = prng.PRNGKey(12)
    got = be.vmm(torch.from_numpy(x), torch.from_numpy(p["w_h"]), key)
    want = jbe.vmm(jnp.asarray(x), jnp.asarray(p["w_h"]), jnp.asarray(key))
    _close(got, want, 1e-5)
    loud = get_backend("analog", spec=DeviceSpec(
        crossbar=xb.CrossbarSpec(read_sigma=0.1, **cb), **kw))
    assert not torch.equal(got, loud.vmm(torch.from_numpy(x),
                                         torch.from_numpy(p["w_h"]), key))
    assert be.draws_noise and not be._fused_recurrence_ok()
    assert get_backend("analog")._fused_recurrence_ok()


def test_cmos_backend_is_exact_fixed_point_on_the_per_step_path():
    be = get_backend("cmos")
    assert be.spec.adc_bits is None and not be._fused_recurrence_ok()
    x = torch.from_numpy(_w((4, 8), 0, 1.0))
    w = torch.from_numpy(_w((8, 3), 1, 0.3))
    y = be.vmm(x, w)
    assert float((y - x @ w).abs().max()) < 0.05       # 8-bit quant only
    assert torch.equal(be.vmm(x, w), y)


@pytest.mark.parametrize("cadence", [1, 3])
def test_analog_state_device_updates_match_reference(cadence):
    """Programming, then three writes with retention drift at a cadence:
    the pairs, the read-back weights and the applied deltas against the
    reference's, from the same keys; ``_ticks`` counts as it does."""
    from repro.analog.crossbar import CrossbarSpec as JCB
    cb = dict(write_sigma=0.1, read_sigma=0.0, w_clip=1.5, prog_sigma=0.1,
              drift_rate=0.01, drift_cadence=cadence)
    kw = dict(input_bits=8, adc_bits=8, gain_sigma=0.02, weight_clip=1.5)
    be = get_backend("analog_state",
                     spec=DeviceSpec(crossbar=xb.CrossbarSpec(**cb), **kw))
    jbe = jget_backend("analog_state",
                       spec=JDeviceSpec(crossbar=JCB(**cb), **kw))
    p = _params()
    tp, jp = params_from_numpy(p, "cpu"), {k: jnp.asarray(v)
                                           for k, v in p.items()}
    st = be.init_device_state(tp, prng.PRNGKey(1))
    jst = jbe.init_device_state(jp, jax.random.PRNGKey(1))
    assert set(st) == set(jst)
    be.telemetry.enable()
    for i in range(3):
        u = _updates(p, 10 + i)
        tp, applied, st = be.device_apply_update(
            tp, params_from_numpy(u, "cpu"), prng.PRNGKey(20 + i), state=st)
        jp, japplied, jst = jbe.device_apply_update(
            jp, {k: jnp.asarray(v) for k, v in u.items()},
            jnp.asarray(prng.PRNGKey(20 + i)), state=jst)
        for k in p:
            _close(tp[k], jp[k], 1e-6)
            _close(applied[k], japplied[k], 1e-6)
        for name in ("w_h", "u_h", "w_o"):
            for g in ("g_pos", "g_neg"):
                _close(st[name][g], jst[name][g], 1e-13)
        if cadence > 1:
            assert int(st["_ticks"]) == int(jst["_ticks"])
    assert be.telemetry.snapshot() == {"drift_ticks": 3}


def test_analog_state_drift_relaxes_weights_toward_zero():
    spec = xb.CrossbarSpec(write_sigma=0.0, prog_sigma=0.0, drift_rate=0.1,
                           w_clip=1.0)
    be = get_backend("analog_state",
                     spec=DeviceSpec(input_bits=8, adc_bits=8,
                                     weight_clip=1.0, crossbar=spec))
    params = {"w_h": torch.tensor([[0.8, -0.8]])}
    state = be.init_device_state(params, prng.PRNGKey(0))
    zeros = {"w_h": torch.zeros_like(params["w_h"])}
    p, applied, _ = be.device_apply_update(params, zeros, prng.PRNGKey(1),
                                           state=state)
    np.testing.assert_allclose(p["w_h"].numpy(),
                               params["w_h"].numpy() * 0.9, rtol=1e-5)
    assert not applied["w_h"].any()


def test_analog_state_reads_through_the_pairs_like_the_reference():
    """A per-step recurrence read through programmed pairs (programming
    noise, plane-gain noise, read noise on each device) against the
    reference, from one carried-across device state (fp32 tolerance,
    ADC ties handled by repro_torch.testing)."""
    from repro.analog.crossbar import CrossbarSpec as JCB
    from repro.core.miru import MiRUConfig as JCfg
    from repro_torch.core.miru import MiRUConfig
    for read_sigma in (0.0, 0.05):
        cb = dict(write_sigma=0.1, read_sigma=read_sigma, w_clip=1.5,
                  prog_sigma=0.1)
        kw = dict(input_bits=8, adc_bits=8, gain_sigma=0.02,
                  weight_clip=1.5)
        be = get_backend("analog_state",
                         spec=DeviceSpec(crossbar=xb.CrossbarSpec(**cb), **kw))
        jbe = jget_backend("analog_state",
                           spec=JDeviceSpec(crossbar=JCB(**cb), **kw))
        p = _params(2)
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        jst = jbe.init_device_state(jp, jax.random.PRNGKey(4))
        st = device_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, jst), "cpu")
        x = np.random.default_rng(1).uniform(-1, 1, (5, 4, 6)).astype(
            np.float32)
        key = prng.PRNGKey(5)
        got = be.device_recurrence(params_from_numpy(p, "cpu"),
                                   MiRUConfig(n_x=6, n_h=12, n_y=4),
                                   torch.from_numpy(x), key, state=st)
        want = jbe.device_recurrence(jp, JCfg(n_x=6, n_h=12, n_y=4),
                                     jnp.asarray(x), jnp.asarray(key),
                                     state=jst)
        _rows_agree(got, want)


def _rows_agree(got, want, max_rows_off=1):
    """(h_all, h_prev, pre) of two per-step recurrences agree at 2e-5,
    but for at most ``max_rows_off`` batch rows where an ADC code flipped
    on a last-bit difference: there every ``pre`` is within one ADC
    level (1/32 at 8 bits, ±4)."""
    g = [a.numpy() for a in got]
    w = [np.asarray(a) for a in want]
    off = np.zeros(g[0].shape[0], bool)
    for a, b in zip(g, w):
        off |= ~np.isclose(a, b, rtol=2e-5, atol=2e-5).all((1, 2))
    assert off.sum() <= max_rows_off, off
    assert np.abs(g[2] - w[2]).max() <= 1 / 32 + 1e-5
