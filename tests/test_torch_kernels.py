"""The torch port's WBS kernels' plain versions and wrappers against the
JAX reference.

The JAX side runs as its own tests run it on the CPU: the jnp oracles in
``repro.kernels.ref`` and the Pallas kernels in interpret mode. The CUDA
kernels themselves run only on a card (tests/test_torch_cuda.py); here
``kernels/ops.py`` dispatches CPU tensors to the plain versions, and the
wrappers' own checks are exercised directly.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

# The JAX reference; a GPU machine without JAX still collects the
# CUDA-marked tests (tests/test_torch_cuda.py).
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.wbs_matmul import wbs_matmul_pallas  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.analog.wbs import ideal_gains, quantize_signed  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import wbs_matmul as kmatmul  # noqa: E402
from repro_torch.kernels import wbs_miru_scan as kscan  # noqa: E402
from repro_torch.kernels import miru_readout as kreadout  # noqa: E402
from repro_torch.kernels import miru_scan as kmiru  # noqa: E402
from repro_torch.utils import round_up  # noqa: E402
from repro.kernels.miru_scan import miru_scan_pallas  # noqa: E402

SCAN_KW = dict(beta=0.8, lam=0.5, n_bits=8, adc_range=4.0)


def _matmul_inputs(M, K, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (M, K)).astype(np.float32)
    w = rng.normal(0, 0.3, (K, N)).astype(np.float32)
    sign, code = quantize_signed(torch.from_numpy(x), 8)
    return sign, code, torch.from_numpy(w)


@pytest.mark.parametrize("adc_bits", [8, None])
@pytest.mark.parametrize("m,k,n", [(8, 28, 100), (5, 37, 13),
                                   (16, 130, 40)])
def test_wbs_matmul_ref_vs_reference_and_pallas(m, k, n, adc_bits):
    sign, code, w = _matmul_inputs(m, k, n, m * k + n)
    gains = ideal_gains(8)
    got = ref.wbs_matmul_ref(sign, code, w, gains, adc_bits)
    js, jc, jw = (jnp.asarray(t.numpy()) for t in (sign, code, w))
    jg = jnp.asarray(gains.numpy())
    want_ref = jref.wbs_matmul_ref(js, jc, jw, jg, adc_bits)
    # The Pallas kernel in interpret mode, through the padding wrapper.
    want_pallas = jops.wbs_matmul(js, jc, jw, jg, adc_bits)
    for want in (want_ref, want_pallas):
        testing.compare_matmul(got, want, sign=sign, code=code, w=w,
                               gains=gains, adc_bits=adc_bits).check()


def test_wbs_matmul_ref_per_plane_gains():
    sign, code, w = _matmul_inputs(6, 20, 9, 1)
    gains = ideal_gains(8) * torch.from_numpy(
        1 + 0.05 * np.random.default_rng(2).normal(size=8).astype(np.float32))
    got = ref.wbs_matmul_ref(sign, code, w, gains)
    want = jref.wbs_matmul_ref(*(jnp.asarray(t.numpy())
                                 for t in (sign, code, w, gains)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_plane_product_order_is_the_kernels():
    """K tiles of 128, planes MSB first, k ascending, fp32: a K = 130
    product equals the hand-written loop bit for bit."""
    sign, code, w = _matmul_inputs(3, 130, 4, 7)
    g = ideal_gains(8)
    acc = torch.zeros(3, 4)
    for k0 in (0, 128):
        for b in range(8):
            dot = torch.zeros(3, 4)
            for k in range(k0, min(k0 + 128, 130)):
                p = ((code[:, k].int() >> (7 - b)) & 1).float() \
                    * sign[:, k].float()
                dot = dot + p[:, None] * w[k]
            acc = acc + g[b] * dot
    assert torch.equal(ref.plane_product(sign, code, w, g), acc)


def _scan_inputs(b, t, h, seed, with_h0):
    rng = np.random.default_rng(seed)
    drive = rng.normal(0, 1, (b, t, h)).astype(np.float32)
    u = (rng.normal(0, 1, (h, h)) * 0.3).astype(np.float32)
    b_h = (rng.normal(0, 1, (h,)) * 0.1).astype(np.float32)
    h0 = rng.uniform(-0.5, 0.5, (b, h)).astype(np.float32) if with_h0 \
        else None
    return drive, u, b_h, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("adc_bits", [8, None])
@pytest.mark.parametrize("b,t,h", [(1, 1, 8), (3, 5, 37), (8, 9, 128),
                                   (5, 4, 130)])
def test_wbs_miru_scan_vs_reference_and_pallas(b, t, h, adc_bits, with_h0):
    drive, u, b_h, h0 = _scan_inputs(b, t, h, b * 100 + t + h, with_h0)
    kw = dict(SCAN_KW, adc_bits=adc_bits, weight_scale=1.5)
    got = ops.wbs_miru_scan(torch.from_numpy(drive), torch.from_numpy(u),
                            torch.from_numpy(b_h),
                            None if h0 is None else torch.from_numpy(h0),
                            **kw)
    jh0 = None if h0 is None else jnp.asarray(h0)
    # jnp oracle, and the Pallas kernel in interpret mode.
    for use_kernel in (False, True):
        want = jops.wbs_miru_scan(jnp.asarray(drive), jnp.asarray(u),
                                  jnp.asarray(b_h), jh0,
                                  use_kernel=use_kernel, **kw)
        testing.compare_scan(got, want, drive=drive, u_scaled=u / 1.5,
                             b_h=b_h, beta=0.8, n_bits=8, w_scale=1.5,
                             adc_bits=adc_bits).check()


def test_wbs_miru_scan_per_step_gains():
    B, T, H, nb = 4, 6, 40, 8
    drive, u, b_h, h0 = _scan_inputs(B, T, H, 0, True)
    gains = (2.0 ** -np.arange(1, nb + 1, dtype=np.float32))[None, :] \
        * (1 + 0.05 * np.random.default_rng(1).normal(size=(T, nb))
           ).astype(np.float32)
    kw = dict(SCAN_KW, adc_bits=8, weight_scale=1.5)
    got = ops.wbs_miru_scan(*(torch.from_numpy(a) for a in (drive, u, b_h)),
                            torch.from_numpy(h0), gains=torch.from_numpy(gains),
                            **kw)
    want = jref.wbs_miru_scan_ref(
        jnp.asarray(drive), jnp.asarray(u / 1.5), jnp.asarray(h0),
        jnp.asarray(b_h[None]), beta=0.8, lam=0.5, n_bits=8, adc_bits=8,
        w_scale=1.5, gains=jnp.asarray(gains))
    testing.compare_scan(got, want, drive=drive, u_scaled=u / 1.5, b_h=b_h,
                         beta=0.8, n_bits=8, w_scale=1.5, adc_bits=8,
                         gains=gains).check()


@pytest.mark.parametrize("weight_scale", [1.0, 1.5])
def test_wbs_input_drive_matches_reference(weight_scale):
    B, T, K, H = 3, 5, 28, 20
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (B, T, K)).astype(np.float32)
    w = rng.normal(0, 0.3, (K, H)).astype(np.float32)
    got = ops.wbs_input_drive(torch.from_numpy(x), torch.from_numpy(w), 8,
                              weight_scale=weight_scale)
    for use_kernel in (False, True):
        want = jops.wbs_input_drive(
            jnp.asarray(x), jnp.asarray(w), 8, weight_scale=weight_scale,
            use_kernel=use_kernel)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)
    # Row for row the per-step product.
    step = ops.wbs_dense(torch.from_numpy(x[:, 2]),
                         torch.from_numpy(w) / weight_scale, 8,
                         adc_bits=None) * weight_scale
    assert torch.equal(got[:, 2], step)


def _single_pass(sign, code, w, gains):
    """The kernels' plane_tile (csrc/wbs_common.cuh) step for step: per K
    tile of 128, ONE pass over k carrying every plane's sum, each step a
    fused multiply-add (the exact plane product p·w, summed with one
    rounding: formed in float64, which holds the sum of these two floats
    exactly, and rounded to float32 once), the plane sums then joined to
    the accumulator in plane order."""
    n_bits = gains.shape[0]
    M, K = sign.shape
    s = sign.to(torch.float32)
    acc = torch.zeros((M, w.shape[1]), dtype=torch.float32)
    for k0 in range(0, K, ref.BK):
        dots = [torch.zeros_like(acc) for _ in range(n_bits)]
        for k in range(k0, min(k0 + ref.BK, K)):
            for b in range(n_bits):
                p = ((code[:, k].to(torch.int32) >> (n_bits - 1 - b)) & 1
                     ).to(torch.float32) * s[:, k]
                pw = p[:, None] * w[k]
                assert torch.equal(pw.double(),
                                   p[:, None].double() * w[k].double())
                dots[b] = (dots[b].double() + pw.double()).to(torch.float32)
        for b in range(n_bits):
            acc = acc + gains[b] * dots[b]
    return acc * (2.0 ** n_bits / (2.0 ** n_bits - 1.0))


@pytest.mark.parametrize("n_bits", [1, 4, 8])
@pytest.mark.parametrize("m,k,n", [(5, 300, 37), (13, 129, 100)])
def test_single_pass_plane_order_equals_the_plain_version_bitwise(
        m, k, n, n_bits):
    """All plane sums carried in one pass over k and joined in plane order
    (the order the CUDA kernels keep) give ref.wbs_matmul_ref's bits, at K
    over one 128-deep tile and ragged M and N, with gains that are not
    the ideal ratios (so the order of joining the planes matters)."""
    rng = np.random.default_rng(m * k + n + n_bits)
    x = torch.from_numpy(rng.uniform(-1, 1, (m, k)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.3, (k, n)).astype(np.float32))
    sign, code = quantize_signed(x, n_bits)
    gains = torch.from_numpy(
        (2.0 ** -np.arange(1, n_bits + 1) * rng.uniform(0.9, 1.1, n_bits))
        .astype(np.float32))
    assert torch.equal(_single_pass(sign, code, w, gains),
                       ref.wbs_matmul_ref(sign, code, w, gains))


@pytest.mark.parametrize("m,k,n", [(5, 33, 70), (1, 130, 33),
                                   (9, 28, 100)])
def test_ops_matmul_ragged_edges_are_exact_zeros(m, k, n):
    """``ops.wbs_matmul`` takes any M and N (the kernel masks the ragged
    edges instead of padding): zero rows and columns past the edges only
    add output rows and columns of exact zeros, so the product at any
    shape is the whole-tile product cut back."""
    sign, code, w = _matmul_inputs(m, k, n, 3)
    g = ideal_gains(8)
    want = ref.wbs_matmul_ref(sign, code, w, g, 8)
    assert torch.equal(ops.wbs_matmul(sign, code, w, g, 8), want)
    padded = ref.wbs_matmul_ref(
        ops._pad_rows(sign, round_up(m, 8)),
        ops._pad_rows(code, round_up(m, 8)), F.pad(w, (0, round_up(n, 32) - n)), g, 8)
    assert torch.equal(padded[:m, :n], want)
    assert not padded[m:].any() and not padded[:, n:].any()


def test_ops_refuse_gradients():
    drive = torch.zeros(2, 3, 4, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no_grad"):
        ops.wbs_miru_scan(drive, torch.zeros(4, 4), torch.zeros(4),
                          **SCAN_KW)
    with torch.no_grad():
        ops.wbs_miru_scan(drive, torch.zeros(4, 4), torch.zeros(4),
                          **SCAN_KW)


def test_kernel_wrappers_refuse_cpu_tensors_and_bad_shapes():
    sign, code, w = _matmul_inputs(8, 28, 32, 0)
    with pytest.raises(ValueError, match="CUDA"):
        kmatmul.wbs_matmul(sign, code, w, ideal_gains(8))
    with pytest.raises(ValueError, match="CUDA"):
        kscan.wbs_miru_scan(torch.zeros(8, 2, 4), torch.zeros(4, 4),
                            torch.zeros(8, 4), torch.zeros(4),
                            torch.zeros(2, 8), beta=0.8, lam=0.5)
    assert kmatmul.adc_args(8, 4.0) == (1, 1 / 32, -128, 127)
    assert kmatmul.adc_args(None, 4.0)[0] == 0


def test_build_names_each_source_by_digest(monkeypatch):
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == set(_build.NAMES)
    paths = {n: _build.library_path(n) for n in _build.NAMES}
    assert len(set(paths.values())) == len(_build.NAMES)
    assert all(p.parent == _build.BUILD_DIR for p in paths.values())
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(_build.Path, "exists", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc()


def test_pallas_matmul_interpret_direct():
    """The Pallas kernel at block multiples, no wrapper in between."""
    sign, code, w = _matmul_inputs(8, 128, 128, 9)
    g = ideal_gains(8)
    want = wbs_matmul_pallas(*(jnp.asarray(t.numpy())
                               for t in (sign, code, w, g)),
                             adc_bits=8, bm=8, interpret=True)
    got = ops.wbs_matmul(sign, code, w, g, 8)
    testing.compare_matmul(got, want, sign=sign, code=code, w=w, gains=g,
                           adc_bits=8).check()


# ---------------------------------------------------------------------------
# The ideal MiRU scan and the readout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_h0", [False, True])
def test_miru_scan_ref_vs_pallas_interpret_direct(with_h0):
    """The plain version against the Pallas kernel at block multiples (B
    a multiple of 8, H of 128), no wrapper in between; fp32 tolerance
    (rtol 2e-5, atol 1e-6: XLA's dot sums in its own order)."""
    rng = np.random.default_rng(11)
    xw = rng.normal(0, 0.6, (8, 5, 128)).astype(np.float32)
    u = (rng.uniform(-1, 1, (128, 128)) * 0.15).astype(np.float32)
    h0 = (rng.uniform(-0.5, 0.5, (8, 128)) if with_h0
          else np.zeros((8, 128))).astype(np.float32)
    got = ref.miru_scan_ref(*(torch.from_numpy(a) for a in (xw, u, h0)),
                            0.8, 0.5)
    want = miru_scan_pallas(jnp.asarray(xw), jnp.asarray(u),
                            jnp.asarray(h0), beta=0.8, lam=0.5,
                            interpret=True)
    for a, c in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=2e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("m,k,n", [(1, 100, 10), (14, 100, 10), (9, 7, 3)])
def test_miru_readout_ref_order_and_reference(m, k, n):
    """k ascending, products and sums rounded to fp32, the bias last: the
    plain readout equals the hand-written loop bit for bit, and the
    reference's ``h @ w_o + b_o`` at fp32 tolerance."""
    rng = np.random.default_rng(m + k)
    h, w, b = (torch.from_numpy(rng.normal(0, 0.5, s).astype(np.float32))
               for s in ((m, k), (k, n), (n,)))
    got = ref.miru_readout_ref(h, w, b)
    acc = torch.zeros(m, n)
    for i in range(k):
        acc = acc + h[:, i:i + 1] * w[i]
    assert torch.equal(got, acc + b)
    want = jnp.asarray(h.numpy()) @ jnp.asarray(w.numpy()) \
        + jnp.asarray(b.numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=1e-6)


def test_ops_readout_and_scan_dispatch_cpu_to_plain(monkeypatch):
    """On CPU tensors the ops run the plain versions and never touch a
    kernel wrapper."""
    def boom(*a, **k):
        raise AssertionError("a CUDA kernel wrapper was called on the CPU")
    monkeypatch.setattr(kreadout, "miru_readout", boom)
    monkeypatch.setattr(kmiru, "miru_scan", boom)
    rng = np.random.default_rng(2)
    h, w, b = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((3, 4, 6), (6, 5), (5,)))
    got = ops.miru_readout(h, w, b)
    assert got.shape == (3, 4, 5)
    assert torch.equal(got.reshape(12, 5),
                       ref.miru_readout_ref(h.reshape(12, 6), w, b))
    u, h0 = torch.zeros(6, 6), torch.zeros(3, 6)
    assert all(torch.equal(a, c) for a, c in zip(
        ops.miru_scan(h, u, h0, 0.8, 0.5),
        ref.miru_scan_ref(h, u, h0, 0.8, 0.5)))


def test_new_kernel_wrappers_refuse_cpu_tensors_and_bad_inputs():
    with pytest.raises(ValueError, match="CUDA"):
        kmiru.miru_scan(torch.zeros(2, 3, 4), torch.zeros(4, 4),
                        torch.zeros(2, 4), beta=0.8, lam=0.5)
    with pytest.raises(ValueError, match="CUDA"):
        kreadout.miru_readout(torch.zeros(2, 4), torch.zeros(4, 3),
                              torch.zeros(3))
    # Read noise is ported (queue B2): it needs a key.
    with pytest.raises(ValueError, match="read_key"):
        ops.wbs_matmul(*_matmul_inputs(8, 4, 3, 0), ideal_gains(8),
                       read_sigma=0.1)


def test_wbs_input_drive_per_step_gains_are_the_per_step_products():
    """With per-step gains, each step's drive is that step's own
    crossbar product, row for row."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.uniform(-1, 1, (3, 4, 7)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.3, (7, 5)).astype(np.float32))
    gains = ideal_gains(8) * (1 + 0.05 * torch.from_numpy(
        rng.normal(size=(4, 8)).astype(np.float32)))
    got = ops.wbs_input_drive(x, w, 8, weight_scale=1.5, gains=gains)
    for t in range(4):
        step = ops.wbs_dense(x[:, t], w / 1.5, 8, adc_bits=None,
                             gains=gains[t]) * 1.5
        assert torch.equal(got[:, t], step)


# ---------------------------------------------------------------------------
# k-WTA by threshold bisection (ops.kwta)
# ---------------------------------------------------------------------------

def _kwta_rows(R, N, seed, ties=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (R, N)).astype(np.float32)
    if ties:                        # repeated magnitudes, both signs
        x = np.round(x * 4) / 4
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,N,k,ties", [
    (64, 1024, 580, False),         # benchmarks/kernel_bench.py's shape
    (3, 100, 10, False),            # fewer rows than the reference's block
    (11, 257, 30, False),           # rows the reference pads to 16
    (8, 64, 20, True),              # ties at the threshold
])
def test_kwta_bitwise_equal_to_reference(R, N, k, ties, dtype):
    x = _kwta_rows(R, N, R + N, ties)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jops.kwta(jx, k).astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = ops.kwta(tx, k)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert np.array_equal(got.float().numpy(), want)
    assert torch.equal(ref.kwta_bisect_ref(tx, k), got)


def test_kwta_one_row_and_k_at_least_n():
    x = _kwta_rows(1, 300, 4)[0]
    want = np.asarray(jops.kwta(jnp.asarray(x), 25))
    got = ops.kwta(torch.from_numpy(x), 25)
    assert got.shape == (300,) and np.array_equal(got.numpy(), want)
    assert int((got != 0).sum()) == 25
    t = torch.from_numpy(x)
    assert ops.kwta(t, 300) is t
    t2 = t[None]
    assert ops.kwta(t2, 400) is t2


def test_kwta_long_rows_take_the_exact_top_k(monkeypatch):
    """Rows longer than the limit go to the exact top-k (the reference's
    fallback), on any device; shrink the limit to reach it."""
    assert ops.KWTA_ROW_LIMIT == jops._KWTA_VMEM_LIMIT
    x = _kwta_rows(2, 64, 5, ties=True)
    monkeypatch.setattr(ops, "KWTA_ROW_LIMIT", 32)
    got = ops.kwta(torch.from_numpy(x), 10)
    want = np.asarray(jref.kwta_ref(jnp.asarray(x), 10))
    assert np.array_equal(got.numpy(), want)


def test_kwta_wrapper_refuses_cpu_tensors_and_bad_inputs():
    from repro_torch.kernels import kwta as kkwta
    with pytest.raises(ValueError, match="CUDA"):
        kkwta.kwta(torch.zeros(2, 8), 3)
