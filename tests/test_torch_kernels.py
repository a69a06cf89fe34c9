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


@pytest.mark.parametrize("b,h", [(64, 100), (32, 100), (1, 100), (5, 37),
                                 (33, 130), (300, 100), (8, 1024)])
def test_scan_geometry_and_row_padding_leave_the_real_rows_alone(b, h):
    """The scan's launch for (B, H) (``kernels/wbs_miru_scan.py ::
    geometry``): whole clusters of at most 8 blocks whose column slabs
    cover H, fewer than a cluster's rows of padding, a plane table that
    fits a block, and at the main paths' shapes (B 64 and 32, H 100) at
    least 64 blocks. The rows ``ops.wbs_miru_scan`` pads, whatever they
    hold, leave the real rows' bits alone (``ref.wbs_miru_scan_ref``)."""
    g = kscan.geometry(b, h)
    bp = g.padded(b)
    assert bp % g.rows == 0 and 0 <= bp - b < g.rows
    assert 1 <= g.cluster <= 8 and 1 <= g.rows <= 8 and g.ncols % 2 == 0
    assert (g.ncols - 2) * g.cluster < h <= g.ncols * g.cluster
    assert kscan.smem_bytes(h, g.rows, g.ncols, False) <= kscan.SMEM_LIMIT
    assert g.u_in_smem == (kscan.smem_bytes(h, g.rows, g.ncols, True)
                           <= kscan.SMEM_LIMIT)
    assert g.blocks(b) == bp // g.rows * g.cluster
    if h == 100 and b in (64, 32):
        assert g.blocks(b) >= 64
    t = 2 if h > 200 else 3
    drive, u, b_h, h0 = (torch.from_numpy(a) for a in _scan_inputs(
        b, t, h, b + h, True))
    args = (u / 1.5, b_h, 0.8, 0.5, 8, 8, 4.0, 1.5)
    want = ref.wbs_miru_scan_ref(drive, args[0], h0, *args[1:])
    junk = torch.full((bp - b, t, h), 3.0)
    for pad_d, pad_h in ((ops._pad_rows(drive, bp), ops._pad_rows(h0, bp)),
                         (torch.cat([drive, junk]),
                          torch.cat([h0, junk[:, 0]]))):
        assert pad_d.shape == (bp, t, h) and pad_h.shape == (bp, h)
        got = ref.wbs_miru_scan_ref(pad_d, args[0], pad_h, *args[1:])
        for a, c in zip(got, want):
            assert torch.equal(a[:b], c)


def test_scan_geometry_refuses_an_h_whose_table_does_not_fit():
    kscan.geometry(1, 5598)
    with pytest.raises(ValueError, match="too wide"):
        kscan.geometry(1, 5599)
    # Wide H keeps fewer rows a cluster, so the table still fits.
    assert kscan.geometry(64, 4096).rows == 1


def _miru_inputs(b, t, h, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(0, 0.6, (b, t, h)).astype(np.float32)),
            torch.from_numpy((rng.uniform(-1, 1, (h, h))
                              * np.sqrt(3.0 / h)).astype(np.float32)),
            torch.from_numpy(rng.uniform(-0.5, 0.5, (b, h)).astype(
                np.float32)))


@pytest.mark.parametrize("b,h", [(64, 100), (300, 100), (1, 100), (5, 37),
                                 (397, 128), (64, 129), (8, 256),
                                 (2, 3632)])
def test_miru_scan_place_and_each_row_alone(b, h):
    """Where the ideal scan reads U from at width H (``kernels/
    miru_scan.py :: u_place``): its column in registers exactly up to
    ``REG_H``, else shared memory where a block's layout fits, else
    global memory. The kernel runs one block a row (B blocks: 64 at train
    (a)'s shape), so a row's bits must not depend on the rows beside it:
    the first, a middle and the last row scanned alone give the batch's
    bits (``ref.miru_scan_ref``)."""
    place = kmiru.u_place(h)
    assert (place == "registers") == (h <= kmiru.REG_H)
    assert kmiru.smem_bytes(h, place) <= kmiru.SMEM_LIMIT
    assert (place == "smem") == (h > kmiru.REG_H and kmiru.smem_bytes(
        h, "smem") <= kmiru.SMEM_LIMIT)
    t = 2 if h > 200 else 3
    xw, u, h0 = _miru_inputs(b, t, h, b + h)
    want = ref.miru_scan_ref(xw, u, h0, 0.8, 0.5)
    for r in sorted({0, b // 2, b - 1}):
        got = ref.miru_scan_ref(xw[r:r + 1], u, h0[r:r + 1], 0.8, 0.5)
        for a, c in zip(got, want):
            assert torch.equal(a[0], c[r])


def test_miru_scan_refuses_h_past_its_limit():
    assert kmiru.u_place(kmiru.MAX_H) == "global"
    with pytest.raises(ValueError, match="outside"):
        kmiru.u_place(kmiru.MAX_H + 1)
    # A forced place that cannot hold U raises.
    kmiru.check_place(kmiru.REG_H, "registers")
    with pytest.raises(ValueError, match="registers"):
        kmiru.check_place(kmiru.REG_H + 1, "registers")
    with pytest.raises(ValueError, match="shared memory"):
        kmiru.check_place(300, "smem")
    with pytest.raises(ValueError, match="3632"):
        kmiru.check_place(kmiru.MAX_H + 1, "global")


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
    """The kernels' plane_dots and join_planes (csrc/wbs_common.cuh) step
    for step: per K tile of 128, ONE pass over k carrying every plane's
    sum, each step a fused multiply-add (the exact plane product p·w,
    summed with one rounding: formed in float64, which holds the sum of
    these two floats exactly, and rounded to float32 once), the plane sums
    then joined to the accumulator in plane order."""
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
    """The ideal scan and a direct crossbar product have no backward (nor
    have the reference's Pallas calls); the fused WBS scan has its
    straight-through one."""
    xw = torch.zeros(2, 3, 4, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no_grad"):
        ops.miru_scan(xw, torch.zeros(4, 4), torch.zeros(2, 4), 0.8, 0.5)
    sign, code, w = _matmul_inputs(8, 28, 32, 0)
    with pytest.raises(NotImplementedError, match="no_grad"):
        ops.wbs_matmul(sign, code, w.requires_grad_(True), ideal_gains(8))
    with torch.no_grad():
        ops.miru_scan(xw, torch.zeros(4, 4), torch.zeros(2, 4), 0.8, 0.5)
        ops.wbs_matmul(sign, code, w, ideal_gains(8))
    h_all, _, _ = ops.wbs_miru_scan(xw, torch.zeros(4, 4), torch.zeros(4),
                                    **SCAN_KW)
    assert h_all.requires_grad


def test_kernel_wrappers_refuse_cpu_tensors_and_bad_shapes():
    sign, code, w = _matmul_inputs(8, 28, 32, 0)
    with pytest.raises(ValueError, match="CUDA"):
        kmatmul.wbs_matmul(sign, code, w, ideal_gains(8))
    with pytest.raises(ValueError, match="CUDA"):
        kscan.wbs_miru_scan(torch.zeros(8, 2, 4), torch.zeros(4, 4),
                            torch.zeros(8, 4), torch.zeros(4),
                            torch.zeros(2, 8), beta=0.8, lam=0.5,
                            geom=kscan.geometry(8, 4))
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


def _readout_launch_walk(M, K, N, g):
    """The outputs and k ranges of ``csrc/miru_readout.cu``'s launch under
    geometry g, walked as its blocks, threads and tiles run: {(m, n): the
    k each tile sums, in order}."""
    seen = {}
    rows, cols = g.grid(M, N)
    for bx in range(rows):
        for by in range(cols):
            for r in range(g.rows):
                for c in range(g.cols):
                    m, n = bx * g.rows + r, by * g.cols + c
                    if m >= M or n >= N:
                        continue
                    assert (m, n) not in seen
                    seen[(m, n)] = [k for k0 in range(0, K, g.k_tile)
                                    for k in range(k0, min(k0 + g.k_tile, K))]
    return seen


@pytest.mark.parametrize("m,k,n", [(896, 100, 10), (200, 100, 10),
                                   (64, 100, 10), (32, 100, 10),
                                   (1, 100, 10), (14, 1500, 10),
                                   (896, 1500, 10), (3, 37, 300),
                                   (5, 1, 1), (9, 7, 257)])
def test_readout_geometry_covers_every_output_and_k_once(m, k, n):
    """``miru_readout.geometry`` launches every output exactly once, each
    summing k = 0..K-1 ascending across its K-tiles, within the block's
    threads and shared memory and the grid's limits; 896 rows spread over
    128 blocks, 32 and 64 rows over 32 and 64."""
    g = kreadout.geometry(m, k, n)
    assert g.k_tile % 4 == 0 and g.k_tile >= 4
    assert kreadout.smem_floats(g) <= kreadout.SMEM_FLOATS
    assert g.rows * g.cols <= kreadout.MAX_THREADS <= 1024
    assert g.grid(m, n)[1] <= 65535
    walk = _readout_launch_walk(m, k, n, g)
    assert len(walk) == m * n
    assert all(ks == list(range(k)) for ks in walk.values())
    if k <= 1000 and n <= kreadout.MAX_THREADS:
        assert g.k_tile >= k and g.cols == n        # one tile, whole rows
    if n == 10 and m in (32, 64, 896):
        assert g.grid(m, n)[0] == {32: 32, 64: 64, 896: 128}[m]


@pytest.mark.parametrize("sms", [1, 78, 114, 132, 144])
def test_readout_geometry_follows_the_cards_sms(sms):
    """``geometry`` aims its row groups at the card's SMs (the wrapper
    reads them from the device): one row a block up to M = sms, and every
    output still launched once with its k ascending."""
    for m in (1, 32, 64, 200, 896):
        g = kreadout.geometry(m, 100, 10, sms)
        assert g.rows == max(1, min(-(-m // sms), kreadout.MAX_THREADS // 10))
        walk = _readout_launch_walk(m, 100, 10, g)
        assert len(walk) == m * 10
        assert all(ks == list(range(100)) for ks in walk.values())
    assert kreadout.geometry(896, 100, 10) \
        == kreadout.geometry(896, 100, 10, kreadout.H100_SMS)


def _readout_tiled(h, w, b, g):
    """The kernel's arithmetic under geometry g on the CPU: each block's
    rows and columns, the chain carried across the K-tiles in ascending
    k, products and sums rounded to fp32, the bias last."""
    M, K = h.shape
    N = w.shape[1]
    out = torch.empty(M, N)
    rows, cols = g.grid(M, N)
    for bx in range(rows):
        for by in range(cols):
            ms = slice(bx * g.rows, min((bx + 1) * g.rows, M))
            ns = slice(by * g.cols, min((by + 1) * g.cols, N))
            acc = torch.zeros(ms.stop - ms.start, ns.stop - ns.start)
            for k0 in range(0, K, g.k_tile):
                for k in range(k0, min(k0 + g.k_tile, K)):
                    acc = acc + h[ms, k, None] * w[k, ns]
            out[ms, ns] = acc + b[ns]
    return out


@pytest.mark.parametrize("geom", [None, (1, 10, 100), (3, 4, 8), (7, 10, 4),
                                  (25, 7, 12)])
def test_readout_geometry_never_changes_a_row(geom):
    """Whatever rows a block, columns a block and K-tile the launch takes,
    every row's bits are the plain version's, which depend on that row
    alone."""
    rng = np.random.default_rng(31)
    h, w, b = (torch.from_numpy(rng.normal(0, 0.5, s).astype(np.float32))
               for s in ((40, 101), (101, 10), (10,)))
    g = kreadout.geometry(40, 101, 10) if geom is None \
        else kreadout.Geometry(*geom)
    want = ref.miru_readout_ref(h, w, b)
    assert torch.equal(_readout_tiled(h, w, b, g), want)
    for m in (1, 13, 32):
        assert torch.equal(_readout_tiled(h[:m], w, b, g), want[:m])


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


@pytest.mark.parametrize("N,path,warps,v", [
    (1, "warp", 1, 1), (100, "warp", 1, 4),
    (512, "warp", 1, 16),                       # the warp path's limit
    (513, "block", 2, 16), (1024, "block", 2, 16),
    (2048, "block", 4, 16), (2049, "block", 8, 16), (8193, "block", 32, 16),
    (16384, "block", 32, 16),                   # the block path's limit
    (16385, "stream", 32, 0), (65536, "stream", 32, 0),
    (1 << 20, "stream", 32, 0),                 # ops.KWTA_ROW_LIMIT
])
def test_kwta_plan_takes_each_row_length_to_its_path(N, path, warps, v):
    from repro_torch.kernels import kwta as kkwta
    assert (kkwta.WARP_N, kkwta.BLOCK_N) == (512, 16384)
    assert ops.KWTA_ROW_LIMIT == 1 << 20
    for dt in (torch.float32, torch.bfloat16):
        p = kkwta.plan(N, dt)
        assert tuple(p) == (path, warps, v)
    # only the register kernels that csrc/kwta.cu instantiates
    assert v in {"warp": kkwta.WARP_V, "block": (kkwta.PLAN_V,),
                 "stream": (0,)}[path]
    if path != "stream":            # the fewest warps, then values, that fit
        assert 32 * warps * v >= N
        assert N > 16 * warps * v or (path == "warp" and v == 1) \
            or (path == "block" and warps == 2)
    blocks, threads = kkwta.launch_shape(11, p)
    assert (blocks, threads) == ((3, 128) if path == "warp"
                                 else (11, 32 * warps))


def test_kwta_plan_refuses_other_dtypes_and_empty_rows():
    from repro_torch.kernels import kwta as kkwta
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kkwta.plan(10, torch.float16)
    with pytest.raises(ValueError, match="empty rows"):
        kkwta.plan(0)


def _kwta_by_plan(x, k, p, iters=32):
    """``csrc/kwta.cu``'s arithmetic under plan p on the CPU: the row
    spread over the plan's threads, value j of thread t element j·threads
    + t, +0 past N; each thread's counts summed over the row; the max an
    fmax over the threads' maxima; mid by fp32 rounding."""
    R, N = x.shape
    x32 = x.to(torch.float32)
    threads = 32 * p.warps
    per = -(-N // threads) if p.path == "stream" else p.v
    held = torch.zeros(R, per * threads)
    held[:, :N] = x32
    held = held.reshape(R, per, threads).abs()
    out = torch.empty_like(x32)
    for r in range(R):
        mx = held[r].amax(0).amax()
        lo, hi = torch.tensor(0.0), mx + 1.0
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            if int((held[r] > mid).sum(0).sum()) > k:
                lo = mid
            else:
                hi = mid
        theta = hi if int((held[r] > hi).sum(0).sum()) >= k else lo
        out[r] = torch.where(x32[r].abs() > theta, x32[r], 0.0)
    return out.to(x.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,N,k,ties", [(3, 100, 10, False),
                                        (5, 2048, 2047, True),
                                        (2, 2049, 0, False),
                                        (2, 5000, 700, True)])
def test_kwta_plans_never_change_a_row(R, N, k, ties, dtype):
    """Every plan that holds a row (its own, and those of the longer rows,
    the streamed one included) gives the plain version's bits: the counts
    are integers and the padding is +0, which no threshold (≥ +0)
    counts."""
    from repro_torch.kernels import kwta as kkwta
    x = torch.from_numpy(_kwta_rows(R, N, N + k, ties)).to(
        getattr(torch, dtype))
    want = ref.kwta_bisect_ref(x, k)
    plans = {kkwta.plan(n) for n in (N, 128, 512, 513, 2048, 4096, 8192,
                                     kkwta.BLOCK_N, kkwta.BLOCK_N + 1)
             if n >= N}
    assert len(plans) >= 3
    for p in plans:
        assert torch.equal(_kwta_by_plan(x, k, p), want), p
