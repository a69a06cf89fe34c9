"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips (the
decision is made in the ``cuda`` fixture, at run time, so every pytest
worker collects the same tests). Run them on a GPU machine with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_*.py``.

The plain versions repeat the kernels' arithmetic (summation order,
float64 tanh), so the kernels must match them bit for bit.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import testing
from repro_torch.analog.wbs import ideal_gains, quantize_signed
from repro_torch.backends import get_backend
from repro_torch.core.miru import MiRUConfig, init_miru_params
from repro_torch.kernels import ops, ref
from repro_torch.kernels import wbs_matmul as kmatmul
from repro_torch.kernels import wbs_miru_scan as kscan
from repro_torch.kernels import miru_readout as kreadout
from repro_torch.kernels import miru_scan as kmiru

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _on(dev, *arrays):
    return [torch.from_numpy(a).to(dev) for a in arrays]


@pytest.mark.parametrize("adc_bits", [8, None])
@pytest.mark.parametrize("m,k,n", [(896, 28, 100), (64, 100, 100),
                                   (5, 37, 13), (16, 300, 40), (8, 256, 256),
                                   (33, 129, 70), (400, 256, 100)])
def test_wbs_matmul_kernel_equals_plain(cuda, m, k, n, adc_bits):
    """Bitwise, at ragged M and N (nothing padded: the wrapper takes the
    operands as they are), one launch a call."""
    rng = np.random.default_rng(m + k + n)
    x, w = _on(cuda, rng.uniform(-1, 1, (m, k)).astype(np.float32),
               rng.normal(0, 0.3, (k, n)).astype(np.float32))
    sign, code = quantize_signed(x, 8)
    g = ideal_gains(8, device=cuda)
    before = kmatmul.launches
    got = ops.wbs_matmul(sign, code, w, g, adc_bits)
    want = ref.wbs_matmul_ref(sign, code, w, g, adc_bits)
    torch.cuda.synchronize()
    assert kmatmul.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(kmatmul.wbs_matmul(sign, code, w, g, adc_bits), want)


@pytest.mark.parametrize("n_bits", [1, 4, 8])
def test_wbs_matmul_kernel_equals_plain_at_other_widths(cuda, n_bits):
    """The single-pass plane sums at every code width, with gains that are
    not the ideal ratios, two K tiles, ragged M and N."""
    rng = np.random.default_rng(n_bits)
    x, w = _on(cuda, rng.uniform(-1, 1, (13, 300)).astype(np.float32),
               rng.normal(0, 0.3, (300, 37)).astype(np.float32))
    sign, code = quantize_signed(x, n_bits)
    g = ideal_gains(n_bits, device=cuda) * torch.from_numpy(
        rng.uniform(0.9, 1.1, n_bits).astype(np.float32)).to(cuda)
    got = ops.wbs_matmul(sign, code, w, g, 8)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.wbs_matmul_ref(sign, code, w, g, 8))


def _smem_switch(b):
    """The narrowest H at which a block of the scan at batch b reads its
    slab of U from global memory (kernels/wbs_miru_scan.py :: geometry,
    an H100's shared memory): arithmetic alone, the same in every pytest
    worker."""
    return next(h for h in range(2, 6000)
                if not kscan.geometry(b, h).u_in_smem)


@pytest.mark.parametrize("adc_bits", [8, None])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,t,h", [
    (64, 14, 100), (32, 28, 100),        # the serve and train shapes
    (64, 14, 256), (3, 5, 37), (9, 3, 128), (8, 2, 1024),
    (1, 6, 100), (5, 4, 37), (33, 3, 130),   # B off the cluster's rows
    (16, 3, 37), (16, 3, 130),               # H off the cluster's width
    (8, 2, _smem_switch(8) - 1), (8, 2, _smem_switch(8)),   # U's switch
])
def test_wbs_miru_scan_kernel_equals_plain(cuda, b, t, h, with_h0, adc_bits):
    rng = np.random.default_rng(b * t + h)
    drive, u, b_h, h0 = _on(
        cuda, rng.normal(0, 0.6, (b, t, h)).astype(np.float32),
        rng.uniform(-1, 1, (h, h)).astype(np.float32) * np.float32(
            np.sqrt(3.0 / h)),
        rng.normal(0, 0.1, (h,)).astype(np.float32),
        rng.uniform(-0.5, 0.5, (b, h)).astype(np.float32))
    kw = dict(beta=0.8, lam=0.5, n_bits=8, adc_bits=adc_bits, adc_range=4.0)
    before = kscan.launches
    got = ops.wbs_miru_scan(drive, u, b_h, h0 if with_h0 else None,
                            weight_scale=1.5, **kw)
    want = ref.wbs_miru_scan_ref(
        drive, u / 1.5, h0 if with_h0 else torch.zeros_like(h0), b_h,
        w_scale=1.5, **kw)
    torch.cuda.synchronize()
    assert kscan.launches == before + 1
    for a, c in zip(got, want):
        assert torch.equal(a, c)


def test_wbs_miru_scan_rows_do_not_depend_on_their_cluster(cuda):
    """A row's bits are the same whichever rows share its cluster: a
    64-row call launched with 1, 2, 4 and 8 rows a cluster in clusters of
    2, 4 and 8 blocks, and 5 rows of it in a call padded with junk rows
    to whole clusters of 2, 4 and 8 rows, all equal the call at
    ``geometry``'s launch (1 row a cluster of 2 at H 100)."""
    rng = np.random.default_rng(5)
    drive, u, b_h, h0 = _on(
        cuda, rng.normal(0, 0.6, (64, 14, 100)).astype(np.float32),
        rng.uniform(-0.17, 0.17, (100, 100)).astype(np.float32) / 1.5,
        rng.normal(0, 0.1, (100,)).astype(np.float32),
        rng.uniform(-0.5, 0.5, (64, 100)).astype(np.float32))
    gains = ideal_gains(8, device=cuda).expand(14, 8).contiguous()
    kw = dict(beta=0.8, lam=0.5, adc_bits=8, adc_range=4.0, w_scale=1.5)
    scan = lambda d, h, g: kscan.wbs_miru_scan(d, u, h, b_h, gains,
                                               geom=g, **kw)
    base = kscan.geometry(64, 100)
    assert (base.rows, base.cluster) == (1, 2)
    full = scan(drive, h0, base)
    want = ref.wbs_miru_scan_ref(drive, u, h0, b_h, 0.8, 0.5, 8, 8, 4.0, 1.5)
    torch.cuda.synchronize()
    for a, c in zip(full, want):
        assert torch.equal(a, c)
    for rows in (1, 2, 4, 8):
        for cluster in (2, 4, 8):
            got = scan(drive, h0, kscan.Geometry.of(rows, cluster, 100))
            torch.cuda.synchronize()
            for a, c in zip(got, full):
                assert torch.equal(a, c), (rows, cluster)
    junk = torch.full((3, 14, 100), 3.0, device=cuda)
    for rows in (2, 4, 8):
        g = kscan.Geometry.of(rows, 2, 100)
        pad = g.padded(5) - 5
        got = scan(torch.cat([drive[17:22], junk[:pad]]),
                   torch.cat([h0[17:22], junk[:pad, 0]]), g)
        torch.cuda.synchronize()
        for a, c in zip(got, full):
            assert torch.equal(a[:5], c[17:22]), rows


def test_fused_equals_per_step_on_the_card(cuda):
    cfg = MiRUConfig(n_x=28, n_h=100, n_y=10)
    params = init_miru_params(torch.Generator().manual_seed(0), cfg, cuda)
    g = torch.Generator().manual_seed(1)
    x = (torch.rand((64, 14, 28), generator=g) * 2 - 1).to(cuda)
    h0 = (torch.rand((64, 100), generator=g) - 0.5).to(cuda)
    backend = get_backend("wbs")
    fused = backend.device_recurrence(params, cfg, x, fused=True, h0=h0)
    step = backend.device_recurrence(params, cfg, x, fused=False, h0=h0)
    cpu = backend.device_recurrence({k: v.cpu() for k, v in params.items()},
                                    cfg, x.cpu(), fused=True, h0=h0.cpu())
    for a, c, d in zip(fused, step, cpu):
        assert torch.equal(a, c)
        assert torch.equal(a.cpu(), d)


def test_wrappers_check_their_inputs(cuda):
    sign = torch.zeros((8, 4), dtype=torch.int8, device=cuda)
    code = torch.zeros((8, 4), dtype=torch.uint8, device=cuda)
    w = torch.zeros((4, 32), device=cuda)
    g = ideal_gains(8, device=cuda)
    with pytest.raises(TypeError):
        kmatmul.wbs_matmul(sign.float(), code, w, g)
    with pytest.raises(ValueError, match="shape mismatch"):
        kmatmul.wbs_matmul(sign[:5], code, w, g)
    with pytest.raises(ValueError, match="contiguous"):
        kmatmul.wbs_matmul(sign, code, torch.zeros((32, 4), device=cuda).t(),
                           g)
    with pytest.raises(ValueError, match="one CUDA device"):
        kmatmul.wbs_matmul(sign, code, w.cpu(), g)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,t,h", [(64, 28, 100), (300, 28, 100),
                                   (64, 28, 256), (3, 5, 37), (9, 3, 128),
                                   (8, 2, 1024)])
def test_miru_scan_kernel_equals_plain(cuda, b, t, h, with_h0):
    rng = np.random.default_rng(b * t + h + 1)
    xw, u, h0 = _on(
        cuda, rng.normal(0, 0.6, (b, t, h)).astype(np.float32),
        rng.uniform(-1, 1, (h, h)).astype(np.float32) * np.float32(
            np.sqrt(3.0 / h)),
        rng.uniform(-0.5, 0.5, (b, h)).astype(np.float32))
    if not with_h0:
        h0 = torch.zeros_like(h0)
    before = kmiru.launches
    got = ops.miru_scan(xw, u, h0, 0.8, 0.5)
    want = ref.miru_scan_ref(xw, u, h0, 0.8, 0.5)
    torch.cuda.synchronize()
    assert kmiru.launches == before + 1
    for a, c in zip(got, want):
        assert torch.equal(a, c)


def _miru_inputs(dev, b, t, h, seed):
    rng = np.random.default_rng(seed)
    return _on(dev, rng.normal(0, 0.6, (b, t, h)).astype(np.float32),
               (rng.uniform(-1, 1, (h, h)) * np.sqrt(3.0 / h)).astype(
                   np.float32),
               rng.uniform(-0.5, 0.5, (b, h)).astype(np.float32))


@pytest.mark.parametrize("place,h", [("registers", 100), ("smem", 100),
                                     ("global", 100), ("smem", 129),
                                     ("global", 129), ("global", 256)])
def test_miru_scan_at_every_u_place(cuda, place, h):
    """Each place the scan can read U from (its column in registers, U in
    shared or in global memory), forced one by one on 13 rows: the plain
    version's bits."""
    b, t = 13, 5
    xw, u, h0 = _miru_inputs(cuda, b, t, h, h + len(place))
    got = kmiru.miru_scan(xw, u, h0, beta=0.8, lam=0.5, place=place)
    want = ref.miru_scan_ref(xw, u, h0, 0.8, 0.5)
    torch.cuda.synchronize()
    for a, c in zip(got, want):
        assert torch.equal(a, c)


@pytest.mark.parametrize("h", [w + d for w in kmiru.REG_CHAINS
                               for d in (0, 1)])
@pytest.mark.parametrize("b", [1, 5, 65, 300])
def test_miru_scan_at_ragged_batches_and_the_register_width(cuda, b, h):
    """``ops.miru_scan`` at ragged B on both sides of each register
    chain's length, the last the width past which U's column leaves the
    registers: one launch, the plain version's bits."""
    xw, u, h0 = _miru_inputs(cuda, b, 3, h, b + h)
    assert (kmiru.u_place(h) == "registers") == (h <= kmiru.REG_H)
    before = kmiru.launches
    got = ops.miru_scan(xw, u, h0, 0.8, 0.5)
    want = ref.miru_scan_ref(xw, u, h0, 0.8, 0.5)
    torch.cuda.synchronize()
    assert kmiru.launches == before + 1
    for a, c in zip(got, want):
        assert a.shape == c.shape and torch.equal(a, c)


def test_readout_kernel_equals_plain_and_is_row_exact(cuda):
    rng = np.random.default_rng(5)
    h, w, b = _on(cuda, rng.uniform(-1, 1, (896, 100)).astype(np.float32),
                  rng.normal(0, 0.3, (100, 10)).astype(np.float32),
                  rng.normal(0, 0.1, (10,)).astype(np.float32))
    before = kreadout.launches
    full = ops.miru_readout(h, w, b)
    torch.cuda.synchronize()
    assert kreadout.launches == before + 1
    assert torch.equal(full, ref.miru_readout_ref(h, w, b))
    for m in (1, 14, 32, 64, 200, 896):
        assert torch.equal(ops.miru_readout(h[:m].contiguous(), w, b),
                           full[:m])


@pytest.mark.parametrize("k,n", [(1500, 10), (1501, 10), (37, 300)])
def test_readout_kernel_row_exact_past_one_tile(cuda, k, n):
    """K past one shared-memory tile (the chain carried across tiles; K
    % 4 != 0 takes the 4-byte copies of h), and N past a block's columns
    (a column tile of w_o, 4-byte copies): bit for bit and row-exact at
    every M, one launch a call."""
    from repro_torch.kernels import miru_readout as kr
    rng = np.random.default_rng(k + n)
    h, w, b = _on(cuda, rng.uniform(-1, 1, (896, k)).astype(np.float32),
                  rng.normal(0, 0.3, (k, n)).astype(np.float32),
                  rng.normal(0, 0.1, (n,)).astype(np.float32))
    assert kr.geometry(896, k, n).k_tile < k or kr.geometry(
        896, k, n).cols < n
    full = ops.miru_readout(h, w, b)
    assert torch.equal(full, ref.miru_readout_ref(h, w, b))
    for m in (1, 14, 32, 64, 200):
        before = kreadout.launches
        got = ops.miru_readout(h[:m].contiguous(), w, b)
        torch.cuda.synchronize()
        assert kreadout.launches == before + 1
        assert torch.equal(got, full[:m])
        assert torch.equal(got, ref.miru_readout_ref(h[:m], w, b))


def test_miru_forward_fused_launches_the_scan_on_the_card(cuda):
    from repro_torch.core.miru import miru_forward
    cfg = MiRUConfig(n_x=28, n_h=100, n_y=10)
    params = init_miru_params(torch.Generator().manual_seed(2), cfg, cuda)
    x = torch.rand((64, 28, 28), generator=torch.Generator().manual_seed(3))
    before = (kmiru.launches, kreadout.launches)
    logits, inter = miru_forward(params, cfg, x.to(cuda), use_fused=True)
    torch.cuda.synchronize()
    assert (kmiru.launches, kreadout.launches) == (before[0] + 1,
                                                   before[1] + 1)
    cpu, cinter = miru_forward({k: v.cpu() for k, v in params.items()}, cfg,
                               x, use_fused=True)
    np.testing.assert_allclose(logits.cpu().numpy(), cpu.numpy(),
                               rtol=2e-5, atol=1e-6)


def test_one_slot_engine_serves_the_64_slot_bits(cuda):
    from repro_torch.serve import (RecurrentServeConfig,
                                   RecurrentServeEngine, TrafficSpec, replay)
    cfg = MiRUConfig(n_x=28, n_h=100, n_y=10)
    params = init_miru_params(torch.Generator().manual_seed(0), cfg, cuda)
    arrivals = [(a.uid, f) for a, f in replay(TrafficSpec(
        n_requests=24, rate_hz=None, n_users=6, frames_min=28,
        frames_max=28, n_x=28, seed=0))]

    def serve(slots, traffic):
        eng = RecurrentServeEngine(
            cfg, RecurrentServeConfig(device="wbs", fresh_meter=True,
                                      batch_slots=slots, chunk=14),
            params, torch_device=cuda)
        reqs = [eng.submit(f, uid=u) for u, f in traffic]
        eng.run_until_drained()
        return reqs

    full = serve(64, arrivals)
    for uid in sorted({u for u, _ in arrivals})[:3]:
        mine = [(u, f) for u, f in arrivals if u == uid]
        alone = serve(1, mine)
        want = [r.logits for (u, _), r in zip(arrivals, full) if u == uid]
        for a, w in zip(alone, want):
            assert np.array_equal(a.logits, w)


# ---------------------------------------------------------------------------
# The read-noise variant of the WBS product (read_sigma > 0)
# ---------------------------------------------------------------------------

def _read_noise_inputs(dev, m, k, n, seed):
    rng = np.random.default_rng(seed)
    x, w = _on(dev, rng.uniform(-1, 1, (m, k)).astype(np.float32),
               rng.normal(0, 0.3, (k, n)).astype(np.float32))
    sign, code = quantize_signed(x, 8)
    return sign, code, w, ideal_gains(8, device=dev)


@pytest.mark.parametrize("adc_bits", [8, None])
@pytest.mark.parametrize("m,k,n", [(32, 28, 100), (32, 100, 100),
                                   (896, 28, 100), (5, 37, 13),
                                   (16, 300, 40)])
def test_read_noise_kernel_equals_plain(cuda, m, k, n, adc_bits):
    """Bitwise, and the same bits as the plain version on the CPU: the
    noise depends on the key alone."""
    from repro_torch import prng
    sign, code, w, g = _read_noise_inputs(cuda, m, k, n, m + k + n)
    key = prng.PRNGKey(m * k + n)
    words = ops.read_key_words(key)
    before = (kmatmul.launches, kmatmul.read_noise_launches)
    got = ops.wbs_matmul(sign, code, w, g, adc_bits, read_sigma=0.1,
                         read_key=key)
    want = ref.wbs_matmul_read_noise_ref(sign, code, w, g, 0.1, words,
                                         adc_bits)
    torch.cuda.synchronize()
    assert (kmatmul.launches, kmatmul.read_noise_launches) == (
        before[0], before[1] + 1)
    assert torch.equal(got, want)
    cpu = ops.wbs_matmul(sign.cpu(), code.cpu(), w.cpu(), g.cpu(), adc_bits,
                         read_sigma=0.1, read_key=key)
    assert torch.equal(got.cpu(), cpu)


def test_read_noise_kernel_at_zero_sigma_is_the_plain_kernel(cuda):
    for m, k, n in ((32, 28, 100), (32, 100, 100), (896, 28, 100)):
        sign, code, w, g = _read_noise_inputs(cuda, m, k, n, 7)
        for adc_bits in (8, None):
            a = kmatmul.wbs_matmul_read_noise(sign, code, w, g, 0.0, (1, 2),
                                              adc_bits=adc_bits)
            b = kmatmul.wbs_matmul(sign, code, w, g, adc_bits)
            torch.cuda.synchronize()
            assert torch.equal(a, b)


def test_read_noise_is_shared_by_all_rows_of_a_call(cuda):
    """One draw per weight element per call, for any M: identical rows,
    even 128 or more rows apart, give identical outputs."""
    from repro_torch import prng
    sign, code, w, g = _read_noise_inputs(cuda, 300, 100, 100, 3)
    sign[200], code[200] = sign[3], code[3]
    y = ops.wbs_matmul(sign, code, w, g, None, read_sigma=0.1,
                       read_key=prng.PRNGKey(1))
    torch.cuda.synchronize()
    assert torch.equal(y[3], y[200])
    assert not torch.equal(y, ops.wbs_matmul(sign, code, w, g, None))


@pytest.mark.parametrize("m,k,n", [(7, 100, 100), (33, 130, 45),
                                   (1, 28, 100), (1, 257, 70),
                                   (3000, 28, 100)])
def test_read_noise_kernel_at_ragged_edges(cuda, m, k, n):
    """M not a multiple of a block's rows, N not a multiple of 32, K over
    one 128-deep tile, M 1, and a product past the wide layout's switch
    (M·N ≥ 32,768): bitwise against the plain version, and at σ = 0 the
    plain kernel's bits."""
    from repro_torch import prng
    sign, code, w, g = _read_noise_inputs(cuda, m, k, n, m + k + n)
    key = prng.PRNGKey(m + k * n)
    words = ops.read_key_words(key)
    for adc_bits in (8, None):
        got = kmatmul.wbs_matmul_read_noise(sign, code, w, g, 0.1, words,
                                            adc_bits=adc_bits)
        want = ref.wbs_matmul_read_noise_ref(sign, code, w, g, 0.1, words,
                                             adc_bits)
        zero = kmatmul.wbs_matmul_read_noise(sign, code, w, g, 0.0, words,
                                             adc_bits=adc_bits)
        plain = kmatmul.wbs_matmul(sign, code, w, g, adc_bits)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.equal(zero, plain)


# ---------------------------------------------------------------------------
# The flash-attention forward and the k-WTA bisection (the LM slice)
# ---------------------------------------------------------------------------

def _flash_inputs(dev, B, Sq, Sk, H, Kh, dh, dtype, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
               for s in ((B, Sq, H, dh), (B, Sk, Kh, dh), (B, Sk, Kh, dh)))
    return [t.to(dev, dtype) for t in (q, k, v)]


# The launch counters of the flash kernels (kernels/flash_attention.py).
# kernels/ops.py sends bf16 to the tensor-core forward, dq and dk/dv, fp32
# to the fp32 ones.
_FLASH_COUNTERS = ("fwd_f32_sm90_launches", "fwd_sm90_launches",
                   "dq_launches", "dq_sm90_launches", "dkv_launches",
                   "dkv_sm90_launches")
_FWD_COUNTER = {"float32": "fwd_f32_sm90_launches",
                "bfloat16": "fwd_sm90_launches"}
_DQ_COUNTER = {"float32": "dq_launches", "bfloat16": "dq_sm90_launches"}
_DKV_COUNTER = {"float32": "dkv_launches", "bfloat16": "dkv_sm90_launches"}


def _flash_launches():
    from repro_torch.kernels import flash_attention as kflash
    return {n: getattr(kflash, n) for n in _FLASH_COUNTERS}


def _launched(before, *names):
    """The flash counters moved by exactly one for each of ``names`` and
    not at all for the others."""
    after = _flash_launches()
    return {n: after[n] - before[n] for n in after} == \
        {n: int(n in names) for n in after}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,Kh,dh,causal", [
    (1, 2048, 2048, 14, 2, 64, True),    # the qwen2-0.5B prefill, rep 7
    (2, 2048, 2048, 14, 2, 64, True),    # ... at the main path's batch
    (2, 256, 256, 4, 2, 64, True),       # kernel_bench's shape
    (1, 300, 300, 14, 2, 64, True),      # Sk not a tile multiple
    (2, 100, 333, 4, 2, 64, False),      # Sq != Sk, not causal
    (1, 130, 130, 4, 4, 64, True),       # rep 1
    (1, 96, 96, 4, 2, 128, True),        # head dim 128
    (2, 40, 40, 4, 2, 8, False),         # head dim 8, zero-padded to 64
    (1, 4096, 4096, 16, 16, 64, False),  # seamless's encoder, not causal
    (1, 2048, 4096, 16, 16, 64, False),  # seamless's cross-attention
    (1, 4096, 4096, 56, 8, 128, True),   # llava's prefill, GQA 56/8
])
def test_flash_kernel_equals_plain(cuda, B, Sq, Sk, H, Kh, dh, causal,
                                   dtype):
    """fp32 through the fp32 kernel, bf16 through the tensor-core kernel
    (``flash_attention_fwd_sm90``), each launched once."""
    dt = getattr(torch, dtype)
    q, k, v = _flash_inputs(cuda, B, Sq, Sk, H, Kh, dh, dt, Sq + Sk + H)
    before = _flash_launches()
    out, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _launched(before, _FWD_COUNTER[dtype])
    # The plain version on the same inputs, through the same wrapper.
    plain = lambda: ops.flash_attention_fwd(q.cpu(), k.cpu(), v.cpu(),
                                            causal=causal)
    want_o, want_l = plain()
    assert out.dtype == dt and lse.dtype == torch.float32
    if not torch.allclose(lse.cpu(), want_l, rtol=0, atol=1e-5):
        # Keep the inputs and both lse (under the checkout's chiprun_out/,
        # the git-ignored directory of a GPU run's results), and recompute
        # each side once: the record, in the failure's message, says
        # which side moved.
        rec = testing.record_lse_mismatch(
            Path(__file__).resolve().parents[1] / "chiprun_out" / "flash_lse"
            / f"test_{B}_{Sq}_{Sk}_{H}_{Kh}_{dh}_{causal}_{dtype}.pt",
            dict(q=q, k=k, v=v), lse,
            want_l, lambda: ops.flash_attention_fwd(q, k, v,
                                                    causal=causal)[1],
            lambda: plain()[1])
        pytest.fail(f"lse off the plain version's by more than 1e-5: {rec}")
    if dt == torch.float32:
        np.testing.assert_allclose(out.cpu().numpy(), want_o.numpy(),
                                   rtol=2e-5, atol=2e-6)
    else:
        # Against the plain version's fp32 value: one bf16 ulp of rounding
        # plus the fp32 tolerance of the two summation orders.
        want32, _ = ops.flash_attention_fwd(q.cpu().float(),
                                            k.cpu().float(),
                                            v.cpu().float(), causal=causal)
        assert testing.bf16_within(out.cpu(), want32)[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_masks_padding_by_sk_true_and_skips_future_tiles(
        cuda, dtype):
    """Keys at or past sk_true, and under the causal mask keys past each
    row, leave the output's bits unchanged whatever they hold: the kernel
    skips their tiles or weighs them by exactly 0."""
    q, k, v = _flash_inputs(cuda, 1, 200, 200, 14, 2, 64,
                            getattr(torch, dtype), 9)
    out, lse = ops.flash_attention_fwd(q, k, v, causal=True)
    k2, v2 = k.clone(), v.clone()
    k2[:, 150:], v2[:, 150:] = 7.0, -3.0
    out2, lse2 = ops.flash_attention_fwd(q, k2, v2, causal=True)
    assert torch.equal(out[:, :150], out2[:, :150])
    assert torch.equal(lse[..., :150], lse2[..., :150])
    # Padded keys past sk_true: the same bits as without the padding.
    kp = torch.cat([k, torch.full_like(k[:, :56], 5.0)], 1)
    vp = torch.cat([v, torch.full_like(v[:, :56], -5.0)], 1)
    for causal in (True, False):
        a, la = ops.flash_attention_fwd(q, k, v, causal=causal)
        b, lb = ops.flash_attention_fwd(q, kp, vp, causal=causal, sk_true=200)
        assert torch.equal(a, b) and torch.equal(la, lb)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("H,Kh", [(7, 1), (4, 4)])      # rep 7 and 1
def test_flash_fp32_forward_with_padded_keys_equals_plain(cuda, H, Kh, dh,
                                                         causal):
    """The fp32 tensor-core forward (its inputs in three bf16 terms) with
    keys padded past ``sk_true``: out within the fp32 tolerance of the
    plain version, lse within 1e-5, one launch of the fp32 forward."""
    B, Sq, Sk, skt = 2, 200, 330, 170
    q, k, v = _flash_inputs(cuda, B, Sq, Sk, H, Kh, dh, torch.float32,
                            H + dh + int(causal))
    before = _flash_launches()
    out, lse = ops.flash_attention_fwd(q, k, v, causal=causal, sk_true=skt)
    torch.cuda.synchronize()
    assert _launched(before, _FWD_COUNTER["float32"])
    want_o, want_l = ops.flash_attention_fwd(q.cpu(), k.cpu(), v.cpu(),
                                             causal=causal, sk_true=skt)
    np.testing.assert_allclose(out.cpu().numpy(), want_o.numpy(), rtol=2e-5,
                               atol=2e-6)
    assert float((lse.cpu() - want_l).abs().max()) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,Kh,dh,causal,sk_true", [
    (2, 2048, 2048, 14, 2, 64, True, None),   # the qwen2-0.5B train step
    (1, 100, 333, 4, 2, 64, False, 250),      # Sq != Sk, padded keys
    (1, 300, 300, 14, 2, 64, True, None),     # rep 7, Sk off the tiles
    (2, 130, 130, 4, 4, 64, True, None),      # rep 1
    (1, 96, 200, 4, 1, 80, False, 150),       # head dim 80, padded to 128
    (1, 70, 70, 4, 2, 128, True, None),       # head dim 128
    (1, 300, 333, 14, 2, 128, False, 300),    # head dim 128, rep 7, sk_true
    (1, 2048, 4096, 16, 16, 64, False, None),  # seamless's cross-attention
    (1, 2048, 4096, 16, 16, 64, False, 3000),  # ... keys past sk_true
    (1, 4096, 4096, 56, 8, 128, True, None),   # llava's step, GQA 56/8
])
def test_flash_bwd_kernels_equal_plain(cuda, B, Sq, Sk, H, Kh, dh, causal,
                                       sk_true, dtype):
    """The dq and dk/dv kernels of the dtype (bf16: the tensor-core
    ``flash_attention_bwd_dq_sm90`` and ``flash_attention_bwd_dkv_sm90``
    with its fold; fp32: the fp32 tensor-core ``flash_attention_bwd_dq``
    and ``flash_attention_bwd_dkv``, on inputs split into bf16 terms),
    each launched once."""
    dt = getattr(torch, dtype)
    q, k, v = _flash_inputs(cuda, B, Sq, Sk, H, Kh, dh, dt, Sq + Sk + dh)
    out, lse = ops.flash_attention_fwd(q, k, v, causal=causal,
                                       sk_true=sk_true)
    dout = _flash_inputs(cuda, B, Sq, Sq, H, H, dh, dt, 1)[0]
    before = _flash_launches()
    got = ops.flash_attention_bwd(q, k, v, out, lse, dout, causal, sk_true)
    torch.cuda.synchronize()
    assert _launched(before, _DQ_COUNTER[dtype], _DKV_COUNTER[dtype])
    want = testing.flash_bwd_plain(q, k, v, out, lse, dout, causal, sk_true)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.shape == t.shape and g.dtype == dt
        assert testing.grads_close(g, w), float((g.float() - w).abs().max())
    if sk_true is not None:          # keys past sk_true get no gradient
        assert not got[1][:, sk_true:].any() and \
            not got[2][:, sk_true:].any()


@pytest.mark.parametrize("B,Sq,Sk,H,Kh,dh,causal,sk_true", [
    (2, 2048, 2048, 14, 2, 64, True, None),   # the qwen2-0.5B train step
    (1, 1100, 2048, 14, 2, 64, True, 1100),   # the training twin's keys
    (2, 2048, 2048, 14, 2, 64, False, None),  # not causal
    (1, 100, 333, 4, 2, 64, False, 250),      # Sq != Sk, ragged sk_true
    (1, 130, 130, 7, 1, 128, True, None),     # head dim 128, rep 7
    (2, 96, 200, 4, 4, 128, False, 150),      # head dim 128, rep 1
    (1, 70, 70, 4, 2, 80, True, None),        # head dim 80, padded
])
def test_flash_dq_sm90_equals_plain(cuda, B, Sq, Sk, H, Kh, dh, causal,
                                    sk_true):
    """The tensor-core dq against ``ref.flash_attention_bwd_ref`` at
    ``testing.grads_close``, launched once a call, with Sq off the 64-row
    tile in most cases."""
    from repro_torch.kernels import flash_attention as kflash
    bf = torch.bfloat16
    q, k, v = _flash_inputs(cuda, B, Sq, Sk, H, Kh, dh, bf, Sq + Sk + H)
    dout = _flash_inputs(cuda, B, Sq, Sq, H, H, dh, bf, 3)[0]
    out, lse = ops.flash_attention_fwd(q, k, v, causal=causal,
                                       sk_true=sk_true)
    before = kflash.dq_sm90_launches
    dq = ops.flash_attention_bwd(q, k, v, out, lse, dout, causal,
                                 sk_true)[0]
    torch.cuda.synchronize()
    assert kflash.dq_sm90_launches == before + 1
    want = testing.flash_bwd_plain(q, k, v, out, lse, dout, causal,
                                   sk_true)[0]
    assert dq.dtype == bf and dq.shape == q.shape
    assert testing.grads_close(dq, want), float((dq.float() - want).abs()
                                                .max())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("B,S,H,Kh,dh,causal", [
    (2, 2048, 14, 2, 64, True),          # the qwen2-0.5B train step
    (1, 300, 7, 1, 128, False),          # rep 7, head dim 128
])
def test_flash_sm90_kernels_are_bitwise_run_to_run(cuda, B, S, H, Kh, dh,
                                                   causal, dtype):
    """The tensor-core forward, dq (a block owns its rows) and dk/dv (its
    rep partials folded in a fixed order, no atomics) of the dtype give
    the same bits on every call: the
    forward and backward twice, then dq and dk/dv ten more times."""
    from repro_torch.kernels import flash_attention as kflash
    dt = getattr(torch, dtype)
    q, k, v = _flash_inputs(cuda, B, S, S, H, Kh, dh, dt, 11)
    dout = _flash_inputs(cuda, B, S, S, H, H, dh, dt, 12)[0]
    runs = []
    for _ in range(2):
        out, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
        runs.append((out, lse, *ops.flash_attention_bwd(
            q, k, v, out, lse, dout, causal)))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    heads = lambda t: t.transpose(1, 2).reshape(-1, S, dh)
    qt, kt, vt, ot, dot = (heads(t).contiguous() for t in (q, k, v, out,
                                                           dout))
    lse = lse.reshape(-1, S)
    delta = torch.sum(dot.float() * ot.float(), -1)
    kw = dict(causal=causal, sk_true=S, q_heads=H, kv_heads=Kh,
              scale=dh ** -0.5)
    kernels = ((kflash.flash_attention_bwd_dq_sm90,
                kflash.flash_attention_bwd_dkv_sm90) if dt == torch.bfloat16
               else (kflash.flash_attention_bwd_dq,
                     kflash.flash_attention_bwd_dkv))
    for kernel in kernels:
        first = kernel(qt, kt, vt, dot, lse, delta, **kw)
        for _ in range(10):
            again = kernel(qt, kt, vt, dot, lse, delta, **kw)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_flash_fp32_backward_takes_the_f32_tensor_core_kernels(cuda,
                                                               monkeypatch):
    """The dispatch: an fp32 backward loads the fp32 tensor-core libraries
    and no other flash library, and moves ``dq_launches`` and
    ``dkv_launches`` by one each a call and the bf16 counters not at all;
    a bf16 backward loads the bf16 ones."""
    from repro_torch.kernels import _build
    load, loaded = _build.load, []

    def recording(name, flags=()):
        loaded.append(name)
        return load(name, flags)
    monkeypatch.setattr(_build, "load", recording)
    for dtype, libs in (("float32", {"flash_attention_bwd_dq_f32_sm90",
                                     "flash_attention_bwd_dkv_f32_sm90"}),
                        ("bfloat16", {"flash_attention_bwd_dq_sm90",
                                      "flash_attention_bwd_dkv_sm90"})):
        dt = getattr(torch, dtype)
        q, k, v = _flash_inputs(cuda, 1, 130, 130, 4, 2, 64, dt, 14)
        dout = _flash_inputs(cuda, 1, 130, 130, 4, 4, 64, dt, 15)[0]
        out, lse = ops.flash_attention_fwd(q, k, v, causal=True)
        for _ in range(2):
            loaded.clear()
            before = _flash_launches()
            ops.flash_attention_bwd(q, k, v, out, lse, dout, True)
            torch.cuda.synchronize()
            assert _launched(before, _DQ_COUNTER[dtype],
                             _DKV_COUNTER[dtype])
            assert set(loaded) == libs, loaded


def test_flash_bf16_calls_the_sm90_kernels_cannot_take_raise(cuda):
    """A bf16 call the tensor-core kernels cannot take raises; it is never
    handed to the fp32 kernels, which raise on bf16 themselves (no flash
    counter moves)."""
    from repro_torch.kernels import flash_attention as kflash
    bf = torch.bfloat16
    q, k, v = (t.transpose(1, 2).reshape(-1, 64, 96).contiguous() for t in
               _flash_inputs(cuda, 1, 64, 64, 4, 2, 96, bf, 13))
    kw = dict(causal=True, sk_true=64, q_heads=4, kv_heads=2, scale=0.1)
    lse = torch.zeros(4, 64, device=cuda)
    before = _flash_launches()
    with pytest.raises(ValueError, match="must be one of"):
        kflash.flash_attention_fwd_sm90(q, k, v, **kw)
    with pytest.raises(ValueError, match="must be one of"):
        kflash.flash_attention_bwd_dkv_sm90(q, k, v, q, lse, lse, **kw)
    with pytest.raises(ValueError, match="must be one of"):
        kflash.flash_attention_bwd_dq_sm90(q, k, v, q, lse, lse, **kw)
    q64, k64, v64 = (t[..., :64].contiguous() for t in (q, k, v))
    with pytest.raises(TypeError, match="bfloat16 only"):
        kflash.flash_attention_fwd_sm90(q64.float(), k64.float(),
                                        v64.float(), **kw)
    with pytest.raises(TypeError, match="bfloat16 only"):
        kflash.flash_attention_bwd_dq_sm90(q64.float(), k64.float(),
                                           v64.float(), q64.float(), lse,
                                           lse, **kw)
    # The fp32 kernels take fp32 only: bf16 never reaches them.
    with pytest.raises(TypeError, match="float32 only"):
        kflash.flash_attention_fwd(q64, k64, v64, **kw)
    with pytest.raises(TypeError, match="float32 only"):
        kflash.flash_attention_bwd_dq(q64, k64, v64, q64, lse, lse, **kw)
    with pytest.raises(TypeError, match="float32 only"):
        kflash.flash_attention_bwd_dkv(q64, k64, v64, q64, lse, lse, **kw)
    flat = torch.zeros(q64.numel() + 1, dtype=bf, device=cuda)
    q_odd = flat[1:].view(q64.shape)              # 2 bytes off alignment
    with pytest.raises(ValueError, match="16-byte aligned"):
        kflash.flash_attention_fwd_sm90(q_odd, k64, v64, **kw)
    with pytest.raises(ValueError, match="fit none"):  # (192, 192): no pair
        ops.flash_attention_fwd(*_flash_inputs(cuda, 1, 16, 16, 2, 1, 192,
                                               bf, 14))
    with pytest.raises(TypeError):
        q, k, v = _flash_inputs(cuda, 1, 16, 16, 2, 1, 64, bf, 15)
        ops.flash_attention_fwd(q, k.float(), v)
    assert _flash_launches() == before


def _mla_flash_inputs(dev, B, Sq, Sk, H, dtype, seed, dh=192, dv=128):
    """q, k (dh columns) and v (dv columns), MLA's head dims (rep 1)."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
               for s in ((B, Sq, H, dh), (B, Sk, H, dh), (B, Sk, H, dv)))
    return [t.to(dev, dtype) for t in (q, k, v)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,causal,sk_true", [
    (1, 2048, 2048, 16, True, None),     # the deepseek prefill's tiles
    (1, 2048, 2048, 16, False, None),
    (2, 300, 333, 4, True, 290),         # Sk off the tiles, padded keys
    (1, 130, 130, 3, False, None),       # Sq off the 64-row tiles
])
def test_flash_mla_pair_equals_plain(cuda, B, Sq, Sk, H, causal, sk_true,
                                     dtype):
    """The (192, 128) instantiations of the forward (bf16: the tensor-core
    kernel; fp32: one warpgroup of 64 query rows a block) against the
    plain version: one launch, out (B, Sq, H, 128), lse within 1e-5, fp32
    out at rtol 2e-5 / atol 2e-6, bf16 within one ulp plus that."""
    dt = getattr(torch, dtype)
    q, k, v = _mla_flash_inputs(cuda, B, Sq, Sk, H, dt, Sq + Sk + H)
    before = _flash_launches()
    out, lse = ops.flash_attention_fwd(q, k, v, causal=causal,
                                       sk_true=sk_true)
    torch.cuda.synchronize()
    assert _launched(before, _FWD_COUNTER[dtype])
    assert out.shape == (B, Sq, H, 128) and out.dtype == dt
    want_o, want_l = ops.flash_attention_fwd(
        q.cpu().float(), k.cpu().float(), v.cpu().float(), causal=causal,
        sk_true=sk_true)
    assert float((lse.cpu() - want_l).abs().max()) <= 1e-5
    if dt == torch.float32:
        np.testing.assert_allclose(out.cpu().numpy(), want_o.numpy(),
                                   rtol=2e-5, atol=2e-6)
    else:
        assert testing.bf16_within(out.cpu(), want_o)[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,causal,sk_true", [
    (1, 2048, 2048, 16, True, None),
    (1, 2048, 2048, 16, False, None),
    (2, 300, 333, 4, True, 290),
    (1, 100, 200, 3, False, 150),
])
def test_flash_mla_pair_backward_equals_plain(cuda, B, Sq, Sk, H, causal,
                                              sk_true, dtype):
    """The (192, 128) dq and dk/dv of the dtype (bf16: dq's panels and
    dk/dv's dV and dK blocks; fp32: K and V through one region in dq, Q
    and dO in dk/dv's dK blocks), each launched once a call, against the
    plain version at ``testing.grads_close``; dq and dk have 192 columns,
    dv 128; keys past sk_true get no gradient; a second call the same
    bits."""
    dt = getattr(torch, dtype)
    q, k, v = _mla_flash_inputs(cuda, B, Sq, Sk, H, dt, Sq + Sk)
    out, lse = ops.flash_attention_fwd(q, k, v, causal=causal,
                                       sk_true=sk_true)
    dout = _mla_flash_inputs(cuda, B, Sq, Sq, H, dt, 2)[2]
    before = _flash_launches()
    got = ops.flash_attention_bwd(q, k, v, out, lse, dout, causal, sk_true)
    torch.cuda.synchronize()
    assert _launched(before, _DQ_COUNTER[dtype], _DKV_COUNTER[dtype])
    want = testing.flash_bwd_plain(q, k, v, out, lse, dout, causal, sk_true)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.shape == t.shape and g.dtype == dt
        assert testing.grads_close(g, w), float((g.float() - w).abs().max())
    if sk_true is not None:
        assert not got[1][:, sk_true:].any() and \
            not got[2][:, sk_true:].any()
    again = ops.flash_attention_bwd(q, k, v, out, lse, dout, causal, sk_true)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_flash_gradients_through_the_function_match_full_attention(cuda):
    """The autograd Function on the card (forward and backward kernels)
    against torch.autograd through ``full_attention``, fp32."""
    from repro_torch.models import attention as attn
    q, k, v = (t.requires_grad_() for t in _flash_inputs(
        cuda, 2, 300, 300, 14, 2, 64, torch.float32, 4))
    g = _flash_inputs(cuda, 2, 300, 300, 14, 14, 64, torch.float32, 5)[0]
    got = torch.autograd.grad(
        ops.flash_attention_fwd(q, k, v, causal=True)[0], (q, k, v), g)
    want = torch.autograd.grad(attn.full_attention(q, k, v, True),
                               (q, k, v), g)
    for a, b in zip(got, want):
        assert testing.grads_close(a, b)


def _kwta_rows(R, N, seed, ties=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (R, N)).astype(np.float32)
    if ties:                        # repeated magnitudes, both signs
        x = np.round(x * 4) / 4
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,N,k,ties", [
    (64, 1024, 580, False), (3, 100, 10, False), (11, 257, 30, False),
    (8, 65536, 6000, False),
    # each path's edges (kwta.plan: a warp a row up to 512, a block of 2-32
    # warps a row up to 16,384, then the row streamed), R not a multiple
    # of the four rows a block of the warp path, k 0 and k N - 1, tied rows
    (1, 1, 0, False), (5, 512, 256, False), (13, 512, 511, True),
    (6, 513, 1, False), (9, 1024, 0, True), (5, 2048, 1000, False),
    (6, 2049, 2048, True), (7, 16384, 16383, False), (5, 16384, 3000, True),
    (3, 16385, 0, False), (2, 70000, 9000, True),
])
def test_kwta_kernel_equals_plain(cuda, R, N, k, ties, dtype):
    from repro_torch.kernels import kwta as kkwta
    x = torch.from_numpy(_kwta_rows(R, N, R + N, ties)).to(
        cuda, getattr(torch, dtype))
    before = kkwta.launches
    got = ops.kwta(x, k)
    torch.cuda.synchronize()
    assert kkwta.launches == before + 1
    assert torch.equal(got, ref.kwta_bisect_ref(x, k))
    assert torch.equal(got.cpu(), ops.kwta(x.cpu(), k))


def _lm(dev, name="qwen2-0.5b", **kw):
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_smoke_config(name), **kw)
    return cfg, lm.init_params(torch.Generator().manual_seed(0), cfg, dev)


def test_prefill_launches_the_flash_kernel_once_a_layer(cuda):
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.models import lm
    from repro_torch.utils import tree_to
    cfg, params = _lm(cuda, attn_chunk=16)
    toks = torch.randint(0, cfg.vocab, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    before = kflash.fwd_f32_sm90_launches
    logits = lm.prefill(params, cfg, {"tokens": toks})
    torch.cuda.synchronize()
    assert kflash.fwd_f32_sm90_launches == before + cfg.n_layers
    cpu = lm.prefill(tree_to(params, "cpu"), cfg, {"tokens": toks})
    np.testing.assert_allclose(logits.cpu().numpy(), cpu.numpy(), rtol=1e-5,
                               atol=1e-5)
    before = kflash.fwd_f32_sm90_launches
    lm.prefill(params, cfg, {"tokens": toks[:, :16]})   # S <= chunk: full
    assert kflash.fwd_f32_sm90_launches == before


def test_mla_decode_in_the_engine_graph_follows_the_cpu(cuda):
    """deepseek-v3's smoke config (fp32, MLA with its bf16 latent cache)
    served by the engine on the card, its decode one CUDA graph
    (``mla_decode`` with the graph's row mask as ``write_rows``), against
    the CPU's eager engine on the same prompts: the tokens tie-aware, the
    logits within 1e-3. Then a replay stepping slot 1 alone at position 7
    leaves every latent row of the other slots the same bits and writes
    slot 1's."""
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.utils import tree_leaves
    cfg, params = _lm("cpu", name="deepseek-v3-671b")
    prompts = [list(range(3 + i, 9 + 2 * i)) for i in range(4)]
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        eng = ServeEngine(cfg, ServeConfig(
            batch_slots=4, max_len=32, eos_token=-1, torch_device=dev,
            keep_logits=True), params)
        reqs = [eng.submit(p, 6) for p in prompts]
        eng.run_until_drained()
        runs[dev.type] = (eng, reqs)
    eng, reqs = runs["cuda"]
    want = runs["cpu"][1]
    assert eng._graph is not None and set(eng.caches["dense"]) == \
        {"c_kv", "k_rope"}
    testing.compare_tokens([r.tokens for r in reqs], [r.tokens for r in want],
                           [torch.stack(r.logits) for r in reqs],
                           [torch.stack(r.logits) for r in want],
                           atol=1e-3).check()
    before = [t.clone() for t in tree_leaves(eng.caches)]
    eng._decode({1: cfg.vocab - 1}, 7)
    torch.cuda.synchronize()
    other = torch.tensor([True, False, True, True], device=cuda)
    after = tree_leaves(eng.caches)
    assert all(torch.equal(a[:, other], b[:, other])
               for a, b in zip(after, before))
    assert any(not torch.equal(a[:, 1, 7], b[:, 1, 7])
               for a, b in zip(after, before))


def _encdec_cache(cfg, params, dev, B, max_len, lens):
    """A seamless decode cache on ``dev`` whose rows hold the cross K/V
    of their first ``lens[row]`` seeded frames (``lm.encode_cross_kv``)."""
    from repro_torch.models import lm
    frames = torch.randn((B, max(lens), cfg.d_model),
                         generator=torch.Generator().manual_seed(2))
    caches = lm.init_cache(cfg, B, max_len, dev, enc_len=max(lens))
    for row, n in enumerate(lens):
        k, v = lm.encode_cross_kv(params, cfg, frames[row:row + 1, :n])
        caches["cross_k"][:, row, :n] = k[:, 0].to(dev)
        caches["cross_v"][:, row, :n] = v[:, 0].to(dev)
        caches["enc_len"][row] = n
    return caches


def test_encdec_decode_captured_in_a_graph_follows_the_cpu(cuda):
    """seamless's smoke decode from a filled cross cache (rows of 8 and 5
    frames), captured once as a CUDA graph with the row mask as
    ``write_rows`` and replayed, against the CPU's eager decode: logits
    within 1e-4 at each of 6 positions; a replay stepping row 1 alone
    leaves row 0's self cache the same bits, and no replay writes the
    cross cache or ``enc_len``."""
    from repro_torch.models import lm
    from repro_torch.utils import tree_to
    cfg, params = _lm("cpu", name="seamless-m4t-medium")
    card = tree_to(params, cuda)
    caches = {"cpu": _encdec_cache(cfg, params, "cpu", 2, 8, (8, 5))}
    caches["cuda"] = tree_to(caches["cpu"], cuda)
    cross = {n: caches["cuda"][n].clone()
             for n in ("cross_k", "cross_v", "enc_len")}
    toks = torch.zeros((2, 1), dtype=torch.int64, device=cuda)
    pos = torch.zeros((), dtype=torch.int64, device=cuda)
    rows = torch.ones(2, dtype=torch.bool, device=cuda)
    step = lambda: lm.decode_step(card, cfg, caches["cuda"], toks, pos,
                                  write_rows=rows)[0]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    rows.zero_()
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        logits = step()
    rows.fill_(True)
    seq = torch.randint(0, cfg.vocab, (2, 6),
                        generator=torch.Generator().manual_seed(3))
    for t in range(6):
        toks.copy_(seq[:, t:t + 1])
        pos.fill_(t)
        graph.replay()
        want, _ = lm.decode_step(params, cfg, caches["cpu"], seq[:, t:t + 1],
                                 t)
        np.testing.assert_allclose(logits.cpu().numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-4)
    before = {k: v.clone() for k, v in caches["cuda"]["self"].items()}
    rows.copy_(torch.tensor([False, True]))
    pos.fill_(6)
    graph.replay()
    torch.cuda.synchronize()
    for k, v in caches["cuda"]["self"].items():
        assert torch.equal(v[:, 0], before[k][:, 0])
        assert not torch.equal(v[:, 1, 6], before[k][:, 1, 6])
    for n, t in cross.items():
        assert torch.equal(caches["cuda"][n], t), n


@pytest.mark.parametrize("name", ["seamless-m4t-medium", "llava-next-34b"])
def test_multimodal_engine_graph_follows_the_cpu(cuda, name):
    """The engine on the card (its decode a CUDA graph; seamless over the
    empty cross memory of ``init_cache``, captured with zero-size cross
    tensors; llava text-only through its int8 cache) against the CPU's
    eager engine on the same prompts: tokens tie-aware, logits within
    1e-4."""
    from repro_torch.serve import ServeConfig, ServeEngine
    cfg, params = _lm("cpu", name)
    prompts = [list(range(2 + i, 8 + 2 * i)) for i in range(4)]
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        eng = ServeEngine(cfg, ServeConfig(
            batch_slots=3, max_len=32, eos_token=-1, torch_device=dev,
            keep_logits=True), params)
        reqs = [eng.submit(p, 6) for p in prompts]
        eng.run_until_drained()
        runs[dev.type] = reqs
        if dev.type == "cuda":
            assert eng._graph is not None
    testing.compare_tokens([r.tokens for r in runs["cuda"]],
                           [r.tokens for r in runs["cpu"]],
                           [r.logits for r in runs["cuda"]],
                           [r.logits for r in runs["cpu"]], atol=1e-4)


def test_multimodal_prefill_launches_the_flash_kernel_a_call(cuda):
    """seamless's smoke prefill with ``attn_chunk`` 4 below 12 frames and
    10 tokens: one fp32 flash forward for each encoder, decoder and cross
    attention (6), logits within 1e-5 of the CPU's; llava's with its 8
    patches before 12 tokens past chunk 16: one a layer."""
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.models import lm
    from repro_torch.utils import tree_to
    for name, chunk, n_prefix, want in (("seamless-m4t-medium", 4, 12, 6),
                                        ("llava-next-34b", 16, 8, 2)):
        cfg, params = _lm(cuda, name, attn_chunk=chunk)
        g = torch.Generator().manual_seed(4)
        key = "frames" if cfg.is_encoder_decoder else "patches"
        batch = {"tokens": torch.randint(0, cfg.vocab, (2, 10 + 2 * (
            key == "patches")), generator=g),
                 key: torch.randn((2, n_prefix, cfg.d_model), generator=g)}
        before = kflash.fwd_f32_sm90_launches
        logits = lm.prefill(params, cfg, batch)
        torch.cuda.synchronize()
        assert kflash.fwd_f32_sm90_launches == before + want
        cpu = lm.prefill(tree_to(params, "cpu"), cfg, batch)
        np.testing.assert_allclose(logits.cpu().numpy(), cpu.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_trainer_on_the_card_follows_the_cpu(cuda):
    """Three Trainer steps of a small fp32 config (flash branch on every
    step: 40 tokens against ``attn_chunk`` 16) on the card and on the CPU
    from the same params and batches: the losses and grad norms agree at
    rtol 1e-5 and the final params' distance is within 1e-3 of the CPU
    update's norm (Adam's normalised steps can turn a last-bit difference
    in a near-zero gradient into a whole step, so no elementwise bound);
    each step launches the flash forward twice a layer (remat), the dq
    and dk/dv kernels once a layer."""
    from repro_torch.data.pipeline import ShardedBatcher
    from repro_torch.data.synthetic import lm_token_batch
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.utils import tree_leaves, tree_to
    cfg, params = _lm("cpu", attn_chunk=16)
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        tr = Trainer(cfg, TrainConfig(warmup_steps=0, log_every=1000),
                     ShardedBatcher(lambda rng, s: lm_token_batch(
                         rng, 2, 40, cfg.vocab)),
                     params=tree_to(params, dev), device=dev)
        before = (kflash.fwd_f32_sm90_launches, kflash.dq_launches, kflash.dkv_launches)
        hist = tr.run(steps=3)
        torch.cuda.synchronize()
        after = (kflash.fwd_f32_sm90_launches, kflash.dq_launches, kflash.dkv_launches)
        runs[dev.type] = (hist, tree_to(tr.params, "cpu"),
                          [a - b for a, b in zip(after, before)])
    (hc, pc, lc), (hh, ph, lh) = runs["cuda"], runs["cpu"]
    L = cfg.n_layers
    assert lc == [2 * L * 3, L * 3, L * 3] and lh == [0, 0, 0]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in hc],
                                   [h[key] for h in hh], rtol=1e-5)
    d2 = sum(float(((a - b).double() ** 2).sum())
             for a, b in zip(tree_leaves(pc), tree_leaves(ph)))
    u2 = sum(float(((b - p0).double() ** 2).sum())
             for b, p0 in zip(tree_leaves(ph), tree_leaves(params)))
    assert (d2 / u2) ** 0.5 <= 1e-3, (d2 / u2) ** 0.5


def test_lm_engine_batch_composition_on_the_card(cuda):
    """Each request decodes the same tokens alone as in a burst, in any
    slot, on the card."""
    from repro_torch.serve import ServeConfig, ServeEngine
    cfg, params = _lm(cuda, dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, rng.integers(2, 12)).tolist()
               for _ in range(10)]

    def serve(traffic):
        eng = ServeEngine(cfg, ServeConfig(batch_slots=4, max_len=32,
                                           eos_token=-1, torch_device=cuda),
                          params)
        reqs = [eng.submit(p, max_new=8) for p in traffic]
        eng.run_until_drained()
        return [r.tokens for r in reqs]

    burst = serve(prompts)
    assert all(len(t) == 8 for t in burst)
    for i in (0, 5, 9):
        assert serve([prompts[i]]) == [burst[i]]


@pytest.mark.parametrize("B", [64, 32])
def test_scan_gradients_through_the_kernel_equal_the_plain_forwards(cuda, B):
    """The fused scan's straight-through gradients with the kernel
    forward equal, bit for bit, those of the same backward on the plain
    forward's residuals (which equal the kernel's), at (B, 28, 100)."""
    rng = np.random.default_rng(B)
    H, T = 100, 28
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)
    inp = dict(drive=f(rng.normal(0, 0.6, (B, T, H))),
               u_h=f(rng.uniform(-0.17, 0.17, (H, H))),
               h0=f(rng.uniform(-0.5, 0.5, (B, H))),
               b_h=f(rng.normal(0, 0.1, H)))
    kw = dict(beta=0.8, lam=0.5, n_bits=8, adc_bits=8, adc_range=4.0,
              weight_scale=1.5)
    leaves = {k: v.clone().requires_grad_(True) for k, v in inp.items()}
    before = kscan.launches
    outs = ops.wbs_miru_scan(**leaves, **kw)
    assert kscan.launches == before + 1
    cts = [f(rng.normal(size=(B, T, H))) for _ in range(3)]
    got = torch.autograd.grad(outs, [leaves[k] for k in
                                     ("drive", "u_h", "h0", "b_h")], cts)
    with torch.no_grad():
        plain = ref.wbs_miru_scan_ref(inp["drive"], inp["u_h"] / 1.5,
                                      inp["h0"], inp["b_h"], 0.8, 0.5, 8, 8,
                                      4.0, 1.5)
        want = ops.wbs_miru_scan_bwd(inp["u_h"], plain[1], plain[2], *cts,
                                     beta=0.8, lam=0.5)
    torch.cuda.synchronize()
    for a, b in zip(outs, plain):
        assert torch.equal(a.detach(), b)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_adam_step_on_wbs_on_the_card_follows_the_cpu(cuda):
    """One Adam step of the Fig. 4 protocol on ``wbs`` at the paper's
    width, on the card and on the CPU from the same state (three CPU
    steps in): the forward is bitwise (kernel == plain), the backward's
    products cuBLAS's, so loss, params and moments agree at fp32
    tolerance; the step launches the drive, the scan and the readout
    once each."""
    from repro_torch import prng
    from repro_torch.core import continual
    from repro_torch.data.synthetic import make_permuted_tasks
    from repro_torch.utils import tree_to
    cfg = MiRUConfig(n_x=28, n_h=100, n_y=10)
    tasks = make_permuted_tasks(0, n_tasks=1, n_train=256, n_test=8)
    tr = continual.TrainerSpec(algo="adam", batch_size=32)
    sched = continual.build_batch_schedule(
        tr, continual.ReplaySpec(capacity=32), tasks)
    step, _, opt = continual._make_raw_steps(cfg, tr, get_backend("wbs"))
    key, params, _, _ = continual._init_run(cfg, tr, get_backend("wbs"),
                                            "cpu")
    state = opt.init(params)
    x, y = torch.from_numpy(sched.x[0]), torch.from_numpy(sched.y[0])
    with torch.no_grad():
        for s in range(3):
            key, k = prng.split(key)
            params, state, _, _, _ = step(params, state, k, x[s], y[s], None)
        key, k = prng.split(key)
        cpu = step(params, state, k, x[3], y[3], None)
        before = (kmatmul.launches, kscan.launches, kreadout.launches)
        card = step(tree_to(params, cuda), tree_to(state, cuda), k,
                    x[3].to(cuda), y[3].to(cuda), None)
        torch.cuda.synchronize()
    after = (kmatmul.launches, kscan.launches, kreadout.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    np.testing.assert_allclose(float(card[2]), float(cpu[2]), rtol=2e-5)
    for k_ in cpu[0]:
        np.testing.assert_allclose(card[0][k_].cpu().numpy(),
                                   cpu[0][k_].numpy(), rtol=2e-5, atol=1e-6,
                                   err_msg=k_)
        np.testing.assert_allclose(card[1][0].mu[k_].cpu().numpy(),
                                   cpu[1][0].mu[k_].numpy(), rtol=2e-5,
                                   atol=1e-6, err_msg=k_)


@pytest.mark.parametrize("n_classes", [None, 10])
def test_loss_aware_insert_on_the_card_equals_the_cpu(cuda, n_classes):
    """The in-graph buffer's inserts on CUDA tensors leave the bits the
    same inserts leave on CPU tensors: codes, labels, priorities, size."""
    from repro_torch import prng
    from repro_torch.replay import ingraph
    rng = np.random.default_rng(3)
    states = {d: ingraph.ingraph_init(32, (28, 28), 4, d)
              for d in ("cpu", cuda)}
    for r in range(6):
        xs = rng.uniform(0, 1, (32, 28, 28)).astype(np.float32)
        ys = rng.integers(0, 10, 32).astype(np.int32)
        pr = rng.exponential(1.0, 32).astype(np.float32)
        valid = rng.uniform(size=32) < 0.75
        for d in states:
            states[d] = ingraph.ingraph_insert(
                states[d], prng.PRNGKey(r), torch.from_numpy(xs).to(d),
                torch.from_numpy(ys).to(d), torch.from_numpy(pr).to(d), 4,
                valid=torch.from_numpy(valid).to(d), decay=0.9,
                n_classes=n_classes)
    torch.cuda.synchronize()
    for k, v in states["cpu"].items():
        assert torch.equal(states[cuda][k].cpu(), v), k
    assert int(states["cpu"]["size"]) == 32


@pytest.mark.parametrize("trainer", ["adam", "dfa", "dfa_hw"])
def test_continual_config_runs_on_the_card(cuda, trainer):
    """The legacy ``ContinualConfig`` (deprecated, it warns) runs each of
    its trainer strings on the card."""
    from repro_torch.core import continual
    from repro_torch.data.synthetic import make_permuted_tasks
    tasks = make_permuted_tasks(0, n_tasks=2, n_train=64, n_test=16)
    ccfg = continual.ContinualConfig(trainer=trainer, batch_size=16,
                                     replay_capacity=16)
    with pytest.warns(DeprecationWarning):
        out = continual.run_continual(MiRUConfig(n_x=28, n_h=100, n_y=10),
                                      ccfg, tasks, torch_device=cuda)
    assert np.isfinite(out["losses"]).all() and out["R"].shape == (2, 2)


@pytest.mark.parametrize("name,algo", [("ideal", "dfa"), ("wbs", "dfa"),
                                       ("analog_state", "dfa"),
                                       ("wbs", "adam")])
def test_compiled_run_equals_the_loop_on_the_card(cuda, name, algo):
    """``run_compiled`` on the card: R, losses, params, the RunLog and the
    write counters bit for bit ``run_continual``'s, each run through its
    path's kernel: the fused scan on ``wbs``, the per-step WBS product
    on ``analog_state`` (its pair read has no fused path), the readout
    on ``ideal``."""
    from repro_torch.core import continual
    from repro_torch.obs import ObsSpec
    from repro_torch.scenarios import (build_scenario, run_compiled,
                                       scenario_miru_config)
    tasks = build_scenario("permuted", 0, n_tasks=2, n_train=96, n_test=64)
    cfg = scenario_miru_config(tasks, n_h=100)
    trainer = continual.TrainerSpec(algo=algo, epochs_per_task=2,
                                    batch_size=32)
    kernel = {"ideal": kreadout, "wbs": kscan, "analog_state": kmatmul}[name]
    runs, snaps = [], []
    for run in (continual.run_continual, run_compiled):
        backend = get_backend(name, spec_overrides=dict(track_endurance=True))
        backend.telemetry.enable()
        before = kernel.launches
        runs.append(run(cfg, trainer, tasks,
                        replay=continual.ReplaySpec(capacity=64),
                        device=backend, obs=ObsSpec(cadence=5),
                        torch_device=cuda))
        torch.cuda.synchronize()
        assert kernel.launches > before
        snaps.append({k: v for k, v in backend.telemetry.snapshot().items()
                      if k.startswith(("write_", "drift_"))})
        snaps[-1]["updates"] = backend.tracker.updates_applied
    loop, comp = runs
    assert np.array_equal(loop["R"], comp["R"])
    assert loop["losses"] == comp["losses"]
    for k in loop["params"]:
        assert torch.equal(loop["params"][k], comp["params"][k]), k
    for f in ("loss", "write_pulses", "dg_mag", "replay_occupancy",
              "drift_ticks"):
        assert np.array_equal(getattr(loop["runlog"], f),
                              getattr(comp["runlog"], f)), f
    assert snaps[0] == snaps[1]


@pytest.mark.parametrize("name", ["ideal", "wbs", "analog_state"])
def test_zero_rate_faults_change_no_bit_on_the_card(cuda, name):
    """A zero-rate FaultSpec through ``run_compiled`` on the card: R,
    losses and params bit for bit the run without one."""
    from repro_torch.core import continual
    from repro_torch.faults import FaultSpec
    from repro_torch.scenarios import (build_scenario, run_compiled,
                                       scenario_miru_config)
    tasks = build_scenario("permuted", 0, n_tasks=2, n_train=96, n_test=64)
    cfg = scenario_miru_config(tasks, n_h=100)
    trainer = continual.TrainerSpec(algo="dfa", epochs_per_task=1)
    runs = [run_compiled(cfg, trainer, tasks,
                         replay=continual.ReplaySpec(capacity=64),
                         device=get_backend(name, spec_overrides=dict(
                             faults=f)), torch_device=cuda)
            for f in (None, FaultSpec())]
    assert np.array_equal(runs[0]["R_full"], runs[1]["R_full"])
    assert runs[0]["losses"] == runs[1]["losses"]
    for k, v in runs[0]["params"].items():
        assert torch.equal(v, runs[1]["params"][k]), k


def test_fused_equals_per_step_under_masks_on_the_card(cuda):
    """At 1 % stuck cells the masked forward stays on the fused scan (one
    launch), bit for bit the per-step path (2·T ``wbs_matmul``) and the
    CPU's forward from the same masks."""
    from repro_torch import prng
    from repro_torch.backends import DeviceSpec
    from repro_torch.faults import FaultSpec
    cfg = MiRUConfig(n_x=28, n_h=100, n_y=10)
    be = get_backend("wbs", spec=DeviceSpec(
        input_bits=8, adc_bits=8, weight_clip=1.0,
        faults=FaultSpec(sa0_rate=0.005, sa1_rate=0.005)))
    params = init_miru_params(prng.PRNGKey(0), cfg, cuda)
    st = be.init_device_state(params, prng.PRNGKey(5))
    x = torch.rand(32, 28, 28, generator=torch.Generator().manual_seed(0))
    xd = x.to(cuda)
    with torch.no_grad():
        s0 = kscan.launches
        fused = be.device_recurrence(params, cfg, xd, prng.PRNGKey(3),
                                     state=st)
        torch.cuda.synchronize()
        assert kscan.launches == s0 + 1
        m0 = kmatmul.launches
        step = be.device_recurrence(params, cfg, xd, prng.PRNGKey(3),
                                    state=st, fused=False)
        torch.cuda.synchronize()
        assert kmatmul.launches == m0 + 2 * 28 and kscan.launches == s0 + 1
        cpu = be.device_recurrence(
            {k: v.cpu() for k, v in params.items()}, cfg, x,
            prng.PRNGKey(3), state={"_faults": {
                n: {k: v.cpu() for k, v in t.items()}
                for n, t in st["_faults"].items()}})
    for a, b, c in zip(fused, step, cpu):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)


def test_march_recovers_the_stuck_map_on_the_card(cuda):
    """The march self-test on the card: the exact effective stuck map of
    every tile (spares remapped), two ``wbs_matmul`` launches a tile,
    the values the CPU's."""
    from repro_torch import prng
    from repro_torch.backends import DeviceSpec
    from repro_torch.faults import (FaultSpec, effective_masks,
                                    march_recover, remap_columns)
    cfg = MiRUConfig(n_x=28, n_h=100, n_y=10)
    be = get_backend("wbs", spec=DeviceSpec(
        input_bits=8, adc_bits=8, weight_clip=1.0, faults=FaultSpec(
            sa0_rate=0.02, sa1_rate=0.02, dead_row_rate=0.02,
            dead_col_rate=0.02, n_spare_cols=4)))
    params = init_miru_params(prng.PRNGKey(0), cfg, cuda)
    st = be.init_device_state(params, prng.PRNGKey(7))
    st = {"_faults": remap_columns(st["_faults"])}
    before = kmatmul.launches
    rec = march_recover(be, params, st)
    torch.cuda.synchronize()
    assert kmatmul.launches == before + 2 * len(rec)
    cpu = march_recover(be, {k: v.cpu() for k, v in params.items()},
                        {"_faults": {n: {k: v.cpu() for k, v in t.items()}
                                     for n, t in st["_faults"].items()}})
    for n, tile in st["_faults"].items():
        assert torch.equal(rec[n]["stuck"], effective_masks(tile)[0]), n
        assert torch.equal(rec[n]["value"].cpu(), cpu[n]["value"]), n


# ---------------------------------------------------------------------------
# The moe, ssm and hybrid families on the card
# ---------------------------------------------------------------------------

def test_moe_ffn_on_the_card_is_run_to_run_bitwise_and_follows_the_cpu(
        cuda):
    """The MoE combine gathers each token's K slots and sums them in a
    fixed order: two calls give the same bits; against the CPU at fp32
    tolerance (rtol 2e-5, atol 1e-6), with a capacity that drops slots."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.utils import tree_to
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"),
                              dtype=torch.float32)
    p = moe.init_moe_params(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.randn(2, 300, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    pc = tree_to(p, cuda)
    a, b = (moe.moe_ffn(pc, cfg, x.to(cuda)) for _ in range(2))
    assert torch.equal(a, b)
    np.testing.assert_allclose(a.cpu().numpy(),
                               moe.moe_ffn(p, cfg, x).numpy(), rtol=2e-5,
                               atol=1e-6)


def test_int8_cache_on_the_card_equals_the_cpu(cuda):
    """Codes, scales and the dequantised K/V bit for bit the CPU's on the
    same k/v (the draws are the same bits, kept on the card)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import attention as attn
    cfg = get_smoke_config("jamba-1.5-large-398b")
    gen = torch.Generator().manual_seed(2)
    kvd = cfg.n_kv_heads * cfg.hd()
    caches = {d: attn.init_kv_cache(cfg, attn.CacheSpec(4, 6, "int8"), d)
              for d in ("cpu", cuda)}
    for pos in range(3):
        k, v = (torch.randn(4, 1, kvd, generator=gen) for _ in range(2))
        for d, c in caches.items():
            attn.cache_insert(c, k.to(d), v.to(d), pos,
                              write_rows=torch.tensor([0, 3], device=d))
    for key, t in caches[cuda].items():
        assert torch.equal(t.cpu(), caches["cpu"][key]), key
    for a, b in zip(attn.cache_read(caches[cuda]),
                    attn.cache_read(caches["cpu"])):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("name,kw", [
    ("granite-moe-3b-a800m", {}), ("mamba2-370m", {}),
    ("jamba-1.5-large-398b", {"kv_cache_dtype": "int8"})])
def test_engine_cuda_graph_follows_the_cpu(cuda, name, kw):
    """The engine's decode, captured once as a CUDA graph and replayed,
    against the CPU's eager engine on the same burst: tokens tie-aware,
    logits within 1e-4 (fp32)."""
    from repro_torch.serve import ServeConfig, ServeEngine
    cfg, params = _lm("cpu", name, **kw)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab, rng.integers(2, 10)).tolist()
               for _ in range(6)]
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        eng = ServeEngine(cfg, ServeConfig(batch_slots=3, max_len=32,
                                           eos_token=-1, torch_device=dev,
                                           keep_logits=True), params)
        reqs = [eng.submit(p, max_new=6) for p in prompts]
        eng.run_until_drained()
        runs[dev.type] = reqs
        if dev.type == "cuda":
            assert eng._graph is not None
    testing.compare_tokens([r.tokens for r in runs["cuda"]],
                           [r.tokens for r in runs["cpu"]],
                           [r.logits for r in runs["cuda"]],
                           [r.logits for r in runs["cpu"]], atol=1e-4)


def test_mamba2_engine_batch_composition_on_the_card(cuda):
    """A mamba2 request decodes the same tokens alone as in a burst, on
    the card (``write_rows`` keeps the other slots' SSM state; admission
    clears a reused slot's)."""
    from repro_torch.serve import ServeConfig, ServeEngine
    cfg, params = _lm(cuda, "mamba2-370m", dtype=torch.bfloat16)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab, rng.integers(2, 12)).tolist()
               for _ in range(8)]

    def serve(traffic):
        eng = ServeEngine(cfg, ServeConfig(batch_slots=3, max_len=32,
                                           eos_token=-1, torch_device=cuda),
                          params)
        reqs = [eng.submit(p, max_new=6) for p in traffic]
        eng.run_until_drained()
        return [r.tokens for r in reqs]

    burst = serve(prompts)
    for i in (0, 4, 7):
        assert serve([prompts[i]]) == [burst[i]]


def _metered_engine(dev, cfg, params, name, **kw):
    from repro_torch.serve import ServeConfig, ServeEngine
    return ServeEngine(cfg, ServeConfig(batch_slots=3, max_len=32,
                                        eos_token=-1, torch_device=dev,
                                        device=name, meter=True, **kw),
                       params)


def test_metered_graph_engine_counts_as_the_eager_engine(cuda):
    """A quantized engine's decode as a CUDA graph: the capture (and its
    warm-up run) meters nothing, each replay adds one call's counts, and
    the burst's counters equal the CPU's eager engine's on the same
    traffic, and the hand count (7 quantized projections a layer, 3
    rows each, a decode call). Its tokens follow the CPU's, tie-aware at
    1e-2: the products are bitwise, but a last-bit difference elsewhere
    can flip an input code, and one flipped code moves these logits (up
    to 0.45) by up to 2.6e-3 (measured on the CPU)."""
    from repro_torch.backends import register_backend, unregister_backend
    from repro_torch.backends.wbs import WBSBackend
    name = "wbs_graph_meter_test"
    cfg, params = _lm("cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab, rng.integers(2, 10)).tolist()
               for _ in range(6)]
    register_backend(name, WBSBackend)
    try:
        eng = _metered_engine(cuda, cfg, params, name)
        eng.telemetry.reset()
        eng._capture()
        assert eng.telemetry.snapshot() == {}
        D, Fd, hd = cfg.d_model, cfg.d_ff, cfg.hd()
        q, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
        macs = 3 * cfg.n_layers * (D * q + 2 * D * kv + q * D + 3 * D * Fd)
        assert eng._graph_counts["macs/dense"] == macs
        runs, counts = {}, {}
        for dev in (cuda, torch.device("cpu")):
            eng = _metered_engine(dev, cfg, params, name, keep_logits=True)
            eng.telemetry.reset()
            reqs = [eng.submit(p, max_new=6) for p in prompts]
            eng.run_until_drained()
            runs[dev.type], counts[dev.type] = reqs, eng.telemetry.snapshot()
            assert counts[dev.type]["macs/dense"] == eng.decode_calls * macs
        assert counts["cuda"] == counts["cpu"]
        testing.compare_tokens([r.tokens for r in runs["cuda"]],
                               [r.tokens for r in runs["cpu"]],
                               [r.logits for r in runs["cuda"]],
                               [r.logits for r in runs["cpu"]], atol=1e-2)
    finally:
        unregister_backend(name)


@pytest.mark.parametrize("name,extra", [("qwen2-0.5b", 0),
                                        ("internlm2-1.8b", 1)])
def test_quantized_prefill_launches_the_crossbar_kernel_a_projection(
        cuda, name, extra):
    """Every quantized projection one ``wbs_matmul`` launch: seven a
    layer, plus the head where it is untied (internlm2); the logits
    follow the CPU's within a few flipped input codes' moves (one moves
    smoke logits by up to 2.6e-3)."""
    from repro_torch.models import lm
    from repro_torch.utils import tree_to
    cfg, params = _lm(cuda, name, quant_mode="wbs")
    toks = torch.randint(0, cfg.vocab, (2, 12),
                         generator=torch.Generator().manual_seed(1))
    before = kmatmul.launches
    logits = lm.prefill(params, cfg, {"tokens": toks})
    torch.cuda.synchronize()
    assert kmatmul.launches == before + 7 * cfg.n_layers + extra
    cpu = lm.prefill(tree_to(params, "cpu"), cfg, {"tokens": toks})
    np.testing.assert_allclose(logits.cpu().numpy(), cpu.numpy(), rtol=0,
                               atol=1e-2)


def test_miru_mixer_launches_its_kernels(cuda):
    """The float miru mixer: one ``miru_scan`` launch a layer at H =
    d_model; the quantized one: two ``wbs_matmul`` a step and four more a
    layer (w_out, the SwiGLU three)."""
    from repro_torch.models import lm
    from repro_torch.utils import tree_to
    for quant, S in (("none", 9), ("wbs", 5)):
        cfg, params = _lm(cuda, mixer="miru", quant_mode=quant)
        toks = torch.randint(0, cfg.vocab, (1, S),
                             generator=torch.Generator().manual_seed(2))
        before = (kmiru.launches, kmatmul.launches)
        logits = lm.prefill(params, cfg, {"tokens": toks})
        torch.cuda.synchronize()
        want = (cfg.n_layers, 0) if quant == "none" \
            else (0, cfg.n_layers * (2 * S + 4))
        assert (kmiru.launches - before[0],
                kmatmul.launches - before[1]) == want
        cpu = lm.prefill(tree_to(params, "cpu"), cfg, {"tokens": toks})
        np.testing.assert_allclose(logits.cpu().numpy(), cpu.numpy(),
                                   rtol=0, atol=1e-4 if quant == "none"
                                   else 1e-2)
