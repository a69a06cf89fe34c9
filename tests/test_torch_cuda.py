"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips (the
decision is made in the ``cuda`` fixture, at run time, so every pytest
worker collects the same tests). Run them on a GPU machine with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_*.py``.

The plain versions repeat the kernels' arithmetic (summation order,
float64 tanh), so the kernels must match them bit for bit.
"""
import numpy as np
import pytest
import torch

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
                                   (5, 37, 13), (16, 300, 40), (8, 256, 256)])
def test_wbs_matmul_kernel_equals_plain(cuda, m, k, n, adc_bits):
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


@pytest.mark.parametrize("adc_bits", [8, None])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,t,h", [(64, 14, 100), (64, 14, 256), (3, 5, 37),
                                   (9, 3, 128), (8, 2, 1024)])
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
    with pytest.raises(ValueError, match="multiple"):
        kmatmul.wbs_matmul(sign[:5], code[:5], w, g)
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
    for m in (1, 14, 200, 896):
        assert torch.equal(ops.miru_readout(h[:m].contiguous(), w, b),
                           full[:m])


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
        w_p = ops.pad_wbs_weights(w)
        for adc_bits in (8, None):
            a = kmatmul.wbs_matmul_read_noise(sign, code, w_p, g, 0.0,
                                              (1, 2), n_cols=n,
                                              adc_bits=adc_bits)
            b = kmatmul.wbs_matmul(sign, code, w_p, g, adc_bits)
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
