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
_FLASH_COUNTERS = ("launches", "fwd_sm90_launches", "dq_launches",
                   "dq_sm90_launches", "dkv_launches", "dkv_sm90_launches")
_FWD_COUNTER = {"float32": "launches", "bfloat16": "fwd_sm90_launches"}
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,Kh,dh,causal,sk_true", [
    (2, 2048, 2048, 14, 2, 64, True, None),   # the qwen2-0.5B train step
    (1, 100, 333, 4, 2, 64, False, 250),      # Sq != Sk, padded keys
    (1, 300, 300, 14, 2, 64, True, None),     # rep 7, Sk off the tiles
    (2, 130, 130, 4, 4, 64, True, None),      # rep 1
    (1, 96, 200, 4, 1, 80, False, 150),       # head dim 80, padded to 128
    (1, 70, 70, 4, 2, 128, True, None),       # head dim 128
    (1, 300, 333, 14, 2, 128, False, 300),    # head dim 128, rep 7, sk_true
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
    """The tensor-core forward (bf16; fp32 takes the CUDA-core one), dq (a
    block owns its rows) and dk/dv (its rep partials folded in a fixed
    order, no atomics) of the dtype give the same bits on every call: the
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
    with pytest.raises(ValueError, match="D must be one of"):
        kflash.flash_attention_fwd_sm90(q, k, v, **kw)
    with pytest.raises(ValueError, match="D must be one of"):
        kflash.flash_attention_bwd_dkv_sm90(q, k, v, q, lse, lse, **kw)
    with pytest.raises(ValueError, match="D must be one of"):
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
    with pytest.raises(ValueError, match="exceed"):  # dh 192 > 128
        ops.flash_attention_fwd(*_flash_inputs(cuda, 1, 16, 16, 2, 1, 192,
                                               bf, 14))
    with pytest.raises(TypeError):
        q, k, v = _flash_inputs(cuda, 1, 16, 16, 2, 1, 64, bf, 15)
        ops.flash_attention_fwd(q, k.float(), v)
    assert _flash_launches() == before


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,N,k", [(64, 1024, 580), (3, 100, 10),
                                   (11, 257, 30), (8, 65536, 6000)])
def test_kwta_kernel_equals_plain(cuda, R, N, k, dtype):
    from repro_torch.kernels import kwta as kkwta
    rng = np.random.default_rng(R + N)
    x = torch.from_numpy(rng.normal(0, 1, (R, N)).astype(np.float32)).to(
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
    before = kflash.launches
    logits = lm.prefill(params, cfg, {"tokens": toks})
    torch.cuda.synchronize()
    assert kflash.launches == before + cfg.n_layers
    cpu = lm.prefill(tree_to(params, "cpu"), cfg, {"tokens": toks})
    np.testing.assert_allclose(logits.cpu().numpy(), cpu.numpy(), rtol=1e-5,
                               atol=1e-5)
    before = kflash.launches
    lm.prefill(params, cfg, {"tokens": toks[:, :16]})   # S <= chunk: full
    assert kflash.launches == before


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
        before = (kflash.launches, kflash.dq_launches, kflash.dkv_launches)
        hist = tr.run(steps=3)
        torch.cuda.synchronize()
        after = (kflash.launches, kflash.dq_launches, kflash.dkv_launches)
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
