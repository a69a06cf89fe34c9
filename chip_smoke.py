#!/usr/bin/env python3
"""Drive the PyTorch port's MiRU serving and training paths, the analog
substrates and the Table I metering on one NVIDIA GPU, and check them.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. device: the card's name and count, and ``nvidia-smi``'s name and power
   limit;
2. build: the four CUDA libraries compiled by nvcc for sm_90a from
   ``src/repro_torch/kernels/csrc/``, one nvcc each, all at once;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main paths' shapes: bitwise for the recurrences, the readout and
   the read-noise WBS product, tie-aware (rtol = atol = 2e-5) for the WBS
   product; the read-noise variant also at σ = 0 against the plain
   kernel (bitwise), on two identical rows of one call (identical
   outputs), and in its moments over 512 keys;
4. serve: the paper's 28×100×10 network (``configs/m2ru_paper.py``) with
   seeded random weights, served through ``RecurrentServeEngine`` on the
   ``wbs`` substrate (64 slots, chunk 14) for a 256-request burst over 96
   users with 28 frames each; the launch counters are zeroed just before
   and read just after, and the served logits are held against the same
   traffic served by the port on the CPU; a second, traced run of the
   burst gives the device's busy time and its share of the untraced
   run's wall time;
5. contracts: fused equals per-step bit for bit; batch composition, slot
   permutation and a one-slot engine serve the 64-slot engine's bits;
   ``analog_state`` at zero device noise is the ``analog`` program bit
   for bit (R, params, losses, counters, write maps);
6. train: (a) the software DFA step through the fused float recurrence
   (``dfa_grads(use_fused=True)`` + ``sgd_kwta_update``, batch 64, 400
   steps, as ``examples/quickstart.py``), held against the same 400
   steps run by the port on the CPU (every loss, the final params and
   the test accuracy); (b) the Fig. 4 protocol (``run_continual``, DFA,
   reservoir replay of 512, 3 permuted tasks, 14 epochs a task, batch
   32) on ``ideal`` and ``wbs``, and (c) on ``analog`` (Fig. 4's
   ``dfa_hw``), held to the reference's accuracy bands and to the port's
   own CPU run of the same protocol: the leading steps' losses
   (``LOSS_AGREE_STEPS``) and the R matrix (``R_TOLERANCE``); (d)
   ``analog`` with per-access read noise (``CrossbarSpec(read_sigma=0.10,
   write_sigma=0.10, w_clip=1.5)``) on one task at the same settings:
   56 read-noise launches a forward, accuracy above chance, the leading
   losses against a CPU run of its first epoch, which draws the same
   noise;
7. table1: the metered runs of ``benchmarks/table1_throughput.py``
   (``analog_state`` and ``cmos``, 2 tasks × 320 examples, 2 epochs,
   reservoir 64, endurance tracked): the reference's Table I bands, the
   metered figures within 5 % of the analytical model, and the
   shape-determined counters equal to the port's CPU run of the same
   work;
8. times: CUDA-event timings of each kernel, its plain version and,
   where one exists, one PyTorch call computing the same function, each
   over a CUDA graph of repeated launches, beside the least time the
   card could take.

The CPU runs that the card's results are held against (the twins) run
at the start, in :data:`TWIN_WORKERS` worker processes of one thread
each, beside the card's phases; each phase waits for its twin's result.

Then the ``kernels`` line, the ``nvidia-smi`` line, and the final
``{"ok": true, ...}`` line. Any failure exits non-zero before the final
line; without a CUDA device the script exits 2 and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# The paper network (configs/m2ru_paper.py PAPER_CONFIG) and the serve
# width of benchmarks/serve_bench.py.
N_X, N_H, N_Y, BETA, LAM = 28, 100, 10, 0.8, 0.5
SLOTS, CHUNK, FRAMES = 64, 14, 28
N_REQUESTS, N_USERS = 256, 96
N_BITS, ADC_BITS, ADC_RANGE, W_SCALE = 8, 8, 4.0, 1.5   # wbs default_spec
T_SEQ = 28                     # rows of a 28×28 permuted image
# Train (a), examples/quickstart.py: batch 64, 400 steps, 800/300 examples.
SW_BATCH, SW_STEPS, SW_TRAIN, SW_TEST = 64, 400, 800, 300
# Train (b), the DFA settings of tests/test_continual.py (Fig. 4).
CL_TASKS, CL_TRAIN, CL_TEST, CL_EPOCHS, CL_BATCH, CL_CAPACITY = \
    3, 500, 200, 14, 32, 512
# Parity of the training paths with the port's own CPU run of the same
# work. Both sides start from the same state and batches and run the same
# kernel arithmetic (kernel == plain, bit for bit); only the products and
# contractions left to cuBLAS and the CPU's BLAS sum in other orders. So
# the losses agree to fp32 rounding, step by step, until a quantizer code
# or a ζ selection flips on a last-bit difference, and from there the runs
# drift apart like two seeds. Measured on an H100 with
# tools/parity_reach.py, where faults planted on the card side show what
# each check can see:
#
# - train (a): all 400 losses within 2.3e-7 relative, the final params
#   within 2.4e-7 (a CPU run at 2 threads: 1.8e-6 and 5.9e-5); with h_t
#   handed to DFA in place of h_{t-1}, 14 steps agree and the params end
#   0.016 apart, at the same test accuracy;
# - train (b) ``ideal``: 386 leading steps agree and R is equal;
# - train (b) ``wbs``: 5 leading steps agree (the 8-bit input quantizer
#   and ADC flip first there) and R lies 3 test examples (MA 0.0067) from
#   the CPU's, the same in every run; the ADC skipped or a 7-bit input
#   quantizer leave 0 steps agreeing yet R only 3 and 2 examples away,
#   and lost writes to U leave 1 step agreeing and R 6 examples (MA
#   0.018) away. On ``wbs`` the R check alone cannot tell these faults
#   from a sound run; the leading losses can;
# - train (c) ``analog``: 13-14 leading steps agree and R lies 2 test
#   examples (MA 0-0.0033) from the CPU's; a CPU run at 2 threads agrees
#   on all 630; write noise off leaves 1 step and R 5 examples (MA 0.015)
#   away, gain noise off 0 steps and 2 examples, the ADC skipped 1 and 2,
#   lost writes to U 2 steps and 7 examples (MA 0.022);
# - train (d), read noise, against the CPU's first epoch: 12 of 15 steps
#   agree; σ = 0 and σ = 0.05 on the card leave 0.
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5
# Leading steps of train (b)-(d) whose losses must agree (train (a): all).
LOSS_AGREE_STEPS = {"ideal": 100, "wbs": 3, "analog": 5, "read_noise": 5}
PARAMS_ATOL = 1e-3            # train (a)'s final params against the CPU's
R_TOLERANCE = {"ideal": (2, 0.01), "wbs": (4, 0.01), "analog": (4, 0.01)}
# Train (d): §V-B's 10 % cycle-to-cycle read variability (CrossbarSpec's
# own default) on ``analog``; the CPU twin runs its first epoch.
READ_SIGMA, RN_CPU_EPOCHS = 0.10, 1
RN_MIN_ACC = 0.5              # train (d)'s accuracy: chance is 0.1
# Table I: benchmarks/table1_throughput.py's metered runs (non-fast).
T1_TASKS, T1_TRAIN, T1_TEST, T1_EPOCHS, T1_CAPACITY = 2, 320, 32, 2, 64
# Read-noise moments: keys, and the bounds on r = (y_noisy − y_clean) /
# (σ·√Σ_k (x_k·w_kn)²): |mean r| < 5/√keys (5 sd even if every output of
# a key were fully correlated), |mean r² − 1| < 0.05 (over 512 keys × 100
# independent columns its sd is 0.006).
RN_KEYS, RN_MEAN_SD, RN_VAR_TOL = 512, 5.0, 0.05
# The kernels: each one's wrapper module and launch counter.
KERNELS = {"wbs_matmul": ("wbs_matmul", "launches"),
           "wbs_matmul_read_noise": ("wbs_matmul", "read_noise_launches"),
           "wbs_miru_scan": ("wbs_miru_scan", "launches"),
           "miru_scan": ("miru_scan", "launches"),
           "miru_readout": ("miru_readout", "launches")}
# CPU twins run beside the card's phases, one thread each.
TWIN_WORKERS = 4
# Published H100 SXM peaks (NVIDIA data sheet): fp32 and fp64 on CUDA
# cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_FP64_FLOPS = 34e12
PEAK_BYTES = 3.35e12


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def counters() -> dict:
    """{kernel: (wrapper module, counter attribute)}."""
    import importlib
    return {k: (importlib.import_module(f"repro_torch.kernels.{m}"), a)
            for k, (m, a) in KERNELS.items()}


def reset_launches() -> None:
    for mod, attr in counters().values():
        setattr(mod, attr, 0)


def read_launches() -> dict:
    return {k: getattr(mod, attr) for k, (mod, attr) in counters().items()}


def require_launches(path: str, launches: dict, names) -> None:
    """Fail unless every kernel of ``path`` launched in its run."""
    missing = [k for k in names if not launches[k]]
    if missing:
        raise AssertionError(f"{path}: kernel(s) {missing} never launched "
                             f"(launches {launches})")


def loss_agree_steps(losses, cpu_losses) -> int:
    """How many leading steps' losses agree with the CPU run's at
    LOSS_RTOL / LOSS_ATOL."""
    import numpy as np
    a = np.asarray(losses, np.float64)
    b = np.asarray(cpu_losses, np.float64)
    ok = np.isclose(a, b, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    return int(len(ok) if ok.all() else np.argmin(ok))


def time_graph(fn, reps: int = 20, rounds: int = 5) -> float:
    """Milliseconds per call of ``fn`` on the device: ``reps`` calls
    captured in one CUDA graph (so host launch overhead is excluded),
    replayed ``rounds`` times between CUDA events after a warm-up."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * rounds)


def bound_ms(flops: float, n_bytes: float, flops64: float = 0.0
             ) -> tuple[float, str]:
    """The least time for the work: fp32 FLOPs at the fp32 peak plus fp64
    FLOPs at the fp64 peak, or bytes at the memory rate, whichever is
    larger."""
    t_ops = flops / PEAK_FP32_FLOPS + flops64 / PEAK_FP64_FLOPS
    t_bytes = n_bytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def matmul_inputs(rng, dev, M, K, N, x_scale=1.0):
    import numpy as np
    import torch
    from repro_torch.analog.wbs import ideal_gains, quantize_signed
    x = torch.from_numpy(rng.uniform(-1, 1, (M, K)).astype(np.float32)
                         * np.float32(x_scale)).to(dev)
    lim = np.sqrt(6.0 / (K + N))
    w = torch.from_numpy(rng.uniform(-lim, lim, (K, N)).astype(np.float32)
                         ).to(dev) / W_SCALE
    sign, code = quantize_signed(x, N_BITS)
    return dict(sign=sign, code=code, w=w,
                gains=ideal_gains(N_BITS, device=dev))


def scan_inputs(rng, dev, B, T, H, with_h0):
    import numpy as np
    import torch
    lim = np.sqrt(6.0 / (2 * H))
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    return dict(
        drive=f(rng.normal(0.0, 0.6, (B, T, H))),
        u_h=f(rng.uniform(-lim, lim, (H, H))),
        b_h=f(rng.normal(0.0, 0.1, (H,))),
        h0=f(rng.uniform(-0.5, 0.5, (B, H))) if with_h0 else None)


def check_kernels(dev) -> dict:
    import numpy as np
    import torch
    from repro_torch import testing
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(0)
    err = {k: 0.0 for k in KERNELS}
    with torch.no_grad():
        for name, (M, K, N, xs) in {"drive": (SLOTS * CHUNK, N_X, N_H, 1.0),
                                    "u_h": (SLOTS, N_H, N_H, BETA)}.items():
            inp = matmul_inputs(rng, dev, M, K, N, xs)
            for adc in (ADC_BITS, None):
                got = ops.wbs_matmul(**inp, adc_bits=adc, adc_range=ADC_RANGE)
                want = ref.wbs_matmul_ref(**inp, adc_bits=adc,
                                          adc_range=ADC_RANGE)
                torch.cuda.synchronize()
                rep = testing.compare_matmul(got, want, **inp, adc_bits=adc,
                                             adc_range=ADC_RANGE).check()
                err["wbs_matmul"] = max(err["wbs_matmul"], rep.max_abs_err)
                emit("kernels", kernel="wbs_matmul", case=name,
                     shape=[M, K, N], adc_bits=adc,
                     bitwise=bool(torch.equal(got, want)), **rep.as_dict())
        for H in (N_H, 256):
            for with_h0 in (False, True):
                inp = scan_inputs(rng, dev, SLOTS, CHUNK, H, with_h0)
                for adc in (ADC_BITS, None):
                    kw = dict(beta=BETA, lam=LAM, n_bits=N_BITS, adc_bits=adc,
                              adc_range=ADC_RANGE, weight_scale=W_SCALE)
                    got = ops.wbs_miru_scan(**inp, **kw)
                    h0 = inp["h0"] if with_h0 else torch.zeros(
                        (SLOTS, H), device=dev)
                    u_scaled = inp["u_h"] / W_SCALE
                    want = ref.wbs_miru_scan_ref(
                        inp["drive"], u_scaled, h0, inp["b_h"], BETA, LAM,
                        N_BITS, adc, ADC_RANGE, W_SCALE)
                    torch.cuda.synchronize()
                    rep = testing.compare_scan(
                        got, want, drive=inp["drive"], u_scaled=u_scaled,
                        b_h=inp["b_h"], beta=BETA, n_bits=N_BITS,
                        w_scale=W_SCALE, adc_bits=adc,
                        adc_range=ADC_RANGE).check()
                    err["wbs_miru_scan"] = max(err["wbs_miru_scan"],
                                               rep.max_abs_err)
                    emit("kernels", kernel="wbs_miru_scan",
                         shape=[SLOTS, CHUNK, H], h0=with_h0, adc_bits=adc,
                         bitwise=all(torch.equal(a, b)
                                     for a, b in zip(got, want)),
                         **rep.as_dict())
        # The ideal scan at the training shapes: batch 64 and the 300-row
        # test set at the paper's width, and batch 64 at H = 256.
        for B, H in ((SW_BATCH, N_H), (SW_TEST, N_H), (SW_BATCH, 256)):
            for with_h0 in (False, True):
                inp = scan_inputs(rng, dev, B, T_SEQ, H, with_h0)
                h0 = inp["h0"] if with_h0 else torch.zeros((B, H), device=dev)
                got = ops.miru_scan(inp["drive"], inp["u_h"], h0, BETA, LAM)
                want = ref.miru_scan_ref(inp["drive"], inp["u_h"], h0, BETA,
                                         LAM)
                torch.cuda.synchronize()
                e = max(float((a - b).abs().max()) for a, b in zip(got, want))
                err["miru_scan"] = max(err["miru_scan"], e)
                bitwise = all(torch.equal(a, b) for a, b in zip(got, want))
                emit("kernels", kernel="miru_scan", shape=[B, T_SEQ, H],
                     h0=with_h0, bitwise=bitwise, max_abs_err=e)
                if not bitwise:
                    raise AssertionError(f"miru_scan != plain at "
                                         f"{(B, T_SEQ, H)}, h0={with_h0}")
        # The readout at the serve (896 rows), eval (200) and train (64)
        # shapes; each row's bits must not depend on the number of rows.
        w_o = torch.from_numpy(rng.normal(0, 0.3, (N_H, N_Y)).astype(
            np.float32)).to(dev)
        b_o = torch.from_numpy(rng.normal(0, 0.1, N_Y).astype(
            np.float32)).to(dev)
        h = torch.from_numpy(rng.uniform(-1, 1, (SLOTS * CHUNK, N_H)).astype(
            np.float32)).to(dev)
        full = ops.miru_readout(h, w_o, b_o)
        for M in (SLOTS * CHUNK, CL_TEST, SW_BATCH, CHUNK, 1):
            got = ops.miru_readout(h[:M].contiguous(), w_o, b_o)
            want = ref.miru_readout_ref(h[:M], w_o, b_o)
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            err["miru_readout"] = max(err["miru_readout"], e)
            bitwise = torch.equal(got, want) and torch.equal(got, full[:M])
            emit("kernels", kernel="miru_readout", shape=[M, N_H, N_Y],
                 bitwise_and_row_exact=bitwise, max_abs_err=e)
            if not bitwise:
                raise AssertionError(f"miru_readout not bitwise or not "
                                     f"row-exact at M={M}")
        err["wbs_matmul_read_noise"] = check_read_noise(dev, rng)
    return err


def check_read_noise(dev, rng) -> float:
    """The read-noise WBS product: bitwise against its plain version on
    the card at the read-noise path's shapes (the per-step tiles at batch
    32, and the 896-row serve drive), with and without the ADC; at σ = 0
    bitwise equal to the plain kernel; one draw per weight element per
    call (two identical rows, 197 rows apart, give identical outputs);
    and its moments over RN_KEYS keys against the analysis."""
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import wbs_matmul as kmm
    err = 0.0
    for name, (M, K, N) in {"w_h": (CL_BATCH, N_X, N_H),
                            "u_h": (CL_BATCH, N_H, N_H),
                            "drive": (SLOTS * CHUNK, N_X, N_H)}.items():
        inp = matmul_inputs(rng, dev, M, K, N)
        key = prng.PRNGKey(M + K + N)
        words = ops.read_key_words(key)
        for adc in (ADC_BITS, None):
            got = ops.wbs_matmul(**inp, adc_bits=adc, adc_range=ADC_RANGE,
                                 read_sigma=READ_SIGMA, read_key=key)
            want = ref.wbs_matmul_read_noise_ref(
                **inp, read_sigma=READ_SIGMA, key_words=words, adc_bits=adc,
                adc_range=ADC_RANGE)
            w_p = ops.pad_wbs_weights(inp["w"])
            zero = kmm.wbs_matmul_read_noise(
                inp["sign"], inp["code"], w_p, inp["gains"], 0.0, words,
                n_cols=N, adc_bits=adc, adc_range=ADC_RANGE)
            plain_kernel = kmm.wbs_matmul(inp["sign"], inp["code"], w_p,
                                          inp["gains"], adc, ADC_RANGE)
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            err = max(err, e)
            bitwise = bool(torch.equal(got, want))
            zero_equal = bool(torch.equal(zero, plain_kernel))
            emit("kernels", kernel="wbs_matmul_read_noise", case=name,
                 shape=[M, K, N], adc_bits=adc, read_sigma=READ_SIGMA,
                 bitwise=bitwise, max_abs_err=e,
                 sigma0_equals_plain_kernel=zero_equal)
            if not (bitwise and zero_equal):
                raise AssertionError(
                    f"wbs_matmul_read_noise at {(M, K, N)}, adc {adc}: "
                    f"bitwise {bitwise}, σ = 0 == plain kernel {zero_equal}")
    # One draw per weight element per call, whatever M: rows 3 and 200
    # of a 300-row call (another 128-row block on the TPU) are identical.
    inp = matmul_inputs(rng, dev, 300, N_H, N_H)
    inp["sign"][200], inp["code"][200] = inp["sign"][3], inp["code"][3]
    y = ops.wbs_matmul(**inp, read_sigma=READ_SIGMA,
                       read_key=prng.PRNGKey(1))
    rows_equal = bool(torch.equal(y[3], y[200]))
    # Moments at the per-step shape, no ADC.
    inp = matmul_inputs(rng, dev, CL_BATCH, N_H, N_H, BETA)
    clean = ops.wbs_matmul(**inp).double()
    xq = inp["sign"].double() * inp["code"].double() / (2 ** N_BITS - 1)
    var = READ_SIGMA ** 2 * (xq ** 2) @ (inp["w"].double() ** 2)
    ok = var > 0
    s1 = s2 = 0.0
    for kk in prng.split(prng.PRNGKey(7), RN_KEYS):
        d = ops.wbs_matmul(**inp, read_sigma=READ_SIGMA,
                           read_key=kk).double() - clean
        r = d[ok] / var[ok].sqrt()
        s1, s2 = s1 + r.sum(), s2 + (r * r).sum()
    n = RN_KEYS * int(ok.sum())
    mean_r, mean_r2 = float(s1) / n, float(s2) / n
    emit("kernels", kernel="wbs_matmul_read_noise", case="contracts",
         identical_rows_identical_outputs=rows_equal, keys=RN_KEYS,
         mean_r=mean_r, mean_r2=mean_r2,
         bounds={"abs_mean_r": RN_MEAN_SD / RN_KEYS ** 0.5,
                 "abs_mean_r2_minus_1": RN_VAR_TOL})
    if not rows_equal:
        raise AssertionError("read noise: identical rows of one call gave "
                             "different outputs")
    if abs(mean_r) >= RN_MEAN_SD / RN_KEYS ** 0.5 \
            or abs(mean_r2 - 1.0) >= RN_VAR_TOL:
        raise AssertionError(f"read-noise moments off: mean r {mean_r}, "
                             f"mean r² {mean_r2}")
    return err


# ---------------------------------------------------------------------------
# Phases 4 and 5: the serve path
# ---------------------------------------------------------------------------

def paper_model(dev):
    import torch
    from repro_torch.core.miru import MiRUConfig, init_miru_params
    cfg = MiRUConfig(n_x=N_X, n_h=N_H, n_y=N_Y, beta=BETA, lam=LAM)
    return cfg, init_miru_params(torch.Generator().manual_seed(0), cfg, dev)


def burst_spec():
    from repro_torch.serve import TrafficSpec
    return TrafficSpec(n_requests=N_REQUESTS, rate_hz=None, n_users=N_USERS,
                       frames_min=FRAMES, frames_max=FRAMES, n_x=N_X, seed=0)


def serve(cfg, params, arrivals, dev, **scfg):
    """Serve ``arrivals`` [(uid, frames)] through a fresh engine on
    ``dev``; returns (engine, requests)."""
    import torch
    from repro_torch.serve import RecurrentServeConfig, RecurrentServeEngine
    scfg.setdefault("batch_slots", SLOTS)
    scfg.setdefault("chunk", CHUNK)
    eng = RecurrentServeEngine(
        cfg, RecurrentServeConfig(device="wbs", fresh_meter=True, **scfg),
        params, torch_device=dev)
    reqs = [eng.submit(frames, uid=uid) for uid, frames in arrivals]
    eng.run_until_drained()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return eng, reqs


def streams(arrivals, reqs, uids):
    """Per-user logits, the user's bursts concatenated in serving order."""
    import numpy as np
    return [np.concatenate([r.logits for (u, _), r in zip(arrivals, reqs)
                            if u == uid]) for uid in uids]


def device_busy(fn) -> dict:
    """Run ``fn`` once under torch.profiler: the device's busy time (the
    summed durations of its kernels, copies and sets) and the kernels
    that took most of it. The profiler's start-up and per-op cost stretch
    the traced run's wall time by orders of magnitude, so the caller
    relates the busy time to an untraced run of the same work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    traced_wall = time.perf_counter() - t0
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            calls, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (calls + 1, us + e.self_device_time_total)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    return {"device_busy_s": sum(us for _, us in by_name.values()) / 1e6,
            "traced_wall_s": traced_wall,
            "top_kernels": [{"name": n[:60], "calls": c, "device_ms": us / 1e3}
                            for n, (c, us) in top]}


def serve_path(dev, device_name: str) -> dict:
    import numpy as np
    import torch
    from repro_torch import testing
    from repro_torch.serve import replay
    cfg, params = paper_model(dev)
    arrivals = [(a.uid, f) for a, f in replay(burst_spec())]
    uids = sorted({u for u, _ in arrivals})
    # Warm-up on other traffic (CUDA context, allocator, libraries loaded).
    serve(cfg, params, [(f"warm{i}", f) for i, (_, f) in
                        enumerate(arrivals[:SLOTS])], dev)

    reset_launches()
    t0 = time.perf_counter()
    eng, reqs = serve(cfg, params, arrivals, dev)
    wall = time.perf_counter() - t0
    launches = read_launches()
    require_launches("serve", launches,
                     ("wbs_matmul", "wbs_miru_scan", "miru_readout"))
    stats = eng.request_stats()
    if stats["requests"] != N_REQUESTS or \
            stats["frames_served"] != N_REQUESTS * FRAMES:
        raise AssertionError(f"served {stats['requests']} requests, "
                             f"{stats.get('frames_served')} frames")
    served = streams(arrivals, reqs, uids)
    for s in served:
        if not np.isfinite(s).all() or s.shape[1] != N_Y:
            raise AssertionError("served logits not finite or wrong shape")

    eng_cpu, reqs_cpu = serve(cfg, params, arrivals, torch.device("cpu"))
    if [r.emitted for r in reqs] != [r.emitted for r in reqs_cpu] or \
            eng.slab.stats() != eng_cpu.slab.stats():
        raise AssertionError("emitted frames or slab counters differ from "
                             "the CPU run")
    bound = testing.one_level_logit_bound(params["w_o"], LAM, ADC_BITS,
                                          ADC_RANGE)
    rep = testing.compare_streams(served, streams(arrivals, reqs_cpu, uids),
                                  flip_bound=bound).check()
    # The same burst again, traced: device busy time over the untraced
    # run's wall time is the share of the serve run the card was busy.
    busy = device_busy(lambda: serve(cfg, params, arrivals, dev))
    busy["busy_share_of_untraced_wall"] = busy["device_busy_s"] / wall \
        if busy["device_busy_s"] else None
    emit("serve", device=device_name, launches=launches,
         launches_per_step={k: v / stats["steps_run"]
                            for k, v in launches.items()},
         wall_s=wall, vs_cpu=rep.as_dict(), traced_run=busy,
         **{k: stats[k] for k in ("requests", "steps_run", "latency_ms",
                                  "queue_wait_ms", "decode_ms",
                                  "sequences_per_s", "frames_per_s", "slab")})
    return dict(cfg=cfg, params=params, arrivals=arrivals, uids=uids,
                served=served, launches=launches)


def contracts(dev, run: dict) -> None:
    import numpy as np
    import torch
    from repro_torch.backends import get_backend
    cfg, params, arrivals = run["cfg"], run["params"], run["arrivals"]
    by_uid = dict(zip(run["uids"], run["served"]))

    # Fused vs per-step (one wbs_matmul per tile per step), bit for bit.
    _, reqs = serve(cfg, params, arrivals, dev, fused=False)
    per_step = streams(arrivals, reqs, run["uids"])
    fused_equal = all(np.array_equal(a, b)
                      for a, b in zip(run["served"], per_step))
    g = torch.Generator().manual_seed(1)
    x = (torch.rand((SLOTS, CHUNK, N_X), generator=g) * 2 - 1).to(dev)
    h0 = (torch.rand((SLOTS, N_H), generator=g) - 0.5).to(dev)
    backend = get_backend("wbs")
    with torch.no_grad():
        a = backend.device_recurrence(params, cfg, x, fused=True, h0=h0)
        b = backend.device_recurrence(params, cfg, x, fused=False, h0=h0)
    recurrence_equal = all(torch.equal(u, v) for u, v in zip(a, b))
    if not (fused_equal and recurrence_equal):
        raise AssertionError(f"fused != per-step: serve {fused_equal}, "
                             f"device_recurrence {recurrence_equal}")

    # Batch composition and slot permutation at the fixed 64-slot shape:
    # each of 8 users served alone, first in slot 0, then in slot j
    # (j resident dummy users ahead of it), must reproduce its stream.
    users = run["uids"][:8]
    solo_equal = one_slot_equal = True
    for i, uid in enumerate(users):
        mine = [(u, f) for u, f in arrivals if u == uid]
        _, reqs = serve(cfg, params, mine, dev)
        alone = np.concatenate([r.logits for r in reqs])
        j = 1 + 7 * i
        dummies = [(f"dummy{k}", arrivals[k][1][:1]) for k in range(j)]
        _, reqs = serve(cfg, params, dummies + mine, dev)
        moved = np.concatenate([r.logits for r in reqs[j:]])
        solo_equal &= np.array_equal(alone, by_uid[uid]) \
            and np.array_equal(moved, by_uid[uid])
        _, reqs = serve(cfg, params, mine, dev, batch_slots=1)
        one_slot_equal &= np.array_equal(
            np.concatenate([r.logits for r in reqs]), by_uid[uid])
    if not solo_equal:
        raise AssertionError("batch composition or slot permutation changed "
                             "a served stream at the fixed slab shape")
    if not one_slot_equal:
        raise AssertionError("a one-slot engine served other bits than the "
                             "64-slot engine")
    emit("contracts", fused_equals_per_step=True,
         batch_composition_and_slot_permutation_bitwise=True,
         one_slot_engine_bitwise=True)


# ---------------------------------------------------------------------------
# Phase 6: the training paths
# ---------------------------------------------------------------------------

def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def busy_share(fn, untraced_wall: float) -> dict:
    """``fn`` traced once: its device busy time over ``untraced_wall``, the
    wall time of the same work untraced."""
    busy = device_busy(fn)
    busy["busy_share_of_untraced_wall"] = busy["device_busy_s"] \
        / untraced_wall
    busy["untraced_wall_s"] = untraced_wall
    return busy


def software_run(dev, steps: Optional[int] = None,
                 count: bool = False) -> dict:
    """examples/quickstart.py through the fused float recurrence on
    ``dev``: params from PRNGKey(0), Ψ from PRNGKey(1), ``steps`` DFA +
    ζ-SGD steps on batches of 64 drawn by ``default_rng(0)``, then the
    test accuracy. With ``count``, the launch counters are zeroed just
    before the steps and read just after."""
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.core.dfa import dfa_grads, sgd_kwta_update
    from repro_torch.core.miru import (MiRUConfig, init_dfa_feedback,
                                       init_miru_params, miru_forward)
    from repro_torch.data.synthetic import make_permuted_tasks
    from repro_torch.utils import accuracy
    steps = SW_STEPS if steps is None else steps
    task = make_permuted_tasks(seed=0, n_tasks=1, n_train=SW_TRAIN,
                               n_test=SW_TEST)[0]
    cfg = MiRUConfig(n_x=N_X, n_h=N_H, n_y=N_Y, beta=BETA, lam=LAM)
    params = init_miru_params(prng.PRNGKey(0), cfg, dev)
    psi = init_dfa_feedback(prng.PRNGKey(1), cfg, device=dev)
    rng = np.random.default_rng(0)
    idx = np.stack([rng.integers(0, SW_TRAIN, SW_BATCH)
                    for _ in range(steps)])
    xb = torch.from_numpy(task.x_train[idx]).to(dev)
    yb = torch.from_numpy(task.y_train[idx]).to(dev)
    with torch.no_grad():
        _sync(dev)
        if count:
            reset_launches()
        t0 = time.perf_counter()
        losses = []
        for it in range(steps):
            loss, g = dfa_grads(params, psi, cfg, xb[it], yb[it],
                                use_fused=True)
            params, _ = sgd_kwta_update(params, g, lr=0.2, keep_frac=0.57,
                                        hidden_lr_scale=0.3)
            losses.append(loss)
        _sync(dev)
        wall = time.perf_counter() - t0
        launches = read_launches()
        logits, _ = miru_forward(params, cfg,
                                 torch.from_numpy(task.x_test).to(dev),
                                 use_fused=True)
        acc = float(accuracy(logits, torch.from_numpy(task.y_test).to(dev)))
    losses = torch.stack(losses).cpu().numpy()
    return dict(acc=acc, wall_s=wall, launches=launches, losses=losses,
                params=params,
                finite=bool(np.isfinite(losses).all()
                            and torch.isfinite(logits).all()))


def train_software(dev, twins: dict) -> dict:
    """Phase 6a. The launches of the counted run on the card, its time per
    step and test accuracy, a traced run's busy share, and the same 400
    steps on the CPU (the kernels' plain versions) as the check: every
    loss, the final params and the test accuracy."""
    software_run(dev, steps=3)                       # warm-up
    run = software_run(dev, count=True)
    require_launches("train (a)", run["launches"],
                     ("miru_scan", "miru_readout"))
    steps = 50
    short = software_run(dev, steps=steps)
    busy = busy_share(lambda: software_run(dev, steps=steps),
                      short["wall_s"])
    cpu = twins["software"].result()
    if not (run["finite"] and cpu["finite"]):
        raise AssertionError("train (a): loss or logits not finite")
    if run["acc"] < 0.9 or abs(run["acc"] - cpu["acc"]) > 2 / SW_TEST + 1e-9:
        raise AssertionError(f"train (a): test accuracy {run['acc']} on the "
                             f"card, {cpu['acc']} on the CPU")
    agree = loss_agree_steps(run["losses"], cpu["losses"])
    if agree < len(cpu["losses"]):
        raise AssertionError(f"train (a): the losses leave the CPU run's at "
                             f"step {agree}")
    d_params = max(float((run["params"][k].cpu() - cpu["params"][k]).abs()
                         .max()) for k in cpu["params"])
    if d_params > PARAMS_ATOL:
        raise AssertionError(f"train (a): final params {d_params} from the "
                             f"CPU run's")
    emit("train_software", steps=SW_STEPS, batch=SW_BATCH,
         ms_per_step=1e3 * run["wall_s"] / SW_STEPS,
         launches=run["launches"],
         launches_per_step={k: v / SW_STEPS
                            for k, v in run["launches"].items()},
         test_acc=run["acc"], cpu_test_acc=cpu["acc"],
         cpu_ms_per_step=1e3 * cpu["wall_s"] / SW_STEPS,
         loss_agree_steps=agree, max_abs_d_params=d_params,
         first_last_loss=[float(run["losses"][0]),
                          float(run["losses"][-1])],
         traced_run=dict(busy, steps=steps))
    return run


def read_noise_backend():
    """Train (d)'s substrate: ``analog`` with §V-B's cycle-to-cycle read
    variability on every access."""
    from repro_torch.analog.crossbar import CrossbarSpec
    from repro_torch.backends import get_backend
    return get_backend("analog", spec_overrides=dict(crossbar=CrossbarSpec(
        read_sigma=READ_SIGMA, write_sigma=0.10, w_clip=W_SCALE)))


def protocol_run(dev, backend, n_tasks: Optional[int] = None,
                 count: bool = False, epochs: Optional[int] = None) -> dict:
    """The Fig. 4 protocol on ``dev``: ``run_continual`` with DFA and
    reservoir replay on ``backend`` (a name or a backend) over
    ``n_tasks`` permuted tasks, ``epochs`` a task (default CL_EPOCHS)."""
    from repro_torch.core.continual import (ReplaySpec, TrainerSpec,
                                            run_continual)
    from repro_torch.core.miru import MiRUConfig
    from repro_torch.data.synthetic import make_permuted_tasks
    n_tasks = CL_TASKS if n_tasks is None else n_tasks
    tasks = make_permuted_tasks(0, n_tasks=n_tasks, n_train=CL_TRAIN,
                                n_test=CL_TEST)
    cfg = MiRUConfig(n_x=N_X, n_h=N_H, n_y=N_Y, beta=BETA, lam=LAM)
    trainer = TrainerSpec(algo="dfa", batch_size=CL_BATCH,
                          epochs_per_task=CL_EPOCHS if epochs is None
                          else epochs)
    _sync(dev)
    if count:
        reset_launches()
    t0 = time.perf_counter()
    out = run_continual(cfg, trainer, tasks,
                        replay=ReplaySpec(capacity=CL_CAPACITY),
                        device=backend, torch_device=dev)
    _sync(dev)
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = read_launches()
    return out


def train_step_ms(dev, backend: str, steps: int = 100) -> float:
    """Milliseconds per DFA train step of the protocol on the card: the
    first ``steps`` batches of task 0's schedule through the trainer's own
    step, after a warm-up, ending in a synchronize."""
    import torch
    from repro_torch import prng
    from repro_torch.backends import get_backend
    from repro_torch.core.continual import (ReplaySpec, TrainerSpec,
                                            _init_run, _make_raw_steps,
                                            build_batch_schedule)
    from repro_torch.core.miru import MiRUConfig
    from repro_torch.data.synthetic import make_permuted_tasks
    tasks = make_permuted_tasks(0, n_tasks=1, n_train=CL_TRAIN,
                                n_test=CL_TEST)
    cfg = MiRUConfig(n_x=N_X, n_h=N_H, n_y=N_Y, beta=BETA, lam=LAM)
    trainer = TrainerSpec(epochs_per_task=CL_EPOCHS, batch_size=CL_BATCH)
    be = get_backend(backend)
    sched = build_batch_schedule(trainer, ReplaySpec(capacity=CL_CAPACITY),
                                 tasks)
    step, _ = _make_raw_steps(cfg, trainer, be)
    key, params, psi, st = _init_run(cfg, trainer, be, dev)
    xs = torch.from_numpy(sched.x[0][:steps]).to(dev)
    ys = torch.from_numpy(sched.y[0][:steps]).to(dev)
    opt = {"psi": psi}
    with torch.no_grad():
        for s in range(3):
            step(params, opt, prng.PRNGKey(s), xs[s], ys[s], st)
        _sync(dev)
        t0 = time.perf_counter()
        for s in range(steps):
            key, k = prng.split(key)
            params, opt, _, _, st = step(params, opt, k, xs[s], ys[s], st)
        _sync(dev)
    return 1e3 * (time.perf_counter() - t0) / steps


def table1_run(dev, name: str) -> tuple:
    """``benchmarks/table1_throughput.py``'s metered run (non-fast) on
    ``dev``: ``run_continual`` on the paper shape with telemetry and the
    endurance tracker on. Returns (backend, result)."""
    from repro_torch.backends import get_backend
    from repro_torch.core.continual import (ReplaySpec, TrainerSpec,
                                            run_continual)
    from repro_torch.core.miru import MiRUConfig
    from repro_torch.data.synthetic import make_permuted_tasks
    tasks = make_permuted_tasks(0, n_tasks=T1_TASKS, n_train=T1_TRAIN,
                                n_test=T1_TEST)
    backend = get_backend(name, spec_overrides=dict(track_endurance=True))
    backend.telemetry.enable()
    _sync(dev)
    t0 = time.perf_counter()
    res = run_continual(MiRUConfig(n_x=N_X, n_h=N_H, n_y=N_Y),
                        TrainerSpec(algo="dfa", epochs_per_task=T1_EPOCHS),
                        tasks, replay=ReplaySpec(capacity=T1_CAPACITY),
                        device=backend, torch_device=dev)
    _sync(dev)
    res["wall_s"] = time.perf_counter() - t0
    return backend, res


def cpu_twin(kind: str) -> dict:
    """One CPU run that a card phase is held against, in a worker process
    of one thread: ``software`` (train (a)), ``protocol:<backend>``
    (train (b), (c)), ``read_noise`` (train (d)'s first epoch),
    ``table1:<backend>``. Returns what the checks read, as plain
    values and CPU tensors."""
    import torch
    torch.set_num_threads(1)
    cpu = torch.device("cpu")
    if kind == "software":
        run = software_run(cpu)
        return {k: run[k] for k in ("acc", "wall_s", "losses", "params",
                                    "finite")}
    if kind.startswith("table1:"):
        backend, res = table1_run(cpu, kind.split(":")[1])
        return {"snapshot": backend.telemetry.snapshot(), "R": res["R"],
                "wall_s": res["wall_s"]}
    if kind == "read_noise":
        run = protocol_run(cpu, read_noise_backend(), n_tasks=1,
                           epochs=RN_CPU_EPOCHS)
    else:
        run = protocol_run(cpu, kind.split(":")[1])
    return {k: run[k] for k in ("R", "MA", "losses", "wall_s")}


#: Every twin, longest first (measured on the CPU of the card's host).
TWINS = ("protocol:analog", "protocol:wbs", "software", "table1:analog_state",
         "protocol:ideal", "table1:cmos", "read_noise")


def start_twins():
    """(pool, {kind: future}): every CPU twin submitted to TWIN_WORKERS
    fresh processes."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    pool = ProcessPoolExecutor(
        max_workers=TWIN_WORKERS,
        mp_context=multiprocessing.get_context("spawn"))
    return pool, {k: pool.submit(cpu_twin, k) for k in TWINS}


def r_within(backend: str, run: dict, cpu: dict) -> bool:
    """Whether a protocol run's R and MA lie within
    :data:`R_TOLERANCE` of the CPU run's."""
    import numpy as np
    n_examples, ma_tol = R_TOLERANCE[backend]
    dR = float(np.abs(np.asarray(run["R"]) - np.asarray(cpu["R"])).max())
    return (dR <= n_examples / CL_TEST + 1e-9
            and abs(run["MA"] - cpu["MA"]) <= ma_tol + 1e-9)


def train_protocol(dev, twins: dict) -> dict:
    """Phases 6b and 6c, on ``ideal``, ``wbs`` and ``analog`` (Fig. 4's
    ``dfa_hw``): the counted run on the card with the reference's
    accuracy bands (``tests/test_continual.py``: task 0 > 0.75 after task
    0, R[-1, 0] > 0.25, and ``dfa_hw``'s MA within 0.06 of ``dfa``'s),
    its leading losses and R against the port's CPU run of the same
    protocol (:data:`LOSS_AGREE_STEPS`, :data:`R_TOLERANCE`), ms per
    train step, and the busy share of one traced task."""
    import numpy as np
    paths = {"ideal": ("miru_readout",),
             "wbs": ("wbs_matmul", "wbs_miru_scan", "miru_readout"),
             "analog": ("wbs_matmul", "wbs_miru_scan", "miru_readout")}
    out = {}
    for backend, kernels in paths.items():
        protocol_run(dev, backend, n_tasks=1)        # warm-up
        run = protocol_run(dev, backend, count=True)
        require_launches(f"train {backend}", run["launches"], kernels)
        R = np.asarray(run["R"])
        if not (R[0, 0] > 0.75 and R[-1, 0] > 0.25
                and np.isfinite(run["losses"]).all()):
            raise AssertionError(f"train {backend}: R {R.tolist()} "
                                 f"outside the reference's bands")
        if backend == "analog" and out["ideal"]["MA"] - run["MA"] >= 0.06:
            raise AssertionError(f"train analog: MA {run['MA']} more than "
                                 f"0.06 below ideal's {out['ideal']['MA']}")
        cpu = twins[f"protocol:{backend}"].result()
        agree = loss_agree_steps(run["losses"], cpu["losses"])
        if agree < min(LOSS_AGREE_STEPS[backend], len(cpu["losses"])):
            raise AssertionError(f"train {backend}: the losses leave the "
                                 f"CPU run's at step {agree}")
        dR = float(np.abs(R - np.asarray(cpu["R"])).max())
        dMA = abs(run["MA"] - cpu["MA"])
        n_examples, ma_tol = R_TOLERANCE[backend]
        if not r_within(backend, run, cpu):
            raise AssertionError(
                f"train {backend}: R {R.tolist()} on the card vs "
                f"{np.asarray(cpu['R']).tolist()} on the CPU")
        one = protocol_run(dev, backend, n_tasks=1)
        busy = busy_share(lambda: protocol_run(dev, backend, n_tasks=1),
                          one["wall_s"])
        n_steps = len(run["losses"])
        emit("train_protocol", backend=backend, R=R.tolist(), MA=run["MA"],
             cpu_R=np.asarray(cpu["R"]).tolist(), cpu_MA=cpu["MA"],
             loss_agree_steps=agree, max_abs_dR=dR, abs_dMA=dMA,
             tolerance={"test_examples": n_examples, "MA": ma_tol},
             steps=n_steps,
             wall_s=run["wall_s"], cpu_wall_s=cpu["wall_s"],
             launches=run["launches"],
             launches_per_step={k: v / n_steps
                                for k, v in run["launches"].items()},
             ms_per_train_step=train_step_ms(dev, backend),
             traced_task=busy)
        out[backend] = run
    return out


def train_read_noise(dev, twins: dict) -> dict:
    """Phase 6d: ``analog`` with per-access read noise on one task at the
    protocol's settings. Every forward is the per-step path through the
    read-noise kernel, 2 launches a time step (56 a forward) and no other
    WBS launch; the accuracy clears chance (0.1) to RN_MIN_ACC; the
    leading losses agree with the CPU run of its first epoch, which
    draws the same Philox noise from the same keys."""
    import numpy as np
    protocol_run(dev, read_noise_backend(), n_tasks=1, epochs=1)  # warm-up
    run = protocol_run(dev, read_noise_backend(), n_tasks=1, count=True)
    n_steps = len(run["losses"])
    forwards = n_steps + 1                   # a forward a step, one eval
    la = run["launches"]
    per_forward = la["wbs_matmul_read_noise"] / forwards
    if la["wbs_matmul_read_noise"] != 2 * T_SEQ * forwards \
            or la["wbs_matmul"] or la["wbs_miru_scan"]:
        raise AssertionError(f"train (d): launches {la} over {forwards} "
                             f"forwards, not {2 * T_SEQ} read-noise "
                             f"launches a forward")
    R = np.asarray(run["R"])
    if not (R[0, 0] > RN_MIN_ACC and np.isfinite(run["losses"]).all()):
        raise AssertionError(f"train (d): accuracy {R[0, 0]} not above "
                             f"{RN_MIN_ACC}")
    cpu = twins["read_noise"].result()
    agree = loss_agree_steps(run["losses"][:len(cpu["losses"])],
                             cpu["losses"])
    if agree < LOSS_AGREE_STEPS["read_noise"]:
        raise AssertionError(f"train (d): the losses leave the CPU run's at "
                             f"step {agree}")
    emit("train_read_noise", read_sigma=READ_SIGMA, acc=float(R[0, 0]),
         min_acc=RN_MIN_ACC, steps=n_steps, forwards=forwards,
         read_noise_launches_per_forward=per_forward, launches=la,
         loss_agree_steps=agree, cpu_steps=len(cpu["losses"]),
         wall_s=run["wall_s"], cpu_wall_s=cpu["wall_s"],
         ms_per_train_step=1e3 * run["wall_s"] / n_steps)
    return run


def table1(dev, twins: dict) -> dict:
    """Phase 7: Table I from the metered ``analog_state`` and ``cmos``
    runs. The reference's bands (``tests/test_telemetry.py``: 48.62 mW,
    312 GOPS/W, 3.21 pJ/op and 29× within 5 %, 12.2 years and the 6.9-year
    hot tail within 15 %), the benchmark's ``within_5pct`` against the
    analytical model, and the shape-determined counters equal to the CPU
    run of the same work."""
    from repro_torch.analog.costmodel import M2RUCostModel
    from repro_torch.telemetry import cmos_comparison, telemetry_report
    from repro_torch.telemetry import meters
    shape_meters = (meters.VMM_ROWS, meters.MACS, meters.BIT_PULSES,
                    meters.WBS_PHASES, meters.ADC_CONVERSIONS,
                    meters.INTERP, meters.SAMPLE_STEPS, meters.SEQUENCES,
                    meters.REPLAY_READS, meters.REPLAY_WRITES,
                    meters.REPLAY_READ_BYTES, meters.REPLAY_WRITE_BYTES)
    m = M2RUCostModel()
    runs, launches = {}, {}
    for name in ("analog_state", "cmos"):
        table1_run(dev, name)                         # warm-up
        reset_launches()
        runs[name] = table1_run(dev, name)
        launches[name] = read_launches()
        require_launches(f"table1 {name}", launches[name],
                         ("wbs_matmul", "miru_readout"))
    (ab, ares), (cb, _) = runs["analog_state"], runs["cmos"]
    rep = telemetry_report(ab.telemetry, model=m, tracker=ares["endurance"])
    cmp = cmos_comparison(ab.telemetry, cb.telemetry, model=m)
    met, ana, life = rep["metered"], rep["analytical"], rep["lifetime"]
    agreement = {k: abs(met[k] - ana[k]) / ana[k]
                 for k in ("power_mw", "gops", "gops_per_w", "pj_per_op",
                           "step_latency_us")}
    bands = {"power_mw": (met["power_mw"], 48.62, 0.05),
             "gops_per_w": (met["gops_per_w"], 312, 0.05),
             "pj_per_op": (met["pj_per_op"], 3.21, 0.05),
             "gain_vs_cmos": (cmp["efficiency_gain"], 29.0, 0.05),
             "years": (life["years_mean"], 12.2, 0.15),
             "years_hot_tail": (life["years_hot_tail"], 6.9, 0.15)}
    failed = [k for k, (v, want, rel) in bands.items()
              if not abs(v - want) <= rel * want]
    counters_equal = {}
    for name, (backend, _) in runs.items():
        snap = backend.telemetry.snapshot()
        cpu = twins[f"table1:{name}"].result()["snapshot"]
        counters_equal[name] = all(
            snap.get(k) == cpu.get(k) for k in set(snap) | set(cpu)
            if k.split("/")[0] in shape_meters)
    emit("table1", metered={k: met[k] for k in agreement},
         analytical=ana, gain_vs_cmos=cmp["efficiency_gain"],
         lifetime={k: life[k] for k in ("years_mean", "years_hot_tail",
                                        "writes_per_device_update")},
         agreement=agreement, within_5pct=all(v < 0.05
                                              for v in agreement.values()),
         bands={k: {"value": v, "paper": want, "rel": rel}
                for k, (v, want, rel) in bands.items()},
         shape_counters_equal_cpu=counters_equal, launches=launches,
         wall_s={k: r[1]["wall_s"] for k, r in runs.items()})
    if failed or not all(v < 0.05 for v in agreement.values()) \
            or not all(counters_equal.values()):
        raise AssertionError(f"table1: bands {failed}, agreement "
                             f"{agreement}, counters {counters_equal}")
    return launches


def analog_contract(dev) -> None:
    """``analog_state`` at zero write, read and programming noise and no
    drift is the ``analog`` program on the card, bit for bit: R, params,
    losses, telemetry counters and write maps, over the telemetry
    protocol of ``tests/test_telemetry.py`` (2 tasks × 96, 1 epoch)."""
    import numpy as np
    import torch
    from repro_torch.analog.crossbar import CrossbarSpec
    from repro_torch.backends import DeviceSpec, get_backend
    from repro_torch.core.continual import (ReplaySpec, TrainerSpec,
                                            run_continual)
    from repro_torch.core.miru import MiRUConfig
    from repro_torch.data.synthetic import make_permuted_tasks
    spec = DeviceSpec(input_bits=N_BITS, adc_bits=ADC_BITS,
                      adc_range=ADC_RANGE, gain_sigma=0.02,
                      weight_clip=W_SCALE, track_endurance=True,
                      crossbar=CrossbarSpec(write_sigma=0.0, read_sigma=0.0,
                                            w_clip=W_SCALE, prog_sigma=0.0,
                                            drift_rate=0.0))
    tasks = make_permuted_tasks(0, n_tasks=2, n_train=96, n_test=32)
    runs = {}
    for name in ("analog", "analog_state"):
        b = get_backend(name, spec=spec)
        b.telemetry.enable()
        runs[name] = run_continual(
            MiRUConfig(n_x=N_X, n_h=N_H, n_y=N_Y), TrainerSpec(algo="dfa"),
            tasks, replay=ReplaySpec(capacity=64), device=b,
            torch_device=dev)
    a, st = runs["analog"], runs["analog_state"]
    equal = {
        "R": bool(np.array_equal(a["R"], st["R"])),
        "losses": a["losses"] == st["losses"],
        "params": all(torch.equal(a["params"][k], st["params"][k])
                      for k in a["params"]),
        "counters": a["telemetry"].snapshot() == st["telemetry"].snapshot(),
        "write_maps": bool(np.array_equal(a["endurance"].all_counts(),
                                          st["endurance"].all_counts()))}
    emit("contracts", analog_state_equals_analog_at_zero_noise=equal)
    if not all(equal.values()):
        raise AssertionError(f"analog_state != analog at zero noise: "
                             f"{equal}")


# ---------------------------------------------------------------------------
# Phase 8: times
# ---------------------------------------------------------------------------

def times(dev) -> dict:
    """Each kernel's wrapper on inputs already padded and prepared as the
    serve path hands them over, so ``ms`` is the launch alone."""
    import numpy as np
    import torch
    from repro_torch.kernels import (miru_readout, miru_scan, ops, ref,
                                     wbs_matmul, wbs_miru_scan)
    rng = np.random.default_rng(1)
    out = {}
    with torch.no_grad():
        M, K, N = SLOTS * CHUNK, N_X, N_H
        inp = matmul_inputs(rng, dev, M, K, N)
        w_p = ops.pad_wbs_weights(inp["w"])
        deq = (inp["sign"].float() * inp["code"].float()) * 2.0 ** -N_BITS
        # By linearity Σ_b g_b·(plane_b⊙sign)@w = (sign⊙Σ_b g_b·plane_b)@w:
        # the work is one product plus an n_bits-term decode per input.
        flops = 2.0 * M * K * N + 2.0 * M * K * N_BITS
        n_bytes = 2 * M * K + 4 * K * N + 4 * N_BITS + 4 * M * N
        b, by = bound_ms(flops, n_bytes)
        out["wbs_matmul"] = dict(
            shape=[M, K, N],
            ms=time_graph(lambda: wbs_matmul.wbs_matmul(
                inp["sign"], inp["code"], w_p, inp["gains"])),
            plain_ms=time_graph(lambda: ref.wbs_matmul_ref(**inp)),
            library_ms=time_graph(lambda: torch.matmul(deq, inp["w"])),
            bound_ms=b, bound_by=by)
        # The read-noise variant at the per-step shape of train (d): the
        # product as above plus, per weight element, one Box–Muller normal
        # (counted as 8 fp64 operations: two scalings, log, ×−2, sqrt,
        # ×2π, cos, the product; Philox's integer rounds are not counted,
        # so the bound is a floor) and the perturbation's 3 fp32
        # operations. No single PyTorch call computes this function.
        M, K, N = CL_BATCH, N_H, N_H
        inp = matmul_inputs(rng, dev, M, K, N, BETA)
        w_p = ops.pad_wbs_weights(inp["w"])
        words = ops.read_key_words(np.asarray([0, 42], np.uint32))
        flops = 2.0 * M * K * N + 2.0 * M * K * N_BITS + 3.0 * K * N
        n_bytes = 2 * M * K + 4 * K * N + 4 * N_BITS + 4 * M * N
        b, by = bound_ms(flops, n_bytes, flops64=8.0 * K * N)
        out["wbs_matmul_read_noise"] = dict(
            shape=[M, K, N], read_sigma=READ_SIGMA,
            ms=time_graph(lambda: wbs_matmul.wbs_matmul_read_noise(
                inp["sign"], inp["code"], w_p, inp["gains"], READ_SIGMA,
                words, n_cols=N)),
            plain_ms=time_graph(lambda: ref.wbs_matmul_read_noise_ref(
                **inp, read_sigma=READ_SIGMA, key_words=words),
                reps=2, rounds=3),
            library_ms=None, bound_ms=b, bound_by=by)
        B, T, H = SLOTS, CHUNK, N_H
        inp = scan_inputs(rng, dev, B, T, H, with_h0=True)
        u_scaled = inp["u_h"] / W_SCALE
        gains = inp["drive"].new_tensor(
            [2.0 ** -(k + 1) for k in range(N_BITS)]).expand(T, N_BITS)
        gains = gains.contiguous()
        # One (B, H)×(H, H) product per step plus the decode of β·h.
        flops = 2.0 * B * T * H * H + 2.0 * B * T * H * N_BITS
        n_bytes = 4 * (B * T * H + H * H + B * H + H + T * N_BITS) \
            + 3 * 4 * B * T * H
        b, by = bound_ms(flops, n_bytes)
        out["wbs_miru_scan"] = dict(
            shape=[B, T, H],
            ms=time_graph(lambda: wbs_miru_scan.wbs_miru_scan(
                inp["drive"], u_scaled, inp["h0"], inp["b_h"], gains,
                beta=BETA, lam=LAM, adc_bits=ADC_BITS, adc_range=ADC_RANGE,
                w_scale=W_SCALE)),
            plain_ms=time_graph(lambda: ref.wbs_miru_scan_ref(
                inp["drive"], u_scaled, inp["h0"], inp["b_h"], BETA, LAM,
                N_BITS, ADC_BITS, ADC_RANGE, W_SCALE), reps=2, rounds=3),
            library_ms=None, bound_ms=b, bound_by=by)
        # The ideal scan at train (a)'s shape. One (B, H)×(H, H) product
        # per step; xw in, h_all and pre out, U and h0 once. No single
        # PyTorch call computes the recurrence.
        B, T, H = SW_BATCH, T_SEQ, N_H
        inp = scan_inputs(rng, dev, B, T, H, with_h0=True)
        flops = 2.0 * B * T * H * H
        n_bytes = 4 * (3 * B * T * H + H * H + B * H)
        b, by = bound_ms(flops, n_bytes)
        out["miru_scan"] = dict(
            shape=[B, T, H],
            ms=time_graph(lambda: miru_scan.miru_scan(
                inp["drive"], inp["u_h"], inp["h0"], beta=BETA, lam=LAM)),
            plain_ms=time_graph(lambda: ref.miru_scan_ref(
                inp["drive"], inp["u_h"], inp["h0"], BETA, LAM),
                reps=2, rounds=3),
            library_ms=None, bound_ms=b, bound_by=by)
        # The readout at the serve shape (the kernels line) and the eval
        # shape, beside torch.addmm of the same operands.
        w_o = torch.from_numpy(rng.normal(0, 0.3, (N_H, N_Y)).astype(
            np.float32)).to(dev)
        b_o = torch.from_numpy(rng.normal(0, 0.1, N_Y).astype(
            np.float32)).to(dev)
        for key, M in (("miru_readout", SLOTS * CHUNK),
                       ("miru_readout@eval", CL_TEST)):
            h = torch.from_numpy(rng.uniform(-1, 1, (M, N_H)).astype(
                np.float32)).to(dev)
            b, by = bound_ms(2.0 * M * N_H * N_Y + M * N_Y,
                             4 * (M * N_H + N_H * N_Y + N_Y + M * N_Y))
            out[key] = dict(
                shape=[M, N_H, N_Y],
                ms=time_graph(lambda: miru_readout.miru_readout(h, w_o,
                                                                b_o)),
                plain_ms=time_graph(lambda: ref.miru_readout_ref(h, w_o,
                                                                 b_o)),
                library_ms=time_graph(lambda: torch.addmm(b_o, h, w_o)),
                bound_ms=b, bound_by=by)
    for name, t in out.items():
        emit("times", kernel=name, **t)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    dev = torch.device("cuda", 0)
    # The plain versions and the readout run in full fp32: no TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit("device", kind=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    libs = _build.build()
    emit("build", seconds=time.perf_counter() - t0,
         ptxas={n: [ln.strip() for ln in p.with_suffix(".log").read_text()
                    .splitlines() if "registers" in ln or "spill" in ln]
                for n, p in libs.items() if p.with_suffix(".log").exists()})

    pool, twins = start_twins()
    try:
        err = check_kernels(dev)
        run = serve_path(dev, name)
        contracts(dev, run)
        analog_contract(dev)
        sw = train_software(dev, twins)
        cl = train_protocol(dev, twins)
        rn = train_read_noise(dev, twins)
        t1 = table1(dev, twins)
        t = times(dev)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)

    # launches: each kernel's count in the run of the path it was ported
    # for (serve for the WBS kernels and the readout, train (a) for the
    # ideal scan, train (d) for the read-noise product); launches_by_path
    # has every path's count.
    by_path = {"serve": run["launches"], "train_software": sw["launches"],
               "train_protocol_ideal": cl["ideal"]["launches"],
               "train_protocol_wbs": cl["wbs"]["launches"],
               "train_protocol_analog": cl["analog"]["launches"],
               "train_read_noise": rn["launches"],
               "table1_analog_state": t1["analog_state"],
               "table1_cmos": t1["cmos"]}
    own = {"wbs_matmul": "serve", "wbs_matmul_read_noise": "train_read_noise",
           "wbs_miru_scan": "serve", "miru_scan": "train_software",
           "miru_readout": "serve"}
    src = "src/repro_torch/kernels/csrc/"
    source = {k: src + KERNELS[k][0] + ".cu" for k in KERNELS}
    replaces = {"wbs_matmul": "src/repro/kernels/wbs_matmul.py:99",
                "wbs_matmul_read_noise": "src/repro/kernels/wbs_matmul.py:99 "
                                         "(read_sigma > 0: :36-45, :65-73)",
                "wbs_miru_scan": "src/repro/kernels/wbs_miru_scan.py:105",
                "miru_scan": "src/repro/kernels/miru_scan.py:47",
                "miru_readout": "h @ w_o in src/repro/core/miru.py:133 (not "
                                "a TPU kernel; repair of queue C)"}
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": source[k],
         "replaces": replaces[k], "launches": by_path[own[k]][k],
         "launches_by_path": {p: c[k] for p, c in by_path.items()},
         "max_abs_err": err[k], "ms": t[k]["ms"], "plain_ms": t[k]["plain_ms"],
         "bound_ms": t[k]["bound_ms"], "bound_by": t[k]["bound_by"],
         "library_ms": t[k]["library_ms"]} for k in KERNELS]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
