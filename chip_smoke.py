#!/usr/bin/env python3
"""Drive the PyTorch port's MiRU serving and training paths, the analog
substrates, the Table I metering and the LM zoo's dense serving and
training paths on one NVIDIA GPU, and check them.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. device: the card's name and count, and ``nvidia-smi``'s name and power
   limit;
2. build: the eleven CUDA libraries compiled by nvcc for sm_90a from
   ``src/repro_torch/kernels/csrc/``, one nvcc each, all at once;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main paths' shapes: bitwise for the recurrences, the readout, the
   read-noise WBS product and k-WTA, tie-aware (rtol = atol = 2e-5) for
   the WBS product; the read-noise variant also at σ = 0 against the
   plain kernel (bitwise), on two identical rows of one call (identical
   outputs), and in its moments over 512 keys; the flash-attention
   forward at the qwen2-0.5B prefill's shape and five others (fp32
   ``out`` at rtol 2e-5 / atol 2e-6, ``lse`` at atol 1e-5, bf16 ``out``
   within one bf16 ulp plus that fp32 tolerance; bf16 through the
   tensor-core kernel, fp32 through the fp32 one, each call launching
   its dtype's kernel once), and with keys padded past ``sk_true`` bit
   for bit as without, and the same call twice bit for bit; the flash
   backward's dq and dk/dv kernels (bf16: the tensor-core dq and dk/dv
   with its fold; fp32: the fp32 tensor-core dq and dk/dv, each with its
   split of the inputs into bf16 terms, dk/dv with its fold) at the
   training shape (bf16 and fp32, each also twice, bit for bit), the
   training twin's, with keys past ``sk_true`` and Sq != Sk, rep 1, a
   head dim padded from 80 to 128 and one of 128 (fp32 at rtol 1e-4 with
   a floor of 1e-5 of the largest gradient, bf16 within one ulp plus
   that), and the gradients through the autograd Function against
   torch.autograd through ``full_attention``;
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
lm. the LM zoo's dense serving path, qwen2-0.5B at full width in bf16
   with seeded random weights: (i) ``lm.prefill`` of 2 × 2,048 tokens,
   one launch of the bf16 tensor-core flash forward a layer, finite
   logits, its device busy share; (ii) the same config in fp32 cut to 2
   layers, on a 1,100-token prompt (the fp32 flash forward), against the
   port's CPU run of the same weights (``LM_PREFILL_ATOL``);
   (iii) ``ServeEngine`` (8 slots, max_len 256) draining a burst of 32
   seeded requests of 8-64 prompt tokens, 32 new tokens each: latency,
   tokens/s, steps, decode calls, busy share; (iv) four of them served
   alone decode the burst's tokens; (v) those four, 8 tokens each, on
   the 2-layer fp32 model against the CPU's run (tokens tie-aware,
   logits within ``LM_SERVE_ATOL``);
lm_train. the LM training path: (i) the same full model (bf16, remat
   on) through ``train.Trainer`` with AdamW at ``TrainConfig``'s
   defaults, ``ShardedBatcher`` over 2 × 2,048-token batches, 30 counted
   steps after 3 of warm-up: ms a step, tokens/s, every loss and grad
   norm finite, peak memory, exactly 48 launches of the bf16 tensor-core
   flash forward (24 and their 24 recomputes), 24 of the tensor-core dq
   and 24 of the tensor-core dk/dv a step, and the busy share of a traced
   3-step
   window; (ii) the same config in fp32 at full depth (TF32 off), 5
   timed steps after 3 of warm-up: ms a step, every loss and grad norm
   finite, exactly 48 launches of the fp32 forward, 24 of the fp32
   tensor-core dq and 24 of its dk/dv a step (none of the bf16 kernels),
   the device time of dq and dk/dv a step and the busy share of a traced
   3-step window; (iii) the 2-layer fp32 training twin, 3 steps on 1,100
   tokens (KV padded to 2,048, ``sk_true`` 1,100; the fp32 forward, dq
   and dk/dv kernels), against the port's CPU run of the same steps:
   every loss
   (``LM_TRAIN_LOSS_RTOL``), grad norm (``LM_TRAIN_GNORM_RTOL``) and the
   final params (their distance over the CPU update's norm,
   ``LM_TRAIN_PARAMS_REL``); then ``ops.kwta`` once at (64, 1024), k 580;
8. times: CUDA-event timings of each kernel, its plain version and,
   where one exists, one PyTorch call computing the same function (for
   k-WTA the exact top-k, a different function; for the flash backward
   the backward of ``scaled_dot_product_attention``), each over a CUDA
   graph of repeated launches, beside the least time the card could
   take (for the bf16 tensor-core flash kernels also that bound with
   their bf16 split's extra products, ``bound_split_ms``; for the fp32
   backward the bound of its six bf16 products a product and, beside it,
   that of the fp32 products on the CUDA cores, ``bound_cuda_cores_ms``);
   the WBS product at
   both main-path shapes (the drive and the per-step product) beside
   ``torch.matmul`` of the dequantized operand; the fp32 route's flash
   forward, dq and dk/dv on fp32 inputs beside
   ``scaled_dot_product_attention`` on the same fp32 inputs (TF32 off).

The CPU runs that the card's results are held against (the twins) run
at the start, in :data:`TWIN_WORKERS` worker processes of one thread
each, beside the card's phases; each phase waits for its twin's result.

Then the ``kernels`` line, the ``nvidia-smi`` line, and the final
``{"ok": true, ...}`` line. Any failure exits non-zero before the final
line; without a CUDA device the script exits 2 and prints no result.
"""
from __future__ import annotations

import json
import re
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
# The LM slice: qwen2-0.5B (configs/qwen2_0_5b.py CONFIG: 24 layers, d 896,
# 14 query heads over 2 KV heads, vocab 151,936) at full width in bf16,
# with seeded random weights (the repository holds no checkpoint).
LM = "qwen2-0.5b"
LM_PREFILL_B, LM_PREFILL_S = 2, 2048
# Serving: 8 slots, max_len 256; a burst of 32 requests with seeded
# prompts of 8-64 tokens, 32 new tokens each, no EOS, greedy.
LM_SLOTS, LM_MAX_LEN, LM_REQUESTS, LM_MAX_NEW = 8, 256, 32, 32
LM_PROMPT_MIN, LM_PROMPT_MAX = 8, 64
LM_CONTRACT = (0, 9, 18, 27)   # burst requests also served alone
# The CPU twins: the same config at full width in fp32, depth cut to 2
# layers, the same weights on both sides. The prefill twin's prompt is
# 1,100 tokens (the flash branch, KV padded to the 1,024 chunk: 2,048,
# sk_true 1,100); the serve twin serves LM_CONTRACT's prompts, 8 tokens.
LM_TWIN_LAYERS, LM_TWIN_S, LM_TWIN_MAX_NEW = 2, 1100, 8
LM_TWIN_ROWS = tuple(range(0, LM_TWIN_S, 10)) + (LM_TWIN_S - 1,)
# Card-vs-CPU logit tolerances of the twins (max |Δ logit|, logits up to
# about 3), measured on an H100 with tools/parity_reach.py --paths lm:
# - prefill: the card 6.8e-6 from the CPU, the CPU at 2 threads 3.6e-6;
#   the causal mask dropped 4.0, the GQA head map shifted by one 4.3;
#   sk_true ignored 6.8e-6, as sound: under the causal mask every padded
#   key lies past every query, so that fault cannot change this path's
#   output (phase 3 catches it, non-causal);
# - serve: the card's logits 3.2e-4 from the CPU's (the bf16 cache rounds
#   K/V that differ in the last fp32 bit), the CPU at 2 threads 3.2e-4;
#   the reference's every-row cache write 3.6, with other tokens.
LM_PREFILL_ATOL = 1e-4
LM_SERVE_ATOL = 1e-3
# LM training: the same full model (bf16, remat on) through
# train/trainer.Trainer at TrainConfig's defaults (AdamW, lr 3e-4, warmup
# 10, weight decay 0.1, clip 1.0), 2 × 2,048 tokens a step from
# lm_token_batch (KV > attn_chunk: the flash branch); LM_TRAIN_WARMUP
# steps first, then LM_TRAIN_STEPS counted and timed, then a traced
# window of LM_TRAIN_TRACE_STEPS. Each step launches the flash forward
# twice a layer (the forward and its recompute under remat) and the dq
# and dk/dv kernels once a layer.
LM_TRAIN_B, LM_TRAIN_S = 2, 2048
LM_TRAIN_WARMUP, LM_TRAIN_STEPS, LM_TRAIN_TRACE_STEPS = 3, 30, 3
# The same config in fp32 at full depth (the fp32 forward, dq and dk/dv
# a layer, as the bf16 run's kernels), fewer steps: each is slower.
LM_TRAIN_F32_WARMUP, LM_TRAIN_F32_STEPS = 3, 5
# The training twin: the 2-layer fp32 model of the LM twins on one
# 1,100-token sequence a step (the flash branch, KV padded to 2,048,
# sk_true 1,100), warmup 0 (lr 3e-4 from the first step), 3 Trainer
# steps, against the port's CPU run of the same steps. Measured on an
# H100 with tools/parity_reach.py --paths lm_train: the card's losses
# 7.9e-8 relative from the CPU's, its grad norms 6.6e-7, its final
# params' distance 2.6e-5 of the CPU update's norm (the CPU at 2 threads:
# 0, 9.4e-8, 1.2e-5); with dq's scale dropped, the backward's causal mask
# off, delta omitted or dk/dv shifted to the next KV head, the losses
# 1.2e-4 to 4.4e-4 apart, the grad norms 0.037 to 2,760 and the params
# 0.16 to 0.99 of the update. Each tolerance below separates them.
LM_TRAIN_TWIN_STEPS = 3
LM_TRAIN_LOSS_RTOL = 1e-5
LM_TRAIN_GNORM_RTOL = 1e-4
LM_TRAIN_PARAMS_REL = 1e-2
# The kernels: each one's wrapper module and launch counter.
KERNELS = {"wbs_matmul": ("wbs_matmul", "launches"),
           "wbs_matmul_read_noise": ("wbs_matmul", "read_noise_launches"),
           "wbs_miru_scan": ("wbs_miru_scan", "launches"),
           "miru_scan": ("miru_scan", "launches"),
           "miru_readout": ("miru_readout", "launches"),
           "flash_attention_fwd": ("flash_attention", "launches"),
           "flash_attention_bwd_dq": ("flash_attention", "dq_launches"),
           "flash_attention_bwd_dkv": ("flash_attention", "dkv_launches"),
           "kwta": ("kwta", "launches"),
           "flash_attention_fwd_sm90": ("flash_attention",
                                        "fwd_sm90_launches"),
           "flash_attention_bwd_dkv_sm90": ("flash_attention",
                                            "dkv_sm90_launches"),
           "flash_attention_bwd_dq_sm90": ("flash_attention",
                                           "dq_sm90_launches")}
# The flash kernels each dtype takes (kernels/ops.py's fixed rule): bf16
# the tensor-core forward, dq and dk/dv, fp32 the fp32 forward and the
# fp32 tensor-core dq and dk/dv.
FLASH_FWD = {"torch.bfloat16": "flash_attention_fwd_sm90",
             "torch.float32": "flash_attention_fwd"}
FLASH_DQ = {"torch.bfloat16": "flash_attention_bwd_dq_sm90",
            "torch.float32": "flash_attention_bwd_dq"}
FLASH_DKV = {"torch.bfloat16": "flash_attention_bwd_dkv_sm90",
             "torch.float32": "flash_attention_bwd_dkv"}
# CPU twins run beside the card's phases, one thread each.
TWIN_WORKERS = 4
# Published H100 SXM peaks (NVIDIA data sheet): fp32 and fp64 on CUDA
# cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_FP64_FLOPS = 34e12
PEAK_BF16_TENSOR_FLOPS = 989e12    # dense, tensor cores
PEAK_BYTES = 3.35e12


T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line: the phase, its fields, and the seconds since the
    script started (``t_s``)."""
    print(json.dumps({"phase": phase, **fields,
                      "t_s": round(time.perf_counter() - T_START, 1)}),
          flush=True)


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


def time_events(fn, reps: int = 20) -> float:
    """Milliseconds per call of ``fn`` between CUDA events around ``reps``
    back-to-back calls after a warm-up, without a graph (host launch
    gaps, if any, count)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: float, n_bytes: float, flops64: float = 0.0,
             flops_bf16_tc: float = 0.0) -> tuple[float, str]:
    """The least time for the work: fp32 FLOPs at the fp32 peak plus fp64
    FLOPs at the fp64 peak plus bf16 tensor-core FLOPs at their peak, or
    bytes at the memory rate, whichever is larger."""
    t_ops = flops / PEAK_FP32_FLOPS + flops64 / PEAK_FP64_FLOPS \
        + flops_bf16_tc / PEAK_BF16_TENSOR_FLOPS
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
        err.update(check_lm_kernels(dev, rng))
    err.update(check_flash_bwd(dev, rng))
    return err


def bf16_ulps(a, b) -> int:
    """Largest distance between two bf16 tensors in units in the last
    place (bit patterns mapped onto a monotonic integer scale)."""
    import torch

    def ordered(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -32768 - i, i)
    return int((ordered(a) - ordered(b)).abs().max())


def flash_inputs(rng, dev, B, Sq, Sk, H, Kh, dh, dtype):
    import numpy as np
    import torch
    return [torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)).to(
        dev, dtype) for s in ((B, Sq, H, dh), (B, Sk, Kh, dh),
                              (B, Sk, Kh, dh))]


def launched_once(names, before: dict) -> bool:
    """Whether, since ``before``, each flash kernel in ``names`` launched
    exactly once and no other flash kernel launched."""
    now = read_launches()
    return all(now[k] - before[k] == (k in names) for k in now
               if k.startswith("flash_attention"))


def check_lm_kernels(dev, rng) -> dict:
    """The flash forward and k-WTA kernels against their plain versions on
    the card: flash at fp32 rtol 2e-5 / atol 2e-6 on ``out`` and atol 1e-5
    on ``lse``, bf16 ``out`` within one bf16 ulp of the plain version's
    fp32 value plus that fp32 tolerance; each call launching the kernel
    of its dtype (bf16 the tensor-core forward) once; k-WTA bit for bit."""
    import numpy as np
    import torch
    from repro_torch import testing
    from repro_torch.kernels import ops, ref
    err = {"flash_attention_fwd": 0.0, "flash_attention_fwd_sm90": 0.0,
           "kwta": 0.0}
    # (B, Sq, Sk, H, Kh, dh, causal): the qwen2-0.5B prefill (GQA rep 7)
    # at the main path's batch (the second sequence's heads read KV heads
    # 2-3) and at one sequence, kernel_bench's shape, Sk off the tile (and
    # the KV padded past sk_true, as the prefill twin does), Sq != Sk
    # without the causal mask, rep 1.
    cases = [((LM_PREFILL_B, LM_PREFILL_S, LM_PREFILL_S, 14, 2, 64, True),
              (torch.bfloat16,)),
             ((1, 2048, 2048, 14, 2, 64, True), (torch.bfloat16,)),
             ((2, 256, 256, 4, 2, 64, True), (torch.float32, torch.bfloat16)),
             ((1, 1100, 1100, 14, 2, 64, True), (torch.float32,)),
             ((2, 100, 333, 4, 2, 64, False), (torch.float32,
                                              torch.bfloat16)),
             ((1, 130, 130, 4, 4, 64, True), (torch.float32,
                                              torch.bfloat16)),
             ((1, 300, 300, 14, 2, 128, True), (torch.float32,
                                               torch.bfloat16))]
    for (B, Sq, Sk, H, Kh, dh, causal), dtypes in cases:
        for dt in dtypes:
            q, k, v = flash_inputs(rng, dev, B, Sq, Sk, H, Kh, dh, dt)
            before = read_launches()
            out, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
            kernel = FLASH_FWD[str(dt)]
            qt = q.transpose(1, 2).reshape(B * H, Sq, dh)
            kt = k.transpose(1, 2).reshape(B * Kh, Sk, dh)
            vt = v.transpose(1, 2).reshape(B * Kh, Sk, dh)
            want, want_lse = ref.flash_attention_fwd_ref(
                qt.float(), kt.float(), vt.float(), causal, Sk, H, Kh)
            want = want.reshape(B, H, Sq, dh).transpose(1, 2)
            torch.cuda.synchronize()
            e = float((out.float() - want).abs().max())
            e_lse = float((lse.reshape(B * H, Sq) - want_lse).abs().max())
            err[kernel] = max(err[kernel], e)
            if dt == torch.float32:
                ok = bool(torch.allclose(out, want, rtol=2e-5, atol=2e-6))
                extra = {}
            else:
                # One bf16 ulp of rounding plus the fp32 tolerance of the
                # two summation orders (testing.bf16_within); the ulps
                # against the plain version rounded to bf16 are reported.
                ok = testing.bf16_within(out, want)[0]
                extra = {"bf16_ulps_vs_plain_rounded": bf16_ulps(
                    out, want.to(torch.bfloat16))}
            launched = launched_once((kernel,), before)
            if not e_lse <= 1e-5:
                # Keep the inputs and both lse (under the checkout's
                # chiprun_out/, the git-ignored directory of a GPU run's
                # results) and recompute each side once: the record says
                # which side moved.
                extra["lse_record"] = testing.record_lse_mismatch(
                    ROOT / "chiprun_out" / "flash_lse"
                    / f"mismatch_{B}_{Sq}_{Sk}_{H}_{Kh}_{dh}_{causal}.pt",
                    dict(q=q, k=k, v=v), lse.reshape(B * H, Sq), want_lse,
                    lambda: ops.flash_attention_fwd(
                        q, k, v, causal=causal)[1].reshape(B * H, Sq),
                    lambda: ref.flash_attention_fwd_ref(
                        qt.float(), kt.float(), vt.float(), causal, Sk, H,
                        Kh)[1])
            ok = ok and e_lse <= 1e-5 and launched
            emit("kernels", kernel=kernel,
                 shape=[B, Sq, Sk, H, Kh, dh], causal=causal, dtype=str(dt),
                 max_abs_err=e, lse_max_abs_err=e_lse,
                 launched_once=launched, ok=ok, **extra)
            if not ok:
                raise AssertionError(f"{kernel} != plain at "
                                     f"{(B, Sq, Sk, H, Kh, dh)}, {dt}, or "
                                     f"not launched once ({launched})")
    # Keys padded past sk_true read as the unpadded call, bit for bit; and
    # the same call twice gives the same bits.
    pad = lambda t: torch.cat([t, torch.full_like(t[:, :948], 3.0)], 1)
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = flash_inputs(rng, dev, 1, 1100, 1100, 14, 2, 64, dt)
        for causal in (True, False):
            a = ops.flash_attention_fwd(q, k, v, causal=causal)
            b = ops.flash_attention_fwd(q, pad(k), pad(v), causal=causal,
                                        sk_true=1100)
            c = ops.flash_attention_fwd(q, k, v, causal=causal)
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(a, b))
            again = all(torch.equal(x, y) for x, y in zip(a, c))
            emit("kernels", kernel=FLASH_FWD[str(dt)],
                 case="sk_true padding", causal=causal, dtype=str(dt),
                 bitwise_equal_to_unpadded=same,
                 bitwise_equal_run_to_run=again)
            if not (same and again):
                raise AssertionError(f"padding past sk_true changed the "
                                     f"output, or a second call differs "
                                     f"({dt}, causal {causal})")
    # k-WTA: kernel_bench's (64, 1024) at k 580, 3 and 11 rows (the
    # reference pads 11 to 16), and long rows; f32 and bf16.
    for R, N, kk in ((64, 1024, 580), (3, 1024, 100), (11, 4096, 300),
                     (8, 65536, 6000)):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rng.normal(0, 1, (R, N)).astype(
                np.float32)).to(dev, dt)
            got = ops.kwta(x, kk)
            want = ref.kwta_bisect_ref(x, kk)
            torch.cuda.synchronize()
            same = bool(torch.equal(got, want))
            err["kwta"] = max(err["kwta"], float(
                (got.float() - want.float()).abs().max()))
            kept = (got != 0).sum(-1)
            emit("kernels", kernel="kwta", shape=[R, N], k=kk, dtype=str(dt),
                 bitwise=same, kept_min=int(kept.min()),
                 kept_max=int(kept.max()))
            if not same:
                raise AssertionError(f"kwta != plain at {(R, N)}, k {kk}, "
                                     f"{dt}")
    return err


def check_flash_bwd(dev, rng) -> dict:
    """The flash backward's dq and dk/dv kernels against their plain
    version on the card: the training shape (B 2, S
    2,048, 14/2 heads, dh 64, causal) in bf16 and fp32, the training
    twin's (1,100 queries against keys padded to 2,048, sk_true 1,100),
    Sq != Sk without the causal mask and with keys past sk_true, rep 1,
    a head dim of 80 zero-padded to 128 and one of 128; each call
    launching the dq and dk/dv kernels of its dtype (bf16 the tensor-core
    dq and dk/dv with its fold, fp32 the fp32 tensor-core dq and dk/dv)
    once; at the training shape in each dtype the same call again, bit for
    bit; then the gradients through the autograd Function against
    torch.autograd through the plain ``full_attention``, fp32
    (``testing.grads_close``)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn
    from repro_torch.testing import flash_bwd_plain, grads_close
    err = {"flash_attention_bwd_dq": 0.0, "flash_attention_bwd_dkv": 0.0,
           "flash_attention_bwd_dq_sm90": 0.0,
           "flash_attention_bwd_dkv_sm90": 0.0}
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [((LM_TRAIN_B, LM_TRAIN_S, LM_TRAIN_S, 14, 2, 64, True, None),
              (bf16, f32)),
             ((1, LM_TWIN_S, 2048, 14, 2, 64, True, LM_TWIN_S), (f32,
                                                                bf16)),
             ((1, 100, 333, 4, 2, 64, False, 250), (f32, bf16)),
             ((2, 130, 130, 4, 4, 64, True, None), (f32, bf16)),
             ((1, 96, 200, 4, 1, 80, False, 150), (f32, bf16)),
             ((1, 300, 300, 14, 2, 128, True, None), (bf16, f32))]
    with torch.no_grad():
        for (B, Sq, Sk, H, Kh, dh, causal, skt), dtypes in cases:
            for dt in dtypes:
                q, k, v = flash_inputs(rng, dev, B, Sq, Sk, H, Kh, dh, dt)
                dout = flash_inputs(rng, dev, B, Sq, Sq, H, H, dh, dt)[0]
                out, lse = ops.flash_attention_fwd(q, k, v, causal, skt)
                dq_k, dkv = FLASH_DQ[str(dt)], FLASH_DKV[str(dt)]
                before = read_launches()
                got = ops.flash_attention_bwd(q, k, v, out, lse, dout,
                                              causal, skt)
                launched = launched_once((dq_k, dkv), before)
                want = flash_bwd_plain(q, k, v, out, lse, dout, causal, skt)
                torch.cuda.synchronize()
                e = {n: float((g.float() - w).abs().max())
                     for n, g, w in zip(("dq", "dk", "dv"), got, want)}
                ok = launched and all(grads_close(g, w)
                                      for g, w in zip(got, want))
                if skt is not None:       # keys past sk_true: no gradient
                    ok = ok and not (got[1][:, skt:].any()
                                     or got[2][:, skt:].any())
                extra = {}
                if B == LM_TRAIN_B and Sq == LM_TRAIN_S:
                    again = ops.flash_attention_bwd(q, k, v, out, lse, dout,
                                                    causal, skt)
                    same = all(torch.equal(a, b)
                               for a, b in zip(got, again))
                    extra["bitwise_equal_run_to_run"] = same
                    ok = ok and same
                err[dq_k] = max(err[dq_k], e["dq"])
                err[dkv] = max(err[dkv], e["dk"], e["dv"])
                emit("kernels", kernel=f"{dq_k} + {dkv}",
                     shape=[B, Sq, Sk, H, Kh, dh], causal=causal,
                     sk_true=skt, dtype=str(dt), max_abs_err=e,
                     max_abs_grad={n: float(w.abs().max()) for n, w in
                                   zip(("dq", "dk", "dv"), want)},
                     launched_once=launched, ok=ok, **extra)
                if not ok:
                    raise AssertionError(f"flash backward != plain at "
                                         f"{(B, Sq, Sk, H, Kh, dh)}, {dt}, "
                                         f"or launches wrong ({launched}), "
                                         f"or not bitwise run to run "
                                         f"({extra})")
    q, k, v = (t.requires_grad_() for t in flash_inputs(
        rng, dev, 2, 300, 300, 14, 2, 64, f32))
    g = flash_inputs(rng, dev, 2, 300, 300, 14, 14, 64, f32)[0]
    got = torch.autograd.grad(ops.flash_attention_fwd(q, k, v, True)[0],
                              (q, k, v), g)
    want = torch.autograd.grad(attn.full_attention(q, k, v, True),
                               (q, k, v), g)
    torch.cuda.synchronize()
    ok = all(grads_close(a, b) for a, b in zip(got, want))
    emit("kernels", kernel="flash_attention_bwd",
         case="autograd Function vs torch.autograd of full_attention",
         shape=[2, 300, 300, 14, 2, 64], dtype="torch.float32",
         max_abs_err={n: float((a - b).abs().max())
                      for n, a, b in zip(("dq", "dk", "dv"), got, want)},
         ok=ok)
    if not ok:
        raise AssertionError("flash gradients differ from torch.autograd "
                             "through full_attention")
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
            zero = kmm.wbs_matmul_read_noise(
                inp["sign"], inp["code"], inp["w"], inp["gains"], 0.0, words,
                adc_bits=adc, adc_range=ADC_RANGE)
            plain_kernel = kmm.wbs_matmul(inp["sign"], inp["code"], inp["w"],
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


# The port's kernels (csrc/*.cu) live in an anonymous namespace at the top.
_PORT_KERNEL = re.compile(
    r"(void )?(\(anonymous namespace\)|flash_f32_sm90)::")


def device_busy(fn) -> dict:
    """Run ``fn`` once under torch.profiler: the device's busy time (the
    summed durations of its kernels, copies and sets), the kernels that
    took most of it, and every kernel of the port that ran. The profiler's start-up and per-op cost stretch
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
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {"device_busy_s": sum(us for _, us in by_name.values()) / 1e6,
            "traced_wall_s": traced_wall,
            "top_kernels": [{"name": n[:60], "calls": c, "device_ms": us / 1e3}
                            for n, (c, us) in ranked[:6]],
            "port_kernels": [{"name": n[:60], "calls": c,
                              "device_ms": us / 1e3}
                             for n, (c, us) in ranked if _PORT_KERNEL.match(n)]}


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
    ``table1:<backend>``, ``lm_prefill`` and ``lm_serve`` (the LM
    phase's 2-layer fp32 twins), ``lm_train`` (the training twin).
    Returns what the checks read, as plain values and CPU tensors."""
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
    if kind == "lm_prefill":
        cfg, params = lm_twin_model(cpu)
        return {"logits": lm_prefill_twin_logits(cfg, params, cpu)}
    if kind == "lm_serve":
        cfg, params = lm_twin_model(cpu)
        _, reqs = lm_serve(cfg, params, lm_twin_prompts(cfg.vocab), cpu,
                           LM_TWIN_MAX_NEW, keep_logits=True)
        return {"tokens": [r.tokens for r in reqs],
                "logits": [torch.stack(r.logits) for r in reqs]}
    if kind == "lm_train":
        return lm_train_twin_run(cpu)
    if kind == "read_noise":
        run = protocol_run(cpu, read_noise_backend(), n_tasks=1,
                           epochs=RN_CPU_EPOCHS)
    else:
        run = protocol_run(cpu, kind.split(":")[1])
    return {k: run[k] for k in ("R", "MA", "losses", "wall_s")}


#: Every twin, longest first (measured on the CPU of the card's host).
TWINS = ("protocol:analog", "protocol:wbs", "lm_train", "software",
         "table1:analog_state", "protocol:ideal", "table1:cmos",
         "read_noise", "lm_serve", "lm_prefill")


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
# Phase lm: the LM zoo's dense serving path (qwen2-0.5B)
# ---------------------------------------------------------------------------

def lm_config(n_layers: Optional[int] = None, dtype=None):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(LM)
    return dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers,
                               dtype=dtype or cfg.dtype)


def lm_full_model(dev, dtype=None):
    """Full qwen2-0.5B in bf16 (or ``dtype``), weights drawn on the card
    from seed 0."""
    import torch
    from repro_torch.models import lm
    cfg = lm_config(dtype=dtype)
    return cfg, lm.init_params(torch.Generator(dev).manual_seed(0), cfg, dev)


def lm_twin_model(dev):
    """The twins' model: full width, fp32, 2 layers, its weights drawn on
    the CPU from seed 1 and moved to ``dev`` (the card and the CPU twin
    hold the same bits)."""
    import torch
    from repro_torch.models import lm
    from repro_torch.utils import tree_to
    cfg = lm_config(LM_TWIN_LAYERS, torch.float32)
    params = lm.init_params(torch.Generator().manual_seed(1), cfg, "cpu")
    return cfg, tree_to(params, dev)


def lm_prompts(vocab: int) -> list:
    """The burst's 32 seeded prompts of 8-64 tokens."""
    import numpy as np
    rng = np.random.default_rng(0)
    lens = rng.integers(LM_PROMPT_MIN, LM_PROMPT_MAX + 1, LM_REQUESTS)
    return [rng.integers(0, vocab, n).tolist() for n in lens]


def lm_twin_prompts(vocab: int) -> list:
    prompts = lm_prompts(vocab)
    return [prompts[i] for i in LM_CONTRACT]


def lm_prefill_twin_logits(cfg, params, dev):
    """The twin prefill's logits (f32, on the CPU) at LM_TWIN_ROWS."""
    import numpy as np
    import torch
    from repro_torch.models import lm
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (1, LM_TWIN_S)))
    logits = lm.prefill(params, cfg, {"tokens": toks})
    return logits[0, list(LM_TWIN_ROWS)].to(torch.float32).cpu()


def lm_serve(cfg, params, prompts, dev, max_new: int = LM_MAX_NEW,
             keep_logits: bool = False):
    """``prompts`` through a fresh 8-slot ``ServeEngine`` on ``dev``, all
    submitted at once; returns (engine, requests)."""
    from repro_torch.serve import ServeConfig, ServeEngine
    eng = ServeEngine(cfg, ServeConfig(
        batch_slots=LM_SLOTS, max_len=LM_MAX_LEN, eos_token=-1,
        torch_device=dev, keep_logits=keep_logits), params)
    reqs = [eng.submit(p, max_new) for p in prompts]
    eng.run_until_drained()
    _sync(dev)
    return eng, reqs


def lm_path(dev, twins: dict) -> dict:
    """(i) the full model's prefill through the flash kernel, (ii) its
    2-layer fp32 twin against the CPU's, (iii) the serve burst, (iv) the
    batch-composition contract, (v) the serve twin."""
    import numpy as np
    import torch
    from repro_torch import testing
    from repro_torch.models import lm
    cfg, params = lm_full_model(dev)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (LM_PREFILL_B, LM_PREFILL_S)))

    def prefill():
        out = lm.prefill(params, cfg, {"tokens": toks})
        _sync(dev)
        return out
    prefill()                                          # warm-up
    reset_launches()
    t0 = time.perf_counter()
    logits = prefill()
    prefill_s = time.perf_counter() - t0
    pre_launches = read_launches()
    require_launches("lm_prefill", pre_launches,
                     ("flash_attention_fwd_sm90",))
    if pre_launches["flash_attention_fwd_sm90"] != cfg.n_layers or \
            pre_launches["flash_attention_fwd"]:
        raise AssertionError(f"lm_prefill: {pre_launches} flash launches, "
                             f"want {cfg.n_layers} of the bf16 tensor-core "
                             f"forward (one a layer) and no other")
    if logits.shape != (LM_PREFILL_B, LM_PREFILL_S, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError("prefill logits not finite or wrong shape")
    del logits
    emit("lm", part="prefill", config=LM, layers=cfg.n_layers,
         dtype=str(cfg.dtype), tokens=[LM_PREFILL_B, LM_PREFILL_S],
         launches=pre_launches, wall_ms=prefill_s * 1e3,
         tokens_per_s=LM_PREFILL_B * LM_PREFILL_S / prefill_s,
         traced_run=busy_share(prefill, prefill_s))

    tcfg, tparams = lm_twin_model(dev)
    reset_launches()
    got = lm_prefill_twin_logits(tcfg, tparams, dev)
    twin_all = read_launches()
    twin_launches = twin_all["flash_attention_fwd"]
    cpu = twins["lm_prefill"].result()["logits"]
    d = float((got - cpu).abs().max())
    emit("lm", part="prefill_twin", layers=LM_TWIN_LAYERS, tokens=LM_TWIN_S,
         rows_compared=len(LM_TWIN_ROWS), flash_launches=twin_launches,
         max_abs_d_logits=d, max_abs_logit=float(cpu.abs().max()),
         atol=LM_PREFILL_ATOL)
    if twin_launches != LM_TWIN_LAYERS or \
            twin_all["flash_attention_fwd_sm90"] or d > LM_PREFILL_ATOL:
        raise AssertionError(f"prefill twin: logits {d:.3g} from the CPU's "
                             f"(atol {LM_PREFILL_ATOL}), launches "
                             f"{twin_all} (want {LM_TWIN_LAYERS} of the "
                             "fp32 forward)")

    prompts = lm_prompts(cfg.vocab)
    lm_serve(cfg, params, prompts[:2], dev, max_new=4)  # warm-up
    reset_launches()
    t0 = time.perf_counter()
    eng, reqs = lm_serve(cfg, params, prompts, dev)
    serve_s = time.perf_counter() - t0
    serve_launches = read_launches()
    stats = eng.request_stats()
    if stats["requests"] != LM_REQUESTS or \
            any(len(r.tokens) != LM_MAX_NEW for r in reqs):
        raise AssertionError(f"served {stats['requests']} requests")
    # The busy share over a window that fills all 8 slots, served
    # untraced and then traced: the burst's first 8 prompts cut to 8
    # tokens, 8 new tokens each — 56 one-slot prefill calls and 8 decode
    # calls of all 8 slots, as the burst mixes one-slot prefills with
    # grouped decodes. The profiler spends about a second a call
    # collecting the events of its about 3,100 PyTorch ops, so the whole
    # burst would take over half an hour.
    wave = [p[:LM_PROMPT_MIN] for p in prompts[:LM_SLOTS]]
    t0 = time.perf_counter()
    weng, _ = lm_serve(cfg, params, wave, dev, LM_TWIN_MAX_NEW)
    busy = busy_share(lambda: lm_serve(cfg, params, wave, dev,
                                       LM_TWIN_MAX_NEW),
                      time.perf_counter() - t0)
    busy["window"] = (f"{len(wave)} requests of {LM_PROMPT_MIN} prompt "
                      f"tokens, {LM_TWIN_MAX_NEW} new each, "
                      f"{LM_SLOTS} slots, {weng.decode_calls} decode "
                      "calls")
    emit("lm", part="serve", slots=LM_SLOTS, max_len=LM_MAX_LEN,
         requests=stats["requests"], max_new=LM_MAX_NEW,
         prompt_tokens=sum(len(p) for p in prompts), wall_s=serve_s,
         launches=serve_launches, traced_run=busy,
         **{k: stats[k] for k in ("steps_run", "decode_calls", "latency_ms",
                                  "queue_wait_ms", "decode_ms",
                                  "tokens_per_s", "sequences_per_s",
                                  "tokens_generated")})

    alone = {i: lm_serve(cfg, params, [prompts[i]], dev)[1][0].tokens
             for i in LM_CONTRACT}
    same = {i: alone[i] == reqs[i].tokens for i in LM_CONTRACT}
    emit("lm", part="contract", requests=list(LM_CONTRACT),
         alone_equals_burst=same)
    if not all(same.values()):
        raise AssertionError(f"batch composition changed tokens: {same}")

    _, treqs = lm_serve(tcfg, tparams, lm_twin_prompts(cfg.vocab), dev,
                        LM_TWIN_MAX_NEW, keep_logits=True)
    cpu = twins["lm_serve"].result()
    first = max(float((r.logits[0] - c[0]).abs().max())
                for r, c in zip(treqs, cpu["logits"]))
    rep = testing.compare_tokens([r.tokens for r in treqs], cpu["tokens"],
                                 [r.logits for r in treqs], cpu["logits"],
                                 atol=LM_SERVE_ATOL)
    emit("lm", part="serve_twin", layers=LM_TWIN_LAYERS,
         requests=len(treqs), max_new=LM_TWIN_MAX_NEW,
         first_logits_max_abs_d=first, atol=LM_SERVE_ATOL,
         tokens_equal=[r.tokens for r in treqs] == cpu["tokens"],
         **rep.as_dict())
    if first > LM_SERVE_ATOL:
        raise AssertionError(f"serve twin: first logits {first:.3g} apart")
    return {"lm_prefill": pre_launches, "lm_prefill_twin": twin_all,
            "lm_serve": serve_launches}


# ---------------------------------------------------------------------------
# Phase lm_train: the LM training path (qwen2-0.5B)
# ---------------------------------------------------------------------------

def lm_train_batcher(cfg, B: int, S: int, seed: int = 0):
    """``ShardedBatcher`` over ``lm_token_batch(rng, B, S, vocab)``; the
    ``Trainer`` moves each batch to its device."""
    from repro_torch.data.pipeline import ShardedBatcher
    from repro_torch.data.synthetic import lm_token_batch
    return ShardedBatcher(lambda rng, step: lm_token_batch(rng, B, S,
                                                           cfg.vocab),
                          seed=seed)


def lm_train_twin_run(dev) -> dict:
    """The training twin on ``dev``: the LM twins' 2-layer fp32 model,
    LM_TRAIN_TWIN_STEPS Trainer steps on 1 × LM_TWIN_S tokens, warmup 0.
    Returns its losses, grad norms and final params (on the CPU), and
    each kernel's launches in the run."""
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.utils import tree_to
    cfg, params = lm_twin_model(dev)
    tr = Trainer(cfg, TrainConfig(warmup_steps=0),
                 lm_train_batcher(cfg, 1, LM_TWIN_S, seed=2),
                 params=params, device=dev)
    reset_launches()
    hist = tr.run(steps=LM_TRAIN_TWIN_STEPS)
    _sync(dev)
    launches = read_launches()
    return {"losses": [h["loss"] for h in hist],
            "grad_norms": [h["grad_norm"] for h in hist],
            "params": tree_to(tr.params, "cpu"), "launches": launches}


def train_twin_distances(run: dict, cpu: dict, init: dict) -> dict:
    """How far a training twin run lies from the CPU's: the largest
    relative loss and grad-norm differences over the steps, and the
    final params' largest difference and its L2 norm over that of the
    CPU run's update (params minus the initial ones)."""
    import numpy as np
    import torch
    from repro_torch.utils import flatten_dict
    rel = lambda a, b: float(np.max(np.abs(np.subtract(a, b))
                                    / np.abs(b)))
    got, want, p0 = (flatten_dict(t) for t in (run["params"],
                                                cpu["params"], init))
    d2 = u2 = 0.0
    dmax = 0.0
    for k, w in want.items():
        d = (got[k].double() - w.double())
        d2 += float(torch.sum(d * d))
        u = w.double() - p0[k].double()
        u2 += float(torch.sum(u * u))
        dmax = max(dmax, float(d.abs().max()))
    return {"loss_max_rel_d": rel(run["losses"], cpu["losses"]),
            "grad_norm_max_rel_d": rel(run["grad_norms"],
                                       cpu["grad_norms"]),
            "params_max_abs_d": dmax,
            "params_d_over_update": (d2 / u2) ** 0.5}


def lm_train(dev, twins: dict) -> dict:
    """(i) the full model's training steps in bf16 and (ii) in fp32
    through the flash forward and backward kernels of each dtype
    (:func:`lm_train_full`); (iii) the 2-layer fp32 training twin against
    the CPU's run of the same steps."""
    import torch
    launches = lm_train_full(dev, torch.bfloat16, LM_TRAIN_WARMUP,
                             LM_TRAIN_STEPS, "train")
    launches_fp32 = lm_train_full(dev, torch.float32, LM_TRAIN_F32_WARMUP,
                                  LM_TRAIN_F32_STEPS, "train_fp32")

    run = lm_train_twin_run(dev)
    cpu = twins["lm_train"].result()
    d = train_twin_distances(run, cpu, lm_twin_model(torch.device("cpu"))[1])
    # The fp32 twin takes the fp32 forward, dq and dk/dv kernels.
    n = LM_TWIN_LAYERS * LM_TRAIN_TWIN_STEPS
    twin_want = {"flash_attention_fwd": 2 * n, "flash_attention_bwd_dq": n,
                 "flash_attention_bwd_dkv": n}
    twin_exact = all(run["launches"][k] == n for k, n in twin_want.items()) \
        and all(c == 0 for k, c in run["launches"].items()
                if k not in twin_want)
    ok = (twin_exact and d["loss_max_rel_d"] <= LM_TRAIN_LOSS_RTOL
          and d["grad_norm_max_rel_d"] <= LM_TRAIN_GNORM_RTOL
          and d["params_d_over_update"] <= LM_TRAIN_PARAMS_REL)
    emit("lm_train", part="twin", layers=LM_TWIN_LAYERS, tokens=LM_TWIN_S,
         steps=LM_TRAIN_TWIN_STEPS, losses=run["losses"],
         cpu_losses=cpu["losses"], grad_norms=run["grad_norms"],
         cpu_grad_norms=cpu["grad_norms"], launches=run["launches"],
         tolerances={"loss_rtol": LM_TRAIN_LOSS_RTOL,
                     "grad_norm_rtol": LM_TRAIN_GNORM_RTOL,
                     "params_d_over_update": LM_TRAIN_PARAMS_REL},
         ok=ok, **d)
    if not ok:
        raise AssertionError(f"lm_train twin: {d}, launches "
                             f"{run['launches']} (want {twin_want})")
    return {"lm_train": launches, "lm_train_fp32": launches_fp32,
            "lm_train_twin": run["launches"]}


def lm_train_full(dev, dtype, warmup: int, steps: int, part: str) -> dict:
    """The full model (:func:`lm_full_model`) in ``dtype`` through
    ``Trainer`` at ``TrainConfig``'s defaults, 2 × 2,048 tokens a
    step: ``steps`` timed after ``warmup``: ms a step, tokens/s, finite
    losses and grad norms, peak memory, exactly 48 launches of the
    dtype's flash forward (24 and their 24 recomputes), 24 of its dq and
    24 of its dk/dv a step and none of another flash kernel; then a
    traced window of LM_TRAIN_TRACE_STEPS beside the same number run
    untraced: the busy share and the device time a step of the flash
    forward, dq, dk/dv (with its fold) and the fp32 backward's split.
    Returns the timed steps' launches."""
    import numpy as np
    import torch
    from repro_torch.train import TrainConfig, Trainer
    cfg, params = lm_full_model(dev, dtype)
    tr = Trainer(cfg, TrainConfig(),
                 lm_train_batcher(cfg, LM_TRAIN_B, LM_TRAIN_S),
                 params=params, device=dev)
    del params
    tr.run(steps=warmup)
    _sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    hist = tr.run(steps=steps)[-steps:]
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    want = {FLASH_FWD[str(dtype)]: 2 * cfg.n_layers,
            FLASH_DQ[str(dtype)]: cfg.n_layers,
            FLASH_DKV[str(dtype)]: cfg.n_layers}
    exact = all(launches[k] == n * steps for k, n in want.items()) \
        and all(c == 0 for k, c in launches.items() if k not in want)
    losses = [h["loss"] for h in hist]
    gnorms = [h["grad_norm"] for h in hist]
    finite = bool(np.isfinite(losses).all() and np.isfinite(gnorms).all())
    t0 = time.perf_counter()
    tr.run(steps=LM_TRAIN_TRACE_STEPS)
    _sync(dev)
    busy = busy_share(lambda: tr.run(steps=LM_TRAIN_TRACE_STEPS),
                      time.perf_counter() - t0)
    busy["window"] = f"{LM_TRAIN_TRACE_STEPS} train steps"
    per_step = lambda name: sum(
        k["device_ms"] for k in busy["port_kernels"]
        if name in k["name"]) / LM_TRAIN_TRACE_STEPS
    emit("lm_train", part=part, config=LM, layers=cfg.n_layers,
         dtype=str(cfg.dtype), remat=cfg.remat,
         tokens_per_step=[LM_TRAIN_B, LM_TRAIN_S], steps=steps,
         n_params=tr.n_params,
         step_ms_median=float(np.median([h["sec"] for h in hist])) * 1e3,
         step_ms=[h["sec"] * 1e3 for h in hist], wall_s=wall,
         tokens_per_s=steps * LM_TRAIN_B * LM_TRAIN_S / wall,
         losses=losses, grad_norms=gnorms,
         max_memory_allocated_gb=peak / 1e9, launches=launches,
         launches_per_step={k: v / steps for k, v in launches.items()},
         launches_exact=exact, finite=finite,
         device_ms_per_step={n: per_step(k) for n, k in (
             ("fwd", "flash_fwd_"), ("dq", "flash_bwd_dq_"),
             ("dkv", "flash_bwd_dkv_"), ("split", "split_inputs_kernel"))},
         traced_run=busy)
    if not (finite and exact):
        raise AssertionError(f"lm_train {part}: finite {finite}, launches "
                             f"{launches} (want {want} a step)")
    return launches


def kwta_path(dev) -> dict:
    """``ops.kwta`` once at kernel_bench's (64, 1024), k 580: its launch
    counts."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    g = torch.from_numpy(np.random.default_rng(3).normal(
        0, 1, (64, 1024)).astype(np.float32)).to(dev)
    reset_launches()
    out = ops.kwta(g, 580)
    _sync(dev)
    launches = read_launches()
    require_launches("ops_kwta", launches, ("kwta",))
    emit("kwta", shape=[64, 1024], k=580, launches=launches,
         kept=int((out != 0).sum(-1).max()))
    return launches


# ---------------------------------------------------------------------------
# Phase 8: times
# ---------------------------------------------------------------------------

def times(dev) -> dict:
    """Each kernel's wrapper on inputs prepared as the main path hands them
    over, so ``ms`` is the launch alone."""
    import numpy as np
    import torch
    from repro_torch.kernels import (miru_readout, miru_scan, ops, ref,
                                     wbs_matmul, wbs_miru_scan)
    rng = np.random.default_rng(1)
    out = {}
    with torch.no_grad():
        # The hoisted drive (the kernels line) and the per-step recurrent
        # product, each unpadded as ops.wbs_matmul hands it over.
        for key, (M, K, N, xs) in {
                "wbs_matmul": (SLOTS * CHUNK, N_X, N_H, 1.0),
                "wbs_matmul@step": (SLOTS, N_H, N_H, BETA)}.items():
            inp = matmul_inputs(rng, dev, M, K, N, xs)
            deq = (inp["sign"].float() * inp["code"].float()) \
                * 2.0 ** -N_BITS
            # By linearity Σ_b g_b·(plane_b⊙sign)@w = (sign⊙Σ_b
            # g_b·plane_b)@w: one product plus an n_bits-term decode per
            # input.
            flops = 2.0 * M * K * N + 2.0 * M * K * N_BITS
            n_bytes = 2 * M * K + 4 * K * N + 4 * N_BITS + 4 * M * N
            b, by = bound_ms(flops, n_bytes)
            out[key] = dict(
                shape=[M, K, N],
                ms=time_graph(lambda: wbs_matmul.wbs_matmul(
                    inp["sign"], inp["code"], inp["w"], inp["gains"])),
                plain_ms=time_graph(lambda: ref.wbs_matmul_ref(**inp)),
                library_ms=time_graph(lambda: torch.matmul(deq, inp["w"])),
                library="torch.matmul of the dequantized operand",
                bound_ms=b, bound_by=by)
        # The read-noise variant at the per-step shape of train (d): the
        # product as above plus, per weight element, one Box–Muller normal
        # (counted as 8 fp64 operations: two scalings, log, ×−2, sqrt,
        # ×2π, cos, the product; Philox's integer rounds are not counted,
        # so the bound is a floor) and the perturbation's 3 fp32
        # operations. No single PyTorch call computes this function.
        M, K, N = CL_BATCH, N_H, N_H
        inp = matmul_inputs(rng, dev, M, K, N, BETA)
        words = ops.read_key_words(np.asarray([0, 42], np.uint32))
        flops = 2.0 * M * K * N + 2.0 * M * K * N_BITS + 3.0 * K * N
        n_bytes = 2 * M * K + 4 * K * N + 4 * N_BITS + 4 * M * N
        b, by = bound_ms(flops, n_bytes, flops64=8.0 * K * N)
        out["wbs_matmul_read_noise"] = dict(
            shape=[M, K, N], read_sigma=READ_SIGMA,
            ms=time_graph(lambda: wbs_matmul.wbs_matmul_read_noise(
                inp["sign"], inp["code"], inp["w"], inp["gains"], READ_SIGMA,
                words)),
            plain_ms=time_graph(lambda: ref.wbs_matmul_read_noise_ref(
                **inp, read_sigma=READ_SIGMA, key_words=words),
                reps=2, rounds=3),
            library_ms=None, library=None, bound_ms=b, bound_by=by)
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
            library_ms=None, library=None, bound_ms=b, bound_by=by)
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
            library_ms=None, library=None, bound_ms=b, bound_by=by)
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
                library="torch.addmm",
                bound_ms=b, bound_by=by)
        out.update(lm_times(dev, rng))
    for name, t in out.items():
        emit("times", kernel=name, **t)
    return out


def sdpa_yardstick(q, k, v, H, Kh):
    """``scaled_dot_product_attention`` on (B, S, heads, dh) q, k, v, causal
    with GQA, as a zero-argument call and its name (timed here only; the
    port never calls it)."""
    import torch.nn.functional as F
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    try:
        F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                       enable_gqa=True)
        return (lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, enable_gqa=True),
            "F.scaled_dot_product_attention(enable_gqa=True)")
    except TypeError:              # a PyTorch without enable_gqa
        kr, vr = (x.repeat_interleave(H // Kh, 1) for x in (kh, vh))
        return (lambda: F.scaled_dot_product_attention(qh, kr, vr,
                                                       is_causal=True),
                "F.scaled_dot_product_attention, K/V repeated")


def flash_bound(flops: float, n_bytes: float, dtype) -> tuple[float, str]:
    """bf16 operands: the bf16 tensor-core peak; fp32 operands: the fp32
    peak of the CUDA cores (the tensor cores' TF32 drops 13 bits of each
    operand, so they compute another function)."""
    import torch
    if dtype == torch.bfloat16:
        return bound_ms(0.0, n_bytes, flops_bf16_tc=flops)
    return bound_ms(flops, n_bytes)


def lm_times(dev, rng) -> dict:
    """The flash forwards at the qwen2-0.5B prefill's shape (the bf16
    tensor-core kernel the prefill runs on bf16 inputs, the fp32 route's
    kernel on fp32 inputs), each beside its plain version and
    ``scaled_dot_product_attention`` on the same inputs, then the
    backward's kernels (:func:`flash_bwd_times`) and the k-WTA bisection
    at kernel_bench's shape beside the exact top-k."""
    import torch
    from repro_torch.kernels import flash_attention, kwta, ref
    out = {}
    B, S, H, Kh, dh = LM_PREFILL_B, LM_PREFILL_S, 14, 2, 64
    kw = dict(causal=True, sk_true=S, q_heads=H, kv_heads=Kh,
              scale=dh ** -0.5)
    for key, dt in (("flash_attention_fwd_sm90", torch.bfloat16),
                    ("flash_attention_fwd", torch.float32)):
        q, k, v = flash_inputs(rng, dev, B, S, S, H, Kh, dh, dt)
        qt = q.transpose(1, 2).reshape(B * H, S, dh).contiguous()
        kt = k.transpose(1, 2).reshape(B * Kh, S, dh).contiguous()
        vt = v.transpose(1, 2).reshape(B * Kh, S, dh).contiguous()
        # Causal: half the score matrix, q, k, v read once and out, lse
        # written once. The tensor-core kernel splits p into three bf16
        # terms, three products for p.V: 2x the operations
        # (bound_split_ms).
        flops = 4.0 * B * H * S * S * dh / 2
        size = qt.element_size()
        n_bytes = size * (2 * B * H * S * dh + 2 * B * Kh * S * dh) \
            + 4 * B * H * S
        b, by = flash_bound(flops, n_bytes, dt)
        yard, yard_name = sdpa_yardstick(q, k, v, H, Kh)
        fn = getattr(flash_attention, key)
        out[key] = dict(
            shape=[B, S, H, Kh, dh], dtype=str(dt), causal=True,
            ms=time_graph(lambda: fn(qt, kt, vt, **kw)),
            plain_ms=time_graph(lambda: ref.flash_attention_fwd_ref(
                qt, kt, vt, True, S, H, Kh), reps=2, rounds=3),
            library_ms=time_graph(yard), library=f"{yard_name}, {dt}",
            bound_ms=b, bound_by=by)
        if dt == torch.bfloat16:
            out[key]["bound_split_ms"] = flash_bound(2 * flops, n_bytes,
                                                     dt)[0]
    out.update(flash_bwd_times(dev, rng))
    # k-WTA at kernel_bench's (64, 1024), k 580, f32: the function reads x
    # and writes out once and makes |x| and iters + 2 comparisons an
    # element. The yardstick is the exact top-k k-WTA (torch.topk), a
    # different function (exact, not bisected).
    R, N, kk, iters = 64, 1024, 580, 32
    x = torch.from_numpy(rng.normal(0, 1, (R, N)).astype("float32")).to(dev)
    b, by = bound_ms(R * N * (iters + 3.0), 2 * 4 * R * N)
    out["kwta"] = dict(
        shape=[R, N], k=kk, dtype="float32",
        ms=time_graph(lambda: kwta.kwta(x, kk, iters)),
        plain_ms=time_graph(lambda: ref.kwta_bisect_ref(x, kk, iters),
                            reps=2, rounds=3),
        library_ms=time_graph(lambda: ref.kwta_ref(x, kk)),
        library="exact top-k k-WTA (torch.topk), a different function",
        bound_ms=b, bound_by=by)
    return out


def flash_bwd_times(dev, rng) -> dict:
    """The flash backward's kernels at the training shape (B 2, S 2,048,
    14/2 heads, dh 64, causal): on bf16 inputs the tensor-core dq and
    dk/dv (with its fold) the train step runs, on fp32 inputs the fp32
    route's tensor-core dq and dk/dv (each with its split of the inputs,
    dk/dv with its fold); each beside the plain version and the backward
    of ``scaled_dot_product_attention`` over a saved forward on the same
    inputs (both compute dq, dk and dv together: the same figure stands
    beside each kernel of the dtype), and the whole bf16 backward as the
    port runs it (delta's torch reduction, dq and dk/dv)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, ref
    B, S, H, Kh, dh = LM_TRAIN_B, LM_TRAIN_S, 14, 2, 64
    kw = dict(causal=True, sk_true=S, q_heads=H, kv_heads=Kh,
              scale=dh ** -0.5)
    # Causal halves each of the 2·S·S·dh products a head: dq takes three
    # (s, dO·vᵀ, ds·k), dk/dv four (s, dO·vᵀ, pᵀ·dO, dsᵀ·q), against q,
    # k, v, dO, lse and delta read once and the outputs written once. The
    # bf16 kernels split ds (dq) and pᵀ and dsᵀ (dk/dv) into bf16 hi and
    # lo: four products instead of three, six instead of four
    # (bound_split_ms). The fp32 kernels carry every operand in three bf16
    # terms and make each product of six: their bound is that bf16
    # tensor-core work, beside the fp32 products on the CUDA cores
    # (bound_cuda_cores_ms).
    prod = 2.0 * B * H * S * S * dh / 2
    out = {}
    for dt, dq_k, dkv_k in ((torch.bfloat16, "flash_attention_bwd_dq_sm90",
                             "flash_attention_bwd_dkv_sm90"),
                            (torch.float32, "flash_attention_bwd_dq",
                             "flash_attention_bwd_dkv")):
        q, k, v = flash_inputs(rng, dev, B, S, S, H, Kh, dh, dt)
        do = flash_inputs(rng, dev, B, S, S, H, H, dh, dt)[0]
        heads = lambda t: t.transpose(1, 2).reshape(-1, S, dh).contiguous()
        qt, kt, vt, dot = heads(q), heads(k), heads(v), heads(do)
        fwd = (flash_attention.flash_attention_fwd_sm90
               if dt == torch.bfloat16
               else flash_attention.flash_attention_fwd)
        ot, lse = fwd(qt, kt, vt, **kw)
        delta = torch.sum(dot.float() * ot.float(), -1)
        args = (qt, kt, vt, dot, lse, delta)
        size = qt.element_size()
        reads = size * (2 * B * H * S * dh + 2 * B * Kh * S * dh) \
            + 2 * 4 * B * H * S
        dq_bytes = reads + size * B * H * S * dh
        dkv_bytes = reads + 2 * size * B * Kh * S * dh
        plain = time_graph(lambda: ref.flash_attention_bwd_ref(
            qt, kt, vt, ot, lse, dot, True, S, H, Kh), reps=2, rounds=3)
        qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        with torch.enable_grad():
            o = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                               enable_gqa=True)
        g = do.transpose(1, 2).contiguous()
        # CUDA events around back-to-back calls, not a graph: autograd
        # runs each backward op on its forward's stream, which a capture
        # on another stream cannot record.
        lib = time_events(lambda: torch.autograd.grad(o, (qh, kh, vh), g,
                                                      retain_graph=True))
        lib_name = (f"backward of F.scaled_dot_product_attention(is_causal, "
                    f"enable_gqa) over a saved forward, {dt}, dq, dk and dv "
                    f"together (CUDA events over 20 calls, no graph)")
        dq_fn = getattr(flash_attention, dq_k)
        dkv_fn = getattr(flash_attention, dkv_k)
        common = dict(shape=[B, S, H, Kh, dh], dtype=str(dt), causal=True,
                      plain_ms=plain, plain="ref.flash_attention_bwd_ref: "
                      "dq, dk and dv together", library_ms=lib,
                      library=lib_name)
        for key, fn, n_prod, n_bytes in ((dq_k, dq_fn, 3, dq_bytes),
                                         (dkv_k, dkv_fn, 4, dkv_bytes)):
            out[key] = dict(ms=time_graph(lambda: fn(*args, **kw)), **common)
            if dt == torch.bfloat16:
                b, by = flash_bound(n_prod * prod, n_bytes, dt)
            else:
                b, by = bound_ms(0.0, n_bytes,
                                 flops_bf16_tc=6 * n_prod * prod)
                out[key].update(
                    bound_cuda_cores_ms=flash_bound(n_prod * prod, n_bytes,
                                                    dt)[0],
                    note="the split of the inputs into bf16 terms"
                         + (" and the fold" if key == dkv_k else ""))
            out[key].update(bound_ms=b, bound_by=by)
        if dt != torch.bfloat16:
            continue
        out[dq_k]["bound_split_ms"] = flash_bound(4 * prod, dq_bytes, dt)[0]
        out[dkv_k].update(
            bound_split_ms=flash_bound(6 * prod, dkv_bytes, dt)[0],
            note="the dk/dv kernel and the fold of the rep partials")

        def whole():
            d = torch.sum(dot.float() * ot.float(), -1)
            dq_fn(qt, kt, vt, dot, lse, d, **kw)
            dkv_fn(qt, kt, vt, dot, lse, d, **kw)
        b, by = flash_bound(7 * prod, reads + size * B * H * S * dh
                            + 2 * size * B * Kh * S * dh, dt)
        out["flash_attention_bwd@whole"] = dict(
            ms=time_graph(whole), bound_ms=b, bound_by=by, **common,
            note="delta's torch reduction, the tensor-core dq and dk/dv")
    return out


def require_no_local_memory(libs: dict) -> None:
    """Fail if nvcc gave a tensor-core flash kernel (the forward, dq or
    dk/dv: every library named ``*_sm90``) a stack frame. wgmma reads its
    register operands after the instruction issues; a value the compiler
    keeps in local memory is loaded into a scratch register that it may
    reuse while the tensor cores still read it, which makes results change
    from run to run (seen on the card with a 128-byte frame)."""
    frames = {n: [ln.strip() for ln in p.with_suffix(".log").read_text()
                  .splitlines() if "bytes stack frame" in ln
                  and not ln.strip().startswith("0 bytes stack frame")]
              for n, p in libs.items() if n.endswith("_sm90")}
    if any(frames.values()):
        raise AssertionError(f"sm90 flash kernels use local memory: {frames}")


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
    require_no_local_memory(libs)

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
        lmr = lm_path(dev, twins)
        lmt = lm_train(dev, twins)
        kw = kwta_path(dev)
        t = times(dev)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)

    # launches: each kernel's count in the run of the path it was ported
    # for (serve for the WBS kernels and the readout, train (a) for the
    # ideal scan, train (d) for the read-noise product, the LM prefill for
    # the bf16 tensor-core forward and its fp32 twin for the fp32 forward,
    # LM training for the tensor-core dq and dk/dv and its full-depth fp32
    # run for the fp32 dq and dk/dv, ops.kwta at the bench shape for
    # k-WTA);
    # launches_by_path has every path's count.
    by_path = {"serve": run["launches"], "train_software": sw["launches"],
               "train_protocol_ideal": cl["ideal"]["launches"],
               "train_protocol_wbs": cl["wbs"]["launches"],
               "train_protocol_analog": cl["analog"]["launches"],
               "train_read_noise": rn["launches"],
               "table1_analog_state": t1["analog_state"],
               "table1_cmos": t1["cmos"], **lmr, **lmt, "ops_kwta": kw}
    own = {"wbs_matmul": "serve", "wbs_matmul_read_noise": "train_read_noise",
           "wbs_miru_scan": "serve", "miru_scan": "train_software",
           "miru_readout": "serve", "flash_attention_fwd": "lm_prefill_twin",
           "flash_attention_bwd_dq": "lm_train_fp32",
           "flash_attention_bwd_dkv": "lm_train_fp32", "kwta": "ops_kwta",
           "flash_attention_fwd_sm90": "lm_prefill",
           "flash_attention_bwd_dkv_sm90": "lm_train",
           "flash_attention_bwd_dq_sm90": "lm_train"}
    src = "src/repro_torch/kernels/csrc/"
    lib = {"flash_attention_fwd": "flash_attention_fwd",   # else the module
           "flash_attention_bwd_dq": "flash_attention_bwd_dq_f32_sm90",
           "flash_attention_bwd_dkv": "flash_attention_bwd_dkv_f32_sm90",
           "flash_attention_fwd_sm90": "flash_attention_fwd_sm90",
           "flash_attention_bwd_dkv_sm90": "flash_attention_bwd_dkv_sm90",
           "flash_attention_bwd_dq_sm90": "flash_attention_bwd_dq_sm90"}
    source = {k: src + lib.get(k, KERNELS[k][0]) + ".cu" for k in KERNELS}
    replaces = {"wbs_matmul": "src/repro/kernels/wbs_matmul.py:99",
                "wbs_matmul_read_noise": "src/repro/kernels/wbs_matmul.py:99 "
                                         "(read_sigma > 0: :36-45, :65-73)",
                "wbs_miru_scan": "src/repro/kernels/wbs_miru_scan.py:105",
                "miru_scan": "src/repro/kernels/miru_scan.py:47",
                "miru_readout": "h @ w_o in src/repro/core/miru.py:133 (not "
                                "a TPU kernel; repair of queue C)",
                "flash_attention_fwd": "src/repro/kernels/flash_attention.py"
                                       ":227 (pallas_call :270)",
                "flash_attention_bwd_dq": "src/repro/kernels/"
                                          "flash_attention.py:161 "
                                          "(pallas_call :185)",
                "flash_attention_bwd_dkv": "src/repro/kernels/"
                                           "flash_attention.py:161 "
                                           "(pallas_call :205)",
                "kwta": "src/repro/kernels/kwta.py:47 (pallas_call :53)",
                "flash_attention_fwd_sm90": "src/repro/kernels/"
                                            "flash_attention.py:227 "
                                            "(pallas_call :270), bf16",
                "flash_attention_bwd_dkv_sm90": "src/repro/kernels/"
                                                "flash_attention.py:161 "
                                                "(pallas_call :205), bf16",
                "flash_attention_bwd_dq_sm90": "src/repro/kernels/"
                                               "flash_attention.py:161 "
                                               "(pallas_call :185), bf16"}
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": source[k],
         "replaces": replaces[k], "launches": by_path[own[k]][k],
         "launches_by_path": {p: c[k] for p, c in by_path.items()},
         "max_abs_err": err[k], "ms": t[k]["ms"], "plain_ms": t[k]["plain_ms"],
         "bound_ms": t[k]["bound_ms"], "bound_by": t[k]["bound_by"],
         "library_ms": t[k]["library_ms"], "library": t[k]["library"],
         **{f: t[k][f] for f in ("bound_split_ms", "bound_cuda_cores_ms",
                                 "note") if f in t[k]}}
        for k in KERNELS]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
