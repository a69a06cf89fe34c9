#!/usr/bin/env python3
"""Drive the PyTorch port's MiRU serving and training paths, the analog
substrates, the Table I metering and the LM zoo's serving and training
paths (dense, MoE, SSM, hybrid, MLA, encoder-decoder, vision prefix),
unsharded and under a sharding context, on one NVIDIA GPU, and check
them.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. device: the card's name and count, and ``nvidia-smi``'s name and power
   limit;
2. build: the twelve CUDA libraries compiled by nvcc for sm_90a from
   ``src/repro_torch/kernels/csrc/``, one nvcc each, all at once;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main paths' shapes: bitwise for the recurrences, the readout, the
   read-noise WBS product and k-WTA, tie-aware (rtol = atol = 2e-5) for
   the WBS product; the fused WBS scan also where its clusters' edges
   fall (B 1, 5, 33; H 37, 130, on both sides of the switch of U's slab
   to global memory, 1,024); the read-noise variant also at σ = 0 against the
   plain kernel (bitwise), on two identical rows of one call (identical
   outputs), and in its moments over 512 keys; the flash-attention
   forward at the qwen2-0.5B prefill's shape and five others (fp32
   ``out`` at rtol 2e-5 / atol 2e-6, ``lse`` at atol 1e-5, bf16 ``out``
   within one bf16 ulp plus that fp32 tolerance; bf16 through the
   tensor-core kernel, fp32 through the fp32 tensor-core one on inputs
   split into bf16 terms, each call launching its dtype's kernel once),
   and with keys padded past ``sk_true`` bit
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
   ``LM_TRAIN_PARAMS_REL``);
train_adam. the BPTT + Adam baseline through the Fig. 4 protocol
   (``algo="adam"``, 6 epochs a task, otherwise train (b)'s settings) on
   ``ideal`` and ``wbs`` (the drive, the fused scan and the readout
   launched under autograd, the scan's straight-through backward once a
   step): the reference's bands (task 0 > 0.75, R[-1, 0] > 0.25, DFA
   within 0.25 of Adam's MA and above 0.45), the leading losses and R
   against the port's CPU run (``ideal`` at train (b)'s tolerances,
   ``wbs`` at ``R_TOLERANCE["adam_wbs"]``), launches and
   backward calls a step, ms a step, the busy share of a traced window;
   TF32 off;
grad_contract. the scan's gradients through the kernel forward equal to
   those on the plain forward's residuals, bit for bit, at (64, 28, 100)
   and (32, 28, 100); fused and per-step gradients of a CE loss on
   ``wbs`` at the paper's shape within rtol 1e-4, atol 1e-6; the hidden
   gradients nonzero;
train_ragged. DFA on ``wbs`` at N_H over the few-shot keyword stream
   (ragged in T and n_train) under a PadPolicy: finite, above chance, R
   and the leading losses against the port's CPU run; ``force=True``
   equal to it; the seq-MNIST surrogate (28 × 28) with a PadPolicy
   attached but aligned equal to the run without, bit for bit;
train_loss_aware. ``loss_aware`` replay with Adam on ``ideal`` (the
   device-resident buffer): full after task 0, the permuted stream's
   bands, the metered replay traffic equal to the exact count, R and the
   leading losses against the port's CPU run;
scenarios. the compiled whole-sequence run (``repro_torch.scenarios``)
   at the paper's width: 3 permuted tasks of 600/200 examples, DFA,
   batch 32, reservoir 512, 2 epochs a task. ``run_compiled`` equals
   ``run_continual`` bit for bit on ``ideal``, ``wbs`` and
   ``analog_state`` (metered and endurance-tracked there: the write,
   drift and replay counters, the tracker's maps and update counts
   equal, the other counters in the ratio of the evaluations); on
   ``wbs`` the drive, the fused scan and the readout launch once each a
   train step and an evaluation; ``ObsSpec(cadence=10, tracer=...)``
   leaves R, losses and params as they were, the loop's RunLog equals the
   compiled run's, the exported trace holds the schedule, compile and
   execute spans; ``seeds=[0, 1]``'s first seed is the single-seed run;
   the ``wbs`` run against its CPU twin (``LOSS_AGREE_STEPS``,
   ``R_TOLERANCE``); ``run_sweep`` over permuted, class_incremental and
   keyword_fewshot (the masked steps) × ``wbs``, ``analog_state`` at one
   epoch and 2 tasks: every cell compiled, MA above chance, power,
   GOPS/W and a timeline; ms a train step of the loop and the compiled
   run (no speedup asserted), compile and execute seconds, the busy
   share of a traced compiled run;
obs. the recurrent engine serves phase 4's burst with a tracer: the same
   logits bit for bit, one ``serve.step`` span per engine step; the LM
   engine serves the serve twin's four requests on the 2-layer fp32
   model with a tracer and decodes the tokens it decodes without; a run
   record written through ``JsonlSink`` reads back and names the card;
   then ``ops.kwta`` once at (64, 1024), k 580;
faults. the fault model (``repro_torch.faults``) at the paper's width on
   ``wbs`` (8-bit drive and ADC, |w| ≤ 1.0; 2 permuted tasks of 600/200,
   2 epochs, through ``run_compiled``): a zero-rate ``FaultSpec`` changes
   no bit; at 1 % stuck cells (half SA0, half SA1) every forward launches
   the drive, the fused scan and the readout once, and fused equals
   per-step bit for bit; read upsets at 1e-3 are keyed and take the
   per-step path (2·T ``wbs_matmul``, no scan, a forward); the march
   self-test recovers the exact stuck map (2 launches a tile); clean,
   faulty and mitigated accuracy (march, remap onto 4 spare columns,
   bias compensation, 16 recalibration steps) over mask seeds 0-2
   against the CPU twin; the wear-out run's onset over
   ``lifespan_years``' projection within [0.5, 1.5]; fault_bench's
   half-recovery gate at its own setup, against the CPU twin and the
   reference's figures (the reference fails the gate: no accuracy lost);
   ms a step and the busy share of the masked run;
fleet. ``run_fleet`` of 8 chips on ``analog_state`` (metered, endurance
   tracked, profile "mild", 0.5 % SA0 + 0.5 % SA1 with a rate spread of
   0.5 and a dead-chip rate of 0.125: two dead chips; 2 permuted tasks of
   192/200, 1 epoch): every chip reported, the dead ones at chance, the
   launches a forward, each chip against the CPU twin's, the fleet
   aggregate and ``format_fleet``; the "none" fleet of 4 chips on
   ``wbs`` equal to ``run_compiled(seeds=device_seeds)`` bit for bit; ms
   a chip-step and the busy share of each;
lm_zoo. the LM zoo's MoE, SSM and hybrid families: (i)
   granite-moe-3b-a800m at its published config in bf16 (32 layers, 40
   experts top-8, 3.37 B parameters drawn on the card): a 2,048-token
   prefill with one launch of the bf16 tensor-core flash forward a layer
   and no other kernel, run twice bit for bit (the MoE combine sums in a
   fixed order), its busy share; the lm phase's 32-request burst through
   the 8-slot ``ServeEngine`` (its decode one CUDA graph a call): ms a
   decode call and an engine step, tokens/s, the busy share of an
   8-request window; (ii) its 2-layer fp32 twin on 1,100 tokens against
   the CPU's: each MoE layer's routing (a token's experts may differ only
   at a CPU near-tie, ``ZOO_ROUTE_GAP``), then the logits before the
   first differing token within ``LM_PREFILL_ATOL``; two training steps
   of the twin against the CPU's (``LM_TRAIN_LOSS_RTOL``,
   ``LM_TRAIN_GNORM_RTOL``); (iii) mamba2-370m at its published config
   in bf16: the prefill through the chunked SSD (no kernel), the burst,
   four of its requests alone decoding the burst's tokens, the fp32 twin
   against the CPU, the twin's token-by-token decode against its prefill
   on the card within 1e-4, its training twin; (iv) jamba's smoke config
   with its int8 cache in fp32 and bf16: a 1,100-token prefill through
   the dtype's flash forward (one launch), one request served, in fp32
   against the CPU's tokens (tie-aware, ``LM_SERVE_ATOL``); (v) one
   train step each (granite at 4 layers on 2,048 tokens: 8 flash
   forward, 4 dq, 4 dk/dv launches; mamba2 at 4 layers; jamba), finite,
   and jamba's training twin; the phase's seconds;
lm_quant. the LM zoo on the paper's crossbar (``quant_mode="wbs"``):
   every projection of qwen2-0.5B at its published widths in bf16 (seed
   0, drawn on the card) one launch of the WBS product. (i) A prefill of
   1 × 1,100 tokens (past the 1,024 attention chunk: the flash branch):
   exactly 168 ``wbs_matmul`` (7 a layer; the tied head stays the float
   einsum) and 24 bf16 flash-forward launches, finite logits, two runs
   bit for bit, the distance from the float model on the same weights
   and the argmax agreement (printed, not gated: the reference's bands
   are for its 2-layer smoke config), the busy share; (ii) the 2-layer
   fp32 twin on 1 × 256 tokens against the CPU's (``LMQ_TWIN_ATOL``,
   ``LMQ_TWIN_MEAN_ATOL``; its attention chunk cut to 200 so that it
   takes the fp32 flash forward, 2 launches), and the same twin with a
   planted fault (a 7-bit drive) failing that check; (iii) a metered 8-slot
   ``ServeEngine`` (``device="wbs"``, ``meter=True``, decode replayed as
   a CUDA graph) serving 16 seeded requests of 8-64 prompt tokens, 16
   new tokens each: its counters equal the hand count exactly, the same
   traffic at the smoke width on the card (its decode a CUDA graph too)
   equals the CPU's eager engine exactly in its counters and, tie-aware
   at ``LMQ_SERVE_ATOL``, in its tokens, the ``energy`` block of
   ``request_stats``, ms a decode call, the busy share of a window on a
   captured engine, and one request
   alone in slot 0 decoding the same tokens twice; (iv) the ``miru``
   mixer at full width: float on 1 × 1,024 tokens (24 ``miru_scan``
   launches at H 896, no other kernel) and quantized on 1 × 128 (exactly
   24 × (2·128 + 4) ``wbs_matmul``), finite, and their 2-layer fp32
   twins against the CPU (float on 256 tokens at ``LM_PREFILL_ATOL``,
   quantized on 64 at the twin tolerances); (v) one quantized
   ``Trainer`` step at 4 layers on 1 × 1,100 tokens (bf16: exactly 56
   ``wbs_matmul``, 8 flash forwards, 4 dq and 4 dk/dv), finite, and the
   2-layer fp32 training twin on 256 tokens (chunk 200: exactly 28
   ``wbs_matmul``, 4 fp32 flash forwards, 2 dq and 2 dk/dv) against the
   CPU's step (``LMQ_TRAIN_LOSS_RTOL``, ``LMQ_TRAIN_GNORM_RTOL``); the
   phase's seconds;
lm_mla. MLA and deepseek-v3 with 8-bit Adam: (i) the (192, 128) flash
   kernels (the bf16 tensor-core forward, dq and dk/dv, and the fp32
   route's) against their plain versions at B·H 16, Sq = Sk = 2,048,
   causal and not, and causal with sk_true 1,900 (the flash checks'
   bounds, each kernel launched once a call, the backward twice bit for
   bit); (ii) deepseek-v3-671b at its published widths in bf16, depth cut
   to 2 layers (1 dense, 1 MoE: 13.94 B parameters drawn on the card): a
   1 × 2,048 prefill with one launch of the bf16 (192, 128) forward a
   layer and no other kernel, two runs bit for bit, its busy share; (iii)
   an 8-slot ``ServeEngine`` at max_len 4,096 on the burst's first 16
   prompts, 32 new tokens each (decode one CUDA graph a call): ms a
   decode call, the latent cache's bytes beside a per-head bf16 KV
   cache's; a decode stepping half the slots leaves every latent row of
   the others the same bits; (iv) one ``adam_8bit`` step of one dense MLA
   layer (2.44 B parameters) on 1 × 2,048 tokens: 2 forwards, 1 dq and 1
   dk/dv of the bf16 (192, 128) kernels, the loss, ms, peak memory, the
   moments int8; (v) the fp32 twins (``MLA_TWIN_CUT``, 256 tokens,
   chunk 200: the fp32 (192, 128) kernels) against the CPU's: the
   routing and the prefill's logits (``LM_PREFILL_ATOL``), one step's
   loss, grad norm and every gradient; the phase's seconds;
lm_multimodal. the encoder-decoder and the vision prefix: (i) the (64,
   64) flash kernels of both dtypes, not causal, against their plain
   versions at B·H 16: the forward at 4,096² (seamless's encoder), the
   forward, dq and dk/dv at Sq 2,048 × Sk 4,096 (its cross-attention),
   also with sk_true 3,000 (the flash checks' bounds, each kernel
   launched once a call, the backward twice bit for bit); (ii)
   seamless-m4t-medium at its published config in bf16 (977.7 M
   parameters drawn on the card): a 1 × (4,096 frames, 2,048 tokens)
   prefill with 36 bf16 flash forwards (12 encoder, 12 decoder, 12
   cross) and no other kernel, two runs bit for bit, its busy share; one
   AdamW step on it (72 forwards, 36 dq, 36 dk/dv), its loss, ms and
   peak memory; an 8-row cross cache filled from the encoder (rows of
   4,096 and 2,500 frames, 1.61 GB), 64 teacher-forced decode steps, each
   row's largest logit difference from its forward and the greedy
   agreement, finite; (iii) llava-next-34b at its published widths, depth
   cut to 4 layers (3.15 B parameters): a 1 × (2,880 patches + 1,216
   tokens) prefill (4 causal bf16 (128, 128) forwards over 4,096 keys),
   the 8-slot engine at max_len 4,096 on 16 text requests of 32 new
   tokens through its int8 cache (decode one CUDA graph a call), one
   AdamW step at 2 layers (2.07 B parameters; at 4 the functional
   AdamW's fp32 trees need ~90 GB) with its peak memory; (iv) fp32 twins with the published
   head dims (``MM_TWIN_CUT``, chunk 200: the encoder, decoder and cross
   attention on the fp32 flash kernels with padded keys) against the
   CPU's: the prefill's logits (``LM_PREFILL_ATOL``), one step's loss,
   grad norm and every gradient; seamless's decode from its encoder's
   cross cache against its forward within ``MM_DECODE_ATOL``; the
   phase's seconds;
distributed. the sharded paths at world size 1: a one-rank NCCL group
   (a FileStore) and a (1, 1) mesh over ("data", "model"); granite-moe
   (published, 32 layers) and deepseek-v3 (published widths, 2 layers)
   under ``ShardingContext(attn_mode="ulysses", moe_mode="ep")`` and
   mamba2 (published, 48 layers) under Ulysses, each a 1 × 2,048 bf16
   prefill with its parameters placed by ``param_specs``, against the
   same prefill with no context: the logits bit for bit (else within
   ``LM_PREFILL_ATOL``), one bf16 flash forward an attention layer and
   no other kernel, both prefills' ms, the EP all-to-alls and bank
   gathers; one MoE layer of each MoE model, EP against the global
   dispatch bit for bit; a checkpoint restored onto the mesh as
   DTensors bit for bit; the phase's seconds and ``nvidia-smi``'s line;
8. times: CUDA-event timings of each kernel, its plain version and,
   where one exists, one PyTorch call computing the same function (for
   k-WTA the exact top-k, a different function; for the flash backward
   the backward of ``scaled_dot_product_attention``), each over a CUDA
   graph of repeated launches, beside the least time the card could
   take (for the bf16 tensor-core flash kernels also that bound with
   their bf16 split's extra products, ``bound_split_ms``; for the fp32
   forward and backward the bound of its six bf16 products a product
   and, beside it, that of the fp32 products on the CUDA cores,
   ``bound_cuda_cores_ms``); the WBS product at both main-path shapes
   (the drive and the per-step product) beside ``torch.matmul`` of the
   dequantized operand; the fused WBS scan at the serve and the train
   (b)/(c) shapes, with its launch (rows, cluster, blocks), the bound of
   its plane sums' FMAs, its bytes' and a model of its serial floor
   (``serial_floor_model_ms``, not a measurement); the fp32 route's flash
   forward, dq and dk/dv on fp32 inputs beside
   ``scaled_dot_product_attention`` on the same fp32 inputs (TF32 off);
   the WBS product also at the quantized LM's decode and prefill shapes
   (``lm_shapes``) beside ``torch.matmul`` of the float product; the
   (192, 128) flash kernels of each dtype at the deepseek prefill's shape
   (1 × 2,048, 128 heads, causal) beside their plain versions and
   ``scaled_dot_product_attention`` under the backend that takes
   dh != dv, with bounds from each product's width; the flash kernels
   of each dtype at lm_multimodal's shapes, seamless's (64, 64) ones (1
   × 16 heads, not causal: the forward at 4,096², the forward, dq and
   dk/dv at 2,048 × 4,096; bounds with no causal halving) and llava's
   (128, 128) ones (1 × 56 query heads over 8 KV heads, causal at
   4,096²: the forward, dq and dk/dv) beside their plain versions and
   ``scaled_dot_product_attention`` (``flash_times``).

The CPU runs that the card's results are held against (the twins) run
at the start, in :data:`TWIN_WORKERS` worker processes of one thread
each, beside the card's phases; each phase waits for its twin's result.

Then the ``kernels`` line, the ``nvidia-smi`` line, and the final
``{"ok": true, ...}`` line. Any failure exits non-zero before the final
line; without a CUDA device the script exits 2 and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple, Optional

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
#
# - train (e), Adam on ``wbs``: sound runs spread wider than DFA's. The
#   port's CPU runs at 2 and 8 threads agree on every loss; the run at 1
#   thread leaves them at step 10, its R 3 test examples (MA 0.005) away;
#   the card leaves the 1-thread run at step 9 with R 4 examples (MA
#   0.0033) away, and lies 5 examples from the 2-thread run. So it has
#   its own R entry, past that spread; its leading losses (3 steps, as
#   DFA's on ``wbs``) are the sharper check.
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5
# Leading steps of train (b)-(h) whose losses must agree (train (a): all).
LOSS_AGREE_STEPS = {"ideal": 100, "wbs": 3, "analog": 5, "read_noise": 5,
                    "adam_wbs": 3}
PARAMS_ATOL = 1e-3            # train (a)'s final params against the CPU's
R_TOLERANCE = {"ideal": (2, 0.01), "wbs": (4, 0.01), "analog": (4, 0.01),
               "adam_wbs": (6, 0.01)}
# Train (e), the Adam settings of tests/test_continual.py: 6 epochs a task
# (DFA's 14 match Adam's optimization effort, not its steps), the rest as
# train (b); its losses and R are held to the CPU at train (b)'s entries
# on ``ideal`` and at ``adam_wbs``'s on ``wbs``.
ADAM_EPOCHS = 6
# Train (g): the few-shot keyword stream (make_keyword_fewshot_tasks'
# defaults: 4 tasks of 64, 32, 16 and 8 shots, 16-32 frames of 20
# features, 4 classes; 200 test utterances a task, train (b)'s test-set
# size, the scale of R_TOLERANCE), DFA on ``wbs`` at N_H under a
# PadPolicy that keeps each epoch's partial batch; then the seq-MNIST
# surrogate (make_seq_mnist_tasks, offline: 28 × 28) aligned, with and
# without the policy, RAG_MNIST_TASKS × CL_TRAIN/CL_TEST for
# RAG_MNIST_EPOCHS.
RAG_BATCH, RAG_CAPACITY = 16, 64
RAG_MNIST_TASKS, RAG_MNIST_EPOCHS = 2, 2
# Train (h): loss_aware replay (ReplaySpec(capacity=32,
# policy="loss_aware"), tests/test_replay_policies.py's buffer) with Adam
# on ``ideal``, train (e)'s stream and epochs.
LA_CAPACITY = 32
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
# The lm_zoo phase: granite-moe-3b-a800m (configs/granite_moe_3b_a800m.py
# CONFIG: 32 layers, d 1,536, 24 query heads over 8 KV heads of 64, 40
# experts top-8 of d_ff 512, vocab 49,155) and mamba2-370m
# (configs/mamba2_370m.py CONFIG: 48 layers, d 1,024, state 128, heads of
# 64, vocab 50,280) at their published configs in bf16, weights drawn on
# the card from seed 0; jamba-1.5-large-398b at its smoke config (one
# superblock of 4 layers, d 32) with its int8 cache: at its published
# widths one superblock holds 45.2 B parameters, more than the card's
# memory. Each prefill takes one ZOO_PREFILL_S-token prompt; serving
# takes the lm phase's burst. The twins: the published width in fp32 cut
# to ZOO_TWIN_LAYERS (jamba: its smoke config), weights drawn on the CPU
# from seed 1, the prefill on LM_TWIN_S tokens (the flash branch). A
# token's MoE routing may differ from the CPU's only where the CPU's gap
# between its k-th and (k+1)-th router probability is below
# ZOO_ROUTE_GAP. mamba2's token-by-token decode of ZOO_DECODE_S tokens on
# the twin model equals its prefill within the reference's own
# ZOO_DECODE_ATOL (tests/test_models.py). One train step each at
# ZOO_TRAIN_LAYERS (granite's on ZOO_PREFILL_S tokens launches its flash
# backward), and the fp32 twins ZOO_TRAIN_TWIN_STEPS steps on
# ZOO_TRAIN_TWIN_S tokens against the CPU at lm_train's twin tolerances.
# The phase aims to stay within ZOO_BUDGET_S (printed, not asserted).
ZOO_GRANITE, ZOO_MAMBA2 = "granite-moe-3b-a800m", "mamba2-370m"
ZOO_JAMBA = "jamba-1.5-large-398b"
ZOO_PREFILL_S, ZOO_TWIN_LAYERS, ZOO_ROUTE_GAP = 2048, 2, 1e-5
ZOO_DECODE_S, ZOO_DECODE_ATOL = 300, 1e-4
ZOO_TRAIN_LAYERS, ZOO_TRAIN_TWIN_S, ZOO_TRAIN_TWIN_STEPS = 4, 256, 2
ZOO_BUDGET_S = 150
# The lm_quant phase: qwen2-0.5B (the lm phase's model, LM) with
# quant_mode="wbs". The prefill takes LMQ_PREFILL_S tokens, past the
# config's 1,024-token attention chunk, so attention takes the flash
# branch. Its twins (the published width in fp32, LM_TWIN_LAYERS layers,
# the lm phase's twin weights) take LMQ_TWIN_S tokens with an attention
# chunk of LMQ_TWIN_CHUNK, so that their attention takes the flash branch
# too (the keys padded to 400 and masked by their true length, as the
# prefill's are). On the CPU every quantized product is the bit-plane
# plain version, one pass over K a tile: a 256-token 2-layer forward
# takes about 40 s of one thread, the training step more.
LMQ_PREFILL_S, LMQ_TWIN_S, LMQ_TWIN_CHUNK = 1100, 256, 200
# The twins' logit tolerances, from one flip of a code: on the card the
# WBS products are the CPU's bits, but a last-bit difference elsewhere
# (a norm's reduction, the attention, the tied head) moves an input of
# some product across a rounding boundary of its 8-bit quantizer, and
# that step of 1/255 of the absmax, carried through the later
# quantizers, moves the logits (up to about 3). Measured on the CPU at
# the twin's width and depth: on 64 tokens one input code moved by one
# step, in four places, moves them by 0.029-0.040 at most (mean |d|
# 0.0040-0.0054), one ulp on every norm weight of a layer by 0.021-0.053
# (mean 0.0010-0.0051); on 256 tokens one code by 0.038-0.048, one ulp
# on the weights of one norm of one layer (chunk 200) by 0.007-0.045
# (mean at most 0.0049). A 7-bit drive, the planted fault, moves them
# 0.24 (mean 0.028) on 64 tokens and 0.34 (mean 0.040) on 256; the
# drive's planes joined LSB first 3.97 (mean 0.59) on 64. The tolerances
# lie about twice above the one-step moves and below the fault. The ulp
# and fault moves: ``tools/lmq_tolerances.py prefill``.
LMQ_TWIN_ATOL, LMQ_TWIN_MEAN_ATOL = 0.1, 0.012
LMQ_FAULT_BITS = 7
# The metered engine: LM_SLOTS slots, LM_MAX_LEN, the burst's first
# LMQ_REQUESTS prompts, LMQ_MAX_NEW new tokens each, greedy, no EOS.
LMQ_REQUESTS, LMQ_MAX_NEW = 16, 16
# The same traffic at qwen2's smoke width (fp32) on the card and on the
# CPU: tokens tie-aware, logits within LMQ_SERVE_ATOL. The products are
# the CPU's bits, but a last-bit difference elsewhere can flip an input
# code; one flipped code moves smoke logits (|logit| < 0.4) by up to
# 2.6e-3, and one ulp on every norm weight of a layer moves this
# traffic's by 1.3e-3-2.4e-3 with no token changed (both measured on the
# CPU; the latter by ``tools/lmq_tolerances.py serve``). The tolerance
# lies about four such moves above.
LMQ_SERVE_ATOL = 1e-2
# The WBS product at the quantized LM's shapes, held bit for bit to its
# plain version and timed: a decode call's (LM_SLOTS rows) and the
# prefill's (LMQ_PREFILL_S rows) SwiGLU gate (d_model 896 → d_ff 4,864)
# and down projection (4,864 → 896).
LMQ_D, LMQ_FF = 896, 4864
LMQ_WBS_SHAPES = {"decode": (LM_SLOTS, LMQ_D, LMQ_FF),
                  "decode_down": (LM_SLOTS, LMQ_FF, LMQ_D),
                  "prefill": (LMQ_PREFILL_S, LMQ_D, LMQ_FF),
                  "prefill_down": (LMQ_PREFILL_S, LMQ_FF, LMQ_D)}
# The miru mixer: the float prefill on LMQ_MIRU_S tokens, the quantized
# one (per-step: two WBS products a step) on LMQ_MIRU_Q_S; their twins on
# LMQ_MIRU_TWIN_S and LMQ_MIRU_Q_TWIN_S tokens.
LMQ_MIRU_S, LMQ_MIRU_Q_S = 1024, 128
LMQ_MIRU_TWIN_S, LMQ_MIRU_Q_TWIN_S = 256, 64
# One quantized train step at LMQ_TRAIN_LAYERS layers on LMQ_PREFILL_S
# tokens (bf16), and the fp32 training twin's one step on LMQ_TWIN_S
# tokens against the CPU's. Measured on the CPU (relative): one ulp on
# every norm weight of a layer moves the loss by 4.2e-6 and the grad
# norm by 1.2e-5 on 64 tokens, by 4.4e-5 and 2.5e-4 on 256; the 7-bit
# drive by 4.1e-4 and 3.9e-3 on 64, by 3.0e-4 and 2.4e-3 on 256
# (``tools/lmq_tolerances.py train``).
LMQ_TRAIN_LAYERS = 4
LMQ_TRAIN_LOSS_RTOL, LMQ_TRAIN_GNORM_RTOL = 1e-4, 1e-3
LMQ_BUDGET_S = 150
# The serve paths' traced window: the burst's first 8 prompts cut to
# ZOO_TRACE_PROMPT tokens, ZOO_TRACE_NEW new tokens each.
ZOO_TRACE_PROMPT, ZOO_TRACE_NEW = 2, 2
# The lm_mla phase: deepseek-v3-671b (configs/deepseek_v3_671b.py CONFIG:
# d 7,168, 128 heads of MLA (q_lora 1,536, kv_lora 512, nope 128, rope
# 64, v 128: attention at (dh, dv) = (192, 128)), 256 routed experts top-8
# plus 1 shared of d_ff 2,048, dense d_ff 18,432, vocab 129,280) at its
# published widths in bf16, weights drawn on the card from seed 0, depth
# cut to MLA_LAYERS with MLA_DENSE dense (13.94 B parameters, 27.9 GB; 61
# layers, 671 B, fit no card). A 1 × MLA_PREFILL_S prefill (past the
# 1,024 chunk: the bf16 (192, 128) flash forward once a layer); the
# 8-slot engine at MLA_MAX_LEN on the burst's first MLA_REQUESTS prompts,
# MLA_MAX_NEW new tokens each, its decode one CUDA graph a call; one
# adam_8bit step at MLA_TRAIN_LAYERS (one dense MLA layer: 2.44 B
# parameters; with the MoE layer, 13.94 B, bf16 params, grads and two
# int8 moments would take 83.6 GB) on 1 × MLA_PREFILL_S tokens.
MLA = "deepseek-v3-671b"
MLA_LAYERS, MLA_DENSE, MLA_PREFILL_S = 2, 1, 2048
MLA_MAX_LEN, MLA_REQUESTS, MLA_MAX_NEW = 4096, 16, 32
MLA_TRAIN_LAYERS = 1
# Its fp32 twins, on the card and on the CPU: the published head dims
# (nope 128, rope 64, v 128: the fp32 (192, 128) flash kernels), the rest
# cut (MLA_TWIN_CUT), weights drawn on the CPU from seed 1; MLA_TWIN_S
# tokens with the attention chunk cut to MLA_TWIN_CHUNK so that they take
# the flash branch. The prefill's logits within LM_PREFILL_ATOL (routing
# by routing_agreement), one step's loss and grad norm within
# LM_TRAIN_LOSS_RTOL / LM_TRAIN_GNORM_RTOL and each gradient tensor within
# MLA_TWIN_GRAD_REL of its largest entry (a dropped scale or a mask
# moves a tensor by O(1) of it).
MLA_TWIN_CUT = dict(d_model=512, n_heads=4, n_kv_heads=4, q_lora_rank=128,
                    kv_lora_rank=64, n_experts=8, top_k=2, moe_d_ff=256,
                    d_ff=1024, vocab=1024, n_layers=2, first_dense_layers=1)
MLA_TWIN_S, MLA_TWIN_CHUNK, MLA_TWIN_GRAD_REL = 256, 200, 1e-2
# The (192, 128) kernels against their plain versions: B·H = 16 heads
# (MLA's K/V are per head: rep 1), Sq = Sk = 2,048, causal and not, and
# once with sk_true below Sk; timed at the deepseek prefill's shape (1 ×
# 2,048, 128 heads).
MLA_CHECK_H, MLA_CHECK_S, MLA_CHECK_SKT = 16, 2048, 1900
MLA_TIME_H = 128
MLA_BUDGET_S = 150
# The lm_multimodal phase: seamless-m4t-medium (configs/
# seamless_m4t_medium.py CONFIG: 12 encoder + 12 decoder layers, d 1,024,
# 16 heads of 64, d_ff 4,096, vocab 256,206; 977.7 M parameters) whole, in
# bf16, and llava-next-34b (configs/llava_next_34b.py CONFIG: d 7,168, 56
# query heads over 8 KV heads of 128, d_ff 20,480, vocab 64,000, int8
# cache) at its published widths with depth cut to MM_LLAVA_LAYERS (3.15 B
# parameters; its 60 layers hold 68.8 GB of weights), each drawn on the
# card from seed 0. seamless prefills and trains one AdamW step on 1 ×
# (MM_ENC_S frames, MM_DEC_S tokens): train_4k's frames a sequence, the
# decoder's tokens cut so that the cross-attention runs at Sq != Sk; its
# decode fills a cross cache of MM_DEC_ROWS rows from the encoder
# (MM_ENC_LENS frames, half the rows each) and teacher-forces
# MM_DECODE_T tokens. llava prefills 1 × (MM_PATCHES patches +
# MM_LLAVA_TEXT tokens), train_4k's split, and serves the burst's first
# MM_REQUESTS prompts, MM_MAX_NEW new tokens each, through the 8-slot
# engine at MM_MAX_LEN (text-only, as the reference's decode); its AdamW
# step on the same batch runs at MM_LLAVA_TRAIN_LAYERS (2.07 B
# parameters): the port's AdamW is functional, so the old and the new
# fp32 moments and two fp32 update trees are alive at once, about 28 B a
# parameter, and at 4 layers (3.20 B) the step ran out of the card's 80
# GB. The fp32 twins keep the published head dims (the
# fp32 (64, 64) and (128, 128) kernels) and cut the rest (MM_TWIN_CUT),
# weights drawn on the CPU from seed 1, the attention chunk cut to
# MM_TWIN_CHUNK so that the encoder's, the decoder's and the cross
# attention all take flash with padded keys: logits within
# LM_PREFILL_ATOL, one step's loss, grad norm and each gradient at
# lm_mla's twin tolerances; seamless's decode from its encoder's cross
# cache equal to its forward within MM_DECODE_ATOL (the reference's bound
# for bf16-cached attention, tests/test_models.py).
MM_SEAMLESS, MM_LLAVA = "seamless-m4t-medium", "llava-next-34b"
MM_ENC_S, MM_DEC_S = 4096, 2048
MM_DEC_ROWS, MM_ENC_LENS, MM_DECODE_T = 8, (4096, 2500), 64
MM_LLAVA_LAYERS, MM_PATCHES, MM_LLAVA_TEXT = 4, 2880, 1216
MM_LLAVA_TRAIN_LAYERS = 2
MM_MAX_LEN, MM_REQUESTS, MM_MAX_NEW = 4096, 16, 32
MM_TWIN_LAYERS = 2
MM_TWIN_CUT = {
    MM_SEAMLESS: dict(d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
                      vocab=1024, n_enc_layers=2),
    MM_LLAVA: dict(d_model=512, n_heads=4, n_kv_heads=2, d_ff=1024,
                   vocab=1024, n_frontend_tokens=96)}
MM_TWIN_PREFIX = {MM_SEAMLESS: 300, MM_LLAVA: 96}     # frames, patches
MM_TWIN_TEXT = {MM_SEAMLESS: 256, MM_LLAVA: 160}
MM_TWIN_CHUNK, MM_TWIN_DECODE_T, MM_DECODE_ATOL = 200, 32, 5e-2
# The flash kernels at this slice's shapes against their plain versions
# (MM_CHECKS): seamless's at B·H = MM_CHECK_H heads of 64, llava's at its
# published MM_LLAVA_HEADS (query, KV) of 128.
MM_CHECK_H, MM_CHECK_SKT = 16, 3000
MM_LLAVA_HEADS = (56, 8)
MM_BUDGET_S = 150
# The scenarios phase: the paper's width (28×100×10) through the compiled
# whole-sequence run (repro_torch.scenarios.run_compiled): SC_TASKS
# permuted tasks of SC_TRAIN/SC_TEST examples, DFA, batch CL_BATCH,
# reservoir CL_CAPACITY, SC_EPOCHS epochs a task; obs windows of
# SC_CADENCE steps; then run_sweep over SWEEP_SCENARIOS × SWEEP_BACKENDS
# at one epoch and SWEEP_TASKS tasks.
SC_TASKS, SC_TRAIN, SC_TEST, SC_EPOCHS, SC_CADENCE = 3, 600, 200, 2, 10
SWEEP_SCENARIOS = ("permuted", "class_incremental", "keyword_fewshot")
SWEEP_BACKENDS = ("wbs", "analog_state")
SWEEP_TASKS = 2
# The path kernels each substrate's compiled run launches a forward (a
# train step's or an evaluation's), counted from zero just before it: the
# readout on every substrate; on wbs the hoisted WBS drive and the fused
# scan; on analog_state two WBS products a time step (its pair read has
# no fused path).
SC_LAUNCHES_A_FORWARD = {
    "ideal": {"wbs_matmul": 0, "wbs_miru_scan": 0, "miru_scan": 0,
              "miru_readout": 1},
    "wbs": {"wbs_matmul": 1, "wbs_miru_scan": 1, "miru_scan": 0,
            "miru_readout": 1},
    "analog_state": {"wbs_matmul": 2 * T_SEQ, "wbs_miru_scan": 0,
                     "miru_scan": 0, "miru_readout": 1}}
# The faults phase (repro_torch.faults), at the paper's width on ``wbs``
# with benchmarks/fault_bench.py's knobs (FT_WBS: 8-bit drive and ADC,
# |w| ≤ 1.0): FT_TASKS permuted tasks of FT_TRAIN/FT_TEST, FT_EPOCHS
# epochs, DFA, batch CL_BATCH, reservoir CL_CAPACITY, through
# run_compiled. FT_STUCK stuck cells (half SA0, half SA1), read upsets at
# FT_UPSET, FT_SPARES spare columns for the march → remap → compensate →
# FT_RECAL_STEPS recalibration steps over FT_MASK_SEEDS; faulty and
# mitigated accuracies held to the CPU twin's (which trains its own clean
# model: the two drift apart after a few steps, as train (b) ``wbs``'s
# do) within FT_ACC_TOL.
FT_TASKS, FT_TRAIN, FT_TEST, FT_EPOCHS = 2, 600, 200, 2
FT_WBS = dict(input_bits=8, adc_bits=8, weight_clip=1.0)
FT_STUCK, FT_UPSET, FT_SPARES, FT_RECAL_STEPS = 0.01, 1e-3, 4, 16
FT_MASK_SEEDS = (0, 1, 2)
FT_ACC_TOL = 0.05
# The clean run against its twin: R within 4 test examples, MA within
# 0.02 (two tasks: the port's CPU runs at 3 threads and at 1 lie 3
# examples and MA 0.015 apart, 50 leading losses agreeing).
FT_R_TOLERANCE = (4, 0.02)
# The wear-out run (fault_bench.bench_wearout at this width): paper-scale
# endurance, one write standing for WEAR_ENDURANCE / 30 physical writes,
# at most WEAR_UPDATES updates; the age at which half the cells are worn
# over lifespan_years' projection, against the reference's band.
WEAR_ENDURANCE, WEAR_UPDATES, WEAR_BAND = 1e9, 100, (0.5, 1.5)
# fault_bench's half-recovery gate at its own setup (_easy_setup, not
# fast: 2 prototype tasks of 256/128, 16 features × 8 frames, 8 classes,
# n_h 30, 6 epochs; 1 % stuck, 4 spares, 16 recalibration steps). The
# reference fails its own gate on the CPU: its faulty model is more
# accurate than its clean one (benchmarks/fault_bench.py's
# bench_degradation(fast=False) under jax 0.9.0, mean of mask seeds 0-2):
GATE_REF = {"clean": 0.5703125, "faulty": 0.59375,
            "mitigated": 0.6302083333333334}
# The fleet phase (repro_torch.fleet): FLEET_CHIPS chips on
# ``analog_state`` (metered, endurance tracked), profile "mild", under
# FLEET_FAULTS (FLEET_SEED's draw kills two chips), FLEET_TASKS permuted
# tasks of FLEET_TRAIN/FLEET_TEST, 1 epoch (6 steps a task: the host
# draws every chip's read noise, 278-415 ms a chip-step on an H100's
# host, so the rows are cut to keep the phase near a minute); then the
# "none" fleet of FLEET_PARITY_CHIPS chips on ``wbs`` against
# run_compiled(seeds=).
FLEET_CHIPS, FLEET_TASKS, FLEET_TRAIN, FLEET_TEST = 8, 2, 192, 200
FLEET_FAULTS = dict(sa0_rate=0.005, sa1_rate=0.005, rate_spread=0.5,
                    dead_chip_rate=0.125)
FLEET_SEED, FLEET_PARITY_CHIPS = 0, 4
FLEET_DEAD_MAX_ACC = 0.2       # a dead chip's accuracy; chance is 0.1
# The kernels: each one's wrapper module and launch counter.
KERNELS = {"wbs_matmul": ("wbs_matmul", "launches"),
           "wbs_matmul_read_noise": ("wbs_matmul", "read_noise_launches"),
           "wbs_miru_scan": ("wbs_miru_scan", "launches"),
           "miru_scan": ("miru_scan", "launches"),
           "miru_readout": ("miru_readout", "launches"),
           "flash_attention_fwd_f32_sm90": ("flash_attention",
                                            "fwd_f32_sm90_launches"),
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
# the tensor-core forward, dq and dk/dv, fp32 the fp32 tensor-core
# forward, dq and dk/dv.
FLASH_FWD = {"torch.bfloat16": "flash_attention_fwd_sm90",
             "torch.float32": "flash_attention_fwd_f32_sm90"}
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
# A model of one step of the fused WBS scan at H 100, at the least: a
# 108-long chain of dependent FMAs (4 cycles each), a double tanh, the
# ADC's division and the codes' round trip through the cluster (an
# estimate, not a measurement).
SCAN_STEP_CYCLES = 1000
# A model of one step of the ideal scan at width H, at the least: the
# H-long chain of dependent adds of each output's sum (MIRU_ADD_CYCLES
# each; the multiplies are off the chain), then a double tanh, the update
# and a block barrier, about MIRU_TAIL_CYCLES (an estimate, not a
# measurement).
MIRU_ADD_CYCLES, MIRU_TAIL_CYCLES = 4, 400


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


def launch_floor(blocks: int, threads: int):
    """A zero-argument call that launches the empty kernel
    (``csrc/launch_floor.cu``) at ``blocks`` blocks of ``threads``
    threads, as the wrappers launch theirs: one C call through ctypes on
    the current stream."""
    import ctypes

    import torch
    from repro_torch.kernels import _build
    fn = _build.load("launch_floor").launch_floor_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call():
        err = fn(blocks, threads, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch_floor launch failed: cudaError {err}")
    return call


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


def check_scan(dev, rng) -> float:
    """The fused WBS scan against its plain version, bit for bit; its
    largest difference."""
    import torch
    from repro_torch import testing
    from repro_torch.kernels import ops, ref, wbs_miru_scan
    err = 0.0
    with torch.no_grad():
        # The fused scan at the serve and the train (b)/(c) shapes, at H
        # 256, and where the clusters' edges fall: B 1, 5 and 33 (rows
        # padded to whole clusters), H 37 and 130 (column slabs cut short),
        # H on both sides of the switch of U's slab to global memory, and
        # H 1,024.
        switch = next(h for h in range(2, 6000)
                      if not wbs_miru_scan.geometry(8, h).u_in_smem)
        for B, T, H in ((SLOTS, CHUNK, N_H), (CL_BATCH, T_SEQ, N_H),
                        (SLOTS, CHUNK, 256), (1, CHUNK, N_H), (5, 4, 37),
                        (33, 3, 130), (8, 2, switch - 1), (8, 2, switch),
                        (8, 2, 1024)):
            geom = wbs_miru_scan.geometry(B, H)
            for with_h0 in (False, True):
                inp = scan_inputs(rng, dev, B, T, H, with_h0)
                for adc in (ADC_BITS, None):
                    kw = dict(beta=BETA, lam=LAM, n_bits=N_BITS, adc_bits=adc,
                              adc_range=ADC_RANGE, weight_scale=W_SCALE)
                    got = ops.wbs_miru_scan(**inp, **kw)
                    h0 = inp["h0"] if with_h0 else torch.zeros(
                        (B, H), device=dev)
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
                    err = max(err, rep.max_abs_err)
                    bitwise = all(torch.equal(a, b)
                                  for a, b in zip(got, want))
                    emit("kernels", kernel="wbs_miru_scan",
                         shape=[B, T, H], h0=with_h0, adc_bits=adc,
                         cluster_rows=geom.rows, cluster=geom.cluster,
                         blocks=geom.blocks(B),
                         u_in_smem=geom.u_in_smem,
                         bitwise=bitwise, **rep.as_dict())
                    if not bitwise:
                        raise AssertionError(
                            f"wbs_miru_scan != plain at {(B, T, H)}, "
                            f"h0={with_h0}, adc_bits={adc}")
    return err


def check_miru_scan(dev, rng) -> float:
    """The ideal scan against its plain version, bit for bit; its largest
    difference. At the training shapes (batch 64 and the 300-row test set
    at the paper's width), one past the paper's width (the next register
    chain), on both sides of the width past which U's column leaves the
    registers (U then in shared memory), and at H 256 (U from global
    memory)."""
    import torch
    from repro_torch.kernels import miru_scan, ops, ref
    err = 0.0
    reg = miru_scan.REG_H
    with torch.no_grad():
        for B, T, H in ((SW_BATCH, T_SEQ, N_H), (SW_TEST, T_SEQ, N_H),
                        (SW_BATCH, 4, N_H + 1), (SW_BATCH, 4, reg),
                        (SW_BATCH, 4, reg + 1), (SW_BATCH, T_SEQ, 256)):
            place = miru_scan.u_place(H)
            for with_h0 in (False, True):
                inp = scan_inputs(rng, dev, B, T, H, with_h0)
                h0 = inp["h0"] if with_h0 else torch.zeros((B, H), device=dev)
                got = ops.miru_scan(inp["drive"], inp["u_h"], h0, BETA, LAM)
                want = ref.miru_scan_ref(inp["drive"], inp["u_h"], h0, BETA,
                                         LAM)
                torch.cuda.synchronize()
                e = max(float((a - b).abs().max()) for a, b in zip(got, want))
                err = max(err, e)
                bitwise = all(torch.equal(a, b) for a, b in zip(got, want))
                emit("kernels", kernel="miru_scan", shape=[B, T, H],
                     h0=with_h0, u_place=place, blocks=B,
                     bitwise=bitwise, max_abs_err=e)
                if not bitwise:
                    raise AssertionError(f"miru_scan != plain at "
                                         f"{(B, T, H)}, h0={with_h0}")
    return err


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
        # The quantized LM's shapes (lm_quant), no ADC as its inference
        # spec has none: bit for bit.
        for name, (M, K, N) in LMQ_WBS_SHAPES.items():
            inp = matmul_inputs(rng, dev, M, K, N)
            got = ops.wbs_matmul(**inp)
            want = ref.wbs_matmul_ref(**inp)
            torch.cuda.synchronize()
            bitwise = bool(torch.equal(got, want))
            rep = testing.compare_matmul(got, want, **inp)
            err["wbs_matmul"] = max(err["wbs_matmul"], rep.max_abs_err)
            emit("kernels", kernel="wbs_matmul", case=f"lm_{name}",
                 shape=[M, K, N], adc_bits=None, bitwise=bitwise,
                 **rep.as_dict())
            if not bitwise:
                raise AssertionError(f"wbs_matmul at {[M, K, N]}: not the "
                                     "plain version's bits")
            del inp, got, want
        err["wbs_miru_scan"] = check_scan(dev, rng)
        err["miru_scan"] = check_miru_scan(dev, rng)
        err["miru_readout"] = check_readout(dev, rng)
        err["wbs_matmul_read_noise"] = check_read_noise(dev, rng)
        err.update(check_lm_kernels(dev, rng))
    err.update(check_flash_bwd(dev, rng))
    return err


# The readout's larger-K case: K past one shared-memory tile of the
# kernel at every M (miru_readout.geometry), N past a block's columns.
READOUT_WIDE = ((1500, N_Y), (N_H, 300))


def check_readout(dev, rng) -> float:
    """The readout bit for bit against its plain version and row-exact
    (each row's bits those of the same row in a call on all the rows) at
    the serve (896 rows), eval (200), train (64, 32), chunk and single-row
    shapes, and at the :data:`READOUT_WIDE` widths on a generator of its
    own (so that the draws of the checks after it stay as they were).
    Returns the largest difference."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref
    err = 0.0
    cases = [(rng, N_H, N_Y)] + [(np.random.default_rng(21), K, N)
                                 for K, N in READOUT_WIDE]
    for g, K, N in cases:
        w_o = torch.from_numpy(g.normal(0, 0.3, (K, N)).astype(
            np.float32)).to(dev)
        b_o = torch.from_numpy(g.normal(0, 0.1, N).astype(np.float32)).to(dev)
        h = torch.from_numpy(g.uniform(-1, 1, (SLOTS * CHUNK, K)).astype(
            np.float32)).to(dev)
        full = ops.miru_readout(h, w_o, b_o)
        for M in (SLOTS * CHUNK, CL_TEST, SW_BATCH, CL_BATCH, CHUNK, 1):
            got = ops.miru_readout(h[:M].contiguous(), w_o, b_o)
            want = ref.miru_readout_ref(h[:M], w_o, b_o)
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            err = max(err, e)
            bitwise = torch.equal(got, want) and torch.equal(got, full[:M])
            emit("kernels", kernel="miru_readout", shape=[M, K, N],
                 bitwise_and_row_exact=bitwise, max_abs_err=e)
            if not bitwise:
                raise AssertionError(f"miru_readout not bitwise or not "
                                     f"row-exact at M={M}, K={K}, N={N}")
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
    err = {"flash_attention_fwd_f32_sm90": 0.0,
           "flash_attention_fwd_sm90": 0.0, "kwta": 0.0}
    # (B, Sq, Sk, H, Kh, dh, causal): the qwen2-0.5B prefill (GQA rep 7)
    # at the main path's batch (the second sequence's heads read KV heads
    # 2-3) and at one sequence, kernel_bench's shape, Sk off the tile (and
    # the KV padded past sk_true, as the prefill twin does), Sq != Sk
    # without the causal mask, rep 1.
    cases = [((LM_PREFILL_B, LM_PREFILL_S, LM_PREFILL_S, 14, 2, 64, True),
              (torch.bfloat16, torch.float32)),
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
    err["kwta"] = check_kwta(dev, rng)
    return err


# k-WTA's checked shapes (R, N, k): kernel_bench's (64, 1024) at k 580, 3
# and 11 rows (the reference pads 11 to 16), and long rows, on the main
# generator; then each path's edges (kwta.plan: a warp a row up to 512,
# then a block of the fewest warps that hold the row at 16 values a
# thread up to 16,384, 4 warps at 2,048 and 8 at 2,049, then the row from
# global memory), k 0 and k N - 1, on a generator of its own, so that the
# draws of the checks after it stay as they were.
KWTA_SHAPES = ((64, 1024, 580), (3, 1024, 100), (11, 4096, 300),
               (8, 65536, 6000))
KWTA_EDGES = ((5, 512, 256), (6, 513, 1), (5, 2048, 1000), (6, 2049, 2048),
              (7, 16384, 16383), (3, 16385, 0))


def check_kwta(dev, rng) -> float:
    """``ops.kwta`` bit for bit against its plain version at
    :data:`KWTA_SHAPES` and :data:`KWTA_EDGES`, f32 and bf16; returns the
    largest difference."""
    import numpy as np
    import torch
    from repro_torch.kernels import kwta, ops, ref
    err = 0.0
    edges = np.random.default_rng(22)
    for g, shapes in ((rng, KWTA_SHAPES), (edges, KWTA_EDGES)):
        for R, N, kk in shapes:
            for dt in (torch.float32, torch.bfloat16):
                x = torch.from_numpy(g.normal(0, 1, (R, N)).astype(
                    np.float32)).to(dev, dt)
                got = ops.kwta(x, kk)
                want = ref.kwta_bisect_ref(x, kk)
                torch.cuda.synchronize()
                same = bool(torch.equal(got, want))
                err = max(err, float((got.float() - want.float()).abs()
                                     .max()))
                kept = (got != 0).sum(-1)
                emit("kernels", kernel="kwta", shape=[R, N], k=kk,
                     dtype=str(dt), path=kwta.plan(N, dt).path, bitwise=same,
                     kept_min=int(kept.min()), kept_max=int(kept.max()))
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


def recurrence_fused_equals_per_step(dev, cfg, params) -> bool:
    """``wbs``'s device recurrence at the serve shape through the fused
    scan and through one ``wbs_matmul`` a step: the same bits?"""
    import torch
    from repro_torch.backends import get_backend
    g = torch.Generator().manual_seed(1)
    x = (torch.rand((SLOTS, CHUNK, N_X), generator=g) * 2 - 1).to(dev)
    h0 = (torch.rand((SLOTS, N_H), generator=g) - 0.5).to(dev)
    backend = get_backend("wbs")
    with torch.no_grad():
        a = backend.device_recurrence(params, cfg, x, fused=True, h0=h0)
        b = backend.device_recurrence(params, cfg, x, fused=False, h0=h0)
    return all(torch.equal(u, v) for u, v in zip(a, b))


def contracts(dev, run: dict) -> None:
    import numpy as np
    cfg, params, arrivals = run["cfg"], run["params"], run["arrivals"]
    by_uid = dict(zip(run["uids"], run["served"]))

    # Fused vs per-step (one wbs_matmul per tile per step), bit for bit.
    _, reqs = serve(cfg, params, arrivals, dev, fused=False)
    per_step = streams(arrivals, reqs, run["uids"])
    fused_equal = all(np.array_equal(a, b)
                      for a, b in zip(run["served"], per_step))
    recurrence_equal = recurrence_fused_equals_per_step(dev, cfg, params)
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
                 count: bool = False, epochs: Optional[int] = None,
                 algo: str = "dfa", replay=None) -> dict:
    """The Fig. 4 protocol on ``dev``: ``run_continual`` with ``algo``
    and ``replay`` (default reservoir replay of CL_CAPACITY) on
    ``backend`` (a name or a backend) over ``n_tasks`` permuted tasks,
    ``epochs`` a task (default CL_EPOCHS). With ``count``, the launch
    counters (and ``scan_backward_calls``) are zeroed just before the run
    and read just after."""
    from repro_torch.core.continual import (ReplaySpec, TrainerSpec,
                                            run_continual)
    from repro_torch.core.miru import MiRUConfig
    from repro_torch.data.synthetic import make_permuted_tasks
    from repro_torch.kernels import ops
    n_tasks = CL_TASKS if n_tasks is None else n_tasks
    tasks = make_permuted_tasks(0, n_tasks=n_tasks, n_train=CL_TRAIN,
                                n_test=CL_TEST)
    cfg = MiRUConfig(n_x=N_X, n_h=N_H, n_y=N_Y, beta=BETA, lam=LAM)
    trainer = TrainerSpec(algo=algo, batch_size=CL_BATCH,
                          epochs_per_task=CL_EPOCHS if epochs is None
                          else epochs)
    _sync(dev)
    if count:
        reset_launches()
        ops.scan_backward_calls = 0
    t0 = time.perf_counter()
    out = run_continual(cfg, trainer, tasks,
                        replay=replay if replay is not None
                        else ReplaySpec(capacity=CL_CAPACITY),
                        device=backend, torch_device=dev)
    _sync(dev)
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = read_launches()
    out["scan_backward_calls"] = ops.scan_backward_calls
    return out


def train_steps(dev, backend: str, algo: str = "dfa"):
    """``run(n) -> seconds``: the next ``n`` train steps of the protocol on
    the card — task 0's schedule through the trainer's own step, cycling
    over its batches, after 3 warm-up steps — ending in a synchronize."""
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
    trainer = TrainerSpec(algo=algo, epochs_per_task=CL_EPOCHS,
                          batch_size=CL_BATCH)
    be = get_backend(backend)
    sched = build_batch_schedule(trainer, ReplaySpec(capacity=CL_CAPACITY),
                                 tasks)
    step, _, opt = _make_raw_steps(cfg, trainer, be)
    key, params, psi, st = _init_run(cfg, trainer, be, dev)
    xs = torch.from_numpy(sched.x[0]).to(dev)
    ys = torch.from_numpy(sched.y[0]).to(dev)
    state = {"params": params, "st": st, "key": key, "pos": 0,
             "opt": opt.init(params) if algo == "adam" else {"psi": psi}}

    def run(n: int) -> float:
        with torch.no_grad():
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(n):
                s = state["pos"] % xs.shape[0]
                state["key"], k = prng.split(state["key"])
                (state["params"], state["opt"], _, _,
                 state["st"]) = step(state["params"], state["opt"], k,
                                     xs[s], ys[s], state["st"])
                state["pos"] += 1
            _sync(dev)
        return time.perf_counter() - t0

    run(3)
    return run


def train_step_ms(dev, backend: str, steps: int = 100,
                  algo: str = "dfa") -> float:
    """Milliseconds per train step of the protocol on the card
    (:func:`train_steps`)."""
    return 1e3 * train_steps(dev, backend, algo)(steps) / steps


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
    phase's 2-layer fp32 twins), ``lm_train`` (the training twin),
    ``scenarios:wbs`` (the scenarios phase's compiled run on ``wbs``),
    ``faults`` (the faults phase's clean run and its mitigation),
    ``fault_gate`` (fault_bench's gate at its own setup), ``fleet``
    (the fleet phase's eight chips), ``zoo:<name>`` (the lm_zoo twins),
    ``lmq:<part>`` (the lm_quant twins), ``mla:<part>`` (the lm_mla
    twins) and ``mm:<name>:<part>`` (the lm_multimodal twins).
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
    if kind.startswith("zoo:"):
        return zoo_twin(kind[4:])
    if kind.startswith("lmq:"):
        return lmq_twin(kind[4:])
    if kind.startswith("mla:"):
        return mla_twin(kind[4:])
    if kind.startswith("mm:"):
        return mm_twin(kind[3:])
    if kind == "read_noise":
        run = protocol_run(cpu, read_noise_backend(), n_tasks=1,
                           epochs=RN_CPU_EPOCHS)
    elif kind.startswith("adam:"):
        run = protocol_run(cpu, kind.split(":")[1], algo="adam",
                           epochs=ADAM_EPOCHS)
    elif kind == "ragged":
        run = ragged_run(cpu)
    elif kind == "loss_aware":
        run = loss_aware_run(cpu)
    elif kind == "scenarios:wbs":
        run = scenario_run(cpu, "wbs")
    elif kind == "faults":
        run = faults_mitigation_run(cpu)
        return {k: run[k] for k in ("R", "MA", "losses", "wall_s",
                                    "mitigation")}
    elif kind == "fault_gate":
        return fault_gate(cpu)
    elif kind == "fleet":
        run = fleet_run(cpu)
        return {"R_full": [p["R_full"] for p in run["per_device"]],
                "MA": run["MA"], "seeds": run["device_seeds"],
                "dead": run["faults"]["dead_chips"].tolist(),
                "wall_s": run["wall_s"]}
    else:
        run = protocol_run(cpu, kind.split(":")[1])
    return {k: run[k] for k in ("R", "MA", "losses", "wall_s")}


#: Every twin, longest first (measured on the CPU of the card's host),
#: those of the phases after the LM's last: the pool takes them in this
#: order, so an early phase never waits behind a later one's twin. The
#: fleet's, eight chips of host-drawn read noise, goes in with the
#: first, so that it is done when its phase, near the end, asks for it.
TWINS = ("protocol:analog", "protocol:wbs", "lm_train", "software",
         "fleet", "table1:analog_state", "protocol:ideal", "table1:cmos",
         "read_noise", "lm_serve", "lm_prefill", "adam:wbs", "ragged",
         "loss_aware", "adam:ideal", "scenarios:wbs", "faults",
         "fault_gate", f"zoo:{ZOO_GRANITE}", f"zoo:{ZOO_MAMBA2}",
         f"zoo:{ZOO_JAMBA}", "lmq:train", "lmq:prefill", "lmq:miru",
         "lmq:serve", "mla:prefill", "mla:train",
         *(f"mm:{n}:{k}" for n in ("seamless-m4t-medium", "llava-next-34b")
           for k in ("prefill", "train")))


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


def train_adam(dev, twins: dict, dfa: dict) -> dict:
    """Phase 6e: the BPTT + Adam baseline (``algo="adam"``) through the
    Fig. 4 protocol on ``ideal`` and ``wbs`` (``wbs``: the hoisted drive
    and the fused scan under autograd, the scan's straight-through
    backward once a step), at tests/test_continual.py's Adam settings:
    the reference's bands (task 0 > 0.75 after task 0, R[-1, 0] > 0.25,
    and ``test_dfa_competitive_with_adam``: DFA's MA — train (b)'s
    ``ideal`` run, ``dfa`` — above 0.45 and within 0.25 of Adam's), the
    leading losses and R against the port's CPU run (``ideal`` at train
    (b)'s tolerances, ``wbs`` at its own, ``adam_wbs``), launches and
    scan backward calls a step,
    ms a step and the busy share of a traced window of steps."""
    import numpy as np
    import torch
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("train (e): TF32 is on for the backward's "
                             "products")
    paths = {"ideal": ("miru_readout",),
             "wbs": ("wbs_matmul", "wbs_miru_scan", "miru_readout")}
    out = {}
    for backend, kernels in paths.items():
        protocol_run(dev, backend, n_tasks=1, epochs=1, algo="adam")
        run = protocol_run(dev, backend, count=True, algo="adam",
                           epochs=ADAM_EPOCHS)
        require_launches(f"train adam {backend}", run["launches"], kernels)
        n_steps = len(run["losses"])
        bwd = run["scan_backward_calls"]
        if bwd != (n_steps if backend == "wbs" else 0):
            raise AssertionError(f"train adam {backend}: {bwd} scan "
                                 f"backward calls in {n_steps} steps")
        R = np.asarray(run["R"])
        if not (R[0, 0] > 0.75 and R[-1, 0] > 0.25
                and np.isfinite(run["losses"]).all()):
            raise AssertionError(f"train adam {backend}: R {R.tolist()} "
                                 f"outside the reference's bands")
        if backend == "ideal" and not (
                dfa["MA"] > 0.45 and run["MA"] - dfa["MA"] < 0.25):
            raise AssertionError(f"train adam: DFA's MA {dfa['MA']} vs "
                                 f"Adam's {run['MA']}")
        cpu = twins[f"adam:{backend}"].result()
        tol = "ideal" if backend == "ideal" else "adam_wbs"
        agree = loss_agree_steps(run["losses"], cpu["losses"])
        if agree < min(LOSS_AGREE_STEPS[tol], len(cpu["losses"])):
            raise AssertionError(f"train adam {backend}: the losses leave "
                                 f"the CPU run's at step {agree}")
        if not r_within(tol, run, cpu):
            raise AssertionError(
                f"train adam {backend}: R {R.tolist()} on the card vs "
                f"{np.asarray(cpu['R']).tolist()} on the CPU")
        steps = train_steps(dev, backend, "adam")
        ms = 1e3 * steps(100) / 100
        window = 20
        busy = busy_share(lambda: steps(window), steps(window))
        emit("train_adam", backend=backend, R=R.tolist(), MA=run["MA"],
             dfa_MA=dfa["MA"], cpu_R=np.asarray(cpu["R"]).tolist(),
             cpu_MA=cpu["MA"], loss_agree_steps=agree,
             max_abs_dR=float(np.abs(R - np.asarray(cpu["R"])).max()),
             abs_dMA=abs(run["MA"] - cpu["MA"]),
             tolerance={"test_examples": R_TOLERANCE[tol][0],
                        "MA": R_TOLERANCE[tol][1],
                        "loss_agree_steps": LOSS_AGREE_STEPS[tol]},
             steps=n_steps, epochs=ADAM_EPOCHS, wall_s=run["wall_s"],
             cpu_wall_s=cpu["wall_s"], launches=run["launches"],
             launches_per_step={k: v / n_steps
                                for k, v in run["launches"].items()},
             scan_backward_calls=bwd, ms_per_train_step=ms,
             traced_steps=dict(busy, steps=window))
        out[backend] = run
    return out


def grad_contract(dev) -> None:
    """Phase 6f, the straight-through gradients at the paper's shape on
    the card: (i) the fused scan's gradients through the kernel forward
    equal, bit for bit, those of the same backward on the plain forward's
    residuals (which equal the kernel's, bit for bit) at (64, 28, 100)
    and (32, 28, 100); (ii) a CE loss's gradients through
    ``miru_forward_device`` on ``wbs``, fused and per-step, agree at the
    reference's rtol 1e-4, atol 1e-6 (tests/test_fused_recurrence.py),
    and (iii) the hidden weights' gradients are nonzero."""
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.backends import get_backend
    from repro_torch.core.continual import miru_forward_device
    from repro_torch.core.miru import MiRUConfig, init_miru_params
    from repro_torch.data.synthetic import make_permuted_tasks
    from repro_torch.kernels import ops, ref
    from repro_torch.utils import softmax_cross_entropy
    rng = np.random.default_rng(22)
    kw = dict(beta=BETA, lam=LAM, n_bits=N_BITS, adc_bits=ADC_BITS,
              adc_range=ADC_RANGE, weight_scale=W_SCALE)
    names = ("drive", "u_h", "h0", "b_h")
    for B in (SW_BATCH, CL_BATCH):
        inp = scan_inputs(rng, dev, B, T_SEQ, N_H, with_h0=True)
        leaves = {k: v.clone().requires_grad_(True) for k, v in inp.items()}
        outs = ops.wbs_miru_scan(**leaves, **kw)
        cts = [torch.from_numpy(rng.normal(size=(B, T_SEQ, N_H)).astype(
            np.float32)).to(dev) for _ in range(3)]
        got = torch.autograd.grad(outs, [leaves[k] for k in names], cts)
        with torch.no_grad():
            plain = ref.wbs_miru_scan_ref(
                inp["drive"], inp["u_h"] / W_SCALE, inp["h0"], inp["b_h"],
                BETA, LAM, N_BITS, ADC_BITS, ADC_RANGE, W_SCALE)
            want = ops.wbs_miru_scan_bwd(inp["u_h"], plain[1], plain[2],
                                         *cts, beta=BETA, lam=LAM)
        _sync(dev)
        residuals = all(torch.equal(a.detach(), b)
                        for a, b in zip(outs, plain))
        grads = all(torch.equal(a, b) for a, b in zip(got, want))
        if not (residuals and grads):
            raise AssertionError(f"grad_contract: kernel vs plain forward "
                                 f"at B {B}: residuals {residuals}, "
                                 f"gradients {grads}")
    cfg = MiRUConfig(n_x=N_X, n_h=N_H, n_y=N_Y, beta=BETA, lam=LAM)
    task = make_permuted_tasks(0, n_tasks=1, n_train=CL_TRAIN,
                               n_test=CL_TEST)[0]
    x = torch.from_numpy(task.x_train[:CL_BATCH]).to(dev)
    y = torch.from_numpy(task.y_train[:CL_BATCH]).to(dev)
    params = init_miru_params(prng.PRNGKey(0), cfg, dev)
    grads = {}
    for fused in (True, False):
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in params.items()}
        logits, _ = miru_forward_device(leaves, cfg, x, prng.PRNGKey(0),
                                        get_backend("wbs"), fused=fused)
        g = torch.autograd.grad(softmax_cross_entropy(logits, y),
                                list(leaves.values()))
        grads[fused] = {k: v.cpu().numpy() for k, v in zip(leaves, g)}
    worst = {}
    for k, a in grads[True].items():
        b = grads[False][k]
        if not np.allclose(a, b, rtol=1e-4, atol=1e-6):
            raise AssertionError(f"grad_contract: fused vs per-step "
                                 f"gradient of {k}")
        worst[k] = float(np.abs(a - b).max())
    norms = {k: float(np.abs(v).max()) for k, v in grads[True].items()}
    if not all(norms[k] > 0 for k in ("w_h", "u_h", "b_h")):
        raise AssertionError(f"grad_contract: a hidden gradient is zero "
                             f"({norms})")
    emit("grad_contract", kernel_equals_plain_bitwise=True,
         scan_shapes=[[SW_BATCH, T_SEQ, N_H], [CL_BATCH, T_SEQ, N_H]],
         fused_vs_per_step_max_abs=worst, max_abs_grad=norms,
         tolerance={"rtol": 1e-4, "atol": 1e-6})


def ragged_run(dev, force: bool = False, count: bool = False) -> dict:
    """Train (g)'s ragged run: DFA on ``wbs`` over the keyword stream
    under ``PadPolicy(last_batch="pad", force=force)``."""
    from repro_torch.core.continual import (ReplaySpec, TrainerSpec,
                                            run_continual)
    from repro_torch.core.miru import MiRUConfig
    from repro_torch.data.ragged import PadPolicy
    from repro_torch.data.real import make_keyword_fewshot_tasks
    tasks = make_keyword_fewshot_tasks(0, n_test=CL_TEST)
    cfg = MiRUConfig(n_x=tasks[0].x_train.shape[2], n_h=N_H,
                     n_y=int(max(t.y_train.max() for t in tasks)) + 1,
                     beta=BETA, lam=LAM)
    _sync(dev)
    if count:
        reset_launches()
    t0 = time.perf_counter()
    out = run_continual(cfg, TrainerSpec(batch_size=RAG_BATCH,
                                         epochs_per_task=CL_EPOCHS),
                        tasks, ReplaySpec(capacity=RAG_CAPACITY), "wbs",
                        pad=PadPolicy(last_batch="pad", force=force),
                        torch_device=dev)
    _sync(dev)
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = read_launches()
    return out


def seq_mnist_run(dev, pad) -> dict:
    """DFA on ``wbs`` over the seq-MNIST surrogate, aligned, with ``pad``
    (None or a PadPolicy)."""
    from repro_torch.core.continual import (ReplaySpec, TrainerSpec,
                                            run_continual)
    from repro_torch.core.miru import MiRUConfig
    from repro_torch.data.real import make_seq_mnist_tasks
    tasks = make_seq_mnist_tasks(0, n_tasks=RAG_MNIST_TASKS,
                                 n_train=CL_TRAIN, n_test=CL_TEST,
                                 offline=True)
    cfg = MiRUConfig(n_x=N_X, n_h=N_H, n_y=N_Y, beta=BETA, lam=LAM)
    return run_continual(cfg, TrainerSpec(batch_size=CL_BATCH,
                                          epochs_per_task=RAG_MNIST_EPOCHS),
                         tasks, ReplaySpec(capacity=CL_CAPACITY), "wbs",
                         pad=pad, torch_device=dev)


def train_ragged(dev, twins: dict) -> dict:
    """Phase 6g, the padded ragged path: DFA on ``wbs`` over the few-shot
    keyword stream (ragged in T and in n_train) under a PadPolicy — the
    masked step and eval twins through the WBS kernels — finite losses,
    above chance (0.25) on task 0, R within ``R_TOLERANCE["wbs"]`` and
    the leading losses against the port's CPU run; ``force=True`` (the
    same masked program) the same R and losses bit for bit; and the
    seq-MNIST surrogate, aligned, with a PadPolicy attached equal to the
    run without one, R, losses and params bit for bit."""
    import numpy as np
    import torch
    from repro_torch.data.ragged import PadPolicy
    run = ragged_run(dev, count=True)
    require_launches("train_ragged", run["launches"],
                     ("wbs_matmul", "wbs_miru_scan", "miru_readout"))
    R = np.asarray(run["R"])
    if not (np.isfinite(run["losses"]).all() and R[0, 0] > 0.25):
        raise AssertionError(f"train_ragged: R {R.tolist()}")
    forced = ragged_run(dev, force=True)
    if not (np.array_equal(forced["R"], R)
            and forced["losses"] == run["losses"]):
        raise AssertionError("train_ragged: force=True changed the run")
    cpu = twins["ragged"].result()
    agree = loss_agree_steps(run["losses"], cpu["losses"])
    if agree < min(LOSS_AGREE_STEPS["wbs"], len(cpu["losses"])):
        raise AssertionError(f"train_ragged: the losses leave the CPU run's "
                             f"at step {agree}")
    if not r_within("wbs", run, cpu):
        raise AssertionError(f"train_ragged: R {R.tolist()} on the card vs "
                             f"{np.asarray(cpu['R']).tolist()} on the CPU")
    t0 = time.perf_counter()
    base = seq_mnist_run(dev, None)
    padded = seq_mnist_run(dev, PadPolicy())
    aligned_wall = time.perf_counter() - t0
    equal = (np.array_equal(base["R"], padded["R"])
             and base["losses"] == padded["losses"]
             and all(torch.equal(base["params"][k], padded["params"][k])
                     for k in base["params"]))
    if not equal:
        raise AssertionError("train_ragged: a PadPolicy on the aligned "
                             "seq-MNIST stream changed the run")
    n_steps = len(run["losses"])
    emit("train_ragged", R=R.tolist(), MA=run["MA"],
         cpu_R=np.asarray(cpu["R"]).tolist(), cpu_MA=cpu["MA"],
         loss_agree_steps=agree,
         max_abs_dR=float(np.abs(R - np.asarray(cpu["R"])).max()),
         steps=n_steps, wall_s=run["wall_s"], cpu_wall_s=cpu["wall_s"],
         ms_per_train_step=1e3 * run["wall_s"] / n_steps,
         launches=run["launches"],
         launches_per_step={k: v / n_steps
                            for k, v in run["launches"].items()},
         forced_equal=True, seq_mnist_pad_aligned_bitwise=True,
         seq_mnist_R=np.asarray(base["R"]).tolist(),
         seq_mnist_steps=len(base["losses"]), seq_mnist_wall_s=aligned_wall)
    return run


def loss_aware_run(dev, n_tasks: Optional[int] = None, backend="ideal",
                   count: bool = False) -> dict:
    """Train (h)'s run: Adam with loss_aware replay on ``backend``."""
    from repro_torch.core.continual import ReplaySpec
    return protocol_run(dev, backend, n_tasks=n_tasks, count=count,
                        epochs=ADAM_EPOCHS, algo="adam",
                        replay=ReplaySpec(capacity=LA_CAPACITY,
                                          policy="loss_aware"))


def train_loss_aware(dev, twins: dict) -> dict:
    """Phase 6h: ``loss_aware`` replay (the device-resident buffer, its
    inserts and Gumbel-max draws on the card) with Adam on ``ideal``:
    the buffer full after task 0; the permuted stream's bands (task 0 >
    0.75, R[-1, 0] > 0.25, finite); the metered replay traffic equal to
    ``_ingraph_replay_traffic``'s count; R within ``R_TOLERANCE["ideal"]``
    and the leading losses against the port's CPU run."""
    import numpy as np
    from repro_torch.backends import get_backend
    from repro_torch.core.continual import ReplaySpec, _ingraph_replay_traffic
    from repro_torch.telemetry import meters
    first = loss_aware_run(dev, n_tasks=1)
    size = int(first["replay_state"]["size"])
    if size != LA_CAPACITY:
        raise AssertionError(f"train_loss_aware: {size} of {LA_CAPACITY} "
                             f"slots filled after task 0")
    be = get_backend("ideal")
    be.telemetry.enable()
    run = loss_aware_run(dev, backend=be, count=True)
    require_launches("train_loss_aware", run["launches"], ("miru_readout",))
    R = np.asarray(run["R"])
    if not (R[0, 0] > 0.75 and R[-1, 0] > 0.25
            and np.isfinite(run["losses"]).all()):
        raise AssertionError(f"train_loss_aware: R {R.tolist()} outside "
                             f"the bands")
    per_task = (CL_TRAIN // CL_BATCH) * ADAM_EPOCHS
    want = _ingraph_replay_traffic(
        ReplaySpec(capacity=LA_CAPACITY, policy="loss_aware"), CL_BATCH,
        [per_task] * CL_TASKS, (T_SEQ, N_X))
    snap = run["telemetry"].snapshot()
    got = {k: snap.get(k) for k in want}
    if got != want:
        raise AssertionError(f"train_loss_aware: replay traffic {got}, "
                             f"expected {want}")
    cpu = twins["loss_aware"].result()
    agree = loss_agree_steps(run["losses"], cpu["losses"])
    if agree < min(LOSS_AGREE_STEPS["ideal"], len(cpu["losses"])):
        raise AssertionError(f"train_loss_aware: the losses leave the CPU "
                             f"run's at step {agree}")
    if not r_within("ideal", run, cpu):
        raise AssertionError(f"train_loss_aware: R {R.tolist()} on the card "
                             f"vs {np.asarray(cpu['R']).tolist()} on the CPU")
    n_steps = len(run["losses"])
    emit("train_loss_aware", R=R.tolist(), MA=run["MA"],
         cpu_R=np.asarray(cpu["R"]).tolist(), cpu_MA=cpu["MA"],
         loss_agree_steps=agree,
         max_abs_dR=float(np.abs(R - np.asarray(cpu["R"])).max()),
         buffer_after_task0=size, replay_traffic=got, steps=n_steps,
         wall_s=run["wall_s"], cpu_wall_s=cpu["wall_s"],
         ms_per_train_step=1e3 * run["wall_s"] / n_steps,
         launches=run["launches"],
         launches_per_step={k: v / n_steps
                            for k, v in run["launches"].items()})
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
             keep_logits: bool = False, tracer=None):
    """``prompts`` through a fresh 8-slot ``ServeEngine`` on ``dev``, all
    submitted at once; returns (engine, requests)."""
    from repro_torch.serve import ServeConfig, ServeEngine
    eng = ServeEngine(cfg, ServeConfig(
        batch_slots=LM_SLOTS, max_len=LM_MAX_LEN, eos_token=-1,
        torch_device=dev, keep_logits=keep_logits, tracer=tracer), params)
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
            pre_launches["flash_attention_fwd_f32_sm90"]:
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
    twin_launches = twin_all["flash_attention_fwd_f32_sm90"]
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
    # grouped decodes. The window includes its engine's CUDA-graph
    # capture, whose eager warm-up step the profiler traces op by op.
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
    twin_want = {"flash_attention_fwd_f32_sm90": 2 * n,
                 "flash_attention_bwd_dq": n, "flash_attention_bwd_dkv": n}
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

def wbs_lm_times(dev, rng) -> dict:
    """The WBS product at the quantized LM's shapes (lm_quant,
    ``LMQ_WBS_SHAPES``): a decode call's SwiGLU gate and down projection,
    LM_SLOTS rows, and the prefill's, LMQ_PREFILL_S rows. Its bound as
    the kernels line's (by linearity: one product of the decoded operand)
    and beside it the plane sums' fp32 FMAs that the bits fix
    (``bound_plane_fmas_ms``); the plain version (``ref.wbs_matmul_ref``,
    a loop over K: timed by events around 3 calls, not in a graph); and
    ``torch.matmul`` of the float product (fp32, TF32 off)."""
    import torch
    from repro_torch.kernels import ref, wbs_matmul
    out = {}
    with torch.no_grad():
        for key, (M, K, N) in LMQ_WBS_SHAPES.items():
            inp = matmul_inputs(rng, dev, M, K, N)
            x = inp["sign"].float() * inp["code"].float() / 255.0
            flops = 2.0 * M * K * N + 2.0 * M * K * N_BITS
            n_bytes = 2 * M * K + 4 * K * N + 4 * N_BITS + 4 * M * N
            b, by = bound_ms(flops, n_bytes)
            out[key] = dict(
                shape=[M, K, N],
                ms=time_graph(lambda: wbs_matmul.wbs_matmul(
                    inp["sign"], inp["code"], inp["w"], inp["gains"])),
                plain_ms=time_events(lambda: ref.wbs_matmul_ref(**inp),
                                     reps=3),
                library_ms=time_graph(lambda: torch.matmul(x, inp["w"])),
                library="torch.matmul of the float product (fp32, TF32 "
                        "off)", bound_ms=b, bound_by=by,
                bound_plane_fmas_ms=2.0 * M * K * N * N_BITS
                / PEAK_FP32_FLOPS * 1e3)
    return out


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
        out["wbs_matmul"]["lm_shapes"] = wbs_lm_times(dev, rng)
        # The read-noise variant at train (d)'s two shapes, the per-step
        # recurrent product (the kernels line) and the step's input drive:
        # the product as above plus, per weight element, one Box–Muller
        # normal (counted as 8 fp64 operations: two scalings, log, ×−2,
        # sqrt, ×2π, cos, the product; Philox's integer rounds are not
        # counted, so the bound is a floor) and the perturbation's 3 fp32
        # operations. No single PyTorch call computes this function.
        words = ops.read_key_words(np.asarray([0, 42], np.uint32))
        for key, (M, K, N, xs) in {
                "wbs_matmul_read_noise": (CL_BATCH, N_H, N_H, BETA),
                "wbs_matmul_read_noise@drive": (CL_BATCH, N_X, N_H,
                                                1.0)}.items():
            inp = matmul_inputs(rng, dev, M, K, N, xs)
            flops = 2.0 * M * K * N + 2.0 * M * K * N_BITS + 3.0 * K * N
            n_bytes = 2 * M * K + 4 * K * N + 4 * N_BITS + 4 * M * N
            b, by = bound_ms(flops, n_bytes, flops64=8.0 * K * N)
            out[key] = dict(
                shape=[M, K, N], read_sigma=READ_SIGMA,
                ms=time_graph(lambda: wbs_matmul.wbs_matmul_read_noise(
                    inp["sign"], inp["code"], inp["w"], inp["gains"],
                    READ_SIGMA, words)),
                plain_ms=time_graph(lambda: ref.wbs_matmul_read_noise_ref(
                    **inp, read_sigma=READ_SIGMA, key_words=words),
                    reps=2, rounds=3),
                library_ms=None, library=None, bound_ms=b, bound_by=by)
        # The fused scan at the serve shape and at train (b)/(c)'s. The
        # bits fix the order of every plane sum, so its work is the
        # B·T·H·H·n_bits fp32 FMAs of the plane sums (no tensor core may
        # take them, and no sum may be split): bound_ms, against its bytes
        # (bound_bytes_ms). The T steps are serial besides: each is at
        # least a (H + n_bits)-long chain of dependent FMAs, a double tanh,
        # the ADC's division and the codes' round trip, about
        # SCAN_STEP_CYCLES cycles at the card's top SM clock
        # (serial_floor_model_ms: a model, not a measurement).
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True).stdout.split()[0])
        for key, (B, T) in (("wbs_miru_scan", (SLOTS, CHUNK)),
                            ("wbs_miru_scan@train", (CL_BATCH, T_SEQ))):
            H = N_H
            inp = scan_inputs(rng, dev, B, T, H, with_h0=True)
            u_scaled = inp["u_h"] / W_SCALE
            gains = inp["drive"].new_tensor(
                [2.0 ** -(k + 1) for k in range(N_BITS)]).expand(T, N_BITS)
            gains = gains.contiguous()
            geom = wbs_miru_scan.geometry(B, H)
            flops = 2.0 * B * T * H * H * N_BITS
            n_bytes = 4 * (B * T * H + H * H + B * H + H + T * N_BITS) \
                + 3 * 4 * B * T * H
            b, by = bound_ms(flops, n_bytes)
            out[key] = dict(
                shape=[B, T, H],
                ms=time_graph(lambda: wbs_miru_scan.wbs_miru_scan(
                    inp["drive"], u_scaled, inp["h0"], inp["b_h"], gains,
                    beta=BETA, lam=LAM, adc_bits=ADC_BITS,
                    adc_range=ADC_RANGE, w_scale=W_SCALE, geom=geom)),
                plain_ms=time_graph(lambda: ref.wbs_miru_scan_ref(
                    inp["drive"], u_scaled, inp["h0"], inp["b_h"], BETA, LAM,
                    N_BITS, ADC_BITS, ADC_RANGE, W_SCALE), reps=2, rounds=3),
                library_ms=None, library=None, bound_ms=b, bound_by=by,
                bound_bytes_ms=n_bytes / PEAK_BYTES * 1e3,
                serial_floor_model_ms=T * SCAN_STEP_CYCLES
                / (mhz * 1e3),
                max_sm_mhz=mhz, cluster_rows=geom.rows, cluster=geom.cluster,
                blocks=geom.blocks(B),
                sms=torch.cuda.get_device_properties(dev)
                .multi_processor_count)
        # The ideal scan at train (a)'s shape. One (B, H)×(H, H) product
        # per step: its 2·B·T·H·H fp32 operations (bound_ms), against its
        # bytes, xw in, h_all and pre out, U and h0 once (bound_bytes_ms).
        # The T steps and each output's sum over k are serial besides:
        # about MIRU_ADD_CYCLES·H + MIRU_TAIL_CYCLES a step at the card's
        # top SM clock (serial_floor_model_ms: a model, not a
        # measurement). No single PyTorch call computes the recurrence.
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
            library_ms=None, library=None, bound_ms=b, bound_by=by,
            bound_bytes_ms=n_bytes / PEAK_BYTES * 1e3,
            serial_floor_model_ms=T * (MIRU_ADD_CYCLES * H
                                       + MIRU_TAIL_CYCLES) / (mhz * 1e3),
            max_sm_mhz=mhz, u_place=miru_scan.u_place(H), blocks=B,
            sms=torch.cuda.get_device_properties(dev).multi_processor_count)
        # The readout at the serve shape (the kernels line) and the eval
        # shape, beside torch.addmm of the same operands, and the empty
        # kernel launched at its blocks and threads (launch_floor_ms).
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
            g = miru_readout.geometry(M, N_H, N_Y,
                                      miru_readout.sm_count(dev))
            rows, cols = g.grid(M, N_Y)
            out[key] = dict(
                shape=[M, N_H, N_Y],
                ms=time_graph(lambda: miru_readout.miru_readout(h, w_o,
                                                                b_o)),
                plain_ms=time_graph(lambda: ref.miru_readout_ref(h, w_o,
                                                                 b_o)),
                library_ms=time_graph(lambda: torch.addmm(b_o, h, w_o)),
                library="torch.addmm",
                bound_ms=b, bound_by=by, geometry=g._asdict(),
                blocks=rows * cols, threads=g.threads,
                launch_floor_ms=time_graph(launch_floor(rows * cols,
                                                        g.threads)))
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
    for key, fn, dt in (("flash_attention_fwd_sm90",
                         flash_attention.flash_attention_fwd_sm90,
                         torch.bfloat16),
                        ("flash_attention_fwd_f32_sm90",
                         flash_attention.flash_attention_fwd,
                         torch.float32)):
        q, k, v = flash_inputs(rng, dev, B, S, S, H, Kh, dh, dt)
        qt = q.transpose(1, 2).reshape(B * H, S, dh).contiguous()
        kt = k.transpose(1, 2).reshape(B * Kh, S, dh).contiguous()
        vt = v.transpose(1, 2).reshape(B * Kh, S, dh).contiguous()
        # Causal: half the score matrix, q, k, v read once and out, lse
        # written once. The bf16 kernel splits p into three bf16 terms,
        # three products for p.V: 2x the operations (bound_split_ms). The
        # fp32 kernel carries every operand in three bf16 terms and makes
        # each product of six: its bound is that bf16 tensor-core work,
        # beside the fp32 products on the CUDA cores
        # (bound_cuda_cores_ms).
        flops = 4.0 * B * H * S * S * dh / 2
        size = qt.element_size()
        n_bytes = size * (2 * B * H * S * dh + 2 * B * Kh * S * dh) \
            + 4 * B * H * S
        if dt == torch.bfloat16:
            b, by = flash_bound(flops, n_bytes, dt)
        else:
            b, by = bound_ms(0.0, n_bytes, flops_bf16_tc=6 * flops)
        yard, yard_name = sdpa_yardstick(q, k, v, H, Kh)
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
        else:
            out[key]["bound_cuda_cores_ms"] = flash_bound(flops, n_bytes,
                                                          dt)[0]
    out.update(flash_bwd_times(dev, rng))
    # k-WTA at check_kwta's shapes (KWTA_SHAPES; kernel_bench's (64, 1024),
    # k 580, f32, is the kernels line's), and at (64, 1024) in bf16: the
    # function reads x and writes out once and makes |x| and iters + 2
    # comparisons an element. The yardstick is the exact top-k k-WTA
    # (torch.topk), a different function (exact, not bisected). Beside
    # each, the empty kernel at the plan's blocks and threads
    # (launch_floor_ms).
    iters = 32
    for (R, N, kk), dt in [(s, torch.float32) for s in KWTA_SHAPES] \
            + [(KWTA_SHAPES[0], torch.bfloat16)]:
        x = torch.from_numpy(rng.normal(0, 1, (R, N)).astype(
            "float32")).to(dev, dt)
        b, by = bound_ms(R * N * (iters + 3.0), 2 * x.element_size() * R * N)
        p = kwta.plan(N, dt)
        blocks, threads = kwta.launch_shape(R, p)
        key = "kwta" if (R, N, dt) == (64, 1024, torch.float32) \
            else f"kwta@{R}x{N}" + ("_bf16" if dt == torch.bfloat16 else "")
        out[key] = dict(
            shape=[R, N], k=kk, dtype=str(dt).replace("torch.", ""),
            ms=time_graph(lambda: kwta.kwta(x, kk, iters)),
            plain_ms=time_graph(lambda: ref.kwta_bisect_ref(x, kk, iters),
                                reps=2, rounds=3),
            library_ms=time_graph(lambda: ref.kwta_ref(x, kk)),
            library="exact top-k k-WTA (torch.topk), a different function",
            bound_ms=b, bound_by=by, plan=p._asdict(), blocks=blocks,
            threads=threads,
            launch_floor_ms=time_graph(launch_floor(blocks, threads)))
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


# ---------------------------------------------------------------------------
# The scenarios and obs phases: the compiled whole-sequence run, the sweep,
# and the observability layer's call sites
# ---------------------------------------------------------------------------

def scenario_setup():
    """The scenarios phase's stream and network: SC_TASKS permuted tasks,
    28×100×10."""
    from repro_torch.scenarios import build_scenario, scenario_miru_config
    tasks = build_scenario("permuted", 0, n_tasks=SC_TASKS,
                           n_train=SC_TRAIN, n_test=SC_TEST)
    return scenario_miru_config(tasks, n_h=N_H), tasks


def scenario_run(dev, backend: str, compiled: bool = True, obs=None,
                 seeds=None, metered: bool = False,
                 count: bool = False) -> dict:
    """The scenarios phase's protocol on ``dev``: ``run_compiled`` (or,
    with ``compiled=False``, ``run_continual``) on ``backend``, with
    telemetry and endurance tracking under ``metered``. ``wall_s`` is the
    call's wall time, schedule included (``run_wall_s`` is
    ``run_compiled``'s own, from its upload on). With ``count``,
    the launch counters are zeroed just before and read just after."""
    from repro_torch.backends import get_backend
    from repro_torch.core.continual import (ReplaySpec, TrainerSpec,
                                            run_continual)
    from repro_torch.scenarios import run_compiled
    cfg, tasks = scenario_setup()
    be = get_backend(backend, spec_overrides=dict(track_endurance=metered))
    if metered:
        be.telemetry.enable()
    trainer = TrainerSpec(algo="dfa", epochs_per_task=SC_EPOCHS,
                          batch_size=CL_BATCH)
    kw = dict(replay=ReplaySpec(capacity=CL_CAPACITY), device=be, obs=obs,
              torch_device=dev)
    _sync(dev)
    if count:
        reset_launches()
    t0 = time.perf_counter()
    out = (run_compiled(cfg, trainer, tasks, seeds=seeds, **kw) if compiled
           else run_continual(cfg, trainer, tasks, **kw))
    _sync(dev)
    out["run_wall_s"] = out.get("wall_s")
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = read_launches()
    out["backend"] = be
    return out


def runs_equal(a: dict, b: dict) -> list:
    """What differs between two protocol runs (R, losses, params, device
    state): the names of the parts that are not equal bit for bit."""
    import numpy as np
    import torch
    bad = [k for k in ("R", "losses") if not np.array_equal(
        np.asarray(a[k]), np.asarray(b[k]))]
    bad += [f"params/{k}" for k in a["params"]
            if not torch.equal(a["params"][k], b["params"][k])]
    sa, sb = a.get("device_state"), b.get("device_state")
    if (sa is None) != (sb is None):
        bad.append("device_state")
    elif sa is not None:
        bad += [f"device_state/{k}/{leaf}" for k in sa for leaf in sa[k]
                if not torch.equal(sa[k][leaf], sb[k][leaf])]
    return bad


def runlogs_equal(loop, comp) -> bool:
    """A loop's RunLog against a compiled run's: every stream bit for bit,
    and the loop's lower-triangular accuracy matrix the compiled run's
    lower triangle."""
    import numpy as np
    return (loop.cadence == comp.cadence and loop.n_steps == comp.n_steps
            and all(np.array_equal(getattr(loop, f), getattr(comp, f))
                    for f in ("steps", "loss", "write_pulses", "dg_mag",
                              "replay_occupancy", "drift_ticks",
                              "eval_steps"))
            and np.array_equal(loop.task_acc, np.tril(comp.task_acc)))


def metering_equal(loop: dict, comp: dict) -> dict:
    """The two metered runs' counters and endurance trackers: the write,
    drift and replay counters equal; every other counter in the same
    ratio to ``sample_steps`` (the compiled run evaluates every task
    after every task and the untrained row, the loop the seen tasks
    only); the tracker's maps and update counts equal."""
    import numpy as np
    a = loop["backend"].telemetry.snapshot()
    b = comp["backend"].telemetry.snapshot()
    ss = "sample_steps"
    exact = [k for k in a if k.startswith(("write_", "drift_", "replay_"))]
    ta, tb = loop["backend"].tracker, comp["backend"].tracker
    ca, cb = ta.state_dict()["counts"], tb.state_dict()["counts"]
    n_steps = len(loop["losses"])
    B, T, n = CL_BATCH, T_SEQ, SC_TASKS
    return {
        "keys_equal": set(a) == set(b),
        "write_drift_replay_equal": all(a[k] == b.get(k) for k in exact),
        "write_keys": sorted(exact),
        "other_counters_in_proportion": all(
            a[k] * b[ss] == b[k] * a[ss] for k in a if k not in exact),
        "sample_steps_loop": a[ss], "sample_steps_compiled": b[ss],
        "sample_steps_as_counted": (
            a[ss] == n_steps * B * T + n * (n + 1) // 2 * SC_TEST * T
            and b[ss] == n_steps * B * T + (n * n + n) * SC_TEST * T),
        "tracker_maps_equal": set(ca) == set(cb) and all(
            np.array_equal(ca[k], cb[k]) for k in ca),
        "updates_applied": [ta.updates_applied, tb.updates_applied],
    }


def scenarios_phase(dev, smi: str, twins: dict) -> dict:
    """The compiled whole-sequence run at the paper's width, and the
    sweep: (1) ``run_compiled`` == ``run_continual`` bit for bit on
    ``ideal``, ``wbs`` and ``analog_state`` (metered, endurance tracked:
    counters and tracker maps too); (2) each substrate's compiled
    run launches its path kernels SC_LAUNCHES_A_FORWARD times a train
    step and an evaluation; (3) ObsSpec with a
    tracer leaves R, losses and params as they were, and the loop's
    RunLog equals the compiled run's; (4) the exported trace holds the
    schedule, compile and execute spans; (5) ``seeds=[0, 1]``'s first
    seed is the single-seed run; (6) ``wbs`` against the CPU twin; (7)
    ``run_sweep`` over three streams and two substrates; (8) ms a train
    step, loop and compiled, and the busy share of a traced compiled
    run. No speedup is asserted."""
    import json as _json
    import numpy as np
    from repro_torch.backends import get_backend
    from repro_torch.core.continual import (ReplaySpec, TrainerSpec,
                                            build_batch_schedule)
    from repro_torch.data.ragged import needs_masked_program, pad_tasks
    from repro_torch.obs import ObsSpec, Tracer, timeline
    from repro_torch.scenarios import (build_scenario, get_scenario,
                                       run_sweep, scenario_miru_config)
    from repro_torch.telemetry import format_timeline
    t_phase = time.perf_counter()
    n_steps = SC_TASKS * SC_EPOCHS * (SC_TRAIN // CL_BATCH)
    n_evals = SC_TASKS * SC_TASKS + SC_TASKS
    n_fwd = n_steps + n_evals
    runs, timing, metering = {}, {}, None
    for backend in ("ideal", "wbs", "analog_state"):
        metered = backend == "analog_state"
        loop = scenario_run(dev, backend, compiled=False, metered=metered)
        comp = scenario_run(dev, backend, metered=metered, count=True)
        bad = runs_equal(loop, comp)
        if bad or len(comp["losses"]) != n_steps or not comp["compiled"]:
            raise AssertionError(f"scenarios {backend}: the compiled run "
                                 f"differs from the loop in {bad}")
        if metered:
            metering = metering_equal(loop, comp)
            if not (metering["keys_equal"]
                    and metering["write_drift_replay_equal"]
                    and metering["other_counters_in_proportion"]
                    and metering["sample_steps_as_counted"]
                    and metering["tracker_maps_equal"]
                    and metering["updates_applied"] == [n_steps] * 2):
                raise AssertionError(f"scenarios analog_state: metering "
                                     f"differs: {metering}")
        want = {k: n_fwd * per for k, per in
                SC_LAUNCHES_A_FORWARD[backend].items()}
        got = {k: comp["launches"][k] for k in want}
        if got != want:
            raise AssertionError(f"scenarios {backend}: the compiled run "
                                 f"launched {got}, expected {want}")
        if backend != "ideal":
            timing[backend] = {
                "loop_ms_per_step": 1e3 * loop["wall_s"] / n_steps,
                "compiled_ms_per_step": 1e3 * comp["wall_s"] / n_steps,
                "loop_wall_s": loop["wall_s"],
                "compiled_wall_s": comp["wall_s"],
                "compiled_run_wall_s": comp["run_wall_s"]}
        runs[backend] = comp
    wbs = runs["wbs"]

    # obs: inert on the results, the loop's RunLog the compiled run's.
    tracer = Tracer(process_name="chip_smoke")
    with_obs = scenario_run(dev, "wbs", obs=ObsSpec(cadence=SC_CADENCE,
                                                    tracer=tracer))
    loop_obs = scenario_run(dev, "wbs", compiled=False,
                            obs=ObsSpec(cadence=SC_CADENCE))
    bad = runs_equal(wbs, with_obs) + runs_equal(wbs, loop_obs)
    if bad or not runlogs_equal(loop_obs["runlog"], with_obs["runlog"]):
        raise AssertionError(f"scenarios obs: results differ ({bad}) or "
                             f"the loop's RunLog differs from the compiled "
                             f"run's")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    trace = tracer.export_chrome(out_dir / "scenarios_trace.json")
    spans = {e["name"] for e in _json.loads(trace.read_text())["traceEvents"]
             if e["ph"] == "X"}
    if not {"schedule", "compile", "execute"} <= spans:
        raise AssertionError(f"scenarios trace: spans {spans}")

    # Seeds: the first seed's cell is the single-seed run.
    multi = scenario_run(dev, "wbs", seeds=[0, 1])
    first = multi["per_seed"][0]
    if not (np.array_equal(first["R_full"], wbs["R_full"])
            and first["losses"] == wbs["losses"]):
        raise AssertionError("scenarios seeds: seed 0 of seeds=[0, 1] is "
                             "not the single-seed run")

    # Against the CPU twin of the same compiled run.
    cpu = twins["scenarios:wbs"].result()
    agree = loss_agree_steps(wbs["losses"], cpu["losses"])
    if agree < LOSS_AGREE_STEPS["wbs"] or not r_within("wbs", wbs, cpu):
        raise AssertionError(
            f"scenarios wbs vs the CPU: {agree} leading losses agree; R "
            f"{np.asarray(wbs['R']).tolist()} vs "
            f"{np.asarray(cpu['R']).tolist()}")

    # The sweep.
    skw = dict(n_tasks=SWEEP_TASKS, n_train=SC_TRAIN, n_test=SC_TEST)
    trainer = TrainerSpec(algo="dfa", epochs_per_task=1, batch_size=CL_BATCH)
    t0 = time.perf_counter()
    grid = run_sweep(SWEEP_SCENARIOS, SWEEP_BACKENDS, trainer,
                     ReplaySpec(capacity=CL_CAPACITY), n_h=N_H,
                     scenario_kwargs=skw, obs=ObsSpec(cadence=SC_CADENCE),
                     torch_device=dev)
    sweep_wall = time.perf_counter() - t0
    kw_sc = get_scenario("keyword_fewshot")
    kw_tasks, eval_padded = pad_tasks(kw_sc.build(0, **skw), kw_sc.pad)
    masked = needs_masked_program(kw_sc.pad, eval_padded, build_batch_schedule(
        trainer, ReplaySpec(capacity=CL_CAPACITY), kw_tasks, pad=kw_sc.pad))
    cells = {}
    for key, cell in grid["cells"].items():
        n_y = scenario_miru_config(build_scenario(cell["scenario"], 0, **skw),
                                   N_H).n_y
        tl = format_timeline(timeline(cell["runlog"]))
        ok = (cell["compiled"] and cell["MA"] > 1.0 / n_y
              and cell["power_mw"] > 0 and cell["gops_per_w"] > 0
              and tl.startswith("timeline:"))
        if not ok:
            raise AssertionError(f"sweep {key}: {cell}")
        cells[key] = {"MA": cell["MA"], "chance": 1.0 / n_y,
                      "forgetting": cell["metrics"]["forgetting"],
                      "power_mw": cell["power_mw"],
                      "gops_per_w": cell["gops_per_w"],
                      "wall_s": cell["wall_s"],
                      "timeline_windows": cell["runlog"].n_windows}
    if not masked:
        raise AssertionError("sweep: the keyword stream does not take the "
                             "masked steps")

    busy = busy_share(lambda: scenario_run(dev, "wbs"), wbs["wall_s"])
    emit("scenarios", card=smi, steps=n_steps, evaluations=n_evals,
         loop_equals_compiled=["ideal", "wbs", "analog_state"],
         metering=metering,
         launches_compiled={b: {k: r["launches"][k]
                                for k in SC_LAUNCHES_A_FORWARD[b]}
                            for b, r in runs.items()},
         launches_a_forward=SC_LAUNCHES_A_FORWARD,
         timing=timing, compile_s=with_obs["compile_s"],
         execute_s=with_obs["execute_s"], obs_inert=True,
         runlog_loop_equals_compiled=True, trace_spans=sorted(spans),
         seeds_first_equals_single=True, MA={k: r["MA"]
                                            for k, r in runs.items()},
         cpu_MA=cpu["MA"], loss_agree_steps=agree,
         max_abs_dR=float(np.abs(np.asarray(wbs["R"])
                                 - np.asarray(cpu["R"])).max()),
         sweep=cells, sweep_wall_s=sweep_wall, keyword_masked=masked,
         traced_compiled_wbs=busy,
         phase_s=time.perf_counter() - t_phase)
    return {b: r["launches"] for b, r in runs.items()}


def obs_phase(dev, smi: str, run: dict) -> None:
    """The obs layer's call sites on the card: (1) the recurrent engine
    serves phase 4's burst with a tracer, the same logits bit for bit,
    a ``serve.step`` span per engine step; (2) the LM engine serves the
    serve twin's four requests on the 2-layer fp32 model with a tracer and
    decodes what it decodes without one; (3) a run record through
    ``JsonlSink``, read back, names the card."""
    import numpy as np
    import torch
    from repro_torch.obs import JsonlSink, Tracer, run_record
    t_phase = time.perf_counter()
    tracer = Tracer()
    eng, reqs = serve(run["cfg"], run["params"], run["arrivals"], dev,
                      tracer=tracer)
    served = streams(run["arrivals"], reqs, run["uids"])
    steps = [e["args"]["step"] for e in tracer.events()
             if e["name"] == "serve.step"]
    if not all(np.array_equal(a, b) for a, b in zip(served, run["served"])):
        raise AssertionError("obs: the traced burst served other logits")
    if set(steps) != set(range(eng.steps_run + 1)) or \
            steps != sorted(steps):
        raise AssertionError(f"obs: serve.step spans {steps[:8]}... for "
                             f"{eng.steps_run} engine steps")

    cfg, params = lm_twin_model(dev)
    prompts = lm_twin_prompts(cfg.vocab)
    lm_tracer = Tracer()
    _, traced = lm_serve(cfg, params, prompts, dev, LM_TWIN_MAX_NEW,
                         tracer=lm_tracer)
    _, plain = lm_serve(cfg, params, prompts, dev, LM_TWIN_MAX_NEW)
    summary = lm_tracer.summary()
    if [r.tokens for r in traced] != [r.tokens for r in plain] or \
            summary.get("serve.prefill", {}).get("count") != len(prompts):
        raise AssertionError(f"obs: the traced LM engine decoded other "
                             f"tokens or spans {summary}")
    del params
    torch.cuda.empty_cache()

    sink = JsonlSink(ROOT / "chiprun_out" / "run_records.jsonl")
    rec = run_record("run", "chip_smoke_obs",
                     {"serve_steps": eng.steps_run,
                      "lm_requests": len(prompts)},
                     extra={"card": smi})
    back = sink.read()
    sink.emit(rec)
    read = sink.read()
    if len(read) != len(back) + 1 or read[-1] != json.loads(
            json.dumps(rec)) or read[-1]["torch"]["device"] != \
            torch.cuda.get_device_name(0):
        raise AssertionError(f"obs: the run record read back as "
                             f"{read[-1]}")
    emit("obs", card=smi, serve_steps=eng.steps_run,
         serve_step_spans=len(steps),
         serve_step_s=tracer.total_s("serve.step"),
         lm_spans={k: v["count"] for k, v in summary.items()},
         run_record_torch=read[-1]["torch"],
         phase_s=time.perf_counter() - t_phase)


def faults_backend(fspec=None):
    """The faults phase's substrate: ``wbs`` with FT_WBS and ``fspec``."""
    from repro_torch.backends import DeviceSpec, get_backend
    return get_backend("wbs", spec=DeviceSpec(**FT_WBS, faults=fspec))


def stuck_spec(rate: float = FT_STUCK, **kw):
    """``rate`` stuck cells, half SA0 and half SA1 (fault_bench's)."""
    from repro_torch.faults import FaultSpec
    return FaultSpec(sa0_rate=rate / 2, sa1_rate=rate / 2, **kw)


def faults_setup():
    """(cfg, trainer, tasks) of the faults phase: the paper's network."""
    from repro_torch.core.continual import TrainerSpec
    from repro_torch.core.miru import MiRUConfig
    from repro_torch.scenarios import build_scenario
    tasks = build_scenario("permuted", 0, n_tasks=FT_TASKS,
                           n_train=FT_TRAIN, n_test=FT_TEST)
    cfg = MiRUConfig(n_x=N_X, n_h=N_H, n_y=N_Y, beta=BETA, lam=LAM)
    return cfg, TrainerSpec(algo="dfa", epochs_per_task=FT_EPOCHS,
                            batch_size=CL_BATCH), tasks


def faults_run(dev, fspec=None, count: bool = False) -> dict:
    """``run_compiled`` of the faults phase's stream on ``faults_backend(
    fspec)``; with ``count`` the launch counters are zeroed just before
    and read just after."""
    from repro_torch.core.continual import ReplaySpec
    from repro_torch.scenarios import run_compiled
    cfg, trainer, tasks = faults_setup()
    be = faults_backend(fspec)
    _sync(dev)
    if count:
        reset_launches()
    t0 = time.perf_counter()
    out = run_compiled(cfg, trainer, tasks,
                       replay=ReplaySpec(capacity=CL_CAPACITY), device=be,
                       torch_device=dev)
    _sync(dev)
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = read_launches()
    return out


def mean_accuracy(cfg, trainer, backend, params, state, tasks, dev) -> float:
    """fault_bench's ``_evaluate``: the mean test accuracy over ``tasks``
    through ``backend`` and ``state`` (the deployed, faulty forward),
    evaluation key PRNGKey(99)."""
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.core.continual import _make_raw_steps
    _, evaluate, _ = _make_raw_steps(cfg, trainer, backend)
    with torch.no_grad():
        accs = [evaluate(params, prng.PRNGKey(99),
                         torch.from_numpy(t.x_test).to(dev),
                         torch.from_numpy(t.y_test).to(dev), state)
                for t in tasks]
    return float(np.mean([float(a) for a in accs]))


def mitigation(dev, cfg, trainer, tasks, params, spec) -> dict:
    """fault_bench's mitigation at ``spec`` (with spares) over
    FT_MASK_SEEDS, from the clean model's ``params``: the faulty model's
    accuracy, the march's map against the masks, remap, bias
    compensation on a calibration batch (32 training rows a task) and
    FT_RECAL_STEPS recalibration steps on task 0, then the mitigated
    accuracy."""
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.faults import (calibration_drives, compensate_bias,
                                    effective_masks, march_recover,
                                    recalibrate, remap_columns)
    seeds = []
    for seed in FT_MASK_SEEDS:
        be = faults_backend(spec)
        st = be.init_device_state(params, prng.PRNGKey(seed))
        a_faulty = mean_accuracy(cfg, trainer, be, params, st, tasks, dev)
        rec = march_recover(be, params, st)
        exact = all(torch.equal(rec[n]["stuck"], effective_masks(t)[0])
                    for n, t in st["_faults"].items())
        st = {**st, "_faults": remap_columns(st["_faults"])}
        x_cal = np.concatenate([t.x_train[:32] for t in tasks])
        drives = calibration_drives(be, params, cfg,
                                    torch.from_numpy(x_cal).to(dev),
                                    prng.PRNGKey(11), state=st)
        p_m = compensate_bias(params, st["_faults"], drives)
        p_m, st = recalibrate(cfg, trainer, be, p_m, st, tasks[0],
                              steps=FT_RECAL_STEPS, seed=seed)
        seeds.append({"seed": seed, "faulty": a_faulty,
                      "mitigated": mean_accuracy(cfg, trainer, be, p_m, st,
                                                 tasks, dev),
                      "march_exact": bool(exact)})
    return {"per_seed": seeds,
            "faulty": float(np.mean([m["faulty"] for m in seeds])),
            "mitigated": float(np.mean([m["mitigated"] for m in seeds])),
            "march_exact": all(m["march_exact"] for m in seeds)}


def faults_mitigation_run(dev) -> dict:
    """The clean model of the faults phase (``faults_run``) and the
    mitigation stack at FT_STUCK with FT_SPARES spares on it."""
    cfg, trainer, tasks = faults_setup()
    clean = faults_run(dev)
    clean["clean_accuracy"] = float(clean["R"][-1].mean())
    clean["mitigation"] = mitigation(dev, cfg, trainer, tasks,
                                     clean["params"],
                                     stuck_spec(n_spare_cols=FT_SPARES))
    return clean


def wearout_run(dev) -> dict:
    """fault_bench's ``bench_wearout`` at the paper's width: DFA on task 0
    of the faults stream with per-cell endurance limits (mean
    WEAR_ENDURANCE, spread 0.3, one write WEAR_ENDURANCE / 30 physical
    ones), batches drawn by ``prng.choice``; the stuck fraction a step,
    the accuracy every 10; the virtual age at which half the cells are
    worn over ``lifespan_years`` for the mean write rate of the first 5
    steps."""
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.analog.endurance import lifespan_years
    from repro_torch.core.continual import _init_run, _make_raw_steps
    from repro_torch.faults import FaultSpec, stuck_fraction
    cfg, trainer, tasks = faults_setup()
    scale = WEAR_ENDURANCE / 30.0
    be = faults_backend(FaultSpec(wearout=True,
                                  wearout_endurance=WEAR_ENDURANCE,
                                  wearout_spread=0.3, wearout_scale=scale))
    train_step, evaluate, _ = _make_raw_steps(cfg, trainer, be)
    key, params, psi, _ = _init_run(cfg, trainer, be, dev)
    state = be.init_device_state(params, prng.PRNGKey(0))
    opt_state = {"psi": psi}
    task = tasks[0]
    n = task.x_train.shape[0]
    B = min(trainer.batch_size, 32)
    year_per_update = scale * 1e-3 / (365.25 * 24 * 3600)
    x_te = torch.from_numpy(task.x_test).to(dev)
    y_te = torch.from_numpy(task.y_test).to(dev)
    rates, fracs, traj = [], [], []
    _sync(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        for step in range(WEAR_UPDATES):
            key, k_step, k_batch = prng.split(key, 3)
            idx = prng.choice(k_batch, n, (B,))
            params, opt_state, _, applied, state = train_step(
                params, opt_state, k_step,
                torch.from_numpy(task.x_train[idx]).to(dev),
                torch.from_numpy(task.y_train[idx]).to(dev), state)
            if step < 5:
                rates.append(float(np.mean([
                    float((a != 0).float().mean())
                    for a in applied.values()])))
            frac = stuck_fraction(state["_faults"])
            fracs.append(frac)
            if step % 10 == 0 or frac > 0.95:
                traj.append({"update": step + 1, "stuck_fraction": frac,
                             "accuracy": float(evaluate(
                                 params, prng.PRNGKey(7), x_te, y_te,
                                 state))})
            if frac > 0.95:
                break
    _sync(dev)
    wall = time.perf_counter() - t0
    zeta = float(np.mean(rates))
    proj = lifespan_years(zeta, endurance=WEAR_ENDURANCE)
    onset = next(((i + 1) * year_per_update for i, f in enumerate(fracs)
                  if f >= 0.5), None)
    return {"mean_write_rate": zeta, "projected_lifespan_years": proj,
            "onset_age_years": onset,
            "onset_over_projection": onset / proj if onset else None,
            "updates": len(fracs), "ms_a_step": 1e3 * wall / len(fracs),
            "trajectory": traj}


def gate_setup():
    """fault_bench's ``_easy_setup(fast=False)``, data and all: two
    prototype-sequence tasks the small MiRU masters, n_h 30, 6 epochs."""
    import numpy as np
    from repro_torch.core.continual import TrainerSpec
    from repro_torch.data.synthetic import TaskData
    from repro_torch.scenarios import scenario_miru_config
    rng = np.random.default_rng(0)
    n_classes, F, T = 8, 16, 8
    tasks = []
    for t in range(2):
        protos = rng.uniform(0.1, 0.9,
                             size=(n_classes, F)).astype(np.float32)

        def draw(n):
            y = rng.integers(0, n_classes, size=n)
            x = protos[y][:, None, :] + 0.02 * rng.standard_normal(
                (n, T, F)).astype(np.float32)
            return np.clip(x, 0, 1).astype(np.float32), y.astype(np.int32)

        x_tr, y_tr = draw(256)
        x_te, y_te = draw(128)
        tasks.append(TaskData(x_tr, y_tr, x_te, y_te, task_id=t))
    return (scenario_miru_config(tasks, n_h=30),
            TrainerSpec(algo="dfa", epochs_per_task=6), tasks)


def fault_gate(dev) -> dict:
    """fault_bench's mitigation gate at its own setup: the clean model
    (``run_compiled``, reservoir 64), its accuracy, then
    :func:`mitigation` at 1 % stuck with 4 spares; the accuracy lost and
    recovered, and the gate (recovered ≥ half of lost, lost > 0)."""
    from repro_torch.core.continual import ReplaySpec
    from repro_torch.scenarios import run_compiled
    cfg, trainer, tasks = gate_setup()
    trained = run_compiled(cfg, trainer, tasks, replay=ReplaySpec(
        capacity=64), device=faults_backend(), torch_device=dev)
    params = trained["params"]
    clean = mean_accuracy(cfg, trainer, faults_backend(), params, None,
                          tasks, dev)
    mit = mitigation(dev, cfg, trainer, tasks, params,
                     stuck_spec(0.01, n_spare_cols=4))
    lost = clean - mit["faulty"]
    rec = mit["mitigated"] - mit["faulty"]
    return {"clean": clean, "faulty": mit["faulty"],
            "mitigated": mit["mitigated"], "lost": lost, "recovered": rec,
            "gate": bool(lost > 0 and rec >= 0.5 * lost),
            "march_exact": mit["march_exact"], "per_seed": mit["per_seed"]}


def fleet_setup():
    """(cfg, trainer, tasks) of the fleet phase: the paper's network, 1
    epoch."""
    from repro_torch.core.continual import TrainerSpec
    from repro_torch.core.miru import MiRUConfig
    from repro_torch.scenarios import build_scenario
    tasks = build_scenario("permuted", 0, n_tasks=FLEET_TASKS,
                           n_train=FLEET_TRAIN, n_test=FLEET_TEST)
    cfg = MiRUConfig(n_x=N_X, n_h=N_H, n_y=N_Y, beta=BETA, lam=LAM)
    return cfg, TrainerSpec(algo="dfa", epochs_per_task=1,
                            batch_size=CL_BATCH), tasks


def fleet_run(dev, n_devices: int = FLEET_CHIPS,
              count: bool = False) -> dict:
    """``run_fleet``: ``n_devices`` chips on ``analog_state``, metered and
    endurance tracked, profile "mild", under FLEET_FAULTS; with
    ``count`` the launch counters are zeroed just before and read just
    after."""
    from repro_torch.backends import get_backend
    from repro_torch.core.continual import ReplaySpec
    from repro_torch.faults import FaultSpec
    from repro_torch.fleet import FleetSpec, run_fleet
    cfg, trainer, tasks = fleet_setup()
    be = get_backend("analog_state", spec_overrides=dict(
        track_endurance=True, faults=FaultSpec(**FLEET_FAULTS)))
    be.telemetry.enable()
    _sync(dev)
    if count:
        reset_launches()
    t0 = time.perf_counter()
    out = run_fleet(cfg, trainer, tasks,
                    FleetSpec(n_devices=n_devices, het_profile="mild",
                              seed=FLEET_SEED),
                    replay=ReplaySpec(capacity=CL_CAPACITY), device=be,
                    torch_device=dev)
    _sync(dev)
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = read_launches()
    out["backend"] = be
    return out


def results_equal(a: dict, b: dict) -> list:
    """The parts of two compiled runs that differ bit for bit: R_full,
    losses, params."""
    import numpy as np
    import torch
    bad = [k for k in ("R_full", "losses") if not np.array_equal(
        np.asarray(a[k]), np.asarray(b[k]))]
    return bad + [f"params/{k}" for k in a["params"]
                  if not torch.equal(a["params"][k], b["params"][k])]


def faults_phase(dev, smi: str, twins: dict) -> dict:
    """The fault model on the card, at the paper's width on ``wbs``: (1)
    a zero-rate FaultSpec leaves the compiled run's R, losses and params
    bit for bit; (2) at FT_STUCK stuck cells each forward launches the
    drive and the scan once (the masks do not push it off the fused
    path), and fused == per-step bit for bit on a test set; (3) read
    upsets at FT_UPSET are keyed and never fused (2·T ``wbs_matmul`` a
    forward); (4) the march's map is the masks', 2 launches a tile; (5)
    the mitigation stack over FT_MASK_SEEDS against the CPU twin; (6) the
    wear-out run's onset over its projection; (7) fault_bench's
    half-recovery gate at its own setup, against the CPU twin and the
    reference's figures; ms a step and the busy share of the masked
    run."""
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.faults import FaultSpec, effective_masks, march_recover
    t_phase = time.perf_counter()
    cfg, trainer, tasks = faults_setup()
    n_steps = FT_TASKS * FT_EPOCHS * (FT_TRAIN // CL_BATCH)
    n_fwd = n_steps + FT_TASKS * FT_TASKS + FT_TASKS

    clean = faults_mitigation_run(dev)
    zero = faults_run(dev, FaultSpec())
    bad = results_equal(clean, zero)
    if bad:
        raise AssertionError(f"faults: a zero-rate FaultSpec changed {bad}")

    masked = faults_run(dev, stuck_spec(), count=True)
    want = {"wbs_matmul": n_fwd, "wbs_miru_scan": n_fwd,
            "miru_readout": n_fwd}
    got = {k: masked["launches"][k] for k in want}
    if got != want or not np.isfinite(masked["losses"]).all():
        raise AssertionError(f"faults masked run: launches {got}, expected "
                             f"{want}")

    be = faults_backend(stuck_spec())
    st = be.init_device_state(clean["params"], prng.PRNGKey(5))
    x = torch.from_numpy(tasks[0].x_test).to(dev)
    T = x.shape[1]
    with torch.no_grad():
        reset_launches()
        fused = be.device_recurrence(clean["params"], cfg, x,
                                     prng.PRNGKey(3), state=st)
        _sync(dev)
        l_fused = read_launches()
        reset_launches()
        step = be.device_recurrence(clean["params"], cfg, x,
                                    prng.PRNGKey(3), state=st, fused=False)
        _sync(dev)
        l_step = read_launches()
    if not all(torch.equal(a, b) for a, b in zip(fused, step)) or \
            (l_fused["wbs_miru_scan"], l_fused["wbs_matmul"],
             l_step["wbs_miru_scan"], l_step["wbs_matmul"]) != (1, 1, 0,
                                                               2 * T):
        raise AssertionError(f"faults: fused != per-step under masks, or "
                             f"launches {l_fused} / {l_step}")

    ub = faults_backend(FaultSpec(upset_rate=FT_UPSET))
    su = ub.init_device_state(clean["params"], prng.PRNGKey(0))
    with torch.no_grad():
        reset_launches()
        u1 = ub.device_recurrence(clean["params"], cfg, x, prng.PRNGKey(3),
                                  state=su)
        _sync(dev)
        l_up = read_launches()
        u2 = ub.device_recurrence(clean["params"], cfg, x, prng.PRNGKey(3),
                                  state=su)
        u3 = ub.device_recurrence(clean["params"], cfg, x, prng.PRNGKey(4),
                                  state=su)
        c0 = faults_backend().device_recurrence(clean["params"], cfg, x,
                                                prng.PRNGKey(3))
    upset_frac = float((u1[2] != c0[2]).float().mean())
    if not (torch.equal(u1[0], u2[0]) and not torch.equal(u1[0], u3[0])
            and l_up["wbs_miru_scan"] == 0
            and l_up["wbs_matmul"] == 2 * T and upset_frac > 0):
        raise AssertionError(f"faults: upsets not keyed or fused "
                             f"({l_up})")
    upsets = faults_run(dev, FaultSpec(upset_rate=FT_UPSET), count=True)
    if (upsets["launches"]["wbs_miru_scan"], upsets["launches"][
            "wbs_matmul"]) != (0, 2 * T * n_fwd):
        raise AssertionError(f"faults upsets run: launches "
                             f"{upsets['launches']}")

    mb = faults_backend(stuck_spec(n_spare_cols=FT_SPARES))
    sm = mb.init_device_state(clean["params"], prng.PRNGKey(0))
    reset_launches()
    rec = march_recover(mb, clean["params"], sm)
    _sync(dev)
    l_march = read_launches()
    exact = {n: bool(torch.equal(rec[n]["stuck"], effective_masks(t)[0]))
             for n, t in sm["_faults"].items()}
    if not all(exact.values()) or l_march["wbs_matmul"] != 2 * len(rec):
        raise AssertionError(f"faults march: exact {exact}, launches "
                             f"{l_march}")

    cpu = twins["faults"].result()
    agree = loss_agree_steps(clean["losses"], cpu["losses"])
    dR = float(np.abs(np.asarray(clean["R"]) - np.asarray(cpu["R"])).max())
    mit, cmit = clean["mitigation"], cpu["mitigation"]
    d_acc = {k: abs(mit[k] - cmit[k]) for k in ("faulty", "mitigated")}
    n_ex, ma_tol = FT_R_TOLERANCE
    if (agree < LOSS_AGREE_STEPS["wbs"] or dR > n_ex / FT_TEST + 1e-9
            or abs(clean["MA"] - cpu["MA"]) > ma_tol + 1e-9
            or not mit["march_exact"]
            or max(d_acc.values()) > FT_ACC_TOL):
        raise AssertionError(
            f"faults vs the CPU: {agree} leading losses agree, dR {dR}, MA "
            f"{clean['MA']} vs {cpu['MA']}, mitigation {mit} vs {cmit}")

    wear = wearout_run(dev)
    ratio = wear["onset_over_projection"]
    if ratio is None or not WEAR_BAND[0] <= ratio <= WEAR_BAND[1]:
        raise AssertionError(f"faults wear-out: onset/projection {ratio} "
                             f"outside {WEAR_BAND}")

    gate = fault_gate(dev)
    cgate = twins["fault_gate"].result()
    d_gate = {k: abs(gate[k] - cgate[k])
              for k in ("clean", "faulty", "mitigated")}
    d_ref = {k: abs(gate[k] - GATE_REF[k]) for k in GATE_REF}
    if not gate["march_exact"] or max(d_gate.values()) > FT_ACC_TOL \
            or max(d_ref.values()) > FT_ACC_TOL \
            or (gate["lost"] > 0 and not gate["gate"]):
        raise AssertionError(f"faults gate: {gate} vs the CPU's {cgate}")

    busy = busy_share(lambda: faults_run(dev, stuck_spec()),
                      masked["wall_s"])
    emit("faults", card=smi, steps=n_steps, forwards=n_fwd,
         zero_rate_bitwise=True, launches_masked=got,
         fused_equals_per_step=True,
         launches_fused_forward={k: l_fused[k] for k in want},
         launches_per_step_forward={k: l_step[k] for k in want},
         upsets={"launches_a_forward": {k: l_up[k] for k in want},
                 "keyed": True, "pre_changed_share": upset_frac,
                 "run_launches": {k: upsets["launches"][k] for k in want},
                 "MA": upsets["MA"]},
         march_exact=exact, march_launches=l_march["wbs_matmul"],
         clean_MA=clean["MA"], cpu_MA=cpu["MA"], loss_agree_steps=agree,
         max_abs_dR=dR, mitigation=mit, cpu_mitigation=cmit,
         wearout={k: v for k, v in wear.items()},
         wear_band=WEAR_BAND, gate=gate, cpu_gate=cgate,
         gate_reference=GATE_REF,
         gate_reference_lost=GATE_REF["clean"] - GATE_REF["faulty"],
         ms_a_step={"clean": 1e3 * clean["wall_s"] / n_steps,
                    "masked": 1e3 * masked["wall_s"] / n_steps,
                    "upsets": 1e3 * upsets["wall_s"] / n_steps},
         traced_masked=busy, phase_s=time.perf_counter() - t_phase)
    return {"faults_masked": masked["launches"],
            "faults_upsets": upsets["launches"],
            "faults_march": l_march}


def fleet_phase(dev, smi: str, twins: dict) -> dict:
    """The fleet on one card: (1) FLEET_CHIPS chips on ``analog_state``
    (mild, FLEET_FAULTS, metered): every chip reported, the dead chips at
    chance, 2·T ``wbs_matmul`` and a readout a forward on every chip, each
    chip against the CPU twin's; ``fleet_aggregate``, ``format_fleet``
    and ``telemetry_report(fleet=)``; (2) the "none" fleet of
    FLEET_PARITY_CHIPS chips on ``wbs`` == ``run_compiled(seeds=
    device_seeds)`` bit for bit, one scan a forward; ms a chip-step and
    the busy share of each (a one-chip fleet traced for the first)."""
    import numpy as np
    import torch
    from repro_torch.analog.costmodel import M2RUCostModel
    from repro_torch.backends import get_backend
    from repro_torch.core.continual import ReplaySpec
    from repro_torch.fleet import (FleetSpec, device_seeds, fleet_aggregate,
                                   run_fleet)
    from repro_torch.scenarios import run_compiled
    from repro_torch.telemetry import format_fleet, telemetry_report
    t_phase = time.perf_counter()
    cfg, trainer, tasks = fleet_setup()
    steps = FLEET_TASKS * (FLEET_TRAIN // CL_BATCH)
    n_fwd = steps + FLEET_TASKS * FLEET_TASKS + FLEET_TASKS
    T = tasks[0].x_train.shape[1]

    fl = fleet_run(dev, count=True)
    D = FLEET_CHIPS
    want = {"wbs_matmul": D * n_fwd * 2 * T, "wbs_miru_scan": 0,
            "miru_readout": D * n_fwd}
    got = {k: fl["launches"][k] for k in want}
    dead = np.asarray(fl["faults"]["dead_chips"])
    accs = [p["metrics"]["average_accuracy"] for p in fl["per_device"]]
    if (len(fl["per_device"]) != D or got != want or not dead.any()
            or max(accs[i] for i in np.flatnonzero(dead))
            > FLEET_DEAD_MAX_ACC or not all(
                np.isfinite(p["losses"]).all() for p in fl["per_device"])):
        raise AssertionError(f"fleet: launches {got} (expected {want}), "
                             f"dead {dead.tolist()}, accuracies {accs}")
    cpu = twins["fleet"].result()
    dR = [float(np.abs(p["R_full"] - c).max())
          for p, c in zip(fl["per_device"], cpu["R_full"])]
    n_ex, ma_tol = R_TOLERANCE["analog"]
    if (cpu["dead"] != dead.tolist() or cpu["seeds"] != fl["device_seeds"]
            or max(dR) > n_ex / FLEET_TEST + 1e-9
            or abs(fl["MA"] - cpu["MA"]) > ma_tol + 1e-9):
        raise AssertionError(f"fleet vs the CPU: dR {dR}, MA {fl['MA']} vs "
                             f"{cpu['MA']}")
    agg = fleet_aggregate(fl, model=M2RUCostModel(n_h=N_H))
    be = fl["backend"]
    rep = telemetry_report(be.telemetry, model=M2RUCostModel(n_h=N_H),
                           tracker=be.tracker, fleet=agg)
    block = format_fleet(agg)
    print(block, flush=True)
    # One chip traced, against the untraced fleet's wall a chip.
    busy = busy_share(lambda: fleet_run(dev, n_devices=1), fl["wall_s"] / D)

    be_w = get_backend("wbs")
    spec = FleetSpec(n_devices=FLEET_PARITY_CHIPS, het_profile="none",
                     seed=FLEET_SEED)
    _sync(dev)
    reset_launches()
    t0 = time.perf_counter()
    par = run_fleet(cfg, trainer, tasks, spec,
                    replay=ReplaySpec(capacity=CL_CAPACITY), device=be_w,
                    torch_device=dev)
    _sync(dev)
    par_wall = time.perf_counter() - t0
    l_par = read_launches()
    rc = run_compiled(cfg, trainer, tasks,
                      replay=ReplaySpec(capacity=CL_CAPACITY),
                      device=get_backend("wbs"), seeds=device_seeds(spec),
                      torch_device=dev)
    same = all(np.array_equal(a["R_full"], b["R_full"])
               and a["losses"] == b["losses"]
               for a, b in zip(par["per_device"], rc["per_seed"])) and all(
        torch.equal(par["params"][k], v) for k, v in rc["params"].items())
    want_w = {"wbs_matmul": FLEET_PARITY_CHIPS * n_fwd,
              "wbs_miru_scan": FLEET_PARITY_CHIPS * n_fwd,
              "miru_readout": FLEET_PARITY_CHIPS * n_fwd}
    got_w = {k: l_par[k] for k in want_w}
    if not same or got_w != want_w:
        raise AssertionError(f"fleet parity: equal {same}, launches "
                             f"{got_w} (expected {want_w})")
    busy_w = busy_share(lambda: run_fleet(
        cfg, trainer, tasks, spec, replay=ReplaySpec(capacity=CL_CAPACITY),
        device=get_backend("wbs"), torch_device=dev), par_wall)
    emit("fleet", card=smi, chips=D, steps_a_chip=steps,
         forwards_a_chip=n_fwd, device_seeds=fl["device_seeds"],
         het={k: v.tolist() for k, v in fl["het"].items()},
         rate_scale=fl["faults"]["rate_scale"].tolist(),
         dead_chips=dead.tolist(), accuracy=accs,
         MA=fl["MA"], cpu_MA=cpu["MA"], max_abs_dR=dR,
         launches=got, aggregate={k: agg[k] for k in (
             "average_accuracy", "forgetting", "power_mw", "gops_per_w",
             "lifetime_years", "faults", "hot_tail") if k in agg},
         report_power_mw=rep["metered"]["power_mw"],
         format_fleet=block.splitlines(),
         ms_a_chip_step=1e3 * fl["wall_s"] / (D * steps),
         wall_s=fl["wall_s"], traced_one_chip=busy,
         parity={"chips": FLEET_PARITY_CHIPS, "bitwise": True,
                 "launches": got_w,
                 "ms_a_chip_step": 1e3 * par_wall
                 / (FLEET_PARITY_CHIPS * steps), "traced": busy_w},
         phase_s=time.perf_counter() - t_phase)
    return {"fleet_analog_state": fl["launches"], "fleet_wbs": l_par}


# ---------------------------------------------------------------------------
# Phase lm_zoo: the MoE, SSM and hybrid families (slice 9)
# ---------------------------------------------------------------------------

def zoo_model(name: str, dev, layers: Optional[int] = None, dtype=None,
              seed: int = 0, smoke: bool = False, **kw):
    """``name``'s published config (or its smoke config), depth cut to
    ``layers``, in ``dtype``, with ``kw`` replaced; its weights drawn from
    ``seed``: on the card for a published config at full depth, else on
    the CPU and moved to ``dev``, so that a CPU twin holds the same
    bits."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import lm
    from repro_torch.utils import tree_to
    cfg = (get_smoke_config if smoke else get_config)(name)
    cfg = dataclasses.replace(cfg, n_layers=layers or cfg.n_layers,
                              dtype=dtype or cfg.dtype, **kw)
    if smoke or layers:
        params = lm.init_params(torch.Generator().manual_seed(seed), cfg,
                                "cpu")
        return cfg, tree_to(params, dev)
    return cfg, lm.init_params(torch.Generator(dev).manual_seed(seed), cfg,
                               dev)


def zoo_twin_model(name: str, dev):
    """A twin's model: the published width in fp32, 2 layers (jamba: its
    smoke config, one superblock, with its int8 cache), weights from the
    CPU with seed 1."""
    import torch
    if name == ZOO_JAMBA:
        return zoo_model(name, dev, dtype=torch.float32, seed=1,
                         smoke=True, kv_cache_dtype="int8")
    return zoo_model(name, dev, ZOO_TWIN_LAYERS, torch.float32, seed=1)


@contextlib.contextmanager
def recorded_routing():
    """Record each ``moe_ffn`` call's routing while the block runs: per
    call the (T, K) expert ids, which of them kept their slot, and each
    token's gap between its k-th and (k+1)-th router probability, all on
    the CPU."""
    import torch
    from repro_torch.models import moe
    rec: list = []
    route, dispatch = moe.route, moe.dispatch

    def recording_route(router, xt, k):
        probs, w, e = route(router, xt, k)
        top = torch.topk(probs, k + 1, dim=-1).values
        rec.append({"top_e": e.cpu(), "gap": (top[:, k - 1]
                                              - top[:, k]).cpu()})
        return probs, w, e

    def recording_dispatch(top_e, E, C):
        out = dispatch(top_e, E, C)
        rec[-1]["kept"] = out["kept"].reshape(top_e.shape).cpu()
        return out
    moe.route, moe.dispatch = recording_route, recording_dispatch
    try:
        yield rec
    finally:
        moe.route, moe.dispatch = route, dispatch


def zoo_prefill_logits(cfg, params, S: int = LM_TWIN_S, seed: int = 2,
                       rows=LM_TWIN_ROWS):
    """One seeded S-token prompt's prefill logits at ``rows`` (fp32, on
    the CPU), and the routing of each MoE layer."""
    import numpy as np
    import torch
    from repro_torch.models import lm
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (1, S)))
    with recorded_routing() as routes:
        logits = lm.prefill(params, cfg, {"tokens": toks})
    return logits[0, list(rows)].to(torch.float32).cpu(), routes


def zoo_train_twin_run(name: str, dev) -> dict:
    """The fp32 twin model through ``Trainer`` (warmup 0),
    ZOO_TRAIN_TWIN_STEPS steps on 1 × ZOO_TRAIN_TWIN_S tokens: losses and
    grad norms."""
    from repro_torch.train import TrainConfig, Trainer
    cfg, params = zoo_twin_model(name, dev)
    tr = Trainer(cfg, TrainConfig(warmup_steps=0),
                 lm_train_batcher(cfg, 1, ZOO_TRAIN_TWIN_S, seed=3),
                 params=params, device=dev)
    hist = tr.run(steps=ZOO_TRAIN_TWIN_STEPS)
    return {"losses": [h["loss"] for h in hist],
            "grad_norms": [h["grad_norm"] for h in hist]}


def zoo_jamba_serve(cfg, params, dev, keep_logits: bool = False):
    """jamba's single request (the burst's first prompt at the smoke
    vocab) through an 8-slot engine."""
    _, reqs = lm_serve(cfg, params, lm_prompts(cfg.vocab)[:1], dev,
                       LM_TWIN_MAX_NEW, keep_logits=keep_logits)
    return reqs[0]


def zoo_twin(name: str) -> dict:
    """The CPU side of the lm_zoo twins of ``name``: the prefill logits
    and routing (granite, mamba2), the single request's tokens and logits
    (jamba), and the training twin's losses."""
    import torch
    cpu = torch.device("cpu")
    cfg, params = zoo_twin_model(name, cpu)
    out = {"train": zoo_train_twin_run(name, cpu)}
    if name == ZOO_JAMBA:
        req = zoo_jamba_serve(cfg, params, cpu, keep_logits=True)
        out.update(tokens=req.tokens, logits=torch.stack(req.logits))
    else:
        out["logits"], out["routes"] = zoo_prefill_logits(cfg, params)
    return out


def routing_agreement(card: list, cpu: list) -> dict:
    """Compare two runs' MoE routing layer by layer: per token, the set of
    its top-k experts and the set of those that kept their slot. Causal
    attention and the capacity (earlier tokens first) carry a difference
    only to later tokens, so each layer is compared on the tokens before
    the first one that differed in an earlier layer, and the logits on
    the rows before the first that differed anywhere. A token whose
    expert set differs must sit at a near-tie on the CPU: its gap between
    the k-th and (k+1)-th probability below ZOO_ROUTE_GAP."""
    import numpy as np
    first, n_diff, unexplained = None, 0, []
    for layer, (a, b) in enumerate(zip(card, cpu)):
        ea, eb = a["top_e"].numpy(), b["top_e"].numpy()
        same = (np.sort(ea, 1) == np.sort(eb, 1)).all(1)
        kept = (np.sort(np.where(a["kept"].numpy(), ea, -1), 1)
                == np.sort(np.where(b["kept"].numpy(), eb, -1), 1)).all(1)
        diff = np.nonzero(~(same & kept))[0]
        if first is not None:
            diff = diff[diff < first]
        n_diff += len(diff)
        gap = b["gap"].numpy()
        unexplained += [(layer, int(t), float(gap[t])) for t in diff
                        if not same[t] and gap[t] >= ZOO_ROUTE_GAP]
        if len(diff):
            first = int(diff[0])
    return {"layers": len(card),
            "tokens_routed": int(card[0]["top_e"].shape[0]) if card else 0,
            "differing_tokens": n_diff, "first_differing_token": first,
            "unexplained": unexplained,
            "min_cpu_gap": min(float(b["gap"].min()) for b in cpu)
            if cpu else None}


def zoo_serve(cfg, params, dev, part: str) -> tuple:
    """The lm phase's 32-request burst through an 8-slot engine on the
    full model, after a warm-up; then a short window served by an engine
    whose CUDA graph is already captured, untraced and traced: the
    steady state's busy share and device ms a decode call. Returns the
    burst's requests and launches."""
    from repro_torch.serve import ServeConfig, ServeEngine
    prompts = lm_prompts(cfg.vocab)
    lm_serve(cfg, params, prompts[:2], dev, max_new=4)  # warm-up
    reset_launches()
    t0 = time.perf_counter()
    eng, reqs = lm_serve(cfg, params, prompts, dev, LM_MAX_NEW)
    wall = time.perf_counter() - t0
    launches = read_launches()
    stats = eng.request_stats()
    if stats["requests"] != LM_REQUESTS or \
            any(len(r.tokens) != LM_MAX_NEW for r in reqs):
        raise AssertionError(f"lm_zoo {part}: served {stats['requests']}")
    # A graph replay is thousands of kernel events to the profiler, so
    # the window is short: every slot filled, one-slot prefill calls and
    # grouped decodes, as in the burst.
    wave = [p[:ZOO_TRACE_PROMPT] for p in prompts[:LM_SLOTS]]
    weng = ServeEngine(cfg, ServeConfig(
        batch_slots=LM_SLOTS, max_len=LM_MAX_LEN, eos_token=-1,
        torch_device=dev), params)

    def window():
        for p in wave:
            weng.submit(p, ZOO_TRACE_NEW)
        weng.run_until_drained()
        _sync(dev)
    window()                                           # the capture
    calls = weng.decode_calls
    t0 = time.perf_counter()
    window()
    busy = busy_share(window, time.perf_counter() - t0)
    calls = weng.decode_calls - calls
    busy["window"] = (f"{len(wave)} requests of {ZOO_TRACE_PROMPT} prompt "
                      f"tokens, {ZOO_TRACE_NEW} new each, {LM_SLOTS} "
                      f"slots, {calls // 2} decode calls, the engine's "
                      "CUDA graph captured before")
    busy["device_ms_a_decode_call"] = busy["device_busy_s"] * 1e3 \
        / (calls // 2)
    emit("lm_zoo", part=part, config=cfg.name, layers=cfg.n_layers,
         dtype=str(cfg.dtype), slots=LM_SLOTS, max_len=LM_MAX_LEN,
         requests=stats["requests"], max_new=LM_MAX_NEW,
         prompt_tokens=sum(len(p) for p in prompts), wall_s=wall,
         ms_a_decode_call=wall * 1e3 / stats["decode_calls"],
         ms_an_engine_step=wall * 1e3 / stats["steps_run"],
         launches=launches, traced_run=busy,
         **{k: stats[k] for k in ("steps_run", "decode_calls", "latency_ms",
                                  "decode_ms", "tokens_per_s",
                                  "tokens_generated")})
    return reqs, launches


def zoo_prefill(cfg, params, dev, part: str, phase: str = "lm_zoo",
                batch: Optional[dict] = None) -> dict:
    """``batch`` (default: one seeded ZOO_PREFILL_S-token prompt) through
    ``lm.prefill`` twice (the second timed, its launches counted; the two
    logits bit for bit equal: the MoE combine and the SSD scan are
    fixed-order), finite logits of the text's shape; its busy share.
    Returns the timed run's launches."""
    import numpy as np
    import torch
    from repro_torch.models import lm
    if batch is None:
        batch = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab, (1, ZOO_PREFILL_S)))}
    B, S = batch["tokens"].shape
    prefix = {f"{k}_shape": list(batch[k].shape[:2])
              for k in ("frames", "patches") if k in batch}

    def prefill():
        out = lm.prefill(params, cfg, batch)
        _sync(dev)
        return out
    first = prefill()
    reset_launches()
    t0 = time.perf_counter()
    logits = prefill()
    wall = time.perf_counter() - t0
    launches = read_launches()
    same = bool(torch.equal(first, logits))
    finite = bool(torch.isfinite(logits).all()) and \
        tuple(logits.shape) == (B, S, cfg.vocab)
    del first, logits
    emit(phase, part=part, config=cfg.name, layers=cfg.n_layers,
         dtype=str(cfg.dtype), tokens=[B, S], **prefix, wall_ms=wall * 1e3,
         tokens_per_s=B * S / wall, launches=launches,
         two_runs_bitwise_equal=same, finite=finite,
         traced_run=busy_share(prefill, wall))
    if not (same and finite):
        raise AssertionError(f"{phase} {part}: finite {finite}, two runs "
                             f"equal {same}")
    return launches


def zoo_prefill_twin(name: str, dev, cpu: dict, part: str) -> dict:
    """The fp32 twin's prefill on the card against the CPU's: the MoE
    routing (:func:`routing_agreement`) and the logits of LM_TWIN_ROWS
    before the first differing token within LM_PREFILL_ATOL. Returns
    the card's launches and the twin model (cfg, params)."""
    cfg, params = zoo_twin_model(name, dev)
    reset_launches()
    got, routes = zoo_prefill_logits(cfg, params)
    launches = read_launches()
    agree = routing_agreement(routes, cpu["routes"])
    end = agree["first_differing_token"]
    rows = [i for i, r in enumerate(LM_TWIN_ROWS) if end is None or r < end]
    d = float((got[rows] - cpu["logits"][rows]).abs().max())
    emit("lm_zoo", part=part, config=name, layers=cfg.n_layers,
         tokens=LM_TWIN_S, rows_compared=len(rows), routing=agree,
         launches=launches, max_abs_d_logits=d,
         max_abs_logit=float(cpu["logits"].abs().max()),
         atol=LM_PREFILL_ATOL)
    if agree["unexplained"] or d > LM_PREFILL_ATOL or \
            len(rows) < len(LM_TWIN_ROWS) // 2:
        raise AssertionError(f"lm_zoo {part}: logits {d:.3g} from the "
                             f"CPU's (atol {LM_PREFILL_ATOL}), routing "
                             f"{agree}")
    return launches, cfg, params


def zoo_train(name: str, dev, layers: Optional[int], S: int, part: str,
              want: dict, phase: str = "lm_zoo", **kw) -> dict:
    """One Trainer step on ``name`` (bf16, depth ``layers``, 1 × S
    tokens): a finite loss and grad norm, and exactly the launches in
    ``want`` (none of any other kernel); its line under ``phase``.
    Returns the launches."""
    import math
    from repro_torch.train import TrainConfig, Trainer
    cfg, params = zoo_model(name, dev, layers, **kw)
    tr = Trainer(cfg, TrainConfig(), lm_train_batcher(cfg, 1, S),
                 params=params, device=dev)
    del params
    reset_launches()
    t0 = time.perf_counter()
    h = tr.run(steps=1)[-1]
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = read_launches()
    exact = all(launches[k] == n for k, n in want.items()) and all(
        c == 0 for k, c in launches.items() if k not in want)
    finite = math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
    emit(phase, part=part, config=cfg.name, layers=cfg.n_layers,
         dtype=str(cfg.dtype), tokens=[1, S], n_params=tr.n_params,
         loss=h["loss"], grad_norm=h["grad_norm"], step_ms=wall * 1e3,
         launches=launches, launches_exact=exact, finite=finite)
    if not (finite and exact):
        raise AssertionError(f"{phase} {part}: finite {finite}, launches "
                             f"{launches} (want {want})")
    return launches


def zoo_train_twin(name: str, dev, cpu: dict, part: str) -> None:
    """The fp32 training twin on the card against the CPU's: every loss
    within LM_TRAIN_LOSS_RTOL, every grad norm within
    LM_TRAIN_GNORM_RTOL."""
    import numpy as np
    run = zoo_train_twin_run(name, dev)
    rel = lambda a, b: float(np.max(np.abs(np.subtract(a, b))
                                    / np.abs(b)))
    d_loss = rel(run["losses"], cpu["losses"])
    d_gn = rel(run["grad_norms"], cpu["grad_norms"])
    ok = d_loss <= LM_TRAIN_LOSS_RTOL and d_gn <= LM_TRAIN_GNORM_RTOL
    emit("lm_zoo", part=part, config=name, steps=ZOO_TRAIN_TWIN_STEPS,
         tokens=ZOO_TRAIN_TWIN_S, losses=run["losses"],
         cpu_losses=cpu["losses"], grad_norms=run["grad_norms"],
         cpu_grad_norms=cpu["grad_norms"], loss_max_rel_d=d_loss,
         grad_norm_max_rel_d=d_gn, ok=ok,
         tolerances={"loss_rtol": LM_TRAIN_LOSS_RTOL,
                     "grad_norm_rtol": LM_TRAIN_GNORM_RTOL})
    if not ok:
        raise AssertionError(f"lm_zoo {part}: losses {d_loss:.3g}, grad "
                             f"norms {d_gn:.3g} from the CPU's")


def lm_zoo_phase(dev, twins: dict) -> dict:
    """(i) granite-moe-3b-a800m at its published config: a 2,048-token
    prefill (one bf16 flash forward a layer), two runs bit for bit, the
    serve burst; (ii) its 2-layer fp32 twin against the CPU (routing,
    then logits); (iii) mamba2-370m at its published config: the prefill
    through the chunked SSD, the burst, the batch-composition contract,
    the fp32 twin against the CPU and token-by-token decode against the
    prefill on the card; (iv) jamba's smoke config with its int8 cache in
    fp32 and bf16: a 1,100-token prefill through the flash forward, a
    single request against the CPU twin's tokens; (v) one train step each
    (granite at 4 layers with its flash backward, mamba2 at 4 layers,
    jamba), and the fp32 training twins against the CPU. Returns each
    path's launches."""
    import numpy as np
    import torch
    from repro_torch import testing
    from repro_torch.models import lm
    t_phase = time.perf_counter()
    out = {}
    bf16 = "torch.bfloat16"

    # (i) granite at its published config.
    cfg, params = zoo_model(ZOO_GRANITE, dev)
    out["lm_zoo_granite_prefill"] = zoo_prefill(cfg, params, dev,
                                                "granite_prefill")
    pl = out["lm_zoo_granite_prefill"]
    if pl[FLASH_FWD[bf16]] != cfg.n_layers or sum(pl.values()) != \
            cfg.n_layers:
        raise AssertionError(f"granite prefill: launches {pl}, want "
                             f"{cfg.n_layers} of {FLASH_FWD[bf16]}")
    _, out["lm_zoo_granite_serve"] = zoo_serve(cfg, params, dev,
                                               "granite_serve")
    del params

    # (ii) the granite twin.
    cpu = twins[f"zoo:{ZOO_GRANITE}"].result()
    out["lm_zoo_granite_twin"], *_ = zoo_prefill_twin(
        ZOO_GRANITE, dev, cpu, "granite_twin")
    zoo_train_twin(ZOO_GRANITE, dev, cpu["train"], "granite_train_twin")

    # (iii) mamba2 at its published config.
    cfg, params = zoo_model(ZOO_MAMBA2, dev)
    out["lm_zoo_mamba2_prefill"] = zoo_prefill(cfg, params, dev,
                                               "mamba2_prefill")
    if any(out["lm_zoo_mamba2_prefill"].values()):
        raise AssertionError(f"mamba2 prefill launched "
                             f"{out['lm_zoo_mamba2_prefill']}: it has no "
                             "attention")
    reqs, out["lm_zoo_mamba2_serve"] = zoo_serve(cfg, params, dev,
                                                 "mamba2_serve")
    prompts = lm_prompts(cfg.vocab)
    alone = {i: lm_serve(cfg, params, [prompts[i]], dev,
                         LM_MAX_NEW)[1][0].tokens for i in LM_CONTRACT}
    same = {i: alone[i] == reqs[i].tokens for i in LM_CONTRACT}
    emit("lm_zoo", part="mamba2_contract", requests=list(LM_CONTRACT),
         alone_equals_burst=same)
    if not all(same.values()):
        raise AssertionError(f"mamba2: batch composition changed tokens: "
                             f"{same}")
    del params
    cpu = twins[f"zoo:{ZOO_MAMBA2}"].result()
    _, tcfg, tparams = zoo_prefill_twin(ZOO_MAMBA2, dev, cpu, "mamba2_twin")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, tcfg.vocab, (1, ZOO_DECODE_S)))
    full = lm.prefill(tparams, tcfg, {"tokens": toks})
    cache = lm.init_cache(tcfg, 1, ZOO_DECODE_S, dev)
    steps = []
    for t in range(ZOO_DECODE_S):
        step, cache = lm.decode_step(tparams, tcfg, cache, toks[:, t:t + 1],
                                     t)
        steps.append(step[:, 0])
    d = float((full - torch.stack(steps, 1)).abs().max())
    emit("lm_zoo", part="mamba2_decode_equals_prefill", layers=tcfg.n_layers,
         tokens=ZOO_DECODE_S, max_abs_d=d, atol=ZOO_DECODE_ATOL)
    if d > ZOO_DECODE_ATOL:
        raise AssertionError(f"mamba2: decode {d:.3g} from the prefill")
    zoo_train_twin(ZOO_MAMBA2, dev, cpu["train"], "mamba2_train_twin")

    # (iv) jamba at its smoke config, int8 cache, fp32 and bf16.
    cpu = twins[f"zoo:{ZOO_JAMBA}"].result()
    for dtype in (torch.float32, torch.bfloat16):
        jcfg, jparams = zoo_model(ZOO_JAMBA, dev, dtype=dtype, seed=1,
                                  smoke=True, kv_cache_dtype="int8")
        reset_launches()
        logits, _ = zoo_prefill_logits(jcfg, jparams)
        launches = read_launches()
        n_attn = jcfg.n_layers // jcfg.attn_every
        kern = FLASH_FWD[str(dtype)]
        req = zoo_jamba_serve(jcfg, jparams, dev, keep_logits=True)
        line = dict(part=f"jamba_{str(dtype)[6:]}", config=jcfg.name,
                    kv_cache_dtype=jcfg.kv_cache_dtype, tokens=LM_TWIN_S,
                    launches=launches,
                    finite=bool(torch.isfinite(logits).all()),
                    served_tokens=req.tokens)
        ok = line["finite"] and launches[kern] == n_attn and \
            sum(launches.values()) == n_attn and \
            len(req.tokens) == LM_TWIN_MAX_NEW
        if dtype == torch.float32:
            rep = testing.compare_tokens([req.tokens], [cpu["tokens"]],
                                         [req.logits], [cpu["logits"]],
                                         atol=LM_SERVE_ATOL)
            line.update(cpu_tokens=cpu["tokens"], atol=LM_SERVE_ATOL,
                        tokens_equal=req.tokens == cpu["tokens"],
                        **rep.as_dict())
        out[f"lm_zoo_jamba_prefill_{str(dtype)[6:]}"] = launches
        emit("lm_zoo", ok=ok, **line)
        if not ok:
            raise AssertionError(f"jamba {dtype}: {line}")

    # (v) one train step each, and the jamba training twin.
    out["lm_zoo_granite_train"] = zoo_train(
        ZOO_GRANITE, dev, ZOO_TRAIN_LAYERS, ZOO_PREFILL_S, "granite_train",
        {FLASH_FWD[bf16]: 2 * ZOO_TRAIN_LAYERS,
         FLASH_DQ[bf16]: ZOO_TRAIN_LAYERS,
         FLASH_DKV[bf16]: ZOO_TRAIN_LAYERS})
    out["lm_zoo_mamba2_train"] = zoo_train(
        ZOO_MAMBA2, dev, ZOO_TRAIN_LAYERS, ZOO_PREFILL_S, "mamba2_train", {})
    out["lm_zoo_jamba_train"] = zoo_train(
        ZOO_JAMBA, dev, None, LM_TWIN_S, "jamba_train",
        {FLASH_FWD[bf16]: 2, FLASH_DQ[bf16]: 1, FLASH_DKV[bf16]: 1},
        dtype=torch.bfloat16, smoke=True, kv_cache_dtype="int8")
    zoo_train_twin(ZOO_JAMBA, dev, cpu["train"], "jamba_train_twin")
    emit("lm_zoo", part="seconds", seconds=time.perf_counter() - t_phase,
         budget_s=ZOO_BUDGET_S)
    return out


# ---------------------------------------------------------------------------
# Phase lm_quant: the LM zoo on the crossbar (quant_mode="wbs")
# ---------------------------------------------------------------------------

LMQ_MIRU_ROWS = tuple(range(0, LMQ_MIRU_TWIN_S, 10)) + (LMQ_MIRU_TWIN_S - 1,)


def lmq_twin_model(dev, **kw):
    """The twins' model (qwen2-0.5B's widths in fp32, LM_TWIN_LAYERS
    layers, attention chunk LMQ_TWIN_CHUNK, weights drawn on the CPU from
    seed 1) with ``kw`` replaced."""
    import torch
    return zoo_model(LM, dev, LM_TWIN_LAYERS, torch.float32, seed=1,
                     attn_chunk=LMQ_TWIN_CHUNK, **kw)


def lmq_logits(cfg, params, S: int, rows=None, seed: int = 2):
    """One seeded S-token prompt's prefill logits (fp32, on the CPU), at
    ``rows`` or all of them."""
    import numpy as np
    import torch
    from repro_torch.models import lm
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (1, S)))
    logits = lm.prefill(params, cfg, {"tokens": toks})[0]
    if rows is not None:
        logits = logits[list(rows)]
    return logits.to(torch.float32).cpu()


def lmq_serve(cfg, params, dev, prompts, max_new: int, meter: bool = True,
              keep_logits: bool = False):
    """``prompts`` through a fresh 8-slot engine on the ``wbs`` substrate
    (its telemetry on, from zero, when ``meter``); returns (engine,
    requests)."""
    from repro_torch.serve import ServeConfig, ServeEngine
    eng = ServeEngine(cfg, ServeConfig(
        batch_slots=LM_SLOTS, max_len=LM_MAX_LEN, eos_token=-1,
        torch_device=dev, device="wbs", meter=meter,
        keep_logits=keep_logits), params)
    eng.telemetry.reset()
    reqs = [eng.submit(p, max_new) for p in prompts]
    eng.run_until_drained()
    _sync(dev)
    return eng, reqs


def lmq_hand_count(cfg, decode_calls: int) -> dict:
    """The ``dense`` counters of ``decode_calls`` decode calls, by hand
    (``tests/test_serve_telemetry.py``'s count): per layer wq, wk, wv, wo
    and the SwiGLU gate, up and down, LM_SLOTS rows each (idle slots
    stream pad tokens), 8-bit drives; the tied head is not quantized."""
    D, Fd, hd = cfg.d_model, cfg.d_ff, cfg.hd()
    q, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    denses = [(D, q), (D, kv), (D, kv), (q, D), (D, Fd), (D, Fd), (Fd, D)]
    rows = LM_SLOTS * cfg.n_layers * decode_calls
    return {"vmm_rows/dense": rows * len(denses),
            "macs/dense": rows * sum(i * o for i, o in denses),
            "bit_pulses/dense": rows * 8 * sum(i for i, _ in denses),
            "wbs_phases/dense": rows * 8 * len(denses)}


def lmq_smoke_serve(dev) -> tuple:
    """The metered engine's traffic (the same prompt lengths, new tokens
    and slots) on qwen2's smoke config in fp32, each token's logits kept:
    (engine, requests)."""
    import torch
    cfg, params = zoo_model(LM, dev, dtype=torch.float32, seed=1,
                            smoke=True)
    return lmq_serve(cfg, params, dev,
                     lm_prompts(cfg.vocab)[:LMQ_REQUESTS], LMQ_MAX_NEW,
                     keep_logits=True)


def lmq_train_twin_run(dev) -> dict:
    """One quantized Trainer step (warmup 0) of the twin model on 1 ×
    LMQ_TWIN_S tokens: its loss and grad norm."""
    from repro_torch.train import TrainConfig, Trainer
    cfg, params = lmq_twin_model(dev, quant_mode="wbs")
    tr = Trainer(cfg, TrainConfig(warmup_steps=0),
                 lm_train_batcher(cfg, 1, LMQ_TWIN_S, seed=3),
                 params=params, device=dev)
    h = tr.run(steps=1)[-1]
    return {"loss": h["loss"], "grad_norm": h["grad_norm"]}


def lmq_twin(part: str) -> dict:
    """The CPU side of the lm_quant twins: ``prefill`` (the quantized twin
    model's logits), ``miru`` (the float and the quantized miru twins'),
    ``serve`` (the smoke-width engine's counters, tokens and logits) and
    ``train``."""
    import dataclasses
    import torch
    cpu = torch.device("cpu")
    if part == "prefill":
        cfg, params = lmq_twin_model(cpu, quant_mode="wbs")
        return {"logits": lmq_logits(cfg, params, LMQ_TWIN_S)}
    if part == "miru":
        cfg, params = lmq_twin_model(cpu, mixer="miru")
        return {"float": lmq_logits(cfg, params, LMQ_MIRU_TWIN_S,
                                    LMQ_MIRU_ROWS),
                "wbs": lmq_logits(dataclasses.replace(cfg, quant_mode="wbs"),
                                  params, LMQ_MIRU_Q_TWIN_S)}
    if part == "serve":
        eng, reqs = lmq_smoke_serve(cpu)
        return {"counters": eng.telemetry.snapshot(),
                "decode_calls": eng.decode_calls,
                "steps_run": eng.steps_run,
                "tokens": [r.tokens for r in reqs],
                "logits": [torch.stack(r.logits) for r in reqs]}
    return lmq_train_twin_run(cpu)


def lmq_distance(got, cpu) -> dict:
    """Max and mean |Δ logit| of two logit tensors, and whether both lie
    within the twins' tolerances."""
    d = (got - cpu).abs()
    out = {"max_abs_d": float(d.max()), "mean_abs_d": float(d.mean())}
    out["within"] = out["max_abs_d"] <= LMQ_TWIN_ATOL and \
        out["mean_abs_d"] <= LMQ_TWIN_MEAN_ATOL
    return out


def lmq_exact(launches: dict, want: dict) -> bool:
    """Exactly ``want``'s launches, and none of any other kernel."""
    return all(c == want.get(k, 0) for k, c in launches.items())


def lm_quant_phase(dev, twins: dict) -> dict:
    """(i) qwen2-0.5B at its published widths with every projection on
    the ``wbs`` crossbar: the prefill's launches, bits run to run, the
    distance from the float model; (ii) its 2-layer fp32 twin against the
    CPU, and a planted fault against the same check; (iii) the metered
    engine: counters against the hand count and, at the smoke width on
    the same traffic, against the CPU's engine; the energy block; slot 0
    twice; (iv) the miru mixer, float and quantized, and their twins;
    (v) one quantized train step and the training twin. Returns each
    path's launches."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import testing
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve import ServeConfig, ServeEngine
    t_phase = time.perf_counter()
    bf16, f32 = "torch.bfloat16", "torch.float32"
    out = {}

    # (i) the quantized prefill at full width.
    cfg, params = lm_full_model(dev)
    cfg = dataclasses.replace(cfg, quant_mode="wbs")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, LMQ_PREFILL_S)))

    def prefill(c=cfg):
        logits = lm.prefill(params, c, {"tokens": toks})
        _sync(dev)
        return logits
    first = prefill()
    reset_launches()
    t0 = time.perf_counter()
    logits = prefill()
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = {"wbs_matmul": 7 * cfg.n_layers, FLASH_FWD[bf16]: cfg.n_layers}
    same = bool(torch.equal(first, logits))
    finite = bool(torch.isfinite(logits).all())
    del first
    flt = prefill(dataclasses.replace(cfg, quant_mode="none"))
    rel = float((logits.float() - flt.float()).abs().max()
                / flt.float().abs().max())
    agree = float((logits.argmax(-1) == flt.argmax(-1)).float().mean())
    del flt, logits
    emit("lm_quant", part="prefill", config=LM, quant_mode=cfg.quant_mode,
         layers=cfg.n_layers, dtype=str(cfg.dtype),
         tokens=[1, LMQ_PREFILL_S], wall_ms=wall * 1e3,
         tokens_per_s=LMQ_PREFILL_S / wall, launches=launches,
         launches_exact=lmq_exact(launches, want), finite=finite,
         two_runs_bitwise_equal=same, rel_d_from_float=rel,
         argmax_agreement_with_float=agree,
         traced_run=busy_share(prefill, wall))
    if not (lmq_exact(launches, want) and same and finite):
        raise AssertionError(f"lm_quant prefill: launches {launches} (want "
                             f"{want}), finite {finite}, equal {same}")
    out["lm_quant_prefill"] = launches

    # (ii) the twin against the CPU, then with a planted fault.
    tcfg, tparams = lmq_twin_model(dev, quant_mode="wbs")
    reset_launches()
    got = lmq_logits(tcfg, tparams, LMQ_TWIN_S)
    twin_launches = read_launches()
    cpu = twins["lmq:prefill"].result()["logits"]
    dist = lmq_distance(got, cpu)
    wbs_dense = ops.wbs_dense

    def fewer_bits(x, w, n_bits=8, **kw):
        return wbs_dense(x, w, LMQ_FAULT_BITS, **kw)
    ops.wbs_dense = fewer_bits
    try:
        fault = lmq_distance(lmq_logits(tcfg, tparams, LMQ_TWIN_S), cpu)
    finally:
        ops.wbs_dense = wbs_dense
    ok = dist["within"] and not fault["within"] and bool(
        torch.isfinite(got).all()) and lmq_exact(
        twin_launches, {"wbs_matmul": 7 * tcfg.n_layers,
                        FLASH_FWD[f32]: tcfg.n_layers})
    emit("lm_quant", part="prefill_twin", layers=tcfg.n_layers,
         tokens=LMQ_TWIN_S, attn_chunk=tcfg.attn_chunk,
         launches=twin_launches, **dist,
         max_abs_logit=float(cpu.abs().max()), atol=LMQ_TWIN_ATOL,
         mean_atol=LMQ_TWIN_MEAN_ATOL,
         planted_fault={"drive_bits": LMQ_FAULT_BITS, **fault,
                        "caught": not fault["within"]}, ok=ok)
    if not ok:
        raise AssertionError(f"lm_quant prefill twin: {dist}, planted "
                             f"fault {fault}, launches {twin_launches}")
    del tparams

    # (iii) the metered engine, its counters and energy; slot 0 twice.
    prompts = lm_prompts(cfg.vocab)[:LMQ_REQUESTS]
    lmq_serve(cfg, params, dev, prompts[:2], 4)                # warm-up
    reset_launches()
    t0 = time.perf_counter()
    eng, reqs = lmq_serve(cfg, params, dev, prompts, LMQ_MAX_NEW)
    wall = time.perf_counter() - t0
    serve_launches = read_launches()
    counters = eng.telemetry.snapshot()
    hand = lmq_hand_count(cfg, eng.decode_calls)
    stats = eng.request_stats()
    energy = stats["energy"]
    seng, sreqs = lmq_smoke_serve(dev)
    smoke = seng.telemetry.snapshot()
    cpu = twins["lmq:serve"].result()
    # The smoke-width engine's tokens (its decode replayed as a CUDA
    # graph) against the CPU's eager engine's, tie-aware.
    rep = testing.compare_tokens([r.tokens for r in sreqs], cpu["tokens"],
                                 [r.logits for r in sreqs], cpu["logits"],
                                 atol=LMQ_SERVE_ATOL)
    smoke_tokens = dict(graph=seng._graph is not None,
                        tokens_equal=[r.tokens for r in sreqs]
                        == cpu["tokens"], atol=LMQ_SERVE_ATOL,
                        **rep.as_dict())
    traffic = [(e.decode_calls, e.steps_run) for e in (eng, seng)] + \
        [(cpu["decode_calls"], cpu["steps_run"])]
    eng.telemetry.disable()
    # The busy share of a short window on an engine whose graph is
    # captured, as in lm_zoo.
    wave = [p[:ZOO_TRACE_PROMPT] for p in prompts[:LM_SLOTS]]
    weng = ServeEngine(cfg, ServeConfig(
        batch_slots=LM_SLOTS, max_len=LM_MAX_LEN, eos_token=-1,
        torch_device=dev), params)

    def window():
        for p in wave:
            weng.submit(p, ZOO_TRACE_NEW)
        weng.run_until_drained()
        _sync(dev)
    window()                                           # the capture
    calls = weng.decode_calls
    t0 = time.perf_counter()
    window()
    busy = busy_share(window, time.perf_counter() - t0)
    calls = (weng.decode_calls - calls) // 2
    busy["window"] = (f"{len(wave)} requests of {ZOO_TRACE_PROMPT} prompt "
                      f"tokens, {ZOO_TRACE_NEW} new each, {LM_SLOTS} slots, "
                      f"{calls} decode calls, the graph captured before")
    busy["device_ms_a_decode_call"] = busy["device_busy_s"] * 1e3 / calls
    alone = [lmq_serve(cfg, params, dev, prompts[:1], LMQ_MAX_NEW,
                       meter=False)[1][0].tokens for _ in range(2)]
    ok = (counters == hand and smoke == cpu["counters"]
          == lmq_hand_count(seng.cfg, seng.decode_calls)
          and smoke_tokens["graph"]
          and len(set(traffic)) == 1 and alone[0] == alone[1]
          and len(alone[0]) == LMQ_MAX_NEW
          and all(len(r.tokens) == LMQ_MAX_NEW for r in reqs))
    emit("lm_quant", part="serve", device="wbs", meter=True,
         slots=LM_SLOTS, max_len=LM_MAX_LEN, requests=stats["requests"],
         max_new=LMQ_MAX_NEW, prompt_tokens=sum(len(p) for p in prompts),
         wall_s=wall, ms_a_decode_call=wall * 1e3 / stats["decode_calls"],
         launches_outside_the_graph=serve_launches, counters=counters,
         counters_equal_hand_count=counters == hand,
         smoke_counters_equal_cpu_engine=smoke == cpu["counters"],
         smoke_tokens_against_cpu_engine=smoke_tokens,
         decode_calls_and_steps=traffic,
         energy={k: energy[k] for k in ("power_mw", "gops_per_w",
                                         "pj_per_op", "total_j")},
         pj_per_request=energy["pj_per_request"], traced_run=busy,
         slot0_alone_twice_equal=alone[0] == alone[1], ok=ok,
         **{k: stats[k] for k in ("steps_run", "decode_calls", "latency_ms",
                                  "tokens_per_s", "tokens_generated")})
    if not ok:
        raise AssertionError(f"lm_quant serve: counters {counters} (hand "
                             f"{hand}), smoke {smoke} vs CPU "
                             f"{cpu['counters']}, traffic {traffic}, alone "
                             f"{alone}, smoke tokens {smoke_tokens}")
    out["lm_quant_serve"] = serve_launches
    del params, eng, seng, weng

    # (iv) the miru mixer, float and quantized, and their twins.
    mcfg, mparams = zoo_model(LM, dev, mixer="miru")
    lines = {}
    for quant, S, want in (
            ("none", LMQ_MIRU_S, {"miru_scan": mcfg.n_layers}),
            ("wbs", LMQ_MIRU_Q_S,
             {"wbs_matmul": mcfg.n_layers * (2 * LMQ_MIRU_Q_S + 4)})):
        c = dataclasses.replace(mcfg, quant_mode=quant)
        mtoks = torch.from_numpy(np.random.default_rng(1).integers(
            0, c.vocab, (1, S)))
        reset_launches()
        t0 = time.perf_counter()
        ml = lm.prefill(mparams, c, {"tokens": mtoks})
        _sync(dev)
        wall = time.perf_counter() - t0
        launches = read_launches()
        lines[quant] = dict(tokens=[1, S], wall_ms=wall * 1e3,
                            launches=launches,
                            launches_exact=lmq_exact(launches, want),
                            finite=bool(torch.isfinite(ml).all()))
        out[f"lm_quant_miru_{quant}"] = launches
        del ml
    del mparams
    tm_cfg, tm_params = lmq_twin_model(dev, mixer="miru")
    cpu = twins["lmq:miru"].result()
    d_float = float((lmq_logits(tm_cfg, tm_params, LMQ_MIRU_TWIN_S,
                                LMQ_MIRU_ROWS) - cpu["float"]).abs().max())
    d_wbs = lmq_distance(lmq_logits(dataclasses.replace(
        tm_cfg, quant_mode="wbs"), tm_params, LMQ_MIRU_Q_TWIN_S), cpu["wbs"])
    ok = all(v["launches_exact"] and v["finite"] for v in lines.values()) \
        and d_float <= LM_PREFILL_ATOL and d_wbs["within"]
    emit("lm_quant", part="miru", config=mcfg.name, mixer="miru",
         layers=mcfg.n_layers, dtype=str(mcfg.dtype), float=lines["none"],
         wbs=lines["wbs"], twin_float={"tokens": LMQ_MIRU_TWIN_S,
                                       "rows": len(LMQ_MIRU_ROWS),
                                       "max_abs_d": d_float,
                                       "atol": LM_PREFILL_ATOL},
         twin_wbs={"tokens": LMQ_MIRU_Q_TWIN_S, **d_wbs}, ok=ok)
    if not ok:
        raise AssertionError(f"lm_quant miru: {lines}, twins {d_float:.3g}, "
                             f"{d_wbs}")
    del tm_params

    # (v) one quantized train step, and the training twin.
    L = LMQ_TRAIN_LAYERS
    out["lm_quant_train"] = zoo_train(
        LM, dev, L, LMQ_PREFILL_S, "train",
        {"wbs_matmul": 2 * 7 * L, FLASH_FWD[bf16]: 2 * L,
         FLASH_DQ[bf16]: L, FLASH_DKV[bf16]: L}, phase="lm_quant",
        quant_mode="wbs")
    reset_launches()
    run = lmq_train_twin_run(dev)
    launches = read_launches()
    L = LM_TWIN_LAYERS
    want = {"wbs_matmul": 2 * 7 * L, FLASH_FWD[f32]: 2 * L,
            FLASH_DQ[f32]: L, FLASH_DKV[f32]: L}
    cpu = twins["lmq:train"].result()
    d_loss = abs(run["loss"] - cpu["loss"]) / abs(cpu["loss"])
    d_gn = abs(run["grad_norm"] - cpu["grad_norm"]) / abs(cpu["grad_norm"])
    ok = d_loss <= LMQ_TRAIN_LOSS_RTOL and d_gn <= LMQ_TRAIN_GNORM_RTOL \
        and lmq_exact(launches, want)
    emit("lm_quant", part="train_twin", layers=L, tokens=LMQ_TWIN_S,
         attn_chunk=LMQ_TWIN_CHUNK, launches=launches,
         launches_exact=lmq_exact(launches, want),
         loss=run["loss"], cpu_loss=cpu["loss"],
         grad_norm=run["grad_norm"], cpu_grad_norm=cpu["grad_norm"],
         loss_rel_d=d_loss, grad_norm_rel_d=d_gn,
         tolerances={"loss_rtol": LMQ_TRAIN_LOSS_RTOL,
                     "grad_norm_rtol": LMQ_TRAIN_GNORM_RTOL}, ok=ok)
    if not ok:
        raise AssertionError(f"lm_quant train twin: loss {d_loss:.3g}, "
                             f"grad norm {d_gn:.3g} from the CPU's, "
                             f"launches {launches} (want {want})")
    emit("lm_quant", part="seconds", seconds=time.perf_counter() - t_phase,
         budget_s=LMQ_BUDGET_S)
    return out


# ---------------------------------------------------------------------------
# Phase lm_mla: MLA and deepseek-v3 with 8-bit Adam
# ---------------------------------------------------------------------------

class FlashShape(NamedTuple):
    """One attention shape of a slice's path (B 1): its tag in the
    kernels line, Sq, Sk, the query and KV heads, the (query/key, value)
    head dims, the causal mask, whether the backward runs there too, and
    the keys past ``sk_true`` (None: every key counts) that a check
    masks."""
    tag: str
    sq: int
    sk: int
    h: int
    kh: int
    dh: int
    dv: int
    causal: bool
    bwd: bool = True
    sk_true: Optional[int] = None


def flash_names(shapes) -> dict:
    """The kernels-line names of the flash kernels of each dtype at
    ``shapes``, ``<kernel>@<tag>`` → the kernel whose counter they move
    (each wrapper counts all its shapes; which path's count a name takes
    is set in :func:`main`)."""
    tables = (FLASH_FWD, FLASH_DQ, FLASH_DKV)
    return {f"{k}@{s.tag}": k for s in shapes
            for table in tables[:3 if s.bwd else 1] for k in table.values()}


def flash_qkv(rng, dev, s: FlashShape, dtype):
    """Seeded q (1, Sq, H, dh), k (1, Sk, Kh, dh), v (1, Sk, Kh, dv) and
    dO (1, Sq, H, dv)."""
    import numpy as np
    import torch
    return [torch.from_numpy(rng.normal(0, 1, (1, *sh)).astype(
        np.float32)).to(dev, dtype) for sh in (
        (s.sq, s.h, s.dh), (s.sk, s.kh, s.dh), (s.sk, s.kh, s.dv),
        (s.sq, s.h, s.dv))]


def check_flash_at(dev, cases, seed: int) -> dict:
    """The flash forward (and, where ``bwd``, dq and dk/dv) of each dtype
    at each :class:`FlashShape` of ``cases`` against their plain versions
    on the same inputs, at the flash checks' bounds: out fp32 rtol 2e-5 /
    atol 2e-6, bf16 ``testing.bf16_within``; lse atol 1e-5; the
    gradients ``testing.grads_close``, keys past sk_true with none; each
    kernel launched once a call, the backward twice bit for bit. Returns
    the largest error of each name of :func:`flash_names`."""
    import numpy as np
    import torch
    from repro_torch import testing
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(seed)
    err = {k: 0.0 for k in flash_names(cases)}
    heads = lambda t: t.float().transpose(1, 2).reshape(-1, t.shape[1],
                                                        t.shape[3])
    for s in cases:
        for dt in (torch.bfloat16, torch.float32):
            q, k, v, dout = flash_qkv(rng, dev, s, dt)
            fwd, dq_k, dkv_k = (FLASH_FWD[str(dt)], FLASH_DQ[str(dt)],
                                FLASH_DKV[str(dt)])
            before = read_launches()
            out, lse = ops.flash_attention_fwd(q, k, v, s.causal, s.sk_true)
            f_once = launched_once((fwd,), before)
            want, want_lse = ref.flash_attention_fwd_ref(
                heads(q), heads(k), heads(v), s.causal, s.sk_true, s.h, s.kh)
            want = want.reshape(1, s.h, s.sq, s.dv).transpose(1, 2)
            e = {"out": float((out.float() - want).abs().max()),
                 "lse": float((lse.reshape(s.h, s.sq) - want_lse).abs()
                              .max())}
            out_ok = bool(torch.allclose(out, want, rtol=2e-5, atol=2e-6)) \
                if dt == torch.float32 else testing.bf16_within(out, want)[0]
            ok = out_ok and e["lse"] <= 1e-5 and f_once
            err[f"{fwd}@{s.tag}"] = max(err[f"{fwd}@{s.tag}"], e["out"])
            line = dict(kernel=fwd, head_dims=[s.dh, s.dv],
                        shape=[1, s.sq, s.sk, s.h, s.kh], causal=s.causal,
                        sk_true=s.sk_true, dtype=str(dt),
                        launched_once={"forward": f_once})
            del want
            if s.bwd:
                before = read_launches()
                got = ops.flash_attention_bwd(q, k, v, out, lse, dout,
                                              s.causal, s.sk_true)
                b_once = launched_once((dq_k, dkv_k), before)
                want_g = testing.flash_bwd_plain(q, k, v, out, lse, dout,
                                                 s.causal, s.sk_true)
                again = ops.flash_attention_bwd(q, k, v, out, lse, dout,
                                                s.causal, s.sk_true)
                torch.cuda.synchronize()
                e.update({n: float((g.float() - w).abs().max())
                          for n, g, w in zip(("dq", "dk", "dv"), got,
                                             want_g)})
                skt = s.sk_true
                masked = skt is None or not (got[1][:, skt:].any()
                                             or got[2][:, skt:].any())
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                ok = ok and b_once and masked and same and all(
                    testing.grads_close(g, w) for g, w in zip(got, want_g))
                err[f"{dq_k}@{s.tag}"] = max(err[f"{dq_k}@{s.tag}"],
                                             e["dq"])
                err[f"{dkv_k}@{s.tag}"] = max(err[f"{dkv_k}@{s.tag}"],
                                              e["dk"], e["dv"])
                line.update(kernel=f"{fwd} + {dq_k} + {dkv_k}",
                            launched_once={"forward": f_once,
                                           "backward": b_once},
                            max_abs_grad={n: float(w.abs().max()) for n, w in
                                          zip(("dq", "dk", "dv"), want_g)},
                            backward_bitwise_run_to_run=same)
                del got, want_g, again
            emit("kernels", **line, max_abs_err=e, ok=ok)
            if not ok:
                raise AssertionError(f"flash kernels != plain at {s}, {dt}: "
                                     f"{e}")
            del q, k, v, dout, out, lse
            torch.cuda.empty_cache()
    return err


def flash_widths(kind: str, dh: int, dv: int, split: bool = False) -> int:
    """The summed inner widths of a flash kernel's products: each product
    of a query-key tile costs 2·(its width) FLOPs a (query, key) pair.
    The forward q·kᵀ (dh) and p·V (dv); dq s, dO·Vᵀ, ds·K; dk/dv s,
    dO·Vᵀ, pᵀ·dO, dsᵀ·Q. ``split``: the bf16 kernels' products on split
    terms (p·V in three, ds·K, pᵀ·dO, dsᵀ·Q in two)."""
    x = 1 + int(split)
    return {"fwd": dh + (1 + 2 * int(split)) * dv,
            "dq": dh + dv + x * dh,
            "dkv": dh + dv + x * (dv + dh)}[kind]


def sdpa_timer(q, k, v, dout, causal: bool = True):
    """``F.scaled_dot_product_attention`` on (B, S, heads, ·) q, k, v
    (``enable_gqa`` where q has more heads than k), under the first
    backend of flash, cuDNN, memory-efficient and math that takes them:
    (forward call, forward-and-backward call, the backend's name), or
    (None, None, "none") when none does. Timed here only; the port never
    calls it."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    g = dout.transpose(1, 2).contiguous()
    kw = dict(is_causal=causal)
    if q.shape[2] != k.shape[2]:
        kw["enable_gqa"] = True
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                F.scaled_dot_product_attention(qh, kh, vh, **kw)
        except RuntimeError:
            continue

        def fwd(b=backend):
            with sdpa_kernel(b), torch.no_grad():
                return F.scaled_dot_product_attention(qh, kh, vh, **kw)

        def both(b=backend):
            with sdpa_kernel(b):
                o = F.scaled_dot_product_attention(qh, kh, vh, **kw)
                return torch.autograd.grad(o, (qh, kh, vh), g)
        return fwd, both, backend.name
    return None, None, "none"


def flash_times(dev, shapes, seed: int) -> dict:
    """The flash kernels at each :class:`FlashShape` of ``shapes``: the
    forward, and where ``bwd`` dq and dk/dv, of each dtype (bf16 through
    the tensor-core kernels, fp32 through the fp32 route's), each beside
    its plain version (CUDA events over 3 calls: its score tensors are
    GBs) and ``F.scaled_dot_product_attention`` on the same inputs
    (:func:`sdpa_timer`; for dq and dk/dv its whole forward and backward,
    CUDA events), and the least time for the work: 2·H·Sq·Sk·(the
    product widths, :func:`flash_widths`) FLOPs, halved when causal, q,
    k, v (and dO, lse, delta) read once and the outputs written once."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ref
    rng = np.random.default_rng(seed)
    out = {}
    heads = lambda t: t.transpose(1, 2).reshape(-1, t.shape[1], t.shape[3]
                                                ).contiguous()
    for s in shapes:
        H, Kh, Sq, Sk, dh, dv = s.h, s.kh, s.sq, s.sk, s.dh, s.dv
        kw = dict(causal=s.causal, sk_true=Sk, q_heads=H, kv_heads=Kh,
                  scale=dh ** -0.5)
        pairs = H * Sq * Sk / (2 if s.causal else 1)
        for dt in (torch.bfloat16, torch.float32):
            q, k, v, dout = flash_qkv(rng, dev, s, dt)
            qt, kt, vt, dot = heads(q), heads(k), heads(v), heads(dout)
            bf = dt == torch.bfloat16
            fwd = kf.flash_attention_fwd_sm90 if bf else kf.flash_attention_fwd
            dq_fn = kf.flash_attention_bwd_dq_sm90 if bf \
                else kf.flash_attention_bwd_dq
            dkv_fn = kf.flash_attention_bwd_dkv_sm90 if bf \
                else kf.flash_attention_bwd_dkv
            ot, lse = fwd(qt, kt, vt, **kw)
            delta = torch.sum(dot.float() * ot.float(), -1)
            lib_fwd, lib_both, backend = sdpa_timer(q, k, v, dout, s.causal)
            lib_f = time_events(lib_fwd, reps=5) if lib_fwd else None
            lib_b = time_events(lib_both, reps=5) \
                if lib_both and s.bwd else None
            flags = ", ".join(["is_causal"] * s.causal
                              + ["enable_gqa"] * (H != Kh))
            lib = (f"F.scaled_dot_product_attention"
                   f"{f'({flags})' if flags else ''}, {dt}, backend "
                   f"{backend}")
            qs, ks = H * Sq * qt.element_size(), Kh * Sk * qt.element_size()
            io = {"fwd": (qs + ks) * (dh + dv) + 4 * Sq * H,
                  "dq": qs * (2 * dh + dv) + ks * (dh + dv) + 8 * Sq * H,
                  "dkv": qs * (dh + dv) + ks * 2 * (dh + dv) + 8 * Sq * H}
            plain_f = time_events(lambda: ref.flash_attention_fwd_ref(
                qt, kt, vt, s.causal, Sk, H, Kh), reps=3)
            plain_b = time_events(lambda: ref.flash_attention_bwd_ref(
                qt, kt, vt, ot, lse, dot, s.causal, Sk, H, Kh), reps=3) \
                if s.bwd else None
            args = (qt, kt, vt, dot, lse, delta)
            kinds = [("fwd", lambda: fwd(qt, kt, vt, **kw), plain_f, lib_f)]
            if s.bwd:
                kinds += [("dq", lambda: dq_fn(*args, **kw), plain_b, lib_b),
                          ("dkv", lambda: dkv_fn(*args, **kw), plain_b,
                           lib_b)]
            for kind, call, plain, lib_ms in kinds:
                name = {"fwd": FLASH_FWD, "dq": FLASH_DQ,
                        "dkv": FLASH_DKV}[kind][str(dt)] + f"@{s.tag}"
                flops = 2 * pairs * flash_widths(kind, dh, dv)
                if bf:
                    b, by = bound_ms(0.0, io[kind], flops_bf16_tc=flops)
                    extra = {"bound_split_ms": bound_ms(
                        0.0, io[kind], flops_bf16_tc=2 * pairs * flash_widths(
                            kind, dh, dv, split=True))[0]}
                else:
                    b, by = bound_ms(0.0, io[kind], flops_bf16_tc=6 * flops)
                    extra = {"bound_cuda_cores_ms": bound_ms(flops,
                                                             io[kind])[0]}
                out[name] = dict(
                    shape=[1, Sq, Sk, H, Kh, dh, dv], dtype=str(dt),
                    causal=s.causal, ms=time_graph(call), plain_ms=plain,
                    plain="ref.flash_attention_fwd_ref" if kind == "fwd" else
                    "ref.flash_attention_bwd_ref: dq, dk and dv together",
                    library_ms=lib_ms, library=lib + (
                        "" if kind == "fwd" else ": forward and backward "
                        "together, CUDA events"), bound_ms=b, bound_by=by,
                    **extra)
            del q, k, v, dout, qt, kt, vt, dot, ot, lse, delta, args
            torch.cuda.empty_cache()
    for name, t in out.items():
        emit("times", kernel=name, **t)
    return out


# The (192, 128) shapes: checked at B·H MLA_CHECK_H (MLA's K/V are per
# head: rep 1), Sq = Sk = MLA_CHECK_S, causal and not, and causal with
# sk_true MLA_CHECK_SKT; timed at the deepseek prefill's (1 ×
# MLA_PREFILL_S, MLA_TIME_H heads, causal).
MLA_CHECKS = tuple(
    FlashShape("192x128", MLA_CHECK_S, MLA_CHECK_S, MLA_CHECK_H, MLA_CHECK_H,
               192, 128, causal, sk_true=skt)
    for causal, skt in ((True, None), (False, None), (True, MLA_CHECK_SKT)))
MLA_TIMES = (FlashShape("192x128", MLA_PREFILL_S, MLA_PREFILL_S, MLA_TIME_H,
                        MLA_TIME_H, 192, 128, True),)
MLA_KERNELS = flash_names(MLA_TIMES)
MLA_TWIN_ROWS = tuple(range(0, MLA_TWIN_S, 8)) + (MLA_TWIN_S - 1,)


def mla_model(dev, layers: int = MLA_LAYERS, dense: int = MLA_DENSE, **kw):
    """deepseek-v3 at its published widths in bf16, depth cut to
    ``layers`` (``dense`` of them dense), weights drawn on the card from
    seed 0."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config(MLA), n_layers=layers,
                              first_dense_layers=dense, **kw)
    return cfg, lm.init_params(torch.Generator(dev).manual_seed(0), cfg, dev)


def mla_twin_model(dev):
    """The twins' model: deepseek-v3's head dims with MLA_TWIN_CUT, fp32,
    chunk MLA_TWIN_CHUNK, weights drawn on the CPU from seed 1."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.utils import tree_to
    cfg = dataclasses.replace(get_config(MLA), dtype=torch.float32,
                              attn_chunk=MLA_TWIN_CHUNK, **MLA_TWIN_CUT)
    params = lm.init_params(torch.Generator().manual_seed(1), cfg, "cpu")
    return cfg, tree_to(params, dev)


def mla_value_and_grad(cfg, params, batch: dict):
    """The loss and every gradient (a tree like ``params``), as
    ``train.Trainer`` takes them."""
    import torch
    from repro_torch.models import lm
    from repro_torch.utils import tree_leaves, tree_map
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = lm.loss_fn(p, cfg, batch)
    leaves = tree_leaves(p)
    by_id = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    return loss.detach(), tree_map(lambda t: by_id[id(t)], p)


def mla_batch(cfg, S: int, dev, seed: int = 3) -> dict:
    import numpy as np
    import torch
    from repro_torch.data.synthetic import lm_token_batch
    b = lm_token_batch(np.random.default_rng(seed), 1, S, cfg.vocab)
    return {k: torch.from_numpy(np.asarray(a)).to(dev) for k, a in b.items()}


def twin_step(cfg, params, batch: dict) -> dict:
    """One fp32 twin step's loss, grad norm and gradients (on the CPU)."""
    import torch
    from repro_torch.utils import flatten_dict
    loss, grads = mla_value_and_grad(cfg, params, batch)
    flat = {k: g.cpu() for k, g in flatten_dict(grads).items()}
    gn = torch.sqrt(sum(torch.sum(torch.square(g)) for g in flat.values()))
    return {"loss": float(loss), "grad_norm": float(gn), "grads": flat}


def mla_twin_train(dev) -> dict:
    """The lm_mla twin's step (:func:`twin_step`)."""
    cfg, params = mla_twin_model(dev)
    return twin_step(cfg, params, mla_batch(cfg, MLA_TWIN_S, dev))


def mla_twin(part: str) -> dict:
    """The CPU side of the lm_mla twins: ``prefill`` (logits at
    MLA_TWIN_ROWS and routing) and ``train`` (one step)."""
    import torch
    cpu = torch.device("cpu")
    if part == "prefill":
        cfg, params = mla_twin_model(cpu)
        logits, routes = zoo_prefill_logits(cfg, params, MLA_TWIN_S,
                                            rows=MLA_TWIN_ROWS)
        return {"logits": logits, "routes": routes}
    return mla_twin_train(cpu)


def mla_serve(cfg, params, dev) -> dict:
    """The burst's first MLA_REQUESTS prompts, MLA_MAX_NEW new tokens
    each, through an 8-slot engine at MLA_MAX_LEN on the latent cache
    (after a warm-up engine's two requests): ms a decode call, tokens/s,
    the cache's bytes; then the write_rows check on the same model: a
    decode that steps half the slots leaves every latent row of the
    others the same bits. Returns the burst's launches."""
    import torch
    from repro_torch.models import lm
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.utils import tree_bytes, tree_leaves
    prompts = lm_prompts(cfg.vocab)[:MLA_REQUESTS]

    def engine():
        return ServeEngine(cfg, ServeConfig(
            batch_slots=LM_SLOTS, max_len=MLA_MAX_LEN, eos_token=-1,
            torch_device=dev), params)
    warm = engine()
    for p in prompts[:2]:
        warm.submit(p, 4)
    warm.run_until_drained()
    del warm
    eng = engine()
    reset_launches()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, MLA_MAX_NEW) for p in prompts]
    eng.run_until_drained()
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = read_launches()
    stats = eng.request_stats()
    cache_bytes = tree_bytes(eng.caches)
    kv_bytes = 2 * cfg.n_layers * LM_SLOTS * MLA_MAX_LEN * cfg.n_heads * (
        cfg.qk_nope_head_dim + cfg.qk_rope_head_dim + cfg.v_head_dim)
    served = all(r.done and len(r.tokens) == MLA_MAX_NEW for r in reqs)
    emit("lm_mla", part="serve", config=cfg.name, layers=cfg.n_layers,
         dtype=str(cfg.dtype), slots=LM_SLOTS, max_len=MLA_MAX_LEN,
         requests=stats["requests"], max_new=MLA_MAX_NEW,
         prompt_tokens=sum(len(p) for p in prompts), wall_s=wall,
         ms_a_decode_call=wall * 1e3 / stats["decode_calls"],
         decode_calls=stats["decode_calls"], steps_run=stats["steps_run"],
         tokens_per_s=stats["tokens_per_s"], latency_ms=stats["latency_ms"],
         latent_cache_bytes=cache_bytes,
         latent_cache_bytes_a_layer=cache_bytes // cfg.n_layers,
         per_head_bf16_kv_cache_bytes_a_layer=kv_bytes // cfg.n_layers,
         launches=launches, all_served=served)
    del eng
    # write_rows: random latent rows everywhere, a decode at position 5
    # stepping the even slots.
    caches = lm.init_cache(cfg, LM_SLOTS, 64, dev)
    g = torch.Generator(dev).manual_seed(5)
    for t in tree_leaves(caches):
        t.copy_(torch.randn(t.shape, generator=g, device=dev))
    before = [t.clone() for t in tree_leaves(caches)]
    rows = torch.arange(LM_SLOTS, device=dev) % 2 == 0
    toks = torch.randint(0, cfg.vocab, (LM_SLOTS, 1), generator=g,
                         device=dev)
    logits, _ = lm.decode_step(params, cfg, caches, toks,
                               torch.tensor(5, device=dev), write_rows=rows)
    _sync(dev)
    kept = all(torch.equal(a[:, ~rows], b[:, ~rows])
               for a, b in zip(tree_leaves(caches), before))
    wrote = all(not torch.equal(a[:, rows, 5], b[:, rows, 5])
                for a, b in zip(tree_leaves(caches), before))
    others = all(torch.equal(torch.cat([a[:, rows, :5], a[:, rows, 6:]], 2),
                             torch.cat([b[:, rows, :5], b[:, rows, 6:]], 2))
                 for a, b in zip(tree_leaves(caches), before))
    finite = bool(torch.isfinite(logits).all())
    emit("lm_mla", part="write_rows", slots=LM_SLOTS,
         stepped_slots=rows.nonzero().flatten().tolist(),
         other_slots_bitwise_unchanged=kept, stepped_slots_written=wrote,
         stepped_slots_other_positions_unchanged=others, finite=finite)
    if not (served and kept and wrote and others and finite):
        raise AssertionError(f"lm_mla serve: served {served}, write_rows "
                             f"kept {kept}, wrote {wrote}, others {others}")
    return launches


def mla_train(dev) -> dict:
    """One adam_8bit step at MLA_TRAIN_LAYERS (one dense MLA layer, bf16)
    on 1 × MLA_PREFILL_S tokens: the loss, ms a step, peak memory, the
    moments int8; exactly 2 bf16 flash forwards (the forward and its
    recompute), 1 dq and 1 dk/dv a layer. Returns the launches."""
    import math
    import torch
    from repro_torch import optim
    from repro_torch.optim.qstate import Adam8bitState, QMoment
    from repro_torch.utils import tree_bytes, tree_leaves
    cfg, params = mla_model(dev, MLA_TRAIN_LAYERS, 0, n_experts=0)
    n_params = sum(t.numel() for t in tree_leaves(params))
    opt = optim.adam_8bit(3e-4)
    state = opt.init(params)
    batch = mla_batch(cfg, MLA_PREFILL_S, dev)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    loss, grads = mla_value_and_grad(cfg, params, batch)
    updates, state = opt.update(grads, state, params)
    params = optim.apply_updates(params, updates)
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    adam = next(s for s in state if isinstance(s, Adam8bitState))
    moments = [m for m in tree_leaves(adam.mu) + tree_leaves(adam.nu)]
    int8 = all(m.dtype in (torch.int8, torch.float32) for m in moments) \
        and any(m.dtype == torch.int8 for m in moments)
    moment_bytes = tree_bytes((adam.mu, adam.nu))
    bf16 = "torch.bfloat16"
    want = {FLASH_FWD[bf16]: 2 * cfg.n_layers, FLASH_DQ[bf16]: cfg.n_layers,
            FLASH_DKV[bf16]: cfg.n_layers}
    exact = all(launches[k] == want.get(k, 0) for k in launches)
    finite = math.isfinite(float(loss)) and all(
        bool(torch.isfinite(t).all()) for t in tree_leaves(params))
    emit("lm_mla", part="train", config=cfg.name, layers=cfg.n_layers,
         n_experts=cfg.n_experts, dtype=str(cfg.dtype),
         tokens=[1, MLA_PREFILL_S], n_params=n_params,
         optimizer="adam_8bit(3e-4)", loss=float(loss), step_ms=wall * 1e3,
         peak_memory_bytes=peak, moments_int8=int8,
         moment_bytes=moment_bytes, qmoment_leaves=isinstance(
             adam.mu["embed"], QMoment), launches=launches,
         launches_exact=exact, finite=finite)
    if not (finite and exact and int8):
        raise AssertionError(f"lm_mla train: finite {finite}, int8 {int8}, "
                             f"launches {launches} (want {want})")
    return launches


def lm_mla_phase(dev, twins: dict) -> dict:
    """(i) the (192, 128) flash kernels against their plain versions;
    (ii) deepseek-v3 at its published widths, 2 layers: a 2,048-token
    prefill through the bf16 (192, 128) forward (one launch a layer and no
    other kernel), two runs bit for bit; (iii) the 16-request burst from
    the latent cache, the write_rows check; (iv) one adam_8bit step of a
    dense MLA layer (the bf16 (192, 128) dq and dk/dv); (v) the fp32
    twins (the fp32 (192, 128) kernels) against the CPU: the prefill's
    routing and logits, one step's loss, grad norm and gradients.
    Returns (each path's launches, the kernels' errors)."""
    import torch
    from repro_torch.utils import tree_leaves
    t_phase = time.perf_counter()
    out = {}
    bf16, f32 = "torch.bfloat16", "torch.float32"
    err = check_flash_at(dev, MLA_CHECKS, seed=27)

    cfg, params = mla_model(dev)
    n = sum(t.numel() for t in tree_leaves(params))
    emit("lm_mla", part="model", config=cfg.name, layers=cfg.n_layers,
         dense_layers=cfg.first_dense_layers, n_params=n,
         param_bytes=2 * n, dtype=str(cfg.dtype),
         cut="61 layers (first 3 dense) to 2 (first 1 dense); widths "
             "published")
    out["lm_mla_prefill"] = zoo_prefill(cfg, params, dev, "prefill",
                                        phase="lm_mla")
    pl = out["lm_mla_prefill"]
    if pl[FLASH_FWD[bf16]] != cfg.n_layers or sum(pl.values()) != \
            cfg.n_layers:
        raise AssertionError(f"deepseek prefill: launches {pl}, want "
                             f"{cfg.n_layers} of {FLASH_FWD[bf16]}")
    out["lm_mla_serve"] = mla_serve(cfg, params, dev)
    del params
    torch.cuda.empty_cache()
    out["lm_mla_train"] = mla_train(dev)
    torch.cuda.empty_cache()

    # (v) the fp32 twins.
    cut = {**MLA_TWIN_CUT, "dtype": "float32", "attn_chunk": MLA_TWIN_CHUNK,
           "tokens": MLA_TWIN_S,
           "kept": "qk_nope 128, qk_rope 64, v 128 (the (192, 128) pair)"}
    cpu = twins["mla:prefill"].result()
    tcfg, tparams = mla_twin_model(dev)
    reset_launches()
    got, routes = zoo_prefill_logits(tcfg, tparams, MLA_TWIN_S,
                                     rows=MLA_TWIN_ROWS)
    out["lm_mla_prefill_twin"] = launches = read_launches()
    agree = routing_agreement(routes, cpu["routes"])
    end = agree["first_differing_token"]
    rows = [i for i, r in enumerate(MLA_TWIN_ROWS) if end is None or r < end]
    d = float((got[rows] - cpu["logits"][rows]).abs().max())
    ok = not agree["unexplained"] and d <= LM_PREFILL_ATOL and \
        len(rows) >= len(MLA_TWIN_ROWS) // 2 and \
        launches[FLASH_FWD[f32]] == tcfg.n_layers and \
        sum(launches.values()) == tcfg.n_layers
    emit("lm_mla", part="prefill_twin", cut=cut, rows_compared=len(rows),
         routing=agree, launches=launches, max_abs_d_logits=d,
         max_abs_logit=float(cpu["logits"].abs().max()),
         atol=LM_PREFILL_ATOL, ok=ok)
    if not ok:
        raise AssertionError(f"lm_mla prefill twin: logits {d:.3g} from the "
                             f"CPU's, routing {agree}, launches {launches}")
    del tparams
    cpu = twins["mla:train"].result()
    reset_launches()
    run = mla_twin_train(dev)
    out["lm_mla_train_twin"] = launches = read_launches()
    rel = lambda a, b: abs(a - b) / abs(b)
    d_grads = {k: float((g - cpu["grads"][k]).abs().max()
                        / cpu["grads"][k].abs().max().clamp_min(1e-30))
               for k, g in run["grads"].items()}
    worst = max(d_grads, key=d_grads.get)
    want = {FLASH_FWD[f32]: 2 * tcfg.n_layers, FLASH_DQ[f32]: tcfg.n_layers,
            FLASH_DKV[f32]: tcfg.n_layers}
    ok = rel(run["loss"], cpu["loss"]) <= LM_TRAIN_LOSS_RTOL and \
        rel(run["grad_norm"], cpu["grad_norm"]) <= LM_TRAIN_GNORM_RTOL and \
        d_grads[worst] <= MLA_TWIN_GRAD_REL and \
        all(launches[k] == want.get(k, 0) for k in launches)
    emit("lm_mla", part="train_twin", cut=cut, loss=run["loss"],
         cpu_loss=cpu["loss"], grad_norm=run["grad_norm"],
         cpu_grad_norm=cpu["grad_norm"],
         loss_rel_d=rel(run["loss"], cpu["loss"]),
         grad_norm_rel_d=rel(run["grad_norm"], cpu["grad_norm"]),
         worst_grad=worst, worst_grad_rel_d=d_grads[worst],
         tolerances={"loss_rtol": LM_TRAIN_LOSS_RTOL,
                     "grad_norm_rtol": LM_TRAIN_GNORM_RTOL,
                     "grad_rel": MLA_TWIN_GRAD_REL},
         launches=launches, ok=ok)
    if not ok:
        raise AssertionError(f"lm_mla train twin off the CPU's: {run['loss']}"
                             f" vs {cpu['loss']}, {worst} {d_grads[worst]}")
    emit("lm_mla", part="seconds", seconds=time.perf_counter() - t_phase,
         budget_s=MLA_BUDGET_S)
    return out, err


# This slice's attention shapes, each checked (MM_CHECKS) and timed
# (MM_TIMES) at its path's size: seamless's encoder (MM_ENC_S², the
# forward) and cross-attention (MM_DEC_S × MM_ENC_S, once more with
# sk_true MM_CHECK_SKT) at B·H MM_CHECK_H heads of 64, rep 1, not causal;
# llava's prefill and step, causal at (128, 128) with its MM_LLAVA_HEADS
# query and KV heads over MM_PATCHES + MM_LLAVA_TEXT positions.
MM_LLAVA_S = MM_PATCHES + MM_LLAVA_TEXT
MM_TIMES = (
    FlashShape("enc4096", MM_ENC_S, MM_ENC_S, MM_CHECK_H, MM_CHECK_H, 64, 64,
               False, bwd=False),
    FlashShape("cross2048x4096", MM_DEC_S, MM_ENC_S, MM_CHECK_H, MM_CHECK_H,
               64, 64, False),
    FlashShape("llava4096", MM_LLAVA_S, MM_LLAVA_S, *MM_LLAVA_HEADS, 128, 128,
               True))
MM_CHECKS = MM_TIMES + (MM_TIMES[1]._replace(sk_true=MM_CHECK_SKT),)
MM_KERNELS = flash_names(MM_TIMES)


def mm_model(name: str, dev, layers: Optional[int] = None):
    """The published config in bf16 (depth cut to ``layers``), weights
    drawn on the card from seed 0."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config(name)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg, lm.init_params(torch.Generator(dev).manual_seed(0), cfg, dev)


def mm_twin_model(name: str, dev):
    """The twins' model: the published head dims with MM_TWIN_CUT at
    MM_TWIN_LAYERS, fp32, chunk MM_TWIN_CHUNK, weights drawn on the CPU
    from seed 1."""
    import torch
    return zoo_model(name, dev, MM_TWIN_LAYERS, torch.float32, seed=1,
                     attn_chunk=MM_TWIN_CHUNK, **MM_TWIN_CUT[name])


def mm_batch(cfg, B: int, n_prefix: int, S: int, dev, seed: int = 3
             ) -> dict:
    """Seeded tokens, labels and mask (B, S) and the prefix (B, n_prefix,
    D) in ``cfg.dtype``: frames for an encoder-decoder model, patches for
    a vision one; drawn with numpy, so that the card and the CPU get the
    same inputs."""
    import numpy as np
    import torch
    from repro_torch.data.synthetic import lm_token_batch
    rng = np.random.default_rng(seed)
    b = {k: torch.from_numpy(np.asarray(a)).to(dev)
         for k, a in lm_token_batch(rng, B, S, cfg.vocab).items()}
    key = "frames" if cfg.is_encoder_decoder else "patches"
    b[key] = torch.from_numpy(rng.normal(0, 1, (B, n_prefix, cfg.d_model))
                              .astype(np.float32)).to(dev, cfg.dtype)
    return b


def mm_flash_sites(cfg) -> int:
    """The attention calls a forward makes: encoder, decoder and cross
    layers of an encoder-decoder model, else one a layer."""
    if cfg.is_encoder_decoder:
        return cfg.n_enc_layers + 2 * cfg.n_layers
    return cfg.n_layers


def mm_twin(part: str) -> dict:
    """The CPU side of the lm_multimodal twins, ``<name>:prefill`` (the
    logits) or ``<name>:train`` (one step's loss, grad norm and
    gradients)."""
    import torch
    cpu = torch.device("cpu")
    name, kind = part.rsplit(":", 1)
    cfg, params = mm_twin_model(name, cpu)
    batch = mm_batch(cfg, 1, MM_TWIN_PREFIX[name], MM_TWIN_TEXT[name], cpu)
    if kind == "prefill":
        return {"logits": mm_prefill_logits(cfg, params, batch)}
    return twin_step(cfg, params, batch)


def mm_prefill_logits(cfg, params, batch):
    from repro_torch.models import lm
    return lm.prefill(params, cfg, batch)[0].float().cpu()


def mm_prefill(cfg, params, batch: dict, dev, part: str) -> dict:
    """:func:`zoo_prefill` of ``batch`` with exactly one bf16 flash
    forward an attention call and no other kernel. Returns its
    launches."""
    launches = zoo_prefill(cfg, params, dev, part, "lm_multimodal", batch)
    n = mm_flash_sites(cfg)
    if launches[FLASH_FWD["torch.bfloat16"]] != n or \
            sum(launches.values()) != n:
        raise AssertionError(f"lm_multimodal {part}: launches {launches}, "
                             f"want {n} of the bf16 flash forward")
    return launches


def mm_train(cfg, params, batch: dict, dev, part: str) -> dict:
    """One AdamW step (``optim.adamw(3e-4)``, fp32 moments) on ``batch``:
    the loss, ms, peak memory; exactly two bf16 flash forwards an
    attention call (the forward and its recompute under remat), one dq
    and one dk/dv. The updated parameters are dropped. Returns the
    launches."""
    import math
    import torch
    from repro_torch import optim
    from repro_torch.utils import tree_leaves
    n_params = sum(t.numel() for t in tree_leaves(params))
    opt = optim.adamw(3e-4)
    state = opt.init(params)
    _sync(dev)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    loss, grads = mla_value_and_grad(cfg, params, batch)
    updates, state = opt.update(grads, state, params)
    del grads
    new = optim.apply_updates(params, updates)
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    n = mm_flash_sites(cfg)
    bf16 = "torch.bfloat16"
    want = {FLASH_FWD[bf16]: 2 * n, FLASH_DQ[bf16]: n, FLASH_DKV[bf16]: n}
    exact = all(launches[k] == want.get(k, 0) for k in launches)
    finite = math.isfinite(float(loss)) and all(
        bool(torch.isfinite(t).all()) for t in tree_leaves(new))
    del updates, state, new
    torch.cuda.empty_cache()
    emit("lm_multimodal", part=part, config=cfg.name, layers=cfg.n_layers,
         enc_layers=cfg.n_enc_layers, dtype=str(cfg.dtype),
         tokens=list(batch["tokens"].shape), n_params=n_params,
         optimizer="adamw(3e-4), fp32 moments", loss=float(loss),
         step_ms=wall * 1e3, peak_memory_bytes=peak, launches=launches,
         launches_exact=exact, finite=finite)
    if not (finite and exact):
        raise AssertionError(f"lm_multimodal {part}: finite {finite}, "
                             f"launches {launches} (want {want})")
    return launches


def mm_fill_cross(cfg, params, frames, lens, T: int, dev) -> dict:
    """A decode cache of ``len(lens)`` rows over ``T`` positions whose
    cross K/V hold each row's encoder memory of its first ``lens[row]``
    frames (``lm.encode_cross_kv``, one encoder run a length); the
    positions past a row's length hold another row's K/V, which its
    ``enc_len`` must mask."""
    from repro_torch.models import lm
    caches = lm.init_cache(cfg, len(lens), T, dev, enc_len=max(lens))
    for n in sorted(set(lens), reverse=True):
        rows = [i for i, m in enumerate(lens) if m == n]
        k, v = lm.encode_cross_kv(params, cfg, frames[rows, :n])
        caches["cross_k"][:, rows, :n] = k
        caches["cross_v"][:, rows, :n] = v
        caches["enc_len"][rows] = n
        if n < max(lens):
            caches["cross_k"][:, rows, n:] = caches["cross_k"][:, :1, n:]
            caches["cross_v"][:, rows, n:] = caches["cross_v"][:, :1, n:]
    return caches


def mm_decode_against_forward(cfg, params, batch: dict, lens, dev) -> dict:
    """Teacher-force the batch's tokens through ``lm.decode_step`` from
    :func:`mm_fill_cross`'s cache, each step's logits against the
    forward of the row's frames (its first ``lens[row]``) and tokens:
    the largest difference and the greedy agreement of each row, the
    launches of the fill and ms a decode step."""
    import torch
    from repro_torch.models import lm
    toks, frames = batch["tokens"], batch["frames"]
    B, T = toks.shape
    reset_launches()
    t0 = time.perf_counter()
    caches = mm_fill_cross(cfg, params, frames, lens, T, dev)
    _sync(dev)
    fill_s = time.perf_counter() - t0
    fill_launches = read_launches()
    t0 = time.perf_counter()
    dec = torch.stack([lm.decode_step(params, cfg, caches,
                                      toks[:, t:t + 1], t)[0][:, 0]
                       for t in range(T)], 1)
    _sync(dev)
    step_ms = (time.perf_counter() - t0) * 1e3 / T
    full = torch.cat([lm.prefill(params, cfg, {"tokens": toks[i:i + 1],
                                               "frames": frames[i:i + 1, :n]})
                      for i, n in enumerate(lens)])
    d = (full.float() - dec.float()).abs().amax((1, 2))
    agree = (full.argmax(-1) == dec.argmax(-1)).float().mean(1)
    finite = bool(torch.isfinite(dec).all() and torch.isfinite(full).all())
    cache_bytes = sum(caches[n].numel() * caches[n].element_size()
                      for n in ("cross_k", "cross_v"))
    return {"rows": B, "tokens": T, "enc_lens": list(lens),
            "cross_cache_bytes": cache_bytes, "fill_s": fill_s,
            "fill_launches": fill_launches, "ms_a_decode_step": step_ms,
            "max_abs_d_logits_by_row": d.tolist(),
            "greedy_agreement_by_row": agree.tolist(), "finite": finite}


def mm_serve(cfg, params, dev) -> dict:
    """The burst's first MM_REQUESTS prompts, MM_MAX_NEW new tokens each,
    text-only through an 8-slot engine at MM_MAX_LEN (after a warm-up
    engine's two requests), its decode one CUDA graph a call: ms a decode
    call, tokens/s, the cache's bytes. Returns the burst's launches."""
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.utils import tree_bytes
    prompts = lm_prompts(cfg.vocab)[:MM_REQUESTS]

    def engine():
        return ServeEngine(cfg, ServeConfig(
            batch_slots=LM_SLOTS, max_len=MM_MAX_LEN, eos_token=-1,
            torch_device=dev), params)
    warm = engine()
    for p in prompts[:2]:
        warm.submit(p, 4)
    warm.run_until_drained()
    del warm
    eng = engine()
    reset_launches()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, MM_MAX_NEW) for p in prompts]
    eng.run_until_drained()
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = read_launches()
    stats = eng.request_stats()
    served = all(r.done and len(r.tokens) == MM_MAX_NEW for r in reqs)
    emit("lm_multimodal", part="llava_serve", config=cfg.name,
         layers=cfg.n_layers, dtype=str(cfg.dtype),
         kv_cache_dtype=cfg.kv_cache_dtype, slots=LM_SLOTS,
         max_len=MM_MAX_LEN, requests=stats["requests"], max_new=MM_MAX_NEW,
         prompt_tokens=sum(len(p) for p in prompts), wall_s=wall,
         ms_a_decode_call=wall * 1e3 / stats["decode_calls"],
         decode_calls=stats["decode_calls"], steps_run=stats["steps_run"],
         tokens_per_s=stats["tokens_per_s"], latency_ms=stats["latency_ms"],
         cache_bytes=tree_bytes(eng.caches), graph=eng._graph is not None,
         launches=launches, all_served=served)
    if not served or (dev.type == "cuda" and eng._graph is None):
        raise AssertionError(f"lm_multimodal llava serve: served {served}, "
                             f"graph {eng._graph is not None}")
    return launches


def mm_twins(dev, twins: dict, out: dict) -> None:
    """(iv) the fp32 twins against the CPU's: each model's prefill
    logits, one step's loss, grad norm and gradients; then seamless's
    decode from its encoder's cross cache against its forward."""
    import torch
    f32 = "torch.float32"
    for name in (MM_SEAMLESS, MM_LLAVA):
        short = name.split("-")[0]
        cfg, params = mm_twin_model(name, dev)
        batch = mm_batch(cfg, 1, MM_TWIN_PREFIX[name], MM_TWIN_TEXT[name],
                         dev)
        n = mm_flash_sites(cfg)
        cut = {**MM_TWIN_CUT[name], "n_layers": MM_TWIN_LAYERS,
               "dtype": "float32",
               "attn_chunk": MM_TWIN_CHUNK,
               "prefix": MM_TWIN_PREFIX[name], "tokens": MM_TWIN_TEXT[name],
               "kept": f"head_dim {cfg.hd()}, heads {cfg.n_heads} over "
                       f"{cfg.n_kv_heads} (cut from the published count)"}
        cpu = twins[f"mm:{name}:prefill"].result()
        reset_launches()
        got = mm_prefill_logits(cfg, params, batch)
        out[f"lm_mm_{short}_prefill_twin"] = launches = read_launches()
        d = float((got - cpu["logits"]).abs().max())
        ok = d <= LM_PREFILL_ATOL and launches[FLASH_FWD[f32]] == n and \
            sum(launches.values()) == n
        emit("lm_multimodal", part=f"{short}_prefill_twin", cut=cut,
             launches=launches, max_abs_d_logits=d,
             max_abs_logit=float(cpu["logits"].abs().max()),
             atol=LM_PREFILL_ATOL, ok=ok)
        if not ok:
            raise AssertionError(f"lm_multimodal {short} prefill twin: "
                                 f"logits {d:.3g} from the CPU's, launches "
                                 f"{launches}")
        cpu = twins[f"mm:{name}:train"].result()
        reset_launches()
        run = twin_step(cfg, params, batch)
        out[f"lm_mm_{short}_train_twin"] = launches = read_launches()
        rel = lambda a, b: abs(a - b) / abs(b)
        d_grads = {k: float((g - cpu["grads"][k]).abs().max()
                            / cpu["grads"][k].abs().max().clamp_min(1e-30))
                   for k, g in run["grads"].items()}
        worst = max(d_grads, key=d_grads.get)
        want = {FLASH_FWD[f32]: 2 * n, FLASH_DQ[f32]: n, FLASH_DKV[f32]: n}
        ok = rel(run["loss"], cpu["loss"]) <= LM_TRAIN_LOSS_RTOL and \
            rel(run["grad_norm"], cpu["grad_norm"]) <= LM_TRAIN_GNORM_RTOL \
            and d_grads[worst] <= MLA_TWIN_GRAD_REL and \
            all(launches[k] == want.get(k, 0) for k in launches)
        emit("lm_multimodal", part=f"{short}_train_twin", cut=cut,
             loss=run["loss"], cpu_loss=cpu["loss"],
             grad_norm=run["grad_norm"], cpu_grad_norm=cpu["grad_norm"],
             loss_rel_d=rel(run["loss"], cpu["loss"]),
             grad_norm_rel_d=rel(run["grad_norm"], cpu["grad_norm"]),
             worst_grad=worst, worst_grad_rel_d=d_grads[worst],
             tolerances={"loss_rtol": LM_TRAIN_LOSS_RTOL,
                         "grad_norm_rtol": LM_TRAIN_GNORM_RTOL,
                         "grad_rel": MLA_TWIN_GRAD_REL},
             launches=launches, ok=ok)
        if not ok:
            raise AssertionError(f"lm_multimodal {short} train twin off the "
                                 f"CPU's: {run['loss']} vs {cpu['loss']}, "
                                 f"{worst} {d_grads[worst]}")
        if cfg.is_encoder_decoder:
            n_f = MM_TWIN_PREFIX[name]
            dec = mm_batch(cfg, 2, n_f, MM_TWIN_DECODE_T, dev, seed=4)
            r = mm_decode_against_forward(cfg, params, dec,
                                          (n_f, n_f * 2 // 3), dev)
            ok = r["finite"] and max(r["max_abs_d_logits_by_row"]) <= \
                MM_DECODE_ATOL
            emit("lm_multimodal", part="seamless_decode_twin", cut=cut, **r,
                 atol=MM_DECODE_ATOL, ok=ok)
            if not ok:
                raise AssertionError(f"lm_multimodal seamless decode twin: "
                                     f"{r['max_abs_d_logits_by_row']}")
        del params
        torch.cuda.empty_cache()


def lm_multimodal_phase(dev, twins: dict) -> tuple:
    """(i) the flash kernels at this slice's shapes against their plain
    versions; (ii) seamless-m4t-medium whole: a 4,096-frame, 2,048-token
    prefill (36 bf16 flash forwards), one AdamW step on it, a decode from
    an 8-row cross cache of two memory lengths against each row's
    forward; (iii) llava-next-34b at its published widths, 4 layers: a
    2,880-patch + 1,216-token prefill (4 flash forwards), the engine
    serving 16 text requests, one AdamW step at 2 layers; (iv) the fp32
    twins against the CPU. Returns (each path's launches, the kernels' errors)."""
    import torch
    from repro_torch.utils import tree_leaves
    t_phase = time.perf_counter()
    out = {}
    err = check_flash_at(dev, MM_CHECKS, seed=28)

    cfg, params = mm_model(MM_SEAMLESS, dev)
    n = sum(t.numel() for t in tree_leaves(params))
    emit("lm_multimodal", part="seamless_model", config=cfg.name,
         layers=cfg.n_layers, enc_layers=cfg.n_enc_layers, n_params=n,
         param_bytes=2 * n, dtype=str(cfg.dtype),
         cut=f"none; the decoder's tokens cut to {MM_DEC_S} of train_4k's "
             f"{MM_ENC_S} so that the cross-attention runs at Sq != Sk")
    batch = mm_batch(cfg, 1, MM_ENC_S, MM_DEC_S, dev)
    out["lm_mm_seamless_prefill"] = mm_prefill(cfg, params, batch, dev,
                                               "seamless_prefill")
    out["lm_mm_seamless_train"] = mm_train(cfg, params, batch, dev,
                                           "seamless_train")
    del batch
    lens = [MM_ENC_LENS[i * len(MM_ENC_LENS) // MM_DEC_ROWS]
            for i in range(MM_DEC_ROWS)]
    r = mm_decode_against_forward(
        cfg, params, mm_batch(cfg, MM_DEC_ROWS, MM_ENC_S, MM_DECODE_T, dev,
                              seed=5), lens, dev)
    out["lm_mm_seamless_cross_fill"] = r["fill_launches"]
    emit("lm_multimodal", part="seamless_decode", config=cfg.name, **r)
    if not r["finite"]:
        raise AssertionError("lm_multimodal seamless decode: not finite")
    del params
    torch.cuda.empty_cache()

    cfg, params = mm_model(MM_LLAVA, dev, MM_LLAVA_LAYERS)
    n = sum(t.numel() for t in tree_leaves(params))
    emit("lm_multimodal", part="llava_model", config=cfg.name,
         layers=cfg.n_layers, n_params=n, param_bytes=2 * n,
         dtype=str(cfg.dtype),
         cut=f"60 layers to {MM_LLAVA_LAYERS}; widths published")
    batch = mm_batch(cfg, 1, MM_PATCHES, MM_LLAVA_TEXT, dev)
    out["lm_mm_llava_prefill"] = mm_prefill(cfg, params, batch, dev,
                                            "llava_prefill")
    out["lm_mm_llava_serve"] = mm_serve(cfg, params, dev)
    del params
    torch.cuda.empty_cache()
    cfg, params = mm_model(MM_LLAVA, dev, MM_LLAVA_TRAIN_LAYERS)
    out["lm_mm_llava_train"] = mm_train(cfg, params, batch, dev,
                                        "llava_train")
    del params, batch
    torch.cuda.empty_cache()

    mm_twins(dev, twins, out)
    emit("lm_multimodal", part="seconds",
         seconds=time.perf_counter() - t_phase, budget_s=MM_BUDGET_S)
    return out, err


# ---------------------------------------------------------------------------
# Phase distributed: the sharded paths at world size 1 (slice 13)
# ---------------------------------------------------------------------------

# The distributed phase: a world-size-1 NCCL group (a FileStore, no port)
# and a (1, 1) mesh over ("data", "model") on the card. granite (its
# published config, 32 layers), mamba2 (published, 48 layers) and
# deepseek-v3 (published widths, MLA_LAYERS with MLA_DENSE dense: one
# MoE layer) each prefill one seeded 1 × ZOO_PREFILL_S prompt in bf16
# with their parameters placed by param_specs under a ShardingContext
# (DIST_MODES) and with no context; the logits must be equal (bit for
# bit is printed; past that, within LM_PREFILL_ATOL). At one rank EP is
# the global dispatch, so one MoE layer's output on its own input is
# held bit for bit. Each prefill is timed DIST_TIMED_RUNS times both ways,
# alternately (the median printed), then traced once both ways (the
# device's busy time). The phase aims to stay within DIST_BUDGET_S
# (printed, not asserted).
DIST_MODES = {ZOO_GRANITE: ("ulysses", "ep"), ZOO_MAMBA2: ("ulysses",
                                                           "global"),
              MLA: ("ulysses", "ep")}
DIST_BUDGET_S, DIST_TIMED_RUNS = 40, 3


def dist_prefill(cfg, params, ctx, dev, part: str) -> dict:
    """``cfg``'s prefill of one seeded prompt with no context and, with
    the parameters placed by ``param_specs`` (small banks replicated
    under EP), under ``ctx``: each run once to warm up, then timed
    ``DIST_TIMED_RUNS`` times alternately (each sharded run's launches
    and collectives counted), then traced once; the logits finite, of the
    prompt's shape, and equal. Returns the last sharded run's
    launches."""
    import numpy as np
    import torch
    from repro_torch.distributed import param_specs, sharding_scope
    from repro_torch.distributed.context import (collectives,
                                                 reset_collectives)
    from repro_torch.distributed.sharding import place
    from repro_torch.models import lm
    batch = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, ZOO_PREFILL_S))).to(dev)}
    placed = place(params, param_specs(
        cfg, params, ctx.mesh, replicate_small_banks=ctx.moe_mode == "ep"),
        ctx.mesh)

    def plain():
        out = lm.prefill(params, cfg, batch)
        _sync(dev)
        return out

    def sharded():
        with sharding_scope(ctx):
            out = lm.prefill(placed, cfg, batch)
        _sync(dev)
        return out

    want, got = plain(), sharded()
    plain_runs, runs = [], []
    for _ in range(DIST_TIMED_RUNS):       # alternately, on one card
        t0 = time.perf_counter()
        want = plain()
        plain_runs.append((time.perf_counter() - t0) * 1e3)
        reset_launches()
        reset_collectives()
        t0 = time.perf_counter()
        got = sharded()
        runs.append((time.perf_counter() - t0) * 1e3)
        launches, coll = read_launches(), dict(collectives)
    ms, plain_ms = float(np.median(runs)), float(np.median(plain_runs))
    # Each traced once: the device's busy time both ways says whether the
    # context's extra time is work on the card or on the host.
    traced = {"sharded": busy_share(sharded, ms / 1e3),
              "plain": busy_share(plain, plain_ms / 1e3)}
    got = got.full_tensor()
    bitwise = bool(torch.equal(got, want))
    d = float((got.float() - want.float()).abs().max())
    finite = bool(torch.isfinite(got).all()) and \
        tuple(got.shape) == (1, ZOO_PREFILL_S, cfg.vocab)
    attn_layers = 0 if cfg.layer_pattern == "ssm" else cfg.n_layers
    emit("distributed", part=part, config=cfg.name, layers=cfg.n_layers,
         dtype=str(cfg.dtype), tokens=[1, ZOO_PREFILL_S],
         attn_mode=ctx.attn_mode, moe_mode=ctx.moe_mode,
         sharded_ms=ms, plain_ms=plain_ms, sharded_ms_runs=runs,
         plain_ms_runs=plain_runs, context_ms=ms - plain_ms,
         device_busy_ms={k: v["device_busy_s"] * 1e3
                         for k, v in traced.items()},
         busy_share={k: v["busy_share_of_untraced_wall"]
                     for k, v in traced.items()},
         top_kernels={k: v["top_kernels"] for k, v in traced.items()},
         launches=launches, collectives=coll, logits_bitwise_equal=bitwise,
         max_abs_d_logits=d, atol=LM_PREFILL_ATOL, finite=finite,
         nvidia_smi=nvidia_smi())
    fwd = launches[FLASH_FWD["torch.bfloat16"]]
    if not finite or (not bitwise and d > LM_PREFILL_ATOL) or \
            fwd != attn_layers or sum(launches.values()) != attn_layers:
        raise AssertionError(
            f"distributed {part}: finite {finite}, logits {d:.3g} from the "
            f"plain prefill's, launches {launches} (want {attn_layers} "
            f"bf16 flash forwards and nothing else)")
    return launches


def dist_moe_layer(cfg, params, ctx, dev, part: str) -> None:
    """The first MoE layer's FFN on a seeded bf16 input, with no context
    and under ``ctx`` (EP, the banks placed by ``param_specs``): bit for
    bit equal, two all-to-alls issued."""
    import torch
    from repro_torch.distributed import param_specs, sharding_scope
    from repro_torch.distributed.context import (collectives,
                                                 reset_collectives)
    from repro_torch.distributed.sharding import place
    from repro_torch.models import moe
    from repro_torch.models.blocks import layer_slice
    ffn = layer_slice(params["layers"], 0)["ffn"]
    x = torch.randn((1, ZOO_PREFILL_S, cfg.d_model),
                    generator=torch.Generator(dev).manual_seed(2),
                    device=dev, dtype=cfg.dtype)
    want = moe.moe_ffn(ffn, cfg, x)
    specs = param_specs(cfg, {"ffn": ffn}, ctx.mesh,
                        replicate_small_banks=True)["ffn"]
    reset_collectives()
    with sharding_scope(ctx):
        got = moe.moe_ffn(place(ffn, specs, ctx.mesh), cfg,
                          place(x, ctx.spec("btd"), ctx.mesh)).full_tensor()
    _sync(dev)
    coll = dict(collectives)
    same = bool(torch.equal(got, want))
    emit("distributed", part=part, config=cfg.name, tokens=[1, ZOO_PREFILL_S],
         experts=cfg.n_experts, top_k=cfg.top_k, collectives=coll,
         ep_equals_global_bitwise=same)
    if not same or coll["all_to_all"] != 2:
        raise AssertionError(f"distributed {part}: EP bitwise {same}, "
                             f"collectives {coll}")


def dist_restore(mesh, dev) -> None:
    """A checkpoint of a small tree (bf16 and fp32 leaves) restored onto
    the mesh as DTensors, bit for bit."""
    import tempfile
    import torch
    from repro_torch.distributed.sharding import P
    from repro_torch.train.checkpoint import CheckpointManager
    g = torch.Generator().manual_seed(3)
    tree = {"w": torch.randn((64, 32), generator=g).to(torch.bfloat16),
            "opt": {"mu": torch.randn((64, 32), generator=g)}}
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d)
        ck.save(1, tree)
        _, got, _ = ck.restore(shardings={
            "w": (mesh, P("data", None)), "opt": {"mu": (mesh, P(None,
                                                                "model"))}})
    ok = {k: bool(torch.equal(a.full_tensor().cpu(), b)
                  and a.device.type == mesh.device_type)
          for k, a, b in (("w", got["w"], tree["w"]),
                          ("opt/mu", got["opt"]["mu"], tree["opt"]["mu"]))}
    emit("distributed", part="elastic_restore", mesh=list(mesh.mesh.shape),
         placements={"w": repr(got["w"].placements)}, bitwise=ok)
    if not all(ok.values()):
        raise AssertionError(f"distributed restore: {ok}")


def distributed_phase(dev) -> dict:
    """The sharded paths on a (1, 1) mesh of one NCCL rank: granite's,
    mamba2's and deepseek's prefills under a sharding context (Ulysses
    attention and SSD, EP MoE) against the prefills with no context, a
    MoE layer's EP output bit for bit against the global one, and an
    elastic restore. Returns each path's launches."""
    import os
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import ShardingContext
    from repro_torch.launch.mesh import make_host_mesh
    t_phase = time.perf_counter()
    out = {}
    torch.cuda.set_device(dev)
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(d, "store"), 1), rank=0, world_size=1,
            device_id=dev)
        try:
            mesh = make_host_mesh(1)
            for name, build in ((ZOO_GRANITE, lambda: zoo_model(
                    ZOO_GRANITE, dev)), (ZOO_MAMBA2, lambda: zoo_model(
                    ZOO_MAMBA2, dev)), (MLA, lambda: mla_model(dev))):
                attn_mode, moe_mode = DIST_MODES[name]
                ctx = ShardingContext(mesh=mesh, attn_mode=attn_mode,
                                      moe_mode=moe_mode)
                cfg, params = build()
                part = name.split("-")[0]
                out[f"distributed_{part}_prefill"] = dist_prefill(
                    cfg, params, ctx, dev, f"{part}_prefill")
                if cfg.n_experts:
                    dist_moe_layer(cfg, params, ctx, dev, f"{part}_moe_layer")
                del params
                torch.cuda.empty_cache()
            dist_restore(mesh, dev)
        finally:
            dist.destroy_process_group()
    emit("distributed", part="seconds", seconds=time.perf_counter() - t_phase,
         budget_s=DIST_BUDGET_S, nvidia_smi=nvidia_smi())
    return out


def require_no_local_memory(libs: dict) -> None:
    """Fail if nvcc gave a tensor-core flash kernel (the forward, dq or
    dk/dv: every library named ``*_sm90``), the ideal scan, the readout
    or k-WTA a stack frame. wgmma reads its register operands after the
    instruction issues; a value the compiler keeps in local memory is
    loaded into a scratch register that it may reuse while the tensor
    cores still read it, which makes results change from run to run (seen
    on the card with a 128-byte frame). The scan keeps U's column in
    registers, k-WTA its rows, the readout its chains' operands in shared
    memory: a spill would put local memory back on each chain."""
    frames = {n: [ln.strip() for ln in p.with_suffix(".log").read_text()
                  .splitlines() if "bytes stack frame" in ln
                  and not ln.strip().startswith("0 bytes stack frame")]
              for n, p in libs.items()
              if n.endswith("_sm90")
              or n in ("miru_scan", "miru_readout", "kwta")}
    if any(frames.values()):
        raise AssertionError(f"kernels use local memory: {frames}")


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
        adam = train_adam(dev, twins, cl["ideal"])
        grad_contract(dev)
        rag = train_ragged(dev, twins)
        la = train_loss_aware(dev, twins)
        sc = scenarios_phase(dev, smi, twins)
        obs_phase(dev, smi, run)
        ft = faults_phase(dev, smi, twins)
        flt = fleet_phase(dev, smi, twins)
        zoo = lm_zoo_phase(dev, twins)
        lmq = lm_quant_phase(dev, twins)
        mla, mla_err = lm_mla_phase(dev, twins)
        mm, mm_err = lm_multimodal_phase(dev, twins)
        dst = distributed_phase(dev)
        kw = kwta_path(dev)
        t = times(dev)
        t.update(flash_times(dev, MLA_TIMES, seed=28))
        t.update(flash_times(dev, MM_TIMES, seed=29))
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
               "table1_cmos": t1["cmos"], **lmr, **lmt,
               "train_adam_ideal": adam["ideal"]["launches"],
               "train_adam_wbs": adam["wbs"]["launches"],
               "train_ragged": rag["launches"],
               "train_loss_aware": la["launches"], "ops_kwta": kw,
               **{f"scenarios_{b}": c for b, c in sc.items()}, **ft, **flt,
               **zoo, **lmq, **mla, **mm, **dst}
    own = {"wbs_matmul": "serve", "wbs_matmul_read_noise": "train_read_noise",
           "wbs_miru_scan": "serve", "miru_scan": "train_software",
           "miru_readout": "serve",
           "flash_attention_fwd_f32_sm90": "lm_prefill_twin",
           "flash_attention_bwd_dq": "lm_train_fp32",
           "flash_attention_bwd_dkv": "lm_train_fp32", "kwta": "ops_kwta",
           "flash_attention_fwd_sm90": "lm_prefill",
           "flash_attention_bwd_dkv_sm90": "lm_train",
           "flash_attention_bwd_dq_sm90": "lm_train"}
    src = "src/repro_torch/kernels/csrc/"
    lib = {"flash_attention_fwd_f32_sm90": "flash_attention_fwd_f32_sm90",
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
                "miru_readout": "h @ w_o in src/repro/core/miru.py:139 (not "
                                "a TPU kernel; repair of queue C)",
                "flash_attention_fwd_f32_sm90": "src/repro/kernels/"
                                                "flash_attention.py:227 "
                                                "(pallas_call :270), fp32",
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
    # The slices' shapes: each name's launches in the path that runs its
    # shape (a prefill for the bf16 forward, a train step for the bf16 dq
    # and dk/dv, the fp32 twins for the fp32 ones): the lm_mla paths for
    # (192, 128), which run that pair alone; for lm_multimodal, llava's
    # paths for its (128, 128) shape and seamless's for the (64, 64) ones
    # (a path's count is every launch of the kernel there: the encoder's,
    # the decoder's and the cross-attention's).
    path_of = {"flash_attention_fwd_sm90": "prefill",
               "flash_attention_bwd_dq_sm90": "train",
               "flash_attention_bwd_dkv_sm90": "train",
               "flash_attention_fwd_f32_sm90": "prefill_twin",
               "flash_attention_bwd_dq": "train_twin",
               "flash_attention_bwd_dkv": "train_twin"}
    where = {"192x128": ", (dh, dv) = (192, 128)",
             "enc4096": ", not causal, Sq = Sk = 4,096 (the encoder)",
             "cross2048x4096": ", not causal, Sq 2,048 against Sk 4,096 "
                               "(the cross-attention)",
             "llava4096": ", (dh, dv) = (128, 128), causal, GQA 56/8, "
                          "Sq = Sk = 4,096 (llava's patches and text)"}
    err.update(mla_err)
    err.update(mm_err)
    for m, k in {**MLA_KERNELS, **MM_KERNELS}.items():
        tag = m.split("@")[1]
        model = "mla" if tag == "192x128" else "mm_llava" \
            if tag == "llava4096" else "mm_seamless"
        source[m], own[m] = source[k], f"lm_{model}_{path_of[k]}"
        replaces[m] = replaces[k] + where[tag]
    alias = {**MLA_KERNELS, **MM_KERNELS}
    count = lambda k, c: c[alias.get(k, k)]
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": source[k],
         "replaces": replaces[k], "launches": count(k, by_path[own[k]]),
         "launches_by_path": {p: count(k, c) for p, c in by_path.items()
                              if k in KERNELS or p in (
                                  mla if k in MLA_KERNELS else mm)},
         "max_abs_err": err[k], "ms": t[k]["ms"], "plain_ms": t[k]["plain_ms"],
         "bound_ms": t[k]["bound_ms"], "bound_by": t[k]["bound_by"],
         "library_ms": t[k]["library_ms"], "library": t[k]["library"],
         **{f: t[k][f] for f in ("bound_split_ms", "bound_cuda_cores_ms",
                                 "note", "lm_shapes") if f in t[k]}}
        for k in (*KERNELS, *MLA_KERNELS, *MM_KERNELS)]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
