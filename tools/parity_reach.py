#!/usr/bin/env python3
"""How far the training checks of ``chip_smoke.py`` reach: card-vs-CPU
distances of sound runs beside those of runs with a fault planted on the
card side.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 tools/parity_reach.py [--out FILE]

``chip_smoke.py`` holds each training path on the card against the port's
own CPU run of the same work: train (a) by its losses, final params and
test accuracy, train (b) by its leading losses (``LOSS_AGREE_STEPS``)
and the R matrix (``R_TOLERANCE``). A check is worth only as much as the
gap between the distances it allows and those a wrong card path
produces. This script prints, one JSON line per run:

- ``loss_agree_steps``: how many leading steps' losses agree with the
  sound CPU run at ``chip_smoke.LOSS_RTOL`` / ``LOSS_ATOL`` (rtol 1e-4,
  atol 1e-5);
- train (a): test accuracy and the final params' largest difference;
- train (b): R, MA, the largest R difference in test examples and the MA
  difference, and whether ``R_TOLERANCE`` would pass it.

Sound runs: the card, and the CPU at its default thread count and at 2
threads (another summation order in the CPU's BLAS). Planted faults,
each made in this process without touching the package's files:

- train (a) ``stale_h_prev``: the forward hands DFA h_t where h_{t-1}
  belongs (the shift of ``miru_forward`` dropped);
- train (b) on ``wbs``: ``clip_off`` (no weight clip: ``weight_clip``
  None), ``adc_off`` (the ADC skipped: ``adc_bits`` None), ``input_7bit``
  (the drive quantized to 7 bits instead of 8), ``u_writes_lost`` (the
  recurrent matrix's writes never land);
- train (c) on ``analog``: ``write_noise_off`` (``write_sigma`` 0),
  ``gain_noise_off`` (``gain_sigma`` 0), ``adc_off``,
  ``u_writes_lost``;
- train (d), ``analog`` with read noise (held, as in ``chip_smoke.py``,
  against a CPU run of its first epoch): ``read_noise_off`` (σ = 0) and
  ``read_sigma_0.05`` (half the noise);
- ``lm``, the LM phase's 2-layer fp32 twins of qwen2-0.5B: the prefill
  twin's largest logit difference for the card, the CPU at 2 threads and
  the card with the flash call's ``causal_off``, ``gqa_shift`` (each
  query head reading the next KV head) or ``sk_true_ignored`` (the
  padded keys unmasked), beside ``LM_PREFILL_ATOL``; the serve twin's
  first logits and tokens for the card, the CPU at 2 threads and the
  card with ``cache_writes_all_rows`` (the reference's cache write);
- ``lm_train``, the LM phase's training twin (3 Trainer steps of the
  2-layer fp32 model on 1,100 tokens): the largest relative loss and
  grad-norm differences and the final params' distance over the CPU
  update's norm, for the card, the CPU at 2 threads and the card with a
  fault in the flash backward's call: ``dq_scale_dropped`` (dq not
  multiplied by dh^-0.5), ``causal_off`` (the backward without the
  causal mask), ``delta_omitted`` (delta = 0: out handed over as zeros)
  or ``dkv_head_shift`` (dk/dv landing on the next KV head), beside
  ``LM_TRAIN_LOSS_RTOL``, ``LM_TRAIN_GNORM_RTOL`` and
  ``LM_TRAIN_PARAMS_REL``; then the tensor-core kernels (the bf16
  route's flash forward, dq and dk/dv, which the fp32 twin does not run,
  and the fp32 route's dq and dk/dv): whether each of ``chip_smoke.py``'s
  flash checks (``check_lm_kernels``, ``check_flash_bwd``) passes, sound
  and with a fault planted in the kernels at build time
  (``csrc/flash_sm90.cuh``'s ``FLASH_SM90_FAULT``, variants of the
  libraries under names of their own, which this process loads in place
  of the package's builds):
  ``split_first_term_only`` (p, ds, pᵀ and dsᵀ rounded to bf16 alone in
  all three kernels), ``fold_order_per_call`` (dk/dv's fold of the rep
  partials starting at another query head on each call, as float atomics
  would), ``causal_start_late`` (dk/dv's causal query loop starting one
  tile past the diagonal), ``dq_first_term_only`` (the dq kernel's ds on
  its first bf16 term alone), ``dq_causal_loop_short`` (dq's causal key
  loop one tile short of the diagonal), ``f32_dq_qk_first_term_only``,
  ``f32_dkv_qk_first_term_only`` or ``f32_fwd_qk_first_term_only`` (the
  fp32 dq's, dk/dv's or forward's q·kᵀ on the first bf16 terms of q and k
  alone);
- ``scan``, the fused WBS scan: whether ``chip_smoke.check_scan`` (the
  kernel bit for bit against its plain version at every shape it checks)
  and the fused-equals-per-step contract pass, sound and with
  ``slab_planes_joined_lsb_first`` planted at build time
  (``csrc/wbs_miru_scan.cu``'s ``WBS_SCAN_FAULT``: the second block of
  each cluster joins its columns' plane sums LSB first);
- ``miru_scan``, the ideal scan: whether ``chip_smoke.check_miru_scan``
  (the kernel bit for bit against its plain version) passes, sound and
  with ``chain_drops_last_k`` planted at build time
  (``csrc/miru_scan.cu``'s ``MIRU_SCAN_FAULT``: the second block's sums
  leave out the last input);
- ``read_noise`` also runs the read-noise product's check
  (``chip_smoke.check_read_noise``: bitwise against its plain version,
  σ = 0 equal to the plain kernel, identical rows, the moments), sound
  and with ``draw_counter_off_by_one`` planted at build time
  (``csrc/wbs_matmul.cu``'s ``READ_NOISE_FAULT``: the second block of
  the draw pass draws at counter k·N + n + 1);
- ``readout``: whether ``chip_smoke.check_kernels`` (the readout bit
  for bit against its plain version and row-exact at every shape it
  checks, then the other kernels) passes, sound and with
  ``late_blocks_sum_k_descending`` planted at build time
  (``csrc/miru_readout.cu``'s ``READOUT_FAULT``: every block past the
  first sums each tile's k descending);
- ``kwta``: whether ``chip_smoke.check_lm_kernels`` (k-WTA bit for bit
  against its plain version on each path, after the flash forward's
  checks) passes, sound and with ``lane_31_left_out_of_counts`` planted
  at build time (``csrc/kwta.cu``'s ``KWTA_FAULT``: in every block past
  the first, lane 31 of each warp leaves its values out of the
  bisection's counts).

``--paths`` picks some of ``software ideal wbs analog read_noise lm
lm_train scan miru_scan readout kwta`` (all by default). It exits 1
unless the sound builds pass the kernel checks and every planted kernel
fault fails one.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

_OUT = None
PATHS = ("software", "ideal", "wbs", "analog", "read_noise", "lm",
         "lm_train", "scan", "miru_scan", "readout", "kwta")


def emit(**row) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    if _OUT:
        with open(_OUT, "a") as f:
            f.write(line + "\n")


@contextlib.contextmanager
def threads(n: int):
    import torch
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


@contextlib.contextmanager
def stale_h_prev():
    """DFA sees h_t in place of h_{t-1}."""
    from repro_torch.core import dfa
    orig = dfa.miru_forward

    def forward(*args, **kwargs):
        logits, inter = orig(*args, **kwargs)
        return logits, dict(inter, h_prev=inter["h_all"])
    dfa.miru_forward = forward
    try:
        yield
    finally:
        dfa.miru_forward = orig


def lost_u_writes(name: str = "wbs"):
    """A ``name`` backend whose writes to u_h never land."""
    import torch
    from repro_torch.backends import get_backend
    be = get_backend(name)
    orig = be.apply_update

    def apply_update(params, updates, key=None):
        updates = dict(updates, u_h=torch.zeros_like(updates["u_h"]))
        return orig(params, updates, key)
    be.apply_update = apply_update
    return be


def software(dev, cpu) -> None:
    import numpy as np
    import torch

    def row(name, run):
        d = max(float((run["params"][k].cpu() - cpu["params"][k]).abs()
                      .max()) for k in cpu["params"])
        emit(path="train_software", run=name,
             loss_agree_steps=cs.loss_agree_steps(run["losses"],
                                                  cpu["losses"]),
             steps=len(cpu["losses"]), test_acc=run["acc"],
             cpu_test_acc=cpu["acc"],
             d_test_examples=round(abs(run["acc"] - cpu["acc"])
                                   * cs.SW_TEST),
             max_abs_d_params=d,
             max_rel_d_loss=float(np.max(
                 np.abs(run["losses"] - cpu["losses"])
                 / np.abs(cpu["losses"]))))
    row("card", cs.software_run(dev))
    with threads(2):
        row("cpu_2_threads", cs.software_run(torch.device("cpu")))
    with stale_h_prev():
        row("card_stale_h_prev", cs.software_run(dev))


def analog_spec(**crossbar):
    """``analog``'s default spec with some crossbar fields replaced."""
    import dataclasses
    from repro_torch.backends.analog import AnalogBackend
    spec = AnalogBackend.default_spec()
    return {"crossbar": dataclasses.replace(spec.crossbar, **crossbar)}


def read_noise(dev) -> None:
    """Train (d): the card's read-noise run against the CPU's first
    epoch, beside planted faults."""
    import torch
    from repro_torch.backends import get_backend
    cpu = cs.protocol_run(torch.device("cpu"), cs.read_noise_backend(),
                          n_tasks=1, epochs=cs.RN_CPU_EPOCHS)
    sigma = lambda s: get_backend("analog", spec_overrides=analog_spec(
        read_sigma=s, w_clip=cs.W_SCALE))
    runs = {"card": lambda: cs.protocol_run(dev, cs.read_noise_backend(),
                                            n_tasks=1),
            "card_read_noise_off": lambda: cs.protocol_run(
                dev, sigma(0.0), n_tasks=1),
            "card_read_sigma_0.05": lambda: cs.protocol_run(
                dev, sigma(0.05), n_tasks=1)}
    for name, fn in runs.items():
        run = fn()
        n = len(cpu["losses"])
        emit(path="train_read_noise", run=name,
             loss_agree_steps=cs.loss_agree_steps(run["losses"][:n],
                                                  cpu["losses"]),
             steps=n, acc=float(run["R"][0][0]))


def protocol(dev, backends) -> None:
    import numpy as np
    import torch
    from repro_torch.backends import get_backend
    faults = {
        "wbs": {"clip_off": {"weight_clip": None},
                "adc_off": {"adc_bits": None},
                "input_7bit": {"input_bits": 7}},
        "analog": {"write_noise_off": analog_spec(write_sigma=0.0),
                   "gain_noise_off": {"gain_sigma": 0.0},
                   "adc_off": {"adc_bits": None}}}
    for backend in backends:
        cpu = cs.protocol_run(torch.device("cpu"), backend)
        runs = {"card": lambda: cs.protocol_run(dev, backend)}
        runs["cpu_2_threads"] = lambda: cs.protocol_run(
            torch.device("cpu"), backend)
        for name, over in faults.get(backend, {}).items():
            runs[f"card_{name}"] = (
                lambda over=over: cs.protocol_run(
                    dev, get_backend(backend, spec_overrides=over)))
        if backend in faults:
            runs["card_u_writes_lost"] = lambda: cs.protocol_run(
                dev, lost_u_writes(backend))
        for name, fn in runs.items():
            if name == "cpu_2_threads":
                with threads(2):
                    run = fn()
            else:
                run = fn()
            R, cR = np.asarray(run["R"]), np.asarray(cpu["R"])
            d_ex = float(np.abs(R - cR).max()) * cs.CL_TEST
            d_ma = abs(run["MA"] - cpu["MA"])
            emit(path="train_protocol", backend=backend, run=name,
                 loss_agree_steps=cs.loss_agree_steps(run["losses"],
                                                      cpu["losses"]),
                 steps=len(cpu["losses"]), R=R.tolist(), MA=run["MA"],
                 cpu_R=cR.tolist(), cpu_MA=cpu["MA"],
                 max_d_test_examples=d_ex, d_MA=d_ma,
                 passes_R_tolerance=cs.r_within(backend, run, cpu))


@contextlib.contextmanager
def patched(module, name: str, wrap):
    """``module.name`` replaced by ``wrap(original)`` for the block."""
    orig = getattr(module, name)
    setattr(module, name, wrap(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def flash_fault(kind: str):
    """A planted fault in the flash call of the model's prefill."""
    from repro_torch.kernels import ops

    def wrap(orig):
        def call(q, k, v, causal=True, sk_true=None):
            if kind == "causal_off":
                causal = False
            elif kind == "gqa_shift":
                k, v = k.roll(-1, 2), v.roll(-1, 2)
            elif kind == "sk_true_ignored":
                sk_true = k.shape[1]
            return orig(q, k, v, causal, sk_true)
        return call
    return patched(ops, "flash_attention_fwd", wrap)


def lm(dev) -> None:
    """The LM twins: sound runs beside planted faults."""
    import torch
    from repro_torch import testing
    from repro_torch.models import lm as lm_mod
    cpu_dev = torch.device("cpu")
    ccfg, cparams = cs.lm_twin_model(cpu_dev)
    cpu = cs.lm_prefill_twin_logits(ccfg, cparams, cpu_dev)
    cfg, params = cs.lm_twin_model(dev)
    runs = {"card": (dev, contextlib.nullcontext)}
    runs["cpu_2_threads"] = (cpu_dev, lambda: threads(2))
    for kind in ("causal_off", "gqa_shift", "sk_true_ignored"):
        runs[f"card_{kind}"] = (dev, lambda kind=kind: flash_fault(kind))
    for name, (d, ctx) in runs.items():
        with ctx():
            got = cs.lm_prefill_twin_logits(
                ccfg if d.type == "cpu" else cfg,
                cparams if d.type == "cpu" else params, d)
        diff = float((got - cpu).abs().max())
        emit(path="lm_prefill", run=name, max_abs_d_logits=diff,
             max_abs_logit=float(cpu.abs().max()),
             within_atol=diff <= cs.LM_PREFILL_ATOL,
             atol=cs.LM_PREFILL_ATOL)

    prompts = cs.lm_twin_prompts(ccfg.vocab)
    _, creqs = cs.lm_serve(ccfg, cparams, prompts, cpu_dev,
                           cs.LM_TWIN_MAX_NEW, keep_logits=True)

    def all_rows(orig):
        return lambda *a, write_rows=None, **kw: orig(*a, **kw)
    runs = {"card": (dev, contextlib.nullcontext),
            "cpu_2_threads": (cpu_dev, lambda: threads(2)),
            "card_cache_writes_all_rows": (
                dev, lambda: patched(lm_mod, "decode_step", all_rows))}
    for name, (d, ctx) in runs.items():
        with ctx():
            _, reqs = cs.lm_serve(ccfg if d.type == "cpu" else cfg,
                                  cparams if d.type == "cpu" else params,
                                  prompts, d, cs.LM_TWIN_MAX_NEW,
                                  keep_logits=True)
        first = max(float((r.logits[0] - c.logits[0]).abs().max())
                    for r, c in zip(reqs, creqs))
        every = max(float((torch.stack(r.logits) - torch.stack(c.logits))
                          .abs().max()) for r, c in zip(reqs, creqs))
        try:
            rep = testing.compare_tokens(
                [r.tokens for r in reqs], [c.tokens for c in creqs],
                [r.logits for r in reqs], [c.logits for c in creqs],
                atol=cs.LM_SERVE_ATOL).as_dict()
        except AssertionError as e:
            rep = {"fails": str(e)[:200]}
        emit(path="lm_serve", run=name, first_logits_max_abs_d=first,
             all_logits_max_abs_d=every,
             tokens_equal=[r.tokens for r in reqs] ==
             [c.tokens for c in creqs], atol=cs.LM_SERVE_ATOL,
             compare_tokens=rep)


def flash_bwd_fault(kind: str):
    """A planted fault in the flash backward's call (the autograd
    Function's gradient)."""
    import torch
    from repro_torch.kernels import ops

    def wrap(orig):
        def call(q, k, v, out, lse, dout, causal=True, sk_true=None):
            if kind == "causal_off":
                causal = False
            elif kind == "delta_omitted":
                out = torch.zeros_like(out)
            dq, dk, dv = orig(q, k, v, out, lse, dout, causal, sk_true)
            if kind == "dq_scale_dropped":
                dq = dq * q.shape[-1] ** 0.5
            elif kind == "dkv_head_shift":
                dk, dv = dk.roll(1, 2), dv.roll(1, 2)
            return dq, dk, dv
        return call
    return patched(ops, "flash_attention_bwd", wrap)


def lm_train(dev) -> None:
    """The training twin: sound runs beside planted faults."""
    import torch
    cpu_dev = torch.device("cpu")
    cpu = cs.lm_train_twin_run(cpu_dev)
    init = cs.lm_twin_model(cpu_dev)[1]
    runs = {"card": (dev, contextlib.nullcontext),
            "cpu_2_threads": (cpu_dev, lambda: threads(2))}
    for kind in ("dq_scale_dropped", "causal_off", "delta_omitted",
                 "dkv_head_shift"):
        runs[f"card_{kind}"] = (dev, lambda kind=kind: flash_bwd_fault(kind))
    for name, (d, ctx) in runs.items():
        with ctx():
            run = cs.lm_train_twin_run(d)
        dist = cs.train_twin_distances(run, cpu, init)
        emit(path="lm_train", run=name, losses=run["losses"],
             grad_norms=run["grad_norms"], **dist,
             within=(dist["loss_max_rel_d"] <= cs.LM_TRAIN_LOSS_RTOL
                     and dist["grad_norm_max_rel_d"]
                     <= cs.LM_TRAIN_GNORM_RTOL
                     and dist["params_d_over_update"]
                     <= cs.LM_TRAIN_PARAMS_REL))


SM90_LIBS = ("flash_attention_fwd_sm90", "flash_attention_bwd_dq_sm90",
             "flash_attention_bwd_dkv_sm90")
DQ_LIB, DKV_LIB = "flash_attention_bwd_dq_sm90", "flash_attention_bwd_dkv_sm90"
F32_DQ_LIB = "flash_attention_bwd_dq_f32_sm90"
F32_DKV_LIB = "flash_attention_bwd_dkv_f32_sm90"
F32_FWD_LIB = "flash_attention_fwd_f32_sm90"
# Each fault: its FLASH_SM90_FAULT value and the libraries built with it.
SM90_FAULTS = {"split_first_term_only": (1, SM90_LIBS),
               "fold_order_per_call": (2, (DKV_LIB,)),
               "causal_start_late": (4, (DKV_LIB,)),
               "dq_first_term_only": (1, (DQ_LIB,)),
               "dq_causal_loop_short": (8, (DQ_LIB,)),
               "f32_dq_qk_first_term_only": (16, (F32_DQ_LIB,)),
               "f32_dkv_qk_first_term_only": (16, (F32_DKV_LIB,)),
               "f32_fwd_qk_first_term_only": (16, (F32_FWD_LIB,))}


def fault_flags(fault: int) -> tuple[str, ...]:
    return (f"-DFLASH_SM90_FAULT={fault}",) if fault else ()


@contextlib.contextmanager
def planted(fault: int, libs=SM90_LIBS, flags_of=fault_flags):
    """The kernels ``libs`` run with ``fault`` planted: the wrappers load
    those libraries built with ``flags_of(fault)`` (``-DFLASH_SM90_FAULT``
    by default)."""
    from repro_torch.kernels import _build
    load = _build.load

    def faulty(name, flags=()):
        return load(name, flags + flags_of(fault) if name in libs
                    else flags)
    _build.load = faulty
    try:
        yield
    finally:
        _build.load = load


def flash_sm90(dev) -> bool:
    """The tensor-core kernels' checks (the bf16 route's and the fp32
    backward's): sound beside planted faults. Whether the sound build
    passes every check and each planted fault fails one."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from repro_torch.kernels import _build
    libs_of = {}                   # each fault's libraries, built once
    for fault, libs in SM90_FAULTS.values():
        libs_of.setdefault(fault, set()).update(libs)
    with ThreadPoolExecutor(len(libs_of)) as pool:       # all nvcc at once
        list(pool.map(lambda f: _build.build(sorted(libs_of[f]),
                                             fault_flags(f)), libs_of))
    passes = {}
    for name, (fault, libs) in {"card": (0, ()), **SM90_FAULTS}.items():
        with planted(fault, libs):
            for check in (cs.check_lm_kernels, cs.check_flash_bwd):
                try:
                    check(dev, np.random.default_rng(0))
                    failed = None
                except AssertionError as e:
                    failed = str(e)[:300]
                passes.setdefault(name, []).append(failed is None)
                emit(path="flash_sm90", run=name, check=check.__name__,
                     passes=failed is None, failure=failed)
    reach = all(passes.pop("card")) and not any(all(p)
                                                for p in passes.values())
    emit(path="flash_sm90", sound_passes_and_every_fault_caught=reach)
    return reach


def kernel_fault(path: str, lib: str, macro: str, fault: str,
                 checks) -> bool:
    """Each of ``checks`` (called with a fresh rng), sound and with
    ``fault`` planted at build time in library ``lib`` (``-D<macro>=1``).
    Whether the sound build passes every check and the fault fails one."""
    import numpy as np
    from repro_torch.kernels import _build
    flags = lambda f: (f"-D{macro}={f}",) if f else ()
    _build.build([lib], flags(1))
    passes = {}
    for name, f in (("card", 0), (fault, 1)):
        with planted(f, (lib,), flags):
            for check in checks:
                try:
                    check(np.random.default_rng(0))
                    failed = None
                except AssertionError as e:
                    failed = str(e)[:300]
                passes.setdefault(name, []).append(failed is None)
                emit(path=path, run=name, passes=failed is None,
                     failure=failed)
    reach = all(passes["card"]) and not all(passes[fault])
    emit(path=path, sound_passes_and_the_fault_caught=reach)
    return reach


def scan(dev) -> bool:
    """The fused scan's bitwise check (``chip_smoke.check_scan``) and the
    fused-equals-per-step contract, sound and with
    ``slab_planes_joined_lsb_first`` planted at build time
    (``csrc/wbs_miru_scan.cu``'s ``WBS_SCAN_FAULT``: the second block of
    each cluster joins its columns' plane sums LSB first). (Where the ADC
    re-quantizes every step, as on the serve path, a reordered sum moves
    the integrator by an ulp and the ADC's level almost never: the
    bitwise check's ADC-off cases are the ones that see it.)"""
    cfg, params = cs.paper_model(dev)

    def fused_equals_per_step(rng):
        if not cs.recurrence_fused_equals_per_step(dev, cfg, params):
            raise AssertionError("fused != per-step (device_recurrence)")
    return kernel_fault("scan", "wbs_miru_scan", "WBS_SCAN_FAULT",
                        "slab_planes_joined_lsb_first",
                        (lambda rng: cs.check_scan(dev, rng),
                         fused_equals_per_step))


def main() -> int:
    global _OUT
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also append the JSON lines to this file")
    ap.add_argument("--paths", nargs="+", default=list(PATHS),
                    choices=PATHS)
    args = ap.parse_args()
    _OUT = args.out
    paths = args.paths
    if not torch.cuda.is_available():
        print("parity_reach: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build
    _build.build()
    dev = torch.device("cuda", 0)
    if "software" in paths:
        software(dev, cs.software_run(torch.device("cpu")))
    protocol(dev, [p for p in ("ideal", "wbs", "analog") if p in paths])
    reach = True
    if "read_noise" in paths:
        read_noise(dev)
        reach = kernel_fault("read_noise", "wbs_matmul", "READ_NOISE_FAULT",
                             "draw_counter_off_by_one",
                             (lambda rng: cs.check_read_noise(dev, rng),))
    if "miru_scan" in paths:
        reach = kernel_fault("miru_scan", "miru_scan", "MIRU_SCAN_FAULT",
                             "chain_drops_last_k",
                             (lambda rng: cs.check_miru_scan(dev, rng),)) \
            and reach
    if "readout" in paths:
        reach = kernel_fault("readout", "miru_readout", "READOUT_FAULT",
                             "late_blocks_sum_k_descending",
                             (lambda rng: cs.check_kernels(dev),)) and reach
    if "kwta" in paths:
        reach = kernel_fault("kwta", "kwta", "KWTA_FAULT",
                             "lane_31_left_out_of_counts",
                             (lambda rng: cs.check_lm_kernels(dev, rng),)) \
            and reach
    if "lm" in paths:
        lm(dev)
    if "lm_train" in paths:
        lm_train(dev)
        reach = flash_sm90(dev) and reach
    if "scan" in paths:
        reach = scan(dev) and reach
    emit(nvidia_smi=cs.nvidia_smi(), cpu_threads=torch.get_num_threads())
    return 0 if reach else 1


if __name__ == "__main__":
    sys.exit(main())
