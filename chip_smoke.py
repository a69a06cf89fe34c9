#!/usr/bin/env python3
"""Drive the PyTorch port's MiRU serving path on one NVIDIA GPU and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. device: the card's name and count, and ``nvidia-smi``'s name and power
   limit;
2. build: both CUDA kernels compiled by nvcc for sm_90a from
   ``src/repro_torch/kernels/csrc/``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the serve path's shapes, with ``repro_torch.testing``'s tie-aware
   comparison (rtol = atol = 2e-5);
4. serve: the paper's 28×100×10 network (``configs/m2ru_paper.py``) with
   seeded random weights, served through ``RecurrentServeEngine`` on the
   ``wbs`` substrate (64 slots, chunk 14) for a 256-request burst over 96
   users with 28 frames each; the launch counters are zeroed just before
   and read just after, and the served logits are held against the same
   traffic served by the port on the CPU; a second, traced run of the
   burst gives the device's busy time and its share of the untraced
   run's wall time;
5. contracts: fused equals per-step bit for bit; batch composition and
   slot permutation are bitwise inert at a fixed slab shape; whether a
   one-slot engine matches is printed, not asserted;
6. times: CUDA-event timings of each kernel, its plain version and (for
   the crossbar product) one torch.matmul, each over a CUDA graph of
   repeated launches, beside the least time the card could take.

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

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# The paper network (configs/m2ru_paper.py PAPER_CONFIG) and the serve
# width of benchmarks/serve_bench.py.
N_X, N_H, N_Y, BETA, LAM = 28, 100, 10, 0.8, 0.5
SLOTS, CHUNK, FRAMES = 64, 14, 28
N_REQUESTS, N_USERS = 256, 96
N_BITS, ADC_BITS, ADC_RANGE, W_SCALE = 8, 8, 4.0, 1.5   # wbs default_spec
# Published H100 SXM peaks (NVIDIA data sheet): fp32 on CUDA cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


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


def bound_ms(flops: float, n_bytes: float) -> tuple[float, str]:
    """The least time for the work: FLOPs at the fp32 peak or bytes at the
    memory rate, whichever is larger."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, n_bytes / PEAK_BYTES
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
    err = {"wbs_matmul": 0.0, "wbs_miru_scan": 0.0}
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
    from repro_torch.kernels import wbs_matmul, wbs_miru_scan
    from repro_torch.serve import replay
    cfg, params = paper_model(dev)
    arrivals = [(a.uid, f) for a, f in replay(burst_spec())]
    uids = sorted({u for u, _ in arrivals})
    # Warm-up on other traffic (CUDA context, allocator, libraries loaded).
    serve(cfg, params, [(f"warm{i}", f) for i, (_, f) in
                        enumerate(arrivals[:SLOTS])], dev)

    wbs_matmul.launches = wbs_miru_scan.launches = 0
    t0 = time.perf_counter()
    eng, reqs = serve(cfg, params, arrivals, dev)
    wall = time.perf_counter() - t0
    launches = {"wbs_matmul": wbs_matmul.launches,
                "wbs_miru_scan": wbs_miru_scan.launches}
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the serve path never launched: "
                             f"{launches}")
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
    emit("contracts", fused_equals_per_step=True,
         batch_composition_and_slot_permutation_bitwise=True,
         one_slot_engine_bitwise=bool(one_slot_equal))


# ---------------------------------------------------------------------------
# Phase 6: times
# ---------------------------------------------------------------------------

def times(dev) -> dict:
    """Each kernel's wrapper on inputs already padded and prepared as the
    serve path hands them over, so ``ms`` is the launch alone."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref, wbs_matmul, wbs_miru_scan
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

    err = check_kernels(dev)
    run = serve_path(dev, name)
    contracts(dev, run)
    t = times(dev)

    src = "src/repro_torch/kernels/csrc/"
    replaces = {"wbs_matmul": "src/repro/kernels/wbs_matmul.py:99",
                "wbs_miru_scan": "src/repro/kernels/wbs_miru_scan.py:105"}
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src + k + ".cu",
         "replaces": replaces[k], "launches": run["launches"][k],
         "max_abs_err": err[k], "ms": t[k]["ms"], "plain_ms": t[k]["plain_ms"],
         "bound_ms": t[k]["bound_ms"], "bound_by": t[k]["bound_by"],
         "library_ms": t[k]["library_ms"]} for k in replaces]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
