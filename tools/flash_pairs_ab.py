#!/usr/bin/env python3
"""Time the six flash kernels of one tree's ``repro_torch`` at the
qwen2-0.5B shapes (B 2, S 2,048, 14 query heads over 2 KV heads, head dim
64, causal: the bf16 forward, dq and dk/dv, and the fp32 route's), and
print the stack frames that ptxas reports for its flash libraries. With
``--mla`` also at the deepseek-v3 shape (1 × 2,048, 128 heads, head dims
192 / 128), which a tree older than the (192, 128) kernels refuses.

GPU only. Compare two trees in one chip call, each in a process of its
own, in turns (parent, change, change, parent):

    git archive <parent> src | tar -x -C archive/parent
    for t in archive/parent . . archive/parent; do
        python3 tools/flash_pairs_ab.py $t; done

Prints one JSON line a run: the tree, ms a call of each kernel (CUDA
graphs of 20 calls, 5 replays, after a warm-up), the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path


def time_graph(fn, reps: int = 20, rounds: int = 5) -> float:
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
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


def stack_frames(libs: dict) -> dict:
    """{library | kernel: ptxas's line} for every kernel with a frame."""
    out, name = {}, None
    for lib, path in libs.items():
        for ln in path.with_suffix(".log").read_text().splitlines():
            if "entry function" in ln:
                name = subprocess.run(
                    ["c++filt", re.search(r"'([^']*)'", ln).group(1)],
                    capture_output=True, text=True).stdout.strip()[:90]
            elif "stack frame" in ln and not ln.strip().startswith("0 bytes"):
                out[f"{lib} | {name}"] = ln.strip()
    return out


def times(B, S, H, Kh, dh, dv) -> dict:
    """ms a call of the six kernels at one shape, causal."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    kw = dict(causal=True, sk_true=S, q_heads=H, kv_heads=Kh,
              scale=dh ** -0.5)
    rng = np.random.default_rng(0)
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        mk = lambda n, d: torch.from_numpy(rng.normal(0, 1, (n, S, d)).astype(
            np.float32)).to("cuda", dt)
        q, k, v, do = mk(B * H, dh), mk(B * Kh, dh), mk(B * Kh, dv), \
            mk(B * H, dv)
        bf = dt == torch.bfloat16
        fwd = fa.flash_attention_fwd_sm90 if bf else fa.flash_attention_fwd
        dq = fa.flash_attention_bwd_dq_sm90 if bf \
            else fa.flash_attention_bwd_dq
        dkv = fa.flash_attention_bwd_dkv_sm90 if bf \
            else fa.flash_attention_bwd_dkv
        o, lse = fwd(q, k, v, **kw)
        delta = torch.sum(do.float() * o.float(), -1)
        tag = "bf16" if bf else "fp32"
        out[f"fwd_{tag}"] = time_graph(lambda: fwd(q, k, v, **kw))
        out[f"dq_{tag}"] = time_graph(
            lambda: dq(q, k, v, do, lse, delta, **kw))
        out[f"dkv_{tag}"] = time_graph(
            lambda: dkv(q, k, v, do, lse, delta, **kw))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", type=Path, help="a tree holding src/repro_torch")
    ap.add_argument("--mla", action="store_true",
                    help="also time the deepseek-v3 shape (192 / 128)")
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve() / "src"))
    import torch
    if not torch.cuda.is_available():
        print("flash_pairs_ab: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build
    libs = _build.build([n for n in _build.NAMES if "flash" in n])
    res = {"tree": str(args.tree), "ms": times(2, 2048, 14, 2, 64, 64)}
    if args.mla:
        res["ms_192x128"] = times(1, 2048, 128, 128, 192, 128)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    res.update(stack_frames=stack_frames(libs), card=smi)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
