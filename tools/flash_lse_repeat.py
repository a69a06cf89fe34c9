#!/usr/bin/env python3
"""The fp32 flash forward's lse at the qwen2-0.5B prefill shape, repeated in
fresh processes: the card's kernel and the CPU's plain version, each held
to a float64 computation of the same lse.

``tests/test_torch_cuda.py::test_flash_kernel_equals_plain[1-2048-2048-14-
2-64-True-float32]`` holds the card's lse to the CPU's at atol 1e-5. This
script shows which side moves if that check ever fails: per process, three
calls on the card and three on the CPU (in both orders), each one's largest
distance from float64, whether repeated calls gave the same bits, and how
many rows of the card and the CPU differ by more than 1e-5.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/flash_lse_repeat.py [--processes 20]

One JSON line per process.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
B, SQ, SK, H, KH, DH = 1, 2048, 2048, 14, 2, 64


def one(order: str) -> dict:
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ops

    rng = np.random.default_rng(SQ + SK + H)      # the test's inputs
    q, k, v = (torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
               for s in ((B, SQ, H, DH), (B, SK, KH, DH), (B, SK, KH, DH)))
    dev = torch.device("cuda")

    def card():
        _, lse = ops.flash_attention_fwd(q.to(dev), k.to(dev), v.to(dev),
                                         causal=True)
        torch.cuda.synchronize()
        return lse.cpu().double().reshape(B * H, SQ)

    def cpu():
        _, lse = ops.flash_attention_fwd(q, k, v, causal=True)
        return lse.double().reshape(B * H, SQ)

    qd = q.double()[0].transpose(0, 1)
    kd = k.double()[0].transpose(0, 1).repeat_interleave(H // KH, 0)
    s = qd @ kd.transpose(1, 2) * DH ** -0.5
    s = s.masked_fill(torch.ones(SQ, SK, dtype=torch.bool).triu(1), -1e300)
    want = torch.logsumexp(s, -1).reshape(B * H, SQ)

    sides = [card, cpu] if order == "card_first" else [cpu, card]
    got = {f.__name__: [f() for _ in range(3)] for f in sides}
    return {"order": order,
            **{f"{n}_err_vs_f64": [float((x - want).abs().max()) for x in xs]
               for n, xs in got.items()},
            **{f"{n}_same_bits": all(torch.equal(x, xs[0]) for x in xs)
               for n, xs in got.items()},
            "rows_over_1e-5": int(((got["card"][0] - got["cpu"][0]).abs()
                                   > 1e-5).sum())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--processes", type=int, default=20)
    ap.add_argument("--one", choices=("card_first", "cpu_first"))
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.one)), flush=True)
        return 0
    rc = 0
    for i in range(args.processes):
        order = ("card_first", "cpu_first")[i % 2]
        rc |= subprocess.run([sys.executable, __file__, "--one", order],
                             timeout=300).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
