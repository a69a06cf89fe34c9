#!/usr/bin/env python3
"""Device times of the port's kernels at the main paths' shapes, for
comparing two trees on one NVIDIA GPU.

Run from the repository root:

    python3 tools/kernel_times.py [--src DIR] [--label NAME] [--out FILE]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (this
tree's by default). The rows and their timers are ``chip_smoke.py``'s
own (``times``: each kernel's wrapper on inputs prepared as the main
path hands them over, beside its plain version, the library call where
one exists and the bound; the flash kernels on their own dtype's inputs;
TF32 off), so the timed tree must offer this tree's kernel wrappers.
To compare a commit with its parent, unpack the parent with
``git archive`` under ``archive/`` and time both trees in one call,
A B B A. One row is added to chip_smoke's: ``ops.wbs_matmul`` as a whole
at the drive and the per-step shape (``ops_ms``: the launch with what
the dispatch does around it).

Prints one JSON object with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def ops_rows(cs, dev) -> dict:
    """``ops.wbs_matmul`` as a whole at the shapes of chip_smoke's
    ``wbs_matmul`` rows."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    rng = np.random.default_rng(1)
    out = {}
    with torch.no_grad():
        for key, (M, K, N, xs) in {
                "wbs_matmul": (cs.SLOTS * cs.CHUNK, cs.N_X, cs.N_H, 1.0),
                "wbs_matmul@step": (cs.SLOTS, cs.N_H, cs.N_H,
                                    cs.BETA)}.items():
            inp = cs.matmul_inputs(rng, dev, M, K, N, xs)
            out[key] = dict(shape=[M, K, N], ops_ms=cs.time_graph(
                lambda: ops.wbs_matmul(**inp)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs                  # puts this tree's src first
    sys.path.insert(0, str(Path(args.src).resolve()))   # --src before it
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch
    from repro_torch.kernels import _build
    _build.build()
    dev = torch.device("cuda", 0)
    res = {"label": args.label,
           "src": str(Path(repro_torch.__file__).parent.parent),
           "device": torch.cuda.get_device_name(0),
           "nvidia_smi": cs.nvidia_smi(), "times": cs.times(dev),
           "ops": ops_rows(cs, dev)}
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
