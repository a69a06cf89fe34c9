#!/usr/bin/env python3
"""Device times of the port's kernels at the main paths' shapes, for
comparing two trees on one NVIDIA GPU.

Run from the repository root:

    python3 tools/kernel_times.py [--src DIR] [--label NAME] [--out FILE]
                                  [--old-fp32-bwd FILE]

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

``--old-fp32-bwd FILE`` also times the fp32 flash backward's CUDA-core
kernels of the tree before the tensor-core redesign, from their source
file, against this tree's in the same process: extract it first (the
GPU machine's copy has no git),

    git show 0928960:src/repro_torch/kernels/csrc/flash_attention_bwd.cu \
        > archive/flash_attention_bwd.cu

and pass that path. It is built by nvcc into a temporary directory (never
into the package) and its dq and dk/dv are timed at the training shape in
fp32 beside this tree's dq and dk/dv and fp32 SDPA's whole backward (TF32
off) on the same inputs, old, new, new, old; each result is held to the
plain version (``testing.grads_close``).

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


def old_fp32_bwd_rows(cs, dev, src: Path) -> dict:
    """The old fp32 dq and dk/dv (C functions ``flash_attention_bwd_dq_
    launch`` and ``flash_attention_bwd_dkv_launch`` of ``src``) beside
    this tree's and fp32 SDPA's whole backward, at the training shape."""
    import ctypes
    import subprocess
    import tempfile

    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch import testing
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as fa
    with tempfile.TemporaryDirectory() as tmp:
        so = Path(tmp) / "libold_flash_attention_bwd.so"
        subprocess.run([_build.nvcc(), *_build.FLAGS, "-o", str(so),
                        str(src)], check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, n_ptrs in (("flash_attention_bwd_dq_launch", 7),
                         ("flash_attention_bwd_dkv_launch", 8)):
        getattr(lib, name).argtypes = [P] * n_ptrs + [I] * 8 + [Fl, P]
        getattr(lib, name).restype = I
    B, S, H, Kh, dh = cs.LM_TRAIN_B, cs.LM_TRAIN_S, 14, 2, 64
    kw = dict(causal=True, sk_true=S, q_heads=H, kv_heads=Kh,
              scale=dh ** -0.5)
    rng = np.random.default_rng(2)
    with torch.no_grad():
        q, k, v = cs.flash_inputs(rng, dev, B, S, S, H, Kh, dh,
                                  torch.float32)
        do = cs.flash_inputs(rng, dev, B, S, S, H, H, dh, torch.float32)[0]
        heads = lambda t: t.transpose(1, 2).reshape(-1, S, dh).contiguous()
        qt, kt, vt, dot = heads(q), heads(k), heads(v), heads(do)
        ot, lse = fa.flash_attention_fwd(qt, kt, vt, **kw)
        delta = torch.sum(dot * ot, -1)
        args = (qt, kt, vt, dot, lse, delta)
        ints = (B * H, H, Kh, S, S, S, dh, 1)

        def old_dq():
            dq = torch.empty_like(qt)
            err = lib.flash_attention_bwd_dq_launch(
                *(t.data_ptr() for t in args), dq.data_ptr(), *ints,
                kw["scale"], torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
            return dq

        def old_dkv():
            dk, dv = torch.empty_like(kt), torch.empty_like(vt)
            err = lib.flash_attention_bwd_dkv_launch(
                *(t.data_ptr() for t in args), dk.data_ptr(), dv.data_ptr(),
                *ints, kw["scale"], torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
            return dk, dv

        want = ref.flash_attention_bwd_ref(qt, kt, vt, ot, lse, dot, True,
                                           S, H, Kh)
        new_dq = lambda: fa.flash_attention_bwd_dq(*args, **kw)
        new_dkv = lambda: fa.flash_attention_bwd_dkv(*args, **kw)
        got = {"old_dq": (old_dq(),), "new_dq": (new_dq(),),
               "old_dkv": old_dkv(), "new_dkv": new_dkv()}
        close = {n: all(testing.grads_close(a, w) for a, w in zip(
            g, want[:1] if n.endswith("dq") else want[1:]))
            for n, g in got.items()}
        out = {"shape": [B, S, H, Kh, dh], "dtype": "torch.float32",
               "causal": True, "grads_close": close}
        for kind, old, new in (("dq", old_dq, new_dq),
                               ("dkv", old_dkv, new_dkv)):
            out[kind] = {"old_ms": [], "new_ms": []}
            for label, fn in (("old_ms", old), ("new_ms", new),
                              ("new_ms", new), ("old_ms", old)):
                out[kind][label].append(cs.time_graph(fn))
        qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        with torch.enable_grad():
            o = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                               enable_gqa=True)
        g = do.transpose(1, 2).contiguous()
        out["sdpa_backward_ms"] = cs.time_events(
            lambda: torch.autograd.grad(o, (qh, kh, vh), g,
                                        retain_graph=True))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out")
    ap.add_argument("--old-fp32-bwd", type=Path)
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
    if args.old_fp32_bwd:
        res["old_fp32_bwd"] = old_fp32_bwd_rows(cs, dev, args.old_fp32_bwd)
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
