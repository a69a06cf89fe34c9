#!/usr/bin/env python3
"""Device times of the port's kernels at the main paths' shapes, for
comparing two trees on one NVIDIA GPU.

Run from the repository root:

    python3 tools/kernel_times.py [--src DIR] [--label NAME] [--out FILE]
                                  [--old-fp32-bwd FILE] [--old-fp32-fwd FILE]
                                  [--old-scan FILE] [--old-read-noise FILE]
                                  [--old-miru-scan FILE]
                                  [--old-readout FILE] [--old-kwta FILE]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (this
tree's by default). The rows and their timers are the timed tree's own
``chip_smoke.py``'s (the one beside ``--src``; ``times``: each kernel's
wrapper on inputs prepared as the main path hands them over, beside its
plain version, the library call where one exists and the bound; the
flash kernels on their own dtype's inputs; TF32 off). To compare a
commit with its parent, unpack the parent with ``git archive`` under
``archive/`` and time both trees in one call, A B B A. One row is added
to chip_smoke's: ``ops.wbs_matmul`` as a whole at the drive and the
per-step shape (``ops_ms``: the launch with what the dispatch does around
it). The ``--old-*`` options time this tree's kernels against older
sources in one process and need ``--src`` left at this tree's.

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

``--old-read-noise FILE`` and ``--old-miru-scan FILE`` time the
read-noise product and the ideal scan of commit d589c78 beside this
tree's: pass that commit's ``wbs_matmul.cu`` and ``miru_scan.cu`` where
they lie in a copy of its tree (``git archive d589c78`` unpacked under
``archive/``), so that each includes its own tree's headers. The read-noise product is timed at train (d)'s two shapes
((32, 28) × (28, 100), the step's drive, and (32, 100) × (100, 100),
the recurrent product), the scan at train (a)'s (64, 28, 100), the
test set's (300, 28, 100), (64, 28, 200) and (64, 28, 256), old, new,
new, old, every
result bit for bit against the plain version; the scan also with U read
from each place that fits the width (``miru_scan.PLACES``: registers,
shared or global memory), twice each, in one order and then the other,
and at train (a)'s shape
with its double tanh or its sums cut out of temporary copies of its
source (``parts_cut_ms``: where a step's time goes; timing only).

``--old-fp32-fwd FILE`` and ``--old-scan FILE`` do the same for the fp32
flash forward (the CUDA-core ``flash_attention_fwd.cu``, whose C
function is ``flash_attention_fwd_launch``) and the fused WBS scan (the
``wbs_miru_scan.cu`` of 8 batch rows a block) of commit 2263fdf,
extracted likewise:

    git show 2263fdf:src/repro_torch/kernels/csrc/flash_attention_fwd.cu \
        > archive/flash_attention_fwd.cu
    git show 2263fdf:src/repro_torch/kernels/csrc/wbs_miru_scan.cu \
        > archive/wbs_miru_scan.cu

The forward is timed at the qwen2-0.5B training shape in fp32, old, new,
new, old, beside fp32 SDPA, each held to the plain version (out at rtol
2e-5 / atol 2e-6, lse at atol 1e-5), and beside a copy of this tree's
kernel with one K/V stage at D 64 (its ``kStages`` rewritten in a
temporary copy of the source: two blocks an SM if it fits 128
registers; its ptxas stack frame is reported). The scan is timed at the
serve shape (64, 14, 100) and train (b)'s (32, 28, 100), old, new, new,
old, both bitwise equal to the plain version, and this tree's kernel at
other launch geometries (rows a cluster, cluster size: the wrapper's
``geom``) once each.

``--old-readout FILE`` and ``--old-kwta FILE`` time the readout and
k-WTA of commit 7eda07d (one thread an output reading from global
memory; a block of 512 threads a row with three barriers a count) beside
this tree's: pass its ``miru_readout.cu`` and ``kwta.cu`` (``git archive
7eda07d`` unpacked under ``archive/``). The readout is timed at the
serve, eval and train shapes ((896, 100, 10), (200, …), (64, …), (32,
…)), k-WTA at ``chip_smoke.KWTA_SHAPES`` in f32 and bf16, old, new, new,
old, every result bit for bit against the plain version, beside
``torch.addmm`` (the readout) and the empty kernel launched at this
tree's blocks and threads (``launch_floor_ms``); plus the variants, each
built from a temporary copy of this tree's source: the readout with one
thread a row carrying its 10 chains interleaved, at 8 and 32 rows a
block, and k-WTA in f32 under every plan that holds the row at N 100 to
16,384 (one warp a row, 2-32 warps a row, the row streamed: the evidence
for ``kwta.plan``).

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


def _build_file(src: Path, flags=()):
    """``src`` built by nvcc into a temporary directory (never into the
    package), finding its headers among this tree's, and loaded, with
    nvcc's report."""
    import ctypes
    import subprocess
    import tempfile
    from repro_torch.kernels import _build
    with tempfile.TemporaryDirectory() as tmp:
        so = Path(tmp) / f"libold_{src.stem}.so"
        run = subprocess.run([_build.nvcc(), *_build.FLAGS, *flags,
                              f"-I{_build.CSRC}", "-o", str(so), str(src)],
                             check=True, capture_output=True, text=True)
        return ctypes.CDLL(str(so)), run.stdout + run.stderr


def old_fp32_fwd_rows(cs, dev, src: Path) -> dict:
    """The old fp32 forward (C function ``flash_attention_fwd_launch`` of
    ``src``) beside this tree's, the same with one K/V stage, and fp32
    SDPA, at the training shape."""
    import ctypes
    import tempfile

    import numpy as np
    import torch
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as fa
    lib, _ = _build_file(src)
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_fwd_launch.argtypes = [P] * 5 + [I] * 8 + [Fl, P]
    lib.flash_attention_fwd_launch.restype = I
    # This tree's forward with one K/V stage at D 64, from a copy of its
    # source (the package's build has two).
    text = (_build.CSRC / "flash_attention_fwd_f32_sm90.cu").read_text()
    stages = "kStages = DQK == 64 ? 2 : 1;"
    if text.count(stages) != 1:
        raise RuntimeError(f"no single {stages!r} in the fp32 forward")
    with tempfile.TemporaryDirectory() as tmp:
        one = Path(tmp) / "flash_attention_fwd_f32_sm90_one_stage.cu"
        one.write_text(text.replace(stages, "kStages = 1;"))
        stage1, stage1_log = _build_file(one)
    fn1 = stage1.flash_attention_fwd_f32_sm90_launch
    fn1.argtypes = [P] * 6 + [I] * 9 + [Fl, P]
    fn1.restype = I
    B, S, H, Kh, dh = cs.LM_TRAIN_B, cs.LM_TRAIN_S, 14, 2, 64
    kw = dict(causal=True, sk_true=S, q_heads=H, kv_heads=Kh,
              scale=dh ** -0.5)
    ints = (B * H, H, Kh, S, S, S, dh, 1)
    rng = np.random.default_rng(3)
    with torch.no_grad():
        q, k, v = cs.flash_inputs(rng, dev, B, S, S, H, Kh, dh,
                                  torch.float32)
        heads = lambda t: t.transpose(1, 2).reshape(-1, S, dh).contiguous()
        qt, kt, vt = heads(q), heads(k), heads(v)
        stream = lambda: torch.cuda.current_stream().cuda_stream

        def old():
            out, lse = torch.empty_like(qt), qt.new_empty(B * H, S)
            err = lib.flash_attention_fwd_launch(
                qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), out.data_ptr(),
                lse.data_ptr(), *ints, kw["scale"], stream())
            assert err == 0, err
            return out, lse

        def one_stage():
            out, lse = torch.empty_like(qt), qt.new_empty(B * H, S)
            terms = torch.empty(3 * (qt.numel() + 2 * kt.numel()),
                                dtype=torch.bfloat16, device=dev)
            err = fn1(qt.data_ptr(), kt.data_ptr(), vt.data_ptr(),
                      terms.data_ptr(), out.data_ptr(), lse.data_ptr(),
                      *ints[:-1], dh, ints[-1], kw["scale"], stream())
            assert err == 0, err
            return out, lse

        new = lambda: fa.flash_attention_fwd(qt, kt, vt, **kw)
        want, want_lse = ref.flash_attention_fwd_ref(qt, kt, vt, True, S, H,
                                                     Kh)
        close = {}
        for name, fn in (("old", old), ("new", new),
                         ("new_one_stage", one_stage)):
            out, lse = fn()
            torch.cuda.synchronize()
            close[name] = bool(torch.allclose(out, want, rtol=2e-5,
                                              atol=2e-6)) and \
                float((lse - want_lse).abs().max()) <= 1e-5
        res = {"shape": [B, S, H, Kh, dh], "dtype": "torch.float32",
               "causal": True, "within_fp32_bounds": close,
               "old_ms": [], "new_ms": [],
               "one_stage_ptxas": [ln.strip() for ln in stage1_log
                                   .splitlines() if "stack frame" in ln
                                   or "registers" in ln]}
        for label, fn in (("old_ms", old), ("new_ms", new), ("new_ms", new),
                          ("old_ms", old)):
            res[label].append(cs.time_graph(fn))
        res["new_one_stage_ms"] = cs.time_graph(one_stage)
        yard, _ = cs.sdpa_yardstick(q, k, v, H, Kh)
        res["sdpa_fp32_ms"] = cs.time_graph(yard)
    return res


def old_scan_rows(cs, dev, src: Path) -> dict:
    """The old fused scan (C function ``wbs_miru_scan_launch`` of ``src``,
    B a multiple of 8) beside this tree's at the serve and train (b)
    shapes, and this tree's at other launch geometries."""
    import ctypes

    import numpy as np
    import torch
    from repro_torch.analog.wbs import ideal_gains
    from repro_torch.kernels import ref
    from repro_torch.kernels import wbs_miru_scan as ks
    from repro_torch.kernels.wbs_matmul import adc_args
    lib, _ = _build_file(src)
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.wbs_miru_scan_launch.argtypes = [P] * 8 + [I] * 4 + [Fl] * 5 + \
        [I, Fl, Fl, Fl, P]
    lib.wbs_miru_scan_launch.restype = I
    rng = np.random.default_rng(4)
    out = {}
    with torch.no_grad():
        for key, (B, T) in (("serve", (cs.SLOTS, cs.CHUNK)),
                            ("train", (cs.CL_BATCH, cs.T_SEQ))):
            H, nb = cs.N_H, cs.N_BITS
            inp = cs.scan_inputs(rng, dev, B, T, H, with_h0=True)
            us = inp["u_h"] / cs.W_SCALE
            g = ideal_gains(nb, device=dev).expand(T, nb).contiguous()
            use_adc, step, lo, hi = adc_args(cs.ADC_BITS, cs.ADC_RANGE)
            norm = 2.0 ** nb / (2.0 ** nb - 1.0)
            kw = dict(beta=cs.BETA, lam=cs.LAM, adc_bits=cs.ADC_BITS,
                      adc_range=cs.ADC_RANGE, w_scale=cs.W_SCALE)

            def old():
                o = [torch.empty(B, T, H, device=dev) for _ in range(3)]
                err = lib.wbs_miru_scan_launch(
                    inp["drive"].data_ptr(), us.data_ptr(),
                    inp["h0"].data_ptr(), inp["b_h"].data_ptr(),
                    g.data_ptr(), *(t.data_ptr() for t in o), B, T, H, nb,
                    cs.BETA, cs.LAM, 1.0 - cs.LAM, norm, cs.W_SCALE,
                    use_adc, step, lo, hi,
                    torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
                return o

            geom = ks.geometry(B, H)

            def new(gm=geom):
                return ks.wbs_miru_scan(inp["drive"], us, inp["h0"],
                                        inp["b_h"], g, geom=gm, **kw)
            want = ref.wbs_miru_scan_ref(
                inp["drive"], us, inp["h0"], inp["b_h"], cs.BETA, cs.LAM,
                nb, cs.ADC_BITS, cs.ADC_RANGE, cs.W_SCALE)
            bitwise = {}
            for name, fn in (("old", old), ("new", new)):
                got = fn()
                torch.cuda.synchronize()
                bitwise[name] = all(torch.equal(a, b)
                                    for a, b in zip(got, want))
            res = {"shape": [B, T, H], "bitwise": bitwise,
                   "geometry": dict(rows=geom.rows, cluster=geom.cluster,
                                    ncols=geom.ncols, blocks=geom.blocks(B)),
                   "old_ms": [], "new_ms": [], "variants": []}
            for label, fn in (("old_ms", old), ("new_ms", new),
                              ("new_ms", new), ("old_ms", old)):
                res[label].append(cs.time_graph(fn))
            for rows in (1, 2, 4, 8):
                for cluster in (2, 4, 8):
                    gm = ks.Geometry.of(rows, cluster, H)
                    if B % rows or gm == geom:
                        continue
                    got = new(gm)
                    torch.cuda.synchronize()
                    res["variants"].append(dict(
                        rows=rows, cluster=cluster, blocks=gm.blocks(B),
                        bitwise=all(torch.equal(a, b)
                                    for a, b in zip(got, want)),
                        ms=cs.time_graph(lambda: new(gm))))
            out[key] = res
    return out


def old_read_noise_rows(cs, dev, src: Path) -> dict:
    """The parent's read-noise kernel (C function
    ``wbs_matmul_read_noise_launch`` of ``src``: one fused launch, no
    scratch) beside this tree's at train (d)'s two shapes, old, new, new,
    old, each held bit for bit to the plain version."""
    import ctypes

    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import wbs_matmul as kmm
    from repro_torch.kernels.wbs_matmul import adc_args
    lib, _ = _build_file(src)
    P, I, Fl, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_uint
    fn = lib.wbs_matmul_read_noise_launch
    fn.argtypes = [P] * 5 + [I] * 4 + [Fl, I, Fl, Fl, Fl, Fl, U, U, P]
    fn.restype = I
    words = ops.read_key_words(np.asarray([0, 42], np.uint32))
    use_adc, step, lo, hi = adc_args(None, cs.ADC_RANGE)
    rng = np.random.default_rng(5)
    out = {}
    with torch.no_grad():
        for key, (M, K, N, xs) in {
                "drive": (cs.CL_BATCH, cs.N_X, cs.N_H, 1.0),
                "step": (cs.CL_BATCH, cs.N_H, cs.N_H, cs.BETA)}.items():
            inp = cs.matmul_inputs(rng, dev, M, K, N, xs)
            nb = inp["gains"].shape[0]
            norm = 2.0 ** nb / (2.0 ** nb - 1.0)

            def old():
                y = torch.empty((M, N), device=dev)
                err = fn(inp["sign"].data_ptr(), inp["code"].data_ptr(),
                         inp["w"].data_ptr(), inp["gains"].data_ptr(),
                         y.data_ptr(), M, K, N, nb, norm, use_adc, step, lo,
                         hi, cs.READ_SIGMA, *words,
                         torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
                return y

            def new():
                return kmm.wbs_matmul_read_noise(
                    inp["sign"], inp["code"], inp["w"], inp["gains"],
                    cs.READ_SIGMA, words)
            want = ref.wbs_matmul_read_noise_ref(
                **inp, read_sigma=cs.READ_SIGMA, key_words=words)
            bitwise = {}
            for name, f in (("old", old), ("new", new)):
                got = f()
                torch.cuda.synchronize()
                bitwise[name] = bool(torch.equal(got, want))
            res = {"shape": [M, K, N], "bitwise": bitwise, "old_ms": [],
                   "new_ms": []}
            for label, f in (("old_ms", old), ("new_ms", new),
                             ("new_ms", new), ("old_ms", old)):
                res[label].append(cs.time_graph(f))
            out[key] = res
    return out


def old_miru_scan_rows(cs, dev, src: Path) -> dict:
    """The parent's ideal scan (C function ``miru_scan_launch`` of ``src``:
    8 rows a block) beside this tree's at train (a)'s shape, the test
    set's and train (a)'s at H 200 (U in shared memory) and H 256 (U from
    global memory), old, new, new,
    old, and this tree's with U read from each place it fits at that
    width (registers, shared or global memory), each timed twice, in one
    order and then the other."""
    import ctypes

    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import miru_scan as km
    lib, _ = _build_file(src)
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.miru_scan_launch.argtypes = [P] * 5 + [I] * 3 + [Fl] * 3 + [P]
    lib.miru_scan_launch.restype = I
    rng = np.random.default_rng(6)
    out = {}
    with torch.no_grad():
        for key, B, H in (("train", cs.SW_BATCH, cs.N_H),
                          ("test", cs.SW_TEST, cs.N_H),
                          ("train@200", cs.SW_BATCH, 200),
                          ("train@256", cs.SW_BATCH, 256)):
            T = cs.T_SEQ
            inp = cs.scan_inputs(rng, dev, B, T, H, with_h0=True)
            xw, u, h0 = inp["drive"], inp["u_h"], inp["h0"]

            def old():
                o = [torch.empty(B, T, H, device=dev) for _ in range(2)]
                err = lib.miru_scan_launch(
                    xw.data_ptr(), u.data_ptr(), h0.data_ptr(),
                    *(t.data_ptr() for t in o), B, T, H, cs.BETA, cs.LAM,
                    1.0 - cs.LAM, torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
                return o

            def new(place=None):
                return km.miru_scan(xw, u, h0, beta=cs.BETA, lam=cs.LAM,
                                    place=place)
            want = ref.miru_scan_ref(xw, u, h0, cs.BETA, cs.LAM)
            equal = lambda got: all(torch.equal(a, b)
                                    for a, b in zip(got, want))
            bitwise = {}
            for name, f in (("old", old), ("new", new)):
                got = f()
                torch.cuda.synchronize()
                bitwise[name] = equal(got)
            res = {"shape": [B, T, H], "bitwise": bitwise,
                   "u_place": km.u_place(H), "blocks": B,
                   "old_ms": [], "new_ms": []}
            for label, f in (("old_ms", old), ("new_ms", new),
                             ("new_ms", new), ("old_ms", old)):
                res[label].append(cs.time_graph(f))
            places = [pl for pl in km.PLACES
                      if km.smem_bytes(H, pl) <= km.SMEM_LIMIT
                      and (pl != "registers" or H <= km.REG_H)]
            res["places"] = {}
            for pl in places:
                got = new(pl)
                torch.cuda.synchronize()
                res["places"][pl] = dict(bitwise=equal(got), ms=[])
            for order in (places, places[::-1]):
                for pl in order:
                    res["places"][pl]["ms"].append(
                        cs.time_graph(lambda: new(pl)))
            out[key] = res
        out["train"]["parts_cut_ms"] = miru_scan_parts(cs, dev, rng)
    return out


def miru_scan_parts(cs, dev, rng) -> dict:
    """Where a step of this tree's ideal scan goes: the kernel at train
    (a)'s shape built from temporary copies of its source with the double
    tanh (tanh(p) read as p) or the sums over k (zeros) cut out, timed
    beside the whole. Timing only: the cut kernels compute another
    function."""
    import ctypes
    import tempfile

    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import miru_scan as km
    text = (_build.CSRC / "miru_scan.cu").read_text()
    cuts = {"tanh": ("static_cast<float>(tanh(static_cast<double>(p)))",
                     "p"),
            "sums": ("const float acc = row_sum_reg<KU>(cur, ur);",
                     "const float acc = 0.0f;")}
    B, T, H = cs.SW_BATCH, cs.T_SEQ, cs.N_H
    place = km.u_place(H)
    inp = cs.scan_inputs(rng, dev, B, T, H, with_h0=True)
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    out = {"shape": [B, T, H], "whole": cs.time_graph(
        lambda: km.miru_scan(inp["drive"], inp["u_h"], inp["h0"],
                             beta=cs.BETA, lam=cs.LAM))}
    with torch.no_grad(), tempfile.TemporaryDirectory() as tmp:
        for name, (old, new) in cuts.items():
            if text.count(old) != 1:
                raise RuntimeError(f"no single {old!r} in miru_scan.cu")
            src = Path(tmp) / f"miru_scan_without_{name}.cu"
            src.write_text(text.replace(old, new))
            lib, _ = _build_file(src)
            fn = lib.miru_scan_launch
            fn.argtypes = [P] * 5 + [I] * 3 + [Fl] * 3 + [I, P]
            fn.restype = I

            def run():
                o = [torch.empty(B, T, H, device=dev) for _ in range(2)]
                err = fn(inp["drive"].data_ptr(), inp["u_h"].data_ptr(),
                         inp["h0"].data_ptr(), *(t.data_ptr() for t in o),
                         B, T, H, cs.BETA, cs.LAM, 1.0 - cs.LAM,
                         km.PLACES.index(place),
                         torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
                return o
            out[f"without_{name}"] = cs.time_graph(run)
    return out


def old_fp32_bwd_rows(cs, dev, src: Path) -> dict:
    """The old fp32 dq and dk/dv (C functions ``flash_attention_bwd_dq_
    launch`` and ``flash_attention_bwd_dkv_launch`` of ``src``) beside
    this tree's and fp32 SDPA's whole backward, at the training shape."""
    import ctypes

    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch import testing
    from repro_torch.kernels import ref
    from repro_torch.kernels import flash_attention as fa
    lib, _ = _build_file(src)
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


# The readout variant that kernel_times appends to a temporary copy of
# csrc/miru_readout.cu (it uses that file's stage_tile, smem_floats and
# constants): one thread a row of h, carrying the row's N = 10 chains
# interleaved over one load of h from shared memory, each k ascending as
# in the package's kernel (so bit for bit the same function).
READOUT_ROWS_VARIANT = r"""
namespace {
constexpr int kRowCols = 10;
__global__ void __launch_bounds__(kMaxThreads)
readout_rows_kernel(const float* __restrict__ h, const float* __restrict__ w,
                    const float* __restrict__ b, float* __restrict__ out,
                    int M, int K, int rows, int k_tile, int vec_h) {
  extern __shared__ __align__(16) float smem[];
  const int hstride = k_tile + kPad;
  float* hs = smem;
  float* ws = hs + rows * hstride;
  float* bs = ws + k_tile * kRowCols;
  const int m0 = blockIdx.x * rows;
  const int r = threadIdx.x;
  const bool active = r < rows;
  const float* hr = hs + r * hstride;
  for (int i = threadIdx.x; i < kRowCols; i += blockDim.x)
    cp_async4(smem_u32(bs + i), b + i, 4);
  float acc[kRowCols];
#pragma unroll
  for (int j = 0; j < kRowCols; ++j) acc[j] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += k_tile) {
    const int kt = min(k_tile, K - k0);
    if (k0 > 0) __syncthreads();
    stage_tile(h, w, hs, ws, M, K, kRowCols, m0, 0, k0, kt, rows, kRowCols,
               k_tile, vec_h, true);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (!active) continue;
    int k = 0;
#pragma unroll 5
    for (; k + 4 <= kt; k += 4) {
      const float4 hv = *reinterpret_cast<const float4*>(hr + k);
      const float* wk = ws + k * kRowCols;
#pragma unroll
      for (int j = 0; j < kRowCols; ++j) {
        acc[j] = __fadd_rn(acc[j], __fmul_rn(hv.x, wk[j]));
        acc[j] = __fadd_rn(acc[j], __fmul_rn(hv.y, wk[kRowCols + j]));
        acc[j] = __fadd_rn(acc[j], __fmul_rn(hv.z, wk[2 * kRowCols + j]));
        acc[j] = __fadd_rn(acc[j], __fmul_rn(hv.w, wk[3 * kRowCols + j]));
      }
    }
    for (; k < kt; ++k)
#pragma unroll
      for (int j = 0; j < kRowCols; ++j)
        acc[j] = __fadd_rn(acc[j], __fmul_rn(hr[k], ws[k * kRowCols + j]));
  }
  const int m = m0 + r;
  if (!active || m >= M) return;
#pragma unroll
  for (int j = 0; j < kRowCols; ++j)
    out[static_cast<size_t>(m) * kRowCols + j] = __fadd_rn(acc[j], bs[j]);
}
}  // namespace

extern "C" int miru_readout_rows_launch(const void* h, const void* w,
                                        const void* b, void* out, int M,
                                        int K, int N, int rows, int k_tile,
                                        void* stream) {
  if (M < 1 || K < 1 || N != kRowCols || rows < 1 || rows > kMaxThreads ||
      k_tile < 4 || k_tile % 4 ||
      smem_floats(rows, kRowCols, k_tile) > kSmemFloats ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec_h = K % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0;
  readout_rows_kernel<<<(M + rows - 1) / rows, (rows + 31) / 32 * 32,
                        smem_floats(rows, kRowCols, k_tile) * sizeof(float),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(out), M, K, rows,
      k_tile, vec_h);
  return static_cast<int>(cudaGetLastError());
}
"""


def old_readout_rows(cs, dev, src: Path) -> dict:
    """The parent's readout (C function ``miru_readout_launch`` of ``src``:
    one thread an output reading both operands from global memory) beside
    this tree's at the serve shape (896, 100, 10), the eval shape (200,
    100, 10) and train (a)'s and (b)'s (64 and 32 rows), old, new, new,
    old, each bit for bit against the plain version, with ``torch.addmm``
    and the empty kernel at this tree's blocks and threads in the same
    process; and :data:`READOUT_ROWS_VARIANT` (one thread a row carrying
    its 10 chains interleaved) at 8 and 32 rows a block."""
    import ctypes
    import tempfile

    import numpy as np
    import torch
    from repro_torch.kernels import miru_readout as kr
    from repro_torch.kernels import _build, ref
    lib, _ = _build_file(src)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.miru_readout_launch.argtypes = [P] * 4 + [I] * 3 + [P]
    lib.miru_readout_launch.restype = I
    with tempfile.TemporaryDirectory() as tmp:
        copy = Path(tmp) / "miru_readout_rows.cu"
        copy.write_text((_build.CSRC / "miru_readout.cu").read_text()
                        + READOUT_ROWS_VARIANT)
        ilp, ilp_log = _build_file(copy)
    ilp.miru_readout_rows_launch.argtypes = [P] * 4 + [I] * 5 + [P]
    ilp.miru_readout_rows_launch.restype = I
    rng = np.random.default_rng(7)
    K, N = cs.N_H, cs.N_Y
    w = torch.from_numpy(rng.normal(0, 0.3, (K, N)).astype(np.float32)).to(
        dev)
    b = torch.from_numpy(rng.normal(0, 0.1, N).astype(np.float32)).to(dev)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    out = {"ilp_ptxas": [ln.strip() for ln in ilp_log.splitlines()
                         if "stack frame" in ln or "registers" in ln]}
    with torch.no_grad():
        for key, M in (("serve", cs.SLOTS * cs.CHUNK), ("eval", cs.CL_TEST),
                       ("train_a", cs.SW_BATCH), ("train_b", cs.CL_BATCH)):
            h = torch.from_numpy(rng.uniform(-1, 1, (M, K)).astype(
                np.float32)).to(dev)

            def old():
                y = torch.empty((M, N), device=dev)
                err = lib.miru_readout_launch(h.data_ptr(), w.data_ptr(),
                                              b.data_ptr(), y.data_ptr(), M,
                                              K, N, stream())
                assert err == 0, err
                return y

            def cols_a_thread(rows):
                def run():
                    y = torch.empty((M, N), device=dev)
                    err = ilp.miru_readout_rows_launch(
                        h.data_ptr(), w.data_ptr(), b.data_ptr(),
                        y.data_ptr(), M, K, N, rows, 100, stream())
                    assert err == 0, err
                    return y
                return run
            new = lambda: kr.miru_readout(h, w, b)
            want = ref.miru_readout_ref(h, w, b)
            variants = {f"cols_a_thread_10_rows_{r}": cols_a_thread(r)
                        for r in (8, 32)}
            bitwise = {}
            for name, f in (("old", old), ("new", new), *variants.items()):
                got = f()
                torch.cuda.synchronize()
                bitwise[name] = bool(torch.equal(got, want))
            g = kr.geometry(M, K, N, kr.sm_count(dev))
            rows, cols = g.grid(M, N)
            res = {"shape": [M, K, N], "bitwise": bitwise,
                   "geometry": g._asdict(), "blocks": rows * cols,
                   "old_ms": [], "new_ms": []}
            for label, f in (("old_ms", old), ("new_ms", new),
                             ("new_ms", new), ("old_ms", old)):
                res[label].append(cs.time_graph(f))
            res["addmm_ms"] = cs.time_graph(lambda: torch.addmm(b, h, w))
            res["launch_floor_ms"] = cs.time_graph(
                cs.launch_floor(rows * cols, g.threads))
            res["variants_ms"] = {n: cs.time_graph(f)
                                  for n, f in variants.items()}
            out[key] = res
    return out


def old_kwta_rows(cs, dev, src: Path) -> dict:
    """The parent's k-WTA (C function ``kwta_launch`` of ``src``: a block
    of 512 threads a row, three barriers a count, the row re-read each
    round) beside this tree's at ``chip_smoke.KWTA_SHAPES`` in f32 and
    bf16, old, new, new, old, each bit for bit against the plain version,
    with the empty kernel at this tree's blocks and threads; then
    :func:`kwta_plan_rows`."""
    import ctypes

    import numpy as np
    import torch
    from repro_torch.kernels import kwta as kk
    from repro_torch.kernels import ref
    lib, _ = _build_file(src)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.kwta_launch.argtypes = [P, P] + [I] * 5 + [P]
    lib.kwta_launch.restype = I
    rng = np.random.default_rng(8)
    iters = 32
    out = {}
    with torch.no_grad():
        for (R, N, k), dt in [(s, d) for s in cs.KWTA_SHAPES
                              for d in (torch.float32, torch.bfloat16)]:
            x = torch.from_numpy(rng.normal(0, 1, (R, N)).astype(
                np.float32)).to(dev, dt)

            def old():
                y = torch.empty_like(x)
                err = lib.kwta_launch(x.data_ptr(), y.data_ptr(), R, N, k,
                                      iters, int(dt == torch.bfloat16),
                                      torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
                return y
            new = lambda: kk.kwta(x, k, iters)
            want = ref.kwta_bisect_ref(x, k, iters)
            bitwise = {}
            for name, f in (("old", old), ("new", new)):
                got = f()
                torch.cuda.synchronize()
                bitwise[name] = bool(torch.equal(got, want))
            p = kk.plan(N, dt)
            blocks, threads = kk.launch_shape(R, p)
            res = {"shape": [R, N], "k": k, "dtype": str(dt),
                   "plan": p._asdict(), "blocks": blocks,
                   "bitwise": bitwise, "old_ms": [], "new_ms": []}
            for label, f in (("old_ms", old), ("new_ms", new),
                             ("new_ms", new), ("old_ms", old)):
                res[label].append(cs.time_graph(f))
            res["launch_floor_ms"] = cs.time_graph(
                cs.launch_floor(blocks, threads))
            out[f"{R}x{N}_{str(dt).replace('torch.', '')}"] = res
    out["plans"] = kwta_plan_rows(cs, dev)
    return out


# The k-WTA register kernels that csrc/kwta.cu leaves out (kwta.plan
# never takes them) and that kwta_plan_rows adds to a temporary copy of
# it: one warp a row at 32 values a lane, 4 and 8 values a thread on the
# block path.
KWTA_PLAN_CASES = {"    KWTA_REGS(16, true)\n":
                   "    KWTA_REGS(16, true)\n    KWTA_REGS(32, true)\n",
                   "    KWTA_REGS(16, false)\n":
                   "    KWTA_REGS(4, false)\n    KWTA_REGS(8, false)\n"
                   "    KWTA_REGS(16, false)\n"}


def kwta_plan_rows(cs, dev) -> dict:
    """k-WTA in f32 under every plan that holds the row at the lengths
    ``kwta.plan`` chooses between (64 rows; 8 at 16,384): one warp a row,
    2-32 warps a row at the fewest values a thread (4, 8 or 16) that hold
    it, the row streamed; launched through ``kwta_launch`` of a temporary
    copy of this tree's ``kwta.cu`` with :data:`KWTA_PLAN_CASES` added,
    each bit for bit against the plain version and timed once,
    ``plan``'s marked. The evidence for ``kwta.plan``."""
    import ctypes
    import tempfile

    import numpy as np
    import torch
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import kwta as kk
    text = (_build.CSRC / "kwta.cu").read_text()
    for old, new in KWTA_PLAN_CASES.items():
        if text.count(old) != 1:
            raise RuntimeError(f"no single {old!r} in kwta.cu")
        text = text.replace(old, new)
    with tempfile.TemporaryDirectory() as tmp:
        copy = Path(tmp) / "kwta_plans.cu"
        copy.write_text(text)
        lib, _ = _build_file(copy)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.kwta_launch.argtypes = [P, P] + [I] * 8 + [P]
    lib.kwta_launch.restype = I
    rng = np.random.default_rng(9)
    out = {}
    with torch.no_grad():
        for R, N in ((64, 100), (64, 512), (64, 1024), (64, 2048),
                     (64, 4096), (8, 16384)):
            x = torch.from_numpy(rng.normal(0, 1, (R, N)).astype(
                np.float32)).to(dev)
            k = N // 2
            want = ref.kwta_bisect_ref(x, k)
            plans = [kk.Plan("warp", 1, next(v for v in (1, 2, 4, 8, 16, 32)
                                             if 32 * v >= N))] \
                if N <= 32 * 32 else []
            plans += [kk.Plan("block", w, next(v for v in (4, 8, 16)
                                               if 32 * w * v >= N))
                      for w in (2, 4, 8, 16, 32) if 32 * w * 16 >= N]
            plans.append(kk.Plan("stream", kk.BLOCK_WARPS, 0))
            rows = []
            for p in plans:
                def f(p=p):
                    y = torch.empty_like(x)
                    err = lib.kwta_launch(
                        x.data_ptr(), y.data_ptr(), R, N, k, 32, 0,
                        kk.PATHS.index(p.path), p.warps, p.v,
                        torch.cuda.current_stream().cuda_stream)
                    assert err == 0, (err, p)
                    return y
                got = f()
                torch.cuda.synchronize()
                rows.append(dict(plan=list(p), planned=p == kk.plan(N),
                                 bitwise=bool(torch.equal(got, want)),
                                 ms=cs.time_graph(f)))
            out[f"{R}x{N}"] = rows
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out")
    ap.add_argument("--old-fp32-bwd", type=Path)
    ap.add_argument("--old-fp32-fwd", type=Path)
    ap.add_argument("--old-scan", type=Path)
    ap.add_argument("--old-read-noise", type=Path)
    ap.add_argument("--old-miru-scan", type=Path)
    ap.add_argument("--old-readout", type=Path)
    ap.add_argument("--old-kwta", type=Path)
    args = ap.parse_args()
    src = Path(args.src).resolve()
    olds = (args.old_fp32_bwd, args.old_fp32_fwd, args.old_scan,
            args.old_read_noise, args.old_miru_scan, args.old_readout,
            args.old_kwta)
    if src != ROOT / "src" and any(olds):
        ap.error("the --old-* options time this tree's kernels: leave --src")
    sys.path.insert(0, str(src.parent))      # the timed tree's chip_smoke
    import chip_smoke as cs                  # puts its src first
    sys.path.insert(0, str(src))             # --src before it
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
    if args.old_fp32_fwd:
        res["old_fp32_fwd"] = old_fp32_fwd_rows(cs, dev, args.old_fp32_fwd)
    if args.old_scan:
        res["old_scan"] = old_scan_rows(cs, dev, args.old_scan)
    if args.old_read_noise:
        res["old_read_noise"] = old_read_noise_rows(cs, dev,
                                                    args.old_read_noise)
    if args.old_miru_scan:
        res["old_miru_scan"] = old_miru_scan_rows(cs, dev,
                                                  args.old_miru_scan)
    if args.old_readout:
        res["old_readout"] = old_readout_rows(cs, dev, args.old_readout)
    if args.old_kwta:
        res["old_kwta"] = old_kwta_rows(cs, dev, args.old_kwta)
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
