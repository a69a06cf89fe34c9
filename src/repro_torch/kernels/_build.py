"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` on first use (route (b):
no PyTorch headers, so a build takes seconds, not minutes). Libraries
are cached under ``kernels/build/`` (listed in ``.gitignore``), named by
a digest of the sources and flags, so an edited source is rebuilt.
:func:`build` starts one ``nvcc`` per missing library, all at once.
Extra ``flags`` (a ``-D`` define, say) make a variant of a library under
a name of its own; the package's wrappers load the plain build.

Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NAMES = ("wbs_matmul", "wbs_miru_scan", "miru_scan", "miru_readout",
         "flash_attention_fwd_f32_sm90", "kwta", "flash_attention_fwd_sm90",
         "flash_attention_bwd_dq_sm90", "flash_attention_bwd_dkv_sm90",
         "flash_attention_bwd_dq_f32_sm90",
         "flash_attention_bwd_dkv_f32_sm90", "launch_floor")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[tuple[str, tuple[str, ...]], ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built on first use")
    return found


def library_path(name: str, flags: tuple[str, ...] = ()) -> Path:
    digest = hashlib.sha256(" ".join(FLAGS + tuple(flags)).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = NAMES,
          flags: tuple[str, ...] = ()) -> dict[str, Path]:
    """Compile every named library that is not built yet, one ``nvcc``
    each, all started together. The compiler's report (``-Xptxas -v``:
    registers, shared memory, spills) lands beside each library as
    ``.log``. Raises if any build fails."""
    paths = {n: library_path(n, flags) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    for n, p in todo.items():
        # A name of this process and thread: two builds of one library,
        # in two processes or two threads, each rename their own file.
        tmp = p.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        log = open(p.with_suffix(".log"), "w")
        procs[n] = (subprocess.Popen(
            [exe, *FLAGS, *flags, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for n, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, todo[n])     # atomic: concurrent builds race safely
        else:
            failed.append(f"{n} (nvcc exit {rc}):\n"
                          + todo[n].with_suffix(".log").read_text())
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return paths


def load(name: str, flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built with the extra
    ``flags``), built if needed."""
    key = (name, tuple(flags))
    lib = _loaded.get(key)
    if lib is None:
        lib = _loaded[key] = ctypes.CDLL(str(build([name], flags)[name]))
    return lib
