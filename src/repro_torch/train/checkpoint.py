"""Atomic, async checkpointing — counterpart of
``repro/train/checkpoint.py``, with the reference's on-disk layout:

  * Step-atomic: write to ``step_N.tmp/``, fsync, rename to ``step_N/`` —
    a crash mid-save never corrupts the latest checkpoint; the ``keep``
    newest steps stay.
  * ``arrays.npz`` holds one logical array per leaf, keyed by its path
    in the tree with ``/`` written ``__``; ``manifest.json`` records the
    step, keys, shapes, dtypes and the caller's ``extra`` (the data
    pipeline's state).
  * Async: ``save_async`` copies the tree to host memory synchronously
    and writes in a background thread.

So a float32 checkpoint written by the reference restores here, optimizer
state included (``AdamState`` and ``chain`` flatten to the same paths).
bf16 leaves go to disk as their uint16 bits with ``"bfloat16"`` in the
manifest's dtypes (numpy has no bfloat16, and the port does not depend on
``ml_dtypes``); a reference bf16 checkpoint, whose leaves numpy holds as
opaque 2-byte voids, is refused with an error. ``restore(device=)``
places the leaves on a device, where the reference takes ``shardings=``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch.analog.endurance import EnduranceTracker
from repro_torch.utils import flatten_dict, unflatten_dict

PyTree = Any


class CheckpointManager:
    def __init__(self, directory: Union[str, os.PathLike], keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    # Save
    # ------------------------------------------------------------------
    def save(self, step: int, tree: PyTree,
             extra: Optional[dict] = None) -> Path:
        """Synchronous atomic save."""
        flat, dtypes = self._to_host(tree)
        return self._write(step, flat, dtypes, extra or {})

    def save_async(self, step: int, tree: PyTree,
                   extra: Optional[dict] = None) -> None:
        """Snapshot now, write in the background."""
        self.wait()
        flat, dtypes = self._to_host(tree)  # device→host copy happens here

        def work():
            self._write(step, flat, dtypes, extra or {})

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    @staticmethod
    def _to_host(tree: PyTree) -> tuple[dict[str, np.ndarray],
                                        dict[str, str]]:
        """{path: numpy array} and {path: dtype name}; bf16 tensors as
        their uint16 bits, named "bfloat16"."""
        flat, dtypes = {}, {}
        for k, v in flatten_dict(_as_dict(tree)).items():
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu()
                if v.dtype == torch.bfloat16:
                    flat[k] = v.view(torch.int16).numpy().view(np.uint16)
                    dtypes[k] = "bfloat16"
                    continue
                v = v.numpy()
            flat[k] = np.asarray(v)
            dtypes[k] = str(flat[k].dtype)
        return flat, dtypes

    def _write(self, step: int, flat: dict[str, np.ndarray],
               dtypes: dict[str, str], extra: dict) -> Path:
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **{k.replace("/", "__"): v
                                        for k, v in flat.items()})
        manifest = {
            "step": step,
            "keys": sorted(flat.keys()),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": dtypes,
            "extra": extra,
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        # fsync the directory entry before the atomic rename.
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ------------------------------------------------------------------
    # Restore
    # ------------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for d in self.dir.glob("step_*"):
            if d.is_dir() and not d.name.endswith(".tmp"):
                try:
                    out.append(int(d.name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None,
                device: Optional[Union[str, torch.device]] = None
                ) -> tuple[int, dict, dict]:
        """Returns (step, tree, extra): the numeric leaves as tensors (on
        ``device``, else the CPU), tagged subtrees revived (the endurance
        tracker)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        dtypes = manifest.get("dtypes", {})
        npz = np.load(d / "arrays.npz")
        flat = {}
        for key in npz.files:
            path = key.replace("__", "/")
            flat[path] = _from_disk(npz[key], dtypes.get(path), path, d)
        tree = _revive(unflatten_dict(flat))
        return manifest["step"], _to_tensors(tree, device), \
            manifest.get("extra", {})


def _from_disk(a: np.ndarray, dtype: Optional[str], path: str, d: Path):
    if dtype != "bfloat16":
        return a
    if a.dtype != np.uint16:
        raise ValueError(
            f"{d}: leaf {path!r} is bfloat16 stored as {a.dtype} — a "
            "checkpoint written by the JAX reference (ml_dtypes' bfloat16). "
            "This package stores bf16 leaves as their uint16 bits; restore "
            "float32 checkpoints from the reference, or convert this one")
    return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)


def _to_tensors(tree, device):
    """Numeric numpy leaves as tensors on ``device`` (default the CPU)."""
    if isinstance(tree, dict):
        return {k: _to_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.dtype.kind in "biuf":
        tree = torch.from_numpy(np.array(tree, copy=True))
    if isinstance(tree, torch.Tensor) and device is not None:
        tree = tree.to(device)
    return tree


def _as_dict(tree: PyTree) -> dict:
    """Convert NamedTuples / tuples / lists in a tree to plain dicts for
    path-stable serialization (the reference's paths). Host-side objects
    that serialize themselves (the endurance tracker — so lifetime
    projections survive restarts) are converted via ``state_dict`` and
    revived by :func:`_revive` on restore."""
    if isinstance(tree, EnduranceTracker):
        return _as_dict(tree.state_dict())
    if isinstance(tree, dict):
        return {str(k): _as_dict(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: _as_dict(v) for f, v in zip(tree._fields, tree)}
    if isinstance(tree, (list, tuple)):
        return {str(i): _as_dict(v) for i, v in enumerate(tree)}
    return tree


def _revive(tree):
    """Inverse of the ``_as_dict`` type conversions: rebuild tagged
    subtrees (``_tree_type_`` sentinel) into their host-side objects."""
    if isinstance(tree, dict):
        tag = tree.get("_tree_type_")
        if tag is not None and str(np.asarray(tag)) == \
                EnduranceTracker.TYPE_TAG:
            return EnduranceTracker.from_state_dict(tree)
        return {k: _revive(v) for k, v in tree.items()}
    return tree


def cast_like(loaded: dict, like: PyTree) -> PyTree:
    """A restored tree ``loaded`` (nested dicts on the paths of
    :func:`_as_dict`) in the structure, dtypes and devices of the live
    tree ``like`` — tuples and NamedTuples rebuilt — leaf by leaf on the
    checkpoint's paths; raises unless both hold the same leaves."""
    flat = flatten_dict(loaded)
    want = flatten_dict(_as_dict(like))
    if set(flat) != set(want):
        raise ValueError(f"checkpoint leaves {sorted(set(flat) ^ set(want))} "
                         "do not match the live tree")
    return _rebuild(flat, like, "")


def _rebuild(flat: dict, like: PyTree, prefix: str) -> PyTree:
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if isinstance(like, dict):
        return {k: _rebuild(flat, v, join(k)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        named = hasattr(like, "_fields")
        names = like._fields if named else [str(i) for i in range(len(like))]
        out = [_rebuild(flat, v, join(n)) for n, v in zip(names, like)]
        return type(like)(*out) if named else type(like)(out)
    return torch.as_tensor(flat[prefix]).to(device=like.device,
                                            dtype=like.dtype)
