"""Deterministic, restart-safe batch iterator — counterpart of
``repro/data/pipeline.py``.

Batch content is a pure function of (seed, step): any process can
rebuild any step, which is what makes checkpoint/restart correct without
data-loader state transfer. The generator runs on the host in numpy (the
reference's draws, bit for bit); ``device=`` moves each batch there as
tensors, in place of the reference's ``sharding=``. ``shard_tasks``
cuts a task stream into the fleet's per-chip training shards.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.utils import resolve_device


@dataclasses.dataclass
class DataState:
    """The entire pipeline state — one integer. Checkpointable trivially."""
    step: int = 0
    seed: int = 0


def _collate_ragged(rows: Sequence[np.ndarray],
                    pad_to: Optional[int] = None
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Zero-pad a list of (L_i, ...) rows to one (N, L, ...) array plus
    the (N,) int32 true lengths. ``pad_to`` pins the padded length (a
    fixed shape across steps); None pads to the batch max — either way
    the result is a pure function of the rows, so a restored batcher
    re-collates bit-identically."""
    rows = [np.asarray(r) for r in rows]
    lengths = np.array([r.shape[0] for r in rows], np.int32)
    tgt = int(lengths.max()) if pad_to is None else int(pad_to)
    if lengths.max() > tgt:
        raise ValueError(f"ragged row of length {int(lengths.max())} "
                         f"exceeds pad_to={tgt}")
    out = np.zeros((len(rows), tgt) + rows[0].shape[1:], rows[0].dtype)
    for i, r in enumerate(rows):
        out[i, :r.shape[0]] = r
    return out, lengths


class ShardedBatcher:
    """Produces per-step batches deterministically from (seed, step).

    ``gen_fn(rng, step) -> dict[str, np.ndarray]`` builds the global
    batch from ``np.random.default_rng(SeedSequence([seed, step]))``.
    Ragged generator outputs — a key whose value is a *list* of
    unequal-length rows — are collated in :meth:`peek`: zero-padded to
    one array plus a ``{key}_lengths`` companion (``pad_to`` pins the
    padded length). :meth:`next` returns numpy arrays, or with
    ``device`` tensors on that device.
    """

    def __init__(self, gen_fn: Callable[[np.random.Generator, int],
                                        dict[str, np.ndarray]],
                 seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None,
                 pad_to: Optional[int] = None):
        self._gen = gen_fn
        self.state = DataState(step=0, seed=seed)
        self._device = None if device is None else resolve_device(device)
        self._pad_to = pad_to

    def peek(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.state.seed, step]))
        raw = self._gen(rng, step)
        batch: dict[str, np.ndarray] = {}
        for k, v in raw.items():
            if isinstance(v, (list, tuple)):
                batch[k], batch[f"{k}_lengths"] = _collate_ragged(
                    v, self._pad_to)
            else:
                batch[k] = v
        return batch

    def next(self) -> dict[str, Any]:
        batch = self.peek(self.state.step)
        self.state.step += 1
        if self._device is not None:
            batch = {k: torch.as_tensor(np.asarray(v)).to(self._device)
                     for k, v in batch.items()}
        return batch

    # -- checkpoint integration ------------------------------------------
    def state_dict(self) -> dict[str, int]:
        return {"step": self.state.step, "seed": self.state.seed}

    def load_state_dict(self, d: dict[str, int]) -> None:
        self.state = DataState(step=int(d["step"]), seed=int(d["seed"]))


def shard_tasks(tasks, n_shards: int, index: int):
    """Per-chip training shard of a task stream (the fleet's data
    loading): shard ``index`` of ``n_shards`` takes the strided slice
    ``index::n_shards`` of every task's training rows, truncated to
    ``n_train // n_shards`` rows so every shard has one shape. Shards are
    pairwise disjoint; test sets are shared untouched (every chip
    evaluates the full protocol). Needs at least one training row per
    shard."""
    from repro_torch.data.synthetic import TaskData
    if not 0 <= index < n_shards:
        raise ValueError(f"shard index {index} out of range for "
                         f"{n_shards} shards")
    out = []
    for t in tasks:
        n = t.x_train.shape[0] // n_shards
        if n == 0:
            raise ValueError(
                f"task {t.task_id} has {t.x_train.shape[0]} training "
                f"rows — fewer than {n_shards} shards")
        sl = slice(index, index + n * n_shards, n_shards)
        out.append(TaskData(
            x_train=t.x_train[sl], y_train=t.y_train[sl],
            x_test=t.x_test, y_test=t.y_test, task_id=t.task_id,
            train_lengths=(None if t.train_lengths is None
                           else t.train_lengths[sl]),
            test_lengths=t.test_lengths, test_valid=t.test_valid))
    return out
