"""Ragged task streams: the bucketed padding policy and its helpers.

Counterpart of ``repro/data/ragged.py``, a numpy copy that returns the
same arrays bit for bit. A :class:`PadPolicy` lets a task stream be
ragged — unequal example counts, unequal sequence lengths — by padding
it onto one bucketed shape with validity masks: masked loss and metric
reductions, replay insertion gated on valid rows.

Padding comes at two granularities here, each with its own mask:

  time      per-example true lengths (``TaskData.train_lengths`` /
            ``test_lengths``); sequences are zero-padded at the end to
            the bucketed T. The recurrence is causal, so end-padding
            never changes the states at t < length; the readout and the
            DFA error are taken at each row's own last step.
  row       the final partial batch (``last_batch="pad"``) and unequal
            eval sets pad with zero rows marked invalid
            (``row_valid`` on the schedule, ``test_valid`` on the task).

(The reference's compiled sweep also pads the step axis; it is not
ported yet, ROADMAP queue A, ``scenarios/``.)

The contract: with a policy attached but nothing ragged,
``run_continual(pad=)`` runs the exact unmasked program, bit for bit.
The masked program (``force=True`` or real raggedness) multiplies by
exact 0.0/1.0 masks and divides each mean by Σvalid, so on an aligned
stream it agrees with the unmasked one to the last ulp.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.data.synthetic import TaskData

__all__ = ["PadPolicy", "pad_tasks", "bucket_size", "eval_masks",
           "needs_masked_program"]


@dataclasses.dataclass(frozen=True)
class PadPolicy:
    """How a ragged task stream maps onto one compiled shape.

    bucket      "max" pads every axis to the stream's maximum; "pow2"
                rounds the targets up to the next power of two (fewer
                recompiles when streams grow across runs).
    last_batch  what happens to the final partial training batch of a
                task whose ``n_train`` does not divide the batch size:
                "drop" discards it (the historical behavior) and "pad"
                keeps it, zero-padded with the pad rows marked invalid.
    force       build the masked program even when the stream is already
                shape-aligned — the parity-testing knob.
    """
    bucket: str = "max"        # "max" | "pow2"
    last_batch: str = "drop"   # "drop" | "pad"
    force: bool = False

    def __post_init__(self):
        if self.bucket not in ("max", "pow2"):
            raise ValueError(f"unknown bucket mode {self.bucket!r}; "
                             "expected 'max' or 'pow2'")
        if self.last_batch not in ("drop", "pad"):
            raise ValueError(f"unknown last_batch mode {self.last_batch!r}; "
                             "expected 'drop' or 'pad'")


def bucket_size(n: int, mode: str) -> int:
    """The padded target for an axis of true size ``n``."""
    if mode == "max":
        return int(n)
    return 1 << max(0, int(n - 1).bit_length())


def _pad_time(x: np.ndarray, lengths: Optional[np.ndarray], t_tgt: int
              ) -> tuple[np.ndarray, Optional[np.ndarray]]:
    """Zero-pad (N, T, F) to (N, t_tgt, F); propagate true lengths."""
    n, t = x.shape[:2]
    if t == t_tgt:
        return x, (None if lengths is None
                   else np.asarray(lengths, np.int32))
    out = np.zeros((n, t_tgt) + x.shape[2:], x.dtype)
    out[:, :t] = x
    if lengths is None:
        lengths = np.full(n, t, np.int32)
    return out, np.asarray(lengths, np.int32)


def pad_tasks(tasks: list[TaskData], policy: PadPolicy
              ) -> tuple[list[TaskData], bool]:
    """Pad a task stream onto one bucketed (T, n_test) shape.

    Returns ``(padded_tasks, padded)`` where ``padded`` says whether any
    time or eval-row padding was actually applied (or any input task
    already carried lengths/validity masks) — the signal
    the compiled sweep uses to pick the masked
    program. Training-row raggedness (unequal ``n_train``) is handled at
    schedule level, not here.
    """
    t_tgt = bucket_size(max(max(t.x_train.shape[1], t.x_test.shape[1])
                            for t in tasks), policy.bucket)
    ne_tgt = bucket_size(max(t.x_test.shape[0] for t in tasks),
                         policy.bucket)
    padded = False
    out = []
    for t in tasks:
        xtr, ltr = _pad_time(np.asarray(t.x_train), t.train_lengths, t_tgt)
        xte, lte = _pad_time(np.asarray(t.x_test), t.test_lengths, t_tgt)
        yte = np.asarray(t.y_test)
        ne = xte.shape[0]
        valid = (np.asarray(t.test_valid, bool) if t.test_valid is not None
                 else None)
        if ne < ne_tgt:
            pad = ne_tgt - ne
            xte = np.concatenate(
                [xte, np.zeros((pad,) + xte.shape[1:], xte.dtype)])
            yte = np.concatenate([yte, np.zeros(pad, yte.dtype)])
            if valid is None:
                valid = np.ones(ne, bool)
            valid = np.concatenate([valid, np.zeros(pad, bool)])
            if lte is None:
                lte = np.full(ne, t_tgt, np.int32)
            # Pad rows gather h at index 0 — any in-range index works,
            # the row is masked out of the metric.
            lte = np.concatenate([lte, np.ones(pad, np.int32)])
        padded |= (ltr is not None or lte is not None
                   or valid is not None)
        out.append(TaskData(x_train=xtr, y_train=np.asarray(t.y_train),
                            x_test=xte, y_test=yte, task_id=t.task_id,
                            train_lengths=ltr, test_lengths=lte,
                            test_valid=valid))
    return out, bool(padded)


def needs_masked_program(policy: PadPolicy, eval_padded: bool,
                         schedule) -> bool:
    """Whether a padded run must build the masked program: forced, any
    eval padding, any schedule row/length mask, or a ragged step count
    across tasks. False means nothing was actually ragged and the exact
    pre-refactor (unmasked) program runs — the bitwise-identity
    guarantee. One predicate shared by :func:`run_continual` and
    :func:`run_compiled` so the loop and the compiled sweep always make
    the same choice."""
    return bool(policy.force or eval_padded or schedule.has_masks
                or len(set(schedule.steps_per_task)) > 1)


def eval_masks(tasks: list[TaskData]) -> tuple[np.ndarray, np.ndarray]:
    """Stacked eval validity/lengths for the masked program:
    ``(n_tasks, n_test) bool`` and ``(n_tasks, n_test) int32``."""
    valid, length = [], []
    for t in tasks:
        ne, T = t.x_test.shape[:2]
        valid.append(np.ones(ne, bool) if t.test_valid is None
                     else np.asarray(t.test_valid, bool))
        length.append(np.full(ne, T, np.int32) if t.test_lengths is None
                      else np.asarray(t.test_lengths, np.int32))
    return np.stack(valid), np.stack(length)
