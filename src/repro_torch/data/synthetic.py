"""Synthetic datasets with the geometry of the paper's benchmarks —
counterpart of ``repro/data/synthetic.py``, a numpy copy that yields the
same arrays bit for bit.

Permuted-"MNIST": each class c has a prototype image drawn once; examples
are prototype + Gaussian pixel noise, clipped to [0,1]; each *task* applies
a fixed random pixel permutation (the standard permuted-MNIST protocol).
Presented to the RNN row-by-row: 28 time steps × 28 features.

Split-"CIFAR": class prototypes in a 512-d "ResNet-18 feature" space
(the paper extracts features with a pre-trained ResNet-18); tasks are
consecutive class pairs with a shared 2-way output head (domain-incremental
protocol). Features are presented as 16 steps × 32 features.

These preserve the paper's task structure and difficulty knobs (class
overlap via noise scale) without requiring the real datasets offline.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TaskData:
    """One task's train/test split. x: (N, T, F) float32 in [0,1]; y: (N,)

    Ragged streams (unequal sequence length or example count across the
    stream — the reference's ``repro/data/ragged.py``) carry the optional mask
    fields: per-example true sequence lengths for zero-end-padded rows
    (None means every row runs the full T) and the eval validity mask
    for zero-padded test rows that must not enter the metrics. Builders
    of uniform streams leave all three None — the historical contract.
    """
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    task_id: int
    train_lengths: "np.ndarray | None" = None   # (n_train,) int32
    test_lengths: "np.ndarray | None" = None    # (n_test,) int32
    test_valid: "np.ndarray | None" = None      # (n_test,) bool


def _prototype_dataset(rng: np.random.Generator, n_classes: int, dim: int,
                       n_train: int, n_test: int, noise: float,
                       ) -> tuple[np.ndarray, np.ndarray,
                                  np.ndarray, np.ndarray]:
    protos = rng.uniform(0.15, 0.85, size=(n_classes, dim)).astype(np.float32)

    def draw(n):
        y = rng.integers(0, n_classes, size=n)
        x = protos[y] + noise * rng.standard_normal((n, dim)).astype(
            np.float32)
        return np.clip(x, 0.0, 1.0), y.astype(np.int32)

    x_tr, y_tr = draw(n_train)
    x_te, y_te = draw(n_test)
    return x_tr, y_tr, x_te, y_te


def make_permuted_tasks(seed: int, n_tasks: int = 5, n_train: int = 1000,
                        n_test: int = 400, side: int = 28,
                        n_classes: int = 10, noise: float = 0.25,
                        ) -> list[TaskData]:
    """Domain-incremental permuted-pixel task stream (permuted-MNIST
    protocol, §VI-A). Task 0 is the identity permutation."""
    rng = np.random.default_rng(seed)
    dim = side * side
    x_tr, y_tr, x_te, y_te = _prototype_dataset(
        rng, n_classes, dim, n_train, n_test, noise)
    tasks = []
    for t in range(n_tasks):
        perm = np.arange(dim) if t == 0 else rng.permutation(dim)
        xt = x_tr[:, perm].reshape(-1, side, side)
        xe = x_te[:, perm].reshape(-1, side, side)
        tasks.append(TaskData(xt, y_tr, xe, y_te, task_id=t))
    return tasks


def make_split_tasks(seed: int, n_tasks: int = 5, n_train: int = 1000,
                     n_test: int = 400, feat_dim: int = 512,
                     steps: int = 16, noise: float = 0.35,
                     ) -> list[TaskData]:
    """Split protocol over a feature space: task t = classes (2t, 2t+1)
    relabeled to a shared binary head (domain-incremental split CIFAR-10)."""
    rng = np.random.default_rng(seed)
    n_classes = 2 * n_tasks
    protos = rng.standard_normal((n_classes, feat_dim)).astype(np.float32)
    protos = 0.5 + 0.18 * protos
    feat = feat_dim // steps

    def draw(cls_pair, n):
        y = rng.integers(0, 2, size=n)
        cls = np.asarray(cls_pair)[y]
        x = protos[cls] + noise * rng.standard_normal(
            (n, feat_dim)).astype(np.float32)
        x = np.clip(x, 0.0, 1.0)
        return x.reshape(-1, steps, feat), y.astype(np.int32)

    tasks = []
    for t in range(n_tasks):
        pair = (2 * t, 2 * t + 1)
        x_tr, y_tr = draw(pair, n_train)
        x_te, y_te = draw(pair, n_test)
        tasks.append(TaskData(x_tr, y_tr, x_te, y_te, task_id=t))
    return tasks


# ---------------------------------------------------------------------------
# Additional continual-learning streams (the reference's scenarios registry)
# ---------------------------------------------------------------------------

def _rotate_images(x: np.ndarray, angle_deg: float) -> np.ndarray:
    """Bilinear rotation of (N, side, side) images about the center.
    Out-of-frame samples read 0 (background). angle 0 is exact identity."""
    if angle_deg == 0.0:
        return x.copy()
    n, side, _ = x.shape
    th = np.deg2rad(angle_deg)
    c, s = np.cos(th), np.sin(th)
    ctr = (side - 1) / 2.0
    rr, cc = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    src_r = c * (rr - ctr) + s * (cc - ctr) + ctr
    src_c = -s * (rr - ctr) + c * (cc - ctr) + ctr
    r0 = np.floor(src_r).astype(np.int64)
    c0 = np.floor(src_c).astype(np.int64)
    fr = (src_r - r0).astype(np.float32)
    fc = (src_c - c0).astype(np.float32)
    out = np.zeros_like(x)
    for dr, dc, w in ((0, 0, (1 - fr) * (1 - fc)), (0, 1, (1 - fr) * fc),
                      (1, 0, fr * (1 - fc)), (1, 1, fr * fc)):
        r = r0 + dr
        col = c0 + dc
        ok = (r >= 0) & (r < side) & (col >= 0) & (col < side)
        rs = np.clip(r, 0, side - 1)
        cs = np.clip(col, 0, side - 1)
        out += (w * ok) * x[:, rs, cs]
    return out


def make_rotated_tasks(seed: int, n_tasks: int = 5, n_train: int = 1000,
                       n_test: int = 400, side: int = 28,
                       n_classes: int = 10, noise: float = 0.25,
                       max_angle: float = 90.0) -> list[TaskData]:
    """Rotated-image domain-incremental stream: one dataset, task t viewed
    under a rotation of t/(n_tasks-1)·max_angle degrees. Task 0 is the
    unrotated identity view (rotated-MNIST protocol)."""
    rng = np.random.default_rng(seed)
    dim = side * side
    x_tr, y_tr, x_te, y_te = _prototype_dataset(
        rng, n_classes, dim, n_train, n_test, noise)
    x_tr = x_tr.reshape(-1, side, side)
    x_te = x_te.reshape(-1, side, side)
    angles = (np.linspace(0.0, max_angle, n_tasks) if n_tasks > 1
              else np.zeros(1))
    tasks = []
    for t, ang in enumerate(angles):
        tasks.append(TaskData(_rotate_images(x_tr, float(ang)), y_tr,
                              _rotate_images(x_te, float(ang)), y_te,
                              task_id=t))
    return tasks


def make_noisy_label_tasks(seed: int, n_tasks: int = 5, n_train: int = 1000,
                           n_test: int = 400, side: int = 28,
                           n_classes: int = 10, noise: float = 0.25,
                           max_flip: float = 0.4) -> list[TaskData]:
    """Label-noise robustness stream: a fixed domain whose *train* labels
    are corrupted at a rate ramping 0 → max_flip across tasks (flipped
    uniformly to another class). Test labels stay clean, so R[t, i] reads
    how well learning survives increasingly unreliable supervision."""
    rng = np.random.default_rng(seed)
    dim = side * side
    rates = (np.linspace(0.0, max_flip, n_tasks) if n_tasks > 1
             else np.zeros(1))
    protos = rng.uniform(0.15, 0.85, size=(n_classes, dim)).astype(np.float32)

    def draw(n):
        y = rng.integers(0, n_classes, size=n)
        x = protos[y] + noise * rng.standard_normal((n, dim)).astype(
            np.float32)
        return np.clip(x, 0.0, 1.0).reshape(-1, side, side), \
            y.astype(np.int32)

    tasks = []
    for t, rate in enumerate(rates):
        x_tr, y_tr = draw(n_train)
        x_te, y_te = draw(n_test)
        flip = rng.random(n_train) < rate
        shift = rng.integers(1, n_classes, size=n_train).astype(np.int32)
        y_noisy = np.where(flip, (y_tr + shift) % n_classes, y_tr)
        tasks.append(TaskData(x_tr, y_noisy.astype(np.int32), x_te, y_te,
                              task_id=t))
    return tasks


def make_drift_tasks(seed: int, n_tasks: int = 5, n_train: int = 1000,
                     n_test: int = 400, side: int = 28,
                     n_classes: int = 10, noise: float = 0.25
                     ) -> list[TaskData]:
    """Gradual domain drift: class prototypes interpolate linearly from a
    start set to an independently drawn end set across the task sequence —
    task t samples around protos_t = (1−α_t)·A + α_t·B, α_t = t/(n−1).
    Neighboring tasks overlap heavily; distant tasks do not."""
    rng = np.random.default_rng(seed)
    dim = side * side
    protos_a = rng.uniform(0.15, 0.85, (n_classes, dim)).astype(np.float32)
    protos_b = rng.uniform(0.15, 0.85, (n_classes, dim)).astype(np.float32)
    alphas = (np.linspace(0.0, 1.0, n_tasks) if n_tasks > 1
              else np.zeros(1))

    tasks = []
    for t, a in enumerate(alphas):
        protos = ((1.0 - a) * protos_a + a * protos_b).astype(np.float32)

        def draw(n):
            y = rng.integers(0, n_classes, size=n)
            x = protos[y] + noise * rng.standard_normal((n, dim)).astype(
                np.float32)
            return np.clip(x, 0.0, 1.0).reshape(-1, side, side), \
                y.astype(np.int32)

        x_tr, y_tr = draw(n_train)
        x_te, y_te = draw(n_test)
        tasks.append(TaskData(x_tr, y_tr, x_te, y_te, task_id=t))
    return tasks


def make_class_incremental_tasks(seed: int, n_tasks: int = 5,
                                 n_train: int = 1000, n_test: int = 400,
                                 side: int = 28, classes_per_task: int = 2,
                                 noise: float = 0.25,
                                 imbalance: float = 1.0) -> list[TaskData]:
    """Class-incremental stream with a (logically) expanding head: task t
    introduces classes [t·c, (t+1)·c) with *global* labels over the full
    n_tasks·c-way output. The model allocates the full head up front (the
    standard compiled-friendly realization of head expansion — unseen
    logits just stay untrained), so shapes are scan-uniform.

    ``imbalance`` > 1 makes the stream class-imbalanced: task t carries
    ``n_train · imbalance^t`` train examples (test sets stay equal), so
    late classes flood any frequency-weighted rehearsal buffer — the
    regime where the *choice* of replay policy governs forgetting
    (class-balanced reservoirs keep early classes represented). Note an
    imbalanced stream is no longer shape-uniform, so the compiled
    scan-over-tasks falls back to the per-task loop."""
    rng = np.random.default_rng(seed)
    dim = side * side
    n_classes = classes_per_task * n_tasks
    protos = rng.uniform(0.15, 0.85, (n_classes, dim)).astype(np.float32)

    tasks = []
    for t in range(n_tasks):
        lo = t * classes_per_task

        def draw(n):
            y = lo + rng.integers(0, classes_per_task, size=n)
            x = protos[y] + noise * rng.standard_normal((n, dim)).astype(
                np.float32)
            return np.clip(x, 0.0, 1.0).reshape(-1, side, side), \
                y.astype(np.int32)

        x_tr, y_tr = draw(int(round(n_train * imbalance ** t)))
        x_te, y_te = draw(n_test)
        tasks.append(TaskData(x_tr, y_tr, x_te, y_te, task_id=t))
    return tasks


def make_streaming_tasks(seed: int, n_tasks: int = 6, n_train: int = 256,
                         n_test: int = 128, side: int = 28,
                         n_classes: int = 10, noise: float = 0.25
                         ) -> list[TaskData]:
    """Online single-pass streaming regime: a continuous example stream
    chopped into ``n_tasks`` segments, each under a fresh pixel
    permutation. Every batch is a pure function of (seed, step) — built
    through one numpy generator per (seed, step), as the reference's
    ``ShardedBatcher`` draws them — so any segment
    is restart-safe and bit-reproducible. The scenario registry marks this
    stream single-pass: the sweep trains one epoch per segment regardless
    of the trainer's ``epochs_per_task``."""
    rng = np.random.default_rng(seed)
    dim = side * side
    protos = rng.uniform(0.15, 0.85, (n_classes, dim)).astype(np.float32)
    perms = np.stack([np.arange(dim)] + [rng.permutation(dim)
                                         for _ in range(n_tasks - 1)])
    chunk = 64
    steps_train = -(-n_train // chunk)          # ceil
    steps_test = -(-n_test // chunk)
    steps_per_seg = steps_train + steps_test

    def gen(step_rng: np.random.Generator, step: int
            ) -> dict[str, np.ndarray]:
        seg = step // steps_per_seg
        y = step_rng.integers(0, n_classes, size=chunk)
        x = protos[y] + noise * step_rng.standard_normal(
            (chunk, dim)).astype(np.float32)
        x = np.clip(x, 0.0, 1.0)[:, perms[seg]]
        return {"x": x.reshape(-1, side, side), "y": y.astype(np.int32)}

    def peek(step: int) -> dict[str, np.ndarray]:
        # The reference's ShardedBatcher.peek: one generator per step.
        return gen(np.random.default_rng(
            np.random.SeedSequence([seed, step])), step)

    tasks = []
    for t in range(n_tasks):
        base = t * steps_per_seg
        tr = [peek(base + i) for i in range(steps_train)]
        te = [peek(base + steps_train + i) for i in range(steps_test)]
        x_tr = np.concatenate([b["x"] for b in tr])[:n_train]
        y_tr = np.concatenate([b["y"] for b in tr])[:n_train]
        x_te = np.concatenate([b["x"] for b in te])[:n_test]
        y_te = np.concatenate([b["y"] for b in te])[:n_test]
        tasks.append(TaskData(x_tr, y_tr, x_te, y_te, task_id=t))
    return tasks


# ---------------------------------------------------------------------------
# LM token streams (for the architecture zoo / trainer)
# ---------------------------------------------------------------------------

def lm_token_batch(rng: np.random.Generator, batch: int, seq_len: int,
                   vocab: int) -> dict[str, np.ndarray]:
    """Markov-ish synthetic token batch: order-1 structure so the LM loss
    actually decreases (pure uniform tokens give a flat loss surface)."""
    # Low-rank transition structure: token t+1 ~ f(token t) + noise.
    base = rng.integers(0, vocab, size=(batch, 1))
    drift = rng.integers(-7, 8, size=(batch, seq_len))
    toks = (np.cumsum(drift, axis=1) + base) % vocab
    noise_mask = rng.random((batch, seq_len)) < 0.1
    noise = rng.integers(0, vocab, size=(batch, seq_len))
    toks = np.where(noise_mask, noise, toks)
    tokens = toks.astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    mask = np.ones_like(tokens, dtype=np.float32)
    mask[:, -1] = 0.0
    return {"tokens": tokens, "labels": labels, "mask": mask}
