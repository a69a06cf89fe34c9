"""Real sequential datasets for the continual-learning scenarios.

Counterpart of ``repro/data/real.py``: the same loaders, offline policy,
checksums, cache directory and builders, a numpy copy whose surrogate
and builders return the reference's arrays bit for bit.

The paper's benchmarks run permuted sequential MNIST (row-by-row, 28
steps × 28 features) and split CIFAR-10 on extracted features; the
synthetic stand-ins in :mod:`repro_torch.data.synthetic` preserve the task
geometry for offline CI. This module adds the real streams behind the
same builder signature, with:

  download + cache   stdlib-only (urllib/gzip/tarfile/pickle), sha256
                     pinned per file — a corrupted or tampered download
                     always raises, it never degrades silently.
  offline policy     ``offline=True`` (or ``REPRO_DATA_OFFLINE=1``)
                     skips the network entirely and serves the
                     deterministic surrogate; ``offline=False`` insists
                     on the real bytes (network failure raises);
                     ``offline=None`` — the default — tries the cache,
                     then the network, then *falls back* to the
                     surrogate with a warning, so CI without egress
                     still runs the full scenario matrix.
  surrogate          a deterministic prototype-pool dataset with the
                     real stream's exact shapes and label space, tagged
                     ``source="surrogate"`` so results can never be
                     mistaken for real-data numbers.

The few-shot keyword stream (:func:`make_keyword_fewshot_tasks`) is
generated, not downloaded: variable-length utterances (ragged T) with
per-task decreasing shot counts (ragged n_train) — the stream that
exercises every axis of the :mod:`repro_torch.data.ragged` padding contract.
"""
from __future__ import annotations

import gzip
import hashlib
import os
import pickle
import tarfile
import urllib.error
import urllib.request
import warnings
from pathlib import Path
from typing import Optional

import numpy as np

from repro_torch.data.synthetic import TaskData

__all__ = ["data_root", "load_mnist", "load_cifar10",
           "make_seq_mnist_tasks", "make_seq_cifar10_tasks",
           "make_keyword_fewshot_tasks"]

_MNIST_BASE = "https://storage.googleapis.com/cvdf-datasets/mnist/"
_MNIST_FILES = {
    "train-images-idx3-ubyte.gz":
        "440fcabf73cc546fa21475e81ea370265605f56be210a4024d2ca8f203523609",
    "train-labels-idx1-ubyte.gz":
        "3552534a0a558bbed6aed32b30c495cca23d567ec52cac8be1a0730e8010255c",
    "t10k-images-idx3-ubyte.gz":
        "8d422c7b0a1c1c79245a5bcf07fe86e33eeafee792b84584aec276f5a2dbc4e6",
    "t10k-labels-idx1-ubyte.gz":
        "f7ae60f92e00ec6debd23a6088c31dbd2371eca3ffa0defaefb259924204aec6",
}
_CIFAR_URL = "https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz"
_CIFAR_SHA256 = \
    "6d958be074577803d12ecdefd02955f39262c83c16fe9348329d7fe0b5c001ce"


def data_root() -> Path:
    """The dataset cache directory: ``$REPRO_DATA_DIR`` or
    ``~/.cache/repro_data``. Created on first use."""
    root = Path(os.environ.get("REPRO_DATA_DIR",
                               Path.home() / ".cache" / "repro_data"))
    root.mkdir(parents=True, exist_ok=True)
    return root


def _env_offline() -> bool:
    return os.environ.get("REPRO_DATA_OFFLINE", "") not in ("", "0")


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _fetch(url: str, sha256: str, dest: Path) -> Path:
    """Return a verified local copy of ``url``, downloading if absent.

    A cached file with the wrong checksum — and a fresh download with
    the wrong checksum — both raise: corruption is never a soft
    failure. Network errors raise ``URLError``/``OSError`` for the
    caller's offline policy to interpret."""
    if dest.exists():
        got = _sha256(dest)
        if got == sha256:
            return dest
        raise ValueError(
            f"checksum mismatch for cached {dest.name}: expected "
            f"{sha256}, got {got}; delete the file to re-download")
    tmp = dest.with_suffix(dest.suffix + ".part")
    with urllib.request.urlopen(url, timeout=60) as r, open(tmp, "wb") as f:
        while True:
            chunk = r.read(1 << 20)
            if not chunk:
                break
            f.write(chunk)
    got = _sha256(tmp)
    if got != sha256:
        tmp.unlink()
        raise ValueError(f"checksum mismatch downloading {url}: expected "
                         f"{sha256}, got {got}")
    tmp.replace(dest)
    return dest


def _surrogate_images(side: int, channels: int, n_classes: int,
                      n_train: int, n_test: int, tag: str
                      ) -> tuple[np.ndarray, np.ndarray,
                                 np.ndarray, np.ndarray]:
    """Deterministic prototype-pool stand-in with the real stream's
    shapes: class prototypes + pixel noise, clipped to [0,1]. Seeded by
    the dataset tag only — every call sees the same pool, like a file
    on disk would be."""
    rng = np.random.default_rng(
        int.from_bytes(hashlib.sha256(tag.encode()).digest()[:8], "big"))
    dim = side * side * channels
    protos = rng.uniform(0.15, 0.85,
                         size=(n_classes, dim)).astype(np.float32)

    def draw(n):
        y = rng.integers(0, n_classes, size=n)
        x = protos[y] + 0.25 * rng.standard_normal((n, dim)).astype(
            np.float32)
        shape = (-1, side, side) if channels == 1 \
            else (-1, side, side, channels)
        return np.clip(x, 0.0, 1.0).reshape(shape), y.astype(np.int32)

    x_tr, y_tr = draw(n_train)
    x_te, y_te = draw(n_test)
    return x_tr, y_tr, x_te, y_te


def _resolve_offline(offline: Optional[bool]) -> Optional[bool]:
    return True if _env_offline() else offline


def _load_real(loader, surrogate, offline: Optional[bool], name: str):
    """Apply the offline policy around a real-data loader."""
    offline = _resolve_offline(offline)
    if offline is True:
        return surrogate() + ("surrogate",)
    try:
        return loader() + ("real",)
    except (urllib.error.URLError, TimeoutError, OSError) as e:
        if offline is False:
            raise
        warnings.warn(
            f"{name} download failed ({e}); serving the deterministic "
            "surrogate dataset (source='surrogate'). Set offline=False "
            "to require real data.", stacklevel=3)
        return surrogate() + ("surrogate",)


def _read_idx_images(path: Path) -> np.ndarray:
    with gzip.open(path, "rb") as f:
        data = f.read()
    n = int.from_bytes(data[4:8], "big")
    rows = int.from_bytes(data[8:12], "big")
    cols = int.from_bytes(data[12:16], "big")
    return np.frombuffer(data, np.uint8, offset=16).reshape(n, rows, cols)


def _read_idx_labels(path: Path) -> np.ndarray:
    with gzip.open(path, "rb") as f:
        data = f.read()
    return np.frombuffer(data, np.uint8, offset=8)


def load_mnist(offline: Optional[bool] = None
               ) -> tuple[np.ndarray, np.ndarray,
                          np.ndarray, np.ndarray, str]:
    """MNIST as float32 [0,1]: ``(x_train (60000,28,28), y_train,
    x_test (10000,28,28), y_test, source)`` where ``source`` is
    ``"real"`` or ``"surrogate"`` (see the module offline policy)."""
    def loader():
        root = data_root() / "mnist"
        root.mkdir(exist_ok=True)
        paths = {name: _fetch(_MNIST_BASE + name, sha, root / name)
                 for name, sha in _MNIST_FILES.items()}
        x_tr = _read_idx_images(paths["train-images-idx3-ubyte.gz"])
        y_tr = _read_idx_labels(paths["train-labels-idx1-ubyte.gz"])
        x_te = _read_idx_images(paths["t10k-images-idx3-ubyte.gz"])
        y_te = _read_idx_labels(paths["t10k-labels-idx1-ubyte.gz"])
        return (x_tr.astype(np.float32) / 255.0, y_tr.astype(np.int32),
                x_te.astype(np.float32) / 255.0, y_te.astype(np.int32))

    def surrogate():
        return _surrogate_images(28, 1, 10, 4096, 1024, "mnist")

    return _load_real(loader, surrogate, offline, "MNIST")


def load_cifar10(offline: Optional[bool] = None
                 ) -> tuple[np.ndarray, np.ndarray,
                            np.ndarray, np.ndarray, str]:
    """CIFAR-10 as float32 [0,1]: ``(x_train (50000,32,32,3), y_train,
    x_test (10000,32,32,3), y_test, source)``."""
    def loader():
        root = data_root()
        tar_path = _fetch(_CIFAR_URL, _CIFAR_SHA256,
                          root / "cifar-10-python.tar.gz")
        xs, ys, xte, yte = [], [], None, None
        with tarfile.open(tar_path, "r:gz") as tar:
            for member in tar.getmembers():
                base = os.path.basename(member.name)
                if base.startswith("data_batch_") or base == "test_batch":
                    d = pickle.load(tar.extractfile(member),
                                    encoding="bytes")
                    x = np.asarray(d[b"data"], np.uint8) \
                        .reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
                    y = np.asarray(d[b"labels"], np.int32)
                    if base == "test_batch":
                        xte, yte = x, y
                    else:
                        xs.append(x)
                        ys.append(y)
        x_tr = np.concatenate(xs)
        y_tr = np.concatenate(ys)
        return (x_tr.astype(np.float32) / 255.0, y_tr,
                xte.astype(np.float32) / 255.0, yte)

    def surrogate():
        return _surrogate_images(32, 3, 10, 4096, 1024, "cifar10")

    return _load_real(loader, surrogate, offline, "CIFAR-10")


def _subsample(rng: np.random.Generator, x: np.ndarray, y: np.ndarray,
               n: int) -> tuple[np.ndarray, np.ndarray]:
    idx = rng.choice(x.shape[0], size=min(n, x.shape[0]), replace=False)
    return x[idx], y[idx]


def make_seq_mnist_tasks(seed: int, n_tasks: int = 5, n_train: int = 1000,
                         n_test: int = 400,
                         offline: Optional[bool] = None) -> list[TaskData]:
    """Permuted *sequential* MNIST on real data: each image is streamed
    row-by-row (28 steps × 28 features) and each task applies a fixed
    random pixel permutation — task 0 is the identity, matching
    :func:`repro_torch.data.synthetic.make_permuted_tasks`' protocol. One
    train/test subsample is drawn per seed and shared by every task, so
    tasks differ only by permutation (the paper's setup)."""
    x_tr, y_tr, x_te, y_te, _src = load_mnist(offline)
    rng = np.random.default_rng(seed)
    x_tr, y_tr = _subsample(rng, x_tr, y_tr, n_train)
    x_te, y_te = _subsample(rng, x_te, y_te, n_test)
    side = x_tr.shape[1]
    dim = side * side
    flat_tr = x_tr.reshape(len(x_tr), dim)
    flat_te = x_te.reshape(len(x_te), dim)
    tasks = []
    for t in range(n_tasks):
        perm = np.arange(dim) if t == 0 else rng.permutation(dim)
        tasks.append(TaskData(
            x_train=flat_tr[:, perm].reshape(-1, side, side),
            y_train=y_tr.copy(),
            x_test=flat_te[:, perm].reshape(-1, side, side),
            y_test=y_te.copy(), task_id=t))
    return tasks


def make_seq_cifar10_tasks(seed: int, n_tasks: int = 5,
                           n_train: int = 1000, n_test: int = 400,
                           offline: Optional[bool] = None
                           ) -> list[TaskData]:
    """Split sequential CIFAR-10 on real data: task t holds classes
    (2t, 2t+1) relabeled to a shared binary head (domain-incremental
    split protocol), each image streamed row-by-row as 32 steps × 96
    features (RGB rows flattened per step)."""
    if n_tasks > 5:
        raise ValueError("split CIFAR-10 supports at most 5 class-pair "
                         f"tasks, got n_tasks={n_tasks}")
    x_tr, y_tr, x_te, y_te, _src = load_cifar10(offline)
    rng = np.random.default_rng(seed)
    tasks = []
    for t in range(n_tasks):
        pair = (2 * t, 2 * t + 1)

        def pick(x, y, n):
            mask = (y == pair[0]) | (y == pair[1])
            xs, ys = _subsample(rng, x[mask], y[mask], n)
            return (xs.reshape(len(xs), 32, 96),
                    (ys == pair[1]).astype(np.int32))

        xtr, ytr = pick(x_tr, y_tr, n_train)
        xte, yte = pick(x_te, y_te, n_test)
        tasks.append(TaskData(xtr, ytr, xte, yte, task_id=t))
    return tasks


def make_keyword_fewshot_tasks(seed: int, n_tasks: int = 4,
                               n_classes: int = 4, feat_dim: int = 20,
                               base_shots: int = 64, n_test: int = 48,
                               min_len: int = 16, max_len: int = 32,
                               n_train: Optional[int] = None,
                               ) -> list[TaskData]:
    """Few-shot continual keyword-spotting-style stream — the ragged
    stress case (on-chip personalization, §VII): task t is "adapt to
    speaker t", with *decreasing* shot counts per task
    (``base_shots // 2**t``, floor 8) and variable utterance lengths in
    [min_len, max_len] — ragged in both n_train and T. Utterances are
    class keyword templates (shared across tasks) plus a per-speaker
    offset, zero-padded to max_len with true lengths recorded, so this
    stream requires a :class:`repro_torch.data.ragged.PadPolicy` to compile.
    Generated deterministically — no download.

    ``n_train`` is the registry's uniform sizing kwarg — an alias for
    ``base_shots`` (task 0's shot count) when given."""
    if n_train is not None:
        base_shots = int(n_train)
    rng = np.random.default_rng(seed)
    templates = rng.uniform(0.2, 0.8,
                            size=(n_classes, max_len, feat_dim)
                            ).astype(np.float32)

    def draw(speaker_delta, n):
        y = rng.integers(0, n_classes, size=n).astype(np.int32)
        lengths = rng.integers(min_len, max_len + 1,
                               size=n).astype(np.int32)
        x = np.zeros((n, max_len, feat_dim), np.float32)
        for i in range(n):
            L = lengths[i]
            # Time-stretch the keyword template to this utterance's
            # own length (nearest-frame resample), then speaker-shift.
            src = np.linspace(0, max_len - 1, L).astype(int)
            utt = templates[y[i]][src] + speaker_delta \
                + 0.08 * rng.standard_normal((L, feat_dim)).astype(
                    np.float32)
            x[i, :L] = np.clip(utt, 0.0, 1.0)
        return x, y, lengths

    tasks = []
    for t in range(n_tasks):
        delta = 0.12 * rng.standard_normal(feat_dim).astype(np.float32)
        shots = max(base_shots // (2 ** t), 8)
        xtr, ytr, ltr = draw(delta, shots)
        xte, yte, lte = draw(delta, n_test)
        tasks.append(TaskData(xtr, ytr, xte, yte, task_id=t,
                              train_lengths=ltr, test_lengths=lte))
    return tasks
