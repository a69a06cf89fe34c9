"""The padded ragged path and the offline real-data streams in the port
against the reference.

* ``data/ragged.py``: ``PadPolicy``, ``bucket_size``, ``pad_tasks``,
  ``needs_masked_program`` and ``eval_masks`` bit-equal to the
  reference's on the same ``TaskData``;
* ``build_batch_schedule(pad=)``: x, y, row masks, lengths, occupancy,
  traffic and digest bit-equal, in both ``last_batch`` modes;
* inside the port, the reference's contracts (``tests/test_ragged_data.py``):
  a ``PadPolicy`` on an aligned stream runs the unmasked program bit for
  bit; a forced masked program agrees with it to float32 ulp level;
* masked ragged runs against the reference's ``run_continual(pad=)``, R
  within 2 test examples an entry;
* ``data/real.py`` on its offline surrogate: the loaders and the three
  builders bit-equal to the reference's, the ``REPRO_DATA_OFFLINE`` pin,
  and the checksum rule of the cache (files in ``tmp_path``; nothing here
  reaches the network).
"""
import hashlib
import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core.miru import MiRUConfig as JMiRUConfig  # noqa: E402
from repro.data import ragged as jragged  # noqa: E402
from repro.data import real as jreal  # noqa: E402
from repro.data.synthetic import TaskData as JTaskData  # noqa: E402
from repro.data.synthetic import make_permuted_tasks as jtasks  # noqa: E402
from repro_torch.core import continual  # noqa: E402
from repro_torch.core.miru import MiRUConfig  # noqa: E402
from repro_torch.data import ragged, real  # noqa: E402
from repro_torch.data.synthetic import TaskData  # noqa: E402
from repro_torch.data.synthetic import make_permuted_tasks  # noqa: E402

jcontinual = importlib.import_module("repro.core.continual")

FIELDS = ("x_train", "y_train", "x_test", "y_test", "train_lengths",
          "test_lengths", "test_valid")


def _ragged_arrays(seed=0, t_max=12, f=6, n_cls=4,
                   sizes=((48, 24), (36, 20), (28, 24))):
    """tests/test_ragged_data.py's stream, ragged in n_train, n_test and
    per-example length, as (x_tr, y_tr, x_te, y_te, l_tr, l_te) arrays."""
    rng = np.random.default_rng(seed)
    out = []
    for ntr, nte in sizes:
        def draw(n):
            x = rng.uniform(0, 1, size=(n, t_max, f)).astype(np.float32)
            y = rng.integers(0, n_cls, size=n).astype(np.int32)
            L = rng.integers(t_max // 2, t_max + 1, size=n).astype(np.int32)
            for i in range(n):
                x[i, L[i]:] = 0.0
            return x, y, L
        xtr, ytr, ltr = draw(ntr)
        xte, yte, lte = draw(nte)
        out.append((xtr, ytr, xte, yte, ltr, lte))
    return out


def _both(arrays):
    """The same arrays as the port's and the reference's TaskData."""
    def mk(cls):
        return [cls(a[0].copy(), a[1].copy(), a[2].copy(), a[3].copy(),
                    task_id=i, train_lengths=a[4].copy(),
                    test_lengths=a[5].copy())
                for i, a in enumerate(arrays)]
    return mk(TaskData), mk(JTaskData)


def _tasks_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.task_id == b.task_id
        for f in FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert np.asarray(x).dtype == np.asarray(y).dtype, f
                np.testing.assert_array_equal(x, y, err_msg=f)


# ---------------------------------------------------------------------------
# The helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 28, 32, 33, 100])
@pytest.mark.parametrize("mode", ["max", "pow2"])
def test_bucket_size_equals_the_reference(n, mode):
    assert ragged.bucket_size(n, mode) == jragged.bucket_size(n, mode)


def test_pad_policy_validates_modes():
    with pytest.raises(ValueError, match="bucket"):
        ragged.PadPolicy(bucket="median")
    with pytest.raises(ValueError, match="last_batch"):
        ragged.PadPolicy(last_batch="wrap")


@pytest.mark.parametrize("bucket", ["max", "pow2"])
@pytest.mark.parametrize("stream", ["ragged", "aligned"])
def test_pad_tasks_and_eval_masks_equal_the_reference(bucket, stream):
    if stream == "ragged":
        tasks, jt = _both(_ragged_arrays())
    else:
        kw = dict(n_tasks=2, n_train=32, n_test=16, side=8)
        tasks, jt = make_permuted_tasks(0, **kw), jtasks(0, **kw)
    got, padded = ragged.pad_tasks(tasks, ragged.PadPolicy(bucket=bucket))
    want, jpadded = jragged.pad_tasks(jt, jragged.PadPolicy(bucket=bucket))
    assert padded == jpadded == (stream == "ragged")
    _tasks_equal(got, want)
    for a, b in zip(ragged.eval_masks(got), jragged.eval_masks(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _schedules(tasks, jt, pad, policy=None, ratio=0.5, algo="dfa"):
    kw = dict(algo=algo, epochs_per_task=2, batch_size=16, seed=3)
    rkw = dict(capacity=24, ratio=ratio, policy=policy)
    got = continual.build_batch_schedule(
        continual.TrainerSpec(**kw), continual.ReplaySpec(**rkw), tasks,
        pad=None if pad is None else ragged.PadPolicy(**pad))
    want = jcontinual.build_batch_schedule(
        jcontinual.TrainerSpec(**kw), jcontinual.ReplaySpec(**rkw), jt,
        pad=None if pad is None else jragged.PadPolicy(**pad))
    return got, want


@pytest.mark.parametrize("policy", [None, "class_balanced", "loss_aware"])
@pytest.mark.parametrize("last_batch", ["drop", "pad"])
def test_padded_schedule_is_bitwise_the_reference(last_batch, policy):
    tasks, jt = _both(_ragged_arrays())
    pad = dict(last_batch=last_batch)
    tasks, _ = ragged.pad_tasks(tasks, ragged.PadPolicy(**pad))
    jt, _ = jragged.pad_tasks(jt, jragged.PadPolicy(**pad))
    got, want = _schedules(tasks, jt, pad, policy)
    assert got.steps_per_task == want.steps_per_task
    for a, b in zip(got.x + got.y + got.occupancy + got.row_valid
                    + got.lengths,
                    want.x + want.y + want.occupancy + want.row_valid
                    + want.lengths):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got.replay_traffic == want.replay_traffic
    assert got.digest() == want.digest()
    assert got.has_masks == want.has_masks
    assert ragged.needs_masked_program(
        ragged.PadPolicy(**pad), False, got) == \
        jragged.needs_masked_program(jragged.PadPolicy(**pad), False, want)
    if last_batch == "pad":
        assert not all(rv.all() for rv in got.row_valid)


@pytest.mark.parametrize("pad", [None, {}, {"force": True}])
def test_aligned_schedule_with_a_policy_is_the_default_build(pad):
    """A PadPolicy on an aligned stream emits the default stream byte for
    byte (masks aside), on both sides; the digest folds the masks in."""
    kw = dict(n_tasks=2, n_train=48, n_test=16, side=8)
    tasks, jt = make_permuted_tasks(0, **kw), jtasks(0, **kw)
    got, want = _schedules(tasks, jt, pad)
    base, _ = _schedules(tasks, jt, None)
    for a, b, c in zip(got.x + got.y, want.x + want.y, base.x + base.y):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert got.digest() == want.digest()
    assert (got.digest() == base.digest()) == (pad is None)
    assert not got.has_masks
    if pad is not None:
        assert ragged.needs_masked_program(
            ragged.PadPolicy(**pad), False, got) == bool(pad)


def test_loss_aware_schedule_is_fresh_only():
    kw = dict(n_tasks=2, n_train=48, n_test=16, side=8)
    tasks, jt = make_permuted_tasks(0, **kw), jtasks(0, **kw)
    got, want = _schedules(tasks, jt, None, policy="loss_aware")
    base, _ = _schedules(tasks, jt, None, ratio=0.0)
    for a, b, c in zip(got.x + got.y, want.x + want.y, base.x + base.y):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert got.replay_traffic == want.replay_traffic == {}


# ---------------------------------------------------------------------------
# The pad contracts inside the port
# ---------------------------------------------------------------------------

def _aligned_run(algo, pad, device="ideal"):
    tasks = make_permuted_tasks(0, n_tasks=2, n_train=64, n_test=48)
    cfg = MiRUConfig(n_x=28, n_h=24, n_y=10)
    tr = continual.TrainerSpec(algo=algo, epochs_per_task=1, batch_size=32)
    return continual.run_continual(cfg, tr, tasks,
                                   continual.ReplaySpec(capacity=48),
                                   device, pad=pad, torch_device="cpu")


@pytest.mark.parametrize("algo", ["dfa", "adam"])
def test_pad_attached_but_aligned_is_bitwise_identical(algo):
    base = _aligned_run(algo, None)
    pad = _aligned_run(algo, ragged.PadPolicy(last_batch="drop"))
    np.testing.assert_array_equal(base["R"], pad["R"])
    assert base["losses"] == pad["losses"]
    for k in base["params"]:
        assert torch.equal(base["params"][k], pad["params"][k]), k


@pytest.mark.parametrize("algo", ["dfa", "adam"])
def test_forced_masked_program_matches_within_ulp(algo):
    base = _aligned_run(algo, None)
    forced = _aligned_run(algo, ragged.PadPolicy(force=True))
    np.testing.assert_allclose(forced["R"], base["R"], atol=1e-6)
    np.testing.assert_allclose(forced["losses"], base["losses"],
                               rtol=2e-5, atol=1e-6)
    for k in base["params"]:
        np.testing.assert_allclose(forced["params"][k].numpy(),
                                   base["params"][k].numpy(),
                                   rtol=2e-5, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# Masked ragged runs against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ["dfa", "adam"])
@pytest.mark.parametrize("last_batch", ["pad", "drop"])
@pytest.mark.parametrize("device", ["ideal", "wbs"])
def test_masked_ragged_run_matches_the_reference(algo, last_batch, device):
    tasks, jt = _both(_ragged_arrays(sizes=((48, 24), (40, 20))))
    cfg, jcfg = (MiRUConfig(n_x=6, n_h=16, n_y=4),
                 JMiRUConfig(n_x=6, n_h=16, n_y=4))
    kw = dict(algo=algo, epochs_per_task=2, batch_size=16, seed=0)
    got = continual.run_continual(
        cfg, continual.TrainerSpec(**kw), tasks,
        continual.ReplaySpec(capacity=32), device,
        pad=ragged.PadPolicy(last_batch=last_batch), torch_device="cpu")
    want = jcontinual.run_continual(
        jcfg, jcontinual.TrainerSpec(**kw), jt,
        jcontinual.ReplaySpec(capacity=32), device,
        pad=jragged.PadPolicy(last_batch=last_batch))
    R, jR = got["R"], np.asarray(want["R"])
    assert np.abs(R - jR).max() <= 2 / 24 + 1e-9, (R, jR)
    assert len(got["losses"]) == len(want["losses"])
    np.testing.assert_allclose(got["losses"][:3], want["losses"][:3],
                               rtol=1e-4, atol=1e-5)


def test_keyword_stream_runs_masked_and_pad_is_required():
    tasks = real.make_keyword_fewshot_tasks(0, n_tasks=2, base_shots=24,
                                            n_test=16, feat_dim=6,
                                            min_len=6, max_len=10)
    cfg = MiRUConfig(n_x=6, n_h=16, n_y=4)
    tr = continual.TrainerSpec(epochs_per_task=1, batch_size=8)
    out = continual.run_continual(cfg, tr, tasks,
                                  continual.ReplaySpec(capacity=16), "wbs",
                                  pad=ragged.PadPolicy(), torch_device="cpu")
    assert out["R"].shape == (2, 2) and np.isfinite(out["losses"]).all()
    with pytest.raises(ValueError, match="in-graph"):
        continual.run_continual(
            cfg, tr, tasks, continual.ReplaySpec(policy="loss_aware"),
            pad=ragged.PadPolicy(), torch_device="cpu")


# ---------------------------------------------------------------------------
# data/real.py on its offline surrogate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loader", ["load_mnist", "load_cifar10"])
def test_offline_surrogates_equal_the_reference(loader):
    got = getattr(real, loader)(offline=True)
    want = getattr(jreal, loader)(offline=True)
    assert got[-1] == want[-1] == "surrogate"
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("builder,kw", [
    ("make_seq_mnist_tasks", dict(n_tasks=2, n_train=64, n_test=32,
                                  offline=True)),
    ("make_seq_cifar10_tasks", dict(n_tasks=2, n_train=64, n_test=32,
                                    offline=True)),
    ("make_keyword_fewshot_tasks", dict(n_tasks=3)),
    ("make_keyword_fewshot_tasks", dict(n_tasks=2, n_train=20, n_test=12,
                                        min_len=4, max_len=9))])
def test_builders_equal_the_reference(builder, kw):
    _tasks_equal(getattr(real, builder)(1, **kw),
                 getattr(jreal, builder)(1, **kw))


def test_offline_env_pins_the_surrogate(monkeypatch, tmp_path):
    """``REPRO_DATA_OFFLINE=1`` serves the surrogate whatever ``offline``
    says, as in the reference; ``$REPRO_DATA_DIR`` is the cache."""
    monkeypatch.setenv("REPRO_DATA_OFFLINE", "1")
    monkeypatch.setenv("REPRO_DATA_DIR", str(tmp_path / "cache"))
    for offline in (None, False):
        assert real.load_mnist(offline)[-1] == "surrogate"
        assert jreal.load_mnist(offline)[-1] == "surrogate"
    assert real.data_root() == tmp_path / "cache"
    assert real.data_root().is_dir()
    with pytest.raises(ValueError, match="at most 5"):
        real.make_seq_cifar10_tasks(0, n_tasks=6, offline=True)


def test_fetch_serves_a_verified_cache_and_refuses_a_bad_one(tmp_path):
    """A cached file with the right sha256 is served without a download;
    one with the wrong sha256 raises (never a soft failure)."""
    dest = tmp_path / "file.gz"
    dest.write_bytes(b"cached bytes")
    sha = hashlib.sha256(b"cached bytes").hexdigest()
    url = "http://localhost:9/never-fetched"
    assert real._fetch(url, sha, dest) == dest
    assert real._sha256(dest) == jreal._sha256(dest) == sha
    with pytest.raises(ValueError, match="checksum mismatch"):
        real._fetch(url, "0" * 64, dest)
    assert real._MNIST_FILES == jreal._MNIST_FILES
    assert real._CIFAR_SHA256 == jreal._CIFAR_SHA256
