"""``loss_aware`` replay in the port against the reference: the
device-resident buffer (``replay/ingraph.py``), ``prng.categorical``,
and ``run_continual``'s in-graph branch.

The buffer's operations are pure functions of (state, key, inputs), so
they are held to the reference's on identical inputs: labels, sizes and
priorities exactly, feature codes bit for bit (the same quantizer on the
same keys). The rehearsal draw is the Gumbel-max ``categorical``; its
logs may differ from XLA's CPU logs by an ulp, so a draw is compared
wherever its top two candidates (logits + Gumbel noise, the port's own)
lie more than :data:`MARGIN` apart — a tie closer than that can fall
either way. The Gumbel noise itself lies within 5e-7 of jax's.

Whole runs depend on float CE priorities and are held to bands: R within
2 test examples of the reference's on a permuted stream, and the
reference's class-incremental gate (``loss_aware`` within 0.10 of
``class_balanced``, ``tests/test_replay_policies.py``) at n_h 100.
"""
import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import replay as jreplay  # noqa: E402
from repro.core.miru import MiRUConfig as JMiRUConfig  # noqa: E402
from repro.data.synthetic import make_permuted_tasks as jtasks  # noqa: E402
from repro.scenarios import build_scenario  # noqa: E402
from repro_torch import prng, replay  # noqa: E402
from repro_torch.backends import get_backend  # noqa: E402
from repro_torch.core import continual  # noqa: E402
from repro_torch.core.miru import MiRUConfig  # noqa: E402
from repro_torch.data.synthetic import TaskData  # noqa: E402
from repro_torch.data.synthetic import make_permuted_tasks  # noqa: E402
from repro_torch.replay import ingraph  # noqa: E402
from repro_torch.telemetry import meters  # noqa: E402

jcontinual = importlib.import_module("repro.core.continual")

MARGIN = 1e-5          # top-two gap below which a Gumbel-max draw is a tie
BITS, SHAPE = 4, (3, 5)


def _jstate(st):
    return {k: jnp.asarray(v.numpy()) for k, v in st.items()}


def _state_equal(got, want):
    assert set(got) == set(want)
    for k in got:
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=k)


def _margins(key, logits: np.ndarray, shape) -> np.ndarray:
    """Top-two gap of logits + Gumbel noise for each draw (the port's)."""
    z = prng.gumbel_np(key, tuple(shape) + logits.shape) + logits
    top2 = np.sort(z, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


# ---------------------------------------------------------------------------
# prng.categorical
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,kind", [(8, "uniform"), (64, "skewed"),
                                    (512, "masked")])
def test_categorical_equals_jax_away_from_ties(n, kind):
    """20 keys × 512 draws (10,240) against ``jax.random.categorical``;
    every draw whose top-two margin exceeds MARGIN agrees."""
    rng = np.random.default_rng(n)
    if kind == "uniform":
        logits = np.zeros(n, np.float32)
    else:
        logits = np.log(rng.uniform(1e-3, 1, n)).astype(np.float32)
    if kind == "masked":
        logits[rng.uniform(size=n) < 0.5] = -np.inf
    compared = 0
    for s in range(20):
        key = jax.random.PRNGKey(s)
        want = np.asarray(jax.random.categorical(key, jnp.asarray(logits),
                                                 shape=(512,)))
        got = prng.categorical(np.asarray(key), torch.from_numpy(logits),
                               (512,)).numpy()
        clear = _margins(np.asarray(key), logits, (512,)) > MARGIN
        np.testing.assert_array_equal(got[clear], want[clear])
        compared += int(clear.sum())
    assert compared >= 10_000 * 0.99


def test_gumbel_noise_within_half_a_micro_of_jax():
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.random.gumbel(key, (64, 512)))
    got = prng.gumbel_np(np.asarray(key), (64, 512))
    assert np.abs(got - want).max() <= 5e-7


def test_fold_in_over_an_array_is_vmapped_fold_in():
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.vmap(lambda i: jax.random.fold_in(key, i))(
        jnp.arange(40)))
    np.testing.assert_array_equal(prng.fold_in(np.asarray(key),
                                               np.arange(40)), want)
    np.testing.assert_array_equal(prng.fold_in(np.asarray(key), 7),
                                  np.asarray(jax.random.fold_in(key, 7)))


# ---------------------------------------------------------------------------
# The buffer's operations
# ---------------------------------------------------------------------------

def test_init_equals_the_reference():
    got = ingraph.ingraph_init(8, SHAPE, BITS)
    want = jreplay.ingraph_init(8, SHAPE, BITS)
    for k in got:
        assert got[k].shape == want[k].shape
    assert got["feat"].dtype == torch.uint8 and got["size"].ndim == 0
    _state_equal(got, want)


def _offers(seed, rounds, B, n_classes):
    rng = np.random.default_rng(seed)
    for r in range(rounds):
        xs = rng.uniform(0, 1, (B,) + SHAPE).astype(np.float32)
        ys = rng.integers(0, n_classes, B).astype(np.int32)
        pr = rng.exponential(1.0, B).astype(np.float32)
        valid = rng.uniform(size=B) < 0.8
        yield r, xs, ys, pr, valid


@pytest.mark.parametrize("n_classes", [None, 4])
@pytest.mark.parametrize("decay", [1.0, 0.9])
def test_insert_equals_the_reference(n_classes, decay):
    """Fill, then evict (global or class-aware), with valid masks and
    decay: labels, sizes, priorities and codes exactly, round by
    round."""
    C = 12
    st = ingraph.ingraph_init(C, SHAPE, BITS)
    jst = jreplay.ingraph_init(C, SHAPE, BITS)
    for r, xs, ys, pr, valid in _offers(5, 6, 7, 4):
        key = jax.random.PRNGKey(100 + r)
        st = ingraph.ingraph_insert(st, np.asarray(key), torch.from_numpy(xs),
                                    torch.from_numpy(ys),
                                    torch.from_numpy(pr), BITS,
                                    valid=torch.from_numpy(valid),
                                    decay=decay, n_classes=n_classes)
        jst = jreplay.ingraph_insert(jst, key, jnp.asarray(xs),
                                     jnp.asarray(ys), jnp.asarray(pr), BITS,
                                     valid=jnp.asarray(valid), decay=decay,
                                     n_classes=n_classes)
        _state_equal(st, jst)
    assert int(st["size"]) == C


def test_insert_semantics():
    """The reference's ``test_ingraph_insert_semantics`` on the port: fill
    in order, then a higher priority evicts the minimum, a lower one is
    refused, an invalid row is never offered."""
    st = ingraph.ingraph_init(4, (2,), BITS)
    xs = torch.full((4, 2), 0.5)
    st = ingraph.ingraph_insert(st, prng.PRNGKey(0), xs, torch.arange(4),
                                torch.tensor([0.5, 0.1, 0.9, 0.3]), BITS)
    assert int(st["size"]) == 4 and st["label"].tolist() == [0, 1, 2, 3]
    st2 = ingraph.ingraph_insert(st, prng.PRNGKey(1), xs[:1],
                                 torch.tensor([9]), torch.tensor([0.2]),
                                 BITS)
    assert st2["label"].tolist() == [0, 9, 2, 3]
    st3 = ingraph.ingraph_insert(st, prng.PRNGKey(1), xs[:1],
                                 torch.tensor([9]), torch.tensor([0.05]),
                                 BITS)
    assert st3["label"].tolist() == [0, 1, 2, 3]
    st4 = ingraph.ingraph_insert(st, prng.PRNGKey(1), xs[:1],
                                 torch.tensor([9]), torch.tensor([5.0]),
                                 BITS, valid=torch.tensor([False]))
    assert st4["label"].tolist() == [0, 1, 2, 3]
    assert st["label"].tolist() == [0, 1, 2, 3]      # inputs untouched


@pytest.mark.parametrize("n_classes", [None, 4])
@pytest.mark.parametrize("fill", [0, 5, 12])
def test_sample_and_mix_equal_the_reference(n_classes, fill):
    C, B, n_rep = 12, 8, 3
    st = ingraph.ingraph_init(C, SHAPE, BITS)
    if fill:
        rng = np.random.default_rng(fill)
        st = ingraph.ingraph_insert(
            st, prng.PRNGKey(4),
            torch.from_numpy(rng.uniform(0, 1, (fill,) + SHAPE)
                             .astype(np.float32)),
            torch.from_numpy(rng.integers(0, 4, fill).astype(np.int32)),
            torch.from_numpy(rng.exponential(1, fill).astype(np.float32)),
            BITS)
    jst = _jstate(st)
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (B,) + SHAPE).astype(np.float32)
    y = rng.integers(0, 4, B).astype(np.int32)
    for s in range(10):
        key = jax.random.PRNGKey(s)
        xr, yr = ingraph.ingraph_sample(st, np.asarray(key), 64, BITS,
                                        n_classes)
        jxr, jyr = jreplay.ingraph_sample(jst, key, 64, BITS, n_classes)
        logits = _sample_logits(st, n_classes)
        clear = _margins(np.asarray(key), logits, (64,)) > MARGIN
        np.testing.assert_array_equal(yr.numpy()[clear],
                                      np.asarray(jyr)[clear])
        np.testing.assert_array_equal(xr.numpy()[clear],
                                      np.asarray(jxr)[clear])
        for active in (True, False):
            xm, ym = ingraph.ingraph_mix(st, np.asarray(key),
                                         torch.from_numpy(x),
                                         torch.from_numpy(y), n_rep,
                                         torch.tensor(active), BITS,
                                         n_classes)
            jxm, jym = jreplay.ingraph_mix(jst, key, jnp.asarray(x),
                                           jnp.asarray(y), n_rep,
                                           jnp.asarray(active), BITS,
                                           n_classes)
            c = np.concatenate([np.ones(B - n_rep, bool),
                                _margins(np.asarray(key), logits,
                                         (n_rep,)) > MARGIN])
            np.testing.assert_array_equal(ym.numpy()[c], np.asarray(jym)[c])
            np.testing.assert_array_equal(xm.numpy()[c], np.asarray(jxm)[c])
            if not (active and fill):
                assert torch.equal(xm, torch.from_numpy(x))


def _sample_logits(st, n_classes) -> np.ndarray:
    """The draw's logits, recomputed in numpy from the state."""
    C = st["prio"].shape[0]
    size = int(st["size"])
    occ = np.arange(C) < size
    pr = np.where(occ, st["prio"].numpy() + np.float32(1e-6), 0).astype(
        np.float32)
    if n_classes is not None:
        lab = st["label"].numpy()
        sums = np.zeros(n_classes, np.float32)
        np.add.at(sums, lab, pr)
        pr = pr / np.maximum(sums[lab], np.float32(1e-6))
    with np.errstate(divide="ignore"):
        logits = np.where(occ, np.log(pr), -np.inf).astype(np.float32)
    if size == 0:
        logits = np.where(np.arange(C) == 0, 0, -np.inf).astype(np.float32)
    return logits


def test_per_example_ce_equals_the_reference():
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 3, (9, 10)).astype(np.float32)
    y = rng.integers(0, 10, 9).astype(np.int32)
    got = ingraph.per_example_ce(torch.from_numpy(logits),
                                 torch.from_numpy(y))
    want = jreplay.per_example_ce(jnp.asarray(logits), jnp.asarray(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=1e-6)


def test_loss_aware_host_hooks_raise():
    pol = replay.make_policy("loss_aware", 4)
    assert pol.in_graph
    with pytest.raises(NotImplementedError, match="in-graph"):
        pol.select_insert(0)
    with pytest.raises(NotImplementedError, match="in-graph"):
        pol.select_sample(np.random.default_rng(0), 2)


# ---------------------------------------------------------------------------
# run_continual's in-graph branch
# ---------------------------------------------------------------------------

def _permuted(n_train=64, n_test=50):
    kw = dict(n_tasks=2, n_train=n_train, n_test=n_test, side=8)
    return make_permuted_tasks(0, **kw), jtasks(0, **kw)


@pytest.mark.parametrize("algo", ["dfa", "adam"])
def test_loss_aware_run_matches_the_reference(algo):
    tasks, jt = _permuted()
    kw = dict(algo=algo, epochs_per_task=3, batch_size=16)
    rs = dict(capacity=32, policy="loss_aware")
    be, jbe = get_backend("ideal"), importlib.import_module(
        "repro.backends").get_backend("ideal")
    be.telemetry.enable()
    jbe.telemetry.enable()
    got = continual.run_continual(MiRUConfig(n_x=8, n_h=32, n_y=10),
                                  continual.TrainerSpec(**kw), tasks,
                                  continual.ReplaySpec(**rs), be,
                                  torch_device="cpu")
    want = jcontinual.run_continual(JMiRUConfig(n_x=8, n_h=32, n_y=10),
                                    jcontinual.TrainerSpec(**kw), jt,
                                    jcontinual.ReplaySpec(**rs), jbe)
    R, jR = got["R"], np.asarray(want["R"])
    assert np.abs(R - jR).max() <= 2 / 50 + 1e-9, (R, jR)
    assert np.isfinite(got["losses"]).all()
    np.testing.assert_allclose(got["losses"][:3], want["losses"][:3],
                               rtol=1e-4, atol=1e-5)
    assert int(got["replay_state"]["size"]) == 32
    snap, jsnap = be.telemetry.snapshot(), jbe.telemetry.snapshot()
    traffic = continual._ingraph_replay_traffic(
        continual.ReplaySpec(**rs), 16, [12, 12], (8, 8))
    for k in (meters.REPLAY_READS, meters.REPLAY_READ_BYTES,
              meters.REPLAY_WRITES, meters.REPLAY_WRITE_BYTES):
        assert snap[k] == jsnap[k] == traffic[k], k


def test_ingraph_traffic_equals_the_reference():
    for ratio, bits in ((0.5, 4), (0.25, 8), (0.0, 4), (0.5, 12)):
        rs = dict(capacity=32, ratio=ratio, bits=bits, policy="loss_aware")
        assert continual._ingraph_replay_traffic(
            continual.ReplaySpec(**rs), 16, [5, 7, 3], (28, 28)) == \
            jcontinual._ingraph_replay_traffic(
                jcontinual.ReplaySpec(**rs), 16, [5, 7, 3], (28, 28))


def test_loss_aware_class_incremental_band():
    """The reference's no-collapse gate on its class-incremental stream
    (``build_scenario`` in the reference, converted): ``loss_aware``
    within 0.10 of ``class_balanced``'s average accuracy, which itself
    clears 0.6; Adam, 3 epochs, capacity 32, n_h 100."""
    jt = build_scenario("class_incremental", seed=0, n_tasks=4,
                        n_train=48, n_test=96, imbalance=3.0)
    tasks = [TaskData(np.asarray(t.x_train), np.asarray(t.y_train),
                      np.asarray(t.x_test), np.asarray(t.y_test),
                      task_id=t.task_id) for t in jt]
    n_y = int(max(int(t.y_train.max()) for t in tasks)) + 1
    cfg = MiRUConfig(n_x=tasks[0].x_train.shape[2], n_h=100, n_y=n_y)
    trainer = continual.TrainerSpec(algo="adam", epochs_per_task=3)

    def acc(policy):
        out = continual.run_continual(
            cfg, trainer, tasks,
            continual.ReplaySpec(capacity=32, policy=policy), "ideal",
            torch_device="cpu")
        return out["MA"]

    balanced, aware = acc("class_balanced"), acc("loss_aware")
    assert balanced > 0.6
    assert aware >= balanced - 0.10, (aware, balanced)


def test_loss_aware_refuses_the_padded_path():
    from repro_torch.data.ragged import PadPolicy
    tasks, _ = _permuted(32, 8)
    with pytest.raises(ValueError, match="in-graph"):
        continual.run_continual(
            MiRUConfig(n_x=8, n_h=8, n_y=10), continual.TrainerSpec(),
            tasks, continual.ReplaySpec(policy="loss_aware"),
            pad=PadPolicy(), torch_device="cpu")
