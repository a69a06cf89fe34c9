"""The port's replay pipeline and task streams against the reference, bit
for bit: Xorshift32 words, reservoir schedules, every host policy's slot
choices and rehearsal draws, the quantizers' codes, the replay buffer's
contents and traffic, and the synthetic generators' arrays. Everything
here is integer or exactly rounded, so every comparison is exact.
"""
import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.data.synthetic as jsyn  # noqa: E402
import repro.replay as jreplay  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch import replay  # noqa: E402
from repro_torch.core import replay as core_replay  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402

# repro.core re-exports names over some of its module names.
jcore_replay = importlib.import_module("repro.core.replay")

HOST_POLICIES = ("reservoir", "ring", "class_balanced", "task_stratified")


@pytest.mark.parametrize("mode", ["modulus", "reject"])
@pytest.mark.parametrize("seed", [0, 1, 0x9E3779B9, 0xFFFFFFFF])
def test_xorshift32_streams(seed, mode):
    a = core_replay.Xorshift32(seed, mode=mode)
    b = jcore_replay.Xorshift32(seed, mode=mode)
    assert [a.next() for _ in range(200)] == [b.next() for _ in range(200)]
    spans = [(1, i) for i in range(1, 60)] + [(0, 2 ** 31 + 7)]
    assert [a.randint(*s) for s in spans] == [b.randint(*s) for s in spans]
    with pytest.raises(ValueError):
        core_replay.Xorshift32(1, mode="nope")


@pytest.mark.parametrize("capacity", [1, 8, 64])
def test_reservoir_sampler_schedule(capacity):
    a = core_replay.ReservoirSampler(capacity, seed=123)
    b = jcore_replay.ReservoirSampler(capacity, seed=123)
    assert [a.offer() for _ in range(500)] == [b.offer() for _ in range(500)]
    assert a.count == b.count


@pytest.mark.parametrize("name", HOST_POLICIES)
def test_host_policy_slot_choices_and_draws(name):
    rng = np.random.default_rng(0)
    ys = rng.integers(0, 6, 400)
    tids = np.repeat(np.arange(4), 100)
    a = replay.make_policy(name, 24, seed=5, n_classes=6, n_tasks=4)
    b = jreplay.make_policy(name, 24, seed=5, n_classes=6, n_tasks=4)
    for y, t in zip(ys, tids):
        assert a.select_insert(int(y), int(t)) == b.select_insert(int(y),
                                                                  int(t))
        assert a.occupancy == b.occupancy
    ra, rb = np.random.default_rng(9), np.random.default_rng(9)
    for n in (1, 7, 16):
        np.testing.assert_array_equal(a.select_sample(ra, n),
                                      b.select_sample(rb, n))
    if hasattr(b, "group_sizes"):
        assert a.group_sizes() == b.group_sizes()


def test_policy_registry_and_loss_aware():
    assert set(HOST_POLICIES) | {"loss_aware"} <= set(
        replay.available_policies())
    cls = replay.get_policy_class("loss_aware")
    assert cls.in_graph
    with pytest.raises(NotImplementedError, match="in-graph"):
        replay.make_policy("loss_aware", 4).select_insert(0)
    with pytest.raises(ValueError, match="in-graph"):
        core_replay.ReplayBuffer(4, (2,), policy="loss_aware")
    with pytest.raises(ValueError, match="unknown replay policy"):
        replay.get_policy_class("nope")


@pytest.mark.parametrize("n_bits", [1, 4, 8, 12])
def test_stochastic_quantize_codes(n_bits):
    x = np.random.default_rng(n_bits).uniform(0, 1, (28, 28)).astype(
        np.float32)
    x[0, :4] = [0.0, 1.0, 0.5, 1.0 - 2.0 ** -n_bits]
    for seed in range(3):
        got = core_replay.stochastic_quantize(torch.from_numpy(x),
                                              prng.PRNGKey(seed), n_bits)
        want = jcore_replay.stochastic_quantize(
            jnp.asarray(x), jax.random.PRNGKey(seed), n_bits)
        np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                      np.asarray(want).astype(np.int64))
    np.testing.assert_array_equal(
        core_replay.uniform_quantize(torch.from_numpy(x), n_bits)
        .numpy().astype(np.int64),
        np.asarray(jcore_replay.uniform_quantize(jnp.asarray(x), n_bits))
        .astype(np.int64))
    codes = np.arange(2 ** min(n_bits, 8), dtype=np.uint8)
    np.testing.assert_array_equal(
        core_replay.dequantize(torch.from_numpy(codes), n_bits).numpy(),
        np.asarray(jcore_replay.dequantize(jnp.asarray(codes), n_bits)))
    assert core_replay.code_dtype(n_bits) == jcore_replay.code_dtype(n_bits)
    assert core_replay.round_trip_bound(n_bits) == \
        jcore_replay.round_trip_bound(n_bits)


def test_stochastic_quantize_batched_keys_are_per_example():
    x = np.random.default_rng(1).uniform(0, 1, (5, 3, 4)).astype(np.float32)
    keys = prng.split(prng.PRNGKey(3), 5)
    got = core_replay.stochastic_quantize(torch.from_numpy(x), keys, 4)
    for i in range(5):
        np.testing.assert_array_equal(
            got[i].numpy(),
            np.asarray(jcore_replay.stochastic_quantize(
                jnp.asarray(x[i]), jnp.asarray(keys[i]), 4)))


@pytest.mark.parametrize("n_bits", [4, 8])
def test_lfsr_quantizer(n_bits):
    x = np.random.default_rng(2).uniform(0, 1, (6, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        core_replay.lfsr_stochastic_quantize(x, n_bits, seed=3),
        jcore_replay.lfsr_stochastic_quantize(x, n_bits, seed=3))


@pytest.mark.parametrize("policy", HOST_POLICIES)
def test_replay_buffer_contents_draws_and_traffic(policy):
    rng = np.random.default_rng(4)
    xs = rng.uniform(0, 1, (90, 6, 5)).astype(np.float32)
    ys = rng.integers(0, 10, 90).astype(np.int32)
    kw = dict(n_bits=4, seed=11)
    a = core_replay.ReplayBuffer(
        16, (6, 5), policy=replay.make_policy(policy, 16, seed=11,
                                              n_classes=10, n_tasks=3), **kw)
    b = jcore_replay.ReplayBuffer(
        16, (6, 5), policy=jreplay.make_policy(policy, 16, seed=11,
                                               n_classes=10, n_tasks=3),
        **kw)
    for s in range(0, 60, 20):
        tids = np.full(20, s // 20)
        assert a.add_batch(xs[s:s + 20], ys[s:s + 20], task_ids=tids) == \
            b.add_batch(xs[s:s + 20], ys[s:s + 20], task_ids=tids)
    for i in range(60, 70):
        assert a.add(xs[i], ys[i], 2) == b.add(xs[i], ys[i], 2)
    valid = np.arange(20) % 3 != 0
    a.add_batch(xs[70:], ys[70:], valid=valid)
    b.add_batch(xs[70:], ys[70:], valid=valid)
    np.testing.assert_array_equal(a._feat, b._feat)
    np.testing.assert_array_equal(a._label, b._label)
    assert a.size == b.size and a.nbytes == b.nbytes
    fa, la = a.sample(np.random.default_rng(1), 8)
    fb, lb = b.sample(np.random.default_rng(1), 8)
    np.testing.assert_array_equal(fa, fb)
    np.testing.assert_array_equal(la, lb)
    assert a.traffic == b.traffic


def test_add_batch_equals_per_example_adds():
    xs = np.random.default_rng(5).uniform(0, 1, (12, 4, 3)).astype(
        np.float32)
    ys = np.arange(12) % 4
    a = core_replay.ReplayBuffer(6, (4, 3), n_bits=4, seed=2)
    b = core_replay.ReplayBuffer(6, (4, 3), n_bits=4, seed=2)
    a.add_batch(xs, ys)
    for x, y in zip(xs, ys):
        b.add(x, int(y))
    np.testing.assert_array_equal(a._feat, b._feat)
    np.testing.assert_array_equal(a._label, b._label)


GENERATORS = {
    "permuted": dict(n_tasks=3, n_train=40, n_test=16),
    "split": dict(n_tasks=2, n_train=40, n_test=16, feat_dim=64, steps=8),
    "rotated": dict(n_tasks=3, n_train=30, n_test=10, side=10),
    "noisy_label": dict(n_tasks=3, n_train=30, n_test=10, side=8),
    "drift": dict(n_tasks=3, n_train=30, n_test=10, side=8),
    "class_incremental": dict(n_tasks=3, n_train=20, n_test=10, side=8,
                              imbalance=1.5),
    "streaming": dict(n_tasks=3, n_train=70, n_test=30, side=8),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_equal_arrays(name):
    fn = f"make_{name}_tasks"
    got = getattr(syn, fn)(3, **GENERATORS[name])
    want = getattr(jsyn, fn)(3, **GENERATORS[name])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.task_id == b.task_id
        for f in ("x_train", "y_train", "x_test", "y_test"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_lm_token_batch_equal():
    a = syn.lm_token_batch(np.random.default_rng(0), 3, 9, 50)
    b = jsyn.lm_token_batch(np.random.default_rng(0), 3, 9, 50)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])
