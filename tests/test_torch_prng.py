"""The port's threefry keys and draws against ``jax.random``.

Keys, splits, folds, raw bits and uniform draws must be bit for bit the
reference's. ``normal`` goes through XLA's erfinv polynomial, evaluated
with a correctly rounded log1p where XLA's CPU log1p has its own last
bits: it is held to 3 ulp (measured worst case over 500,000 draws) and
to at least 98 % bit-exact draws.

The port derives the counters of ``split`` and shaped bits as jax does
with ``jax_threefry_partitionable`` set; the tests check that the
installed reference runs with that flag.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import miru as jmiru  # noqa: E402
from repro.utils import glorot_uniform as jglorot  # noqa: E402
from repro.utils import normal_init as jnormal_init  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import miru  # noqa: E402
from repro_torch.utils import glorot_uniform, normal_init  # noqa: E402

NORMAL_ULP = 3




def _ulp(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def test_installed_reference_is_partitionable():
    """The port's counter derivation is jax's partitionable one; the
    bitwise tests below hold only against a reference that runs it."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1, -3, 2 ** 32 - 1])
def test_prng_key(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seeds", [(0, 7, 123), (2 ** 32 - 1, -3, 99)])
@pytest.mark.parametrize("num", [2, 3, 5, 16])
def test_split(num, seeds):
    for seed in seeds:
        np.testing.assert_array_equal(
            prng.split(prng.PRNGKey(seed), num),
            np.asarray(jax.random.split(jax.random.PRNGKey(seed), num)))


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 5])
def test_split_chain_and_batched_keys(seed):
    key, jkey = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    for _ in range(6):
        key, sub = prng.split(key)
        jkey, jsub = jax.random.split(jkey)
        np.testing.assert_array_equal(sub, np.asarray(jsub))
    keys = prng.split(key, 4)
    got = prng.split(keys, 3)
    assert got.shape == (4, 3, 2)
    for i in range(4):
        np.testing.assert_array_equal(
            got[i], np.asarray(jax.random.split(jnp.asarray(keys[i]), 3)))


@pytest.mark.parametrize("data", [0, 1, 0x0DE5, 0x5E1, 2 ** 32 - 1])
def test_fold_in(data):
    np.testing.assert_array_equal(
        prng.fold_in(prng.PRNGKey(11), data),
        np.asarray(jax.random.fold_in(jax.random.PRNGKey(11), data)))


@pytest.mark.parametrize("seed", [9, 2 ** 32 - 2])
@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (28, 28), (2, 3, 4)])
def test_bits(shape, seed):
    np.testing.assert_array_equal(
        prng.bits(prng.PRNGKey(seed), shape),
        np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape)))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.17320508, 0.17320508),
                                   (-1.0, 3.5),
                                   (float(np.nextafter(np.float32(-1),
                                                       np.float32(0))),
                                    1.0)])
@pytest.mark.parametrize("shape", [(5,), (28, 28), (100, 100)])
@pytest.mark.parametrize("seed", [3, 1234567])
def test_uniform_bit_exact(seed, shape, lo, hi):
    got = prng.uniform(prng.PRNGKey(seed), shape, lo, hi)
    want = jax.random.uniform(jax.random.PRNGKey(seed), shape, jnp.float32,
                              lo, hi)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_uniform_batched_keys_are_per_key_draws():
    keys = prng.split(prng.PRNGKey(2), 5)
    got = prng.uniform(keys, (4, 6))
    assert got.shape == (5, 4, 6)
    for i in range(5):
        np.testing.assert_array_equal(
            got[i].numpy(),
            np.asarray(jax.random.uniform(jnp.asarray(keys[i]), (4, 6))))


@pytest.mark.parametrize("n", [1, 2, 8])
def test_scalar_cipher_equals_vector_cipher(n):
    """One key and up to 8 counters take the Python-integer cipher; it
    must give the numpy cipher's words (run here on a batched key)."""
    rng = np.random.default_rng(n)
    for _ in range(20):
        key = rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.uint32)
        x0 = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
        x1 = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
        y0, y1 = prng.threefry2x32(key, x0, x1)
        v0, v1 = prng.threefry2x32(key[None], x0, x1)
        np.testing.assert_array_equal(y0, v0[0])
        np.testing.assert_array_equal(y1, v1[0])


def test_fma_rounds_once():
    """The exact fused multiply-add that XLA's CPU uses for uniform's
    scale-and-shift: against a float128-free oracle built from
    fractions on a few hundred random triples."""
    from fractions import Fraction
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, 300).astype(np.float32)
    b = np.float32(0.34641016)
    c = np.float32(-0.17320508)
    got = prng.fma_f32(a, b, c)
    for ai, gi in zip(a, got):
        exact = Fraction(float(ai)) * Fraction(float(b)) + Fraction(float(c))
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, np.float32(-1)),
                 np.nextafter(lo, np.float32(1))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.int32))
                                         & 1))
        assert gi == best


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_normal_within_ulps(seed):
    got = prng.normal(prng.PRNGKey(seed), (20000,)).numpy()
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (20000,)))
    d = _ulp(got, want)
    assert d.max() <= NORMAL_ULP
    assert np.mean(d == 0) >= 0.98


def test_glorot_and_init_params_bit_exact():
    key = jax.random.PRNGKey(4)
    np.testing.assert_array_equal(
        glorot_uniform(prng.PRNGKey(4), (28, 100)).numpy(),
        np.asarray(jglorot(key, (28, 100))))
    cfg = miru.MiRUConfig(n_x=28, n_h=100, n_y=10)
    jp = jmiru.init_miru_params(key, jmiru.MiRUConfig(n_x=28, n_h=100,
                                                      n_y=10))
    p = miru.init_miru_params(prng.PRNGKey(4), cfg, "cpu")
    for k in jp:
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(jp[k]))


def test_normal_init_and_feedback_within_ulps():
    key = jax.random.PRNGKey(8)
    d = _ulp(normal_init(prng.PRNGKey(8), (10, 100), 0.3).numpy(),
             np.asarray(jnormal_init(key, (10, 100), 0.3)))
    assert d.max() <= NORMAL_ULP
    cfg = miru.MiRUConfig(n_x=28, n_h=100, n_y=10)
    psi = miru.init_dfa_feedback(prng.PRNGKey(8), cfg, device="cpu")
    jpsi = jmiru.init_dfa_feedback(key, jmiru.MiRUConfig(n_x=28, n_h=100,
                                                         n_y=10))
    assert psi.shape == (10, 100)
    assert _ulp(psi.numpy(), np.asarray(jpsi)).max() <= NORMAL_ULP
