"""Threefry-2x32 keys and draws, bit for bit as ``jax.random`` makes them.

The reference draws its stochastic physics (WBS plane-gain noise), its
initial weights and Ψ, and the replay quantizer's rounding from
``jax.random`` key chains. This module repeats the parts the port needs:
:func:`PRNGKey`, :func:`split`, :func:`fold_in`, raw 32-bit :func:`bits`,
:func:`uniform` (bit-exact) and :func:`normal` (XLA's erfinv polynomial,
evaluated here with a correctly rounded log1p where XLA's CPU log1p has
its own last bits, so ``normal`` is within 3 ulp and about 99 % of
draws are bit-exact).

A key is what ``jax.random.PRNGKey`` returns as raw data: a numpy
``uint32`` array of shape (2,). Keys may carry leading batch axes,
(..., 2), and every function maps over them. Key arithmetic runs on the
host in numpy ``uint32`` (which wraps like the hardware's adders); draws
come back as torch tensors on the requested device.

The counters of ``split`` and of shaped bits are derived as jax does
with its ``jax_threefry_partitionable`` flag set (the default since jax
0.5): each element's flat index, as a 64-bit (hi, lo) counter pair.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
_U32 = np.uint32


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def _threefry_scalar(k0: int, k1: int, x0: int, x1: int
                     ) -> tuple[int, int]:
    """One counter pair through the cipher in Python integers. The key
    chains of a training loop (two splits a step, one per row the replay
    buffer stores) encipher one or two counters at a time, where numpy's
    per-call cost dominates: a ``split`` takes about 38 µs this way and
    185 µs through numpy (medians on an H100 machine's host,
    ``tools/train_host_time.py``), so two splits a step cost 0.3 ms of a
    3.5 ms ``wbs`` train step, and the Fig. 4 schedule builds 0.2 s
    slower."""
    m = 0xFFFFFFFF
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + k0) & m, (x1 + k1) & m
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & m
            x1 = (((x1 << r) | (x1 >> (32 - r))) & m) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & m
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & m
    return x0, x1


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block cipher (20 rounds), elementwise over the
    counter pairs (x0, x1); ``key`` (..., 2) broadcasts against them with
    its batch axes in front. One key and up to 8 counters go through
    :func:`_threefry_scalar`, the rest through numpy."""
    key = np.asarray(key, _U32)
    if key.ndim == 1 and np.ndim(x0) == 1 and np.size(x0) <= 8:
        k0, k1 = int(key[0]), int(key[1])
        pairs = [_threefry_scalar(k0, k1, int(a), int(b))
                 for a, b in zip(x0, x1)]
        return (np.array([p[0] for p in pairs], _U32),
                np.array([p[1] for p in pairs], _U32))
    k0 = key[..., 0].reshape(key.shape[:-1] + (1,) * (np.ndim(x0)))
    k1 = key[..., 1].reshape(key.shape[:-1] + (1,) * (np.ndim(x0)))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x0 = np.asarray(x0, _U32) + ks[0]
        x1 = np.asarray(x1, _U32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def _index_counters(size: int) -> tuple[np.ndarray, np.ndarray]:
    """Each element's flat index as a 64-bit (hi, lo) counter pair."""
    idx = np.arange(size, dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(_U32), idx.astype(_U32)


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: (hi, lo) words of the seed. A 32-bit
    seed's high word is 0, and a negative one wraps (two's complement)."""
    seed = int(seed)
    hi = (seed >> 32) & 0xFFFFFFFF if not -2 ** 31 <= seed < 2 ** 32 else 0
    return np.array([hi, seed & 0xFFFFFFFF], _U32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split``: (..., num, 2) new keys."""
    hi, lo = _index_counters(num)
    y0, y1 = threefry2x32(key, hi, lo)
    return np.stack([y0, y1], axis=-1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in``: the key enciphered with the counter pair
    (0, data)."""
    y0, y1 = threefry2x32(key, np.zeros(1, _U32),
                         np.array([int(data) & 0xFFFFFFFF], _U32))
    return np.concatenate([y0, y1], axis=-1)


def bits(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.bits(key, shape)`` at 32 bits: (..., *shape) uint32."""
    key = np.asarray(key, _U32)
    shape = tuple(int(s) for s in shape)
    size = math.prod(shape)
    hi, lo = _index_counters(size)
    y0, y1 = threefry2x32(key, hi, lo)
    return (y0 ^ y1).reshape(key.shape[:-1] + shape)


def _to_torch(a: np.ndarray, device: Union[str, torch.device]
              ) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def fma_f32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """a·b + c on float32 operands, rounded once to float32, as a fused
    multiply-add does (XLA contracts ``a*b + c`` so on the CPU). The
    product is exact in float64; the float64 sum's rounding error is
    kept (TwoSum) and decides the one case where rounding twice would
    differ: a float64 sum that lies exactly halfway between two floats."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    v = s - p
    err = (p - (s - v)) + (c - v)
    r = s.astype(np.float32)
    toward = np.nextafter(r, np.where(s > r, np.float32(np.inf),
                                      np.float32(-np.inf)).astype(np.float32))
    d = s - r.astype(np.float64)
    half = (toward.astype(np.float64) - r.astype(np.float64)) / 2.0
    beyond = (d != 0) & (d == half) & (err != 0) & ((err > 0) == (d > 0))
    return np.where(beyond, toward, r)


def uniform_np(key: np.ndarray, shape: Sequence[int], minval: float = 0.0,
               maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform`` in float32 as a numpy array: 23 random
    mantissa bits under the exponent of 1.0, minus 1, then scaled and
    shifted by one fused multiply-add, and floored at ``minval``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    mant = (bits(key, shape) >> _U32(9)) | _U32(0x3F800000)
    floats = mant.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, fma_f32(floats, hi - lo, lo))


def uniform(key: np.ndarray, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0, device: Union[str, torch.device] = "cpu"
            ) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` on
    ``device``, bit for bit."""
    return _to_torch(uniform_np(key, shape, minval, maxval), device)


# XLA's float32 erfinv (M. Giles, "Approximating the erfinv function"):
# a degree-8 polynomial in w - 2.5 below w = 5 and in sqrt(w) - 3 above,
# w = -log1p(-x²). PyTorch's erfinv is accurate where this one is not (up
# to ~90 ulp apart in the tails), so the port evaluates XLA's.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv_np(x: np.ndarray) -> np.ndarray:
    """XLA's float32 erfinv, its Horner steps as fused multiply-adds and
    log1p correctly rounded (XLA's CPU log1p differs from that in the
    last bit on about 8 % of inputs): within 2 ulp of the CPU reference,
    equal on about 99 % of inputs."""
    x = np.asarray(x, np.float32)
    w = -np.log1p((x * -x).astype(np.float64)).astype(np.float32)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    coef = [np.where(lt, np.float32(a), np.float32(b))
            for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = coef[0]
    for c in coef[1:]:
        p = fma_f32(p, w, c)
    out = (p * x).astype(np.float32)
    return np.where(np.abs(x) == 1, x * np.float32(np.inf), out)


def normal(key: np.ndarray, shape: Sequence[int],
           device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: √2·erfinv(u) with u
    uniform on (nextafter(-1, 0), 1). The uniform draw is bit-exact, the
    erfinv within 2 ulp of XLA's (:func:`erfinv_np`), the result within
    3 ulp."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform_np(key, shape, lo, 1.0)
    return _to_torch(np.float32(np.sqrt(2.0)) * erfinv_np(u), device)
