"""Hardware experience-replay pipeline (§IV-A): reservoir sampler,
stochastic quantizer, replay buffer — counterpart of
``repro/core/replay.py``.

The paper's data-preparation unit is digital host-side logic (counter,
xorshift32, modulus unit, LFSR-driven stochastic rounder). It is
reproduced here bit-faithfully in numpy; the stochastic quantizer draws
its rounding from :mod:`repro_torch.prng` keys on the reference's key
chain, so the codes equal the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import prng


# ---------------------------------------------------------------------------
# Xorshift32 — the paper's RNG (chosen over LFSR for unbiased indices)
# ---------------------------------------------------------------------------

class Xorshift32:
    """32-bit xorshift PRNG (Marsaglia), exactly the 13/17/5 hardware circuit.

    Produces decorrelated, uniform *words* — the property the paper relies
    on for equal-probability reservoir sampling (unlike an LFSR, whose
    maximal sequence never emits 0 and is correlated between taps).

    ``randint`` reduces a word to a range. The hardware-faithful default
    (``mode="modulus"``, the paper's modulus unit) carries modulo bias
    when the span does not divide 2^32: each value's probability deviates
    from 1/span by at most 2^-32 in absolute terms, but residues below
    ``2^32 mod span`` are overweighted by the factor
    ``ceil(2^32/span)/floor(2^32/span)`` — approaching 2× for spans near
    2^32 (quantified in the reference's tests/test_replay.py). ``mode="reject"`` draws
    words until one falls below the largest multiple of the span — exactly
    uniform, at the cost of a variable number of RNG steps, so it walks a
    *different* bit-stream and must not be enabled under seeds that
    hardware-equivalence tests pin.
    """

    def __init__(self, seed: int = 0x9E3779B9, mode: str = "modulus"):
        if mode not in ("modulus", "reject"):
            raise ValueError(f"unknown randint mode {mode!r}; expected "
                             "'modulus' (hardware-faithful) or 'reject' "
                             "(unbiased)")
        seed = np.uint32(seed if seed != 0 else 0xDEADBEEF)
        self.state = np.uint32(seed)
        self.mode = mode

    def next(self) -> int:
        x = self.state
        with np.errstate(over="ignore"):
            x = np.uint32(x ^ np.uint32(x << np.uint32(13)))
            x = np.uint32(x ^ np.uint32(x >> np.uint32(17)))
            x = np.uint32(x ^ np.uint32(x << np.uint32(5)))
        self.state = x
        return int(x)

    def randint(self, lo: int, hi: int) -> int:
        """Int in [lo, hi]: the paper's modulus unit by default (modulo
        bias ≤ 2^-32 per value — see the class docstring), or unbiased
        rejection sampling when constructed with ``mode="reject"``."""
        span = hi - lo + 1
        if self.mode == "reject":
            limit = (1 << 32) - ((1 << 32) % span)
            x = self.next()
            while x >= limit:
                x = self.next()
            return lo + x % span
        return lo + self.next() % span


# ---------------------------------------------------------------------------
# Stochastic quantizer (eqs. 4-6)
# ---------------------------------------------------------------------------

def _code_torch_dtype(n_bits: int) -> torch.dtype:
    return torch.uint8 if n_bits <= 8 else torch.int32


def stochastic_quantize(x: torch.Tensor, key: np.ndarray, n_bits: int
                        ) -> torch.Tensor:
    """Quantize x∈[0,1] to n_bits integer codes with stochastic rounding.

        z  = x · 2^{n_b}
        q  = ⌊z⌋ + 1   if r < frac(z) and ⌊z⌋ < 2^{n_b} − 1
             ⌊z⌋       otherwise,   r = prng.uniform(key, x.shape)

    ``key`` may carry leading batch axes (..., 2), one key per example:
    x is then (..., *shape) and example i rounds with key i. Codes are
    uint8 up to 8 bits (int32 above, where the reference uses uint16).
    Unbiased away from the top code; see :func:`round_trip_bound`."""
    x = x.to(torch.float32)
    key = np.asarray(key, np.uint32)
    z = x * (2.0 ** n_bits)
    fl = torch.floor(z)
    frac = z - fl
    r = prng.uniform(key, x.shape[key.ndim - 1:], device=x.device)
    top = 2.0 ** n_bits - 1.0
    q = torch.where((r < frac) & (fl < top), fl + 1.0, fl)
    return torch.clamp(q, 0.0, top).to(_code_torch_dtype(n_bits))


def uniform_quantize(x: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Plain truncation quantizer (the baseline in Fig. 5a)."""
    z = torch.floor(x.to(torch.float32) * (2.0 ** n_bits))
    top = 2.0 ** n_bits - 1.0
    return torch.clamp(z, 0.0, top).to(_code_torch_dtype(n_bits))


def dequantize(q: torch.Tensor, n_bits: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Codes → [0, 1): the paper-faithful 1/2^{n_b} scale (an n-bit right
    shift in RTL), so the top of the range is 1 − 2^{−n_b}."""
    return q.to(dtype) / (2.0 ** n_bits)


def round_trip_bound(n_bits: int) -> float:
    """Worst-case |E[dequantize(stochastic_quantize(x))] − x| over
    x ∈ [0, 1].

    The stochastic rounder is exactly unbiased on x ≤ 1 − 2^{−n_b}; in
    the clip region (1 − 2^{−n_b}, 1] the expectation is pinned at
    1 − 2^{−n_b}, so the error grows linearly to its maximum 2^{−n_b}
    at x = 1.0. Scaling dequantization by 1/(2^{n_b} − 1) instead would
    remove the clip but is *not* what the chip's shift-based datapath
    computes — the repro keeps the paper-faithful scale and documents
    the bound (pinned by a property test of the reference).
    """
    return 2.0 ** -n_bits


def code_dtype(n_bits: int) -> np.dtype:
    """Storage dtype for n_bits codes: uint8 holds up to 8-bit codes,
    uint16 up to 16 — matching what the quantizers emit. (Allocating
    uint8 unconditionally silently truncated the high bits of 9–16-bit
    codes.)"""
    if not 1 <= n_bits <= 16:
        raise ValueError(f"n_bits must be in [1, 16], got {n_bits}")
    return np.dtype(np.uint8 if n_bits <= 8 else np.uint16)


def lfsr_stochastic_quantize(x: np.ndarray, n_bits: int, seed: int = 1
                             ) -> np.ndarray:
    """Bit-faithful hardware rounder: an n_bits LFSR supplies r (Verilog
    model in §IV-A-2). Host-side numpy; used in hardware-equivalence tests."""
    taps = {4: (3, 2), 8: (7, 5, 4, 3)}[n_bits if n_bits in (4, 8) else 4]
    state = seed & ((1 << n_bits) - 1) or 1
    flat = x.reshape(-1)
    out = np.empty_like(flat)
    top = 2 ** n_bits - 1
    for i, v in enumerate(flat):
        fb = 0
        for t in taps:
            fb ^= (state >> t) & 1
        state = ((state << 1) | fb) & ((1 << n_bits) - 1)
        z = v * (2.0 ** n_bits)
        fl = np.floor(z)
        r = state / (2.0 ** n_bits)
        q = fl + 1 if (r < (z - fl) and fl < top) else fl
        out[i] = min(max(q, 0), top)
    return out.reshape(x.shape)


def _split_chain(key: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """n sequential ``key, sub = split(key)`` steps: (advanced key,
    (n, 2) subkeys)."""
    subs = np.empty((n, 2), np.uint32)
    for i in range(n):
        key, subs[i] = prng.split(key)
    return key, subs


# ---------------------------------------------------------------------------
# Reservoir sampler + replay buffer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ReservoirSampler:
    """Algorithm-R over a stream of unknown length with the paper's hardware
    construction: counter + xorshift32 + modulus + index check.

    Every element of the stream ends up in the buffer with equal probability
    k/i after i presentations.
    """
    capacity: int
    seed: int = 0x2545F491
    # "modulus" is the paper's hardware (and the bit-stream every pinned
    # seed walks); "reject" swaps in the unbiased rejection reducer.
    rng_mode: str = "modulus"

    def __post_init__(self):
        self._rng = Xorshift32(self.seed, mode=self.rng_mode)
        self.count = 0  # the paper's counter i

    def offer(self) -> Optional[int]:
        """Present one example; return the buffer slot to overwrite, or None
        if the example is not selected."""
        self.count += 1
        i = self.count
        if i <= self.capacity:
            return i - 1
        # j uniform in [1, i] via modulus unit; keep iff j <= k.
        j = self._rng.randint(1, i)
        return j - 1 if j <= self.capacity else None


class ReplayBuffer:
    """Policy-driven, stochastically-quantized replay store.

    Features are stored as n_bits integer codes (8→4-bit halves the memory,
    §IV-A-2) in a dtype sized by :func:`code_dtype`; labels as int32.
    Host-side numpy storage — this is the DRAM replay buffer, not an
    on-device tensor, and when a :class:`~repro_torch.telemetry.meters.Telemetry`
    accumulator is attached every insert/sample is metered as DRAM traffic
    (``replay_*`` counters).

    Slot selection is delegated to a :class:`repro_torch.replay.ReplayPolicy`
    (a registered name or an instance). The default ``"reservoir"`` is
    the paper's §IV-A hardware bit-for-bit — identical sampler seed
    derivation, identical host-RNG consumption — so schedules built
    through the policy layer hash to the pre-refactor golden digest.
    """

    def __init__(self, capacity: int, feature_shape: tuple[int, ...],
                 n_bits: int = 4, seed: int = 7, policy=None,
                 telemetry=None):
        from repro_torch.replay import ReplayPolicy, make_policy
        if policy is None or isinstance(policy, str):
            policy = make_policy(policy or "reservoir", capacity,
                                 seed=seed)
        if not isinstance(policy, ReplayPolicy):
            raise TypeError(f"policy must be a registered name or a "
                            f"ReplayPolicy, got {type(policy).__name__}")
        if policy.in_graph:
            raise ValueError(
                f"policy {policy.name!r} is in-graph (training-state-"
                f"dependent); its device buffer is not ported yet "
                f"(ROADMAP queue A)")
        if policy.capacity != capacity:
            raise ValueError(f"policy capacity {policy.capacity} != "
                             f"buffer capacity {capacity}")
        self.capacity = capacity
        self.n_bits = n_bits
        self.policy = policy
        # Back-compat alias: the reservoir policy's hardware sampler.
        self.sampler = getattr(policy, "sampler", None)
        self._feat = np.zeros((capacity, *feature_shape),
                              dtype=code_dtype(n_bits))
        self._label = np.zeros((capacity,), dtype=np.int32)
        self.size = 0
        self._qkey = prng.PRNGKey(seed)
        self._telemetry = telemetry
        # Running DRAM-traffic tally (meter-keyed), kept even without an
        # attached accumulator so schedule builders can credit the
        # traffic to a run's telemetry exactly once (run_continual and
        # the compiled sweep build/discard schedules at different times).
        self.traffic: dict[str, int] = {}

    # ------------------------------------------------------------------
    def _meter(self, *, reads: int = 0, writes: int = 0) -> None:
        """Count DRAM traffic: rows moved and bytes (codes + int32
        label per row). Host-side concrete deltas — exact, no tracing."""
        from repro_torch.telemetry import meters as M
        row_bytes = (self._feat.dtype.itemsize
                     * int(np.prod(self._feat.shape[1:]))
                     + self._label.dtype.itemsize)
        deltas: dict[str, int] = {}
        if reads:
            deltas[M.REPLAY_READS] = reads
            deltas[M.REPLAY_READ_BYTES] = reads * row_bytes
        if writes:
            deltas[M.REPLAY_WRITES] = writes
            deltas[M.REPLAY_WRITE_BYTES] = writes * row_bytes
        for k, v in deltas.items():
            self.traffic[k] = self.traffic.get(k, 0) + v
        if self._telemetry is not None and self._telemetry.enabled:
            self._telemetry.record(deltas)

    def add(self, x: np.ndarray, y: int, task_id: int = 0) -> bool:
        """Offer one (features∈[0,1], label) example to the policy."""
        slot = self.policy.select_insert(int(y), int(task_id))
        if slot is None:
            return False
        self._qkey, sub = prng.split(self._qkey)
        q = stochastic_quantize(torch.from_numpy(np.asarray(x, np.float32)),
                                sub, self.n_bits).numpy()
        self._feat[slot] = q
        self._label[slot] = y
        self.size = self.policy.occupancy
        self._meter(writes=1)
        return True

    def add_batch(self, xs: np.ndarray, ys: np.ndarray,
                  task_ids=None, valid=None) -> int:
        """Offer a batch to the policy. Equivalent to per-example
        :meth:`add` calls bit-for-bit (same key chain, same quantizer
        draws), but all accepted examples are quantized in one batched
        call — the schedule-building hot path.

        ``valid`` (a (B,) bool mask) gates padded rows out entirely:
        an invalid row is never offered to the policy and consumes no
        sampler or quantizer RNG, so a zero-padded batch leaves the
        buffer in exactly the state the unpadded batch would."""
        slots: list[int] = []
        keep: list[int] = []
        for i in range(len(xs)):
            if valid is not None and not valid[i]:
                continue
            tid = int(task_ids[i]) if task_ids is not None else 0
            slot = self.policy.select_insert(int(ys[i]), tid)
            if slot is None:
                continue
            slots.append(slot)
            keep.append(i)
        if not slots:
            return 0
        # The exact sequential key chain self._qkey would have walked;
        # then one batched quantize, example i on subkey i.
        self._qkey, subs = _split_chain(self._qkey, len(slots))
        q = stochastic_quantize(
            torch.from_numpy(np.ascontiguousarray(xs[keep], np.float32)),
            subs, self.n_bits).numpy()
        for slot, qi, i in zip(slots, q, keep):
            self._feat[slot] = qi
            self._label[slot] = int(ys[i])
        self.size = self.policy.occupancy
        self._meter(writes=len(slots))
        return len(slots)

    def sample(self, rng: np.random.Generator, batch: int
               ) -> tuple[np.ndarray, np.ndarray]:
        """Policy-selected sample of dequantized examples for rehearsal
        (uniform over the occupied prefix under ``reservoir``/``ring``;
        stratified under the partitioned policies). Dequantizes on the
        paper's 1/2^n scale — see :func:`round_trip_bound`."""
        if self.size == 0:
            raise ValueError("empty replay buffer")
        idx = np.asarray(self.policy.select_sample(rng, batch))
        feats = self._feat[idx].astype(np.float32) / (2.0 ** self.n_bits)
        self._meter(reads=batch)
        return feats, self._label[idx]

    @property
    def nbytes(self) -> int:
        return self._feat.nbytes + self._label.nbytes
