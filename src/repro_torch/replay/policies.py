"""Registered host-side replay policies — counterpart of
``repro/replay/policies.py``.

All schedule-time policies are built from the paper's hardware RNG
primitives (:class:`repro_torch.core.replay.Xorshift32`,
:class:`~repro_torch.core.replay.ReservoirSampler`) so every schedule stays a
bit-reproducible function of (trainer seed, stream). The ``reservoir``
policy is the pre-refactor behavior bit-for-bit — same sampler seed
derivation, same host-RNG consumption on sample — which is what keeps
the schedules equal to the reference's bit for bit.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.replay import ReservoirSampler, Xorshift32
from repro_torch.replay.base import ReplayPolicy, register_policy

# The seed whitening ReplayBuffer has always applied to its sampler;
# kept here so policy-built samplers walk the identical xorshift stream.
_SAMPLER_SEED_XOR = 0x5BD1E995


def _region_seed(seed: int, region: int) -> int:
    """Per-region sampler seed: decorrelated, deterministic, 32-bit."""
    return (seed ^ _SAMPLER_SEED_XOR
            ^ ((region + 1) * 0x9E3779B9)) & 0xFFFFFFFF


@register_policy("reservoir")
class ReservoirPolicy(ReplayPolicy):
    """Algorithm-R over the whole stream — the paper's §IV-A hardware
    (counter + xorshift32 + modulus) and the default policy. Every stream
    element ends up in the buffer with equal probability k/i; sampling is
    uniform over the occupied prefix."""

    def __init__(self, capacity: int, seed: int = 7, *,
                 n_classes: Optional[int] = None,
                 n_tasks: Optional[int] = None):
        super().__init__(capacity, seed, n_classes=n_classes,
                         n_tasks=n_tasks)
        self.sampler = ReservoirSampler(capacity,
                                        seed=seed ^ _SAMPLER_SEED_XOR)

    def select_insert(self, y: int, task_id: int = 0) -> Optional[int]:
        return self.sampler.offer()

    def select_sample(self, rng: np.random.Generator, batch: int
                      ) -> np.ndarray:
        # Exactly the pre-refactor draw: one integers() call over the
        # occupied prefix [0, size).
        return rng.integers(0, self.occupancy, size=batch)

    @property
    def occupancy(self) -> int:
        return min(self.sampler.count, self.capacity)


@register_policy("ring")
class RingPolicy(ReplayPolicy):
    """FIFO ring: every offer is accepted and overwrites the oldest slot.
    Maximal recency — the right bias under fast domain drift, the wrong
    one for long-range retention. Identical to ``reservoir`` for the
    first ``capacity`` offers (both fill slots 0..capacity-1 in order)."""

    def __init__(self, capacity: int, seed: int = 7, *,
                 n_classes: Optional[int] = None,
                 n_tasks: Optional[int] = None):
        super().__init__(capacity, seed, n_classes=n_classes,
                         n_tasks=n_tasks)
        self.count = 0

    def select_insert(self, y: int, task_id: int = 0) -> Optional[int]:
        slot = self.count % self.capacity
        self.count += 1
        return slot

    def select_sample(self, rng: np.random.Generator, batch: int
                      ) -> np.ndarray:
        return rng.integers(0, self.occupancy, size=batch)

    @property
    def occupancy(self) -> int:
        return min(self.count, self.capacity)


class _BalancedPolicy(ReplayPolicy):
    """Shared machinery for group-balanced reservoirs (the CBRS scheme —
    Chrysakis & Moens 2020): the buffer always runs at full capacity;
    groups (classes or tasks) are discovered as they appear in the
    stream and share it dynamically.

      fill      while slots are free, every offer is accepted;
      largest   once full, an offer from a currently-largest group runs
                an in-group Algorithm-R (kept with probability
                m_g / n_g, replacing a uniformly drawn member);
      smaller   an offer from any other group always enters, evicting a
                uniformly drawn member of a (uniformly drawn) largest
                group.

    A *static* equal partition would idle the regions of groups that
    have not arrived yet — exactly when rehearsal diversity matters
    most; the dynamic share keeps every slot in use while guaranteeing
    that early groups are never crowded out (once full, group sizes
    re-balance toward ±1 of each other as new groups stream in).

    Slot selection draws from the policy's own Xorshift32 (the paper's
    hardware RNG) so schedules stay bit-reproducible; sampling is
    group-balanced — uniform over seen groups, then uniform within the
    group's members.
    """

    def __init__(self, capacity: int, seed: int = 7, **kwargs):
        super().__init__(capacity, seed, **kwargs)
        self._rng = Xorshift32(_region_seed(seed, 0))
        self._filled = 0
        # group key -> list of owned slot indices; insertion-ordered
        # (dict) so iteration order is deterministic.
        self._members: dict[int, list[int]] = {}
        self._seen: dict[int, int] = {}     # group -> stream count n_g

    def _group_of(self, y: int, task_id: int) -> int:
        raise NotImplementedError

    def select_insert(self, y: int, task_id: int = 0) -> Optional[int]:
        g = self._group_of(int(y), int(task_id))
        self._seen[g] = self._seen.get(g, 0) + 1
        members = self._members.setdefault(g, [])
        if self._filled < self.capacity:
            slot = self._filled
            self._filled += 1
            members.append(slot)
            return slot
        max_m = max(len(m) for m in self._members.values())
        if len(members) >= max_m:
            # Largest group: in-group reservoir over its own stream.
            j = self._rng.randint(1, self._seen[g])
            return members[j - 1] if j <= len(members) else None
        # Under-represented group: take a slot from a largest group.
        largest = [k for k, m in self._members.items()
                   if len(m) == max_m]
        donor = largest[self._rng.randint(0, len(largest) - 1)]
        k = self._rng.randint(0, max_m - 1)
        slot = self._members[donor].pop(k)
        members.append(slot)
        return slot

    def select_sample(self, rng: np.random.Generator, batch: int
                      ) -> np.ndarray:
        groups = [g for g, m in self._members.items() if m]
        counts = np.array([len(self._members[g]) for g in groups])
        gi = rng.integers(0, len(groups), size=batch)
        local = rng.integers(0, counts[gi])
        return np.array([self._members[groups[a]][b]
                         for a, b in zip(gi, local)])

    def group_sizes(self) -> dict[int, int]:
        """Buffer share per seen group (occupancy bookkeeping — the
        balance invariant the tests pin)."""
        return {g: len(m) for g, m in self._members.items()}

    @property
    def occupancy(self) -> int:
        return self._filled


@register_policy("class_balanced")
class ClassBalancedPolicy(_BalancedPolicy):
    """Class-balanced reservoir for the expanding-head
    ``class_incremental`` stream: seen classes share the full buffer
    dynamically (±1 once balanced), so early classes keep their share —
    and stay in the rehearsal mix — no matter how many new classes
    stream in later, and draws are class-uniform instead of
    stream-frequency-weighted. ``n_classes`` (the full head) is
    accepted for context but classes are discovered as they arrive."""

    def _group_of(self, y: int, task_id: int) -> int:
        return y


@register_policy("task_stratified")
class TaskStratifiedPolicy(_BalancedPolicy):
    """Task-stratified reservoir: seen tasks share the full buffer
    dynamically, so every past domain keeps representation regardless
    of how many examples later tasks stream; rehearsal is stratified
    uniformly over seen tasks."""

    def _group_of(self, y: int, task_id: int) -> int:
        return task_id


@register_policy("loss_aware")
class LossAwarePolicy(ReplayPolicy):
    """Loss-prioritized replay. Its priority is training state, so it
    cannot be materialized into a host schedule (``in_graph = True``):
    ``run_continual`` runs it on the device-resident buffer of
    :mod:`repro_torch.replay.ingraph` (class-aware eviction,
    class-normalized sampling, staleness decay), and the host hooks
    raise."""

    in_graph = True

    def select_insert(self, y: int, task_id: int = 0) -> Optional[int]:
        raise NotImplementedError(_LOSS_AWARE)

    def select_sample(self, rng: np.random.Generator, batch: int
                      ) -> np.ndarray:
        raise NotImplementedError(_LOSS_AWARE)

    @property
    def occupancy(self) -> int:
        return 0


_LOSS_AWARE = ("loss_aware is an in-graph replay policy with no host "
               "buffer: run_continual keeps its buffer on the device "
               "(repro_torch.replay.ingraph)")
