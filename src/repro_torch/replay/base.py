"""The ``ReplayPolicy`` protocol and the name-keyed policy registry —
counterpart of ``repro/replay/base.py``.

A replay policy owns the two decisions the rehearsal pipeline makes:

  select-on-insert   which buffer slot (if any) an offered example
                     overwrites — the paper's counter + xorshift32 +
                     modulus hardware implements the ``reservoir``
                     answer (Algorithm R);
  select-on-sample   which occupied slots a rehearsal batch reads.

Policies are host-side objects driven by :class:`repro_torch.core.replay.
ReplayBuffer` while the batch schedule is materialized
(``core.continual.build_batch_schedule``). A policy whose insertion
decision depends on *training state* (``loss_aware``) cannot be
materialized up front: it sets ``in_graph = True``; the reference carries
a device-resident buffer through its step scan for it, which the port
does not have yet (ROADMAP queue A).

    @register_policy("my_policy")
    class MyPolicy(ReplayPolicy):
        def select_insert(self, y, task_id=0): ...
        def select_sample(self, rng, batch): ...

See the reference's docs/replay.md for the contracts each policy keeps.
"""
from __future__ import annotations

from typing import Optional, Type

import numpy as np


class ReplayPolicy:
    """Base class: slot selection for insert and sample.

    ``capacity`` is the total number of buffer slots; ``seed`` feeds the
    policy's own deterministic RNG (policies must never touch global RNG
    state — schedules are bit-reproducible). ``n_classes`` / ``n_tasks``
    give stream context to partitioned policies; unused kwargs are
    accepted so every policy constructs through one uniform signature.
    """

    name: str = "?"
    #: True when insertion depends on training state, so the buffer must
    #: live in-graph (scan-carried) instead of in the host schedule.
    in_graph: bool = False

    def __init__(self, capacity: int, seed: int = 7, *,
                 n_classes: Optional[int] = None,
                 n_tasks: Optional[int] = None):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self.seed = seed
        self.n_classes = n_classes
        self.n_tasks = n_tasks

    # ------------------------------------------------------------------
    def select_insert(self, y: int, task_id: int = 0) -> Optional[int]:
        """Offer one (label, task) example; return the slot index to
        overwrite, or None to reject the example."""
        raise NotImplementedError

    def select_sample(self, rng: np.random.Generator, batch: int
                      ) -> np.ndarray:
        """Return ``batch`` occupied slot indices for a rehearsal draw.
        Draws exclusively from ``rng`` (the schedule's host RNG)."""
        raise NotImplementedError

    @property
    def occupancy(self) -> int:
        """Number of currently occupied slots."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Type[ReplayPolicy]] = {}


def register_policy(name: str):
    """Register a policy class under ``name`` (usable as a decorator).
    Re-registering overwrites (tests, experiments)."""
    def _do(cls: Type[ReplayPolicy]) -> Type[ReplayPolicy]:
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return _do


def unregister_policy(name: str) -> None:
    """Remove a registered policy (test teardown helper)."""
    _REGISTRY.pop(name, None)


def available_policies() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_policy_class(name: str) -> Type[ReplayPolicy]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown replay policy {name!r}; "
            f"available: {', '.join(available_policies()) or '(none)'}"
        ) from None


def make_policy(name: str, capacity: int, seed: int = 7, *,
                n_classes: Optional[int] = None,
                n_tasks: Optional[int] = None, **kwargs) -> ReplayPolicy:
    """Instantiate a registered policy with stream context."""
    return get_policy_class(name)(capacity, seed, n_classes=n_classes,
                                  n_tasks=n_tasks, **kwargs)
