"""Device-resident slab of per-user recurrent state — the MiRU "KV cache".

Counterpart of ``repro/serve/slab.py``. A served user's whole
conversation state is one (n_h,) hidden vector, so the serving cache is
one (n_slots, n_h) tensor on the device: slot i holds user i's ``h`` and
the engine step advances every row at once. :class:`StateSlab` owns that
tensor plus the slot bookkeeping:

  acquire(uid)   make ``uid`` resident and return its slot — reusing its
                 slot, taking a free one (zero state for a new user,
                 reloading spilled state bit-identically for a returning
                 one), or evicting the least-recently-used unpinned
                 resident when the slab is full.
  pin/unpin      streams scheduled into the batch are pinned: the evictor
                 never takes their slot mid-flight.
  release(uid)   drop the user's state entirely (session over).
  evict(uid)     spill the row to host numpy and free the slot.

Spill/reload is bit-exact: a float32 row round-trips device → host numpy
→ device unchanged. Rows are written in place (``h[slot] = row``), in
stream order after any step that produced ``h``.

Invariants (checked by :meth:`check`): every slot is free or mapped to
exactly one uid; the LRU book tracks exactly the resident uids; no uid is
both resident and spilled; only residents are pinned.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Hashable, Optional, Union

import numpy as np
import torch

from repro_torch.utils import resolve_device

__all__ = ["StateSlab", "SlabFullError"]


class SlabFullError(RuntimeError):
    """Every slot is occupied by a pinned (mid-batch) stream."""


class StateSlab:
    def __init__(self, n_slots: int, n_h: int,
                 dtype: torch.dtype = torch.float32,
                 device: Union[str, torch.device] = "cuda"):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = int(n_slots)
        self.n_h = int(n_h)
        self.dtype = dtype
        self.device = resolve_device(device)
        #: The state tensor. The engine reads it as the step's h0 and
        #: assigns the step's masked-writeback output back to it.
        self.h = torch.zeros((self.n_slots, self.n_h), dtype=dtype,
                             device=self.device)
        self._slot_of: dict[Hashable, int] = {}
        self._uid_of: list[Optional[Hashable]] = [None] * self.n_slots
        # Free slots as a stack, lowest index on top: allocation order is
        # deterministic, which the invariance tests use to build slot
        # permutations.
        self._free: list[int] = list(range(self.n_slots))[::-1]
        self._lru: OrderedDict[Hashable, None] = OrderedDict()
        self._pinned: set[Hashable] = set()
        self._spill: dict[Hashable, np.ndarray] = {}
        self.evictions = 0
        self.reloads = 0

    # ------------------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def resident(self) -> tuple[Hashable, ...]:
        """Resident uids in LRU → MRU order."""
        return tuple(self._lru)

    @property
    def spilled(self) -> tuple[Hashable, ...]:
        return tuple(self._spill)

    def slot(self, uid: Hashable) -> Optional[int]:
        return self._slot_of.get(uid)

    def is_resident(self, uid: Hashable) -> bool:
        return uid in self._slot_of

    def can_acquire(self, uid: Hashable) -> bool:
        """Would :meth:`acquire` succeed without raising SlabFullError?"""
        return bool(uid in self._slot_of or self._free
                    or any(u not in self._pinned for u in self._lru))

    # ------------------------------------------------------------------
    def acquire(self, uid: Hashable) -> int:
        """Make ``uid`` resident and MRU; return its slot."""
        slot = self._slot_of.get(uid)
        if slot is not None:
            self.touch(uid)
            return slot
        if not self._free:
            self._evict_lru()
        slot = self._free.pop()
        self._slot_of[uid] = slot
        self._uid_of[slot] = uid
        self._lru[uid] = None
        if uid in self._spill:
            # Returning user: reload the spilled row bit-identically.
            self.h[slot] = torch.from_numpy(self._spill.pop(uid)).to(
                self.device)
            self.reloads += 1
        else:
            # New user: zero state (the slot may hold a departed user's h).
            self.h[slot] = 0
        return slot

    def touch(self, uid: Hashable) -> None:
        """Mark ``uid`` most-recently-used."""
        self._lru.move_to_end(uid)

    def pin(self, uid: Hashable) -> None:
        """Exclude a resident uid from eviction (it is in the batch)."""
        if uid not in self._slot_of:
            raise KeyError(f"cannot pin non-resident uid {uid!r}")
        self._pinned.add(uid)

    def unpin(self, uid: Hashable) -> None:
        self._pinned.discard(uid)

    def release(self, uid: Hashable) -> None:
        """Forget ``uid`` — resident or spilled. No-op if unknown."""
        slot = self._slot_of.pop(uid, None)
        if slot is not None:
            self._uid_of[slot] = None
            self._free.append(slot)
            del self._lru[uid]
        self._pinned.discard(uid)
        self._spill.pop(uid, None)

    def evict(self, uid: Hashable) -> None:
        """Spill ``uid``'s row to host memory and free its slot."""
        if uid in self._pinned:
            raise ValueError(f"cannot evict pinned uid {uid!r}")
        slot = self._slot_of.pop(uid)
        self._spill[uid] = self.h[slot].cpu().numpy().copy()
        self._uid_of[slot] = None
        self._free.append(slot)
        del self._lru[uid]
        self.evictions += 1

    def _evict_lru(self) -> None:
        for uid in self._lru:                 # LRU → MRU order
            if uid not in self._pinned:
                self.evict(uid)
                return
        raise SlabFullError(
            f"all {self.n_slots} slots are pinned mid-batch; "
            "hold the request in the queue until a stream completes")

    def preload(self, uid: Hashable, row: np.ndarray) -> None:
        """Seed ``uid``'s state as a host-spilled row (the chip-failure
        migration path: the next ``acquire`` reloads it bit-exactly)."""
        if uid in self._slot_of:
            raise ValueError(f"uid {uid!r} is already resident")
        row = np.asarray(row)
        if row.shape != (self.n_h,):
            raise ValueError(f"row must be ({self.n_h},), got {row.shape}")
        self._spill[uid] = row

    # ------------------------------------------------------------------
    def read(self, uid: Hashable) -> np.ndarray:
        """Host copy of ``uid``'s current state (resident or spilled)."""
        slot = self._slot_of.get(uid)
        if slot is not None:
            return self.h[slot].cpu().numpy().copy()
        return np.array(self._spill[uid])

    def stats(self) -> dict:
        return {"n_slots": self.n_slots, "resident": len(self._slot_of),
                "free": len(self._free), "spilled": len(self._spill),
                "evictions": self.evictions, "reloads": self.reloads}

    def check(self) -> None:
        """Raise AssertionError if a structural invariant is broken."""
        occupied = {s for s, u in enumerate(self._uid_of) if u is not None}
        free = set(self._free)
        problems = [
            (len(self._free) != len(free), "duplicate free slots"),
            (bool(occupied & free), "slot both free and occupied"),
            (occupied | free != set(range(self.n_slots)),
             "free-list conservation violated"),
            (len(self._slot_of) != len(occupied), "double occupancy"),
            (any(self._uid_of[s] != u for u, s in self._slot_of.items()),
             "slot_of/uid_of disagree"),
            (set(self._lru) != set(self._slot_of), "LRU book != resident set"),
            (bool(set(self._spill) & set(self._slot_of)),
             "uid both resident and spilled"),
            (not self._pinned <= set(self._slot_of), "pinned non-resident"),
        ]
        for bad, what in problems:
            if bad:
                raise AssertionError(what)

    def __repr__(self) -> str:
        return (f"<StateSlab {len(self._slot_of)}/{self.n_slots} resident, "
                f"{len(self._spill)} spilled, {self.evictions} evictions>")
