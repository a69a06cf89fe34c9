"""The :class:`Telemetry` accumulator — device activity counters.

Counterpart of ``repro/telemetry/meters.py``. Counters are host-side
Python integers keyed ``"<meter>/<tag>"`` (e.g. ``"macs/w_h"``). PyTorch
runs eagerly, so every meter hook counts the moment it is called: the
reference's pending-delta buffer and ``io_callback`` flush exist only
because a jitted body runs once at trace time, and are not ported. A
per-step loop meters once per step; a fused path that stands for T steps
meters once inside ``scaled(T)``, so both give the same totals.

Write pulses are data-dependent: they are counted from the write masks
on the masks' device, into int64 tensors that stay there, and folded
into the integer counters when a caller reads them (:meth:`snapshot`,
:meth:`total`). A training loop on the card therefore meters every
update without a host sync, and the totals are exact.
"""
from __future__ import annotations

import contextlib
from collections import Counter
from typing import Mapping, Optional

import numpy as np
import torch

# Canonical meter names (the energy model keys off these).
MACS = "macs"                        # multiply-accumulates per tile
VMM_ROWS = "vmm_rows"                # row-vector crossbar accesses
BIT_PULSES = "bit_pulses"            # WBS input drive pulses (rows·n_in·n_b)
WBS_PHASES = "wbs_phases"            # bit-streaming phases (rows·n_b)
ADC_CONVERSIONS = "adc_conversions"  # per-channel ADC conversions
INTERP = "interp"                    # λ-interpolated candidate states
SAMPLE_STEPS = "sample_steps"        # (sample × time-step) recurrence rows
SEQUENCES = "sequences"              # sequences fully processed
WRITE_PULSES = "write_pulses"        # nonzero programmed synapses
WRITE_EVENTS = "write_events"        # weight-update rounds
DRIFT_TICKS = "drift_ticks"          # retention-drift relaxation ticks
# Replay-buffer DRAM traffic (§IV-A: the rehearsal store lives in
# off-chip DRAM): rows moved and bytes (quantized codes + int32 label).
REPLAY_READS = "replay_reads"                # rehearsal rows fetched
REPLAY_WRITES = "replay_writes"              # rows programmed into DRAM
REPLAY_READ_BYTES = "replay_read_bytes"
REPLAY_WRITE_BYTES = "replay_write_bytes"


class Telemetry:
    """Per-backend activity accumulator. Disabled by default."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.counters: Counter = Counter()
        self._scale = 1
        # Write-pulse counts not read back yet: int64 tensors on the
        # masks' device.
        self._pending: dict[str, "torch.Tensor"] = {}

    def enable(self) -> "Telemetry":
        self.enabled = True
        return self

    def disable(self) -> "Telemetry":
        self.enabled = False
        return self

    def reset(self) -> None:
        self.counters.clear()
        self._pending.clear()

    def _fold(self) -> None:
        """Read the pending device counts back into the counters."""
        for k, v in self._pending.items():
            self.counters[k] += int(v)
        self._pending.clear()

    def snapshot(self) -> dict[str, int]:
        self._fold()
        return dict(self.counters)

    def total(self, meter: str) -> int:
        """Sum of one meter across all tags."""
        self._fold()
        prefix = meter + "/"
        return sum(v for k, v in self.counters.items()
                   if k == meter or k.startswith(prefix))

    @contextlib.contextmanager
    def scaled(self, n: int):
        """Multiply deltas recorded inside the scope by ``n`` — for a
        call that stands for ``n`` executions of the metered step."""
        prev, self._scale = self._scale, self._scale * int(n)
        try:
            yield self
        finally:
            self._scale = prev

    @contextlib.contextmanager
    def diverted(self):
        """Count what is metered inside the scope into a Counter of its
        own, yielded, as if the telemetry were on and unscaled; the
        accumulator's counters, switch and scale are left as they were.
        For work the host runs once and the device then replays without
        it (a CUDA graph): its static deltas are recorded here at the
        capture and added with :meth:`record` on every replay."""
        saved = self.counters, self.enabled, self._scale
        self.counters, self.enabled, self._scale = Counter(), True, 1
        try:
            yield self.counters
        finally:
            self.counters, self.enabled, self._scale = saved

    def record(self, deltas: Mapping[str, int]) -> None:
        """Count static deltas now, times the active ``scaled`` scopes."""
        if not self.enabled:
            return
        for k, v in deltas.items():
            self.counters[k] += v * self._scale

    def meter_vmm(self, drive, weights, input_bits: Optional[int],
                  tag: str = "") -> None:
        """One backend VMM: every leading element of ``drive`` streams
        through the (n_in × n_out) tile."""
        if not self.enabled:
            return
        rows = int(np.prod(drive.shape[:-1])) if drive.ndim > 1 else 1
        n_in, n_out = weights.shape[-2], weights.shape[-1]
        sfx = f"/{tag}" if tag else ""
        deltas = {f"{VMM_ROWS}{sfx}": rows,
                  f"{MACS}{sfx}": rows * n_in * n_out}
        if input_bits:
            deltas[f"{BIT_PULSES}{sfx}"] = rows * n_in * input_bits
            deltas[f"{WBS_PHASES}{sfx}"] = rows * input_bits
        self.record(deltas)

    def meter_adc(self, x, tag: str = "") -> None:
        """Fused-readout ADC: one conversion per element."""
        if not self.enabled:
            return
        sfx = f"/{tag}" if tag else ""
        self.record({f"{ADC_CONVERSIONS}{sfx}": int(np.prod(x.shape))})

    def meter_write_counts(self, counts: Mapping[str, "torch.Tensor"],
                           events: int) -> None:
        """Write pulses from per-device write-count maps (or masks, a
        map of one update) accumulated over ``events`` weight-update
        rounds. The sums stay on the maps' device until read."""
        if not self.enabled:
            return
        for k, c in counts.items():
            name = f"{WRITE_PULSES}/{k}"
            s = torch.as_tensor(c).sum(dtype=torch.int64)
            self._pending[name] = s if name not in self._pending \
                else self._pending[name] + s
        self.counters[WRITE_EVENTS] += int(events)

    def meter_writes(self, masks: Mapping[str, "torch.Tensor"]) -> None:
        """Write pulses from the nonzero-update masks of one update (only
        written devices cost a pulse — §VI-B), plus one write event."""
        self.meter_write_counts(masks, 1)

    def __repr__(self) -> str:
        state = "enabled" if self.enabled else "disabled"
        return f"<Telemetry {state} counters={len(self.counters)}>"
