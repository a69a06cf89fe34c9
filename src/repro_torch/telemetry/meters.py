"""The :class:`Telemetry` accumulator — device activity counters.

Counterpart of ``repro/telemetry/meters.py``. Counters are host-side
Python integers keyed ``"<meter>/<tag>"`` (e.g. ``"macs/w_h"``). PyTorch
runs eagerly, so every meter hook counts the moment it is called: the
reference's pending-delta buffer and ``io_callback`` flush exist only
because a jitted body runs once at trace time, and are not ported. A
per-step loop meters once per step; a fused path that stands for T steps
meters once inside ``scaled(T)``, so both give the same totals.
"""
from __future__ import annotations

import contextlib
from collections import Counter
from typing import Mapping, Optional

import numpy as np

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

    def enable(self) -> "Telemetry":
        self.enabled = True
        return self

    def disable(self) -> "Telemetry":
        self.enabled = False
        return self

    def reset(self) -> None:
        self.counters.clear()

    def snapshot(self) -> dict[str, int]:
        return dict(self.counters)

    def total(self, meter: str) -> int:
        """Sum of one meter across all tags."""
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

    def meter_writes(self, masks: Mapping[str, "torch.Tensor"]) -> None:
        """Write pulses from concrete nonzero-update masks (only written
        devices cost a pulse — §VI-B), plus one write event."""
        if not self.enabled:
            return
        deltas = {f"{WRITE_PULSES}/{k}": int(m.sum()) for k, m in
                  masks.items()}
        deltas[WRITE_EVENTS] = 1
        self.record(deltas)

    def __repr__(self) -> str:
        state = "enabled" if self.enabled else "disabled"
        return f"<Telemetry {state} counters={len(self.counters)}>"
