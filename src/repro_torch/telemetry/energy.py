"""Counters → joules / seconds / GOPS via :class:`HardwareConstants` —
counterpart of ``repro/telemetry/energy.py``, the same arithmetic in the
same order, so equal counters give equal figures.

The analytical model (``analog/costmodel.py``) computes chip time and ops
per step from the architecture; here the same per-event costs are applied
to *metered* counters from a live run, so latency, throughput, power and
efficiency are derived from what the backend actually executed:

  chip cycles  = WBS streaming phases (hidden tile; the U_h tile shares
                 wordlines and runs concurrently) + ADC channel scans
                 (hidden + readout, ceil'd per scan to whole cycles)
                 + λ-interpolation cycles + readout streaming phases
  chip time    = cycles × T_clk
  energy       = Σ_component  P_component × chip time   (the mixed-signal
                 budget is dominated by always-on analog front-end blocks;
                 their energy accrues over busy time)
  ops          = 2 × MACs + 3 × interpolations

The digital-CMOS baseline charges the paper-calibrated per-op energy of a
65 nm 8-bit digital MAC datapath at iso-throughput
(``M2RUCostModel.digital_pj_per_op``) against the same metered op counts.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

from repro_torch.analog.costmodel import DenseCostModel, M2RUCostModel
from repro_torch.telemetry import meters as M

#: Off-chip DRAM access energy for the replay buffer, pJ per byte
#: (edge-class LPDDR4x, ≈5 pJ/bit incl. I/O + activation amortization).
#: Replay traffic is *off-chip*: it is reported alongside the chip
#: numbers (``telemetry_report``'s ``replay`` section) but deliberately
#: not folded into the chip power/efficiency that the analytical-model
#: 5 % agreement gates check.
DRAM_PJ_PER_BYTE = 40.0


def replay_traffic(counters: Mapping[str, int]) -> Optional[dict]:
    """Replay-buffer DRAM traffic summary from metered counters, or None
    when the run metered no replay activity."""
    reads = float(counters.get(M.REPLAY_READS, 0))
    writes = float(counters.get(M.REPLAY_WRITES, 0))
    if reads == 0 and writes == 0:
        return None
    nbytes = float(counters.get(M.REPLAY_READ_BYTES, 0)
                   + counters.get(M.REPLAY_WRITE_BYTES, 0))
    return {
        "rows_read": reads,
        "rows_written": writes,
        "bytes": nbytes,
        "dram_pj_per_byte": DRAM_PJ_PER_BYTE,
        "dram_energy_j": nbytes * DRAM_PJ_PER_BYTE * 1e-12,
    }


@dataclasses.dataclass(frozen=True)
class EnergyReport:
    """Metered energy/latency summary of one workload on one substrate."""
    kind: str                       # "analog" | "cmos"
    cycles: float                   # chip clock cycles (analog) / equiv
    time_s: float                   # chip busy time
    ops: float                      # arithmetic ops (MAC = 2)
    energy_j: float
    breakdown_j: dict[str, float]   # per-component energy
    power_w: float
    power_training_w: float         # + projection/write-control when writes
    gops: float
    gops_per_w: float
    pj_per_op: float
    sample_steps: float             # recurrence rows metered
    write_pulses: float             # programmed synapses metered

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _meter(counters: Mapping[str, int], name: str, tag: str = "") -> float:
    if tag:
        return float(counters.get(f"{name}/{tag}", 0))
    prefix = name + "/"
    return float(sum(v for k, v in counters.items()
                     if k == name or k.startswith(prefix)))


class MeteredEnergy:
    """Fold a :class:`Telemetry` counter snapshot into an
    :class:`EnergyReport` for the M2RU chip geometry in ``model``."""

    def __init__(self, model: "Optional[M2RUCostModel | DenseCostModel]"
                 = None):
        self.model = model if model is not None else M2RUCostModel()

    # ------------------------------------------------------------------
    def _ops(self, counters: Mapping[str, int]) -> float:
        return 2.0 * _meter(counters, M.MACS) + 3.0 * _meter(counters,
                                                             M.INTERP)

    def ops(self, counters: Mapping[str, int]) -> float:
        """Metered arithmetic ops (MAC = 2) across all tags — workload-
        agnostic, unlike the M2RU-geometry cycle model the full reports
        use. The serve engine's pJ/request falls back to this when the
        workload's tags don't map onto the chip geometry."""
        return self._ops(counters)

    def _chip_cycles(self, counters: Mapping[str, int]) -> float:
        m = self.model
        # Hidden crossbar: [W_h; U_h] share wordlines (Fig. 2) and stream
        # the concatenated drive concurrently — one set of phases, keyed
        # off the W_h tile.
        cycles = _meter(counters, M.WBS_PHASES, "w_h")
        hidden_scans = _meter(counters, M.ADC_CONVERSIONS, "hidden") / m.n_h
        cycles += hidden_scans * m.adc_scan_cycles(m.n_h)
        interp_scans = _meter(counters, M.INTERP, "h") / m.n_h
        cycles += interp_scans * m.interp_cycles()
        cycles += _meter(counters, M.WBS_PHASES, "w_o")
        out_scans = _meter(counters, M.ADC_CONVERSIONS, "out") / m.n_y
        cycles += out_scans * m.adc_scan_cycles(m.n_y)
        return cycles

    # ------------------------------------------------------------------
    def analog_report(self, counters: Mapping[str, int]) -> EnergyReport:
        """Mixed-signal M2RU: component powers over metered busy time."""
        m = self.model
        cycles = self._chip_cycles(counters)
        if cycles <= 0:
            raise ValueError(
                "telemetry has no metered forward activity; enable the "
                "backend's telemetry before the first step is traced")
        time_s = cycles * m.cycle_s
        brk_w = m.power_breakdown_w(training=False)
        breakdown_j = {k: p * time_s for k, p in brk_w.items()}
        energy_j = sum(breakdown_j.values())
        ops = self._ops(counters)
        power_w = energy_j / time_s
        p_train = power_w + (m.hw.p_train_extra_w
                             if _meter(counters, M.WRITE_EVENTS) > 0
                             else 0.0)
        gops = ops / time_s / 1e9
        return EnergyReport(
            kind="analog", cycles=cycles, time_s=time_s, ops=ops,
            energy_j=energy_j, breakdown_j=breakdown_j, power_w=power_w,
            power_training_w=p_train, gops=gops,
            gops_per_w=gops / power_w,
            pj_per_op=energy_j / ops * 1e12,
            sample_steps=_meter(counters, M.SAMPLE_STEPS),
            write_pulses=_meter(counters, M.WRITE_PULSES))

    # ------------------------------------------------------------------
    def cmos_report(self, counters: Mapping[str, int]) -> EnergyReport:
        """Digital 65 nm baseline at iso-throughput: the paper-calibrated
        per-op energy (MAC + memory traffic) charged per metered op."""
        m = self.model
        ops = self._ops(counters)
        if ops <= 0:
            raise ValueError("telemetry has no metered forward activity")
        e_op = m.digital_pj_per_op() * 1e-12
        energy_j = ops * e_op
        time_s = ops / (m.gops() * 1e9)        # iso-throughput comparison
        power_w = energy_j / time_s
        return EnergyReport(
            kind="cmos", cycles=time_s / m.cycle_s, time_s=time_s, ops=ops,
            energy_j=energy_j, breakdown_j={"digital_mac": energy_j},
            power_w=power_w, power_training_w=power_w,
            gops=ops / time_s / 1e9, gops_per_w=(ops / time_s / 1e9)
            / power_w, pj_per_op=e_op * 1e12,
            sample_steps=_meter(counters, M.SAMPLE_STEPS),
            write_pulses=_meter(counters, M.WRITE_PULSES))

    # ------------------------------------------------------------------
    def dense_report(self, counters: Mapping[str, int],
                     model: Optional[DenseCostModel] = None,
                     tag: str = "dense") -> EnergyReport:
        """Transformer-shape serving energy: the metered ``dense``-tag
        activity (every quantized projection in the model zoo's LM
        layers) charged through a :class:`DenseCostModel` of the served
        architecture. Iso-throughput like :meth:`cmos_report`: busy time
        is metered ops over the stack's analytical GOPS, so power,
        GOPS/W and pJ/op are the model's figures while total energy and
        time scale with what the engine actually dispatched."""
        m = model if model is not None else self.model
        if not isinstance(m, DenseCostModel):
            raise ValueError(
                "dense_report needs a DenseCostModel (pass one, or "
                "construct MeteredEnergy with it); got "
                f"{type(m).__name__}")
        ops = 2.0 * _meter(counters, M.MACS, tag)
        if ops <= 0:
            raise ValueError(
                f"telemetry has no metered {tag!r} activity; enable the "
                "substrate's telemetry before the first step is traced")
        time_s = ops / (m.gops() * 1e9)
        brk_w = m.power_breakdown_w()
        breakdown_j = {k: p * time_s for k, p in brk_w.items()}
        energy_j = sum(breakdown_j.values())
        power_w = energy_j / time_s
        gops = ops / time_s / 1e9
        token_rows = _meter(counters, M.VMM_ROWS, tag) / m.n_projections
        return EnergyReport(
            kind="dense", cycles=token_rows * m.row_cycles(),
            time_s=time_s, ops=ops, energy_j=energy_j,
            breakdown_j=breakdown_j, power_w=power_w,
            power_training_w=power_w, gops=gops,
            gops_per_w=gops / power_w,
            pj_per_op=energy_j / ops * 1e12,
            sample_steps=token_rows,
            write_pulses=_meter(counters, M.WRITE_PULSES))

    def report(self, counters: Mapping[str, int],
               kind: str = "analog") -> EnergyReport:
        if kind == "analog":
            return self.analog_report(counters)
        if kind == "cmos":
            return self.cmos_report(counters)
        if kind == "dense":
            return self.dense_report(counters)
        raise ValueError(f"unknown substrate kind {kind!r}; "
                         "expected 'analog', 'cmos' or 'dense'")


def efficiency_ratio(analog: EnergyReport, cmos: EnergyReport) -> float:
    """Per-op energy ratio (the paper's 29× claim), robust to the two runs
    metering slightly different numbers of steps."""
    return cmos.pj_per_op / analog.pj_per_op
