"""Run-level summaries: Table I / Fig. 5d / 29×-vs-CMOS from a live run —
counterpart of ``repro/telemetry/report.py``.

``telemetry_report`` assembles the metered numbers next to the analytical
cost model's so benchmarks and examples can assert agreement;
``cmos_comparison`` reproduces the 29× efficiency claim from two metered
runs of the same workload (analog + cmos backends); ``format_report``
renders a human-readable block. The fleet and timeline sections
(``fleet=``, ``runlog=``; ``format_fleet``, ``format_timeline``) wait for
the port of ``fleet/`` and ``obs/`` and raise.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.analog.costmodel import M2RUCostModel
from repro_torch.analog.endurance import EnduranceTracker
from repro_torch.telemetry.energy import (MeteredEnergy, efficiency_ratio,
                                          replay_traffic)
from repro_torch.telemetry.lifetime import project_lifetime
from repro_torch.telemetry.meters import Telemetry


def telemetry_report(telemetry: Telemetry,
                     model: Optional[M2RUCostModel] = None,
                     kind: str = "analog",
                     tracker: Optional[EnduranceTracker] = None,
                     update_period_s: float = 1e-3,
                     fleet: Optional[dict] = None,
                     runlog: Optional[object] = None) -> dict:
    """Metered Table I numbers (+ lifetime when a tracker is given), side
    by side with the closed-form cost model for the same geometry."""
    if fleet is not None or runlog is not None:
        raise NotImplementedError(
            "the fleet and timeline sections are not ported yet (ROADMAP "
            "queue A, obs/ and fleet/)")
    model = model if model is not None else M2RUCostModel()
    energy = MeteredEnergy(model)
    counters = telemetry.snapshot()
    rep = energy.report(counters, kind=kind)
    out = {
        "kind": kind,
        "metered": {
            "cycles": rep.cycles,
            "chip_time_s": rep.time_s,
            "ops": rep.ops,
            "power_mw": rep.power_w * 1e3,
            "power_training_mw": rep.power_training_w * 1e3,
            "gops": rep.gops,
            "gops_per_w": rep.gops_per_w,
            "pj_per_op": rep.pj_per_op,
            "breakdown_mw": {k: v / rep.time_s * 1e3
                             for k, v in rep.breakdown_j.items()},
            "sample_steps": rep.sample_steps,
            "write_pulses": rep.write_pulses,
        },
        "analytical": {
            "power_mw": model.power_w() * 1e3,
            "gops": model.gops(),
            "gops_per_w": model.gops_per_watt(),
            "pj_per_op": model.pj_per_op(),
            "step_latency_us": model.step_latency_s() * 1e6,
        },
    }
    if rep.sample_steps > 0:
        out["metered"]["step_latency_us"] = rep.time_s / rep.sample_steps \
            * 1e6
    # Off-chip replay-buffer DRAM traffic: reported next to — not inside —
    # the chip power budget (see energy.replay_traffic).
    replay = replay_traffic(counters)
    if replay is not None:
        out["replay"] = replay
    if tracker is not None and tracker.updates_applied:
        out["lifetime"] = project_lifetime(
            tracker, model.hw, update_period_s).as_dict()
    return out


def cmos_comparison(telemetry_analog: Telemetry, telemetry_cmos: Telemetry,
                    model: Optional[M2RUCostModel] = None) -> dict:
    """The 29× claim from two metered runs of the same workload."""
    model = model if model is not None else M2RUCostModel()
    energy = MeteredEnergy(model)
    a = energy.analog_report(telemetry_analog.snapshot())
    c = energy.cmos_report(telemetry_cmos.snapshot())
    return {
        "analog_pj_per_op": a.pj_per_op,
        "cmos_pj_per_op": c.pj_per_op,
        "cmos_power_mw": c.power_w * 1e3,
        "efficiency_gain": efficiency_ratio(a, c),
        "paper_gain": 29.0,
    }


def format_report(rep: dict) -> str:
    """Printable telemetry block for the example scripts."""
    m, a = rep["metered"], rep["analytical"]
    lines = [
        f"substrate: {rep['kind']}  "
        f"(metered {m['sample_steps']:.0f} sample-steps, "
        f"{m['ops']:.3g} ops)",
        f"  chip time          {m['chip_time_s']*1e3:9.3f} ms  "
        f"({m.get('step_latency_us', float('nan')):.2f} µs/step; "
        f"model {a['step_latency_us']:.2f})",
        f"  power              {m['power_mw']:9.2f} mW  "
        f"(model {a['power_mw']:.2f}; training "
        f"{m['power_training_mw']:.2f})",
        f"  throughput         {m['gops']:9.2f} GOPS (model {a['gops']:.2f})",
        f"  efficiency         {m['gops_per_w']:9.0f} GOPS/W "
        f"(model {a['gops_per_w']:.0f})",
        f"  energy/op          {m['pj_per_op']:9.2f} pJ "
        f"(model {a['pj_per_op']:.2f})",
    ]
    if m["write_pulses"]:
        lines.append(f"  write pulses       {m['write_pulses']:9.0f}")
    if "replay" in rep:
        r = rep["replay"]
        lines.append(
            f"  replay DRAM        {r['bytes']/1024:9.1f} KiB  "
            f"({r['rows_read']:.0f} reads / {r['rows_written']:.0f} "
            f"writes; ≈{r['dram_energy_j']*1e6:.1f} µJ off-chip @ "
            f"{r['dram_pj_per_byte']:.0f} pJ/B)")
    if "lifetime" in rep:
        lt = rep["lifetime"]
        lines.append(
            f"  projected lifetime {lt['years_mean']:9.1f} years @"
            f"{lt['update_period_s']*1e3:.0f} ms updates "
            f"(hot-tail {lt['years_hot_tail']:.1f}; "
            f"{lt['writes_per_device_update']:.2f} writes/device/update)")
        if lt.get("rate_percentiles"):
            rp = lt["rate_percentiles"]
            lines.append(
                "  ζ write-rate       "
                + "  ".join(f"{k} {v:.3f}" for k, v in rp.items())
                + "  writes/device/update")
    return "\n".join(lines)
