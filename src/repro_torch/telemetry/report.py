"""Run-level summaries: Table I / Fig. 5d / 29×-vs-CMOS from a live run —
counterpart of ``repro/telemetry/report.py``.

``telemetry_report`` assembles the metered numbers next to the analytical
cost model's so benchmarks and examples can assert agreement;
``cmos_comparison`` reproduces the 29× efficiency claim from two metered
runs of the same workload (analog + cmos backends); ``format_report``
renders a human-readable block, with the fleet's distributions
(``fleet=``, ``format_fleet``) and the run's timeline (``runlog=``,
``format_timeline``) under it.
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
    by side with the closed-form cost model for the same geometry.
    ``fleet`` (a :func:`repro_torch.fleet.fleet_aggregate` dict) attaches
    the population-distribution section ``format_report`` renders;
    ``runlog`` (a :class:`repro_torch.obs.RunLog`) attaches the
    ``timeline`` section — write-rate-over-time next to the lifetime
    projection, per-task forgetting next to the final scalar."""
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
    if fleet is not None:
        out["fleet"] = fleet
    if runlog is not None:
        from repro_torch.obs.runlog import timeline
        out["timeline"] = timeline(runlog)
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
    if "fleet" in rep:
        lines.append(format_fleet(rep["fleet"]))
    if "timeline" in rep:
        lines.append(format_timeline(rep["timeline"]))
    return "\n".join(lines)


#: Timeline streams rendered by :func:`format_timeline`, in display
#: order: (timeline key, label, formatter for the aggregate column).
_TIMELINE_ROWS = (
    ("loss", "loss", lambda v: f"last {v[-1]:.4f}"),
    ("write_pulses", "write pulses", lambda v: f"Σ {sum(v):.0f}"),
    ("dg_mag", "Σ|ΔG|", lambda v: f"Σ {sum(v):.3g}"),
    ("replay_occupancy", "replay fill", lambda v: f"max {max(v):.0f}"),
    ("drift_ticks", "drift ticks", lambda v: f"Σ {sum(v):.0f}"),
)


def format_timeline(tl: dict) -> str:
    """Printable timeline block (from :func:`repro_torch.obs.timeline`):
    sparkline per stream — the *when* next to the report's lifetime
    aggregates — plus the per-task forgetting trajectory."""
    from repro_torch.obs.runlog import sparkline
    lines = [f"timeline: {tl['n_steps']} steps @ cadence "
             f"{tl['cadence']} ({len(tl['steps'])} windows)"]
    for key, label, agg in _TIMELINE_ROWS:
        v = tl.get(key)
        if not v:
            continue
        if key == "drift_ticks" and not any(v):
            continue
        lines.append(f"  {label:<18} {sparkline(v):<48} {agg(v)}")
    fg = tl.get("forgetting_after_task")
    if fg is not None and len(fg) > 1:
        lines.append("  forgetting/task    "
                     + " ".join(f"{v:.3f}" for v in fg))
    return "\n".join(lines)


#: Fleet distributions rendered by :func:`format_fleet`, in display
#: order: (result key, label, unit).
_FLEET_ROWS = (
    ("average_accuracy", "accuracy", ""),
    ("forgetting", "forgetting", ""),
    ("power_mw", "power", " mW"),
    ("gops_per_w", "efficiency", " GOPS/W"),
    ("pj_per_op", "energy/op", " pJ"),
    ("lifetime_years", "lifetime", " years"),
    ("lifetime_hot_tail_years", "lifetime hot-tail", " years"),
    ("writes_per_device_update", "ζ write rate", ""),
)


def format_fleet(agg: dict) -> str:
    """Printable fleet-distribution block (from
    :func:`repro_torch.fleet.fleet_aggregate`): one row per figure with
    the population p50/p95/p99 — the tail chip, not the mean."""
    prof = agg.get("het_profile") or "none"
    lines = [f"fleet: {agg['n_devices']} devices over "
             f"{agg.get('n_shards', 1)} shard(s), heterogeneity "
             f"'{prof}'"]
    for key, label, unit in _FLEET_ROWS:
        if key not in agg:
            continue
        d = agg[key]
        lines.append(
            f"  {label:<18} p50 {d['p50']:10.4g}  p95 {d['p95']:10.4g}  "
            f"p99 {d['p99']:10.4g}{unit}")
    hot = agg.get("hot_tail") or {}
    if hot:
        lines.append("  worst chips        "
                     + "  ".join(f"{k.replace('_device', '')}: #{v}"
                                 for k, v in sorted(hot.items())))
    return "\n".join(lines)
