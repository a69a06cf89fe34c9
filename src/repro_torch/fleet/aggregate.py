"""Fleet-aggregate telemetry: population distributions, not means —
counterpart of ``repro/fleet/aggregate.py``.

A deployment decision about an edge fleet hinges on the tail chip, not
the average one. This module folds one :func:`repro_torch.fleet.run_fleet`
result into per-device figures and summarizes each as a distribution —
p50/p95/p99 plus a hot-tail index naming the worst chip.

Per-device energy books come from the fleet's telemetry: every counter
the forward meters is the same for every chip (each ran the same
shapes), so a chip's static share is ``total / n_devices``; only the
write pulses differ per chip, and those come back as per-chip count
maps. Each chip's counters then go through the same
:class:`~repro_torch.telemetry.energy.MeteredEnergy` fold as a one-chip
report. Lifetime is projected per chip from its own write map.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np

from repro_torch.analog.costmodel import HardwareConstants
from repro_torch.analog.endurance import EnduranceTracker
from repro_torch.telemetry import meters
from repro_torch.telemetry.energy import MeteredEnergy
from repro_torch.telemetry.lifetime import project_lifetime

__all__ = ["fleet_aggregate", "distribution"]

#: Percentiles every fleet distribution reports.
PERCENTILES = (50, 95, 99)


def distribution(values) -> dict[str, float]:
    """Summary statistics of one per-device figure across the fleet."""
    arr = np.asarray(list(values), np.float64)
    out = {
        "mean": float(arr.mean()),
        "std": float(arr.std()),
        "min": float(arr.min()),
        "max": float(arr.max()),
    }
    for p in PERCENTILES:
        out[f"p{p}"] = float(np.percentile(arr, p))
    return out


def _per_device_counters(snapshot: dict[str, int], n_devices: int,
                         updates_per_device: int,
                         wcounts: Optional[dict[str, np.ndarray]],
                         device: int) -> dict[str, float]:
    """One chip's counters: the fleet-symmetric static share plus the
    chip's own write pulses."""
    c: dict[str, float] = {
        k: v / n_devices for k, v in snapshot.items()
        if not k.startswith(meters.WRITE_PULSES)
        and k != meters.WRITE_EVENTS}
    c[meters.WRITE_EVENTS] = float(updates_per_device)
    for name, arr in (wcounts or {}).items():
        c[f"{meters.WRITE_PULSES}/{name}"] = float(
            np.asarray(arr[device]).sum())
    return c


def fleet_aggregate(result: dict[str, Any], *, model=None,
                    kind: str = "analog",
                    hw: Optional[HardwareConstants] = None,
                    update_period_s: float = 1e-3) -> dict[str, Any]:
    """Fold a ``run_fleet`` result into population distributions.

    Always reports the learning distributions (``average_accuracy``,
    ``forgetting``). Energy needs a metered run (``result["telemetry"]``),
    lifetime the per-device write maps (``result["wcounts"]``), the
    ``faults`` section a run under a FaultSpec; a section whose inputs
    are missing is left out. ``hot_tail`` names the worst chip per axis.
    """
    D = int(result["n_devices"])
    per_device = result["per_device"]
    updates = int(result["updates_per_device"])
    wcounts = result.get("wcounts")

    acc = [p["metrics"]["average_accuracy"] for p in per_device]
    forg = [p["metrics"]["forgetting"] for p in per_device]
    out: dict[str, Any] = {
        "n_devices": D,
        "n_shards": int(result.get("n_shards", 1)),
        "het_profile": (result["fleet"].het_profile
                        if "fleet" in result else None),
        "updates_per_device": updates,
        "average_accuracy": distribution(acc),
        "forgetting": distribution(forg),
    }
    hot: dict[str, int] = {
        "min_accuracy_device": int(np.argmin(acc)),
        "max_forgetting_device": int(np.argmax(forg)),
    }

    finfo = result.get("faults")
    if finfo is not None:
        # The fault-stricken tail: accuracy's lower percentiles, the
        # dead-chip census and the severity spread the chips drew.
        acc_arr = np.asarray(acc, np.float64)
        dead = finfo.get("dead_chips")
        sec: dict[str, Any] = {
            "dead_chip_count": int(np.asarray(dead).sum())
            if dead is not None else 0,
            "stricken_tail_accuracy": {
                "p1": float(np.percentile(acc_arr, 1)),
                "p5": float(np.percentile(acc_arr, 5)),
                "min": float(acc_arr.min()),
            },
        }
        scale = finfo.get("rate_scale")
        if scale is not None:
            sec["rate_scale"] = distribution(scale)
            hot["max_fault_rate_device"] = int(np.argmax(scale))
        if dead is not None and np.asarray(dead).any():
            sec["dead_devices"] = [int(i) for i in
                                   np.flatnonzero(np.asarray(dead))]
        out["faults"] = sec

    tele = result.get("telemetry")
    if tele is not None and getattr(tele, "enabled", False):
        snap = tele.snapshot()
        me = MeteredEnergy(model)
        reports = [me.report(
            _per_device_counters(snap, D, updates, wcounts, d), kind=kind)
            for d in range(D)]
        out["power_mw"] = distribution(
            [r.power_w * 1e3 for r in reports])
        out["power_training_mw"] = distribution(
            [r.power_training_w * 1e3 for r in reports])
        out["gops_per_w"] = distribution([r.gops_per_w for r in reports])
        out["pj_per_op"] = distribution([r.pj_per_op for r in reports])
        out["energy_mj"] = distribution(
            [r.energy_j * 1e3 for r in reports])
        hot["max_power_device"] = int(np.argmax(
            [r.power_training_w for r in reports]))

    if wcounts:
        projections = []
        for d in range(D):
            tracker = EnduranceTracker()
            tracker.record_counts(
                {n: np.asarray(arr[d]) for n, arr in wcounts.items()},
                updates)
            projections.append(project_lifetime(
                tracker, hw, update_period_s).as_dict())
        out["lifetime_years"] = distribution(
            [p["years_mean"] for p in projections])
        out["lifetime_hot_tail_years"] = distribution(
            [p["years_hot_tail"] for p in projections])
        out["writes_per_device_update"] = distribution(
            [p["writes_per_device_update"] for p in projections])
        rp = [p["rate_percentiles"] for p in projections
              if p.get("rate_percentiles")]
        if rp:
            out["zeta_rate_percentiles"] = {
                k: distribution([r[k] for r in rp]) for k in rp[0]}
        hot["min_lifetime_device"] = int(np.argmin(
            [p["years_mean"] for p in projections]))
        out["per_device_lifetime"] = projections

    out["hot_tail"] = hot
    return out
