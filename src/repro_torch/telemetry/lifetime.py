"""Metered lifetime projection — §VI-B / Fig. 5b from live write maps.
Counterpart of ``repro/telemetry/lifetime.py``.

``EnduranceTracker`` records which devices were actually written each
update during a run; this module folds that map into the paper's lifetime
figures. The bridge between *selected devices* and *endurance cycles* is
the Ziksa programming pulse train: reprogramming one selected synapse costs
``HardwareConstants.ziksa_pulse_rate`` endurance cycles in expectation
(calibrated from the paper's own dense-run statistics: a 6.9-year lifetime
at 10⁹ endurance and a 1 ms update cadence with every device selected
implies ≈4.59e-3 pulses per device-update — Ziksa fires a pulse only when
the accumulated conductance move exceeds a programming quantum). K-WTA
sparsification reduces the selected fraction to ζ ≈ 0.57, and the
projection lands at ≈12.2 years — both ends reproduced here from the
metered write counts alone.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.analog.costmodel import HardwareConstants
from repro_torch.analog.endurance import EnduranceTracker, lifespan_years


@dataclasses.dataclass(frozen=True)
class LifetimeProjection:
    """Lifetime figures derived from a metered write map."""
    updates_observed: int
    writes_per_device_update: float    # mean selected fraction
    pulses_per_device_update: float    # × Ziksa expected pulse rate
    years_mean: float                  # average device reaches endurance
    years_hot_tail: float              # 99th-percentile device (Fig. 5b tail)
    endurance_cycles: float
    update_period_s: float
    #: Per-cell ζ write-rate percentiles (writes per device-update at
    #: p50/p90/p99 across the write map) — the within-chip wear spread
    #: behind the mean/hot-tail pair above.
    rate_percentiles: Optional[dict[str, float]] = None

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def project_lifetime(tracker: EnduranceTracker,
                     hw: Optional[HardwareConstants] = None,
                     update_period_s: float = 1e-3) -> LifetimeProjection:
    """Fold a tracker's per-device write counts into a lifetime projection
    at the paper's update cadence."""
    hw = hw if hw is not None else HardwareConstants()
    updates = tracker.updates_applied
    if updates == 0:
        raise ValueError("tracker has observed no updates; run training "
                         "with track_endurance=True first")
    counts = tracker.all_counts()
    rate_mean = float(counts.mean()) / updates if counts.size else 0.0
    rate_hot = (float(np.percentile(counts, 99)) / updates
                if counts.size else 0.0)
    rate_pcts = ({f"p{p}": float(np.percentile(counts, p)) / updates
                  for p in (50, 90, 99)} if counts.size else None)
    pulses = rate_mean * hw.ziksa_pulse_rate
    return LifetimeProjection(
        updates_observed=updates,
        writes_per_device_update=rate_mean,
        pulses_per_device_update=pulses,
        years_mean=lifespan_years(pulses, hw.endurance_cycles,
                                  update_period_s),
        years_hot_tail=lifespan_years(
            rate_hot * hw.ziksa_pulse_rate, hw.endurance_cycles,
            update_period_s),
        endurance_cycles=hw.endurance_cycles,
        update_period_s=update_period_s,
        rate_percentiles=rate_pcts)
