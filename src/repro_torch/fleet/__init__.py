"""repro_torch.fleet — device-fleet simulation, counterpart of
``repro/fleet``: per-device draws (:mod:`.heterogeneity`), the runner
that trains every chip through the stream (:mod:`.run`, one chip after
another on one card) and the population distributions
(:mod:`.aggregate`)."""
from repro_torch.fleet.aggregate import distribution, fleet_aggregate
from repro_torch.fleet.heterogeneity import (HET_PROFILES, FleetSpec,
                                             HetProfile, device_seeds,
                                             draw_fleet_faults,
                                             draw_heterogeneity,
                                             overlay_device_states,
                                             overlay_fault_states,
                                             supports_heterogeneity)
from repro_torch.fleet.run import fleet_shard_count, run_fleet

__all__ = [
    "FleetSpec", "HetProfile", "HET_PROFILES",
    "device_seeds", "draw_heterogeneity", "draw_fleet_faults",
    "overlay_device_states", "overlay_fault_states",
    "supports_heterogeneity",
    "run_fleet", "fleet_shard_count",
    "fleet_aggregate", "distribution",
]
