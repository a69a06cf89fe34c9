"""Device activity counters (the energy, report and lifetime modules
arrive with the telemetry slice)."""
from repro_torch.telemetry.meters import Telemetry

__all__ = ["Telemetry"]
