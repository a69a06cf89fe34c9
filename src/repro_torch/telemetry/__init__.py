"""Measured device telemetry — counters → energy/latency → paper claims.
Counterpart of ``repro/telemetry``:

- meters:   the Telemetry accumulator (ADC-conversion, bit-pulse,
            crossbar-read/write, MAC counters), eager.
- energy:   counters → joules / seconds / GOPS via HardwareConstants.
- lifetime: EnduranceTracker write maps → lifetime projection (§VI-B).
- report:   GOPS/W and 29×-vs-CMOS summaries.
"""
from repro_torch.telemetry.meters import Telemetry
from repro_torch.telemetry.energy import EnergyReport, MeteredEnergy
from repro_torch.telemetry.lifetime import (LifetimeProjection,
                                            project_lifetime)
from repro_torch.telemetry.report import (cmos_comparison, format_report,
                                          telemetry_report)

__all__ = [
    "Telemetry",
    "EnergyReport", "MeteredEnergy",
    "LifetimeProjection", "project_lifetime",
    "telemetry_report", "cmos_comparison", "format_report",
]
