"""Mixed-signal hardware-like model of the M2RU accelerator.

- crossbar:   conductance-pair weight mapping + device non-idealities.
- wbs:        weighted-bit-streaming numerical model (eqs. 11-19).
- adc:        ADC quantization + integrator leakage model (eqs. 8-10).
- endurance:  per-device write counting, CDF, lifespan projection (Fig. 5b).
- costmodel:  cycle/power analytical model (Fig. 5c/5d, Table I).
"""
from repro_torch.analog.crossbar import (CrossbarSpec, CrossbarState,
                                        program, vmm)
from repro_torch.analog.wbs import WBSSpec, quantize_signed, wbs_vmm
from repro_torch.analog.adc import adc_quantize, integrator_droop
from repro_torch.analog.endurance import EnduranceTracker, lifespan_years
from repro_torch.analog.costmodel import HardwareConstants, M2RUCostModel

__all__ = [
    "CrossbarSpec", "CrossbarState", "program", "vmm",
    "WBSSpec", "wbs_vmm", "quantize_signed",
    "adc_quantize", "integrator_droop",
    "EnduranceTracker", "lifespan_years",
    "M2RUCostModel", "HardwareConstants",
]
