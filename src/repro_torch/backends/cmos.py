"""Digital-CMOS baseline substrate — the paper's 29× comparison anchor.
Counterpart of ``repro/backends/cmos.py``.

A 65 nm all-digital MiRU datapath at the same 8-bit fixed-point precision
as the mixed-signal design: sign-magnitude quantized inputs, exact MACs
in digital accumulators (no ADC — there is nothing analog to convert),
exact clipped writes, no device variability and no endurance limit.

Numerically this is the WBS fixed-point path with ideal gains; what
distinguishes it is its energy model: the telemetry charges each metered
op the paper-calibrated digital per-op energy
(``M2RUCostModel.digital_pj_per_op``), which reproduces the 29×
efficiency gap against a metered analog run of the same workload.

No fused recurrence: without a readout ADC nothing re-quantizes the
integrator each step, so ``_fused_recurrence_ok`` keeps this substrate on
the per-step path (two ``wbs_matmul`` launches a time step).
"""
from __future__ import annotations

from repro_torch.backends.base import DeviceSpec
from repro_torch.backends.registry import register_backend
from repro_torch.backends.wbs import WBSBackend


@register_backend("cmos")
class CMOSBackend(WBSBackend):
    name = "cmos"

    @classmethod
    def default_spec(cls) -> DeviceSpec:
        # 8-bit fixed-point drive, digital accumulation (no readout ADC),
        # the crossbar design's logical dynamic range, so the two
        # substrates train over identical weight ranges.
        return DeviceSpec(input_bits=8, adc_bits=None, adc_range=4.0,
                          gain_sigma=0.0, weight_clip=1.5)
