"""ModelConfig — the single config record every architecture instantiates.

Counterpart of ``repro/configs/base.py``, with torch dtypes. One file per
architecture lives next to this module; each exports ``CONFIG`` (full
size) and ``smoke_config()`` (reduced, runs a real forward on the CPU).
The port's model code runs the dense, moe, ssm and hybrid families; the
others are data here until their slices land (ROADMAP queue A).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|ssm|hybrid|encdec|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None    # default d_model // n_heads

    # Attention flavor
    qk_norm: bool = False             # qwen3
    qkv_bias: bool = False            # qwen2
    rope_theta: float = 1e4
    attn_chunk: int = 1024            # flash-chunk size (S > chunk ⇒ chunked)

    # MLA (deepseek-v3)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0       # deepseek: first k layers dense
    moe_every: int = 1                # jamba: MoE every other layer ⇒ 2
    capacity_factor: float = 1.25

    # SSM / hybrid
    layer_pattern: str = "attn"       # "attn" | "ssm" | "hybrid"
    attn_every: int = 0               # hybrid: 1 attn per this many layers
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_groups: int = 1

    # Encoder-decoder
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    max_enc_len: int = 4096

    # Modality frontend (stub embeddings per the brief)
    frontend: str = "none"            # none | audio | vision
    n_frontend_tokens: int = 0

    # Numerics / execution
    rmsnorm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16
    remat: bool = True
    scan_layers: bool = True
    quant_mode: str = "none"          # none | any repro.backends name (wbs…)
    kv_cache_dtype: str = "bf16"      # bf16 | int8 (stochastic-quantized)
    mixer: str = "default"            # default | miru (ablation, DESIGN §5)

    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model \
            // self.n_heads

    def is_ssm_layer(self, i: int) -> bool:
        if self.layer_pattern == "ssm":
            return True
        if self.layer_pattern == "hybrid":
            # Jamba: 1 attention per `attn_every` layers (1:7 ⇒ every 8th;
            # the attention layer sits mid-period, per the paper's fig.).
            return (i % self.attn_every) != (self.attn_every // 2)
        return False

    def is_moe_layer(self, i: int) -> bool:
        if self.n_experts == 0:
            return False
        if i < self.first_dense_layers:
            return False
        return (i % self.moe_every) == (self.moe_every - 1) \
            if self.moe_every > 1 else True

    # ------------------------------------------------------------------
    # Parameter accounting (for MODEL_FLOPS = 6·N·D roofline term)
    # ------------------------------------------------------------------
    def param_counts(self) -> dict:
        D = self.d_model
        hd = self.hd()
        q = self.n_heads * hd
        kv = self.n_kv_heads * hd

        if self.use_mla:
            attn = (D * self.q_lora_rank
                    + self.q_lora_rank * self.n_heads
                    * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                    + D * (self.kv_lora_rank + self.qk_rope_head_dim)
                    + self.kv_lora_rank * self.n_heads
                    * (self.qk_nope_head_dim + self.v_head_dim)
                    + self.n_heads * self.v_head_dim * D)
        else:
            attn = D * q + 2 * D * kv + q * D

        dense_ffn = 3 * D * self.d_ff
        moe_ffn = self.n_experts * 3 * D * self.moe_d_ff \
            + self.n_shared_experts * 3 * D * self.moe_d_ff \
            + D * self.n_experts                    # router
        moe_active = ((self.top_k + self.n_shared_experts)
                      * 3 * D * self.moe_d_ff + D * self.n_experts)

        d_in = self.ssm_expand * D
        ssm = (D * (2 * d_in + 2 * self.ssm_groups * self.ssm_state
                    + d_in // self.ssm_head_dim)
               + d_in * D) if self.ssm_state else 0

        total = 0
        active = 0
        n_layers = self.n_layers
        for i in range(n_layers):
            if self.is_ssm_layer(i):
                total += ssm
                active += ssm
            else:
                total += attn
                active += attn
            if self.d_ff or self.n_experts:
                if self.is_moe_layer(i):
                    total += moe_ffn
                    active += moe_active
                elif self.d_ff:
                    total += dense_ffn
                    active += dense_ffn
        if self.is_encoder_decoder:
            # encoder: self-attn + ffn; decoder already counted above,
            # add cross-attention per decoder layer.
            total += self.n_enc_layers * (attn + dense_ffn)
            active += self.n_enc_layers * (attn + dense_ffn)
            total += n_layers * attn      # cross-attn
            active += n_layers * attn
        embed = self.vocab * D * (1 if self.tie_embeddings else 2)
        total += embed
        active += embed
        return {"total": total, "active": active}
