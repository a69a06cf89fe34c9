"""jamba-1.5-large-398b [hybrid]: 72L, d_model=8192, 64H (GQA kv=8),
d_ff=24576, vocab=65536, MoE 16e top-2 every other layer, Mamba:attn 7:1
interleave. [arXiv:2403.19887]

Layer pattern: period-8 superblocks — 7 SSD mixers + 1 attention (slot 4);
MoE FFN on odd slots, dense FFN on even. Param total ≈ 398 B (validated in
tests/test_configs.py). SSD mixer follows Mamba-2 (the assigned pool pairs
this entry with the SSD formulation; Jamba's original Mamba-1 layers are
adapted to SSD — DESIGN.md §2). Hybrid ⇒ long_500k RUNS."""
import torch

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=65536,
    layer_pattern="hybrid",
    attn_every=8,
    n_experts=16,
    top_k=2,
    moe_d_ff=24576,
    moe_every=2,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=8,
    kv_cache_dtype="int8",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-smoke",
        family="hybrid",
        n_layers=4,
        d_model=32,
        n_heads=4,
        n_kv_heads=2,
        head_dim=8,
        d_ff=64,
        vocab=128,
        layer_pattern="hybrid",
        attn_every=4,
        n_experts=4,
        top_k=2,
        moe_d_ff=32,
        moe_every=2,
        ssm_state=16,
        ssm_head_dim=8,
        ssm_expand=2,
        ssm_groups=2,
        dtype=torch.float32,
    )
