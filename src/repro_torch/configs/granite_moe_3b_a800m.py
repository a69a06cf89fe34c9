"""granite-moe-3b-a800m [moe]: 32L, d_model=1536, 24H (GQA kv=8),
expert d_ff=512, vocab=49155, MoE 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base]  long_500k skipped.

40 experts do not divide the 16-way model axis ⇒ expert bank shards
TP-over-F instead of EP (distributed/sharding.py fallback)."""
import torch

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=0,                     # all layers MoE
    vocab=49155,
    n_experts=40,
    top_k=8,
    moe_d_ff=512,
    capacity_factor=1.25,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m-smoke",
        family="moe",
        n_layers=2,
        d_model=32,
        n_heads=4,
        n_kv_heads=2,
        head_dim=8,
        d_ff=0,
        vocab=128,
        n_experts=4,
        top_k=2,
        moe_d_ff=16,
        dtype=torch.float32,
    )
