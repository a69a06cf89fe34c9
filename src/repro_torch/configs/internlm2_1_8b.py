"""internlm2-1.8b [dense]: 24L, d_model=2048, 16H (GQA kv=8), d_ff=8192,
vocab=92544. [arXiv:2403.17297]  Full attention ⇒ long_500k skipped."""
import torch

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=92544,
    rope_theta=1e6,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b-smoke",
        family="dense",
        n_layers=2,
        d_model=32,
        n_heads=4,
        n_kv_heads=2,
        head_dim=8,
        d_ff=64,
        vocab=128,
        dtype=torch.float32,
    )
