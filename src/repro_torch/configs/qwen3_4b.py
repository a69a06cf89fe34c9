"""qwen3-4b [dense]: 36L, d_model=2560, 32H (GQA kv=8), d_ff=9728,
vocab=151936, qk-norm. [hf:Qwen/Qwen3-8B]  long_500k skipped."""
import torch

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab=151936,
    qk_norm=True,
    rope_theta=1e6,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b-smoke",
        family="dense",
        n_layers=2,
        d_model=32,
        n_heads=4,
        n_kv_heads=2,
        head_dim=8,
        d_ff=64,
        vocab=128,
        qk_norm=True,
        dtype=torch.float32,
    )
