"""qwen2-0.5b [dense]: 24L, d_model=896, 14H (GQA kv=2), d_ff=4864,
vocab=151936, QKV bias, tied embeddings. [arXiv:2407.10671]
long_500k skipped."""
import torch

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1e6,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b-smoke",
        family="dense",
        n_layers=2,
        d_model=32,
        n_heads=4,
        n_kv_heads=2,
        head_dim=8,
        d_ff=64,
        vocab=128,
        qkv_bias=True,
        tie_embeddings=True,
        dtype=torch.float32,
    )
