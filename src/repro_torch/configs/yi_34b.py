"""yi-34b [dense]: 60L, d_model=7168, 56H (GQA kv=8), d_ff=20480,
vocab=64000 — llama-arch GQA. [arXiv:2403.04652]
Full attention ⇒ long_500k skipped. decode_32k uses the int8
stochastic-quantized KV cache (EXPERIMENTS.md §Perf) to fit 16 GB/chip."""
import torch

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab=64000,
    rope_theta=5e6,
    kv_cache_dtype="int8",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="yi-34b-smoke",
        family="dense",
        n_layers=2,
        d_model=32,
        n_heads=4,
        n_kv_heads=2,
        head_dim=8,
        d_ff=64,
        vocab=128,
        kv_cache_dtype="int8",
        dtype=torch.float32,
    )
