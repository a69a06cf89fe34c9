"""llava-next-34b [vlm]: yi-34b backbone (60L, d_model=7168, 56H kv=8,
d_ff=20480, vocab=64000) + anyres vision frontend (stub patch
embeddings). [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

Anyres tiling: base 576 patches + 4 tiles × 576 = 2880 image tokens,
provided precomputed by input_specs per the brief. long_500k skipped."""
import torch

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab=64000,
    rope_theta=5e6,
    frontend="vision",
    n_frontend_tokens=2880,
    kv_cache_dtype="int8",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b-smoke",
        family="vlm",
        n_layers=2,
        d_model=32,
        n_heads=4,
        n_kv_heads=2,
        head_dim=8,
        d_ff=64,
        vocab=128,
        frontend="vision",
        n_frontend_tokens=8,
        kv_cache_dtype="int8",
        dtype=torch.float32,
    )
