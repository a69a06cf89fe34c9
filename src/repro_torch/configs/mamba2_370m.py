"""mamba2-370m [ssm]: 48L, d_model=1024, attn-free (d_ff=0),
vocab=50280, ssm_state=128 — SSD (state-space duality).
[arXiv:2405.21060]  SSM ⇒ long_500k RUNS (recurrent decode)."""
import torch

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=1,               # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    layer_pattern="ssm",
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=1,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m-smoke",
        family="ssm",
        n_layers=2,
        d_model=32,
        n_heads=1,
        n_kv_heads=1,
        d_ff=0,
        vocab=128,
        layer_pattern="ssm",
        ssm_state=16,
        ssm_head_dim=8,
        ssm_expand=2,
        ssm_groups=1,
        tie_embeddings=True,
        dtype=torch.float32,
    )
