"""seamless-m4t-medium [audio]: enc-dec, 12L, d_model=1024, 16H (kv=16),
d_ff=4096, vocab=256206. [arXiv:2308.11596]

Multimodal: the speech frontend is a stub — input_specs provides
precomputed frame embeddings (B, T_enc, d_model) per the brief. 12L is
read as 12 encoder + 12 decoder layers (the M4T medium speech-to-text
stack). MHA (kv == heads). Full attention ⇒ long_500k skipped.
"""
import torch

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    n_enc_layers=12,
    is_encoder_decoder=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=256206,
    frontend="audio",
    max_enc_len=4096,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium-smoke",
        family="audio",
        n_layers=2,
        n_enc_layers=2,
        is_encoder_decoder=True,
        d_model=32,
        n_heads=4,
        n_kv_heads=4,
        head_dim=8,
        d_ff=64,
        vocab=128,
        frontend="audio",
        max_enc_len=16,
        dtype=torch.float32,
    )
