"""deepseek-v3-671b [moe]: 61L, d_model=7168, 128H, MLA
(q_lora=1536, kv_lora=512, nope=128, rope=64, v=128), MoE 256 routed
top-8 + 1 shared (expert d_ff=2048), first 3 layers dense (d_ff=18432),
vocab=129280. [arXiv:2412.19437]

MTP (multi-token prediction) head is NOT implemented — it is a training-
objective add-on orthogonal to the paper's technique (DESIGN.md §5).
MLA is O(L²) attention ⇒ long_500k skipped. Decode caches latents only.
Optimizer for this config defaults to 8-bit Adam moments (optim.qstate).
"""
import torch

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,                 # dense layers (first 3)
    vocab=129280,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    n_experts=256,
    n_shared_experts=1,
    top_k=8,
    moe_d_ff=2048,
    first_dense_layers=3,
    capacity_factor=1.25,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b-smoke",
        family="moe",
        n_layers=3,
        d_model=32,
        n_heads=4,
        n_kv_heads=4,
        d_ff=64,
        vocab=128,
        use_mla=True,
        q_lora_rank=24,
        kv_lora_rank=16,
        qk_nope_head_dim=8,
        qk_rope_head_dim=4,
        v_head_dim=8,
        n_experts=4,
        n_shared_experts=1,
        top_k=2,
        moe_d_ff=16,
        first_dense_layers=1,
        dtype=torch.float32,
    )
