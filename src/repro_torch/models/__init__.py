"""The LM zoo's dense, moe, ssm and hybrid families: primitive layers,
GQA attention and the KV caches, the MoE FFN, the mamba2 SSD mixer, the
layer stacks and superblocks, and the top-level model."""
from repro_torch.models import attention, blocks, layers, lm, moe, ssm

__all__ = ["attention", "blocks", "layers", "lm", "moe", "ssm"]
