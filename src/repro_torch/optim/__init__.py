"""Self-contained optimizer stack — counterpart of ``repro/optim``.

- optimizers:  optax-style transforms: sgd, adam, adamw, chain,
               clip_by_global_norm, schedules; states on the params'
               device.
- sparsify:    K-WTA gradient sparsification (the paper's ζ) as a
               transform.
- qstate:      8-bit block-quantized Adam moments (``adam_8bit``, the
               optimizer of the largest configs, deepseek-v3's).
- compression: top-k + error-feedback gradient compression.
"""
from repro_torch.optim.compression import topk_compress_error_feedback
from repro_torch.optim.optimizers import (Optimizer, adam, adamw,
                                          add_decayed_weights,
                                          apply_updates, chain,
                                          clip_by_global_norm,
                                          cosine_schedule, scale,
                                          scale_by_adam, sgd,
                                          warmup_cosine)
from repro_torch.optim.qstate import adam_8bit
from repro_torch.optim.sparsify import kwta_sparsify


__all__ = [
    "Optimizer", "sgd", "adam", "adamw", "chain", "clip_by_global_norm",
    "apply_updates", "scale", "scale_by_adam", "add_decayed_weights",
    "cosine_schedule", "warmup_cosine", "adam_8bit", "kwta_sparsify",
    "topk_compress_error_feedback",
]
