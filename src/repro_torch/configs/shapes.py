"""The assigned input shapes and each architecture's inputs at them —
counterpart of ``repro/configs/shapes.py``, with tensors on the ``meta``
device (shapes and dtypes, no allocation) where the reference has
``jax.ShapeDtypeStruct``.

  train_4k     seq 4096  × global_batch 256   (training step)
  prefill_32k  seq 32768 × global_batch 32    (inference prefill)
  decode_32k   KV 32768  × global_batch 128   (one-token decode)
  long_500k    KV 524288 × global_batch 1     (long-context decode;
                                               SSM/hybrid only)

A train or prefill shape gives the batch of ``lm.loss_fn`` / ``lm.prefill``;
a decode shape the caches, tokens and position of ``lm.decode_step``.
The multimodal architectures take precomputed frame or patch embeddings
(bf16) in the batch: an encoder-decoder model min(S, ``max_enc_len``)
frames beside S tokens, a vision model ``n_frontend_tokens`` patches
beside S − n_img tokens; an encoder-decoder decode carries a cross cache
of min(4096, ``max_enc_len``) frames.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def skip_reason(cfg: ModelConfig, shape_name: str) -> Optional[str]:
    """long_500k needs sub-quadratic attention: None, or why the pair is
    skipped."""
    if shape_name == "long_500k" and cfg.layer_pattern == "attn":
        return ("pure full-attention arch: O(L²) attention at 524k context "
                "— skipped per brief; run only for SSM/hybrid")
    return None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """The batch at ``shape``: tokens, labels (int32) and mask (fp32),
    with bf16 frames (encoder-decoder) or patches (vision)."""
    B, S = shape.global_batch, shape.seq_len
    batch: dict = {}
    if cfg.is_encoder_decoder:
        enc = min(S, cfg.max_enc_len)
        batch["frames"] = _meta((B, enc, cfg.d_model), torch.bfloat16)
        batch["tokens"] = _meta((B, S), torch.int32)
    elif cfg.frontend == "vision":
        n_img = cfg.n_frontend_tokens
        batch["patches"] = _meta((B, n_img, cfg.d_model), torch.bfloat16)
        batch["tokens"] = _meta((B, S - n_img), torch.int32)
    else:
        batch["tokens"] = _meta((B, S), torch.int32)
    t = batch["tokens"].shape
    batch["labels"] = _meta(t, torch.int32)
    batch["mask"] = _meta(t, torch.float32)
    return batch


def decode_input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """A one-token decode's inputs at ``shape``: the caches over
    ``seq_len`` (an encoder-decoder's with min(4096, ``max_enc_len``)
    frames of cross memory), tokens (B, 1) and a 0-d position, int32."""
    from repro_torch.models import lm
    B, S = shape.global_batch, shape.seq_len
    enc_len = min(4096, cfg.max_enc_len) if cfg.is_encoder_decoder else 0
    return {
        "caches": lm.init_cache(cfg, B, S, device="meta", enc_len=enc_len),
        "tokens": _meta((B, 1), torch.int32),
        "pos": _meta((), torch.int32),
    }


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """Meta-device stand-ins for every input of the step at
    ``shape_name``."""
    shape = SHAPES[shape_name]
    if shape.kind in ("train", "prefill"):
        return train_batch_specs(cfg, shape)
    return decode_input_specs(cfg, shape)
