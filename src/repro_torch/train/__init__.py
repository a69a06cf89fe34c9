"""Training loop, checkpointing, fault tolerance — counterpart of
``repro/train``."""
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.trainer import TrainConfig, Trainer

__all__ = ["CheckpointManager", "Trainer", "TrainConfig"]
