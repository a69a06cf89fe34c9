"""Observability: the streaming latency histogram."""
from repro_torch.obs.hist import Histogram

__all__ = ["Histogram"]
