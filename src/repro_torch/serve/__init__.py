"""Continuous-batching serving of recurrent (MiRU) streams: the state
slab, the deterministic traffic generator and the engine."""
from repro_torch.serve.loadgen import (Arrival, TrafficSpec, make_arrivals,
                                       replay, request_frames)
from repro_torch.serve.recurrent import (RecurrentServeConfig,
                                         RecurrentServeEngine, StreamRequest,
                                         serve_backend)
from repro_torch.serve.slab import SlabFullError, StateSlab

__all__ = [
    "RecurrentServeEngine", "RecurrentServeConfig", "StreamRequest",
    "serve_backend", "StateSlab", "SlabFullError",
    "TrafficSpec", "Arrival", "make_arrivals", "request_frames", "replay",
]
