"""The paper's primary contribution — counterpart of ``repro/core``.

- miru:      Minion Recurrent Unit (eqs. 1-3) — gate-free GRU variant.
- dfa:       Direct Feedback Alignment through time (Algorithm 1).
- kwta:      K-winner-take-all (the paper's ζ sparsifier / softmax approx).
- replay:    reservoir sampler (xorshift32) + stochastic quantizer + buffer.
- continual: domain-incremental continual-learning trainer (Fig. 4 protocol).
"""
from repro_torch.core.miru import (MiRUConfig, init_miru_params,
                                   init_dfa_feedback, miru_forward,
                                   miru_apply_readout)
from repro_torch.core.kwta import kwta, kwta_mask
from repro_torch.core.replay import (ReservoirSampler, Xorshift32,
                                     ReplayBuffer, code_dtype,
                                     stochastic_quantize, uniform_quantize,
                                     dequantize, round_trip_bound)
from repro_torch.core.dfa import (dfa_grads, bptt_grads, miru_loss,
                                  grad_alignment)
from repro_torch.core.continual import (BatchSchedule, ContinualConfig,
                                        ReplaySpec, TrainerSpec,
                                        build_batch_schedule,
                                        miru_forward_device, run_continual,
                                        evaluate_tasks)

__all__ = [
    "MiRUConfig", "init_miru_params", "init_dfa_feedback", "miru_forward",
    "miru_apply_readout", "kwta", "kwta_mask", "ReservoirSampler",
    "Xorshift32", "ReplayBuffer", "code_dtype", "stochastic_quantize",
    "uniform_quantize", "dequantize", "round_trip_bound",
    "dfa_grads", "bptt_grads", "miru_loss", "grad_alignment",
    "ContinualConfig", "TrainerSpec", "ReplaySpec", "BatchSchedule",
    "build_batch_schedule", "miru_forward_device", "run_continual",
    "evaluate_tasks",
]
