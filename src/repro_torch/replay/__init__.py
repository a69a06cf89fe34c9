"""Pluggable replay policies — counterpart of ``repro/replay``.

- base:     the ``ReplayPolicy`` protocol (select-on-insert +
            select-on-sample) and the name-keyed registry.
- policies: ``reservoir`` (the paper's hardware sampler, the default),
            ``ring`` (FIFO), ``class_balanced``, ``task_stratified``;
            ``loss_aware`` is registered but in-graph, and its device
            buffer is not ported yet (ROADMAP queue A).
"""
from repro_torch.replay.base import (ReplayPolicy, available_policies,
                                     get_policy_class, make_policy,
                                     register_policy, unregister_policy)
from repro_torch.replay.policies import (ClassBalancedPolicy,
                                         LossAwarePolicy, ReservoirPolicy,
                                         RingPolicy, TaskStratifiedPolicy)

__all__ = [
    "ReplayPolicy", "available_policies", "get_policy_class",
    "make_policy", "register_policy", "unregister_policy",
    "ReservoirPolicy", "RingPolicy", "ClassBalancedPolicy",
    "TaskStratifiedPolicy", "LossAwarePolicy",
]
