"""Pluggable replay policies — counterpart of ``repro/replay``.

- base:     the ``ReplayPolicy`` protocol (select-on-insert +
            select-on-sample) and the name-keyed registry.
- policies: ``reservoir`` (the paper's hardware sampler, the default),
            ``ring`` (FIFO), ``class_balanced``, ``task_stratified``;
            ``loss_aware`` is in-graph (no host buffer).
- ingraph:  the device-resident buffer ``loss_aware`` runs on
            (``ingraph_init``/``insert``/``sample``/``mix``,
            ``per_example_ce``).
"""
from repro_torch.replay.base import (ReplayPolicy, available_policies,
                                     get_policy_class, make_policy,
                                     register_policy, unregister_policy)
from repro_torch.replay.ingraph import (ingraph_init, ingraph_insert,
                                        ingraph_mix, ingraph_sample,
                                        per_example_ce)
from repro_torch.replay.policies import (ClassBalancedPolicy,
                                         LossAwarePolicy, ReservoirPolicy,
                                         RingPolicy, TaskStratifiedPolicy)

__all__ = [
    "ReplayPolicy", "available_policies", "get_policy_class",
    "make_policy", "register_policy", "unregister_policy",
    "ReservoirPolicy", "RingPolicy", "ClassBalancedPolicy",
    "TaskStratifiedPolicy", "LossAwarePolicy",
    "ingraph_init", "ingraph_insert", "ingraph_mix", "ingraph_sample",
    "per_example_ce",
]
