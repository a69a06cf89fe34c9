"""Distribution: mesh axes, per-parameter partition specs, activation
sharding context, collective helpers — counterpart of
``repro/distributed``, on a torch ``DeviceMesh`` with DTensor."""
from repro_torch.distributed.context import (ShardingContext,
                                             act_constraint,
                                             current_context,
                                             sharding_scope)
from repro_torch.distributed.sharding import (batch_specs, cache_specs,
                                              opt_state_specs, param_specs)

__all__ = ["ShardingContext", "sharding_scope", "current_context",
           "act_constraint", "param_specs", "batch_specs",
           "opt_state_specs", "cache_specs"]
