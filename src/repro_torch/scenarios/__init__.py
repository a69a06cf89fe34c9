"""Continual-learning scenario suite — counterpart of ``repro/scenarios``.

- registry: name-keyed scenario builders (permuted, split, rotated,
            noisy_label, drift, class_incremental, streaming, and the
            real streams seq_mnist, seq_cifar10, keyword_fewshot), all
            emitting the ``TaskData`` shape, with per-scenario run
            metadata (shape uniformity, trainer overrides, replay policy,
            padding policy).
- metrics:  average accuracy, forgetting, backward/forward transfer
            from the accuracy matrix.
- sweep:    the compiled run — the whole task sequence on the card with
            its schedule uploaded once and no host read per step, bit for
            bit ``run_continual`` — and the scenario × backend sweep.
"""
from repro_torch.scenarios.metrics import (average_accuracy,
                                           backward_transfer,
                                           continual_metrics, forgetting,
                                           forward_transfer)
from repro_torch.scenarios.registry import (ScenarioSpec,
                                            available_scenarios,
                                            build_scenario, get_scenario,
                                            register_scenario,
                                            unregister_scenario)
from repro_torch.scenarios.sweep import (run_compiled, run_sweep,
                                         scenario_miru_config)

__all__ = [
    "ScenarioSpec", "available_scenarios", "build_scenario", "get_scenario",
    "register_scenario", "unregister_scenario",
    "average_accuracy", "backward_transfer", "continual_metrics",
    "forgetting", "forward_transfer",
    "run_compiled", "run_sweep", "scenario_miru_config",
]
