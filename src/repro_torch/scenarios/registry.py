"""Name-keyed registry of continual-learning scenarios — counterpart of
``repro/scenarios/registry.py``, with the same ten registrations.

A *scenario* is a builder that turns (seed, sizing kwargs) into a task
sequence — a ``list[TaskData]`` — plus the metadata the sweep runner
needs to execute it: whether the stream is shape-uniform (the
precondition for the compiled whole-sequence run) and any trainer
overrides the protocol imposes (the online streaming regime is
single-pass regardless of the trainer's ``epochs_per_task``).

    @register_scenario("my_stream", description="...")
    def make_my_stream(seed, n_tasks=5, n_train=1000, n_test=400, **kw):
        return [...TaskData...]

    tasks = build_scenario("my_stream", seed=0, n_tasks=3)

Every builder takes ``(seed, n_tasks=..., n_train=..., n_test=...)`` so
the sweep can size any scenario uniformly; extra knobs are
scenario-specific keywords.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional

from repro_torch.data.synthetic import (TaskData,
                                        make_class_incremental_tasks,
                                        make_drift_tasks,
                                        make_noisy_label_tasks,
                                        make_permuted_tasks,
                                        make_rotated_tasks, make_split_tasks,
                                        make_streaming_tasks)

Builder = Callable[..., list[TaskData]]


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """A registered scenario: the builder plus how to run it."""
    name: str
    builder: Builder
    description: str = ""
    # Shape-uniform across tasks (same n_train/T/F and a fixed head) —
    # required for the compiled whole-sequence run; non-uniform
    # scenarios fall back to the per-task Python loop.
    uniform: bool = True
    # TrainerSpec fields the protocol pins (e.g. single-pass streaming
    # forces epochs_per_task=1). Applied by the sweep on top of the
    # caller's TrainerSpec.
    trainer_overrides: Mapping[str, Any] = \
        dataclasses.field(default_factory=dict)
    # Preferred repro_torch.replay policy for this stream (e.g. the
    # class-incremental protocol rehearses best class-balanced). Resolved
    # by run_sweep / the example driver exactly like trainer_overrides:
    # only when the caller's ReplaySpec.policy is None (no explicit
    # choice). None keeps the global default (reservoir).
    replay_policy: Optional[str] = None
    # The padding policy (repro_torch.data.ragged.PadPolicy) ragged
    # streams declare so the compiled sweep can run them through the
    # masked steps instead of the Python-loop fallback. None (every
    # uniform scenario) changes nothing.
    pad: Optional[Any] = None

    def build(self, seed: int = 0, **kwargs) -> list[TaskData]:
        return self.builder(seed, **kwargs)

    def resolve_replay(self, replay):
        """Apply this scenario's preferred replay policy to a ReplaySpec
        (or None → the default spec) unless the caller pinned one."""
        from repro_torch.core.continual import ReplaySpec
        replay = replay if replay is not None else ReplaySpec()
        if replay.policy is None and self.replay_policy is not None:
            return dataclasses.replace(replay, policy=self.replay_policy)
        return replay


_REGISTRY: dict[str, ScenarioSpec] = {}


def register_scenario(name: str, *, description: str = "",
                      uniform: bool = True,
                      trainer_overrides: Optional[Mapping[str, Any]] = None,
                      replay_policy: Optional[str] = None,
                      pad: Optional[Any] = None):
    """Register a scenario builder (usable as a decorator). Re-registering
    a name overwrites it (tests, experiment sweeps)."""
    def _do(builder: Builder) -> Builder:
        _REGISTRY[name] = ScenarioSpec(
            name=name, builder=builder, description=description,
            uniform=uniform,
            trainer_overrides=dict(trainer_overrides or {}),
            replay_policy=replay_policy, pad=pad)
        return builder
    return _do


def unregister_scenario(name: str) -> None:
    """Remove a registered scenario (test teardown helper)."""
    _REGISTRY.pop(name, None)


def available_scenarios() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_scenario(name: str) -> ScenarioSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; "
            f"available: {', '.join(available_scenarios()) or '(none)'}"
        ) from None


def build_scenario(name: str, seed: int = 0, **kwargs) -> list[TaskData]:
    """Build the task sequence for a registered scenario."""
    return get_scenario(name).build(seed, **kwargs)


# ---------------------------------------------------------------------------
# Built-in scenarios — the streams from repro_torch.data.synthetic
# ---------------------------------------------------------------------------

register_scenario(
    "permuted",
    description="Permuted-pixel domain-incremental stream (permuted-MNIST "
                "protocol, §VI-A); task 0 is the identity permutation.",
)(make_permuted_tasks)

register_scenario(
    "split",
    description="Split feature-space stream: consecutive class pairs on a "
                "shared binary head (domain-incremental split CIFAR-10).",
)(make_split_tasks)

register_scenario(
    "rotated",
    description="Rotated-image stream: one dataset viewed under a "
                "per-task rotation ramping 0→max_angle degrees.",
    # Each rotation is a distinct view of the same classes: stratifying
    # the buffer by task keeps every past view represented.
    replay_policy="task_stratified",
)(make_rotated_tasks)

register_scenario(
    "noisy_label",
    description="Label-noise robustness stream: fixed domain, train-label "
                "corruption ramping 0→max_flip across tasks (clean test).",
)(make_noisy_label_tasks)

register_scenario(
    "drift",
    description="Gradual domain drift: class prototypes interpolate from "
                "a start to an end set across the sequence.",
    # Under gradual drift old prototypes go stale; the FIFO ring's
    # recency bias rehearses the still-relevant neighborhood.
    replay_policy="ring",
)(make_drift_tasks)

register_scenario(
    "class_incremental",
    description="Class-incremental stream with a logically expanding "
                "head: task t introduces classes [t·c, (t+1)·c) with "
                "global labels over the full head.",
    # Per-class reservoir sized for the full expanding head: early
    # classes keep fixed buffer share as later classes stream in.
    replay_policy="class_balanced",
)(make_class_incremental_tasks)

register_scenario(
    "streaming",
    description="Online single-pass streaming regime: a restart-safe "
                "(seed, step)-deterministic stream chopped into segments "
                "under fresh permutations; each example is seen once.",
    trainer_overrides={"epochs_per_task": 1},
)(make_streaming_tasks)


# ---------------------------------------------------------------------------
# Real sequential streams — repro_torch.data.real (offline surrogate)
# ---------------------------------------------------------------------------

def _register_real_scenarios():
    # Deferred so repro_torch.data.real's module import cost (none at
    # import time — downloads happen inside the builders) stays off the
    # registry's critical path and the import cycle stays clean.
    from repro_torch.data.ragged import PadPolicy
    from repro_torch.data.real import (make_keyword_fewshot_tasks,
                                       make_seq_cifar10_tasks,
                                       make_seq_mnist_tasks)

    register_scenario(
        "seq_mnist",
        description="Permuted sequential MNIST on real data (row-by-row, "
                    "28×28; surrogate offline): the paper's §VI-A "
                    "benchmark stream.",
        pad=PadPolicy(last_batch="pad"),
    )(make_seq_mnist_tasks)

    register_scenario(
        "seq_cifar10",
        description="Split sequential CIFAR-10 on real data (row-by-row "
                    "32×96 RGB rows, class-pair binary head; surrogate "
                    "offline).",
        pad=PadPolicy(last_batch="pad"),
    )(make_seq_cifar10_tasks)

    register_scenario(
        "keyword_fewshot",
        description="Few-shot continual keyword stream: variable-length "
                    "utterances and per-task decreasing shot counts — "
                    "ragged in T and n_train; compiles via PadPolicy.",
        uniform=False,
        pad=PadPolicy(last_batch="pad"),
    )(make_keyword_fewshot_tasks)


_register_real_scenarios()
