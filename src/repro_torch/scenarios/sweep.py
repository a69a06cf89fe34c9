"""The whole task sequence in one run on the card, and the scenario ×
backend sweep — counterpart of ``repro/scenarios/sweep.py``.

The reference runs the sequence as one jitted ``lax.scan`` over tasks.
PyTorch runs eagerly, so here the compiled run is the loop of
:func:`repro_torch.core.continual.run_continual` itself
(``_prepare_run``, ``_upload``, ``_execute``): the seed's whole schedule
and its step and eval keys are built before any step runs, the batches
and test sets move to the card in one copy, and no value is read back to
the host until the end. Both entry points run that one loop, so they
agree bit for bit on every backend: R, losses, params, the device state,
the RunLog, and the telemetry's and tracker's write counts.

What the compiled run adds: after each task it evaluates *every* task
(not only the seen prefix), each with its own ``evaluate`` call, so
``R_full`` also carries the unseen-task upper triangle that forward
transfer needs, and with ``baseline`` it first evaluates the untrained
model; the lower-triangular ``R`` (zeros above the diagonal, as
``run_continual`` reports) is derived from ``R_full``. Eager metering
counts each evaluation as it runs, which gives the reference's traced
multiplicities: ``n_tasks²`` evaluations, plus ``n_tasks`` for the
untrained baseline row.

Several seeds run one after the other: ``torch.func.vmap`` cannot map
the host key chain or the CUDA kernels' calls. Streams that are not
shape-uniform across tasks run the per-task loop (``"compiled":
False``) unless a :class:`~repro_torch.data.ragged.PadPolicy` takes them
through the masked steps over the real steps (no step-axis padding:
nothing is traced, so nothing needs one shape).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.backends import DeviceBackend, get_backend
from repro_torch.core.continual import (ReplaySpec, TrainerSpec, _execute,
                                        _obs_stream_args, _prepare_run,
                                        _SeedRun, _upload,
                                        build_batch_schedule, run_continual)
from repro_torch.data.synthetic import TaskData
from repro_torch.replay import get_policy_class
from repro_torch.scenarios.metrics import continual_metrics
from repro_torch.scenarios.registry import get_scenario
from repro_torch.utils import resolve_device

__all__ = ["run_compiled", "run_sweep", "scenario_miru_config"]


def _build_seed_inputs(cfg, trainer: TrainerSpec, rspec: ReplaySpec,
                       backend: DeviceBackend, tasks: list[TaskData],
                       pad=None, eval_padded: bool = False,
                       torch_device: Union[str, torch.device] = "cuda",
                       init: Optional[tuple] = None
                       ) -> tuple[Optional[_SeedRun], Any]:
    """One seed's schedule, initial state, step closures and key chain —
    the run :func:`run_continual` makes — and its schedule. The run is
    None for a stream that is not shape-uniform and has no ``pad``
    policy. ``init`` is ``run_continual``'s replacement of the seeded
    initial state."""
    schedule = build_batch_schedule(trainer, rspec, tasks, pad=pad)
    if pad is None and not schedule.uniform:
        return None, schedule
    return _prepare_run(cfg, trainer, rspec, backend, tasks, schedule,
                        resolve_device(torch_device), pad=pad,
                        eval_padded=eval_padded, init=init), schedule


def _summarize_run(R_full, base_row, losses, baseline: bool) -> dict:
    """One run's summary dict from its raw outputs (host values) —
    shared by the per-seed runs here and a fleet's device axis.

    float64 like run_continual's R (float32 accuracies are exactly
    representable, so the widening keeps bit-equality with the loop)."""
    R_full = np.asarray(R_full, np.float64)
    n_tasks = R_full.shape[0]
    R = np.tril(R_full)
    return {
        "R": R, "R_full": R_full,
        "MA": float(R_full[-1].mean()),
        "acc_after_each": [float(R[t, :t + 1].mean())
                           for t in range(n_tasks)],
        "losses": [float(v) for v in np.asarray(losses).reshape(-1)],
        "metrics": continual_metrics(
            R_full, base_row if baseline else None),
        "baseline_row": base_row,
    }


def _aggregate_seeds(per_seed: list[dict], seeds: Sequence[int]) -> dict:
    """Cross-seed aggregation shared by the compiled and fallback paths:
    metrics (and MA ≡ average_accuracy) become the seed mean, with a
    ``metrics_std`` companion and the raw ``per_seed`` cells."""
    keys = per_seed[0]["metrics"]
    metrics = {k: float(np.mean([p["metrics"][k] for p in per_seed]))
               for k in keys}
    return {
        "per_seed": per_seed,
        "seeds": list(seeds),
        "metrics": metrics,
        "metrics_std": {k: float(np.std([p["metrics"][k]
                                         for p in per_seed]))
                        for k in keys},
        "MA": metrics["average_accuracy"],
    }


def _fallback_python(cfg, trainer, tasks, rspec, backend, seeds,
                     obs=None, torch_device: Union[str, torch.device] = "cuda",
                     init: Optional[tuple] = None):
    """Non-uniform streams: run the per-task Python loop. Mirrors the
    compiled path's multi-seed reporting (metrics are the cross-seed
    mean, with ``metrics_std``), minus FWT — the loop never evaluates
    unseen tasks or the untrained baseline. ``obs`` rides through to
    :func:`run_continual`; a multi-seed fallback reports the first seed's
    RunLog."""
    runs = []
    for s in (seeds if seeds is not None else [trainer.seed]):
        tsp = dataclasses.replace(trainer, seed=s)
        runs.append(run_continual(cfg, tsp, tasks, replay=rspec,
                                  device=backend, obs=obs,
                                  torch_device=torch_device, init=init))
    per_seed = [{"R": r["R"], "MA": r["MA"],
                 "metrics": continual_metrics(r["R"])} for r in runs]
    out = dict(runs[0])
    out["compiled"] = False
    out["metrics"] = per_seed[0]["metrics"]
    if seeds is not None and len(runs) > 1:
        out.update(_aggregate_seeds(per_seed, seeds))
    return out


def run_compiled(cfg, spec: TrainerSpec, tasks: list[TaskData],
                 replay: Optional[ReplaySpec] = None,
                 device: Union[str, DeviceBackend, None] = None,
                 *, seeds: Optional[Sequence[int]] = None,
                 baseline: bool = True,
                 uniform: bool = True,
                 obs: Optional[Any] = None,
                 pad: Optional[Any] = None,
                 torch_device: Union[str, torch.device] = "cuda",
                 init: Optional[tuple] = None) -> dict[str, Any]:
    """Train through the task sequence in one run on ``torch_device``.

    Same contract as :func:`run_continual` (and the same ``R``, ``MA``,
    losses, params and device state, bit for bit, on every backend),
    plus:

      R_full        (n_tasks, n_tasks) with the unseen-task upper triangle
      metrics       average_accuracy / forgetting / BWT (+ FWT when
                    ``baseline``), from :mod:`repro_torch.scenarios.metrics`
      baseline_row  untrained-model accuracy per task (when ``baseline``)
      compiled      False when the stream was not shape-uniform and the
                    run fell back to the per-task Python loop

    ``uniform=False`` (a :class:`ScenarioSpec` declares it) goes straight
    to the Python-loop fallback without building the (ragged) schedule
    first; ragged streams are also detected either way. ``seeds`` runs
    the sequence once per trainer seed, one after the other; per-seed R
    matrices and the metrics' mean and std come back under
    ``"per_seed"``/``"metrics"``, and ``params`` are the first seed's.

    ``obs`` is a :class:`repro_torch.obs.ObsSpec`: metric streams come
    back as ``"runlog"`` (with a leading per-seed axis under ``seeds``),
    and a tracer records three spans, also reported as
    ``"compile_s"``/``"execute_s"``:

      schedule  building every seed's schedule, key chain and initial
                state;
      compile   what the run does before its first step: the one upload
                of the schedules and test sets. The port compiles no
                program (its CUDA libraries load at their first launch,
                inside ``execute``); the name is the reference's;
      execute   every step and evaluation, through the read-back of the
                results.

    ``pad`` is a :class:`~repro_torch.data.ragged.PadPolicy`: ragged
    streams (unequal n_train/n_test/sequence length across tasks) pad
    onto one shape with validity masks and run through the masked steps.
    With a policy attached but nothing actually ragged (and
    ``force=False``), the unmasked steps run — bit for bit the run
    without a policy. Masked runs keep host-materialized replay only (an
    in-graph policy raises). ``init`` replaces the seeded initial state
    of a single-seed run, as :func:`run_continual`'s does.
    """
    trainer = spec
    if not isinstance(trainer, TrainerSpec):
        raise TypeError("run_compiled takes a TrainerSpec; legacy "
                        "ContinualConfig is only supported by run_continual")
    rspec = replay if replay is not None else ReplaySpec()
    backend = get_backend(device if device is not None else "ideal")
    tele = backend.telemetry
    dev = resolve_device(torch_device)
    obs_on = obs is not None and getattr(obs, "metrics", False)
    tracer = getattr(obs, "tracer", None) if obs is not None else None
    seed_list = list(seeds) if seeds is not None else None
    many = seed_list is not None and len(seed_list) > 1
    if init is not None and many:
        raise ValueError("init= sets one run's initial state; it cannot be "
                         "combined with several seeds")

    eval_padded = False
    if pad is not None:
        from repro_torch.data.ragged import pad_tasks
        if get_policy_class(rspec.resolved_policy).in_graph:
            raise ValueError(
                "a PadPolicy cannot be combined with an in-graph replay "
                "policy (loss_aware): the device-resident buffer has no "
                "row-validity channel; use a host-materialized policy")
        tasks, eval_padded = pad_tasks(tasks, pad)

    def fallback():
        return _fallback_python(cfg, trainer, tasks, rspec, backend,
                                seed_list, obs=obs, torch_device=dev,
                                init=init)

    if not uniform and pad is None:
        # Declared ragged (ScenarioSpec.uniform=False) with no padding
        # policy: skip building the schedule and run the loop.
        return fallback()

    def span(name, **args):
        return tracer.span(name, **args) if tracer is not None \
            else contextlib.nullcontext()

    with span("schedule", n_tasks=len(tasks)):
        runs = [_build_seed_inputs(
                    cfg, dataclasses.replace(trainer, seed=s), rspec, backend,
                    tasks, pad=pad, eval_padded=eval_padded,
                    torch_device=dev, init=init)[0]
                for s in (seed_list if seed_list is not None
                          else [trainer.seed])]
    test_shapes = {(t.x_test.shape, t.y_test.shape) for t in tasks}
    if any(r is None for r in runs) or len(test_shapes) != 1:
        # The schedules built are discarded — their replay traffic is
        # *not* credited here; the loop fallback meters its own.
        return fallback()
    if tele.enabled:
        # The replay DRAM traffic of every schedule this run consumes
        # (host policies), or of the device buffer (in-graph) — once.
        for r in runs:
            if r.replay_traffic:
                tele.record(r.replay_traffic)

    n_tasks = len(tasks)
    steps = runs[0].schedule.steps_per_task
    t0 = time.perf_counter()
    with span("compile", backend=backend.name, n_tasks=n_tasks,
              steps_per_task=max(steps) if steps else 0):
        uploads = [_upload(r, tasks, dev) for r in runs]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    with span("execute", backend=backend.name):
        raw = [_execute(r, data, backend, all_tasks=True, baseline=baseline,
                        obs_on=obs_on) for r, data in zip(runs, uploads)]
    t2 = time.perf_counter()

    per_seed = [_summarize_run(
        r["R"], r["baseline_row"] if baseline
        else np.zeros(n_tasks, np.float32), r["losses"], baseline)
        for r in raw]
    out: dict[str, Any]
    if many:
        out = dict(per_seed[0])
        out.update(_aggregate_seeds(per_seed, seed_list))
    else:
        out = per_seed[0]
        if raw[0]["dev_state"] is not None:
            out["device_state"] = raw[0]["dev_state"]
    out["params"] = raw[0]["params"]
    out["compiled"] = True
    out["wall_s"] = t2 - t0
    out["steps_per_task"] = max(steps) if steps else 0
    if tracer is not None:
        out["compile_s"] = t1 - t0
        out["execute_s"] = t2 - t1
    if obs_on:
        from repro_torch.obs import build_runlog
        streams = [_obs_stream_args(r, rw, backend)
                   for r, rw in zip(runs, raw)]
        R_full = np.stack([p["R_full"] for p in per_seed])
        out["runlog"] = build_runlog(
            cadence=obs.cadence, steps_per_task=steps,
            task_acc=R_full if many else R_full[0],
            **{k: np.stack([s[k] for s in streams]) if many else v
               for k, v in streams[0].items()})
    if backend.tracker is not None:
        out["endurance"] = backend.tracker
    if tele.enabled:
        out["telemetry"] = tele
    return out


# ---------------------------------------------------------------------------
# Scenario × backend sweeps
# ---------------------------------------------------------------------------

def scenario_miru_config(tasks: list[TaskData], n_h: int = 100):
    """MiRUConfig sized to a task sequence: n_x from the feature width,
    n_y from the label range across *all* tasks (class-incremental
    streams allocate the full expanding head up front)."""
    from repro_torch.core.miru import MiRUConfig
    F = tasks[0].x_train.shape[2]
    n_y = int(max(int(t.y_train.max()) for t in tasks)) + 1
    return MiRUConfig(n_x=F, n_h=n_h, n_y=max(n_y, 2))


def run_sweep(scenarios: Sequence[str], backends: Sequence[str],
              trainer: Optional[TrainerSpec] = None,
              replay: Optional[ReplaySpec] = None,
              *, seed: int = 0, seeds: Optional[Sequence[int]] = None,
              n_h: int = 100, meter: bool = True,
              scenario_kwargs: Optional[dict] = None,
              obs: Optional[Any] = None,
              torch_device: Union[str, torch.device] = "cuda"
              ) -> dict[str, Any]:
    """The scenario × backend grid. Each cell runs :func:`run_compiled`
    (falling back to the Python loop for non-uniform streams) and reports
    average accuracy, forgetting, BWT, FWT — and, when ``meter`` is set
    and the substrate is a metered device, the live-metered power and
    GOPS/W from :mod:`repro_torch.telemetry`.

    ``obs`` (a :class:`repro_torch.obs.ObsSpec`) rides into every cell's
    :func:`run_compiled`: each cell opens a ``cell:{scenario}/{backend}``
    span on the tracer, metered cells grow a ``timeline`` section in
    their report, and the cell dict carries ``compile_s``/``execute_s``.

    Returns ``{"cells": {f"{scenario}/{backend}": cell, ...}, ...}``.
    """
    from repro_torch.analog.costmodel import M2RUCostModel
    from repro_torch.analog.endurance import EnduranceTracker
    from repro_torch.telemetry import telemetry_report

    trainer = trainer if trainer is not None else TrainerSpec()
    skw = dict(scenario_kwargs or {})
    tracer = getattr(obs, "tracer", None) if obs is not None else None
    cells: dict[str, Any] = {}
    for sc_name in scenarios:
        sc = get_scenario(sc_name)
        tasks = sc.build(seed, **skw)
        cfg = scenario_miru_config(tasks, n_h=n_h)
        tsp = dataclasses.replace(trainer, **sc.trainer_overrides)
        # The stream's preferred replay policy applies unless the caller
        # pinned one (the rule of trainer_overrides).
        rsp = sc.resolve_replay(replay)
        for be_name in backends:
            backend = get_backend(be_name)
            metered = meter and backend.spec.input_bits is not None
            if metered:
                backend.telemetry.enable()
                # Endurance tracking rides along: the run's write-count
                # maps land in the tracker, so the cell gets lifetime
                # columns (with per-cell ζ write-rate percentiles).
                if backend.tracker is None:
                    backend.tracker = EnduranceTracker()
            cell_scope = tracer.span(f"cell:{sc_name}/{be_name}") \
                if tracer is not None else contextlib.nullcontext()
            with cell_scope:
                res = run_compiled(cfg, tsp, tasks, replay=rsp,
                                   device=backend, seeds=seeds,
                                   uniform=sc.uniform, obs=obs,
                                   pad=sc.pad, torch_device=torch_device)
            cell = {
                "scenario": sc_name, "backend": be_name,
                "replay_policy": rsp.resolved_policy,
                "compiled": res["compiled"],
                "MA": res["MA"],
                "metrics": res["metrics"],
                "wall_s": res.get("wall_s"),
                "R": np.asarray(res["R"]).tolist(),
            }
            if "metrics_std" in res:
                cell["metrics_std"] = res["metrics_std"]
            if "compile_s" in res:
                cell["compile_s"] = res["compile_s"]
                cell["execute_s"] = res["execute_s"]
            if "runlog" in res:
                cell["runlog"] = res["runlog"]
            if metered:
                kind = "cmos" if be_name == "cmos" else "analog"
                rep = telemetry_report(
                    backend.telemetry, model=M2RUCostModel(n_h=n_h),
                    kind=kind, tracker=backend.tracker,
                    runlog=res.get("runlog"))
                cell["power_mw"] = rep["metered"]["power_mw"]
                cell["gops_per_w"] = rep["metered"]["gops_per_w"]
                cell["pj_per_op"] = rep["metered"]["pj_per_op"]
                if "lifetime" in rep:
                    lt = rep["lifetime"]
                    cell["lifetime_years"] = lt["years_mean"]
                    cell["lifetime_hot_tail_years"] = lt["years_hot_tail"]
                    # Per-cell ζ write-rate percentiles, not just the
                    # mean — the wear spread across the write map.
                    cell["zeta_write_rate"] = lt["rate_percentiles"]
            cells[f"{sc_name}/{be_name}"] = cell
    return {"cells": cells,
            "scenarios": list(scenarios), "backends": list(backends),
            "n_h": n_h, "seed": seed,
            "seeds": list(seeds) if seeds is not None else None}
