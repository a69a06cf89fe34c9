"""End-to-end driver (the paper's workload) on the PyTorch port,
``repro_torch``: domain-incremental continual learning on a pluggable
device substrate — several hundred training steps through a sequence of
tasks with reservoir replay, DFA-through-time, K-WTA-sparsified noisy
crossbar writes, WBS-quantized inference, and device telemetry: power,
GOPS/W and the lifetime projection are metered from the run's own
backend activity (repro_torch.telemetry).

The flags and the report are those of examples/continual_learning.py,
plus --torch-device: the run goes on the card ("cuda", the default)
unless ``--torch-device cpu`` asks for the CPU.

The task stream (--scenario, any name in the repro_torch.scenarios
registry), the algorithm (--algo adam|dfa) and the substrate (--backend,
any name in the repro_torch.backends registry) compose freely. By default
the whole sequence runs compiled — its schedule uploaded once, no host
read per step (repro_torch.scenarios.sweep) — and reports
forgetting/transfer metrics next to accuracy; --loop uses the per-task
Python loop instead (bit for bit the same R, losses and params). The
legacy combined trainer strings (adam | dfa | dfa_hw) keep working via
--trainer.

The rehearsal layer is pluggable too: --replay-policy picks any
registered repro_torch.replay policy (reservoir | ring | class_balanced |
task_stratified | loss_aware); without the flag, the scenario's
preferred policy applies (class_incremental rehearses class-balanced,
drift rides the FIFO ring) and reservoir remains the global default.

Observability (repro_torch.obs): --obs-cadence N collects the per-step
metric streams into a RunLog (timeline rendered in the telemetry
report), --trace writes a Chrome/Perfetto trace.json with
schedule/compile/execute spans, --record appends a schema-versioned
run-record JSONL. One command produces all three:

    python examples/continual_learning_torch.py \\
        --backend analog_state --obs-cadence 10 \\
        --trace trace.json --record run.jsonl

The real sequential streams (seq_mnist, seq_cifar10) and the ragged
keyword_fewshot stream run through the same compiled run: the
scenario's registered PadPolicy routes them through the masked steps,
and --offline pins the checksum-verified download path to the
deterministic surrogate.

    python examples/continual_learning_torch.py --algo dfa --backend analog_state
    python examples/continual_learning_torch.py --scenario seq_mnist --offline
    python examples/continual_learning_torch.py --scenario rotated --seeds 3
    python examples/continual_learning_torch.py --scenario class_incremental --replay-policy loss_aware
    python examples/continual_learning_torch.py --trainer dfa_hw   # legacy
    python examples/continual_learning_torch.py --torch-device cpu --tasks 2 --epochs 1 --hidden 32
"""
import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.analog.costmodel import M2RUCostModel  # noqa: E402
from repro_torch.backends import available_backends, get_backend  # noqa: E402
from repro_torch.core.continual import (ContinualConfig,  # noqa: E402
                                        ReplaySpec, TrainerSpec,
                                        run_continual)
from repro_torch.replay import available_policies  # noqa: E402
from repro_torch.scenarios import (available_scenarios,  # noqa: E402
                                   build_scenario, get_scenario,
                                   run_compiled, scenario_miru_config)
from repro_torch.telemetry import format_report, telemetry_report  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trainer", default=None,
                    choices=["adam", "dfa", "dfa_hw"],
                    help="legacy combined trainer string (shim path)")
    ap.add_argument("--algo", default=None, choices=["adam", "dfa"],
                    help="learning rule (default: dfa)")
    ap.add_argument("--backend", default=None,
                    choices=list(available_backends()),
                    help="device substrate from the backend registry "
                         "(default: analog_state)")
    ap.add_argument("--scenario", default="permuted",
                    choices=list(available_scenarios()),
                    help="task stream from the scenario registry")
    ap.add_argument("--replay-policy", default=None,
                    choices=list(available_policies()),
                    help="replay policy from the repro_torch.replay "
                         "registry (default: the scenario's preferred "
                         "policy, else reservoir)")
    ap.add_argument("--tasks", type=int, default=4)
    ap.add_argument("--offline", action="store_true",
                    help="real-data scenarios (seq_mnist, seq_cifar10): "
                         "skip the download and use the deterministic "
                         "synthetic surrogate (same as REPRO_DATA_OFFLINE=1)")
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--hidden", type=int, default=100)
    ap.add_argument("--seeds", type=int, default=1,
                    help="run N seeds one after the other in the compiled "
                         "run (metrics mean ± std)")
    ap.add_argument("--loop", action="store_true",
                    help="use the per-task Python loop instead of the "
                         "compiled whole-sequence run")
    ap.add_argument("--no-fused", action="store_true",
                    help="force the per-timestep device_vmm recurrence "
                         "instead of the fused WBS×MiRU scan kernel "
                         "(bit-identical; fused is the fast default on "
                         "substrates that support it)")
    ap.add_argument("--no-telemetry", action="store_true",
                    help="skip activity metering + the energy report")
    ap.add_argument("--obs-cadence", type=int, default=None, metavar="N",
                    help="collect the repro_torch.obs metric streams, "
                         "windowed every N training steps (timeline in "
                         "the report)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace.json "
                         "(schedule/compile/execute spans)")
    ap.add_argument("--record", default=None, metavar="PATH",
                    help="append a schema-versioned run-record to this "
                         "JSONL file")
    ap.add_argument("--torch-device", default="cuda",
                    help="where the run goes: cuda (the default) or cpu")
    args = ap.parse_args(argv)

    obs = tracer = None
    if args.obs_cadence is not None or args.trace or args.record:
        from repro_torch.obs import ObsSpec, Tracer
        if args.trace:
            tracer = Tracer(process_name="continual_learning_torch")
        obs = ObsSpec(cadence=args.obs_cadence or 1, tracer=tracer)

    scenario_kwargs = dict(n_tasks=args.tasks, n_train=600, n_test=200)
    if args.offline:
        # Only the downloading builders take the knob; the synthetic
        # streams are offline by construction.
        if args.scenario not in ("seq_mnist", "seq_cifar10"):
            ap.error("--offline only applies to the real-data scenarios "
                     "(seq_mnist, seq_cifar10)")
        scenario_kwargs["offline"] = True
    tasks = build_scenario(args.scenario, seed=0, **scenario_kwargs)
    cfg = scenario_miru_config(tasks, n_h=args.hidden)

    if args.trainer is not None:
        if args.algo is not None or args.backend is not None:
            ap.error("--trainer (legacy) conflicts with --algo/--backend; "
                     "pass one or the other")
        # Legacy path: the flat config maps onto the specs + registry.
        ccfg = ContinualConfig(trainer=args.trainer,
                               epochs_per_task=args.epochs, batch_size=32,
                               replay_capacity=512,
                               track_endurance=args.trainer != "adam",
                               fused_recurrence=not args.no_fused)
        trainer, replay, backend = ccfg.specs()
    else:
        algo = args.algo or "dfa"
        name = args.backend or "analog_state"
        trainer = TrainerSpec(algo=algo, epochs_per_task=args.epochs,
                              batch_size=32)
        replay = ReplaySpec(capacity=512)
        backend = get_backend(
            name, spec_overrides=dict(track_endurance=algo != "adam"))

    # Scenario protocols can pin trainer fields (streaming is single-pass).
    scenario = get_scenario(args.scenario)
    overrides = scenario.trainer_overrides
    if overrides or args.no_fused:
        if args.no_fused:
            overrides = dict(overrides, fused_recurrence=False)
        trainer = dataclasses.replace(trainer, **overrides)
    # Replay policy: the explicit flag wins; otherwise the scenario's
    # preferred policy (same resolution rule as trainer_overrides).
    if args.replay_policy is not None:
        replay = dataclasses.replace(replay, policy=args.replay_policy)
    replay = scenario.resolve_replay(replay)

    if not args.no_telemetry:
        backend.telemetry.enable()
    n_steps = args.tasks * trainer.epochs_per_task * (600 // 32)
    mode = "python loop" if args.loop else "compiled whole sequence"
    print(f"scenario={args.scenario}  algo={trainer.algo}  "
          f"backend={backend.name}  replay={replay.resolved_policy}  "
          f"tasks={args.tasks}  ~{n_steps} training steps  [{mode}]  "
          f"torch_device={args.torch_device}")
    if args.loop:
        if args.seeds > 1:
            ap.error("--seeds runs inside the compiled run; drop --loop "
                     "to use it")
        res = run_continual(cfg, trainer, tasks, replay=replay,
                            device=backend, obs=obs, pad=scenario.pad,
                            torch_device=args.torch_device)
    else:
        seeds = list(range(args.seeds)) if args.seeds > 1 else None
        res = run_compiled(cfg, trainer, tasks, replay=replay,
                           device=backend, seeds=seeds, obs=obs,
                           uniform=scenario.uniform, pad=scenario.pad,
                           torch_device=args.torch_device)

    print("\naccuracy after each task (mean over seen tasks):")
    for t, a in enumerate(res["acc_after_each"]):
        print(f"  task {t}: {a:.3f}")
    print(f"final mean accuracy (eq. 20): {res['MA']:.3f}")
    print(f"final per-task accuracies:   "
          f"{[round(float(a), 3) for a in res['R'][-1]]}")
    if "metrics" in res:
        m = res["metrics"]
        std = res.get("metrics_std", {})

        def fmt(k):
            s = f"{m[k]:+.3f}"
            return s + (f" ± {std[k]:.3f}" if k in std else "")

        line = (f"forgetting: {fmt('forgetting')}   "
                f"BWT: {fmt('backward_transfer')}")
        if "forward_transfer" in m:
            line += f"   FWT: {fmt('forward_transfer')}"
        print(line)

    m = M2RUCostModel(n_h=args.hidden)
    if backend.telemetry.enabled:
        # Metered numbers from the run that just happened — power, GOPS/W
        # and lifetime derived from the backend's own activity counters.
        kind = "cmos" if backend.name == "cmos" else "analog"
        # Lifetime only makes sense for memristive substrates — SRAM
        # weight registers in the CMOS baseline have no endurance limit.
        tracker = res.get("endurance") if kind == "analog" else None
        rep = telemetry_report(backend.telemetry, model=m, kind=kind,
                               tracker=tracker,
                               runlog=res.get("runlog"))
        print("\ndevice telemetry (metered from this run):")
        print(format_report(rep))
    elif "endurance" in res:
        tracker = res["endurance"]
        rate = tracker.mean_writes() / max(tracker.updates_applied, 1)
        print(f"\nmemristor write rate: {rate:.3f} writes/device/update")
        gain = 1.0 / max(rate, 1e-9)
        print(f"lifespan gain vs dense writes: {gain:.2f}× "
              f"(paper's ζ gain: 12.2/6.9 = 1.77×; absolute years depend "
              f"on workload write density)")
        print(f"accelerator: {m.gops():.1f} GOPS @ "
              f"{m.power_w()*1e3:.2f} mW → {m.gops_per_watt():.0f} GOPS/W")

    if "runlog" in res and not backend.telemetry.enabled:
        # Telemetry off but streams requested: render the timeline alone.
        from repro_torch.obs import timeline
        from repro_torch.telemetry import format_timeline
        print("\n" + format_timeline(timeline(res["runlog"])))

    if tracer is not None:
        if "compile_s" in res:
            print(f"\ncompile {res['compile_s']:.2f} s / execute "
                  f"{res['execute_s']:.3f} s (the upload, then the "
                  f"steps)")
        path = tracer.export_chrome(args.trace)
        print(f"trace written to {path}")
    if args.record:
        from repro_torch.obs import JsonlSink, run_record
        metrics = {"MA": res["MA"], "wall_s": res.get("wall_s")}
        if "metrics" in res:
            metrics.update(res["metrics"])
        rec = run_record(
            "run", "continual", metrics,
            counters=(backend.telemetry.snapshot()
                      if backend.telemetry.enabled else None),
            timeline=(res["runlog"].as_dict(max_points=200)
                      if "runlog" in res else None),
            extra={"scenario": args.scenario, "backend": backend.name,
                   "algo": trainer.algo,
                   "replay_policy": replay.resolved_policy,
                   "torch_device": args.torch_device})
        path = JsonlSink(args.record).emit(rec)
        print(f"run record appended to {path}")


if __name__ == "__main__":
    main()
