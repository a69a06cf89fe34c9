"""The port's ``scenarios/`` against the reference's ``repro.scenarios``:
the registry and every builder (bitwise), the metrics (exactly), and the
compiled whole-sequence run — bit for bit the port's own loop on every
backend and path, and within 2 test examples of the reference's
``run_compiled`` from the same initial state (``test_torch_continual.py``
holds ``run_continual`` so).
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.backends import get_backend as jget_backend  # noqa: E402
from repro_torch import scenarios  # noqa: E402
from repro_torch.backends import get_backend  # noqa: E402
from repro_torch.convert import run_state_from_numpy  # noqa: E402
from repro_torch.core.continual import (ReplaySpec, TrainerSpec,  # noqa: E402
                                        run_continual)
from repro_torch.obs import ObsSpec, Tracer  # noqa: E402
from repro_torch.telemetry import meters  # noqa: E402

jscenarios = importlib.import_module("repro.scenarios")
jcontinual = importlib.import_module("repro.core.continual")

NAMES = ("class_incremental", "drift", "keyword_fewshot", "noisy_label",
         "permuted", "rotated", "seq_cifar10", "seq_mnist", "split",
         "streaming")
REAL = ("seq_mnist", "seq_cifar10")
SIZE = dict(n_tasks=3, n_train=48, n_test=24)
STREAMS = ("steps", "loss", "write_pulses", "dg_mag", "replay_occupancy",
           "drift_ticks", "eval_steps")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors: the suite runs
    in parallel worker processes, where more threads only contend for
    the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Registry, builders, metrics
# ---------------------------------------------------------------------------

def test_registry_names_and_metadata_equal_the_reference():
    # The reference's own tests register and unregister scenarios of
    # their own in its registry; the built-in ten are what both hold.
    assert scenarios.available_scenarios() == NAMES
    assert set(NAMES) <= set(jscenarios.available_scenarios())
    for name in NAMES:
        got, want = scenarios.get_scenario(name), \
            jscenarios.get_scenario(name)
        assert got.name == want.name == name
        assert got.description == want.description
        assert got.uniform == want.uniform
        assert got.replay_policy == want.replay_policy
        assert dict(got.trainer_overrides) == dict(want.trainer_overrides)
        assert (got.pad is None) == (want.pad is None)
        if got.pad is not None:
            assert dataclasses.asdict(got.pad) == \
                dataclasses.asdict(want.pad)
        assert got.resolve_replay(None).resolved_policy == \
            want.resolve_replay(None).resolved_policy
        pinned = got.resolve_replay(ReplaySpec(policy="ring"))
        assert pinned.policy == "ring"
    with pytest.raises(ValueError, match="unknown scenario"):
        scenarios.build_scenario("not-a-scenario")


def test_register_unregister_roundtrip():
    @scenarios.register_scenario("tmp_scn", description="test only",
                                 trainer_overrides={"epochs_per_task": 1})
    def _mk(seed, n_tasks=2, n_train=8, n_test=4):
        return scenarios.build_scenario("permuted", seed, n_tasks=n_tasks,
                                        n_train=n_train, n_test=n_test)
    try:
        assert "tmp_scn" in scenarios.available_scenarios()
        assert len(scenarios.build_scenario("tmp_scn", 0)) == 2
        assert scenarios.get_scenario("tmp_scn").trainer_overrides == \
            {"epochs_per_task": 1}
    finally:
        scenarios.unregister_scenario("tmp_scn")
    assert "tmp_scn" not in scenarios.available_scenarios()


@pytest.mark.parametrize("name", NAMES)
def test_builders_equal_the_reference_bit_for_bit(name):
    """The real streams on their offline surrogates (never the network)."""
    kw = dict(SIZE, offline=True) if name in REAL else dict(SIZE)
    got = scenarios.build_scenario(name, seed=1, **kw)
    want = jscenarios.build_scenario(name, seed=1, **kw)
    assert len(got) == len(want) == SIZE["n_tasks"]
    for a, b in zip(got, want):
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if y is None or np.isscalar(y):
                assert x == y, f.name
            else:
                x, y = np.asarray(x), np.asarray(y)
                assert x.dtype == y.dtype, f.name
                np.testing.assert_array_equal(x, y, err_msg=f.name)


MATRICES = (
    np.array([[0.9]]),
    np.array([[0.9, 0.1], [0.6, 0.8]]),
    np.array([[0.9, 0.2, 0.1], [0.7, 0.85, 0.3], [0.5, 0.6, 0.95]]),
    np.random.default_rng(3).uniform(0, 1, (5, 5)),
)


@pytest.mark.parametrize("R", MATRICES, ids=lambda R: f"{len(R)}x{len(R)}")
def test_metrics_equal_the_reference(R):
    base = np.linspace(0.05, 0.15, len(R))
    for fn in ("average_accuracy", "backward_transfer", "forgetting"):
        assert getattr(scenarios, fn)(R) == getattr(jscenarios, fn)(R)
    assert scenarios.forward_transfer(R, base) == \
        jscenarios.forward_transfer(R, base)
    assert scenarios.continual_metrics(R, base) == \
        jscenarios.continual_metrics(R, base)
    assert scenarios.continual_metrics(R) == jscenarios.continual_metrics(R)


def test_metrics_reject_bad_shapes():
    with pytest.raises(ValueError, match="square"):
        scenarios.average_accuracy(np.zeros((2, 3)))
    with pytest.raises(ValueError, match="baseline"):
        scenarios.forward_transfer(np.zeros((3, 3)), np.zeros(2))


# ---------------------------------------------------------------------------
# The compiled run == the loop, bit for bit, inside the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def permuted():
    tasks = scenarios.build_scenario("permuted", seed=0, n_tasks=3,
                                     n_train=64, n_test=32)
    return scenarios.scenario_miru_config(tasks, n_h=16), tasks


def _keyword():
    sc = scenarios.get_scenario("keyword_fewshot")
    tasks = sc.build(0, n_tasks=2, n_train=32, n_test=24)
    return scenarios.scenario_miru_config(tasks, n_h=16), tasks, sc


def _bitwise(loop, comp):
    np.testing.assert_array_equal(loop["R"], comp["R"])
    assert loop["MA"] == comp["MA"]
    assert loop["acc_after_each"] == comp["acc_after_each"]
    assert loop["losses"] == comp["losses"]
    for k in loop["params"]:
        assert torch.equal(loop["params"][k], comp["params"][k]), k
    a, b = loop.get("device_state"), comp.get("device_state")
    assert (a is None) == (b is None)
    if a is not None:
        for k in a:
            for leaf in a[k]:
                assert torch.equal(a[k][leaf], b[k][leaf]), (k, leaf)
    la, lb = loop["runlog"], comp["runlog"]
    for f in STREAMS:
        np.testing.assert_array_equal(getattr(la, f), getattr(lb, f),
                                      err_msg=f)
    np.testing.assert_array_equal(la.task_acc, np.tril(lb.task_acc))


@pytest.mark.parametrize("case", ["ideal", "wbs", "analog", "analog_state",
                                  "adam_wbs", "loss_aware", "keyword"])
def test_compiled_equals_the_loop_bit_for_bit(permuted, case):
    """R, losses, params, the device state and the RunLog; with telemetry
    and endurance on, the write counters, the tracker's maps and its
    update count."""
    cfg, tasks = permuted
    trainer = TrainerSpec(algo="dfa", epochs_per_task=1, batch_size=16)
    rspec = ReplaySpec(capacity=32)
    name, pad, uniform = case, None, True
    if case == "adam_wbs":
        name, trainer = "wbs", dataclasses.replace(trainer, algo="adam")
    elif case == "loss_aware":
        name = "ideal"
        trainer = dataclasses.replace(trainer, algo="adam")
        rspec = ReplaySpec(capacity=24, policy="loss_aware")
    elif case == "keyword":
        cfg, tasks, sc = _keyword()
        name, pad, uniform = "wbs", sc.pad, sc.uniform
        trainer = dataclasses.replace(trainer, batch_size=8)
    runs, backends = [], []
    for compiled in (False, True):
        backend = get_backend(name, spec_overrides=dict(track_endurance=True))
        backend.telemetry.enable()
        kw = dict(replay=rspec, device=backend, pad=pad, torch_device="cpu",
                  obs=ObsSpec(cadence=3))
        runs.append(scenarios.run_compiled(cfg, trainer, tasks,
                                           uniform=uniform, **kw)
                    if compiled else run_continual(cfg, trainer, tasks, **kw))
        backends.append(backend)
    loop, comp = runs
    assert comp["compiled"] is True
    _bitwise(loop, comp)
    a, b = (be.telemetry.snapshot() for be in backends)
    writes = [k for k in a if k.startswith(meters.WRITE_PULSES)]
    assert writes and a[meters.WRITE_EVENTS] == b[meters.WRITE_EVENTS]
    for k in writes + [meters.DRIFT_TICKS, meters.REPLAY_READS,
                       meters.REPLAY_WRITES]:
        assert a.get(k) == b.get(k), k
    ta, tb = (be.tracker for be in backends)
    assert ta.updates_applied == tb.updates_applied == len(loop["losses"])
    for k, v in ta.state_dict()["counts"].items():
        np.testing.assert_array_equal(v, tb.state_dict()["counts"][k])


def test_full_matrix_baseline_row_and_metered_counts(permuted):
    """The upper triangle is populated, the untrained row sits at chance,
    and eager metering gives the reference's traced multiplicities:
    n_steps·B·T + (n_tasks² + n_tasks)·n_test·T sample steps."""
    cfg, tasks = permuted
    trainer = TrainerSpec(algo="dfa", epochs_per_task=2, batch_size=16)
    backend = get_backend("analog_state",
                          spec_overrides=dict(track_endurance=True))
    backend.telemetry.enable()
    comp = scenarios.run_compiled(cfg, trainer, tasks,
                                  replay=ReplaySpec(capacity=32),
                                  device=backend, torch_device="cpu")
    R, R_full = comp["R"], comp["R_full"]
    iu = np.triu_indices(3, 1)
    assert np.all(R[iu] == 0) and np.any(R_full[iu] > 0)
    np.testing.assert_array_equal(np.tril(R_full), R)
    assert set(comp["metrics"]) == {"average_accuracy", "backward_transfer",
                                    "forgetting", "forward_transfer"}
    assert comp["baseline_row"].shape == (3,)
    assert float(comp["baseline_row"].max()) < 0.3       # chance is 0.1
    n_steps = 3 * comp["steps_per_task"]
    snap = backend.telemetry.snapshot()
    assert snap[meters.WRITE_EVENTS] == n_steps
    assert comp["endurance"].updates_applied == n_steps
    B, T = trainer.batch_size, tasks[0].x_train.shape[1]
    n_test = tasks[0].x_test.shape[0]
    assert backend.telemetry.total(meters.SAMPLE_STEPS) == \
        n_steps * B * T + (3 * 3 + 3) * n_test * T
    no_base = scenarios.run_compiled(cfg, trainer, tasks,
                                     replay=ReplaySpec(capacity=32),
                                     torch_device="cpu", baseline=False)
    np.testing.assert_array_equal(no_base["baseline_row"], np.zeros(3))
    assert "forward_transfer" not in no_base["metrics"]


def test_seeds_fallback_and_declared_ragged(permuted):
    cfg, tasks = permuted
    trainer = TrainerSpec(algo="dfa", epochs_per_task=1, batch_size=16)
    kw = dict(replay=ReplaySpec(capacity=32), torch_device="cpu")
    multi = scenarios.run_compiled(cfg, trainer, tasks, seeds=[0, 1],
                                   obs=ObsSpec(), **kw)
    assert multi["compiled"] and multi["seeds"] == [0, 1]
    assert set(multi["metrics_std"]) == set(multi["metrics"])
    assert multi["MA"] == np.mean([p["MA"] for p in multi["per_seed"]])
    assert multi["runlog"].loss.shape[0] == 2
    for s in (0, 1):
        one = scenarios.run_compiled(cfg, dataclasses.replace(trainer,
                                                              seed=s),
                                     tasks, **kw)
        np.testing.assert_array_equal(multi["per_seed"][s]["R_full"],
                                      one["R_full"])
        assert multi["per_seed"][s]["losses"] == one["losses"]
    assert multi["per_seed"][0]["losses"] != multi["per_seed"][1]["losses"]
    declared = scenarios.run_compiled(cfg, trainer, tasks, uniform=False,
                                      **kw)
    assert declared["compiled"] is False and declared["R"].shape == (3, 3)
    ragged = [tasks[0], dataclasses.replace(
        scenarios.build_scenario("permuted", 1, n_tasks=1, n_train=32,
                                 n_test=32)[0], task_id=1)]
    fb = scenarios.run_compiled(cfg, trainer, ragged, seeds=[0, 1], **kw)
    assert fb["compiled"] is False and "metrics_std" in fb
    with pytest.raises(ValueError, match="init"):
        scenarios.run_compiled(cfg, trainer, tasks, seeds=[0, 1],
                               init=(None, None, None), **kw)


def test_tracer_spans(permuted):
    cfg, tasks = permuted
    tr = Tracer()
    res = scenarios.run_compiled(
        cfg, TrainerSpec(algo="dfa", epochs_per_task=1, batch_size=16),
        tasks, replay=ReplaySpec(capacity=32), torch_device="cpu",
        obs=ObsSpec(cadence=2, tracer=tr))
    assert [e["name"] for e in tr.events() if e["ph"] == "X"] == \
        ["schedule", "compile", "execute"]
    assert res["compile_s"] > 0 and res["execute_s"] > 0
    assert res["wall_s"] >= res["compile_s"] + res["execute_s"]


# ---------------------------------------------------------------------------
# The port against the reference's run_compiled and run_sweep
# ---------------------------------------------------------------------------

N_TEST = 50


@pytest.fixture(scope="module")
def ref_pair():
    """The reference's run_compiled and the port's on ``wbs`` (metered,
    endurance tracked) from the reference's initial state."""
    kw = dict(n_tasks=3, n_train=128, n_test=N_TEST)
    tasks = scenarios.build_scenario("permuted", 0, **kw)
    jtasks = jscenarios.build_scenario("permuted", 0, **kw)
    cfg = scenarios.scenario_miru_config(tasks, n_h=32)
    jcfg = jscenarios.scenario_miru_config(jtasks, n_h=32)
    tkw = dict(algo="dfa", epochs_per_task=6, batch_size=16)
    jbackend = jget_backend("wbs", spec_overrides=dict(track_endurance=True))
    jbackend.telemetry.enable()
    key, p, psi, _ = jcontinual._init_run(
        jcfg, jcontinual.TrainerSpec(**tkw), jbackend)
    want = jscenarios.run_compiled(
        jcfg, jcontinual.TrainerSpec(**tkw), jtasks,
        replay=jcontinual.ReplaySpec(capacity=64), device=jbackend)
    backend = get_backend("wbs", spec_overrides=dict(track_endurance=True))
    backend.telemetry.enable()
    got = scenarios.run_compiled(
        cfg, TrainerSpec(**tkw), tasks, replay=ReplaySpec(capacity=64),
        device=backend, torch_device="cpu",
        init=run_state_from_numpy(np.asarray(key),
                                  {k: np.asarray(v) for k, v in p.items()},
                                  np.asarray(psi), "cpu"))
    return got, want, backend, jbackend


def test_r_full_within_two_examples_of_the_reference(ref_pair):
    got, want = ref_pair[:2]
    assert got["compiled"] and want["compiled"]
    assert got["steps_per_task"] == want["steps_per_task"]
    jR = np.asarray(want["R_full"])
    assert got["R_full"].shape == jR.shape == (3, 3)
    assert np.abs(got["R_full"] - jR).max() <= 2 / N_TEST + 1e-9, \
        (got["R_full"], jR)
    np.testing.assert_array_equal(got["R"], np.tril(got["R_full"]))
    assert abs(got["MA"] - want["MA"]) <= 2 / N_TEST + 1e-9
    assert got["R"][0, 0] > 0.3                     # learns; chance 0.1
    np.testing.assert_allclose(got["losses"][:5], want["losses"][:5],
                               rtol=1e-4, atol=1e-5)
    assert sorted(set(want) - {"device_state"}) == \
        sorted(set(got) - {"device_state"})


def test_counters_follow_the_reference(ref_pair):
    """Shape-determined counters exactly the reference's traced run's;
    the data-dependent write pulses within 1 %."""
    _, _, backend, jbackend = ref_pair
    a, b = backend.telemetry.snapshot(), jbackend.telemetry.snapshot()
    assert set(a) == set(b)
    for k in a:
        if k.startswith(meters.WRITE_PULSES):
            assert abs(a[k] - b[k]) <= 0.01 * b[k], k
        else:
            assert a[k] == b[k], k
    assert backend.tracker.updates_applied == jbackend.tracker.updates_applied


def test_run_sweep_cells_equal_the_reference_in_keys():
    kw = dict(n_h=8, scenario_kwargs=dict(n_tasks=2, n_train=32, n_test=16))
    tkw = dict(algo="dfa", epochs_per_task=1, batch_size=16)
    grid = scenarios.run_sweep(["permuted"], ["ideal", "analog_state"],
                               TrainerSpec(**tkw), ReplaySpec(capacity=32),
                               torch_device="cpu", **kw)
    jgrid = jscenarios.run_sweep(["permuted"], ["ideal", "analog_state"],
                                 jcontinual.TrainerSpec(**tkw),
                                 jcontinual.ReplaySpec(capacity=32), **kw)
    assert set(grid) == set(jgrid)
    assert set(grid["cells"]) == set(jgrid["cells"]) == \
        {"permuted/ideal", "permuted/analog_state"}
    for key, cell in grid["cells"].items():
        assert set(cell) == set(jgrid["cells"][key]), key
        assert cell["compiled"] and 0.0 <= cell["MA"] <= 1.0
        assert cell["replay_policy"] == jgrid["cells"][key]["replay_policy"]
    assert grid["cells"]["permuted/analog_state"]["power_mw"] > 0
    assert "power_mw" not in grid["cells"]["permuted/ideal"]


# ---------------------------------------------------------------------------
# The paper's CLI on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [("--loop",),
                                   ("--trainer", "dfa_hw", "--seeds", "2")])
def test_example_cli_reports_and_writes_its_trace_and_record(
        tmp_path, capsys, flags):
    """``examples/continual_learning_torch.py`` on the CPU: the per-task
    loop, and the compiled run through the legacy trainer string with two
    seeds. The report prints its accuracy, metrics and telemetry lines
    with the timeline, and the trace and run record parse."""
    import json
    import pathlib
    import importlib.util
    path = (pathlib.Path(__file__).resolve().parents[1] / "examples"
            / "continual_learning_torch.py")
    spec = importlib.util.spec_from_file_location("cl_torch_example", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    trace, record = tmp_path / "trace.json", tmp_path / "run.jsonl"
    example.main(["--torch-device", "cpu", "--tasks", "2", "--epochs", "1",
                  "--hidden", "16", "--obs-cadence", "5",
                  "--trace", str(trace), "--record", str(record), *flags])
    out = capsys.readouterr().out
    for line in ("accuracy after each task", "  task 1: ",
                 "final mean accuracy (eq. 20): ",
                 "device telemetry (metered from this run):", "timeline:",
                 "trace written to", "run record appended to"):
        assert line in out, line
    compiled = "--loop" not in flags
    assert ("[compiled whole sequence]" in out) == compiled
    assert ("forgetting: " in out) == compiled
    assert (" ± " in out) == compiled
    events = json.loads(trace.read_text())["traceEvents"]
    spans = {e["name"] for e in events if e["ph"] == "X"}
    assert ({"schedule", "compile", "execute"} <= spans) == compiled
    recs = [json.loads(ln) for ln in record.read_text().splitlines()]
    assert len(recs) == 1 and recs[0]["schema"] == 1
    assert recs[0]["extra"]["torch_device"] == "cpu"
    assert recs[0]["torch"]["device"] == "cpu"
    assert 0.0 <= recs[0]["metrics"]["MA"] <= 1.0
    assert recs[0]["counters"]["write_events"] > 0
    assert len(recs[0]["timeline"]["loss"]) > 0
