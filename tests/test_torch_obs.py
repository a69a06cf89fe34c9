"""The port's ``obs/`` (run logs, tracer, sinks) against the reference's
``repro.obs``, and its call sites: ``run_continual(obs=)``,
``telemetry_report(runlog=)`` and the serve engines' tracers.

The windowing, the reporting and the forgetting series are the
reference's numpy, so they are held to it exactly on the same inputs;
``step_stats`` exactly on its integer streams and at rtol 2e-5 on Σ|ΔG|;
the tracer's events by structure (times aside). A run's RunLog is held
to the reference's from the same initial state: the streams the schedule
decides exactly, the leading losses at ``test_torch_continual.py``'s
tolerance.
"""
import importlib
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.obs as jobs  # noqa: E402
from repro.backends import get_backend as jget_backend  # noqa: E402
from repro.telemetry import format_report as jformat_report  # noqa: E402
from repro.telemetry import Telemetry as JTelemetry  # noqa: E402
from repro.telemetry import format_timeline as jtimeline  # noqa: E402
from repro.telemetry import telemetry_report as jreport  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.analog.crossbar import CrossbarSpec  # noqa: E402
from repro_torch.backends import DeviceSpec, get_backend  # noqa: E402
from repro_torch.convert import run_state_from_numpy  # noqa: E402
from repro_torch.core.continual import (ReplaySpec, TrainerSpec,  # noqa: E402
                                        run_continual)
from repro_torch.scenarios import (build_scenario,  # noqa: E402
                                   scenario_miru_config)
from repro_torch.telemetry import (Telemetry, format_report,  # noqa: E402
                                   format_timeline, meters,
                                   telemetry_report)

jcontinual = importlib.import_module("repro.core.continual")
jscenarios = importlib.import_module("repro.scenarios")

STREAMS = ("steps", "loss", "write_pulses", "dg_mag", "replay_occupancy",
           "drift_ticks", "eval_steps", "task_acc")
TRAINER = dict(algo="dfa", epochs_per_task=1, batch_size=16)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors: the suite runs
    in parallel worker processes, where more threads only contend for
    the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _streams(rng, n, lead=()):
    shape = lead + (n,)
    return dict(
        loss=rng.uniform(0, 3, shape).astype(np.float32),
        write_pulses=rng.integers(0, 500, shape).astype(np.int64),
        dg_mag=rng.uniform(0, 2, shape).astype(np.float32),
        replay_occupancy=np.minimum(np.arange(n) * 7, 64).astype(np.int32)
        * np.ones(shape, np.int32),
        drift_ticks=(np.arange(n) % 2).astype(np.int64)
        * np.ones(shape, np.int64))


def _assert_runlogs_equal(a, b):
    assert (a.cadence, a.n_steps, a.n_windows) == \
        (b.cadence, b.n_steps, b.n_windows)
    for f in STREAMS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


# ---------------------------------------------------------------------------
# Windowing and reporting: the reference's numpy on the same inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cadence", [1, 3, 7, 50])
@pytest.mark.parametrize("steps_per_task,lead", [
    ([7], ()), ([5, 5, 4], ()), ([4, 6], (3,)), ([9, 9], (2,))])
def test_build_runlog_and_reports_equal_the_reference(cadence, steps_per_task,
                                                      lead):
    """Partial last windows, leading (per-seed) axes, the timeline, the
    thinned record view, the forgetting series and the printed block."""
    rng = np.random.default_rng(cadence + len(steps_per_task))
    n = sum(steps_per_task)
    kw = _streams(rng, n, lead)
    n_tasks = len(steps_per_task)
    kw["task_acc"] = rng.uniform(0, 1, lead + (n_tasks, n_tasks))
    got = obs.build_runlog(cadence=cadence, steps_per_task=steps_per_task,
                           **kw)
    want = jobs.build_runlog(cadence=cadence, steps_per_task=steps_per_task,
                             **kw)
    _assert_runlogs_equal(got, want)
    assert got.total_write_pulses == want.total_write_pulses
    assert got.total_drift_ticks == want.total_drift_ticks
    np.testing.assert_array_equal(got.forgetting_after_task(),
                                  want.forgetting_after_task())
    tl, jtl = obs.timeline(got), jobs.timeline(want)
    assert tl == jtl
    assert got.as_dict(max_points=2) == want.as_dict(max_points=2)
    assert format_timeline(tl) == jtimeline(jtl)
    assert obs.sparkline(tl["loss"], width=5) == \
        jobs.sparkline(jtl["loss"], width=5)


def test_runlog_empty_streams_and_spec():
    kw = dict(loss=np.zeros(0, np.float32),
              write_pulses=np.zeros(0, np.int64),
              dg_mag=np.zeros(0, np.float32),
              replay_occupancy=np.zeros(0, np.int64),
              drift_ticks=np.zeros(0, np.int64), task_acc=np.ones((0, 0)))
    got = obs.build_runlog(cadence=5, steps_per_task=[], **kw)
    _assert_runlogs_equal(
        got, jobs.build_runlog(cadence=5, steps_per_task=[], **kw))
    assert got.n_windows == 0 and got.total_write_pulses == 0
    assert obs.sparkline([]) == jobs.sparkline([]) == ""
    with pytest.raises(ValueError, match="per-step stream"):
        obs.build_runlog(cadence=1, steps_per_task=[3], **_streams(
            np.random.default_rng(0), 4), task_acc=np.ones((1, 1)))
    assert obs.ObsSpec().cadence == 1 and obs.ObsSpec(cadence=7).metrics
    for bad in (0, -3):
        with pytest.raises(ValueError, match="cadence"):
            obs.ObsSpec(cadence=bad)
    for drifting in (True, False):
        got, want = (obs.drift_stream(5, drifting=drifting),
                     jobs.drift_stream(5, drifting=drifting))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_step_stats_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    applied = {}
    for name, shape in (("w_h", (6, 9)), ("u_h", (9, 9)), ("b_h", (9,)),
                        ("w_o", (9, 4)), ("b_o", (4,))):
        v = rng.normal(0, 0.1, shape).astype(np.float32)
        applied[name] = v * (rng.uniform(size=shape) < 0.4)
    size = np.int32(rng.integers(0, 64))
    got = obs.step_stats({k: torch.from_numpy(v) for k, v in applied.items()},
                         {"size": torch.tensor(size)})
    want = jobs.step_stats({k: jnp.asarray(v) for k, v in applied.items()},
                           {"size": jnp.asarray(size)})
    assert [t.dtype for t in got] == [torch.int32, torch.float32,
                                      torch.int32]
    assert int(got[0]) == int(want[0])
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=2e-5)
    assert int(got[2]) == int(want[2]) == size
    zero = obs.step_stats({"w": torch.zeros(2, 2), "b": torch.ones(2)}, None)
    assert [float(t) for t in zero] == [0.0, 0.0, 0.0]


# ---------------------------------------------------------------------------
# Tracer and sinks
# ---------------------------------------------------------------------------

def _trace(mod):
    tr = mod.Tracer(process_name="t")
    with tr.span("outer", tag=1):
        with tr.span("inner", step=3):
            pass
        with tr.span("outer"):
            pass
        tr.instant("mark", k="v")
    tr.counter("queue", depth=3)
    with pytest.raises(RuntimeError):
        with tr.span("boom"):
            raise RuntimeError("x")
    return tr


def test_tracer_events_equal_the_reference_minus_times(tmp_path):
    got, want = _trace(obs), _trace(jobs)

    def shape(tr):
        return [(e["name"], e["ph"], e.get("args"), e.get("_depth"),
                 e.get("s")) for e in tr.events()]
    assert shape(got) == shape(want)
    summ, jsumm = got.summary(), want.summary()
    assert {k: v["count"] for k, v in summ.items()} == \
        {k: v["count"] for k, v in jsumm.items()}
    # The nested "outer" counts once; inner's time is inside outer's.
    assert summ["outer"]["count"] == 1
    assert got.total_s("outer") >= got.total_s("inner") > 0
    assert got.total_s("absent") == 0.0
    data = json.loads(got.export_chrome(tmp_path / "t.json").read_text())
    jdata = json.loads(want.export_chrome(tmp_path / "j.json").read_text())
    assert [sorted(e) for e in data["traceEvents"]] == \
        [sorted(e) for e in jdata["traceEvents"]]
    assert data["displayTimeUnit"] == jdata["displayTimeUnit"]
    assert all(e["ts"] >= 0 and e["dur"] >= 0
               for e in data["traceEvents"] if e["ph"] == "X")


def test_step_span_enters_the_profiler_range():
    tr = obs.Tracer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("serve.step", step=0):
            torch.ones(4).sum()
    assert "serve.step" in {e.name for e in prof.events()}


def test_run_record_schema_and_jsonl_roundtrip(tmp_path):
    kw = dict(gates={"ok": True}, counters={"macs/w_h": 4},
              timeline={"loss": [1.0]}, extra={"note": "t"})
    rec = obs.run_record("run", "unit", {"MA": 0.9, "n": 3}, **kw)
    jrec = jobs.run_record("run", "unit", {"MA": 0.9, "n": 3}, **kw)
    assert obs.RUN_RECORD_SCHEMA == jobs.RUN_RECORD_SCHEMA == rec["schema"]
    assert set(rec) - {"torch"} == set(jrec) - {"jax"}
    for k in set(rec) - {"torch", "ts"}:
        assert rec[k] == jrec[k], k
    assert rec["torch"] == {"version": torch.__version__,
                            "cuda": torch.version.cuda, "device": "cpu"}
    sink = obs.JsonlSink(tmp_path / "sub" / "h.jsonl")
    assert sink.read() == []
    p = sink.emit(rec)
    assert p == sink.emit(obs.run_record("run", "unit", {"MA": 0.8}))
    rows = sink.read()
    assert [r["metrics"]["MA"] for r in rows] == [0.9, 0.8]
    assert rows[0] == json.loads(json.dumps(rec))


def test_telemetry_report_timeline_equals_the_reference():
    rng = np.random.default_rng(5)
    kw = _streams(rng, 12)
    kw["task_acc"] = np.array([[0.9, 0.2, 0.1], [0.7, 0.8, 0.3],
                               [0.5, 0.6, 0.9]])
    log = obs.build_runlog(cadence=4, steps_per_task=[4, 4, 4], **kw)
    jlog = jobs.build_runlog(cadence=4, steps_per_task=[4, 4, 4], **kw)
    counters = {"adc_conversions/hidden": 806400,
                "adc_conversions/out": 80640, "bit_pulses/u_h": 6451200,
                "bit_pulses/w_h": 1806336, "interp/h": 806400,
                "macs/u_h": 80640000, "macs/w_h": 22579200,
                "macs/w_o": 8064000, "sample_steps": 8064,
                "sequences": 288, "wbs_phases/u_h": 64512,
                "wbs_phases/w_h": 64512, "wbs_phases/w_o": 64512,
                "write_events": 12, "write_pulses/w_h": 9576}
    t, jt = Telemetry(True), JTelemetry(True)
    t.counters.update(counters)
    jt.counters.update(counters)
    rep = telemetry_report(t, runlog=log)
    jrep = jreport(jt, runlog=jlog)
    assert rep == jrep and "timeline" in rep
    assert format_report(rep) == jformat_report(jrep)
    assert "forgetting/task" in format_report(rep)


# ---------------------------------------------------------------------------
# run_continual(obs=)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    tasks = build_scenario("permuted", seed=0, n_tasks=2, n_train=64,
                           n_test=32)
    return scenario_miru_config(tasks, n_h=24), tasks


def _assert_bitwise(a, b):
    np.testing.assert_array_equal(a["R"], b["R"])
    assert a["losses"] == b["losses"]
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k


def test_run_continual_obs_is_bitwise_neutral(small):
    cfg, tasks = small
    kw = dict(replay=ReplaySpec(capacity=32), device="ideal",
              torch_device="cpu")
    base = run_continual(cfg, TrainerSpec(**TRAINER), tasks, **kw)
    res = run_continual(cfg, TrainerSpec(**TRAINER), tasks,
                        obs=obs.ObsSpec(cadence=2), **kw)
    _assert_bitwise(base, res)
    assert "runlog" not in base
    log = res["runlog"]
    assert isinstance(log, obs.RunLog)
    assert log.n_steps == len(base["losses"]) == 8
    assert log.task_acc.shape == (2, 2)
    np.testing.assert_array_equal(log.task_acc, base["R"])
    np.testing.assert_array_equal(log.eval_steps, [3, 7])
    off = run_continual(cfg, TrainerSpec(**TRAINER), tasks,
                        obs=obs.ObsSpec(metrics=False), **kw)
    assert "runlog" not in off


def _drifting_backend():
    spec = CrossbarSpec(write_sigma=0.0, prog_sigma=0.0, read_sigma=0.0,
                        drift_rate=0.05, w_clip=1.0)
    return get_backend("analog_state", spec=DeviceSpec(
        input_bits=8, adc_bits=8, weight_clip=1.0, crossbar=spec))


@pytest.mark.parametrize("name", ["wbs", "analog_state"])
def test_write_stream_sums_to_the_counter(small, name):
    cfg, tasks = small
    backend = get_backend("wbs") if name == "wbs" else _drifting_backend()
    backend.telemetry.enable()
    res = run_continual(cfg, TrainerSpec(**TRAINER), tasks,
                        replay=ReplaySpec(capacity=32), device=backend,
                        obs=obs.ObsSpec(cadence=4), torch_device="cpu")
    log = res["runlog"]
    assert log.total_write_pulses == \
        backend.telemetry.total(meters.WRITE_PULSES) > 0
    assert log.total_drift_ticks == \
        backend.telemetry.total(meters.DRIFT_TICKS)
    assert log.total_drift_ticks == (log.n_steps if name == "analog_state"
                                     else 0)


def test_ingraph_occupancy_stream(small):
    """The device buffer's fill, read after each step: never past the
    capacity, nondecreasing, the reference's (while the buffer fills,
    every offered row is taken, so the fill is the schedule's)."""
    cfg, tasks = small
    trainer = TrainerSpec(algo="adam", epochs_per_task=1, batch_size=16)
    res = run_continual(cfg, trainer, tasks,
                        replay=ReplaySpec(capacity=40, policy="loss_aware"),
                        device="ideal", obs=obs.ObsSpec(),
                        torch_device="cpu")
    occ = res["runlog"].replay_occupancy
    np.testing.assert_array_equal(occ, [16, 32, 40, 40, 40, 40, 40, 40])


@pytest.fixture(scope="module")
def ref_runs(small):
    """The reference's and the port's loop on ``wbs`` with the obs streams
    on, from the reference's initial state."""
    cfg, tasks = small
    jtasks = jscenarios.build_scenario("permuted", seed=0, n_tasks=2,
                                       n_train=64, n_test=32)
    jcfg = jscenarios.scenario_miru_config(jtasks, n_h=24)
    jtr = jcontinual.TrainerSpec(**TRAINER)
    jbackend = jget_backend("wbs")
    key, p, psi, _ = jcontinual._init_run(jcfg, jtr, jbackend)
    ospec = dict(cadence=1)
    want = jcontinual.run_continual(
        jcfg, jtr, jtasks, replay=jcontinual.ReplaySpec(capacity=32),
        device=jbackend, obs=jobs.ObsSpec(**ospec))
    got = run_continual(
        cfg, TrainerSpec(**TRAINER), tasks, replay=ReplaySpec(capacity=32),
        device="wbs", obs=obs.ObsSpec(**ospec), torch_device="cpu",
        init=run_state_from_numpy(np.asarray(key),
                                  {k: np.asarray(v) for k, v in p.items()},
                                  np.asarray(psi), "cpu"))
    return got["runlog"], want["runlog"]


def test_runlog_follows_the_reference_from_its_state(ref_runs):
    got, want = ref_runs
    assert (got.cadence, got.n_steps) == (want.cadence, want.n_steps) == \
        (1, 8)
    for f in ("steps", "replay_occupancy", "drift_ticks", "eval_steps"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    np.testing.assert_allclose(got.loss[:5], want.loss[:5], rtol=1e-4,
                               atol=1e-5)
    assert got.task_acc.shape == want.task_acc.shape == (2, 2)
    assert got.replay_occupancy.max() == 32


# ---------------------------------------------------------------------------
# The serve engines' tracers
# ---------------------------------------------------------------------------

def test_recurrent_engine_tracer_spans_and_bits():
    from repro.core.miru import MiRUConfig as JMiRUConfig
    from repro.core.miru import init_miru_params as jinit
    from repro.serve import RecurrentServeConfig as JConfig
    from repro.serve import RecurrentServeEngine as JEngine
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.miru import MiRUConfig
    from repro_torch.serve import RecurrentServeConfig, RecurrentServeEngine
    jp = jinit(jax.random.PRNGKey(0), JMiRUConfig(n_x=6, n_h=12, n_y=4))
    params = params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                               "cpu")
    rng = np.random.default_rng(0)
    frames = [rng.uniform(-1, 1, (n, 6)).astype(np.float32)
              for n in (9, 4, 13, 6, 7)]

    def serve(tracer, jax_engine=False):
        kw = dict(batch_slots=2, chunk=4, device="wbs", fresh_meter=True,
                  tracer=tracer)
        eng = (JEngine(JMiRUConfig(n_x=6, n_h=12, n_y=4), JConfig(**kw),
                       jp) if jax_engine else
               RecurrentServeEngine(MiRUConfig(n_x=6, n_h=12, n_y=4),
                                    RecurrentServeConfig(**kw), params,
                                    torch_device="cpu"))
        reqs = [eng.submit(f, uid=i % 3) for i, f in enumerate(frames)]
        eng.run_until_drained()
        return eng, [r.logits.copy() for r in reqs]

    tr, jtr = obs.Tracer(), jobs.Tracer()
    eng, traced = serve(tr)
    _, plain = serve(None)
    serve(jtr, jax_engine=True)
    for a, b in zip(traced, plain):
        np.testing.assert_array_equal(a, b)
    # A span per step() call, the reference's: the idle calls of the
    # drain loop too, which dispatch nothing and keep the step number.
    steps = [e["args"] for e in tr.events() if e["name"] == "serve.step"]
    assert steps == \
        [e["args"] for e in jtr.events() if e["name"] == "serve.step"]
    assert {a["step"] for a in steps} == set(range(eng.steps_run + 1))


def test_lm_engine_tracer_spans_and_tokens():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.serve import ServeConfig, ServeEngine
    cfg = get_smoke_config("qwen2-0.5b")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    prompts = [[5, 9, 17, 3], [7, 8, 2], [42], [11, 4, 6, 1, 2]]

    def serve(tracer):
        eng = ServeEngine(cfg, ServeConfig(batch_slots=2, max_len=32,
                                           eos_token=-1, tracer=tracer,
                                           torch_device="cpu"), params)
        reqs = [eng.submit(p, 4) for p in prompts]
        eng.run_until_drained()
        return eng, [r.tokens for r in reqs], reqs

    tr = obs.Tracer()
    eng, traced, reqs = serve(tr)
    assert traced == serve(None)[1]
    ev = tr.events()
    pre = [e["args"] for e in ev if e["name"] == "serve.prefill"]
    assert pre == [{"rid": r.rid, "prompt_len": len(r.prompt)}
                   for r in reqs]
    steps = [e for e in ev if e["name"] == "serve.step"]
    assert [e["args"]["step"] for e in steps] == \
        list(range(eng.steps_run)) + [eng.steps_run]
