"""The port's ``fleet/`` against the reference's ``repro.fleet``, on the
CPU, at a small size (2 tasks of 64/32 rows, n_h 24, 2-4 chips):

  * ``device_seeds`` exact; the heterogeneity and fleet-fault draws
    within 3 ulp (``normal``), the dead-chip flags exact;
  * ``overlay_device_states``/``overlay_fault_states`` from the
    reference's draws: the ``"_het"`` overlay and the masks bit for bit,
    the re-programmed pairs at fp32 tolerance;
  * ``run_fleet`` with ``"none"`` bit for bit ``run_compiled(seeds=
    device_seeds)``; every chip against the reference's chip built from
    ``_build_seed_inputs`` + ``_make_run_fn`` under ``jax.jit`` (no
    ``shard_map``: the reference's ``run_fleet`` does not run under this
    jax), within 3 test examples;
  * the fleet's counters: the forward's D times one chip's, the write
    pulses and tracker maps the per-chip maps' sums;
  * ``shard_tasks`` exact; ``fleet_aggregate``, ``telemetry_report(
    fleet=)`` and ``format_fleet`` equal the reference's on the same
    result.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro import faults as jfaults  # noqa: E402
from repro import fleet as jfleet  # noqa: E402
from repro.backends import get_backend as jget_backend  # noqa: E402
from repro.core import continual as jcontinual  # noqa: E402
from repro.data.pipeline import shard_tasks as jshard_tasks  # noqa: E402
from repro.fleet import heterogeneity as jhet  # noqa: E402
from repro.scenarios import build_scenario as jbuild_scenario  # noqa: E402
from repro.scenarios import sweep as jsweep  # noqa: E402
from repro.telemetry import meters as jmeters  # noqa: E402
from repro.telemetry import report as jreport  # noqa: E402
from repro_torch import fleet  # noqa: E402
from repro_torch.analog.endurance import EnduranceTracker  # noqa: E402
from repro_torch.backends import get_backend  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.continual import ReplaySpec, TrainerSpec  # noqa: E402
from repro_torch.data import shard_tasks  # noqa: E402
from repro_torch.faults import FaultSpec  # noqa: E402
from repro_torch.fleet import heterogeneity as het  # noqa: E402
from repro_torch.obs import ObsSpec, Tracer  # noqa: E402
from repro_torch.scenarios import (build_scenario, run_compiled,  # noqa: E402
                                   scenario_miru_config)
from repro_torch.telemetry import format_fleet, report  # noqa: E402

SIZE = dict(n_tasks=2, n_train=64, n_test=32)
N_H = 24
REPLAY = dict(capacity=32)
FAULTS = dict(sa0_rate=0.02, sa1_rate=0.01, rate_spread=0.5,
              dead_chip_rate=0.3)
# R within this many test examples of the reference's (of SIZE's 32).
R_EXAMPLES = 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    tasks = build_scenario("permuted", 0, **SIZE)
    return scenario_miru_config(tasks, n_h=N_H), \
        TrainerSpec(algo="dfa", epochs_per_task=1), tasks


def _ulps(a, b) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32)).max())


def _fleet(setup, spec, device, **kw):
    cfg, tr, tasks = setup
    return fleet.run_fleet(cfg, tr, tasks, spec, replay=ReplaySpec(**REPLAY),
                           device=device, torch_device="cpu", **kw)


# ---------------------------------------------------------------------------
# Specs and draws
# ---------------------------------------------------------------------------

def test_fleet_spec_and_profiles_equal_the_reference():
    with pytest.raises(ValueError, match="n_devices"):
        fleet.FleetSpec(n_devices=0)
    with pytest.raises(ValueError, match="het_profile"):
        fleet.FleetSpec(het_profile="extreme")
    for name, prof in fleet.HET_PROFILES.items():
        assert prof.fields() == jfleet.HET_PROFILES[name].fields()
    assert (het._SEED_STREAM_SALT, het._HET_FOLD, het._PROG_FOLD,
            het._FAULT_FOLD) == (jhet._SEED_STREAM_SALT, jhet._HET_FOLD,
                                 jhet._PROG_FOLD, jhet._FAULT_FOLD)


@pytest.mark.parametrize("seed", [0, 1, 0xFFFFFFFF])
def test_device_seeds_equal_the_reference(seed):
    got = fleet.device_seeds(fleet.FleetSpec(n_devices=64, seed=seed))
    assert got == jfleet.device_seeds(jfleet.FleetSpec(n_devices=64,
                                                       seed=seed))
    assert len(set(got)) == 64 and all(isinstance(s, int) for s in got)


@pytest.mark.parametrize("profile", ["none", "mild", "harsh"])
def test_heterogeneity_draws_within_3_ulp(profile):
    for seed in (0, 5):
        got = fleet.draw_heterogeneity(fleet.FleetSpec(
            n_devices=32, het_profile=profile, seed=seed))
        want = jfleet.draw_heterogeneity(jfleet.FleetSpec(
            n_devices=32, het_profile=profile, seed=seed))
        if profile == "none":
            assert got is None and want is None
            continue
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == np.float32 and got[k].shape == (32,)
            assert _ulps(got[k], want[k]) <= 3, k


def test_draw_fleet_faults_equal_the_reference():
    spec = fleet.FleetSpec(n_devices=16, seed=3)
    jspec = jfleet.FleetSpec(n_devices=16, seed=3)
    assert fleet.draw_fleet_faults(spec, None) == (None, None)
    assert fleet.draw_fleet_faults(spec, FaultSpec(sa0_rate=0.1)) \
        == (None, None)
    for kw in (FAULTS, dict(FAULTS, rate_spread=0.0),
               dict(FAULTS, dead_chip_rate=0.0)):
        scale, dead = fleet.draw_fleet_faults(spec, FaultSpec(**kw))
        jscale, jdead = jfleet.draw_fleet_faults(jspec,
                                                 jfaults.FaultSpec(**kw))
        assert _ulps(scale, jscale) <= 3
        np.testing.assert_array_equal(dead, np.asarray(jdead))
        assert dead.dtype == bool


def test_supports_heterogeneity_and_shard_count(setup):
    assert fleet.supports_heterogeneity(get_backend("analog_state"))
    assert not fleet.supports_heterogeneity(get_backend("ideal"))
    with pytest.raises(ValueError, match="analog_state"):
        _fleet(setup, fleet.FleetSpec(n_devices=2, het_profile="mild"),
               "ideal")
    assert fleet.fleet_shard_count(8) == 1
    assert fleet.fleet_shard_count(8, max_shards=4) == 1


def test_overlays_from_the_reference_draws():
    """Each chip's re-programmed state from the reference's own draws
    and initial params: the overlay and the masks (sampled from the
    programming key, then re-sampled under the chip's severity) bit for
    bit, the pairs at fp32 tolerance."""
    fspec = dict(FAULTS, n_spare_cols=2)
    jbe = jget_backend("analog_state", spec_overrides=dict(
        faults=jfaults.FaultSpec(**fspec)))
    be = get_backend("analog_state", spec_overrides=dict(
        faults=FaultSpec(**fspec)))
    jspec = jfleet.FleetSpec(n_devices=3, het_profile="mild", seed=4)
    seeds = jfleet.device_seeds(jspec)
    jcfg = jsweep.scenario_miru_config(jbuild_scenario("permuted", 0,
                                                       **SIZE), n_h=N_H)
    jparams = [jcontinual._init_run(
        jcfg, jcontinual.TrainerSpec(seed=s), jbe)[1] for s in seeds]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *jparams)
    jdraw = jfleet.draw_heterogeneity(jspec)
    want = jhet.overlay_device_states(jbe, stacked, seeds, jdraw)
    draw = {k: np.asarray(v) for k, v in jdraw.items()}
    params = [params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
              for p in jparams]
    got = fleet.overlay_device_states(be, params, seeds, draw)
    jscale, jdead = jfleet.draw_fleet_faults(
        jspec, jfaults.FaultSpec(**fspec))
    want_f = jhet.overlay_fault_states(jbe, stacked, seeds, jscale, jdead,
                                       jfaults.FaultSpec(**fspec))
    got_f = fleet.overlay_fault_states(be, params, seeds,
                                       np.asarray(jscale), np.asarray(jdead),
                                       FaultSpec(**fspec))
    for d in range(3):
        w = jax.tree.map(lambda v: np.asarray(v[d]), want)
        for k, v in w["_het"].items():
            assert got[d]["_het"][k].item() == v, k
        for tree_got, tree_want in ((got[d]["_faults"], w["_faults"]),
                                    (got_f[d], jax.tree.map(
                                        lambda v: np.asarray(v[d]),
                                        want_f))):
            for n in tree_want:
                for k, v in tree_want[n].items():
                    np.testing.assert_array_equal(
                        tree_got[n][k].numpy(), v, err_msg=f"{n}/{k}")
        for n in ("w_h", "u_h", "w_o"):
            for g in ("g_pos", "g_neg"):
                np.testing.assert_allclose(got[d][n][g].numpy(), w[n][g],
                                           rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# run_fleet
# ---------------------------------------------------------------------------

def test_zero_het_parity_with_run_compiled(setup):
    """``"none"``: each chip's run is ``run_compiled``'s for its seed, bit
    for bit (R, losses, chip 0's params, the fleet metrics)."""
    cfg, tr, tasks = setup
    spec = fleet.FleetSpec(n_devices=3, het_profile="none", seed=11)
    seeds = fleet.device_seeds(spec)
    fl = _fleet(setup, spec, "ideal")
    rc = run_compiled(cfg, tr, tasks, replay=ReplaySpec(**REPLAY),
                      device="ideal", seeds=seeds, torch_device="cpu")
    assert fl["device_seeds"] == seeds and fl["het"] is None
    for i in range(3):
        np.testing.assert_array_equal(fl["per_device"][i]["R_full"],
                                      rc["per_seed"][i]["R_full"])
        assert fl["per_device"][i]["losses"] == rc["per_seed"][i]["losses"]
    for k, v in rc["params"].items():
        assert torch.equal(fl["params"][k], v)
        assert torch.equal(fl["params_fleet"][k][0], v)
        assert fl["params_fleet"][k].shape == (3,) + tuple(v.shape)
    assert fl["metrics"] == rc["metrics"]
    assert (fl["n_shards"], fl["n_local"], fl["n_devices"]) == (1, 3, 3)
    assert "faults" not in fl


def test_fleet_counters_are_the_chips_totals(setup):
    """A metered ``wbs`` fleet of two chips: every forward counter is
    the sum of the chips' single-seed runs', the write pulses and the
    tracker's maps are the per-chip maps' sums, and the per-chip maps are
    each chip's own run's."""
    cfg, tr, tasks = setup
    spec = fleet.FleetSpec(n_devices=2, seed=2)
    be = get_backend("wbs", spec_overrides=dict(track_endurance=True))
    be.telemetry.enable()
    fl = _fleet(setup, spec, be)
    snap = be.telemetry.snapshot()
    want: dict = {}
    maps = []
    for s in fleet.device_seeds(spec):
        one = get_backend("wbs", spec_overrides=dict(track_endurance=True))
        one.telemetry.enable()
        run_compiled(cfg, dataclasses.replace(tr, seed=s), tasks,
                     replay=ReplaySpec(**REPLAY), device=one,
                     torch_device="cpu")
        for k, v in one.telemetry.snapshot().items():
            want[k] = want.get(k, 0) + v
        maps.append(one.tracker.state_dict()["counts"])
    assert snap == want
    for name, arr in fl["wcounts"].items():
        assert arr.dtype == np.int32 and arr.shape[0] == 2
        for d in range(2):
            np.testing.assert_array_equal(arr[d], maps[d][name])
    counts = be.tracker.state_dict()["counts"]
    for name in counts:
        np.testing.assert_array_equal(counts[name],
                                      fl["wcounts"][name].sum(axis=0))
    assert be.tracker.updates_applied == 2 * fl["updates_per_device"]


def _reference_chip(jcfg, jtr, jbe, jtasks, s, d, jdraw, jscale, jdead):
    """The reference's chip ``d``: ``_build_seed_inputs`` at its seed, its
    overlays (re-programmed pairs, re-sampled masks), ``_make_run_fn``
    under ``jax.jit`` (no ``shard_map``)."""
    tsp = dataclasses.replace(jtr, seed=int(s))
    _, _, opt = jcontinual._make_raw_steps(jcfg, tsp, jbe)
    inp, sched = jsweep._build_seed_inputs(jcfg, tsp,
                                           jcontinual.ReplaySpec(**REPLAY),
                                           jbe, jtasks, opt)
    dev_state = inp.dev_state
    if jdraw is not None:
        dev_state = jbe.init_device_state(
            inp.params, jax.random.fold_in(jax.random.PRNGKey(s),
                                           jhet._PROG_FOLD),
            het={k: v[d] for k, v in jdraw.items()})
    if jscale is not None:
        dev_state = {**dev_state, "_faults": jfaults.sample_fault_state(
            inp.params, jax.random.fold_in(jax.random.PRNGKey(s),
                                           jhet._FAULT_FOLD),
            jbe.spec.faults, sa1_value=jbe._fault_value_scale(),
            rate_scale=jscale[d], dead=jdead[d])}
    arrays = list(inp.as_arrays())
    arrays[2] = dev_state
    run = jsweep._make_run_fn(jcfg, tsp, jbe, len(jtasks),
                              inp.xs.shape[1], False, True)
    res = jax.jit(run)(*arrays,
                       jnp.asarray(np.stack([t.x_test for t in jtasks])),
                       jnp.asarray(np.stack([t.y_test for t in jtasks])))
    return jax.tree.map(np.asarray, res)


@pytest.mark.parametrize("name,profile", [("analog_state", "mild"),
                                          ("wbs", "none")])
def test_every_chip_within_the_reference_bands(setup, name, profile):
    """Two chips under a fault spread (and on ``analog_state`` the mild
    profile): each chip's R within 3 test examples of the reference's
    chip, its first loss at fp32 tolerance, dead chips at chance on both
    sides; the draws, the seeds and the dead flags the reference's."""
    cfg, tr, tasks = setup
    spec = fleet.FleetSpec(n_devices=2, het_profile=profile, seed=2)
    fl = _fleet(setup, spec, get_backend(name, spec_overrides=dict(
        faults=FaultSpec(**FAULTS))))
    jbe = jget_backend(name, spec_overrides=dict(
        faults=jfaults.FaultSpec(**FAULTS)))
    jspec = jfleet.FleetSpec(n_devices=2, het_profile=profile, seed=2)
    jtasks = jbuild_scenario("permuted", 0, **SIZE)
    jcfg = jsweep.scenario_miru_config(jtasks, n_h=N_H)
    jdraw = jfleet.draw_heterogeneity(jspec)
    jscale, jdead = jfleet.draw_fleet_faults(jspec,
                                             jfaults.FaultSpec(**FAULTS))
    assert fl["device_seeds"] == jfleet.device_seeds(jspec)
    np.testing.assert_array_equal(fl["faults"]["dead_chips"],
                                  np.asarray(jdead))
    jtr = jcontinual.TrainerSpec(algo="dfa", epochs_per_task=1)
    for d, s in enumerate(fl["device_seeds"]):
        ref = _reference_chip(jcfg, jtr, jbe, jtasks, s, d, jdraw, jscale,
                              jdead)
        got = fl["per_device"][d]
        dR = np.abs(got["R_full"] - ref["R_full"]).max()
        assert dR <= R_EXAMPLES / SIZE["n_test"] + 1e-9, (d, dR)
        np.testing.assert_allclose(got["losses"][0],
                                   ref["losses"].reshape(-1)[0], rtol=1e-4)
        if fl["faults"]["dead_chips"][d]:
            assert got["metrics"]["average_accuracy"] < 0.3


def test_fleet_reports_faults_and_the_aggregate_equals_the_reference(setup):
    """Four metered ``wbs`` chips under a fault spread: dead chips at
    chance; ``fleet_aggregate``, ``telemetry_report(fleet=)`` and
    ``format_fleet`` equal the reference's on the same result."""
    cfg, tr, tasks = setup
    be = get_backend("wbs", spec_overrides=dict(
        faults=FaultSpec(sa0_rate=0.02, rate_spread=0.5,
                         dead_chip_rate=0.3), track_endurance=True))
    be.telemetry.enable()
    fl = _fleet(setup, fleet.FleetSpec(n_devices=4, seed=2), be)
    dead = fl["faults"]["dead_chips"]
    assert dead.any() and not dead.all()
    accs = [p["metrics"]["average_accuracy"] for p in fl["per_device"]]
    for i in np.flatnonzero(dead):
        assert accs[i] < 0.3, (i, accs[i])
    agg = fleet.fleet_aggregate(fl)
    jt = jmeters.Telemetry(enabled=True)
    jt.counters.update(be.telemetry.snapshot())
    jagg = jfleet.fleet_aggregate({**fl, "telemetry": jt})
    # Dead chips write nothing: their lifetimes are inf, and the
    # percentiles over them nan on both sides (assert_equal takes nan as
    # equal to nan).
    np.testing.assert_equal(agg, jagg)
    assert agg["faults"]["dead_devices"] == [int(i)
                                             for i in np.flatnonzero(dead)]
    assert "max_fault_rate_device" in agg["hot_tail"]
    rep = report.telemetry_report(be.telemetry, fleet=agg)
    jrep = jreport.telemetry_report(jt, fleet=jagg)
    np.testing.assert_equal(rep, jrep)
    assert report.format_report(rep) == jreport.format_report(jrep)
    assert format_fleet(agg) == jreport.format_fleet(jagg)
    assert format_fleet(agg).startswith("fleet: 4 devices")


def test_fleet_without_fault_spec_omits_section(setup):
    fl = _fleet(setup, fleet.FleetSpec(n_devices=2, seed=0), "ideal")
    assert "faults" not in fl and "faults" not in fleet.fleet_aggregate(fl)
    assert fl["wcounts"] is None


def test_heterogeneous_fleet_obs_and_shards(setup):
    """A mild-profile ``analog_state`` fleet, each chip on its own data
    shard, with obs: the chips differ, the overlay is reported and rides
    each chip's state (drift every update), the RunLog has a leading
    chip axis and the tracer the three spans."""
    tracer = Tracer()
    fl = _fleet(setup, fleet.FleetSpec(n_devices=2, het_profile="mild",
                                       seed=4), "analog_state",
                shard_data=True, obs=ObsSpec(cadence=1, tracer=tracer))
    assert set(fl["het"]) == {"prog_sigma", "read_sigma", "write_sigma",
                              "drift_rate"}
    r0, r1 = (fl["per_device"][i]["R_full"] for i in range(2))
    assert not np.array_equal(r0, r1) or \
        fl["per_device"][0]["losses"] != fl["per_device"][1]["losses"]
    log = fl["runlog"]
    assert log.loss.shape[0] == 2 and log.task_acc.shape[:1] == (2,)
    assert log.drift_ticks.shape[0] == 2 and log.drift_ticks.all()
    assert {"schedule", "compile", "execute"} <= {
        e["name"] for e in tracer.events()}
    assert fl["compile_s"] >= 0 and fl["execute_s"] > 0
    # shard_data: each chip trained on n_train // 2 rows a task.
    assert fl["updates_per_device"] == 2 * (SIZE["n_train"] // 2 // 32)


def test_shard_tasks_equals_the_reference():
    tasks = build_scenario("permuted", 0, n_tasks=2, n_train=50, n_test=8)
    jtasks = jbuild_scenario("permuted", 0, n_tasks=2, n_train=50, n_test=8)
    rows = []
    for i in range(3):
        got, want = shard_tasks(tasks, 3, i), jshard_tasks(jtasks, 3, i)
        for g, w in zip(got, want):
            for f in ("x_train", "y_train", "x_test", "y_test"):
                np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
            assert g.x_train.shape[0] == 16
        rows.append({tuple(r.ravel()[:4]) for r in got[0].x_train})
    assert not rows[0] & rows[1] and not rows[1] & rows[2]
    with pytest.raises(ValueError, match="out of range"):
        shard_tasks(tasks, 3, 3)
    with pytest.raises(ValueError, match="fewer than"):
        shard_tasks(tasks, 51, 0)


def test_tracker_record_counts_of_a_fleet_fold():
    """The fleet tracker's fold is ``record_counts`` of each chip's map:
    the same totals as the chips' update calls."""
    a, b = EnduranceTracker(), EnduranceTracker()
    m = {"w": torch.tensor([[True, False]])}
    for _ in range(3):
        a.record_update(m)
    b.record_counts(a._counts, a.updates_applied)
    assert b.updates_applied == 3
    np.testing.assert_array_equal(b.all_counts(), a.all_counts())
