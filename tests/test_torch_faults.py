"""The port's ``faults/`` against the reference's ``repro.faults``, on the
CPU, on inputs made from a seed:

  * the masks bit for bit (``stuck``, ``value``, the spares and the
    column map come from uniform draws, which are exact), ``wear_limit``
    within 3 ulp (``normal`` and ``exp``);
  * ``apply_cell_faults``, ``mask_updates``, ``apply_read_upsets`` and
    ``advance_wear`` (every mode) on the same masks, bit for bit;
  * the zero-fault contract inside the port: a zero-rate FaultSpec
    changes no bit of a ``run_compiled`` run on ``ideal``, ``wbs`` and
    ``analog_state``; a spec runs on all five backends through
    ``run_continual``, ``run_compiled`` and ``run_sweep``;
  * fused == per-step under masks, bit for bit, and the masked forward
    against the reference's from the same masks (tie-aware); stuck cells
    reject writes; read upsets are keyed and take the per-step path;
  * the mitigation stack: the march's map exact, ``remap_columns`` equal
    to the reference's and injective, ``compensate_bias`` at fp32
    tolerance, ``recalibrate`` on the reference's batches;
  * ``prng.permutation``/``choice`` bit for bit, ties included.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro import faults as jfaults  # noqa: E402
from repro.backends import DeviceSpec as JDeviceSpec  # noqa: E402
from repro.backends import get_backend as jget_backend  # noqa: E402
from repro.core.continual import TrainerSpec as JTrainerSpec  # noqa: E402
from repro.core.miru import MiRUConfig as JMiRUConfig  # noqa: E402
from repro.scenarios import build_scenario as jbuild_scenario  # noqa: E402
from repro.scenarios.sweep import \
    scenario_miru_config as jscenario_miru_config  # noqa: E402
from repro_torch import faults, prng, testing  # noqa: E402
from repro_torch.backends import DeviceSpec, get_backend  # noqa: E402
from repro_torch.convert import device_state_from_numpy  # noqa: E402
from repro_torch.core.continual import (ReplaySpec, TrainerSpec,  # noqa: E402
                                        _init_run, run_continual)
from repro_torch.core.miru import MiRUConfig, init_miru_params  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.scenarios import (build_scenario, run_compiled,  # noqa: E402
                                   run_sweep, scenario_miru_config)
from tests._hypothesis_compat import given, settings, st  # noqa: E402

CFG = MiRUConfig(n_x=8, n_h=20, n_y=4)
JCFG = JMiRUConfig(n_x=8, n_h=20, n_y=4)
WBS = dict(input_bits=8, adc_bits=8, weight_clip=1.0)
FAULTY = dict(sa0_rate=0.03, sa1_rate=0.01, dead_row_rate=0.02,
              dead_col_rate=0.02)
# The paper's tiles (28×100×10).
PAPER = {"w_h": (28, 100), "u_h": (100, 100), "w_o": (100, 10),
         "b_h": (100,), "b_o": (10,)}
BACKENDS = ("ideal", "wbs", "analog", "cmos", "analog_state")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return init_miru_params(prng.PRNGKey(0), CFG, "cpu")


@pytest.fixture(scope="module")
def x_seq():
    return torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 12, CFG.n_x)).astype(np.float32))


def _jp(params):
    return {k: jnp.asarray(v.numpy()) for k, v in params.items()}


def _wbs(faults_spec=None, name="wbs"):
    return get_backend(name, spec=DeviceSpec(**WBS, faults=faults_spec))


def _jwbs(faults_kw=None, name="wbs"):
    fs = None if faults_kw is None else jfaults.FaultSpec(**faults_kw)
    return jget_backend(name, spec=JDeviceSpec(**WBS, faults=fs))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _ulps(a, b) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32)).max()) if a.size else 0


def _tiles_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for name in want:
        assert set(got[name]) == set(want[name]), name
        for k, v in want[name].items():
            g = got[name][k].cpu().numpy()
            if k == "wear_limit":
                assert _ulps(g, v) <= 3, (name, k)
            else:
                assert g.dtype == np.asarray(v).dtype, (name, k)
                np.testing.assert_array_equal(g, np.asarray(v),
                                              err_msg=f"{name}/{k}")


# ---------------------------------------------------------------------------
# Masks and the mask algebra
# ---------------------------------------------------------------------------

MASK_CASES = [
    (0, dict(sa0_rate=0.005, sa1_rate=0.005), None, None),
    (1, dict(sa0_rate=0.005, sa1_rate=0.005, n_spare_cols=4), None, None),
    (2, dict(FAULTY, n_spare_cols=4, wearout=True), None, None),
    (3, dict(sa0_rate=0.1, sa1_rate=0.3, dead_col_rate=0.1,
             n_spare_cols=2), 0.37, False),
    (4, dict(sa0_rate=0.02, rate_spread=0.5, dead_chip_rate=0.3,
             n_spare_cols=1), 1.9, True),
    (5, dict(wearout=True, wearout_spread=0.0, wearout_endurance=3.0),
     None, None),
]


@pytest.mark.parametrize("seed,kw,scale,dead", MASK_CASES)
def test_masks_equal_the_reference(seed, kw, scale, dead):
    """The paper's tile shapes at several rates, seeds, spare counts and
    per-chip severities: every mask bit for bit, the wear limits within
    3 ulp."""
    tp = {k: torch.zeros(v) for k, v in PAPER.items()}
    jp = {k: jnp.zeros(v) for k, v in PAPER.items()}
    got = faults.sample_fault_state(tp, prng.PRNGKey(seed),
                                    faults.FaultSpec(**kw), sa1_value=1.5,
                                    rate_scale=scale, dead=dead)
    want = jfaults.sample_fault_state(
        jp, jax.random.PRNGKey(seed), jfaults.FaultSpec(**kw),
        sa1_value=1.5,
        rate_scale=None if scale is None else jnp.float32(scale),
        dead=None if dead is None else jnp.asarray(dead))
    _tiles_equal(got, _np_tree(want))
    assert faults.stuck_fraction(got) == jfaults.stuck_fraction(want)


def test_mask_ops_equal_the_reference():
    """``apply_cell_faults`` (with a remapped column map),
    ``mask_updates`` and ``apply_read_upsets`` on the same masks and
    inputs: bit for bit; masking is idempotent."""
    kw = dict(FAULTY, n_spare_cols=3)
    jp = {k: jnp.zeros(v) for k, v in PAPER.items()}
    jst = jfaults.remap_columns(jfaults.sample_fault_state(
        jp, jax.random.PRNGKey(9), jfaults.FaultSpec(**kw), sa1_value=1.5))
    st = device_state_from_numpy(_np_tree(jst), "cpu")
    rng = np.random.default_rng(3)
    for name in ("w_h", "u_h", "w_o"):
        w = rng.uniform(-1, 1, PAPER[name]).astype(np.float32)
        got = faults.apply_cell_faults(torch.from_numpy(w), st[name])
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jfaults.apply_cell_faults(jnp.asarray(w), jst[name])))
        assert torch.equal(faults.apply_cell_faults(got, st[name]), got)
    ups = {k: rng.uniform(-0.1, 0.1, v).astype(np.float32)
           for k, v in PAPER.items()}
    got = faults.mask_updates({k: torch.from_numpy(v)
                               for k, v in ups.items()}, st)
    want = jfaults.mask_updates({k: jnp.asarray(v) for k, v in ups.items()},
                                jst)
    for k in ups:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    pre = rng.uniform(-4, 4, (32, 100)).astype(np.float32)
    for seed in (0, 1):
        got = faults.apply_read_upsets(torch.from_numpy(pre),
                                       prng.PRNGKey(seed), 0.05, 4.0)
        want = jfaults.apply_read_upsets(jnp.asarray(pre),
                                         jax.random.PRNGKey(seed), 0.05, 4.0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0 < int((got.numpy() != pre).sum()) < pre.size


@pytest.mark.parametrize("mode", ["sa0", "sa1", "freeze"])
def test_advance_wear_equals_the_reference(mode):
    """Six updates through ``advance_wear`` from the reference's masks
    (its wear limits carried across): the counters, the stuck map and
    the stuck values bit for bit, each step."""
    spec_kw = dict(sa0_rate=0.02, wearout=True, wearout_endurance=4e9,
                   wearout_spread=0.3, wearout_scale=1e9, wearout_mode=mode)
    shapes = {"w_h": (8, 20), "u_h": (20, 20), "b_h": (20,)}
    jp = {k: jnp.zeros(v) for k, v in shapes.items()}
    jst = jfaults.sample_fault_state(jp, jax.random.PRNGKey(2),
                                     jfaults.FaultSpec(**spec_kw),
                                     sa1_value=1.5)
    st = device_state_from_numpy(_np_tree(jst), "cpu")
    rng = np.random.default_rng(5)
    for _ in range(6):
        applied = {k: (rng.uniform(-0.1, 0.1, v)
                       * (rng.uniform(size=v) < 0.6)).astype(np.float32)
                   for k, v in shapes.items()}
        new_p = {k: rng.uniform(-1.5, 1.5, v).astype(np.float32)
                 for k, v in shapes.items()}
        jst = jfaults.advance_wear(
            jst, {k: jnp.asarray(v) for k, v in applied.items()},
            jfaults.FaultSpec(**spec_kw),
            {k: jnp.asarray(v) for k, v in new_p.items()}, sa1_value=1.5)
        st = faults.advance_wear(
            st, {k: torch.from_numpy(v) for k, v in applied.items()},
            faults.FaultSpec(**spec_kw),
            {k: torch.from_numpy(v) for k, v in new_p.items()},
            sa1_value=1.5)
        _tiles_equal(st, _np_tree(jst))
    assert 0 < faults.stuck_fraction(st) < 1


# ---------------------------------------------------------------------------
# The zero-fault contract and the entry points
# ---------------------------------------------------------------------------

def test_faults_none_builds_no_state_and_zero_rate_is_identity(params,
                                                               x_seq):
    assert _wbs().init_device_state(params, prng.PRNGKey(0)) is None
    zb = _wbs(faults.FaultSpec())
    zs = zb.init_device_state(params, prng.PRNGKey(0))
    assert set(zs) == {"_faults"}
    for fused in (None, False):
        a = _wbs().device_recurrence(params, CFG, x_seq, prng.PRNGKey(3),
                                     fused=fused)
        b = zb.device_recurrence(params, CFG, x_seq, prng.PRNGKey(3),
                                 state=zs, fused=fused)
        assert all(torch.equal(u, v) for u, v in zip(a, b))


def _small_stream(n_h=20):
    tasks = build_scenario("permuted", seed=0, n_tasks=2, n_train=64,
                           n_test=32)
    return scenario_miru_config(tasks, n_h=n_h), tasks


@pytest.mark.parametrize("name", ["ideal", "wbs", "analog_state"])
def test_zero_rate_run_compiled_parity(name):
    """End to end through ``run_compiled`` (forward, write, the device
    state carried): a zero-rate FaultSpec changes no bit."""
    cfg, tasks = _small_stream()
    tr = TrainerSpec(algo="dfa", epochs_per_task=1)
    kw = dict(replay=ReplaySpec(capacity=32), torch_device="cpu")
    r0 = run_compiled(cfg, tr, tasks, device=get_backend(name), **kw)
    r1 = run_compiled(cfg, tr, tasks, device=get_backend(
        name, spec_overrides=dict(faults=faults.FaultSpec())), **kw)
    np.testing.assert_array_equal(r0["R_full"], r1["R_full"])
    assert r0["losses"] == r1["losses"] and r0["metrics"] == r1["metrics"]
    for k, v in r0["params"].items():
        assert torch.equal(v, r1["params"][k]), k


@pytest.mark.parametrize("name", BACKENDS)
def test_faults_run_on_every_backend_and_entry_point(name):
    """Stuck cells, dead lines and wear-out on each backend: the loop
    and the compiled run agree bit for bit, the masks ride out in the
    device state (worn cells added), and the stuck cells never moved."""
    cfg, tasks = _small_stream()
    tr = TrainerSpec(algo="dfa", epochs_per_task=1)
    fs = faults.FaultSpec(sa0_rate=0.02, sa1_rate=0.02, dead_row_rate=0.02,
                          wearout=True, wearout_endurance=2e9,
                          wearout_scale=1e9)
    kw = dict(replay=ReplaySpec(capacity=32), torch_device="cpu")

    def be():
        return get_backend(name, spec_overrides=dict(faults=fs))
    loop = run_continual(cfg, tr, tasks, device=be(), **kw)
    comp = run_compiled(cfg, tr, tasks, device=be(), **kw)
    np.testing.assert_array_equal(loop["R"], comp["R"])
    assert loop["losses"] == comp["losses"]
    assert np.isfinite(comp["losses"]).all()
    st0 = _init_run(cfg, tr, be(), "cpu")[3]
    end = comp["device_state"]["_faults"]
    assert faults.stuck_fraction(end) > faults.stuck_fraction(
        st0["_faults"]), "wear-out must add stuck cells"
    for k in end:
        assert torch.equal(loop["device_state"]["_faults"][k]["stuck"],
                           end[k]["stuck"])


def test_faults_run_through_run_sweep():
    """``run_sweep`` takes backend instances: a faulty ``wbs`` and
    ``analog_state`` cell, metered, with lifetime columns."""
    fs = faults.FaultSpec(sa0_rate=0.01, sa1_rate=0.01)
    bes = [get_backend(n, spec_overrides=dict(faults=fs))
           for n in ("wbs", "analog_state")]
    grid = run_sweep(("permuted",), bes, TrainerSpec(algo="dfa"),
                     ReplaySpec(capacity=32), n_h=20,
                     scenario_kwargs=dict(n_tasks=2, n_train=64, n_test=32),
                     torch_device="cpu")
    assert len(grid["cells"]) == 2
    for cell in grid["cells"].values():
        assert cell["compiled"] and cell["power_mw"] > 0
        assert cell["lifetime_years"] > 0


# ---------------------------------------------------------------------------
# The masked forward, writes, upsets
# ---------------------------------------------------------------------------

def test_fused_equals_per_step_under_masks_and_the_reference(params, x_seq):
    """Both recurrence paths read the same masked tensors: bit for bit.
    The reference's forward from the same masks agrees tie-aware."""
    be = _wbs(faults.FaultSpec(**FAULTY))
    st = be.init_device_state(params, prng.PRNGKey(5))
    fused = be.device_recurrence(params, CFG, x_seq, prng.PRNGKey(3),
                                 state=st)
    step = be.device_recurrence(params, CFG, x_seq, prng.PRNGKey(3),
                                state=st, fused=False)
    assert all(torch.equal(a, b) for a, b in zip(fused, step))
    clean = _wbs().device_recurrence(params, CFG, x_seq, prng.PRNGKey(3))
    assert not torch.equal(clean[0], fused[0]), "masks must bite"
    jbe = _jwbs(FAULTY)
    jp = _jp(params)
    jst = jbe.init_device_state(jp, jax.random.PRNGKey(5))
    _tiles_equal(st["_faults"], _np_tree(jst["_faults"]))
    want = jbe.device_recurrence(jp, JCFG, jnp.asarray(x_seq.numpy()),
                                 jax.random.PRNGKey(3), state=jst)
    w_h = faults.apply_cell_faults(params["w_h"], st["_faults"]["w_h"])
    u_h = faults.apply_cell_faults(params["u_h"], st["_faults"]["u_h"])
    testing.compare_scan(
        fused, want, drive=kops.wbs_input_drive(x_seq, w_h, 8),
        u_scaled=u_h, b_h=params["b_h"], beta=CFG.beta, n_bits=8,
        adc_bits=8).check()


def test_stuck_cells_reject_writes(params):
    be = _wbs(faults.FaultSpec(**FAULTY))
    st = be.init_device_state(params, prng.PRNGKey(5))
    ups = {n: torch.full_like(p, 0.05) for n, p in params.items()}
    new_p, applied, _ = be.device_apply_update(params, ups, state=st)
    for name, tile in st["_faults"].items():
        stuck = faults.effective_masks(tile)[0]
        assert stuck.any()
        assert not applied[name][stuck].any(), name
        assert torch.equal(new_p[name][stuck], params[name][stuck]), name


def test_read_upsets_keyed_unfused_and_the_reference(params, x_seq,
                                                     monkeypatch):
    """Upsets draw on a 4-way split a step: reproducible per key,
    different across keys, never through the fused scan, and the
    reference's forward from the same key at fp32 tolerance."""
    be = _wbs(faults.FaultSpec(upset_rate=0.05))
    st = be.init_device_state(params, prng.PRNGKey(0))

    def no_scan(*a, **k):
        raise AssertionError("read upsets must take the per-step path")
    monkeypatch.setattr(kops, "wbs_miru_scan", no_scan)
    a = be.device_recurrence(params, CFG, x_seq, prng.PRNGKey(3), state=st)
    b = be.device_recurrence(params, CFG, x_seq, prng.PRNGKey(3), state=st)
    c = be.device_recurrence(params, CFG, x_seq, prng.PRNGKey(4), state=st)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a[0], c[0])
    monkeypatch.undo()
    clean = _wbs().device_recurrence(params, CFG, x_seq, prng.PRNGKey(3))
    assert not torch.equal(a[0], clean[0])
    jbe = _jwbs(dict(upset_rate=0.05))
    jp = _jp(params)
    want = jbe.device_recurrence(jp, JCFG, jnp.asarray(x_seq.numpy()),
                                 jax.random.PRNGKey(3),
                                 state=jbe.init_device_state(
                                     jp, jax.random.PRNGKey(0)))
    for g, w in zip(a, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)


def test_analog_state_reads_pairs_through_masks(params, x_seq):
    """The conductance-domain read-back is pinned at the stuck cells:
    hoisted (prepared) and per-call reads bit for bit, a zero-rate spec
    bit for bit the clean run, and the masks sampled after the pairs (the
    pairs are the clean state's)."""
    mk = lambda f: get_backend(  # noqa: E731
        "analog_state", spec=DeviceSpec(**WBS, faults=f))
    clean, faulty, zero = (mk(None), mk(faults.FaultSpec(**FAULTY)),
                           mk(faults.FaultSpec()))
    s0, sf, sz = (b.init_device_state(params, prng.PRNGKey(4))
                  for b in (clean, faulty, zero))
    assert "_faults" in sf and "_faults" not in s0
    assert all(torch.equal(s0[k][g], sf[k][g]) for k in s0 for g in s0[k])

    def run(be, st):
        return be.device_recurrence(params, CFG, x_seq, prng.PRNGKey(3),
                                    state=st)[0]
    assert torch.equal(run(clean, s0), run(zero, sz))
    assert not torch.equal(run(clean, s0), run(faulty, sf))
    prep = faulty.prepare_weights(params, state=sf)
    drive = x_seq[:, 0]
    assert torch.equal(
        faulty.device_vmm(drive, params["w_h"], state=sf, tag="w_h",
                          prepared=prep),
        faulty.device_vmm(drive, params["w_h"], state=sf, tag="w_h"))
    jbe = _jwbs(FAULTY, "analog_state")
    jst = jbe.init_device_state(_jp(params), jax.random.PRNGKey(4))
    _tiles_equal(sf["_faults"], _np_tree(jst["_faults"]))


# ---------------------------------------------------------------------------
# Mitigation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["wbs", "analog_state"])
def test_march_recovers_the_reference_map(params, name):
    """The self-test's map equals the true effective stuck map and the
    reference's march, exactly; the recovered values within one ADC-free
    quantization step of the stuck values."""
    kw = dict(FAULTY, n_spare_cols=3)
    be = _wbs(faults.FaultSpec(**kw), name)
    st = be.init_device_state(params, prng.PRNGKey(7))
    rec = faults.march_recover(be, params, st)
    jbe = _jwbs(kw, name)
    jp = _jp(params)
    jrec = jfaults.march_recover(jbe, jp,
                                 jbe.init_device_state(jp,
                                                       jax.random.PRNGKey(7)))
    for n, tile in st["_faults"].items():
        stuck, value = faults.effective_masks(tile)
        assert torch.equal(rec[n]["stuck"], stuck), n
        np.testing.assert_array_equal(rec[n]["stuck"].numpy(),
                                      np.asarray(jrec[n]["stuck"]))
        np.testing.assert_allclose(rec[n]["value"].numpy(),
                                   np.asarray(jrec[n]["value"]), atol=1e-6)
        np.testing.assert_allclose(rec[n]["value"][stuck].numpy(),
                                   value[stuck].numpy(), atol=2 / 255)
    assert not any(r["stuck"].any() for r in
                   faults.march_recover(_wbs(), params, None).values())


@settings(max_examples=10, deadline=None)
@given(st.integers(2, 20), st.integers(2, 20), st.integers(1, 5),
       st.integers(0, 10_000), st.floats(0.0, 0.25))
def test_remap_columns_equals_the_reference_and_is_injective(
        n_in, n_out, n_sp, seed, rate):
    kw = dict(sa0_rate=rate, sa1_rate=0.05, dead_col_rate=0.1,
              n_spare_cols=n_sp)
    shapes = {"w": (n_in, n_out), "u": (n_out, n_out)}
    fs = faults.sample_fault_state({k: torch.zeros(v)
                                    for k, v in shapes.items()},
                                   prng.PRNGKey(seed), faults.FaultSpec(**kw))
    got = faults.remap_columns(fs)
    # The masks are the reference's bit for bit (test_masks_equal_the_
    # reference); its remap runs on the host, on the same masks.
    want = jfaults.remap_columns({n: {k: v.numpy() for k, v in t.items()}
                                  for n, t in fs.items()})
    for name in fs:
        cm = got[name]["colmap"].numpy()
        np.testing.assert_array_equal(cm, np.asarray(want[name]["colmap"]))
        assert len(np.unique(cm)) == len(cm)
        before = int(faults.effective_masks(fs[name])[0].sum())
        after = int(faults.effective_masks(got[name])[0].sum())
        assert after <= before


def test_compensate_bias_and_calibration_drives_match_the_reference(
        params, x_seq):
    kw = dict(FAULTY)
    be = _wbs(faults.FaultSpec(**kw))
    st = be.init_device_state(params, prng.PRNGKey(9))
    drives = faults.calibration_drives(be, params, CFG, x_seq,
                                       prng.PRNGKey(11), state=st)
    jbe = _jwbs(kw)
    jp = _jp(params)
    jst = jbe.init_device_state(jp, jax.random.PRNGKey(9))
    jdrives = jfaults.calibration_drives(jbe, jp, JCFG,
                                         jnp.asarray(x_seq.numpy()),
                                         jax.random.PRNGKey(11), state=jst)
    for k in drives:
        np.testing.assert_allclose(drives[k].numpy(),
                                   np.asarray(jdrives[k]), rtol=1e-5,
                                   atol=1e-6)
    got = faults.compensate_bias(params, st["_faults"], drives)
    want = jfaults.compensate_bias(jp, jst["_faults"], jdrives)
    for k in params:
        if k == "b_h":
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-6)
            assert not torch.equal(got[k], params[k])
        else:
            assert got[k] is params[k]


def test_recalibrate_matches_the_reference():
    """Four recalibration steps on the reference's batches (drawn by
    ``prng.choice``): on ``ideal`` the params within fp32 tolerance of the
    reference's, the stuck cells untouched."""
    cfg, tasks = _small_stream()
    tr = TrainerSpec(algo="dfa", epochs_per_task=1)
    p0 = init_miru_params(prng.PRNGKey(1), cfg, "cpu")
    fs = faults.FaultSpec(**FAULTY)
    be = get_backend("ideal", spec=DeviceSpec(faults=fs))
    st = be.init_device_state(p0, prng.PRNGKey(3))
    p1, st1 = faults.recalibrate(cfg, tr, be, p0, st, tasks[0], steps=4)
    jtasks = jbuild_scenario("permuted", seed=0, n_tasks=2, n_train=64,
                             n_test=32)
    jcfg = jscenario_miru_config(jtasks, n_h=20)
    jbe = jget_backend("ideal", spec=JDeviceSpec(
        faults=jfaults.FaultSpec(**FAULTY)))
    jp0 = _jp(p0)
    jst = jbe.init_device_state(jp0, jax.random.PRNGKey(3))
    jtr = JTrainerSpec(algo="dfa", epochs_per_task=1)
    jp1, _ = jfaults.recalibrate(jcfg, jtr, jbe, jp0, jst, jtasks[0],
                                 steps=4)
    for k in p1:
        np.testing.assert_allclose(p1[k].numpy(), np.asarray(jp1[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert not torch.equal(p1["w_h"], p0["w_h"])
    for name, tile in st1["_faults"].items():
        stuck = faults.effective_masks(tile)[0]
        assert torch.equal(p1[name][stuck], p0[name][stuck]), name


# ---------------------------------------------------------------------------
# permutation / choice
# ---------------------------------------------------------------------------

def _tie_key(n: int) -> int:
    """A seed whose first sort round at ``n`` has two equal 32-bit keys
    (so the stable sort's tie rule decides the order)."""
    for s in range(64):
        sub = prng.split(prng.PRNGKey(s))[1]
        keys = prng.bits(sub, (n,))
        if np.unique(keys).size < n:
            return s
    raise AssertionError("no tie found")


@pytest.mark.parametrize("n", [64, 600, 60_000])
def test_permutation_and_choice_equal_jax(n):
    seeds = [0, 7] + ([_tie_key(n)] if n == 60_000 else [])
    for s in seeds:
        np.testing.assert_array_equal(
            prng.permutation(prng.PRNGKey(s), n),
            np.asarray(jax.random.permutation(jax.random.PRNGKey(s), n)))
        np.testing.assert_array_equal(
            prng.choice(prng.PRNGKey(s), n, (min(n, 32),)),
            np.asarray(jax.random.choice(jax.random.PRNGKey(s), n,
                                         (min(n, 32),), replace=False)))


def test_convert_carries_fault_and_het_state():
    """The reference's ``"_faults"`` and ``"_het"`` trees arrive with the
    same bits and dtypes (bool masks, int32 column maps, float32
    scalars)."""
    jbe = _jwbs(dict(FAULTY, n_spare_cols=2, wearout=True), "analog_state")
    jp = {k: jnp.zeros(v) for k, v in PAPER.items()}
    jst = jbe.init_device_state(jp, jax.random.PRNGKey(1),
                                het={"read_sigma": jnp.float32(0.02)})
    st = device_state_from_numpy(_np_tree(jst), "cpu")
    _tiles_equal(st["_faults"], _np_tree(jst["_faults"]))
    assert st["_het"]["read_sigma"].dtype == torch.float32
    assert st["_het"]["read_sigma"].item() == np.float32(0.02)
