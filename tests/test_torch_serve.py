"""The torch port's recurrent serving path: state slab, traffic generator
and continuous-batching engine.

Against the JAX reference: the traffic arrays are bitwise equal, and the
same trace on the same weights serves the same logits (tie-aware), the
same frame counts and the same slab spill/reload counts. Inside the port
(on the CPU, the kernels' plain versions): the determinism contract —
batch composition, slot permutation, chunking, pipelining and fused vs
per-step change no served bit — plus the scheduling, deadline and
chip-failure semantics of the reference engine.
"""
import numpy as np
import pytest
import torch

# The JAX reference; a GPU machine without JAX still collects the
# CUDA-marked tests (tests/test_torch_cuda.py).
jax = pytest.importorskip("jax")

from _hypothesis_compat import given, settings, st  # noqa: E402
from repro.core.miru import MiRUConfig as JMiRUConfig  # noqa: E402
from repro.core.miru import init_miru_params as jinit  # noqa: E402
from repro.serve import loadgen as jloadgen  # noqa: E402
from repro.serve import RecurrentServeConfig as JServeConfig  # noqa: E402
from repro.serve import RecurrentServeEngine as JServeEngine  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.backends import get_backend  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.miru import MiRUConfig, miru_apply_readout  # noqa: E402
from repro_torch.serve import (RecurrentServeConfig, RecurrentServeEngine,
                               SlabFullError, StateSlab, TrafficSpec,
                               make_arrivals, replay, request_frames,
                               serve_backend)

CFG = MiRUConfig(n_x=6, n_h=12, n_y=4)
N_H = 12


@pytest.fixture(scope="module")
def jparams():
    return jinit(jax.random.PRNGKey(0), JMiRUConfig(n_x=6, n_h=12, n_y=4))


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                             "cpu")


def _engine(params, **kw):
    kw.setdefault("device", "wbs")
    kw.setdefault("fresh_meter", True)
    return RecurrentServeEngine(CFG, RecurrentServeConfig(**kw), params,
                                torch_device="cpu")


def _serve(params, spec, **kw):
    eng = _engine(params, **kw)
    reqs = [eng.submit(f, uid=a.uid) for a, f in replay(spec)]
    eng.run_until_drained()
    return eng, reqs


def _solo_golden(params, spec):
    """Each user's bursts, in order, alone in a one-slot engine."""
    out, engines = {}, {}
    for a, frames in replay(spec):
        eng = engines.setdefault(a.uid, _engine(
            params, batch_slots=1, chunk=int(spec.frames_max)))
        req = eng.submit(frames, uid=a.uid)
        eng.run_until_drained()
        out[a.rid] = req.logits.copy()
    return out


# ---------------------------------------------------------------------------
# Traffic and the JAX reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate_hz", [None, 50.0])
def test_loadgen_bitwise_equal_to_reference(rate_hz):
    kw = dict(n_requests=20, rate_hz=rate_hz, n_users=7, frames_min=2,
              frames_max=9, n_x=5, seed=3)
    mine, ref = TrafficSpec(**kw), jloadgen.TrafficSpec(**kw)
    assert [vars(a) for a in make_arrivals(mine)] == \
        [vars(a) for a in jloadgen.make_arrivals(ref)]
    for (a, f), (ja, jf) in zip(replay(mine), jloadgen.replay(ref)):
        assert f.dtype == jf.dtype and np.array_equal(f, jf)
    assert np.array_equal(request_frames(mine, 4), jloadgen.request_frames(
        ref, 4))


@pytest.mark.parametrize("fused", [None, False])
def test_serves_like_the_reference(params, jparams, fused):
    spec = TrafficSpec(n_requests=12, n_users=5, frames_min=3, frames_max=10,
                       n_x=6, seed=7)
    eng, reqs = _serve(params, spec, batch_slots=3, chunk=4, fused=fused)
    jeng = JServeEngine(JMiRUConfig(n_x=6, n_h=12, n_y=4),
                        JServeConfig(batch_slots=3, chunk=4, device="wbs",
                                     fresh_meter=True, fused=fused), jparams)
    jreqs = [jeng.submit(f, uid=a.uid) for a, f in
             jloadgen.replay(jloadgen.TrafficSpec(**vars(spec)))]
    jeng.run_until_drained()
    assert [r.emitted for r in reqs] == [r.emitted for r in jreqs]
    assert eng.slab.stats() == jeng.slab.stats()
    assert eng.slab.evictions > 0
    uids = sorted({a.uid for a in make_arrivals(spec)})

    def streams(rs):
        return [np.concatenate([r.logits for r in rs if r.uid == u])
                for u in uids]
    testing.compare_streams(
        streams(reqs), streams(jreqs),
        flip_bound=testing.one_level_logit_bound(params["w_o"], CFG.lam, 8)
    ).check()
    st, jst = eng.request_stats(), jeng.request_stats()
    assert set(st) == set(jst) - {"energy"}
    for k in ("requests", "rejected", "timed_out", "steps_run",
              "frames_served", "slab"):
        assert st[k] == jst[k]


@pytest.mark.parametrize("device", ["analog", "cmos"])
def test_metered_energy_equals_the_reference_figures(params, jparams,
                                                     device):
    """``request_stats()["energy"]`` on a metered substrate: the same
    counters as the reference engine serving the same trace, and from
    them the reference's figures (MeteredEnergy over an M2RUCostModel of
    the engine's geometry; pJ per request by frame share), exactly."""
    from repro.analog.costmodel import M2RUCostModel as JModel
    from repro.obs import Histogram as JHistogram
    from repro.telemetry.energy import MeteredEnergy as JEnergy
    spec = TrafficSpec(n_requests=5, n_users=3, frames_min=3, frames_max=8,
                       n_x=6, seed=1)
    eng, reqs = _serve(params, spec, device=device, meter=True,
                       batch_slots=2, chunk=4)
    jeng = JServeEngine(JMiRUConfig(n_x=6, n_h=12, n_y=4),
                        JServeConfig(batch_slots=2, chunk=4, device=device,
                                     fresh_meter=True, meter=True), jparams)
    jreqs = [jeng.submit(f, uid=a.uid) for a, f in
             jloadgen.replay(jloadgen.TrafficSpec(**vars(spec)))]
    jeng.run_until_drained()
    # The same served streams: on ``analog`` the plane gains come from the
    # reference's per-dispatch key chain (normal within 3 ulp).
    uids = sorted({a.uid for a in make_arrivals(spec)})

    def streams(rs):
        return [np.concatenate([r.logits for r in rs if r.uid == u])
                for u in uids]
    testing.compare_streams(
        streams(reqs), streams(jreqs),
        flip_bound=testing.one_level_logit_bound(params["w_o"], CFG.lam, 8)
    ).check()
    snap = eng.telemetry.snapshot()
    assert snap == jeng.telemetry.snapshot()
    en = eng.request_stats()["energy"]
    kind = "cmos" if device == "cmos" else "analog"
    rep = JEnergy(JModel(n_x=6, n_h=12, n_y=4)).report(snap, kind=kind)
    pj = JHistogram()
    total = sum(r.emitted for r in reqs)
    for r in reqs:
        pj.add(rep.energy_j * r.emitted / total * 1e12)
    assert en == {"total_j": rep.energy_j, "power_mw": rep.power_w * 1e3,
                  "gops_per_w": rep.gops_per_w, "pj_per_op": rep.pj_per_op,
                  "pj_per_request": pj.summary()}
    assert en["pj_per_request"]["count"] == 5 and en["total_j"] > 0


# ---------------------------------------------------------------------------
# The determinism contract, inside the port
# ---------------------------------------------------------------------------

def test_output_stream_invariant_to_batch_composition(params):
    spec = TrafficSpec(n_requests=12, n_users=5, frames_min=3, frames_max=10,
                       n_x=6, seed=7)
    golden = _solo_golden(params, spec)
    eng, reqs = _serve(params, spec, batch_slots=3, chunk=4)
    assert eng.slab.evictions > 0, "scenario must exercise spill/reload"
    for a, req in zip(make_arrivals(spec), reqs):
        assert np.array_equal(req.logits, golden[a.rid]), a.rid


def test_output_stream_invariant_to_slot_permutation(params):
    spec = TrafficSpec(n_requests=6, frames_min=4, frames_max=8, n_x=6,
                       seed=3)
    traffic = list(replay(spec))
    streams = {}
    for perm_seed in (0, 1):
        order = np.random.default_rng(perm_seed).permutation(len(traffic))
        eng = _engine(params, batch_slots=4, chunk=3)
        reqs = {}
        for i in order:
            a, frames = traffic[i]
            reqs[a.rid] = eng.submit(frames, uid=f"r{a.rid}")
        eng.run_until_drained()
        streams[perm_seed] = {rid: r.logits for rid, r in reqs.items()}
    for rid in streams[0]:
        assert np.array_equal(streams[0][rid], streams[1][rid]), rid


@pytest.mark.parametrize("chunk", [1, 4, 9])
def test_output_stream_invariant_to_chunking(params, chunk):
    frames = request_frames(TrafficSpec(n_x=6, seed=11), rid=0, n_frames=9)
    outs = []
    for c in (9, chunk):
        eng = _engine(params, batch_slots=2, chunk=c)
        req = eng.submit(frames, uid="u")
        eng.run_until_drained()
        outs.append(req.logits)
    assert np.array_equal(outs[0], outs[1])


@pytest.mark.parametrize("option", [{"pipeline": False}, {"fused": False}])
def test_scheduling_and_path_options_change_no_bit(params, option):
    spec = TrafficSpec(n_requests=6, n_users=3, frames_min=3, frames_max=7,
                       n_x=6, seed=2)
    _, base = _serve(params, spec, batch_slots=2, chunk=4)
    _, other = _serve(params, spec, batch_slots=2, chunk=4, **option)
    for a, b in zip(base, other):
        assert np.array_equal(a.logits, b.logits)


def test_matches_direct_device_recurrence(params):
    bk = get_backend("wbs")
    spec = TrafficSpec(n_x=6, seed=5)
    f1, f2 = request_frames(spec, 0, 6), request_frames(spec, 1, 4)
    eng = _engine(params, batch_slots=2, chunk=3)
    r1 = eng.submit(f1, uid="u")
    r2 = eng.submit(f2, uid="u")             # same user: state carries
    eng.run_until_drained()
    h_all, _, _ = bk.device_recurrence(params, CFG, torch.from_numpy(f1)[None])
    assert np.array_equal(r1.logits,
                          miru_apply_readout(params, CFG, h_all[0]).numpy())
    h_all2, _, _ = bk.device_recurrence(params, CFG, torch.from_numpy(f2)[None],
                                        h0=h_all[:, -1])
    assert np.array_equal(r2.logits,
                          miru_apply_readout(params, CFG, h_all2[0]).numpy())


# ---------------------------------------------------------------------------
# Scheduling semantics
# ---------------------------------------------------------------------------

def test_same_user_bursts_serialize_in_order(params):
    eng = _engine(params, batch_slots=4, chunk=2)
    spec = TrafficSpec(n_x=6, seed=0)
    a1 = eng.submit(request_frames(spec, 0, 6), uid="u")
    a2 = eng.submit(request_frames(spec, 1, 4), uid="u")
    b = eng.submit(request_frames(spec, 2, 2), uid="v")
    eng.step()
    assert a1.cursor > 0 and a2.cursor == 0 and b.cursor > 0
    eng.run_until_drained()
    assert a2.done and a1.t_done <= a2.t_admit
    assert (a1.predictions == np.argmax(a1.logits, -1)).all()
    eng.end_session("u")
    assert not eng.slab.is_resident("u") and "u" not in eng.slab.spilled
    eng.submit(request_frames(spec, 3, 2), uid="v")
    eng.step()
    with pytest.raises(ValueError, match="active"):
        eng.end_session("v")


def test_admission_control_rejects_when_queue_full(params):
    eng = _engine(params, batch_slots=1, chunk=2, max_queue=2)
    spec = TrafficSpec(n_x=6, seed=0)
    reqs = [eng.submit(request_frames(spec, i, 3), uid=f"u{i}")
            for i in range(5)]
    assert [r.rejected for r in reqs] == [False, False, True, True, True]
    eng.run_until_drained()
    assert sum(r.done for r in reqs) == 2
    assert eng.request_stats()["rejected"] == 3
    with pytest.raises(ValueError):
        eng.submit(np.zeros((3, 5), np.float32))


class ScriptedClock:
    def __init__(self, vals=None, t0=0.0, dt=1.0):
        self.vals, self.t, self.dt, self.reads = vals, t0 - dt, dt, 0

    def __call__(self):
        self.reads += 1
        if self.vals is not None:
            return self.vals[min(self.reads - 1, len(self.vals) - 1)]
        self.t += self.dt
        return self.t


def test_scripted_clock_latency_split(params):
    eng = _engine(params, batch_slots=1, chunk=8, pipeline=False,
                  clock=ScriptedClock())
    spec = TrafficSpec(n_x=6, seed=0)
    reqs = [eng.submit(request_frames(spec, i, 3), uid=f"u{i}")
            for i in range(3)]
    eng.run_until_drained()
    assert [r.t_admit for r in reqs] == [3.0, 5.0, 7.0]
    assert [r.t_done for r in reqs] == [4.0, 6.0, 8.0]
    stats = eng.request_stats()
    assert stats["queue_wait_ms"]["p50"] == 4000.0
    assert stats["decode_ms"]["p99"] == 1000.0
    assert stats["latency_ms"]["p99"] == pytest.approx(5980.0)
    assert stats["sequences_per_s"] == pytest.approx(3 / 8)
    assert "energy" not in stats


def test_deadline_times_out_stale_requests(params):
    clock = ScriptedClock([0.0, 1.0, 2.0, 3.0, 3.0] + [10.0] * 60)
    eng = _engine(params, batch_slots=2, chunk=4, deadline_s=5.0,
                  clock=clock)
    spec = TrafficSpec(n_x=6, seed=0)
    reqs = [eng.submit(request_frames(spec, i, 5), uid="u")
            for i in range(3)]
    eng.run_until_drained()
    assert eng.request_stats()["timed_out"] == 2
    assert reqs[0].done and not reqs[0].timed_out
    assert reqs[1].timed_out and reqs[1].t_done == 10.0
    assert eng.pending == 0
    clock = ScriptedClock(list(range(100)))
    eng = _engine(params, batch_slots=2, chunk=4, clock=clock)
    eng.submit(request_frames(spec, 0, 4), uid="a")
    eng.run_until_drained()
    assert clock.reads == 3                  # submit, admit, done only


@pytest.mark.parametrize("fail_at,batch_slots", [((1, 4), 2), ((3,), 2)])
def test_chip_failure_outputs_bitwise_identical(params, fail_at, batch_slots):
    spec = TrafficSpec(n_requests=10, n_users=6, frames_min=3, frames_max=9,
                       n_x=6, seed=2)
    e0, r0 = _serve(params, spec, batch_slots=batch_slots, chunk=3)
    e1, r1 = _serve(params, spec, batch_slots=batch_slots, chunk=3,
                    fail_at_steps=fail_at)
    assert e0.slab.evictions > 0
    for a, b in zip(r0, r1):
        assert np.array_equal(a.logits, b.logits)
    s1 = e1.request_stats()
    assert s1["chip_failures"] == len(fail_at) and s1["retried"] >= 1
    assert s1["slab"]["reloads"] > e0.slab.reloads
    e1.slab.check()


def test_telemetry_shared_per_name_and_fresh_meter(params):
    spec = TrafficSpec(n_x=6, seed=0)
    bk = serve_backend("wbs")
    try:
        e1 = _engine(params, fresh_meter=False, meter=True, batch_slots=1)
        e2 = _engine(params, fresh_meter=False, meter=True, batch_slots=1)
        assert e1.backend is e2.backend is bk
    finally:
        bk.telemetry.reset()
        bk.telemetry.disable()
    e3 = _engine(params, meter=True, batch_slots=2, chunk=4)
    assert e3.backend is not bk
    e3.submit(request_frames(spec, 0, 6), uid="a")
    e3.run_until_drained()
    snap = e3.telemetry.snapshot()
    assert snap["sequences"] == 1
    assert snap["vmm_rows/w_h"] == 2 * 8     # 2 slots × 2 steps × chunk 4
    assert snap["sample_steps"] == 2 * 8
    assert bk.telemetry.total("macs") == 0


def test_engine_refuses_cuda_without_card(params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cpu"):
        RecurrentServeEngine(CFG, RecurrentServeConfig(), params)


def test_slab_defaults_to_cuda_and_refuses_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cpu"):
        StateSlab(2, N_H)
    assert StateSlab(2, N_H, device="cpu").h.device.type == "cpu"


# ---------------------------------------------------------------------------
# The slab
# ---------------------------------------------------------------------------

def _fill(slab, uid, seed):
    row = np.random.default_rng(seed).normal(size=N_H).astype(np.float32)
    slab.h[slab.slot(uid)] = torch.from_numpy(row)
    return row


def test_evict_reload_bit_identity_and_zero_state():
    slab = StateSlab(2, N_H, device="cpu")
    slab.acquire("a")
    row = _fill(slab, "a", 0)
    slab.evict("a")
    assert slab.spilled == ("a",) and slab.n_free == 2
    slab.acquire("b")
    _fill(slab, "b", 1)
    slab.release("b")
    assert slab.acquire("c") == 0 and not slab.read("c").any()
    slab.acquire("a")
    assert np.array_equal(slab.read("a"), row) and slab.reloads == 1
    slab.pin("a")
    slab.pin("c")
    with pytest.raises(SlabFullError):
        slab.acquire("d")
    with pytest.raises(ValueError):
        slab.evict("a")
    with pytest.raises(KeyError):
        slab.pin("zz")
    slab.check()


_OPS = ("acquire", "release", "evict", "pin", "unpin", "touch")


@settings(max_examples=12)
@given(st.integers(1, 5), st.integers(0, 10_000))
def test_slab_invariants_under_random_ops(n_slots, seed):
    rng = np.random.default_rng(seed)
    slab = StateSlab(n_slots, N_H, device="cpu")
    uids = [f"u{i}" for i in range(2 * n_slots + 2)]
    shadow = {}
    for step in range(40):
        op = _OPS[int(rng.integers(len(_OPS)))]
        uid = uids[int(rng.integers(len(uids)))]
        if op == "acquire":
            if slab.can_acquire(uid):
                tracked = slab.is_resident(uid) or uid in slab.spilled
                slab.acquire(uid)
                if not tracked:
                    shadow[uid] = _fill(slab, uid, seed=step)
            else:
                with pytest.raises(SlabFullError):
                    slab.acquire(uid)
        elif op == "release":
            slab.release(uid)
            shadow.pop(uid, None)
        elif op == "evict":
            if slab.is_resident(uid) and uid not in slab._pinned:
                slab.evict(uid)
        elif op == "pin":
            if slab.is_resident(uid):
                slab.pin(uid)
        elif op == "unpin":
            slab.unpin(uid)
        elif slab.is_resident(uid):
            slab.touch(uid)
        slab.check()
        assert slab.n_free + len(slab.resident) == n_slots
    for u, row in shadow.items():
        if slab.is_resident(u) or u in slab.spilled:
            assert np.array_equal(slab.read(u), row), u


# ---------------------------------------------------------------------------
# The row-exact readout (the one-slot vs 64-slot fault on the card)
# ---------------------------------------------------------------------------

def test_readout_plain_version_is_row_exact_across_m(params):
    """Each row's logits depend on that row alone: the same 14 rows give
    the same bits alone, in a 64-row batch and in an 896-row batch (the
    serve shapes), where a library GEMM on the card picks another
    kernel."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(3)
    big = torch.from_numpy(rng.uniform(-1, 1, (896, N_H)).astype(np.float32))
    rows = big[100:114]
    want = ref.miru_readout_ref(rows, params["w_o"], params["b_o"])
    for m in (1, 14, 64, 896):
        batch = big[100:100 + m] if m >= 14 else rows[:m]
        got = ref.miru_readout_ref(batch, params["w_o"], params["b_o"])
        assert torch.equal(got[:min(m, 14)], want[:min(m, 14)])


def test_miru_apply_readout_dispatches_to_the_readout(params, monkeypatch):
    from repro_torch.kernels import ops, ref
    calls = []
    real = ops.miru_readout

    def spy(h, w_o, b_o):
        calls.append(tuple(h.shape))
        return real(h, w_o, b_o)
    monkeypatch.setattr(ops, "miru_readout", spy)
    h = torch.from_numpy(np.random.default_rng(4).uniform(
        -1, 1, (5, N_H)).astype(np.float32))
    got = miru_apply_readout(params, CFG, h)
    assert calls == [(5, N_H)]
    assert torch.equal(got, ref.miru_readout_ref(h, params["w_o"],
                                                 params["b_o"]))
