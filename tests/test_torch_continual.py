"""The port's continual-learning slice against the reference: the batch
schedule (bitwise), the run's initial state, the write path, and the
Fig. 4 protocol end to end on ``ideal`` and ``wbs``.

The protocol runs start both trainers from the same state — the
reference's initial params, Ψ and key, carried across as numpy
(``convert.run_state_from_numpy``) — and hold the port's R matrix to the
reference's within 2 test examples per entry and MA within 0.01: DFA's
ζ write keeps the top 57 % of each gradient by magnitude, so an ulp of
difference in one gradient entry can swap which synapse is written, and
the two runs drift apart by that much over a few hundred steps.
"""
import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.backends import get_backend as jget_backend  # noqa: E402
from repro.core.miru import MiRUConfig as JMiRUConfig  # noqa: E402
from repro.data.synthetic import make_permuted_tasks as jtasks  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.backends import get_backend  # noqa: E402
from repro_torch.convert import (params_from_numpy,  # noqa: E402
                                 run_state_from_numpy)
from repro_torch.core import continual  # noqa: E402
from repro_torch.core.miru import MiRUConfig  # noqa: E402
from repro_torch.data.synthetic import make_permuted_tasks  # noqa: E402
from repro_torch.telemetry import meters  # noqa: E402

# repro.core re-exports names over some of its module names.
jcontinual = importlib.import_module("repro.core.continual")

ROOT = Path(__file__).resolve().parents[1]
SIDE, N_H, N_TEST = 8, 32, 50
TRAINER = dict(epochs_per_task=6, batch_size=16)


def _tasks(n_tasks=2, n_train=256):
    kw = dict(n_tasks=n_tasks, n_train=n_train, n_test=N_TEST, side=SIDE)
    return make_permuted_tasks(0, **kw), jtasks(0, **kw)


def _cfgs():
    return (MiRUConfig(n_x=SIDE, n_h=N_H, n_y=10),
            JMiRUConfig(n_x=SIDE, n_h=N_H, n_y=10))


@pytest.mark.parametrize("policy", ["reservoir", "ring", "class_balanced",
                                    "task_stratified"])
@pytest.mark.parametrize("ratio", [0.5, 0.25, 0.0])
def test_batch_schedule_bitwise(policy, ratio):
    tasks, jt = _tasks(3, 48)
    kw = dict(epochs_per_task=2, batch_size=16, seed=3)
    rkw = dict(capacity=24, ratio=ratio, policy=policy)
    got = continual.build_batch_schedule(
        continual.TrainerSpec(**kw), continual.ReplaySpec(**rkw), tasks)
    want = jcontinual.build_batch_schedule(
        jcontinual.TrainerSpec(**kw), jcontinual.ReplaySpec(**rkw), jt)
    assert got.steps_per_task == want.steps_per_task
    for a, b in zip(got.x + got.y + got.occupancy,
                    want.x + want.y + want.occupancy):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got.replay_traffic == want.replay_traffic


def test_init_run_follows_the_reference_chain():
    cfg, jcfg = _cfgs()
    trainer = continual.TrainerSpec(seed=7)
    key, params, psi, state = continual._init_run(
        cfg, trainer, get_backend("ideal"), "cpu")
    jkey, jparams, jpsi, jstate = jcontinual._init_run(
        jcfg, jcontinual.TrainerSpec(seed=7), jget_backend("ideal"))
    np.testing.assert_array_equal(key, np.asarray(jkey))
    for k in jparams:
        np.testing.assert_array_equal(params[k].numpy(),
                                      np.asarray(jparams[k]))
    ulp = np.abs(psi.numpy().view(np.int32).astype(np.int64)
                 - np.asarray(jpsi).view(np.int32).astype(np.int64))
    assert ulp.max() <= 3
    assert state is None and jstate is None


@pytest.mark.parametrize("name,clip", [("ideal", None), ("wbs", 1.5)])
def test_apply_update_matches_reference(name, clip):
    rng = np.random.default_rng(1)
    p = {"w": rng.uniform(-1.6, 1.6, (6, 5)).astype(np.float32),
         "b": rng.normal(size=5).astype(np.float32)}
    u = {k: (rng.normal(size=v.shape) * 0.3
             * (rng.uniform(size=v.shape) < 0.5)).astype(np.float32)
         for k, v in p.items()}
    new, applied, state = get_backend(name).device_apply_update(
        params_from_numpy(p, "cpu"), params_from_numpy(u, "cpu"))
    jnew, japplied, _ = jget_backend(name).device_apply_update(
        {k: jnp.asarray(v) for k, v in p.items()},
        {k: jnp.asarray(v) for k, v in u.items()})
    assert state is None
    for k in p:
        np.testing.assert_array_equal(new[k].numpy(), np.asarray(jnew[k]))
        np.testing.assert_array_equal(applied[k].numpy(),
                                      np.asarray(japplied[k]))
    if clip is not None:
        assert float(new["w"].abs().max()) <= clip


def test_record_endurance_meters_write_pulses():
    backend = get_backend("wbs")
    applied = {"w_h": torch.tensor([[0.0, 1.0], [2.0, 0.0]]),
               "b_h": torch.ones(2)}
    backend.record_endurance(applied)          # telemetry off: nothing
    assert backend.telemetry.snapshot() == {}
    backend.telemetry.enable()
    backend.record_endurance(applied)
    assert backend.telemetry.snapshot() == {
        f"{meters.WRITE_PULSES}/w_h": 2, meters.WRITE_EVENTS: 1}


def test_forward_device_matches_reference_on_ideal():
    cfg, jcfg = _cfgs()
    jkey, jp, _, _ = jcontinual._init_run(jcfg, jcontinual.TrainerSpec(),
                                          jget_backend("ideal"))
    p = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    x = np.random.default_rng(2).uniform(0, 1, (6, SIDE, SIDE)).astype(
        np.float32)
    got, inter = continual.miru_forward_device(
        p, cfg, torch.from_numpy(x), prng.PRNGKey(0), get_backend("ideal"))
    want, jinter = jcontinual.miru_forward_device(
        jp, jcfg, jnp.asarray(x), jax.random.PRNGKey(0),
        jget_backend("ideal"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=1e-6)
    for k in inter:
        np.testing.assert_allclose(inter[k].numpy(), np.asarray(jinter[k]),
                                   rtol=2e-5, atol=1e-6)


def _run_both(device, spec_overrides=None, n_tasks=2):
    cfg, jcfg = _cfgs()
    tasks, jt = _tasks(n_tasks)
    trainer = continual.TrainerSpec(**TRAINER)
    jtrainer = jcontinual.TrainerSpec(**TRAINER)
    rspec = dict(capacity=64)
    jbackend = jget_backend(device, spec_overrides=spec_overrides)
    backend = get_backend(device, spec_overrides=spec_overrides)
    key, p, psi, _ = jcontinual._init_run(jcfg, jtrainer, jbackend)
    want = jcontinual.run_continual(jcfg, jtrainer, jt,
                                    replay=jcontinual.ReplaySpec(**rspec),
                                    device=jbackend)
    got = continual.run_continual(
        cfg, trainer, tasks, replay=continual.ReplaySpec(**rspec),
        device=backend, torch_device="cpu",
        init=run_state_from_numpy(np.asarray(key),
                                  {k: np.asarray(v) for k, v in p.items()},
                                  np.asarray(psi), "cpu"))
    return got, want


@pytest.mark.parametrize("device,overrides", [
    ("ideal", None), ("wbs", None), ("wbs", {"gain_sigma": 0.02})])
def test_run_continual_r_matrix_within_two_examples(device, overrides):
    got, want = _run_both(device, overrides)
    R, jR = got["R"], np.asarray(want["R"])
    assert R.shape == jR.shape == (2, 2)
    np.testing.assert_array_equal(np.triu(R, 1), 0)
    assert np.abs(R - jR).max() <= 2 / N_TEST + 1e-9, (R, jR)
    assert abs(got["MA"] - want["MA"]) <= 0.01 + 1e-9
    assert R[0, 0] > 0.3          # learns (chance is 0.1)
    assert len(got["losses"]) == len(want["losses"])
    np.testing.assert_allclose(got["losses"][:5], want["losses"][:5],
                               rtol=1e-4, atol=1e-5)


def test_run_continual_meters_like_the_reference():
    cfg, jcfg = _cfgs()
    tasks, jt = _tasks(2, 64)
    kw = dict(epochs_per_task=1, batch_size=16)
    backend, jbackend = get_backend("wbs"), jget_backend("wbs")
    backend.telemetry.enable()
    jbackend.telemetry.enable()
    got = continual.run_continual(cfg, continual.TrainerSpec(**kw), tasks,
                                  replay=continual.ReplaySpec(capacity=16),
                                  device=backend, torch_device="cpu")
    jcontinual.run_continual(jcfg, jcontinual.TrainerSpec(**kw), jt,
                             replay=jcontinual.ReplaySpec(capacity=16),
                             device=jbackend)
    a, b = got["telemetry"].snapshot(), jbackend.telemetry.snapshot()
    assert set(a) == set(b)
    for k in a:
        if k.startswith(meters.WRITE_PULSES):
            assert abs(a[k] - b[k]) <= 0.01 * b[k], k
        else:
            assert a[k] == b[k], k


def test_unported_options_raise():
    cfg, _ = _cfgs()
    tasks, _ = _tasks(1, 32)
    with pytest.raises(NotImplementedError, match="next slice"):
        continual.run_continual(cfg, continual.TrainerSpec(algo="adam"),
                                tasks, torch_device="cpu")
    with pytest.raises(ValueError, match="unknown trainer algo"):
        continual.run_continual(cfg, continual.TrainerSpec(algo="sgd"),
                                tasks, torch_device="cpu")
    with pytest.raises(NotImplementedError, match="pad"):
        continual.run_continual(cfg, continual.TrainerSpec(), tasks,
                                pad=object(), torch_device="cpu")
    with pytest.raises(NotImplementedError, match="obs"):
        continual.run_continual(cfg, continual.TrainerSpec(), tasks,
                                obs=object(), torch_device="cpu")
    with pytest.raises(NotImplementedError, match="in-graph"):
        continual.run_continual(
            cfg, continual.TrainerSpec(), tasks, torch_device="cpu",
            replay=continual.ReplaySpec(policy="loss_aware"))
    with pytest.raises(NotImplementedError, match="ContinualConfig"):
        continual.ContinualConfig(trainer="dfa")


def test_adam_refusal_names_the_slice_that_brings_it():
    """``algo="adam"`` is ROADMAP queue A's "slice 6" (the MiRU's BPTT +
    Adam baseline), not slice 4 (the LM zoo, already ported)."""
    cfg, _ = _cfgs()
    tasks, _ = _tasks(1, 32)
    with pytest.raises(NotImplementedError) as err:
        continual.run_continual(cfg, continual.TrainerSpec(algo="adam"),
                                tasks, torch_device="cpu")
    assert "queue A, slice 6" in str(err.value)
    assert "BPTT + Adam" in str(err.value)
    assert "slice 4" not in str(err.value)


def test_run_continual_refuses_cuda_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, _ = _cfgs()
    tasks, _ = _tasks(1, 32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        continual.run_continual(cfg, continual.TrainerSpec(), tasks)


_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                     re.MULTILINE)


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if _IMPORT.search(f.read_text())]
    assert offenders == []
