"""The torch port's LM training path (``repro_torch.train``,
``repro_torch.data.pipeline``) against the JAX reference, and
``tests/test_train.py``'s behaviour for the port.

The reference's Trainer and the port's run the qwen2-0.5b smoke config
(fp32) at ``attn_chunk=8`` on 4 × 16-token batches, so every step's
attention takes the flash branch (the port's autograd Function around
the flash kernels' plain versions). From the same initial parameters and
the same batches their losses agree at rtol 1e-5 and their grad norms
at rtol 1e-4 for 15 steps (measured: within 9.9e-8 and 5.9e-7
relative, with ``grad_accum`` 1 and 2; the two sides sum in other
orders, and Adam's normalised steps carry those last-bit differences
forward). A checkpoint written by the
reference Trainer restores into the port's, optimizer state and data
position included, and continues the reference's run at the same
tolerances.

Not ported: ``test_checkpoint_elastic_reshard`` — it restores onto a JAX
mesh's ``NamedSharding``; the port is one device and takes
``restore(device=)`` instead (tested below).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data.pipeline import ShardedBatcher as JBatcher  # noqa: E402
from repro.data.synthetic import lm_token_batch as j_lm_token_batch  # noqa: E402,E501
from repro.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro_torch.analog.endurance import EnduranceTracker  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.data.pipeline import (ShardedBatcher,  # noqa: E402
                                       _collate_ragged)
from repro_torch.data.synthetic import lm_token_batch  # noqa: E402
from repro_torch.train import CheckpointManager, TrainConfig, Trainer  # noqa: E402,E501
from repro_torch.train.faults import (HealthMonitor, PreemptionGuard,  # noqa: E402,E501
                                      retry)
from repro_torch.utils import flatten_dict, tree_leaves  # noqa: E402

LOSS_RTOL, GNORM_RTOL = 1e-5, 1e-4
CHUNK, B, S = 8, 4, 16


def _cfgs():
    return (dataclasses.replace(jconfigs.get_smoke_config("qwen2-0.5b"),
                                attn_chunk=CHUNK),
            dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                                attn_chunk=CHUNK))


def _tcfg(cls, tmp=None, steps=20, seed=0, checkpoint_every=1000, **kw):
    return cls(steps=steps, lr=1e-3, warmup_steps=2,
               checkpoint_every=checkpoint_every, log_every=1000,
               checkpoint_dir=None if tmp is None else str(tmp), seed=seed,
               **kw)


def _mk_trainer(tmp_path, steps=20, seed=0, checkpoint_every=5, **kw):
    """The port's counterpart of ``tests/test_train.py::_mk_trainer``."""
    cfg = get_smoke_config("qwen2-0.5b")

    def gen(rng, step):
        return lm_token_batch(rng, 4, 16, cfg.vocab)

    return Trainer(cfg, _tcfg(TrainConfig, tmp_path, steps, seed,
                              checkpoint_every, **kw),
                   ShardedBatcher(gen, seed=seed), device="cpu")


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference Trainer for 15 steps, a checkpoint written at step 5:
    (its initial params as numpy, its history, the checkpoint dir)."""
    jcfg, cfg = _cfgs()
    d = tmp_path_factory.mktemp("reference_ckpt")
    t = JTrainer(jcfg, _tcfg(JTrainConfig, d),
                 JBatcher(lambda rng, s: j_lm_token_batch(rng, B, S,
                                                          jcfg.vocab)))
    init = jax.tree.map(np.asarray, t.params)
    t.run(steps=5)
    t.save(async_=False)
    t.run(steps=10)
    return init, [dict(h) for h in t.history], d


def _port_trainer(init, tmp=None, **kw):
    _, cfg = _cfgs()
    return Trainer(cfg, _tcfg(TrainConfig, tmp, **kw),
                   ShardedBatcher(lambda rng, s: lm_token_batch(
                       rng, B, S, cfg.vocab)),
                   params=lm_params_from_numpy(init, "cpu"), device="cpu")


def _follows(got, want):
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in want], rtol=LOSS_RTOL)
    np.testing.assert_allclose([h["grad_norm"] for h in got],
                               [h["grad_norm"] for h in want],
                               rtol=GNORM_RTOL)
    assert [h["step"] for h in got] == [h["step"] for h in want]


def test_trainer_follows_reference_trainer(reference_run):
    init, want, _ = reference_run
    t = _port_trainer(init)
    _follows(t.run(steps=15), want)
    assert t.n_params == sum(a.size for a in jax.tree.leaves(init))


def test_trainer_with_grad_accum_follows_reference():
    """grad_accum 2: the reference's microbatch sums and final division."""
    jcfg, _ = _cfgs()
    jt = JTrainer(jcfg, _tcfg(JTrainConfig, grad_accum=2),
                  JBatcher(lambda rng, s: j_lm_token_batch(rng, B, S,
                                                           jcfg.vocab)))
    init = jax.tree.map(np.asarray, jt.params)
    want = jt.run(steps=10)
    _follows(_port_trainer(init, grad_accum=2).run(steps=10), want)


def test_reference_checkpoint_restores_into_the_port(reference_run,
                                                     tmp_path):
    """The reference's step-5 checkpoint (params, AdamW state, data
    position) restored by the port's Trainer: its next 10 steps follow
    the reference's uninterrupted run."""
    init, want, d = reference_run
    t = _port_trainer(init, d)
    assert t.maybe_restore() and t.step == 5
    assert t.batcher.state.step == 5
    count = t.opt_state[1].count
    assert count.dtype == torch.int32 and int(count) == 5
    _follows(t.run(steps=10), want[5:])


def test_default_init_draws_the_reference_params():
    """Without ``params`` both Trainers draw ``init_params(PRNGKey(seed))``
    (the port's truncated normal within a few ulp of XLA's erfinv)."""
    jcfg, cfg = _cfgs()
    want = JTrainer(jcfg, _tcfg(JTrainConfig, seed=3),
                    JBatcher(lambda rng, s: {})).params
    got = Trainer(cfg, _tcfg(TrainConfig, seed=3),
                  ShardedBatcher(lambda rng, s: {}), device="cpu").params
    jflat = flatten_dict(jax.tree.map(np.asarray, want))
    for k, t in flatten_dict(got).items():
        np.testing.assert_allclose(t.numpy(), jflat[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_batcher_matches_reference_and_collates_ragged_rows():
    def gen(rng, step):
        b = j_lm_token_batch(rng, 2, 8, 100)
        b["rows"] = [np.arange(n) for n in rng.integers(1, 6, 3)]
        return b
    ours, ref = ShardedBatcher(gen, seed=4, pad_to=6), \
        JBatcher(gen, seed=4, pad_to=6)
    for _ in range(3):
        a, b = ours.next(), ref.next()
        assert set(a) == set(b) and "rows_lengths" in a
        for k in a:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]))
    assert ours.state_dict() == ref.state_dict() == {"step": 3, "seed": 4}
    ours.load_state_dict({"step": 1, "seed": 4})
    np.testing.assert_array_equal(ours.next()["tokens"],
                                  ref.peek(1)["tokens"])
    on = ShardedBatcher(gen, seed=4, device="cpu").next()
    assert isinstance(on["tokens"], torch.Tensor) and \
        on["tokens"].dtype == torch.int32
    with pytest.raises(ValueError, match="pad_to"):
        _collate_ragged([np.zeros(4), np.zeros(9)], pad_to=6)


# ---------------------------------------------------------------------------
# tests/test_train.py, for the port
# ---------------------------------------------------------------------------

def test_loss_decreases(tmp_path):
    t = _mk_trainer(tmp_path, steps=40)
    hist = t.run()
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_endurance_tracker_checkpoint_roundtrip(tmp_path):
    """Lifetime projections survive restarts: the port's tracker
    serializes inside any checkpointed tree and is revived on restore."""
    from repro_torch.telemetry import project_lifetime
    tracker = EnduranceTracker(endurance=5e8)
    rng = np.random.default_rng(0)
    for _ in range(3):
        tracker.record_update({"w_h": torch.from_numpy(rng.random((4, 6))
                                                       < 0.5),
                               "u_h": torch.from_numpy(rng.random((6, 6))
                                                       < 0.5)})
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(7, {"params": {"w": torch.ones((2, 2))}, "endurance": tracker})
    step, tree, _ = mgr.restore()
    assert step == 7
    restored = tree["endurance"]
    assert isinstance(restored, EnduranceTracker)
    assert restored.endurance == tracker.endurance
    assert restored.updates_applied == tracker.updates_applied
    np.testing.assert_array_equal(restored.all_counts(),
                                  tracker.all_counts())
    assert project_lifetime(restored).years_mean == \
        project_lifetime(tracker).years_mean
    restored.record_update({"w_h": torch.ones((4, 6), dtype=torch.bool)})
    assert restored.updates_applied == 4


def test_checkpoint_restart_bit_identical(tmp_path):
    """Crash/restart: the restored trainer reproduces the uninterrupted
    run exactly (deterministic data pipeline + exact state restore)."""
    a = _mk_trainer(tmp_path / "a", steps=20, checkpoint_every=1000)
    a.run(steps=10)
    a.save(async_=False)
    a.run(steps=10)
    uninterrupted = [h["loss"] for h in a.history[10:]]

    b = _mk_trainer(tmp_path / "a", steps=20, checkpoint_every=1000)
    assert b.maybe_restore()
    assert b.step == 10
    b.run(steps=10)
    assert [h["loss"] for h in b.history] == uninterrupted


def test_checkpoint_atomicity(tmp_path):
    ck = CheckpointManager(tmp_path, keep=2)
    tree = {"params": {"w": torch.arange(8.0)}}
    ck.save(1, tree)
    ck.save(2, tree)
    ck.save(3, tree)
    assert ck.all_steps() == [2, 3]          # keep=2 GC'd step 1
    assert not list(tmp_path.glob("*.tmp"))  # no torn state left
    step, restored, _ = ck.restore()
    assert step == 3
    assert torch.equal(restored["params"]["w"], torch.arange(8.0))


def test_checkpoint_async(tmp_path):
    ck = CheckpointManager(tmp_path)
    ck.save_async(7, {"w": torch.ones((1024, 64))}, extra={"note": "async"})
    ck.wait()
    step, restored, extra = ck.restore(device="cpu")
    assert step == 7 and extra["note"] == "async"
    assert restored["w"].shape == (1024, 64)


def test_checkpoint_layout_is_the_reference_and_keeps_bf16_bits(tmp_path):
    """``arrays.npz`` keys with ``/`` written ``__`` and a manifest the
    reference's ``restore`` reads; bf16 leaves on disk as their uint16
    bits, named "bfloat16", and restored bit for bit."""
    from repro.train import CheckpointManager as JCheckpointManager
    w = torch.linspace(-3, 3, 12).reshape(3, 4)
    tree = {"params": {"w": w, "h": w.to(torch.bfloat16)},
            "opt": (torch.tensor(3, dtype=torch.int32),)}
    CheckpointManager(tmp_path).save(4, tree, extra={"data": {"step": 4}})
    manifest = json.loads((tmp_path / "step_4" / "manifest.json")
                          .read_text())
    assert manifest["keys"] == ["opt/0", "params/h", "params/w"]
    assert manifest["dtypes"] == {"opt/0": "int32", "params/h": "bfloat16",
                                  "params/w": "float32"}
    step, jtree, extra = JCheckpointManager(tmp_path).restore()
    assert step == 4 and extra == {"data": {"step": 4}}
    np.testing.assert_array_equal(jtree["params"]["w"], w.numpy())
    _, tree2, _ = CheckpointManager(tmp_path).restore()
    assert torch.equal(tree2["params"]["h"], tree["params"]["h"])
    assert tree2["opt"]["0"].dtype == torch.int32


def test_reference_bf16_checkpoint_is_refused(tmp_path):
    from repro.train import CheckpointManager as JCheckpointManager
    JCheckpointManager(tmp_path).save(
        1, {"w": jnp.ones((2, 2), jnp.bfloat16)})
    with pytest.raises(ValueError, match="reference"):
        CheckpointManager(tmp_path).restore()


def test_preemption_guard_checkpoint_and_stop(tmp_path):
    """SIGTERM mid-run → finish the in-flight step, checkpoint, exit."""
    t = _mk_trainer(tmp_path, steps=100, checkpoint_every=1000)
    guard = PreemptionGuard(install=False)
    t.run(steps=3)
    guard.requested = True                  # deterministic "signal"
    t.run(guard=guard)                      # runs exactly one more step
    assert t.step == 4                      # stopped at the boundary
    assert t.ckpt.latest_step() == 4        # checkpoint saved on exit


def test_health_monitor_straggler():
    mon = HealthMonitor(straggler_factor=3.0)
    for s in range(10):
        assert not mon.record(s, 0.1)
    assert mon.record(10, 1.0)               # 10× the EWMA
    assert mon.straggler_events[0][0] == 10


def test_health_monitor_excludes_stragglers_from_ewma():
    """A flagged step must not poison the baseline it was judged
    against."""
    mon = HealthMonitor(straggler_factor=3.0, ewma=0.9)
    for s in range(3):
        assert not mon.record(s, 1.0)
    assert mon.mean_step_s == pytest.approx(1.0)
    assert mon.record(3, 4.0)                # straggler: 4 > 3×1.0
    assert mon.mean_step_s == pytest.approx(1.0)
    assert mon.record(4, 3.5)                # still caught
    assert [e[0] for e in mon.straggler_events] == [3, 4]


def test_retry_rejects_nonpositive_attempts():
    with pytest.raises(ValueError, match="attempts"):
        retry(lambda: 1, attempts=0)


def test_retry_success_and_no_sleep_after_last_attempt(monkeypatch):
    sleeps = []
    monkeypatch.setattr("repro_torch.train.faults.time.sleep",
                        sleeps.append)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert retry(flaky, attempts=3, backoff_s=0.1) == "ok"
    assert sleeps == [pytest.approx(0.1), pytest.approx(0.2)]
    sleeps.clear()
    with pytest.raises(RuntimeError, match="always"):
        retry(lambda: (_ for _ in ()).throw(RuntimeError("always")),
              attempts=2, backoff_s=0.1)
    assert sleeps == [pytest.approx(0.1)]


def test_kwta_and_compression_in_trainer(tmp_path):
    t = _mk_trainer(tmp_path, steps=10, kwta_grad_keep=0.5,
                    grad_compression_keep=0.5)
    hist = t.run()
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert all(torch.isfinite(x).all() for x in tree_leaves(t.params))


def test_quantized_models_are_not_ported():
    """A quantized model trains (against the reference in
    ``tests/test_torch_lm_quant.py``); its mode is validated by name
    when the Trainer is built, as in the reference."""
    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                              quant_mode="wbs")
    t = Trainer(cfg, _tcfg(TrainConfig, steps=2), ShardedBatcher(
        lambda rng, s: lm_token_batch(rng, 2, 8, cfg.vocab)), device="cpu")
    hist = t.run(steps=2)
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in hist)
    with pytest.raises(ValueError, match="unknown device backend"):
        Trainer(dataclasses.replace(cfg, quant_mode="nope"), TrainConfig(),
                ShardedBatcher(lambda r, s: {}), device="cpu")
