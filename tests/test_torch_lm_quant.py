"""The LM zoo on a device substrate (``quant_mode``) and the ``miru``
mixer in the torch port, against the JAX reference.

- ``backends.inference_backend``: the reference's spec overrides on
  every registered name, one shared instance a name, dropped when a name
  is registered again or removed.
- ``layers.dense`` with a quant mode: the sign-magnitude codes of the
  normalised drive equal the reference's, the output at fp32 tolerance
  (the bit-plane sums run in another order; measured within 1.9e-6 on
  outputs up to 8).
- ``blocks.miru_mixer``, float and ``wbs``, and ``lm.forward`` of the
  ``qwen2-0.5b`` and ``internlm2-1.8b`` smoke configs (fp32) with
  ``quant_mode="wbs"``, the dense and the miru mixer, on the
  reference's weights carried across by ``convert.lm_params_from_numpy``:
  at rtol 1e-5 / atol 1e-5 (measured: at most 7.2e-7 apart on logits up
  to 2.9). The reference's own bands for the quantized forward
  (``tests/test_integration.py::test_wbs_quantized_lm_forward``) hold
  for the port too.
- The metered ``ServeEngine``: ``tests/test_serve_telemetry.py``'s three
  cases (the hand count, exact; doubling; unmetered), its counters equal
  to the reference engine's ``snapshot()`` on the same traffic, and the
  ``energy`` block of ``request_stats`` equal to the reference's on the
  same counters, for the default ``DenseCostModel`` and an
  ``M2RUCostModel``.
- One request decodes the reference engine's tokens. A quantized
  projection normalises by one absmax over all the engine's rows, and
  the port's idle rows differ from the reference's (it writes no cache
  row of an idle slot, ROADMAP queue C), so the check runs a one-slot
  engine, where no other row shares the absmax.
- A quantized training step: ``lm.loss_fn``'s value and gradients (the
  straight-through products and the absmax, as autograd takes it)
  against ``jax.value_and_grad`` (measured within 1.1e-6 of each
  tensor's largest gradient), and a ``Trainer`` step's loss and grad
  norm against the reference ``Trainer``'s.
- The miru mixer has no decode, as in the reference.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.analog.costmodel import M2RUCostModel as JM2RUCostModel  # noqa: E402,E501
from repro.analog.wbs import quantize_signed as jquantize_signed  # noqa: E402
from repro.backends import inference_backend as jinference_backend  # noqa: E402,E501
from repro.backends import register_backend as jregister_backend  # noqa: E402
from repro.backends import unregister_backend as junregister_backend  # noqa: E402,E501
from repro.backends.wbs import WBSBackend as JWBSBackend  # noqa: E402
from repro.data.pipeline import ShardedBatcher as JBatcher  # noqa: E402
from repro.data.synthetic import lm_token_batch as j_lm_token_batch  # noqa: E402,E501
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro_torch import configs, prng  # noqa: E402
from repro_torch.analog.costmodel import M2RUCostModel  # noqa: E402
from repro_torch.analog.wbs import quantize_signed  # noqa: E402
from repro_torch.backends import (available_backends,  # noqa: E402
                                  inference_backend, register_backend,
                                  unregister_backend)
from repro_torch.backends.wbs import WBSBackend  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.data.pipeline import ShardedBatcher  # noqa: E402
from repro_torch.data.synthetic import lm_token_batch  # noqa: E402
from repro_torch.models import blocks, layers, lm  # noqa: E402
from repro_torch.serve.engine import ServeConfig, ServeEngine  # noqa: E402
from repro_torch.telemetry.meters import Telemetry  # noqa: E402
from repro_torch.train import TrainConfig, Trainer  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

RTOL, ATOL = 1e-5, 1e-5
DENSE_RTOL, DENSE_ATOL = 2e-5, 1e-5
NAME = "wbs_lm_quant_test"


def _pair(name: str, seed: int = 1, **kw):
    """(jax cfg, jax params, port cfg, port params) of a smoke config with
    the fields ``kw`` replaced, the reference's weights on both sides."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(name), **kw)
    cfg = dataclasses.replace(configs.get_smoke_config(name), **kw)
    jp = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, cfg, lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                               "cpu")


def _tokens(vocab, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# inference_backend
# ---------------------------------------------------------------------------

def test_inference_backend_spec_is_the_references_on_every_name():
    assert set(available_backends()) >= {"ideal", "wbs", "analog",
                                         "analog_state", "cmos"}
    for name in ("ideal", "wbs", "analog", "analog_state", "cmos"):
        got, want = inference_backend(name).spec, jinference_backend(name).spec
        for f in ("input_bits", "adc_bits", "adc_range", "gain_sigma",
                  "weight_clip", "track_endurance", "faults"):
            assert getattr(got, f) == getattr(want, f), (name, f)
        assert (got.input_bits, got.adc_bits, got.weight_clip) == \
            (8, None, None)
        if want.crossbar is None:
            assert got.crossbar is None
        else:
            assert dataclasses.asdict(got.crossbar) == \
                dataclasses.asdict(want.crossbar), name
        assert type(inference_backend(name)).__name__ == \
            type(jinference_backend(name)).__name__


def test_inference_backend_is_shared_and_dropped_on_registration():
    register_backend(NAME, WBSBackend)
    try:
        first = inference_backend(NAME)
        assert inference_backend(NAME) is first
        register_backend(NAME, WBSBackend)
        second = inference_backend(NAME)
        assert second is not first and inference_backend(NAME) is second
    finally:
        unregister_backend(NAME)
    with pytest.raises(ValueError, match="unknown device backend"):
        inference_backend(NAME)


# ---------------------------------------------------------------------------
# dense, the miru mixer, the quantized forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant_mode", ["wbs", "ideal", "cmos", "analog",
                                        "analog_state"])
def test_dense_on_a_substrate_matches_reference(quant_mode):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, (2, 5, 24)).astype(np.float32)
    w = rng.normal(0, 0.3, (24, 40)).astype(np.float32)
    b = rng.normal(0, 1, (40,)).astype(np.float32)
    want = np.asarray(jlayers.dense(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b), quant_mode=quant_mode))
    got = layers.dense(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b), quant_mode=quant_mode)
    _close(got, want, DENSE_RTOL, DENSE_ATOL)
    # The drive's codes: x / absmax, sign-magnitude at 8 bits.
    xt = torch.from_numpy(x)
    s = torch.clamp_min(torch.max(torch.abs(xt)), 1e-6)
    sign, code = quantize_signed(xt / s, 8)
    jx = jnp.asarray(x)
    jsign, jcode = jquantize_signed(
        jx / jnp.maximum(jnp.max(jnp.abs(jx)), 1e-6), 8)
    np.testing.assert_array_equal(sign.numpy(), np.asarray(jsign))
    np.testing.assert_array_equal(code.numpy(), np.asarray(jcode))


@pytest.mark.parametrize("quant_mode", ["none", "wbs"])
def test_miru_mixer_matches_reference(quant_mode):
    """One layer's mixer on the reference's weights: the float branch
    through the ideal scan's plain version, the quantized one through
    ``device_recurrence``'s per-step path."""
    jcfg, jp, cfg, tp = _pair("qwen2-0.5b", quant_mode=quant_mode,
                              mixer="miru")
    assert set(tp["layers"]["mixer"]) == {"w_h", "u_h", "b_h", "w_out"}
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1.5, (2, 9, cfg.d_model)).astype(np.float32)
    jmp = jax.tree.map(lambda a: a[0], jp["layers"]["mixer"])
    mp = blocks.layer_slice(tp["layers"]["mixer"], 0)
    mp = {k: v.clone() for k, v in mp.items()}
    mp["b_h"] = torch.from_numpy(rng.normal(0, 0.1, cfg.d_model)
                                 .astype(np.float32))
    jmp = dict(jmp, b_h=jnp.asarray(mp["b_h"].numpy()))
    want = jblocks.miru_mixer(jmp, jcfg, jnp.asarray(x))
    got = blocks.miru_mixer(mp, cfg, torch.from_numpy(x))
    _close(got, want)


def test_miru_mixer_params_are_drawn_as_the_reference():
    cfg = dataclasses.replace(configs.get_smoke_config("qwen2-0.5b"),
                              mixer="miru")
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("qwen2-0.5b"),
                               mixer="miru")
    got = blocks.init_miru_mixer(prng.PRNGKey(7), cfg, "cpu")
    want = jblocks.init_miru_mixer(jax.random.PRNGKey(7), jcfg)
    assert set(got) == set(want)
    for k in got:
        _close(got[k], want[k], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name,mixer", [("qwen2-0.5b", "default"),
                                        ("internlm2-1.8b", "default"),
                                        ("qwen2-0.5b", "miru")])
def test_quantized_forward_matches_reference(name, mixer):
    """``lm.forward`` with every projection on ``wbs`` (qwen2's tied head
    stays the float einsum, internlm2's head is quantized)."""
    jcfg, jp, cfg, tp = _pair(name, quant_mode="wbs", mixer=mixer)
    toks = _tokens(cfg.vocab, 2, 12)
    want = jlm.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got = lm.forward(tp, cfg, {"tokens": torch.from_numpy(toks)})
    assert torch.isfinite(got).all()
    _close(got, want)


def test_quantized_forward_tracks_the_float_forward():
    """The reference's own bands
    (``tests/test_integration.py::test_wbs_quantized_lm_forward``) on the
    port: 8-bit drives keep the logits within 0.15 of their range and the
    argmax mostly the float model's."""
    _, _, cfg, tp = _pair("internlm2-1.8b", seed=0)
    toks = torch.arange(2 * 8).reshape(2, 8) % cfg.vocab
    ref = lm.forward(tp, cfg, {"tokens": toks})
    wbs = lm.forward(tp, dataclasses.replace(cfg, quant_mode="wbs"),
                     {"tokens": toks})
    rel = float((wbs - ref).abs().max() / ref.abs().max())
    agree = float((ref.argmax(-1) == wbs.argmax(-1)).float().mean())
    assert rel < 0.15 and agree > 0.8, (rel, agree)


def test_the_miru_mixer_has_no_decode():
    _, _, cfg, tp = _pair("qwen2-0.5b", mixer="miru")
    with pytest.raises(NotImplementedError, match="reference"):
        lm.init_cache(cfg, 1, 8, "cpu")
    with pytest.raises(NotImplementedError, match="reference"):
        lm.decode_step(tp, cfg, {}, torch.zeros(1, 1, dtype=torch.int64), 0)
    with pytest.raises(NotImplementedError, match="reference"):
        ServeEngine(cfg, ServeConfig(torch_device="cpu"), tp)


# ---------------------------------------------------------------------------
# The metered engine (tests/test_serve_telemetry.py's cases)
# ---------------------------------------------------------------------------

@pytest.fixture
def quant_backend():
    """A private name on both sides, so that the shared instance and its
    telemetry are this test's alone."""
    register_backend(NAME, WBSBackend)
    jregister_backend(NAME, JWBSBackend)
    yield inference_backend(NAME)
    unregister_backend(NAME)
    junregister_backend(NAME)


@pytest.fixture(scope="module")
def smoke():
    return _pair("qwen2-0.5b", seed=0)


def _engines(smoke, slots: int, meter: bool = True, max_len: int = 32):
    jcfg, jp, cfg, tp = smoke
    kw = dict(batch_slots=slots, max_len=max_len, eos_token=-1, device=NAME,
              meter=meter)
    return (ServeEngine(cfg, ServeConfig(torch_device="cpu", **kw), tp),
            JServeEngine(jcfg, JServeConfig(**kw), jp))


def _per_execution(cfg, slots: int) -> dict:
    """The reference test's hand count for one decode call: per layer the
    quantized wq, wk, wv, wo and the SwiGLU gate/up/down, B rows each
    (idle slots stream pad tokens); the tied head is not quantized."""
    D, Fd = cfg.d_model, cfg.d_ff
    hd = cfg.hd()
    q, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    denses = [(D, q), (D, kv), (D, kv), (q, D), (D, Fd), (D, Fd), (Fd, D)]
    L, input_bits = cfg.n_layers, 8
    return {"macs": slots * L * sum(i * o for i, o in denses),
            "vmm_rows": slots * L * len(denses),
            "bit_pulses": slots * L * input_bits * sum(i for i, _ in denses),
            "wbs_phases": slots * L * input_bits * len(denses)}


def _drain(*engines):
    for eng in engines:
        eng.run_until_drained()
    jax.effects_barrier()


def test_counters_match_hand_computed(quant_backend, smoke):
    eng, ref = _engines(smoke, slots=2)
    tele = eng.telemetry
    assert tele is quant_backend.telemetry and tele.enabled
    tele.reset()
    ref.telemetry.reset()
    req, jreq = eng.submit([1, 2, 3], max_new=4), ref.submit([1, 2, 3], 4)
    _drain(eng, ref)
    assert req.done and len(req.tokens) == 4
    executions = 2 + 4                 # prefill len(prompt) - 1, decode 4
    per = _per_execution(eng.cfg, 2)
    snap = tele.snapshot()
    for meter in ("macs", "vmm_rows", "bit_pulses", "wbs_phases"):
        assert snap[f"{meter}/dense"] == executions * per[meter], meter
    assert tele.total("adc_conversions") == 0
    assert snap == ref.telemetry.snapshot()
    assert jreq.done and eng.decode_calls == executions


def test_counters_scale_with_workload(quant_backend, smoke):
    eng, _ = _engines(smoke, slots=2)
    tele = eng.telemetry
    tele.reset()
    eng.submit([1, 2, 3], max_new=4)
    _drain(eng)
    first = tele.snapshot()
    assert first["macs/dense"] > 0
    eng.submit([1, 2, 3], max_new=4)
    _drain(eng)
    second = tele.snapshot()
    assert second == {k: 2 * v for k, v in first.items()}


def test_unmetered_engine_counts_nothing(quant_backend, smoke):
    quant_backend.telemetry.reset()
    quant_backend.telemetry.disable()
    eng, _ = _engines(smoke, slots=2, meter=False)
    eng.submit([1, 2], max_new=3)
    _drain(eng)
    assert eng.telemetry.snapshot() == {}
    assert "energy" not in eng.request_stats()


def test_energy_block_is_the_references(quant_backend, smoke):
    """Two requests of unequal length: the energy figures and each
    request's share equal the reference engine's on the same counters."""
    eng, ref = _engines(smoke, slots=1)
    eng.telemetry.reset()
    ref.telemetry.reset()
    for e in (eng, ref):
        e.submit([5, 9, 17, 3], max_new=3)
        e.submit([2, 7], max_new=5)
    _drain(eng, ref)
    assert eng.telemetry.snapshot() == ref.telemetry.snapshot()
    for got, want in ((eng.request_stats()["energy"],
                       ref.request_stats()["energy"]),
                      (eng.request_stats(model=M2RUCostModel())["energy"],
                       ref.request_stats(model=JM2RUCostModel())["energy"])):
        assert set(got) == set(want)
        for k, v in want.items():
            if isinstance(v, dict):
                assert got[k].keys() == v.keys()
                np.testing.assert_allclose(list(got[k].values()),
                                           list(v.values()), rtol=1e-12)
            else:
                np.testing.assert_allclose(got[k], v, rtol=1e-12)
    assert {"power_mw", "gops_per_w", "pj_per_op"} <= \
        set(eng.request_stats()["energy"])


def test_one_request_decodes_the_reference_engines_tokens(quant_backend,
                                                           smoke):
    eng, ref = _engines(smoke, slots=1, meter=False)
    prompt = [5, 9, 17, 3, 44, 2]
    got, want = eng.submit(prompt, 10), ref.submit(prompt, 10)
    _drain(eng, ref)
    assert len(got.tokens) == 10 and got.tokens == want.tokens


def test_engine_device_takes_a_name(smoke):
    _, _, cfg, tp = smoke
    with pytest.raises(TypeError, match="registry name"):
        ServeEngine(cfg, ServeConfig(torch_device="cpu",
                                     device=WBSBackend()), tp)
    with pytest.raises(ValueError, match="unknown device backend"):
        ServeEngine(cfg, ServeConfig(torch_device="cpu", device="nope"), tp)
    with pytest.raises(ValueError, match="substrate"):
        ServeEngine(cfg, ServeConfig(torch_device="cpu", meter=True), tp)
    eng = ServeEngine(dataclasses.replace(cfg, quant_mode="wbs"),
                      ServeConfig(torch_device="cpu"), tp)
    assert eng.backend is inference_backend("wbs")
    assert ServeEngine(cfg, ServeConfig(torch_device="cpu"), tp
                       ).telemetry is None


def test_diverted_counts_leave_the_accumulator_alone():
    """What the engine does around a CUDA graph's capture: the counts of
    the captured call go to a Counter of their own, whether the telemetry
    is on or not, and are added on each replay only while it is on."""
    tele = Telemetry()
    drive, w = torch.zeros(3, 4), torch.zeros(4, 5)
    with tele.scaled(7), tele.diverted() as counts:
        tele.meter_vmm(drive, w, 8, "dense")
    assert tele.counters == {} and not tele.enabled and tele._scale == 1
    assert counts == {"vmm_rows/dense": 3, "macs/dense": 60,
                      "bit_pulses/dense": 96, "wbs_phases/dense": 24}
    tele.record(counts)
    assert tele.snapshot() == {}
    tele.enable()
    tele.record(counts)
    tele.record(counts)
    assert tele.snapshot() == {k: 2 * v for k, v in counts.items()}


# ---------------------------------------------------------------------------
# Quantized training
# ---------------------------------------------------------------------------

def test_quantized_loss_and_grads_match_reference():
    jcfg, jp, cfg, tp = _pair("qwen2-0.5b", seed=0, quant_mode="wbs",
                              attn_chunk=8)
    toks = _tokens(cfg.vocab, 2, 16)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1),
             "mask": np.ones((2, 16), np.float32)}
    jloss, jgrads = jax.value_and_grad(lambda p: jlm.loss_fn(
        p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}))(jp)
    tp = tree_map(lambda t: t.requires_grad_(), tp)
    loss = lm.loss_fn(tp, cfg, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    grads = torch.autograd.grad(loss, tree_leaves(tp))
    _close(loss.detach(), jloss, rtol=1e-6, atol=0)
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        jg = np.asarray(jg)
        _close(g, jg, rtol=1e-5, atol=1e-5 * np.abs(jg).max())


def test_quantized_trainer_step_matches_reference():
    jcfg, jp, cfg, _ = _pair("qwen2-0.5b", seed=0, quant_mode="wbs",
                             attn_chunk=8)
    kw = dict(steps=4, lr=1e-3, warmup_steps=2, log_every=1000,
              checkpoint_every=1000)
    init = jax.tree.map(np.asarray, jp)     # the reference's step donates
    jt = JTrainer(jcfg, JTrainConfig(**kw), JBatcher(
        lambda rng, s: j_lm_token_batch(rng, 2, 16, jcfg.vocab)),
        params=jp)
    want = jt.run(steps=2)
    t = Trainer(cfg, TrainConfig(**kw), ShardedBatcher(
        lambda rng, s: lm_token_batch(rng, 2, 16, cfg.vocab)),
        params=lm_params_from_numpy(init, "cpu"), device="cpu")
    got = t.run(steps=2)
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in want], rtol=1e-5)
    np.testing.assert_allclose([h["grad_norm"] for h in got],
                               [h["grad_norm"] for h in want], rtol=1e-4)
