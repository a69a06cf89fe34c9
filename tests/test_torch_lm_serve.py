"""The torch port's LM serving engine (``serve/engine.py``) against the
JAX reference's ``ServeEngine``, and the batch-composition contract the
port holds where the reference does not.

The reference writes every slot's cache row at the position it steps, so
a request admitted while another decodes overwrites that request's
history (ROADMAP queue C). On traffic the reference serves right — one
request, prompts of one token admitted together (no prefill steps), or
the last request admitted in a pass — the two engines decode the same
tokens; elsewhere the port decodes what each request decodes alone.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine  # noqa: E402

A = [5, 9, 17, 3]
B = [7, 8, 2, 11, 4, 6]


@pytest.fixture(scope="module")
def model():
    jcfg = jax_smoke("qwen2-0.5b")
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return (jcfg, jp, get_smoke_config("qwen2-0.5b"),
            lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))


def _serve(engine, prompts, max_new=12, delay=None):
    """Submit prompts[0], step ``delay`` times, submit the rest; drain."""
    reqs = [engine.submit(prompts[0], max_new)]
    for _ in range(delay or 0):
        engine.step()
    reqs += [engine.submit(p, max_new) for p in prompts[1:]]
    engine.run_until_drained()
    return [r.tokens for r in reqs]


def _both(model, prompts, delay=None, **kw):
    jcfg, jp, cfg, tp = model
    kw.setdefault("batch_slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("eos_token", -1)
    ref = _serve(JServeEngine(jcfg, JServeConfig(**kw), jp), prompts,
                 delay=delay)
    port = _serve(ServeEngine(cfg, ServeConfig(torch_device="cpu", **kw), tp),
                  prompts, delay=delay)
    return ref, port


@pytest.mark.parametrize("prompt", [A, B, [42]])
def test_one_request_decodes_the_reference_tokens(model, prompt):
    ref, port = _both(model, [prompt])
    assert port == ref and len(port[0]) == 12


def test_one_token_prompts_admitted_together_match_the_reference(model):
    ref, port = _both(model, [[5], [9], [17]], batch_slots=3)
    assert port == ref


def test_the_last_request_admitted_together_matches_the_reference(model):
    ref, port = _both(model, [A, B[:4]])
    assert port[1] == ref[1]


def test_sampling_matches_the_reference(model):
    ref, port = _both(model, [A], greedy=False, temperature=0.7, seed=3)
    assert port == ref


def test_a_late_request_leaves_earlier_slots_alone(model):
    """The reference fault pinned: B admitted after 4 steps rewrites A's
    cache rows in the reference (A's tokens change after the fourth), and
    not in the port, whose A decodes what A decodes alone."""
    alone_ref, alone = _both(model, [A])
    ref, port = _both(model, [A, B], delay=4)
    assert alone == alone_ref
    assert alone[0] == [54, 54, 45, 115, 67, 82, 47, 32, 54, 97, 97, 97]
    assert ref[0] != alone_ref[0] and ref[0][:4] == alone_ref[0][:4]
    assert port[0] == alone[0]
    assert port[1] == _both(model, [B])[1][0]


def test_batch_composition_and_slot_do_not_change_tokens(model):
    """Each request decodes the same tokens alone, in a full engine, in
    another slot and behind other traffic."""
    _, _, cfg, tp = model
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, rng.integers(1, 9)).tolist()
               for _ in range(7)]

    def engine(slots):
        return ServeEngine(cfg, ServeConfig(batch_slots=slots, max_len=32,
                                            eos_token=-1,
                                            torch_device="cpu"), tp)
    burst = _serve(engine(3), prompts, max_new=6)
    for p, toks in zip(prompts, burst):
        assert _serve(engine(3), [p], max_new=6)[0] == toks
    # The last prompt in slot 2, behind two others still decoding.
    late = _serve(engine(3), [prompts[0], prompts[1], prompts[6]],
                  max_new=6, delay=None)
    assert late[2] == burst[6]


def test_request_stats_and_finish_rules(model):
    _, _, cfg, tp = model
    clock = iter(np.arange(0.0, 100.0, 0.5))
    eng = ServeEngine(cfg, ServeConfig(batch_slots=2, max_len=10,
                                       eos_token=-1, torch_device="cpu",
                                       clock=lambda: float(next(clock))), tp)
    reqs = [eng.submit(p, max_new=m) for p, m in ((A, 3), (B, 20), ([1], 2))]
    eng.run_until_drained()
    assert [len(r.tokens) for r in reqs] == [3, 4, 2]   # max_len - 1 = 9
    assert all(r.done for r in reqs)
    assert [r.steps for r in reqs] == [6, 9, 2]
    st = eng.request_stats()
    assert st["requests"] == 3 and st["tokens_generated"] == 9
    assert st["decode_calls"] >= st["steps_run"]
    assert st["latency_ms"]["count"] == 3
    assert st["tokens_per_s"] > 0


def test_deadline_drops_stale_requests(model):
    _, _, cfg, tp = model
    t = [0.0]
    eng = ServeEngine(cfg, ServeConfig(batch_slots=1, max_len=16,
                                       eos_token=-1, torch_device="cpu",
                                       deadline_s=1.0, clock=lambda: t[0]),
                      tp)
    first, second = eng.submit(A, 2), eng.submit(B, 2)
    eng.step()                                  # admits A at t = 0
    t[0] = 5.0
    eng.run_until_drained()
    assert first.tokens and not first.timed_out
    assert second.timed_out and second.done and not second.tokens
    assert eng.request_stats()["timed_out"] == 1


def test_unported_options_raise(model):
    """The substrate options run (against the reference in
    ``tests/test_torch_lm_quant.py``); what still raises is the
    reference's refusals: a built backend for ``device``, an unknown
    name, ``meter`` without a substrate. An unmetered engine has no
    energy block, whatever ``model``."""
    _, _, cfg, tp = model
    eng = ServeEngine(cfg, ServeConfig(torch_device="cpu", device="wbs",
                                       meter=True), tp)
    assert eng.cfg.quant_mode == "wbs" and eng.telemetry.enabled
    eng.telemetry.disable()
    for kw, err in (({"device": eng.backend}, TypeError),
                    ({"device": "nope"}, ValueError),
                    ({"meter": True}, ValueError)):
        with pytest.raises(err):
            ServeEngine(cfg, ServeConfig(torch_device="cpu", **kw), tp)
    eng = ServeEngine(cfg, ServeConfig(torch_device="cpu"), tp)
    assert "energy" not in eng.request_stats(model=object())


def test_the_engine_asks_for_the_card_by_default(model, monkeypatch):
    _, _, cfg, tp = model
    assert ServeConfig().torch_device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, ServeConfig(), tp)


def test_kept_logits_and_the_tie_aware_token_comparison(model):
    """``keep_logits`` records each generated token's logits; a stream
    compares equal to itself, a flip on a near-tie is counted, and a flip
    off a tie or logits beyond ``atol`` raise."""
    from repro_torch import testing
    _, _, cfg, tp = model
    eng = ServeEngine(cfg, ServeConfig(batch_slots=2, max_len=32,
                                       eos_token=-1, torch_device="cpu",
                                       keep_logits=True), tp)
    reqs = [eng.submit(p, 5) for p in (A, B)]
    eng.run_until_drained()
    toks = [r.tokens for r in reqs]
    logits = [r.logits for r in reqs]
    assert [len(x) for x in logits] == [5, 5]
    assert [int(torch.argmax(x)) for x in logits[0]] == toks[0]
    assert testing.compare_tokens(toks, toks, logits, logits,
                                  atol=1e-6).flipped_rows == 0
    # Make token 2 of stream 0 a near-tie, then flip the other side's pick.
    tied = [list(x) for x in logits]
    row = tied[0][2].clone()
    second = int(torch.topk(row, 2).indices[1])
    row[second] = row[toks[0][2]] - 1e-7
    tied[0][2] = row
    flipped = [list(t) for t in toks]
    flipped[0][2] = second
    rep = testing.compare_tokens(toks, flipped, tied, tied, atol=1e-6)
    assert rep.flipped_rows == 1 and rep.flips[0][:2] == (0, 2)
    with pytest.raises(AssertionError, match="not a tie"):
        testing.compare_tokens(toks, flipped, logits, logits, atol=1e-6)
    far = [[x + 1e-3 for x in s] for s in logits]
    with pytest.raises(AssertionError, match="apart"):
        testing.compare_tokens(toks, toks, logits, far, atol=1e-6)


def test_bf16_within_allows_one_ulp_plus_the_fp32_tolerance():
    from repro_torch import testing
    w = torch.tensor([1.0, 0.3, -2.5e-5, 0.0])
    exact = w.to(torch.bfloat16)
    assert testing.bf16_within(exact, w) == (True, float(
        (exact.float() - w).abs().max()))
    up = torch.nextafter(exact.float(), torch.tensor(10.0)).to(
        torch.bfloat16)                      # not a bf16 step: same value
    assert testing.bf16_within(up, w)[0]
    two = (exact.float() + 2 * 2.0 ** -7).to(torch.bfloat16)   # 2 ulps at 1
    assert not testing.bf16_within(two[:1], w[:1])[0]
