"""The torch port's optimizer stack (``repro_torch.optim``) against the
JAX reference (``repro.optim``).

Every transform, recipe and schedule runs on identical numpy trees and
gradients (made from a seed, independent of the params, so both sides
see the same inputs at every step); updates, params and every state leaf
agree at rtol 1e-6 (atol 1e-7 for values that pass near zero): the
element arithmetic is the reference's, in its order, and only
transcendental functions (pow, cos, sqrt) may round differently in the
last bit. The reference's own behavioural tests (``tests/test_optim.py``)
are mirrored for the port. ``adam_8bit``'s int8 codes and fp32 scales
equal the reference's bit for bit on the same gradients (the reference
run eagerly, as every transform here: under ``jax.jit`` XLA turns the
division by 127 into a product with its reciprocal).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.optim.sparsify import write_masks  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

RTOL, ATOL = 1e-6, 1e-7


def _tree(rng, scale=1.0):
    return {"w": (scale * rng.normal(0, 1, (8, 16))).astype(np.float32),
            "b": (scale * rng.normal(0, 1, (16,))).astype(np.float32),
            "layers": {"u": (scale * rng.normal(0, 1, (3, 8, 8))
                             ).astype(np.float32)}}


def _close(got, want, what):
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=what)


PAIRS = {
    "scale": (lambda o: o.scale(0.5)),
    "scale_by_schedule": (lambda o: o.optimizers.scale_by_schedule(
        o.warmup_cosine(0.1, 2, 6))),
    "clip_by_global_norm": (lambda o: o.clip_by_global_norm(1.0)),
    "scale_by_adam": (lambda o: o.scale_by_adam()),
    "add_decayed_weights": (lambda o: o.add_decayed_weights(0.1)),
    "chain": (lambda o: o.chain(o.clip_by_global_norm(5.0), o.scale(-0.1))),
    "sgd": (lambda o: o.sgd(0.1)),
    "sgd_momentum": (lambda o: o.sgd(0.1, momentum=0.9)),
    "adam": (lambda o: o.adam(0.05)),
    "adamw": (lambda o: o.adamw(0.05)),
    "adamw_schedule": (lambda o: o.adamw(o.warmup_cosine(0.05, 2, 6),
                                         weight_decay=0.1)),
    "adamw_cosine": (lambda o: o.adamw(o.cosine_schedule(0.05, 4),
                                       max_grad_norm=None)),
    "adam_8bit": (lambda o: o.adam_8bit(0.05)),
    "adam_8bit_schedule": (lambda o: o.adam_8bit(o.warmup_cosine(0.05, 2, 6),
                                                 max_grad_norm=None)),
    "kwta_sparsify": (lambda o: o.kwta_sparsify(o.adam(0.05), keep_frac=0.5,
                                                min_size=4)),
    "compression": (lambda o: o.topk_compress_error_feedback(
        o.adam(0.05), keep_frac=0.25, min_size=4)),
}


@pytest.mark.parametrize("name", list(PAIRS))
def test_transform_matches_reference(name):
    """Six steps of ``update`` + ``apply_updates``: updates, params and
    state leaf for leaf."""
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    jopt, topt = PAIRS[name](joptim), PAIRS[name](optim)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = tree_map(torch.from_numpy, p0)
    js, ts = jopt.init(jp), topt.init(tp)
    _close(ts, js, f"{name}: init state")
    for step in range(6):
        g = _tree(rng, scale=3.0)       # large enough for the clip to act
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = topt.update(tree_map(torch.from_numpy, g), ts, tp)
        _close(tu, ju, f"{name}: updates at step {step}")
        _close(ts, js, f"{name}: state at step {step}")
        jp, tp = joptim.apply_updates(jp, ju), optim.apply_updates(tp, tu)
        _close(tp, jp, f"{name}: params at step {step}")


def test_adam_state_lives_on_the_params_device_with_an_int32_count():
    p = tree_map(torch.from_numpy, _tree(np.random.default_rng(1)))
    state = optim.adamw(optim.warmup_cosine(0.1, 2, 10)).init(p)
    clip, adam, decay, sched = state
    assert clip == () and decay == ()
    assert adam.count.dtype == torch.int32 and adam.count.shape == ()
    assert sched.dtype == torch.int32
    assert all(t.dtype == torch.float32 and t.device == p["w"].device
               for t in tree_leaves((adam.mu, adam.nu)))


@pytest.mark.parametrize("which", ["cosine_schedule", "warmup_cosine"])
def test_schedules_match_reference(which):
    make = {"cosine_schedule": lambda o: o.cosine_schedule(2.0, 50),
            "warmup_cosine": lambda o: o.warmup_cosine(1.0, 10, 100)}[which]
    js, ts = make(joptim), make(optim)
    for step in range(0, 121, 3):
        want = js(jnp.asarray(step, jnp.int32))
        got = ts(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL,
                                   atol=ATOL)


def test_bf16_grads_clip_in_fp32_as_jax_promotes():
    """JAX multiplies a bf16 gradient by the fp32 clip factor in fp32; the
    port promotes the same way instead of keeping bf16."""
    g = {"a": np.linspace(-40, 40, 64, dtype=np.float32).reshape(8, 8)}
    ju, _ = joptim.clip_by_global_norm(1.0).update(
        {"a": jnp.asarray(g["a"]).astype(jnp.bfloat16)}, ())
    tu, _ = optim.clip_by_global_norm(1.0).update(
        {"a": torch.from_numpy(g["a"]).to(torch.bfloat16)}, ())
    assert tu["a"].dtype == torch.float32 and ju["a"].dtype == jnp.float32
    np.testing.assert_allclose(tu["a"].numpy(), np.asarray(ju["a"]),
                               rtol=RTOL, atol=ATOL)


def test_adam_8bit_state_is_int8_with_fp32_scales_on_the_params_device():
    """As ``tests/test_optim.py::test_adam_8bit_state_is_int8``: the codes
    keep the parameter's rank, the last dim padded to the 128 block; the
    scales are fp32, one a block; a 0-d parameter takes (1,)."""
    from repro_torch.optim.qstate import Adam8bitState
    params = {"w": torch.zeros((300, 256)), "b": torch.zeros((130,)),
              "s": torch.zeros(())}
    state = optim.adam_8bit(0.01).init(params)
    adam = next(s for s in state if isinstance(s, Adam8bitState))
    assert adam.count.dtype == torch.int32 and adam.count.shape == ()
    for m in (adam.mu, adam.nu):
        assert m["w"].codes.dtype == torch.int8
        assert m["w"].codes.shape == (300, 256)
        assert m["w"].scales.shape == (300, 2)
        assert m["w"].scales.dtype == torch.float32
        assert m["b"].codes.shape == (256,) and m["b"].scales.shape == (2,)
        assert m["s"].codes.shape == (128,) and m["s"].scales.shape == (1,)
        assert all(t.device == params["w"].device
                   for t in tree_leaves(m))


def test_adam_8bit_codes_and_scales_equal_the_reference():
    """``scale_by_adam_8bit`` over eight steps of the same gradients (a
    last dim off the block, a 0-d leaf, a stacked 3-d one): every int8
    code and fp32 scale of both moments equal to the reference's, bit for
    bit; the updates at rtol 1e-6."""
    from repro.optim import qstate as jqstate
    from repro_torch.optim import qstate
    rng = np.random.default_rng(3)
    p0 = {"w": rng.normal(0, 1, (8, 200)).astype(np.float32),
          "s": np.float32(0.3),
          "layers": {"u": rng.normal(0, 1, (3, 4, 130)).astype(np.float32)}}
    jopt, topt = jqstate.scale_by_adam_8bit(), qstate.scale_by_adam_8bit()
    js = jopt.init(jax.tree.map(jnp.asarray, p0))
    ts = topt.init(tree_map(torch.tensor, p0))
    for step in range(8):
        g = jax.tree.map(lambda a: (3 * rng.normal(0, 1, np.shape(a))
                                    ).astype(np.float32), p0)
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js)
        tu, ts = topt.update(tree_map(torch.tensor, g), ts)
        want, got = jax.tree.leaves(js), tree_leaves(ts)
        assert len(want) == len(got) == 13
        for w, t in zip(want, got):
            w = np.asarray(w)
            assert t.dtype == {np.int8: torch.int8, np.float32: torch.float32,
                               np.int32: torch.int32}[w.dtype.type]
            assert np.array_equal(t.numpy(), w), f"step {step}"
        _close(tu, ju, f"updates at step {step}")


def test_adam_8bit_tracks_fp32_adam():
    """As ``tests/test_optim.py::test_adam_8bit_tracks_fp32_adam``: 60
    steps of each on the quadratic problem end in the same basin."""
    params, loss_fn = _quad_problem(dim=8)
    out = {}
    for name, opt in (("fp32", optim.adam(0.05)),
                      ("8bit", optim.adam_8bit(0.05, weight_decay=0.0,
                                               max_grad_norm=None))):
        p, state = params, opt.init(params)
        for _ in range(60):
            q = tree_map(lambda t: t.detach().requires_grad_(), p)
            g = dict(zip(q, torch.autograd.grad(loss_fn(q),
                                                list(q.values()))))
            u, state = opt.update(g, state, p)
            p = optim.apply_updates(p, u)
        out[name] = float(loss_fn(p))
    assert abs(out["8bit"] - out["fp32"]) < 0.1


def test_all_matches_reference():
    assert optim.__all__ == joptim.__all__


# ---------------------------------------------------------------------------
# tests/test_optim.py's behaviour, for the port
# ---------------------------------------------------------------------------

def _quad_problem(seed=0, dim=16):
    target = torch.from_numpy(np.random.default_rng(seed).normal(
        0, 1, (dim, dim)).astype(np.float32))
    params = {"w": torch.zeros((dim, dim)), "b": torch.zeros((dim,))}

    def loss_fn(p):
        return torch.mean((p["w"] - target) ** 2) + torch.mean(p["b"] ** 2)

    return params, loss_fn


@pytest.mark.parametrize("make_opt", [
    lambda: optim.sgd(0.1, momentum=0.9),
    lambda: optim.adam(0.05),
    lambda: optim.adamw(0.05, weight_decay=0.0),
    lambda: optim.adam_8bit(0.05, weight_decay=0.0),
    lambda: optim.kwta_sparsify(optim.adam(0.05), keep_frac=0.5,
                                min_size=4),
    lambda: optim.topk_compress_error_feedback(optim.adam(0.05),
                                               keep_frac=0.25, min_size=4),
])
def test_optimizers_converge(make_opt):
    params, loss_fn = _quad_problem()
    opt = make_opt()
    state = opt.init(params)
    l0 = float(loss_fn(params))
    for _ in range(150):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = loss_fn(p)
        g = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        u, state = opt.update(g, state, params)
        params = optim.apply_updates(params, u)
    assert float(loss.detach()) < 0.2 * l0


def test_clip_by_global_norm():
    opt = optim.clip_by_global_norm(1.0)
    g = {"a": torch.full((4,), 100.0)}
    u, _ = opt.update(g, opt.init(g))
    assert float(torch.linalg.norm(u["a"])) == pytest.approx(1.0, rel=1e-4)
    g_small = {"a": torch.full((4,), 0.01)}
    u, _ = opt.update(g_small, ())
    np.testing.assert_allclose(u["a"].numpy(), g_small["a"].numpy(),
                               rtol=1e-5)


def test_kwta_sparsify_masks_updates():
    opt = optim.kwta_sparsify(optim.sgd(1.0), keep_frac=0.25, min_size=4)
    g = {"w": torch.arange(1.0, 17.0).reshape(4, 4)}
    u, _ = opt.update(g, opt.init(g), g)
    assert int((u["w"] != 0).sum()) == 4       # 25 % of 16
    assert int(write_masks(u)["w"].sum()) == 4


def test_error_feedback_accumulates():
    """Dropped gradient mass reappears via the residual (unbiased), over
    16 rounds, with the reference's residual at every round."""
    opt = optim.topk_compress_error_feedback(optim.scale(-1.0),
                                             keep_frac=0.5, min_size=0)
    jopt = joptim.topk_compress_error_feedback(joptim.scale(-1.0),
                                               keep_frac=0.5, min_size=0)
    g = np.array([[4.0, 1.0], [3.0, 2.0]], np.float32)
    state, jstate = opt.init({"w": torch.from_numpy(g)}), \
        jopt.init({"w": jnp.asarray(g)})
    rounds, sent_total = 16, torch.zeros((2, 2))
    for _ in range(rounds):
        u, state = opt.update({"w": torch.from_numpy(g)}, state)
        ju, jstate = jopt.update({"w": jnp.asarray(g)}, jstate)
        sent_total = sent_total + (-u["w"])
        _close(state, jstate, "error-feedback state")
    np.testing.assert_allclose(sent_total.numpy() / rounds, g, rtol=0.4)


def test_schedules():
    s = optim.warmup_cosine(1.0, 10, 100)
    at = lambda f, n: float(f(torch.tensor(n, dtype=torch.int32)))
    assert at(s, 0) == 0.0
    assert at(s, 10) == pytest.approx(1.0, rel=1e-3)
    assert at(s, 100) <= 0.06
    assert at(optim.cosine_schedule(2.0, 50), 0) == pytest.approx(2.0)
