"""The port's sharded paths (``distributed/``, the expert-parallel MoE,
Ulysses attention and SSD, elastic restore) on gloo meshes of spawned
CPU processes (``testing.Ranks``; what each rank runs is in
``_torch_dist_cases.py``), each held both to the port's call with no
context and to the reference on the same numpy inputs and parameters.

- EP MoE on a (4, 2) mesh (8 ranks), the reference's
  ``tests/test_moe_ep.py`` cases: granite's smoke config with (4
  experts, top 2) in exchange mode and (3, 2) in replicated mode at
  capacity factor 8, with and without sequence parallelism, equal to the
  reference's global ``moe_ffn``, and so are the gradients in x, the
  banks and the router; at capacity factor 1.0, where slots drop, equal
  to the reference's ``_moe_ffn_ep`` run in a JAX subprocess on 8 forced
  host devices, and unequal to the global path.
- Ulysses GQA, MLA and the SSD (one and two groups), the gathered
  fallback (3 heads), gathered GQA and its cross-attention, on (1, 2)
  and (2, 2) meshes, with the gradients of GQA (Ulysses and gathered)
  and of the SSD; the qwen2, granite, mamba2 and deepseek smoke prefills
  on (2, 2) with parameters placed by ``param_specs`` under (gather,
  global) and (ulysses, ep); qwen2's with ``quant_mode="wbs"`` and with
  the miru mixer under (gather, global) on (1, 2), which run those parts
  on whole tensors.
- Elastic restore on a one-rank mesh and, as P("data", None), on two.

Tolerances. Against the call with no context: values at fp32
tolerance, rtol 2e-5 / atol 1e-6 (a sharded product sums its shards'
parts in another order); gradients and whole prefills' logits at rtol
2e-5 with atol 1e-6 of the largest magnitude (a parameter's gradient
sums over the batch and sequence, in another order on each mesh; a
logit's error is absolute at the scale of the largest products, up to
1.2e-6 measured on deepseek's logits of up to 3.3), the SSD's gradients
at atol 5e-5 of the largest (``SSD_GRAD_ATOL``). Against the reference:
the tolerances at which the module tests hold the plain port to it
(``REF_TOL``, ``REF_GRAD_TOL``). The restored rows are exact.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import _torch_dist_cases as cases  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.testing import Ranks  # noqa: E402

RTOL, ATOL = 2e-5, 1e-6
#: The port's tolerances against the reference, as its module tests hold
#: the plain port: (rtol, atol) of a mixer's output by kind and of the
#: logits; of the gradients, (rtol, atol as a share of the largest).
REF_TOL = {"gqa": (2e-5, 2e-6), "cross": (2e-5, 2e-6), "mla": (2e-5, 1e-6),
           "ssd": (1e-5, 1e-5), "lm": (1e-5, 1e-5)}
REF_GRAD_TOL = {"moe": (1e-5, 1e-6), "gqa": (1e-5, 1e-6),
                "ssd": (1e-5, 5e-5)}
#: The SSD's a_log gradient sums its decay terms over the batch, the
#: sequence and the head dim with cancellation: on (2, 2) it moved by
#: 2.5e-6 (1.7e-5 of the largest) against the call with no context, and
#: the plain port's by 2.7e-6 against the reference (measured).
SSD_GRAD_ATOL = 5e-5
ROOT = Path(__file__).resolve().parents[1]
NAME = "granite-moe-3b-a800m"
#: (case, n_experts, top_k, capacity_factor, sequence_parallel) of the
#: EP runs.
EP_CASES = (("exchange", 4, 2, 8.0, True), ("replicated", 3, 2, 8.0, True),
            ("exchange_no_sp", 4, 2, 8.0, False),
            ("replicated_no_sp", 3, 2, 8.0, False),
            ("drops", 4, 2, 1.0, True))
EP_NO_DROPS = [c[0] for c in EP_CASES if c[0] != "drops"]
PREFILL_NAMES = ("qwen2-0.5b", "granite-moe-3b-a800m", "mamba2-370m",
                 "deepseek-v3-671b")
ULYSSES_CASES = tuple(cases.ULYSSES)
GRAD_CASES = tuple(k for k, v in cases.ULYSSES.items() if v[4])
MESHES = {"1x2": (2, 2), "2x2": (4, 2)}        # name → (world, model)
BATCH, SEQ, CHUNK = 2, 32, 16


def _jcfg(E, K, cf):
    return dataclasses.replace(jconfigs.get_smoke_config(NAME),
                               n_experts=E, top_k=K, capacity_factor=cf)


def _jtree(tree):
    """A port parameter tree as the reference's: jnp arrays, same bits."""
    if isinstance(tree, dict):
        return {k: _jtree(v) for k, v in tree.items()}
    return jnp.asarray(tree.detach().numpy())


def _reference_grads(fn, jp, x, g, names):
    """The gradients of Σ fn(params, x)·g in x and ``names``."""
    def loss(x, ws):
        return jnp.sum(fn({**jp, **ws}, x) * g)

    gx, gw = jax.grad(loss, argnums=(0, 1))(x, {n: jp[n] for n in names})
    return {"x": np.asarray(gx), **{n: np.asarray(gw[n]) for n in names}}


def _reference_mixers():
    """{case: (output, {name: gradient})}: the reference's mixer of each
    Ulysses case on the port's parameters and inputs of that case."""
    fns = {"gqa": jattn.gqa_attention, "mla": jattn.mla_attention}
    out = {}
    for name, (cfg, p, x, g) in cases.ulysses_inputs(BATCH, SEQ).items():
        arch, overrides, _, kind, grad_of = cases.ULYSSES[name]
        jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                                   **overrides)
        pos = jnp.arange(SEQ)

        def fn(p_, x_):
            if kind == "ssd":
                return jssm.mamba2_forward(p_, jcfg, x_)
            if kind == "cross":
                return jattn.gqa_attention(p_, jcfg, x_, pos, kv=(x_,))
            return fns[kind](p_, jcfg, x_, pos)

        fn = jax.jit(fn)
        jp, jx = _jtree(p), jnp.asarray(x.numpy())
        grads = _reference_grads(fn, jp, jx, jnp.asarray(g.numpy()),
                                 grad_of) if grad_of else {}
        out[name] = (np.asarray(fn(jp, jx)), grads)
    return out


def _reference_prefills():
    """{label: logits}: the reference's prefill of each whole-prefill
    model on the port's parameters and tokens."""
    models = [(n, n, {}) for n in PREFILL_NAMES] + list(cases.GATHERED)
    out = {}
    for label, arch, overrides in models:
        _, p, tokens = cases.prefill_inputs(arch, overrides, BATCH, SEQ,
                                            CHUNK)
        jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                                   **cases.prefill_overrides(overrides,
                                                             CHUNK))
        out[label] = np.asarray(jlm.prefill(
            _jtree(p), jcfg, {"tokens": jnp.asarray(tokens.numpy())}))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every group of ranks started at once, beside the JAX subprocess
    of the reference's EP at capacity 1.0: {"ep": (ranks' results, the
    reference's global outputs, its EP output), "two": ..., "four":
    ...}. "two" runs Ulysses on (1, 2), then the restore onto (2, 1);
    "four" Ulysses on (2, 2), then the four smoke prefills; "one" the
    restore onto one rank."""
    d = tmp_path_factory.mktemp("ranks")
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (8, 16, 32)).astype(np.float32)
    g = rng.normal(0, 1, x.shape).astype(np.float32)
    params, jps = {}, {}
    for name, E, K, cf, _ in EP_CASES:
        jps[name] = jmoe.init_moe_params(jax.random.PRNGKey(0),
                                         _jcfg(E, K, cf))
        params[name] = {k: np.asarray(v) for k, v in jps[name].items()}
    np.savez(d / "drops.npz", x=x, **params["drops"])
    ref = _start_reference_ep(d / "drops.npz", d / "ref_ep.npy")
    groups = {
        "ep": Ranks(cases.moe_ep, 8, d / "ep",
                    [c + (params[c[0]],) for c in EP_CASES], x, g,
                    timeout=300),
        "two": Ranks(cases.ulysses_and_restore, 2, d / "two", 2, BATCH,
                     SEQ, str(d / "ck"), timeout=300),
        "four": Ranks(cases.ulysses_and_prefills, 4, d / "four", 2, BATCH,
                      SEQ, PREFILL_NAMES, SEQ, timeout=300),
        "one": Ranks(cases.restore, 1, d / "one", str(d / "ck1"), 1,
                     timeout=300)}
    try:
        # The reference on the same inputs, while the ranks run.
        want = {}
        for name, E, K, cf, _ in EP_CASES:
            jcfg, jx = _jcfg(E, K, cf), jnp.asarray(x)
            want[name] = (np.asarray(jmoe.moe_ffn(jps[name], jcfg, jx)),
                          _reference_grads(
                              lambda p_, x_: jmoe.moe_ffn(p_, jcfg, x_),
                              jps[name], jx, jnp.asarray(g),
                              ("w_gate", "w_up", "w_down", "router")))
        reference = {"mixers": _reference_mixers(),
                     "prefills": _reference_prefills()}
        out = {k: r.result() for k, r in groups.items()}
    finally:
        log, _ = ref.communicate(timeout=300)
    assert ref.returncode == 0, log
    out["ep"] = (out["ep"], want, np.load(d / "ref_ep.npy"))
    out["reference"] = reference
    return out


REFERENCE_EP = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_smoke_config
    from repro.distributed import ShardingContext, sharding_scope
    from repro.models import moe as moe_mod

    inp = np.load(sys.argv[1])
    cfg = dataclasses.replace(get_smoke_config("granite-moe-3b-a800m"),
                              n_experts=4, top_k=2, capacity_factor=1.0)
    p = {k: jnp.asarray(inp[k]) for k in ("router", "w_gate", "w_up",
                                          "w_down")}
    mesh = jax.make_mesh((4, 2), ("data", "model"))
    ctx = ShardingContext(mesh=mesh, batch_axes=("data",),
                          sequence_parallel=True, moe_mode="ep")
    sh = NamedSharding(mesh, P("data", "model", None))
    with sharding_scope(ctx):
        y = jax.jit(lambda p_, x_: moe_mod._moe_ffn_ep(p_, cfg, x_, ctx),
                    in_shardings=(None, sh), out_shardings=sh)(
            p, jnp.asarray(inp["x"]))
    np.save(sys.argv[2], np.asarray(y))
""")


def _start_reference_ep(inputs: Path, output: Path) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-c", REFERENCE_EP,
                             str(inputs), str(output)], env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _close_to_scale(got: np.ndarray, want: np.ndarray, what: str,
                    tol: tuple = (RTOL, ATOL)) -> None:
    np.testing.assert_allclose(got, want, rtol=tol[0],
                               atol=tol[1] * float(np.abs(want).max()),
                               err_msg=what)


# ---------------------------------------------------------------------------
# Expert-parallel MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", EP_NO_DROPS)
def test_ep_equals_the_reference_global_path(runs, case):
    got, want, _ = runs["ep"]
    r = got[case]
    np.testing.assert_allclose(r["ep"], want[case][0], rtol=RTOL, atol=ATOL)
    # At capacity 8 nothing drops: EP is the global path's function.
    np.testing.assert_allclose(r["ep"], r["plain"], rtol=RTOL, atol=ATOL)
    if case.startswith("exchange"):   # 2 all-to-alls, 3 bank gathers
        assert r["collectives"]["all_to_all"] == 2
        assert r["collectives"]["all_gather"] == 3
        assert r["specs"]["w_gate"] == ("model", "data", None)
    else:                       # every expert on every rank
        assert r["collectives"]["all_to_all"] == 0
        assert r["collectives"]["all_gather"] == 0
        assert r["specs"]["w_gate"] == (None, None, None)


def test_ep_with_drops_equals_the_reference_ep_path(runs):
    got, want, ref_ep = runs["ep"]
    r = got["drops"]
    np.testing.assert_allclose(r["ep"], ref_ep, rtol=RTOL, atol=ATOL)
    # Each rank's capacity drops other slots than the global one does.
    assert np.abs(r["ep"] - want["drops"][0]).max() > 1e-2
    assert np.abs(r["ep"] - r["plain"]).max() > 1e-2


@pytest.mark.parametrize("case", EP_NO_DROPS)
def test_ep_gradients_equal_the_plain_and_the_reference_ones(runs, case):
    """Without sequence parallelism too, where both ranks of the model
    axis route the same tokens and each token reaches its expert's owner
    from both: the gradients count it once."""
    got, want, _ = runs["ep"]
    grads = got[case]["grads"]
    assert set(grads) == {"x", "w_gate", "w_up", "w_down", "router"}
    for what, (g1, g0) in grads.items():
        _close_to_scale(g1, g0, f"{case}: d/d{what}")
        _close_to_scale(g1, want[case][1][what],
                        f"{case}: d/d{what} against the reference",
                        REF_GRAD_TOL["moe"])


# ---------------------------------------------------------------------------
# Ulysses, the gathered fallback, MLA and SSD
# ---------------------------------------------------------------------------

def _ulysses(runs, mesh):
    return runs["two" if mesh == "1x2" else "four"]["ulysses"]


@pytest.mark.parametrize("case", ULYSSES_CASES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_mixer_equals_the_plain_one(runs, mesh, case):
    y1, y0, _, counts = _ulysses(runs, mesh)[case]
    assert y1.shape == y0.shape
    np.testing.assert_allclose(y1, y0, rtol=RTOL, atol=ATOL)
    rtol, atol = REF_TOL[cases.ULYSSES[case][3]]
    np.testing.assert_allclose(y1, runs["reference"]["mixers"][case][0],
                               rtol=rtol, atol=atol)
    if case in ("gqa_seq", "ssd", "ssd_groups"):
        # x (or q, k, v) came in sequence-sharded: a seq → heads reshard.
        assert counts["reshard_all_to_all"] >= 1
    if case.startswith("ssd"):
        # The conv ran on sequence shards, the rows before each gathered.
        assert counts["all_gather"] >= 1


@pytest.mark.parametrize("case", GRAD_CASES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_mixer_gradients_equal_the_plain_and_reference_ones(
        runs, mesh, case):
    grads = _ulysses(runs, mesh)[case][2]
    want = runs["reference"]["mixers"][case][1]
    assert set(grads) == {"x", *cases.ULYSSES[case][4]} == set(want)
    kind = cases.ULYSSES[case][3]
    for what, (g1, g0) in grads.items():
        _close_to_scale(g1, g0, f"{case}: d/d{what}",
                        (RTOL, SSD_GRAD_ATOL if kind == "ssd" else ATOL))
        _close_to_scale(g1, want[what],
                        f"{case}: d/d{what} against the reference",
                        REF_GRAD_TOL[kind])


# ---------------------------------------------------------------------------
# Whole prefills on (2, 2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("modes", cases.MODES, ids="-".join)
@pytest.mark.parametrize("name", PREFILL_NAMES)
def test_prefill_under_a_context_equals_the_plain_one(runs, name, modes):
    got, want, counts = runs["four"]["prefills"][(name,) + modes]
    assert got.shape == want.shape == (2, 32, 128)
    # atol 1e-6 of the largest logit: deepseek's smoke logits reach 3.3,
    # and its sharded products' reordered sums move a logit near 3e-4 by
    # up to 1.2e-6 (measured), 5 ulp of the largest.
    _close_to_scale(got, want, name)
    np.testing.assert_allclose(got, runs["reference"]["prefills"][name],
                               rtol=REF_TOL["lm"][0], atol=REF_TOL["lm"][1])
    moe = name in ("granite-moe-3b-a800m", "deepseek-v3-671b")
    assert (counts["all_to_all"] > 0) == (moe and modes[1] == "ep")


@pytest.mark.parametrize("label", [g[0] for g in cases.GATHERED])
def test_quantized_and_miru_prefills_gather_and_equal_the_plain_ones(
        runs, label):
    got, want, counts = runs["two"]["prefills"][(label,) + cases.MODES[0]]
    assert got.shape == want.shape == (2, 32, 128)
    _close_to_scale(got, want, label)
    np.testing.assert_allclose(got, runs["reference"]["prefills"][label],
                               rtol=REF_TOL["lm"][0], atol=REF_TOL["lm"][1])


# ---------------------------------------------------------------------------
# Elastic restore
# ---------------------------------------------------------------------------

def test_elastic_restore_onto_one_rank(runs):
    """The counterpart of the reference's
    ``test_train.py::test_checkpoint_elastic_reshard``."""
    r = runs["one"]
    # A mesh dim of one rank holds the whole dim: Replicate().
    assert r["placements"] == "(Replicate(), Replicate())"
    np.testing.assert_array_equal(r["full"].reshape(-1), np.arange(16.0))
    np.testing.assert_array_equal(r["locals"][0], r["full"])
    np.testing.assert_array_equal(r["b"], np.arange(3))
    assert r["b_type"] == "Tensor"


def test_elastic_restore_onto_two_ranks_places_their_rows(runs):
    r = runs["two"]["restore"]
    assert r["placements"] == "(Shard(dim=0), Replicate())"
    rows = np.arange(16.0).reshape(4, 4)
    np.testing.assert_array_equal(r["locals"][0], rows[:2])
    np.testing.assert_array_equal(r["locals"][1], rows[2:])
    np.testing.assert_array_equal(r["full"], rows)
