"""The port's public surface against the reference's, name by name, and
the names ported to close the gap, each against the reference.

Every ``.py`` file of ``src/repro`` is read with ``ast``: its top-level
public names (functions, classes, assignments) and, in an
``__init__.py``, the names it imports. Each must have a counterpart in
the port's module of the same path (an attribute of the module; in an
``__init__.py``, a name that the port's ``__init__.py`` binds), or stand
in one of two lists: :data:`TRIMS`, names with no torch meaning, each
with its reason, and :data:`TO_PORT`, the ROADMAP items still queued,
with the names and files they will bring. A name in either list that the
port has after all fails too, so the lists stay true.
"""
import ast
import dataclasses
import importlib
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import utils as jutils  # noqa: E402
from repro.analog import adc as jadc  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.scenarios import build_scenario as jbuild_scenario  # noqa: E402
from repro_torch import configs, prng, utils  # noqa: E402
from repro_torch.analog import adc  # noqa: E402
from repro_torch.backends import get_backend  # noqa: E402
from repro_torch.core import miru as miru_mod  # noqa: E402
from repro_torch.core.miru import MiRUConfig, init_miru_params  # noqa: E402
from repro_torch.data.synthetic import make_permuted_tasks  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention, blocks  # noqa: E402
from repro_torch.scenarios import build_scenario  # noqa: E402

# repro.core re-exports names over some of its module names.
jcontinual = importlib.import_module("repro.core.continual")
jmiru = importlib.import_module("repro.core.miru")
continual = importlib.import_module("repro_torch.core.continual")

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"

#: Reference names with no torch meaning: (file, name) → reason.
TRIMS = {
    ("utils.py", "cpu_device"): "JAX's host device handle; torch names "
                                "its CPU torch.device('cpu')",
    ("utils.py", "PyTree"): "a typing alias of JAX's pytrees; the port "
                            "types its dict trees where it needs to",
    ("backends/base.py", "PyTree"): "as utils.PyTree",
    ("kernels/ops.py", "pad_wbs_weights"): "pads weights to the Pallas "
                                           "kernel's blocks; the CUDA "
                                           "kernel takes any shape",
    ("kernels/wbs_matmul.py", "wbs_matmul_pallas"): "the Pallas entry "
        "point; its CUDA counterpart is kernels/wbs_matmul.py "
        ":: wbs_matmul",
    ("kernels/wbs_miru_scan.py", "wbs_miru_scan_pallas"): "the Pallas "
        "entry point; its CUDA counterpart is :: wbs_miru_scan",
    ("kernels/miru_scan.py", "miru_scan_pallas"): "the Pallas entry "
        "point; its CUDA counterpart is :: miru_scan",
    ("kernels/kwta.py", "kwta_pallas"): "the Pallas entry point; its CUDA "
                                        "counterpart is :: kwta",
    ("kernels/flash_attention.py", "flash_attention_fwd_pallas"): "the "
        "Pallas entry point; its CUDA counterparts are the forward "
        "wrappers of kernels/flash_attention.py",
    ("kernels/flash_attention.py", "flash_attention_bwd_pallas"): "the "
        "Pallas entry point; its CUDA counterparts are the dq and dk/dv "
        "wrappers",
    ("kernels/flash_attention.py", "NEG_INF"): "the Pallas kernels' "
        "masked score; the port's lives beside its plain versions "
        "(kernels/ref.py :: NEG_INF) and in the CUDA sources",
    ("launch/hlo_analysis.py", "parse_module"): "parses XLA's HLO text; "
        "the port counts the program it dispatches (a TorchDispatchMode)",
    ("launch/hlo_analysis.py", "Instr"): "an HLO instruction of the "
        "parsed text; as parse_module",
    ("launch/hlo_analysis.py", "Computation"): "an HLO computation of the "
        "parsed text; as parse_module",
}

#: ROADMAP queue A items still to port: item → reference names
#: ((file, name)) and whole files (file, None) it brings.
TO_PORT: dict = {}

_QUEUED = {entry for entries in TO_PORT.values() for entry in entries}


def public_names(path: Path) -> set[str]:
    """Top-level public names of a file; in an ``__init__.py`` also the
    names its imports bind."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)) and \
                path.name == "__init__.py":
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return {n for n in names if not n.startswith("_") and n != "annotations"}


def _port_names(rel: str) -> set[str]:
    path = PORT / rel
    if path.name == "__init__.py":
        return public_names(path)
    module = importlib.import_module(
        "repro_torch." + rel[:-3].replace("/", "."))
    return {n for n in dir(module) if not n.startswith("_")}


REF_FILES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


@pytest.mark.parametrize("rel", REF_FILES)
def test_each_reference_name_has_a_port_counterpart(rel):
    if (rel, None) in _QUEUED:
        assert not (PORT / rel).exists(), f"{rel} is ported: unqueue it"
        return
    assert (PORT / rel).exists(), f"{rel} has no counterpart in the port"
    have = _port_names(rel)
    missing = sorted(n for n in public_names(REF / rel) - have
                     if (rel, n) not in TRIMS and (rel, n) not in _QUEUED)
    assert not missing, f"{rel}: no port counterpart for {missing}"


def test_trims_and_queued_names_are_missing_from_the_port():
    for rel, name in list(TRIMS) + [e for e in _QUEUED if e[1]]:
        assert name in public_names(REF / rel), (rel, name)
        assert name not in _port_names(rel), \
            f"{rel} :: {name} is in the port: take it off its list"


# ---------------------------------------------------------------------------
# The names ported with this surface, against the reference
# ---------------------------------------------------------------------------

def test_hold_droop_below_paper_budget():
    """Eqs. 8-10; the paper's < 10.5 µV over 200 ns
    (``tests/test_analog.py::test_hold_droop_below_paper_budget``)."""
    assert adc.total_hold_droop() < 10.5e-6
    assert adc.total_hold_droop() == jadc.total_hold_droop()
    args = dict(v_int=0.7, t_conv=150e-9, c_f=3e-12, i_b=20e-12,
                r_leak=5e9)
    assert adc.total_hold_droop(**args) == jadc.total_hold_droop(**args)
    assert adc.droop_leakage(0.5, 2e-7, 1e10, 2e-12) == \
        jadc.droop_leakage(0.5, 2e-7, 1e10, 2e-12)
    assert adc.droop_bias(5e-11, 2e-7, 2e-12) == \
        jadc.droop_bias(5e-11, 2e-7, 2e-12)
    for t in (1e-9, 2e-7, 5e-6):
        assert adc.integrator_droop(0.5, t, 1e-3) == \
            jadc.integrator_droop(0.5, t, 1e-3)


def test_param_count_vs_gru():
    """The compactness claim (``tests/test_miru.py::test_param_count_vs_gru``):
    MiRU drops the two gates' weight sets."""
    cfg = MiRUConfig(n_x=28, n_h=100, n_y=10)
    miru_n = miru_mod.miru_param_count(cfg)
    gru_n = miru_mod.gru_param_count(28, 100, 10)
    core_miru = 28 * 100 + 100 * 100 + 100
    assert gru_n - miru_n == 3 * core_miru - core_miru
    assert miru_n == core_miru + 100 * 10 + 10
    assert miru_n == jmiru.miru_param_count(jmiru.MiRUConfig(28, 100, 10))
    assert gru_n == jmiru.gru_param_count(28, 100, 10)
    params = init_miru_params(prng.PRNGKey(0), cfg, "cpu")
    assert miru_n == utils.count_params(params)


@pytest.mark.parametrize("backend", ["wbs", "ideal", "analog"])
def test_device_vmm_and_quantize_inputs(backend):
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (6, 20)).astype(np.float32)
    w = rng.normal(0, 0.3, (20, 12)).astype(np.float32)
    got = ops.device_vmm(torch.from_numpy(x), torch.from_numpy(w), backend)
    want = jops.device_vmm(jnp.asarray(x), jnp.asarray(w), backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=1e-5)
    inst = get_backend(backend, spec_overrides=dict(input_bits=6))
    np.testing.assert_array_equal(
        ops.device_vmm(torch.from_numpy(x), torch.from_numpy(w), inst),
        inst.device_vmm(torch.from_numpy(x), torch.from_numpy(w)))
    for n_bits in (4, 8):
        sign, code = ops.quantize_inputs(torch.from_numpy(x), n_bits)
        jsign, jcode = jops.quantize_inputs(jnp.asarray(x), n_bits)
        np.testing.assert_array_equal(sign.numpy(), np.asarray(jsign))
        np.testing.assert_array_equal(code.numpy(), np.asarray(jcode))


def test_evaluate_tasks_is_an_r_row():
    """One row of R: the accuracy of each task seen so far, from the
    run's own ``evaluate``, as the reference's on the same params."""
    cfg = MiRUConfig(n_x=8, n_h=16, n_y=10)
    jcfg = jmiru.MiRUConfig(n_x=8, n_h=16, n_y=10)
    tasks = make_permuted_tasks(0, n_tasks=3, n_train=16, n_test=40, side=8)
    trainer = continual.TrainerSpec(algo="dfa")
    params = init_miru_params(prng.PRNGKey(0), cfg, "cpu")
    jparams = jmiru.init_miru_params(jax.random.PRNGKey(0), jcfg)
    _, evaluate, _ = continual._make_raw_steps(cfg, trainer,
                                               get_backend("ideal"))
    from repro.backends import get_backend as jget_backend
    _, jevaluate, _ = jcontinual._make_raw_steps(
        jcfg, jcontinual.TrainerSpec(algo="dfa"), jget_backend("ideal"))
    key = prng.PRNGKey(5)
    accs = continual.evaluate_tasks(evaluate, params, key, tasks, upto=1)
    assert accs.shape == (2,)
    direct = [float(evaluate(params, key, torch.from_numpy(t.x_test),
                             torch.from_numpy(t.y_test), None))
              for t in tasks[:2]]
    np.testing.assert_array_equal(accs, direct)
    jaccs = jcontinual.evaluate_tasks(jevaluate, jparams,
                                      jax.random.PRNGKey(5), tasks, 1)
    np.testing.assert_allclose(accs, jaccs, atol=1.5 / 40)


def test_hw_miru_forward_is_the_analog_forward_and_warns():
    ccfg = continual.ContinualConfig(trainer="dfa_hw")
    cfg = MiRUConfig(n_x=8, n_h=16, n_y=10)
    params = init_miru_params(prng.PRNGKey(0), cfg, "cpu")
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (4, 5, 8)).astype(np.float32))
    with pytest.warns(DeprecationWarning, match="miru_forward_device"):
        got, _ = continual.hw_miru_forward(params, cfg, x,
                                           prng.PRNGKey(3), ccfg)
    _, _, backend = ccfg.specs()
    want, _ = continual.miru_forward_device(params, cfg, x,
                                            prng.PRNGKey(3), backend)
    assert backend.name == "analog"
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jspec = jcontinual.ContinualConfig(trainer="dfa_hw").specs()[2].spec
    assert dataclasses.asdict(backend.spec) == dataclasses.asdict(jspec)


def test_golden_schedule_digest_is_the_references_constant():
    """The constant verbatim; the port's schedule is held to the live
    reference's digest (the reference's own golden test fails under
    jax 0.9)."""
    assert continual.GOLDEN_PERMUTED_SCHEDULE_SHA256 == \
        jcontinual.GOLDEN_PERMUTED_SCHEDULE_SHA256
    kw = dict(seed=0, n_tasks=2, n_train=64, n_test=16)
    got = continual.build_batch_schedule(
        continual.TrainerSpec(algo="dfa", epochs_per_task=1, seed=0),
        continual.ReplaySpec(capacity=32), build_scenario("permuted", **kw))
    want = jcontinual.build_batch_schedule(
        jcontinual.TrainerSpec(algo="dfa", epochs_per_task=1, seed=0),
        jcontinual.ReplaySpec(capacity=32),
        jbuild_scenario("permuted", **kw))
    assert got.digest() == want.digest()


def test_tree_helpers_onehot_and_count_params():
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": {"c": rng.normal(size=(5,)).astype(np.float32),
                  "d": rng.normal(size=(2, 2)).astype(np.float32)}}
    other = jax.tree.map(lambda a: a * 2 + 1, tree)
    t = jax.tree.map(torch.from_numpy, tree)
    o = jax.tree.map(torch.from_numpy, other)
    j = jax.tree.map(jnp.asarray, tree)
    jo = jax.tree.map(jnp.asarray, other)

    def same(got, want):
        for g, w in zip(utils.tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=1e-6, atol=0)
    same(utils.tree_add(t, o), jutils.tree_add(j, jo))
    same(utils.tree_scale(t, 0.3), jutils.tree_scale(j, 0.3))
    same(utils.tree_zeros_like(t), jutils.tree_zeros_like(j))
    np.testing.assert_allclose(float(utils.tree_global_norm(t)),
                               float(jutils.tree_global_norm(j)), rtol=1e-6)
    bf = utils.tree_cast(t, torch.bfloat16)
    assert all(x.dtype == torch.bfloat16 for x in utils.tree_leaves(bf))
    assert utils.tree_bytes(bf) == jutils.tree_bytes(
        jutils.tree_cast(j, jnp.bfloat16)) == 2 * (12 + 5 + 4)
    assert utils.tree_bytes(t) == jutils.tree_bytes(j)
    assert utils.count_params(t) == jutils.count_params(j) == 21
    labels = np.array([[0, 3], [9, -1]], np.int32)
    for n in (4, 10):
        np.testing.assert_array_equal(
            utils.onehot(torch.from_numpy(labels), n).numpy(),
            np.asarray(jutils.onehot(jnp.asarray(labels), n)))


def test_init_moe_and_neg_inf():
    cfg = configs.get_smoke_config("granite-moe-3b-a800m")
    from repro import configs as jconfigs
    jcfg = jconfigs.get_smoke_config("granite-moe-3b-a800m")
    got = blocks.init_moe(prng.PRNGKey(4), cfg, "cpu")
    want = jblocks.init_moe(jax.random.PRNGKey(4), jcfg)
    for g, w in zip(utils.tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.to(torch.float32).numpy(),
                                   np.asarray(w, np.float32), rtol=1e-5,
                                   atol=1e-6)
    assert attention.NEG_INF == jattention.NEG_INF
