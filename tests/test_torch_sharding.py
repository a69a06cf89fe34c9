"""The port's sharding rules (``distributed/sharding.py``), its
``ShardingContext.spec`` and its production mesh, against the reference's.

The reference's ``tests/test_sharding.py`` does not collect under jax
0.9 (it builds ``AbstractMesh`` with the older signature). Its rules run
given ``AbstractMesh((16, 16), ("data", "model"))`` and ``AbstractMesh(
(2, 16, 16), ("pod", "data", "model"))``, and so do the port's, which
read only ``mesh.shape[name]``. Every spec is compared leaf by leaf as a
tuple, exactly:

- ``param_specs`` of every arch (the reference's ``lm.param_shapes``
  against the port's ``meta`` tree), with ``fsdp`` and
  ``replicate_small_banks`` each on and off;
- ``batch_specs`` at every train and prefill shape, ``cache_specs`` at
  every decode shape an arch runs, ``opt_state_specs`` of the ``adamw``
  and ``adam_8bit`` states of every arch;
- ``ShardingContext.spec`` for its eight kinds.

The reference's own cases are repeated here by name. ``to_placements``
and ``make_production_mesh`` are held on torch's fake process group at
world 256 and 512 (no process, no communication).
"""
import contextlib
import functools

import pytest
import torch
import torch.distributed as dist

jax = pytest.importorskip("jax")
from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.distributed import context as jcontext  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs, optim  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.distributed import ShardingContext  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.sharding import P, to_placements  # noqa: E402
from repro_torch.launch.mesh import (make_host_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import lm  # noqa: E402

MESHES = {"16x16": AbstractMesh((16, 16), ("data", "model")),
          "2x16x16": AbstractMesh((2, 16, 16), ("pod", "data", "model"))}
ARCHS = configs.list_archs()
OPTIMIZERS = {"adamw": (joptim.adamw, optim.adamw),
              "adam_8bit": (joptim.adam_8bit, optim.adam_8bit)}
KINDS = ("btd", "bt", "btv", "bshd", "bshd_full", "bsh", "bshd_seq",
         "bs__")


@functools.lru_cache(maxsize=None)
def _param_shapes(name: str):
    """(the reference's ShapeDtypeStruct tree, the port's meta tree)."""
    return (jlm.param_shapes(jconfigs.get_config(name)),
            lm.param_shapes(configs.get_config(name)))


@functools.lru_cache(maxsize=None)
def _opt_shapes(name: str, opt: str):
    jp, tp = _param_shapes(name)
    jopt, topt = OPTIMIZERS[opt]
    return jax.eval_shape(jopt(1e-4).init, jp), topt(1e-4).init(tp)


def _flat(module, tree) -> dict:
    return {path: tuple(spec) for path, spec in module._flatten(tree)}


def _same(jtree, ttree) -> None:
    want, got = _flat(jsharding, jtree), _flat(sharding, ttree)
    assert got == want, {k: (got.get(k), want.get(k))
                         for k in set(got) | set(want)
                         if got.get(k) != want.get(k)}


def _pod(mesh_name: str) -> bool:
    return mesh_name == "2x16x16"


# ---------------------------------------------------------------------------
# The rules, leaf by leaf
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rsb", [False, True], ids=["tp_banks", "rep_banks"])
@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "tp_only"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_specs_equal_the_reference(mesh, arch, fsdp, rsb):
    jp, tp = _param_shapes(arch)
    m = MESHES[mesh]
    _same(jsharding.param_specs(jconfigs.get_config(arch), jp, m, fsdp=fsdp,
                                replicate_small_banks=rsb),
          sharding.param_specs(configs.get_config(arch), tp, m, fsdp=fsdp,
                               replicate_small_banks=rsb))


@pytest.mark.parametrize("shape", [n for n, s in shapes.SHAPES.items()
                                   if s.kind in ("train", "prefill")])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_specs_equal_the_reference(mesh, arch, shape):
    want = jshapes.input_specs(jconfigs.get_config(arch), shape)
    got = shapes.input_specs(configs.get_config(arch), shape)
    _same(jsharding.batch_specs(want, MESHES[mesh], _pod(mesh)),
          sharding.batch_specs(got, MESHES[mesh], _pod(mesh)))


DECODES = [(a, n) for a in ARCHS for n, s in shapes.SHAPES.items()
           if s.kind == "decode"
           and shapes.skip_reason(configs.get_config(a), n) is None]


@pytest.mark.parametrize("arch,shape", DECODES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_cache_specs_equal_the_reference(mesh, arch, shape):
    want = jshapes.input_specs(jconfigs.get_config(arch), shape)["caches"]
    got = shapes.input_specs(configs.get_config(arch), shape)["caches"]
    _same(jsharding.cache_specs(want, MESHES[mesh], _pod(mesh)),
          sharding.cache_specs(got, MESHES[mesh], _pod(mesh)))


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_opt_state_specs_equal_the_reference(mesh, arch, opt):
    jp, tp = _param_shapes(arch)
    jo, to = _opt_shapes(arch, opt)
    m = MESHES[mesh]
    _same(jsharding.opt_state_specs(
              jo, jsharding.param_specs(jconfigs.get_config(arch), jp, m), m),
          sharding.opt_state_specs(
              to, sharding.param_specs(configs.get_config(arch), tp, m), m))


@pytest.mark.parametrize("sp", [True, False], ids=["sp", "no_sp"])
@pytest.mark.parametrize("batch_axes", [("data",), ("pod", "data")],
                         ids=["data", "pod_data"])
@pytest.mark.parametrize("kind", KINDS)
def test_context_spec_equals_the_reference(kind, batch_axes, sp):
    mesh = MESHES["2x16x16"]
    want = jcontext.ShardingContext(mesh=mesh, batch_axes=batch_axes,
                                    sequence_parallel=sp).spec(kind)
    got = ShardingContext(mesh=mesh, batch_axes=batch_axes,
                          sequence_parallel=sp).spec(kind)
    assert isinstance(got, P) and got == tuple(want)


def test_context_refuses_an_unknown_kind():
    with pytest.raises(ValueError):
        ShardingContext(mesh=MESHES["16x16"]).spec("bsd")


# ---------------------------------------------------------------------------
# The reference's own cases (tests/test_sharding.py), by name
# ---------------------------------------------------------------------------

M16 = MESHES["16x16"]


def _specs(arch: str, **kw) -> dict:
    return sharding.param_specs(configs.get_config(arch),
                                _param_shapes(arch)[1], M16, **kw)


def test_dense_param_specs():
    specs = _specs("qwen3-4b")
    assert specs["embed"] == P("model", None)
    layer = specs["layers"]["mixer"]
    assert layer["wq"] == P(None, "data", "model")
    assert layer["wo"] == P(None, "model", "data")
    assert specs["layers"]["norm1"] == P(None, None)
    assert specs["final_norm"] == P(None)


def test_moe_expert_specs_ep_vs_replicate_fallback():
    moe = _specs("deepseek-v3-671b")["layers"]["ffn"]   # 256 | 16 → EP
    assert moe["w_gate"] == P(None, "model", "data", None)
    assert moe["w_down"] == P(None, "model", None, "data")
    # granite: 40 experts ∤ 16 — TP over F, or replicated 63 MB banks.
    assert _specs("granite-moe-3b-a800m")["layers"]["ffn"]["w_gate"] == \
        P(None, None, "data", "model")
    assert _specs("granite-moe-3b-a800m", replicate_small_banks=True)[
        "layers"]["ffn"]["w_gate"] == P(None, None, None, None)


def test_nondivisible_dims_replicate():
    assert _specs("seamless-m4t-medium")["embed"] == P(None, None)
    assert _specs("qwen2-0.5b")["embed"] == P("model", None)


def test_batch_and_cache_specs():
    cfg = configs.get_config("yi-34b")
    b = sharding.batch_specs(shapes.input_specs(cfg, "train_4k"), M16,
                             multi_pod=False)
    assert b["tokens"] == P("data", None)
    c = sharding.cache_specs(shapes.input_specs(cfg, "decode_32k")["caches"],
                             M16, multi_pod=False)
    # batch 128 = 16·8: over "data", and "model" does not divide 8.
    leaf = next(iter(sharding._flatten(c)))[1]
    assert leaf[1] == "data"


def test_cache_specs_batch1_uses_model_axis():
    cfg = configs.get_config("jamba-1.5-large-398b")
    c = sharding.cache_specs(shapes.input_specs(cfg, "long_500k")["caches"],
                             M16, multi_pod=False)
    assert any(any(a is not None for a in s)
               for _, s in sharding._flatten(c))


def test_opt_state_inherits_param_spec():
    cfg = configs.get_config("qwen2-0.5b")
    tp = _param_shapes("qwen2-0.5b")[1]
    ospecs = sharding.opt_state_specs(optim.adamw(1e-4).init(tp),
                                      sharding.param_specs(cfg, tp, M16),
                                      M16)
    assert any(s == P(None, "data", "model")
               for _, s in sharding._flatten(ospecs))


# ---------------------------------------------------------------------------
# Placements and the production mesh on the fake process group
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _fake_world(n: int):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _check_placements(spec: tuple, placements: tuple, names: tuple) -> None:
    """Mesh dim i shards tensor dim d exactly where spec[d] names it."""
    for i, (name, pl) in enumerate(zip(names, placements)):
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        if dims:
            assert pl == torch.distributed.tensor.Shard(dims[0]), (spec, i)
        else:
            assert pl.is_replicate(), (spec, i)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_production_mesh_and_placements_of_every_rule(mesh):
    world = 512 if _pod(mesh) else 256
    with _fake_world(world):
        m = make_production_mesh(multi_pod=_pod(mesh), device_type="cpu")
        assert tuple(m.mesh.shape) == tuple(MESHES[mesh].axis_sizes)
        assert m.mesh_dim_names == MESHES[mesh].axis_names
        assert sharding.mesh_shape(m) == dict(MESHES[mesh].shape)
        for arch in ARCHS:
            cfg = configs.get_config(arch)
            tp = _param_shapes(arch)[1]
            specs = sharding.param_specs(cfg, tp, m)
            assert _flat(sharding, specs) == _flat(
                sharding, sharding.param_specs(cfg, tp, MESHES[mesh]))
            trees = [specs, sharding.opt_state_specs(
                _opt_shapes(arch, "adam_8bit")[1], specs, m)]
            for name, s in shapes.SHAPES.items():
                if shapes.skip_reason(cfg, name) is None:
                    inp = shapes.input_specs(cfg, name)
                    trees.append(sharding.cache_specs(inp["caches"], m,
                                                      _pod(mesh))
                                 if "caches" in inp else
                                 sharding.batch_specs(inp, m, _pod(mesh)))
            for tree in trees:
                for _, spec in sharding._flatten(tree):
                    _check_placements(spec, to_placements(spec, m),
                                      m.mesh_dim_names)


@pytest.mark.parametrize("world", [8, 255, 257])
def test_production_mesh_refuses_another_world_size(world):
    with _fake_world(world):
        for multi_pod in (False, True):
            with pytest.raises(ValueError, match="ranks"):
                make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def test_host_mesh_and_an_out_of_order_tuple():
    with _fake_world(8):
        m = make_host_mesh(2, device_type="cpu")
        assert tuple(m.mesh.shape) == (4, 2)
        assert m.mesh_dim_names == ("data", "model")
        Shard = torch.distributed.tensor.Shard
        assert to_placements(P(("data", "model"), None), m) == (Shard(0),
                                                                Shard(0))
        assert to_placements(P(None, "model"), m)[1] == Shard(1)
        with pytest.raises(ValueError, match="order"):
            to_placements(P(("model", "data"), None), m)
