"""The dry run (``repro_torch.launch.dryrun``): one cell of each kind as
rank 0's program on the fake process group at the production meshes'
world sizes (256 and 512), with smoke configs and small shapes patched
in; the record's keys against the reference's, a skipped pair, a bad
``--quant`` failing before anything is traced, and a reshard counted as
the all-to-all a card's mesh runs. Published widths are the CLI's
(``python -m repro_torch.launch.dryrun --arch all --shape all``), not
these tests'.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from torch.distributed.tensor import _collective_utils

from repro_torch import configs, prng
from repro_torch.configs import shapes
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.models import lm
from repro_torch.testing import Ranks

# The reference's record keys (``repro/launch/dryrun.py :: lower_cell``)
# less its compiler's (lower_s, compile_s, cost_analysis, hlo_chars),
# plus the port's trace_s and the program's torch_version and
# reshard_costs.
COMMON = {"arch", "shape", "mesh", "chips", "kind", "n_params",
          "param_bytes", "seq_par", "remat", "tag", "fsdp", "quant_mode",
          "attn_mode", "moe_mode", "trace_s", "memory_analysis",
          "collectives", "hlo_analysis", "ok", "torch_version",
          "reshard_costs"}
KEYS = {"train": COMMON | {"optimizer", "opt_bytes"},
        "prefill": COMMON, "decode": COMMON | {"cache_bytes"}}

#: The logits' tolerance against the reference (``REF_TOL["lm"]`` of
#: ``test_torch_distributed.py``, as the module tests hold the plain port).
REF_LM_TOL = (1e-5, 1e-5)

SMALL = {"tiny_train": shapes.ShapeSpec("tiny_train", "train", 32, 32),
         "tiny_prefill": shapes.ShapeSpec("tiny_prefill", "prefill", 64, 32),
         "tiny_decode": shapes.ShapeSpec("tiny_decode", "decode", 64, 32)}


@pytest.fixture
def smoke(monkeypatch):
    cfgs = {a: configs.get_smoke_config(a)
            for a in ("qwen2-0.5b", "mamba2-370m")}
    monkeypatch.setattr(dryrun, "get_config", lambda name: cfgs[name])
    for name, spec in SMALL.items():
        monkeypatch.setitem(shapes.SHAPES, name, spec)
    return cfgs


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", list(SMALL))
def test_one_cell_of_each_kind(smoke, shape, multi_pod):
    arch = "mamba2-370m" if shape == "tiny_decode" else "qwen2-0.5b"
    rec = dryrun.run_cell(arch, shape, multi_pod, device_type="cpu")
    assert rec["ok"], rec.get("traceback")
    kind = SMALL[shape].kind
    assert set(rec) == KEYS[kind]
    assert rec["chips"] == (512 if multi_pod else 256)
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert rec["fsdp"] == (kind != "decode")
    assert rec["torch_version"] == torch.__version__
    # DTensor's own pricing on two mesh dims; on three, mesh dim by mesh
    # dim where this torch's own would search every path.
    assert rec["reshard_costs"] == ("mesh_dim" if multi_pod and hasattr(
        _collective_utils, "_compute_placement_transition_cost")
        else "dtensor")
    mem = rec["memory_analysis"]
    assert set(mem) == {"argument_size_in_bytes", "output_size_in_bytes",
                        "temp_size_in_bytes"}
    assert mem["argument_size_in_bytes"] > 0 and \
        mem["output_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] >= 0
    # This rank's shard of the inputs: no more than the whole.
    whole = rec["param_bytes"] + rec.get("opt_bytes", 0) \
        + rec.get("cache_bytes", 0)
    assert mem["argument_size_in_bytes"] <= whole + 2 ** 20
    h = rec["hlo_analysis"]
    assert h["flops"] > 0 and h["bytes_accessed"] > 0
    assert rec["collectives"] == {k: {"count": int(v["count"]),
                                      "bytes": int(v["bytes"])}
                                  for k, v in h["per_collective"].items()}
    if kind == "train":
        assert rec["optimizer"] == "adamw"
        assert h["per_collective"]["all-reduce"]["count"] > 0
    assert not dist.is_initialized()


def test_skipped_pair_and_bad_quant(smoke, monkeypatch):
    rec = dryrun.run_cell("qwen2-0.5b", "long_500k", False,
                          device_type="cpu")
    assert rec == {"arch": "qwen2-0.5b", "shape": "long_500k",
                   "mesh": "16x16", "ok": True,
                   "skipped": shapes.skip_reason(smoke["qwen2-0.5b"],
                                                 "long_500k")}
    monkeypatch.setattr(dryrun, "fake_group",
                        lambda world: pytest.fail("traced a bad --quant"))
    rec = dryrun.run_cell("qwen2-0.5b", "tiny_prefill", False,
                          quant="no-such-substrate", device_type="cpu")
    assert not rec["ok"] and "no-such-substrate" in rec["error"]


def test_cuda_mesh_without_a_card_raises(smoke):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda mesh builds")
    with pytest.raises(RuntimeError, match="device_type"):
        dryrun.lower_cell("qwen2-0.5b", "tiny_prefill", False)


def test_reshard_counts_the_cards_all_to_all():
    """A sequence → heads reshard on a CPU mesh: one all-to-all of this
    rank's output, as on a card's mesh (DTensor alone would gather)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_production_mesh

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        mesh = make_production_mesh(device_type="cpu")
        x = DTensor.from_local(
            torch.empty((2, 8, 32, 4), dtype=torch.bfloat16, device="meta"),
            mesh, (Shard(0), Shard(1)), run_check=False)
        with dryrun.alltoall_on_cpu_mesh(), hlo_analysis.count() as a:
            y = x.redistribute(mesh, (Shard(0), Shard(2)))
    finally:
        dist.destroy_process_group()
    assert tuple(y.to_local().shape) == (2, 128, 2, 4)
    assert dict(a.per_collective) == {
        "all-to-all": {"count": 1, "bytes": 2 * 128 * 2 * 4 * 2}}
    assert Replicate() not in y.placements


def test_decode_into_sequence_sharded_caches(tmp_path):
    """The decode's cache writes on DTensors (each rank writes the rows
    of its own sequence shard, ``context.write_rows_at``): four gloo
    ranks decoding the smoke qwen2-0.5b at batch 1, the caches sharded
    over their sequence, give the logits and caches of the reference's
    jitted ``decode_step`` on the same parameters, tokens and positions,
    at the tolerances ``test_torch_distributed.py`` holds the sharded
    paths to it (logits ``REF_TOL["lm"]``; the bf16 caches one bf16 ulp,
    as ``test_torch_lm.py`` holds the plain decode), and those of the
    same steps with no context at fp32 tolerance."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import _torch_dist_cases as cases
    from repro import configs as jconfigs
    from repro.models import lm as jlm

    positions = (0, 5, 9, 12)
    got = Ranks(cases.sharded_decode, 4, tmp_path / "ranks", "qwen2-0.5b",
                positions, timeout=200).result()
    cfg = configs.get_smoke_config("qwen2-0.5b")
    jcfg = jconfigs.get_smoke_config("qwen2-0.5b")
    p = lm.init_params(prng.PRNGKey(0), cfg, device="cpu")
    jp = _jtree(p)
    jstep = jax.jit(lambda p_, c_, t_, pos_: jlm.decode_step(
        p_, jcfg, c_, t_, pos_))
    caches = lm.init_cache(cfg, 1, 16, device="cpu")
    jcaches = jlm.init_cache(jcfg, 1, 16)
    for i, pos in enumerate(positions):
        tok = np.array([[3 + i]], dtype=np.int32)
        logits, caches = lm.decode_step(p, cfg, caches, torch.from_numpy(tok),
                                        torch.tensor(pos))
        want, jcaches = jstep(jp, jcaches, jnp.asarray(tok), jnp.int32(pos))
        np.testing.assert_allclose(got[0][i], np.asarray(want),
                                   rtol=REF_LM_TOL[0], atol=REF_LM_TOL[1])
        np.testing.assert_allclose(got[0][i], logits.numpy(), rtol=1e-5,
                                   atol=1e-6)
    assert set(got[1]) == set(caches) == set(jcaches)
    for k, v in caches.items():
        np.testing.assert_allclose(got[1][k],
                                   np.asarray(jcaches[k], np.float32),
                                   rtol=2 ** -7, atol=1e-6)
        np.testing.assert_allclose(got[1][k], v.float().numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert np.any(got[1][k] != 0)


def _jtree(tree):
    """A port parameter tree as the reference's: jnp arrays, same bits."""
    import jax.numpy as jnp

    if isinstance(tree, dict):
        return {k: _jtree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_jtree(v) for v in tree)
    return jnp.asarray(tree.detach().numpy())


@pytest.mark.parametrize("vocab_sharded", [False, True])
def test_loss_backward_keeps_the_logits_local(vocab_sharded):
    """The masked cross-entropy's gradient in DTensor logits (batch over
    "data"; the vocab over "model", or whole where it does not divide)
    allocates no tensor of the global logits' shape (autograd's gather
    backward made one, zero, on every rank), and on plain tensors it is
    autograd's gather gradient, bit for bit."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.distributed import ShardingContext, sharding_scope
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.utils import softmax_cross_entropy_masked as ce

    B, S, V = 8, 4, 4002 if vocab_sharded else 4001
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = make_host_mesh(2, device_type="cpu")
        vp = Shard(2) if vocab_sharded else Replicate()

        def dt(shape, local, dtype, placements):
            return DTensor.from_local(
                torch.empty(local, dtype=dtype, device="meta"), mesh,
                placements, run_check=False, shape=shape,
                stride=torch.empty(shape, device="meta").stride())
        logits = dt((B, S, V), (B // 2, S, V // 2 if vocab_sharded else V),
                    torch.float32, (Shard(0), vp)).requires_grad_()
        labels = dt((B, S), (B // 2, S), torch.int32, (Shard(0), Replicate()))
        mask = dt((B, S), (B // 2, S), torch.float32, (Shard(0), Replicate()))
        with sharding_scope(ShardingContext(mesh=mesh, batch_axes=("data",))),\
                hlo_analysis.count() as a:
            g, = torch.autograd.grad(ce(logits, labels, mask), logits)
    finally:
        dist.destroy_process_group()
    # DTensor may lay the gradient out otherwise, one rank's share all
    # the same.
    assert g.to_local().numel() == logits.to_local().numel()
    assert not [t for t in a.as_dict()["top_shapes"]
                if f"[{B},{S},{V}]" in t["op_shape"]]

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(0, 3, (3, 5, 17)).astype(np.float32))
    lab = torch.from_numpy(rng.integers(0, 17, (3, 5)))
    m = torch.from_numpy((rng.random((3, 5)) > 0.3).astype(np.float32))
    a_, b_ = x.clone().requires_grad_(), x.clone().requires_grad_()
    want = torch.logsumexp(a_, -1) - torch.gather(a_, -1, lab[..., None])[
        ..., 0]
    (torch.sum(want * m) / torch.sum(m)).backward()
    ce(b_, lab, m).backward()
    assert torch.equal(a_.grad, b_.grad)
