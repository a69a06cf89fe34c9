"""The dispatch-level analysis (``repro_torch.launch.hlo_analysis``), the
kernels' work (``kernels/work.py``), the roofline and the report, against
the reference's ``repro.launch`` where the reference has a counterpart.

On the CPU: the reference's HLO fixture re-cut as torch code on a fake
world of 4, rank 0 against the whole program on a fake (2, 2) mesh, the
port's count of a step against the reference's HLO analysis of the same
step, the kernel events of a flash prefill on ``meta``, ``model_flops``
for every arch × shape, and the roofline and report tables on the same
synthetic records.
"""
import contextlib
import dataclasses
import functools
import json

import pytest
import torch
import torch.distributed as dist

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.launch import hlo_analysis as jhlo  # noqa: E402
from repro.launch import make_report as jmake_report  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.kernels import ops, work  # noqa: E402
from repro_torch.launch import hlo_analysis, make_report, roofline  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.utils import tree_size  # noqa: E402


@contextlib.contextmanager
def fake_world(n: int):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# (a) The reference's fixture as torch code
# ---------------------------------------------------------------------------

def test_fixture_flops_collectives_and_bytes():
    """6 iterations of (8, 4) @ (4, 4) and an all-reduce, then an
    all-gather of a (4, 4) block to (16, 4), on a fake world of 4
    (``tests/test_hlo_analysis.py``'s module, with the loop unrolled by
    eager dispatch)."""
    import torch.distributed._functional_collectives as funcol

    x0, w = torch.ones(8, 4), torch.ones(4, 4)
    with fake_world(4):
        group = dist.group.WORLD
        with hlo_analysis.count() as a:
            x = x0
            for _ in range(6):
                x = funcol.all_reduce(x @ w, "sum", group)
            g = funcol.all_gather_single(x[:4], 0, group).wait()
            assert tuple(g.shape) == (16, 4)
    # dot: 2 · 8·4 out · 4 contracted = 256 FLOPs, six times.
    assert a.flops == 256 * 6
    assert a.per_collective["all-reduce"] == {"count": 6, "bytes": 128 * 6}
    assert a.per_collective["all-gather"] == {"count": 1, "bytes": 256}
    assert a.collective_bytes == 128 * 6 + 256
    # Each iteration writes the product (128 B) and the all-reduce's
    # output (128 B); then the all-gather (256 B). The slice is a view.
    assert a.bytes_accessed == 6 * (128 + 128) + 256
    d = a.as_dict()
    assert set(d) == {"flops", "bytes_accessed", "collective_bytes",
                      "per_collective", "top_shapes", "kernels"}
    assert {e["op_shape"]: e["bytes"] for e in d["top_shapes"]} == {
        "aten.mm f32[8,4]": 768.0,
        "_c10d_functional.all_reduce f32[8,4]": 768.0,
        "_c10d_functional.all_gather_into_tensor f32[16,4]": 256.0}


def test_views_inplace_updates_and_live_bytes():
    buf = torch.zeros(4, 16, 8)
    with hlo_analysis.count(args=(buf,)) as a:
        v = buf.view(4, 128).t()             # views: nothing
        del v
        row = torch.ones(4, 1, 8)            # 128 B
        buf[:, 3:4].copy_(row)               # the rows written: 128 B
        buf.index_copy_(1, torch.tensor([5]), row)   # the update: 128 B
        # (a tensor made from data dispatches no op)
        tmp = buf * 2                        # 2,048 B, live then freed
        del tmp
    assert a.bytes_accessed == 128 + 128 + 128 + 2048
    assert a.argument_bytes == 2048
    assert a.peak_bytes == 2048 + 128 + 2048
    assert a.live_bytes == 2048 + 128           # ``row`` is still held


# ---------------------------------------------------------------------------
# (b) Rank 0 against the whole program
# ---------------------------------------------------------------------------

def test_rank_counts_its_share_of_the_gemms():
    """The smoke qwen2-0.5b prefill (full attention) on a fake (2, 2)
    mesh with FSDP: rank 0's FLOPs × 4 are the unsharded program's,
    exactly. The FLOPs are the GEMMs' (no kernel runs at S ≤ chunk), and
    every GEMM splits over the 4 ranks: the projections and the MLP by
    batch × (sequence or hidden), the attention by batch × queries, the
    tied head by batch × vocab; none is replicated, so none is left
    out."""
    from repro_torch.distributed import (ShardingContext, batch_specs,
                                         param_specs, sharding_scope)
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh

    cfg = configs.get_smoke_config("qwen2-0.5b")
    B, S = 4, 16
    tokens = torch.zeros((B, S), dtype=torch.int32, device="meta")
    pshapes = lm.param_shapes(cfg)
    with hlo_analysis.count() as whole:
        lm.prefill(pshapes, cfg, {"tokens": tokens})
    with fake_world(4):
        mesh = make_host_mesh(2, device_type="cpu")
        params = dryrun._local_meta(pshapes, param_specs(cfg, pshapes, mesh),
                                    mesh)
        batch = {"tokens": tokens}
        batch = dryrun._local_meta(batch, batch_specs(batch, mesh, False),
                                   mesh)
        with sharding_scope(ShardingContext(mesh=mesh)), \
                hlo_analysis.count() as rank:
            lm.prefill(params, cfg, batch)
    assert whole.flops > 0 and not whole.kernels
    assert 4 * rank.flops == whole.flops
    assert rank.per_collective["all-gather"]["count"] > 0


# ---------------------------------------------------------------------------
# (c) Against the reference's analysis of the same step
# ---------------------------------------------------------------------------

def _jax_params(cfg_name):
    from repro.configs import get_smoke_config
    from repro.models import lm as jlm
    jcfg = get_smoke_config(cfg_name)
    return jcfg, jlm, jlm.init_params(jax.random.PRNGKey(0), jcfg)


def test_prefill_flops_match_the_reference_hlo():
    """The smoke internlm2-1.8b prefill at S ≤ chunk (full attention on
    both sides): the dispatched GEMMs' FLOPs within 1 % of the
    reference's dots."""
    jcfg, jlm, jparams = _jax_params("internlm2-1.8b")
    B, S = 2, 16
    jb = {"tokens": jnp.ones((B, S), jnp.int32)}
    hlo = jax.jit(lambda p: jlm.prefill(p, jcfg, jb)).lower(
        jparams).compile().as_text()
    want = jhlo.analyze(hlo).flops
    cfg = configs.get_smoke_config("internlm2-1.8b")
    assert S <= cfg.attn_chunk
    a = hlo_analysis.analyze(
        lm.prefill, lm.param_shapes(cfg), cfg,
        {"tokens": torch.ones((B, S), dtype=torch.int32, device="meta")})
    assert a.kernels == {}
    assert abs(a.flops / want - 1) < 0.01, (a.flops, want)


def test_train_flops_against_six_n_d_and_the_reference():
    """The smoke train step (loss and gradients, remat on): FLOPs within
    [0.8, 4.0] × 6·N·D as ``test_real_module_sanity`` asserts, and within
    1 % of the reference's HLO count of the same step: both recompute
    each layer's forward once in the backward (remat: ``checkpoint``
    here, ``jax.checkpoint`` there) and both take full attention at S
    16, so the same GEMMs run on each side."""
    jcfg, jlm, jparams = _jax_params("internlm2-1.8b")
    B, S = 2, 16
    jb = {"tokens": jnp.ones((B, S), jnp.int32),
          "labels": jnp.ones((B, S), jnp.int32),
          "mask": jnp.ones((B, S), jnp.float32)}
    hlo = jax.jit(lambda p: jax.value_and_grad(
        lambda q: jlm.loss_fn(q, jcfg, jb))(p)).lower(
        jparams).compile().as_text()
    want = jhlo.analyze(hlo).flops
    cfg = configs.get_smoke_config("internlm2-1.8b")
    params = lm.param_shapes(cfg)
    meta = lambda dt: torch.ones((B, S), dtype=dt, device="meta")
    batch = {"tokens": meta(torch.int32), "labels": meta(torch.int32),
             "mask": meta(torch.float32)}
    from repro_torch.launch.dryrun import value_and_grad
    a = hlo_analysis.analyze(value_and_grad, cfg, params, batch)
    model = 6 * tree_size(params) * B * S
    assert 0.8 * model < a.flops < 4.0 * model, (a.flops, model)
    assert abs(a.flops / want - 1) < 0.01, (a.flops, want)
    assert a.bytes_accessed > 0


# ---------------------------------------------------------------------------
# (d) Kernel events
# ---------------------------------------------------------------------------

def _flash_cfg():
    return dataclasses.replace(configs.get_smoke_config("qwen2-0.5b"),
                               attn_chunk=16)


def test_flash_prefill_counts_one_event_a_layer_and_not_its_body():
    """A prefill past the chunk takes the flash kernel: on ``meta`` one
    ``flash_attention_fwd`` event a layer with ``work.flash_fwd``'s work
    and no plain version run; on the CPU, which runs the plain version
    inside the wrapper, the same counts to the byte."""
    cfg = _flash_cfg()
    B, S = 2, 64
    tokens = torch.zeros((B, S), dtype=torch.int32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops.ref, "flash_attention_fwd_ref",
                   lambda *a, **k: pytest.fail("the plain version ran"))
        meta = hlo_analysis.analyze(lm.prefill, lm.param_shapes(cfg), cfg,
                                    {"tokens": tokens.to("meta")})
    w = work.flash_fwd(B, cfg.n_heads, cfg.n_kv_heads, S, S, cfg.hd(),
                       cfg.hd(), True, 4)
    assert meta.kernels == {"flash_attention_fwd": {
        "count": cfg.n_layers, "flops": cfg.n_layers * w.flops,
        "bytes": cfg.n_layers * w.bytes}}
    params = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    # Once before counting, each device's cached rope frequencies made.
    lm.prefill(params, cfg, {"tokens": tokens})
    cpu = hlo_analysis.analyze(lm.prefill, params, cfg, {"tokens": tokens})
    meta = hlo_analysis.analyze(lm.prefill, lm.param_shapes(cfg), cfg,
                                {"tokens": tokens.to("meta")})
    assert cpu.as_dict() == meta.as_dict()
    rec = {"shape": "x", "hlo_analysis": meta.as_dict()}
    assert roofline.attention_score_bytes(rec, kv_len=S) == 0


def test_decode_scores_are_found():
    """A decode takes ``full_attention`` over the cache: its score
    buffers (…, cache length) are what ``attention_score_bytes``
    finds."""
    cfg = _flash_cfg()
    B, L = 2, 512
    caches = lm.init_cache(cfg, B, L, device="meta")
    a = hlo_analysis.analyze(
        lm.decode_step, lm.param_shapes(cfg), cfg, caches,
        torch.zeros((B, 1), dtype=torch.int32, device="meta"),
        torch.zeros((), dtype=torch.int32, device="meta"))
    rec = {"shape": "x", "hlo_analysis": a.as_dict()}
    got = roofline.attention_score_bytes(rec, kv_len=L)
    scores = [e for e in a.as_dict()["top_shapes"]
              if e["op_shape"].endswith(f",{L}]")
              and e["op_shape"].count(",") >= 3]
    assert got > 0 and got == sum(e["bytes"] for e in scores)


@pytest.mark.parametrize("kind", ["matmul", "read_noise", "scan", "miru",
                                  "readout", "kwta", "bwd"])
def test_each_wrapper_reports_its_kernel(kind):
    """Every wrapper that launches a kernel reports one event with its
    work, on ``meta`` without running its plain version, and outputs of
    the plain version's shapes."""
    import numpy as np
    m = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device="meta")
    c = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt)
    calls = {
        "matmul": (lambda t: ops.wbs_matmul(t(6, 5, dt=torch.int8),
                                            t(6, 5, dt=torch.uint8),
                                            t(5, 3), t(8)),
                   "wbs_matmul", work.wbs_matmul(6, 5, 3, 8)),
        "read_noise": (lambda t: ops.wbs_matmul(
            t(6, 5, dt=torch.int8), t(6, 5, dt=torch.uint8), t(5, 3), t(8),
            read_sigma=0.1, read_key=np.asarray([0, 1], np.uint32)),
            "wbs_matmul_read_noise", work.wbs_matmul(6, 5, 3, 8,
                                                     read_noise=True)),
        "scan": (lambda t: ops.wbs_miru_scan(t(2, 3, 4), t(4, 4), t(4),
                                             beta=0.5, lam=0.5, n_bits=8),
                 "wbs_miru_scan", work.wbs_miru_scan(2, 3, 4, 8)),
        "miru": (lambda t: ops.miru_scan(t(2, 3, 4), t(4, 4), t(2, 4),
                                         0.5, 0.5),
                 "miru_scan", work.miru_scan(2, 3, 4)),
        "readout": (lambda t: ops.miru_readout(t(2, 3, 4), t(4, 5), t(5)),
                    "miru_readout", work.miru_readout(6, 4, 5)),
        "kwta": (lambda t: ops.kwta(t(3, 10), 4), "kwta",
                 work.kwta(3, 10, 32, 4)),
        "bwd": (lambda t: ops.flash_attention_bwd(
            t(1, 8, 4, 8), t(1, 8, 2, 8), t(1, 8, 2, 8), t(1, 8, 4, 8),
            t(1, 4, 8), t(1, 8, 4, 8)), "flash_attention_bwd_dq",
            work.flash_bwd_dq(1, 4, 2, 8, 8, 8, 8, True, 4)),
    }
    fn, name, w = calls[kind]
    with torch.no_grad():
        want = fn(c)
        with hlo_analysis.count() as a:
            got = fn(m)
    assert a.kernels[name] == {"count": 1, "flops": w.flops + w.flops64,
                               "bytes": w.bytes}
    assert a.flops == sum(k["flops"] for k in a.kernels.values())
    flat = lambda o: o if isinstance(o, tuple) else (o,)
    assert [(t.shape, t.dtype) for t in flat(got)] == \
        [(t.shape, t.dtype) for t in flat(want)]
    assert all(t.is_meta for t in flat(got))


# ---------------------------------------------------------------------------
# (e) model_flops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", configs.list_archs())
def test_model_flops_are_the_references(arch):
    for shape in SHAPES:
        assert roofline.model_flops(arch, shape) == \
            jroofline.model_flops(arch, shape)


# ---------------------------------------------------------------------------
# (f) Roofline and report tables on the same synthetic records
# ---------------------------------------------------------------------------

def _records() -> list:
    """Synthetic records of both meshes and tags: ok cells of every kind,
    a skip and a failure."""
    out = []
    for i, (arch, shape) in enumerate([
            ("qwen2-0.5b", "train_4k"), ("qwen2-0.5b", "decode_32k"),
            ("mamba2-370m", "long_500k"), ("deepseek-v3-671b", "train_4k"),
            ("granite-moe-3b-a800m", "prefill_32k")]):
        for mesh, chips in (("16x16", 256), ("2x16x16", 512)):
            for tag in ("", "opt"):
                k = 1 + i + (tag == "opt")
                out.append({
                    "arch": arch, "shape": shape, "mesh": mesh,
                    "chips": chips, "tag": tag, "ok": True,
                    "trace_s": 1.5 * k, "compile_s": 1.5 * k,
                    "torch_version": "2.13.0",
                    "reshard_costs": "dtensor" if mesh == "16x16"
                    else "mesh_dim",
                    "memory_analysis": {
                        "argument_size_in_bytes": 3e9 * k,
                        "output_size_in_bytes": 1e9,
                        "temp_size_in_bytes": 7e9 / k},
                    "hlo_analysis": {
                        "flops": 1e14 * k, "bytes_accessed": 3e11 / k,
                        "collective_bytes": 5e9 * k,
                        "per_collective": {
                            "all-gather": {"count": 10.0 * k,
                                           "bytes": 4e9 * k},
                            "all-reduce": {"count": 3.0, "bytes": 1e9 * k}},
                        "top_shapes": [{"op_shape": "aten.mm bf16[8,4]",
                                        "bytes": 1e9}]}})
    out.append({"arch": "yi-34b", "shape": "long_500k", "mesh": "16x16",
                "skipped": "pure full-attention arch", "ok": True, "tag": ""})
    out.append({"arch": "yi-34b", "shape": "train_4k", "mesh": "16x16",
                "ok": False, "error": "RuntimeError: planted", "tag": ""})
    return out


def _write(recs, d):
    for r in recs:
        suffix = f"-{r['tag']}" if r["tag"] else ""
        (d / f"{r['arch']}--{r['shape']}--{r['mesh']}{suffix}.json"
         ).write_text(json.dumps(r))


def _point_at(mp, mod_roof, mod_report, d):
    load = functools.partial(mod_roof.load_record, out_dir=d)
    summ = lambda mesh="16x16", tag="", flash_adjust=False: \
        mod_roof.summarize(mesh, tag, d, flash_adjust)
    mp.setattr(mod_report, "load_record", load)
    mp.setattr(mod_report, "summarize", summ)


def test_roofline_and_report_equal_the_references(tmp_path, monkeypatch):
    recs = _records()
    _write(recs, tmp_path)
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(jroofline, name, getattr(roofline, name))
    for r in recs:
        got = roofline.roofline_from_record(r)
        want = jroofline.roofline_from_record(r)
        assert (got is None) == (want is None)
        if got is not None:
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.row() == want.row()
    for mesh in ("16x16", "2x16x16"):
        for tag in ("", "opt"):
            for adj in (False, True):
                assert [dataclasses.asdict(r) for r in roofline.summarize(
                    mesh, tag, tmp_path, adj)] == [
                    dataclasses.asdict(r) for r in jroofline.summarize(
                        mesh, tag, tmp_path, adj)]
    _point_at(monkeypatch, roofline, make_report, tmp_path)
    _point_at(monkeypatch, jroofline, jmake_report, tmp_path)
    for mesh in ("16x16", "2x16x16"):
        for tag in ("", "opt"):
            # The one column that differs: the port's trace seconds where
            # the reference has its compile seconds.
            assert make_report.dryrun_table(mesh, tag) == \
                jmake_report.dryrun_table(mesh, tag).replace(
                    "| compile s |", "| trace s |")
            for adj in (False, True):
                assert make_report.roofline_table(mesh, tag, adj) == \
                    jmake_report.roofline_table(mesh, tag, adj)
    # ... and the header of the adjusted column, the port's flash kernel
    # being no Pallas kernel.
    assert make_report.perf_compare_table() == \
        jmake_report.perf_compare_table().replace("+pallas-flash", "+flash")
    assert "| OK |" in make_report.dryrun_table("16x16")
    assert "**FAIL**" in make_report.dryrun_table("16x16")


@pytest.mark.parametrize("field, value, mesh, tag", [
    ("torch_version", "2.11.0", "16x16", ""),
    ("torch_version", "2.11.0", "16x16", "opt"),
    ("reshard_costs", "dtensor", "2x16x16", "")])
def test_report_refuses_records_of_two_programs(tmp_path, monkeypatch,
                                                field, value, mesh, tag):
    """One record traced by another torch release, or priced otherwise
    on its mesh: each table that reads it with the others raises, and
    ``main`` names the program of records that agree."""
    recs = _records()
    _write(recs, tmp_path)
    _point_at(monkeypatch, roofline, make_report, tmp_path)
    assert make_report.provenance(("16x16", ""), ("2x16x16", ""),
                                  ("16x16", "opt")) == {
        "torch": "2.13.0", "reshard_costs": {"16x16": "dtensor",
                                             "2x16x16": "mesh_dim"}}
    odd = next(r for r in recs if r["mesh"] == mesh and r["tag"] == tag
               and r["arch"] == "qwen2-0.5b" and r["shape"] == "train_4k")
    _write([dict(odd, **{field: value})], tmp_path)
    with pytest.raises(ValueError, match="mix programs"):
        make_report.dryrun_table(mesh, tag)
    with pytest.raises(ValueError, match="mix programs"):
        make_report.roofline_table(mesh, tag)
    if mesh == "16x16":
        with pytest.raises(ValueError, match="mix programs"):
            make_report.perf_compare_table()
    with pytest.raises(ValueError, match="mix programs"):
        make_report.main()
