"""Multi-pod dry run: one rank's program of every (arch × shape × mesh)
cell, traced on ``meta`` tensors — counterpart of
``repro/launch/dryrun.py``.

The reference lowers and compiles each step for 512 placeholder host
devices and reads XLA's per-device program. The port runs rank 0's
program on torch's fake process group (``world_size`` 256, or 512 with
``--multi-pod``), which answers every collective without sending
anything:

  * the production mesh (``launch/mesh.py``) on that group;
  * parameters, optimizer state, batch and caches as DTensors over
    ``meta`` local shards (``DTensor.from_local``: rank 0's shard of each
    spec of ``distributed.sharding``), so nothing is allocated;
  * the step run once under its ``ShardingContext`` and the analysis of
    ``launch/hlo_analysis.py``: FLOPs, bytes and collectives of the local
    ops, each hand-written kernel's launch as one event, and the live
    storages' peak.

The decisions are the reference's: FSDP dropped for decode where the
tensor-parallel bytes fit 8 GB a chip, small MoE banks replicated under
EP except in decode, sequence parallelism off for decode, ``adam_8bit``
above 100 B parameters and AdamW otherwise, prefill logits ``btv`` (the
vocab replicated where it does not divide the model axis), the decode's
tokens over the batch axes where they divide.

The record has the reference's keys, with these differences:
  * ``trace_s`` (seconds to run the rank's program) replaces ``lower_s``
    and ``compile_s``;
  * ``hlo_analysis`` is ``hlo_analysis.Analysis.as_dict()`` (its
    ``kernels`` too) and ``collectives`` the :func:`collective_bytes` of
    its events;
  * there is no ``cost_analysis`` and no ``hlo_chars``;
  * ``torch_version`` and ``reshard_costs`` say which program was
    counted: DTensor picks its placements, and so the rank's program, by
    the torch release's sharding rules, and by how candidate reshards
    are priced ("dtensor", its own pricing, or "mesh_dim", below);
  * ``memory_analysis`` has ``argument_size_in_bytes`` (this rank's bytes
    of the step's inputs), ``output_size_in_bytes`` (of its outputs) and
    ``temp_size_in_bytes``: the peak of live bytes during the step less
    the arguments. Nothing is donated: the functional optimizer holds
    old and new trees at once, and the peak says so.

DTensor runs on ``meta`` locals everywhere; no ``FakeTensorMode`` is
needed. A sequence ↔ heads reshard counts as the all-to-all a card's
mesh runs, on a CPU mesh too (:func:`alltoall_on_cpu_mesh`). On the
(2, 16, 16) mesh candidate placements are priced mesh dim by mesh dim
(:func:`mesh_dim_reshard_costs`, ``--reshard-costs mesh_dim``, the
default) where this torch's own pricing searches every reshard path, so
that the run ends: DTensor may then choose other placements than it
would with its own pricing (``--reshard-costs dtensor``), and the
record says which priced it.

``device_type`` names the mesh's devices: "cuda" unless the caller asks
for another (the tests pass "cpu"); where it names "cuda" and no card is
present, the cell raises rather than switch.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all [--multi-pod]
  python -m repro_torch.launch.dryrun ... --device-type cpu   (no card)
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch import optim
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.shapes import SHAPES, input_specs, skip_reason
from repro_torch.distributed import (ShardingContext, batch_specs,
                                     cache_specs, opt_state_specs,
                                     param_specs, sharding_scope)
from repro_torch.distributed.sharding import P, to_placements
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import RESULTS_DIR
from repro_torch.models import lm
from repro_torch.utils import tree_bytes, tree_leaves, tree_map, tree_size


def collective_bytes(analysis: hlo_analysis.Analysis) -> dict:
    """Count and output bytes of each collective type the rank's program
    issued."""
    return {k: {"count": int(v["count"]), "bytes": int(v["bytes"])}
            for k, v in sorted(analysis.per_collective.items())}


def make_optimizer(cfg, n_params: int):
    """8-bit Adam moments for the ≥100 B configs, fp32 AdamW otherwise."""
    if n_params > 100e9:
        return optim.adam_8bit(3e-4), "adam_8bit"
    return optim.adamw(3e-4), "adamw"


@contextlib.contextmanager
def fake_group(world: int):
    """A fake process group of ``world`` ranks, this process rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already up; the dry run "
                           "needs its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def alltoall_on_cpu_mesh():
    """DTensor's sequence ↔ heads reshard as the all-to-all a card's mesh
    runs, on a CPU mesh too. On a CPU mesh DTensor swaps it for an
    all-gather and a chunk (gloo has no all-to-all), which would count
    the mesh dim's whole tensor; the fake group has one, so the dry run's
    counts do not depend on ``device_type``."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import placement_types as pt

    orig = pt.shard_dim_alltoall

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        group = funcol._resolve_group((mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, funcol._group_or_group_name(group))

    pt.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        pt.shard_dim_alltoall = orig


@contextlib.contextmanager
def mesh_dim_reshard_costs(mesh, enabled: bool = True):
    """On a mesh of more than two dims, DTensor's sharding propagation
    prices each candidate placement's reshard one mesh dim at a time
    (the transition cost of each dim's placement change), as it did
    before its planner searched every path through the placements: that
    search, forced wherever a candidate shards one tensor dim over mesh
    dims out of order, takes minutes an op on the (2, 16, 16) mesh. Only
    the choice among candidates reads these costs; the reshards run as
    DTensor plans them. Where this torch has no such pricing (older
    releases price dim by dim already), on a mesh of two dims or where
    not ``enabled``, nothing changes. Yields the pricing in force:
    "mesh_dim" or "dtensor"."""
    import torch.distributed.tensor._collective_utils as cu
    import torch.distributed.tensor._ops.utils as ou
    from torch.distributed.tensor import placement_types

    step = getattr(cu, "_compute_placement_transition_cost", None)
    if not enabled or mesh.ndim <= 2 or step is None or \
            getattr(ou, "redistribute_cost", None) is not cu.redistribute_cost:
        yield "dtensor"
        return

    def by_mesh_dim(current, target) -> float:
        if current.mesh != target.mesh:
            return float("inf")
        if current.is_replicated() or current.placements == \
                target.placements:
            return 0.0
        strided = getattr(placement_types, "_StridedShard", ())
        if current.shard_order is None or target.shard_order is None or \
                any(isinstance(p, strided) for p in
                    (*current.placements, *target.placements)):
            return float("inf")        # strided shards: never chosen
        topo = cu.MeshTopoInfo.build_from_mesh(current.mesh)
        gb = cu.spec_to_bytes(current) / current.num_shards / 2 ** 30
        cost = 0.0
        for i, (c, t) in enumerate(zip(current.placements,
                                       target.placements)):
            c_cost, gb = step(c, t, topo, i, gb)
            if c_cost == float("inf"):
                return c_cost
            cost += c_cost
        return cost

    ou.redistribute_cost = by_mesh_dim
    try:
        yield "mesh_dim"
    finally:
        ou.redistribute_cost = cu.redistribute_cost


def _local_meta(tree, specs, mesh):
    """Each ``meta`` tensor of ``tree`` (global shapes) as a DTensor over
    rank 0's ``meta`` shard of its spec: nothing is allocated."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: _local_meta(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        out = [_local_meta(v, s, mesh) for v, s in zip(tree, specs)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    if not isinstance(tree, torch.Tensor):
        return tree
    placements = to_placements(specs, mesh)
    shape = list(tree.shape)
    for i, pl in enumerate(placements):
        if pl.is_shard():
            shape[pl.dim] = math.ceil(shape[pl.dim] / mesh.size(i))
    local = torch.empty(shape, dtype=tree.dtype, device="meta")
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=tree.shape, stride=tree.stride())


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    return sum((t.to_local() if isinstance(t, DTensor) else t).numel()
               * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def value_and_grad(cfg, params, batch):
    """``lm.loss_fn`` and its gradients in ``params`` by autograd: (loss,
    grads), the grads a tree like ``params``."""
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = lm.loss_fn(p, cfg, batch)
    leaves = tree_leaves(p)
    by_id = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    return loss.detach(), tree_map(lambda t: by_id[id(t)], p)


def train_step(cfg, optimizer, params, opt_state, batch):
    """One training step, the reference's ``train_step``: the loss and
    its gradients, the optimizer's update, the new parameters. Returns
    (new params, new optimizer state, loss); nothing is updated in
    place."""
    loss, grads = value_and_grad(cfg, params, batch)
    updates, new_opt = optimizer.update(grads, opt_state, params)
    return optim.apply_updates(params, updates), new_opt, loss


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               seq_par: bool = True, remat: bool = True,
               extra_tag: str = "", attn_mode: str = "gather",
               moe_mode: str = "global", kv_dtype: str = "",
               quant: str = "none", device_type: str = "cuda",
               reshard_costs: str = "mesh_dim") -> dict:
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, remat=remat)
    if kv_dtype:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_dtype)
    if quant and quant != "none":
        # Quantized execution modes resolve through the device-backend
        # registry — fail fast on unknown substrates, before tracing.
        from repro_torch.backends import get_backend
        get_backend(quant)
        cfg = dataclasses.replace(cfg, quant_mode=quant)
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device_type 'cuda' needs a card for the mesh, "
                           "and none is present; pass device_type='cpu' "
                           "(--device-type cpu) to trace on the host")

    shape = SHAPES[shape_name]
    with fake_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device_type=device_type)
        return _trace(cfg, arch, shape, shape_name, mesh, multi_pod,
                      seq_par, remat, extra_tag, attn_mode, moe_mode,
                      reshard_costs)


def _trace(cfg, arch, shape, shape_name, mesh, multi_pod, seq_par, remat,
           extra_tag, attn_mode, moe_mode, reshard_costs) -> dict:
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    n_chips = mesh.size()
    model = mesh.size(mesh.mesh_dim_names.index("model"))

    pshapes = lm.param_shapes(cfg)
    n_params = tree_size(pshapes)
    # Serving cells drop FSDP when TP-only weights fit per-chip HBM —
    # removes all per-layer weight gathers from the decode step.
    tp_bytes_per_chip = tree_bytes(pshapes) / model
    use_fsdp = shape.kind != "decode" or tp_bytes_per_chip > 8e9
    # Replicated small banks pair with the EP-local dispatch (train /
    # prefill); decode uses the global path where TP-sharded banks win.
    pspecs = param_specs(cfg, pshapes, mesh, fsdp=use_fsdp,
                         replicate_small_banks=(moe_mode == "ep" and
                                                shape.kind != "decode"))
    record = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": int(n_chips), "kind": shape.kind,
        "n_params": int(n_params),
        "param_bytes": int(tree_bytes(pshapes)),
        "seq_par": seq_par, "remat": remat, "tag": extra_tag,
        "fsdp": use_fsdp, "quant_mode": cfg.quant_mode,
        "attn_mode": attn_mode, "moe_mode": moe_mode,
        "torch_version": torch.__version__,
    }
    ctx = ShardingContext(mesh=mesh, batch_axes=batch_axes,
                          sequence_parallel=seq_par and
                          shape.kind != "decode",
                          attn_mode=attn_mode, moe_mode=moe_mode)
    params = _local_meta(pshapes, pspecs, mesh)
    specs = input_specs(cfg, shape_name)

    if shape.kind == "train":
        optimizer, opt_name = make_optimizer(cfg, n_params)
        record["optimizer"] = opt_name
        oshapes = optimizer.init(pshapes)
        record["opt_bytes"] = int(tree_bytes(oshapes))
        opt_state = _local_meta(
            oshapes, opt_state_specs(oshapes, pspecs, mesh), mesh)
        batch = _local_meta(specs, batch_specs(specs, mesh, multi_pod),
                            mesh)
        args = (params, opt_state, batch)

        def step():
            return train_step(cfg, optimizer, params, opt_state, batch)

    elif shape.kind == "prefill":
        batch = _local_meta(specs, batch_specs(specs, mesh, multi_pod),
                            mesh)
        logits_spec = ctx.spec("btv")
        if cfg.vocab % model != 0:
            logits_spec = P(logits_spec[0], None, None)
        args = (params, batch)

        def step():
            logits = lm.prefill(params, cfg, batch)
            return logits.redistribute(mesh,
                                       to_placements(logits_spec, mesh))

    else:  # decode
        cspecs = cache_specs(specs["caches"], mesh, multi_pod)
        record["cache_bytes"] = int(tree_bytes(specs["caches"]))
        caches = _local_meta(specs["caches"], cspecs, mesh)
        tok_spec = batch_specs({"tokens": specs["tokens"]}, mesh,
                               multi_pod)["tokens"]
        tokens = _local_meta(specs["tokens"], tok_spec, mesh)
        pos = _local_meta(specs["pos"], P(), mesh)
        B = specs["tokens"].shape[0]
        n_dp = math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                         for a in batch_axes)
        out_tok_spec = P(batch_axes if len(batch_axes) > 1
                         else batch_axes[0]) if B % n_dp == 0 else P()
        args = (params, caches, tokens, pos)

        def step():
            logits, new_caches = lm.decode_step(params, cfg, caches,
                                                tokens, pos)
            tok = lm.greedy_token(logits)
            return (tok.redistribute(mesh, to_placements(out_tok_spec,
                                                         mesh)),
                    new_caches)

    t0 = time.time()
    with alltoall_on_cpu_mesh(), \
            mesh_dim_reshard_costs(mesh, reshard_costs == "mesh_dim") \
            as record["reshard_costs"], \
            sharding_scope(ctx), hlo_analysis.count(args) as a:
        out = step()
        out_bytes = _local_bytes(out)
        del out
    record["trace_s"] = round(time.time() - t0, 1)
    record["memory_analysis"] = {
        "argument_size_in_bytes": int(a.argument_bytes),
        "output_size_in_bytes": int(out_bytes),
        "temp_size_in_bytes": int(a.peak_bytes - a.argument_bytes)}
    record["collectives"] = collective_bytes(a)
    record["hlo_analysis"] = a.as_dict()
    record["ok"] = True
    return record


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             seq_par: bool = True, remat: bool = True,
             tag: str = "", attn_mode: str = "gather",
             moe_mode: str = "global", kv_dtype: str = "",
             quant: str = "none", device_type: str = "cuda",
             reshard_costs: str = "mesh_dim") -> dict:
    reason = skip_reason(get_config(arch), shape_name)
    if reason:
        return {"arch": arch, "shape": shape_name,
                "mesh": _mesh_name(multi_pod), "skipped": reason,
                "ok": True}
    try:
        return lower_cell(arch, shape_name, multi_pod, seq_par, remat, tag,
                          attn_mode, moe_mode, kv_dtype, quant, device_type,
                          reshard_costs)
    except Exception as e:
        return {"arch": arch, "shape": shape_name,
                "mesh": _mesh_name(multi_pod),
                "ok": False, "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--seq-par", type=int, default=1)
    ap.add_argument("--remat", type=int, default=1)
    ap.add_argument("--attn", default="gather",
                    choices=["gather", "ulysses"])
    ap.add_argument("--moe", default="global", choices=["global", "ep"])
    ap.add_argument("--kv", default="", choices=["", "bf16", "int8"])
    ap.add_argument("--quant", default="none",
                    help="quantized execution substrate: any name in the "
                         "repro_torch.backends registry (validated before "
                         "tracing), or 'none'")
    ap.add_argument("--tag", default="")
    ap.add_argument("--device-type", default="cuda",
                    help="the mesh's device type: cuda (the default) or "
                         "cpu, where no card is present")
    ap.add_argument("--reshard-costs", default="mesh_dim",
                    choices=["mesh_dim", "dtensor"],
                    help="how DTensor prices candidate reshards on a mesh "
                         "of more than two dims: mesh dim by mesh dim (the "
                         "default), or by its own pricing, which may take "
                         "minutes an op there")
    ap.add_argument("--out-dir", default=str(RESULTS_DIR))
    args = ap.parse_args()

    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    n_fail = 0
    for arch in archs:
        for shape_name in shapes:
            rec = run_cell(arch, shape_name, args.multi_pod,
                           bool(args.seq_par), bool(args.remat), args.tag,
                           args.attn, args.moe, args.kv, args.quant,
                           args.device_type, args.reshard_costs)
            mesh_tag = _mesh_name(args.multi_pod)
            suffix = f"-{args.tag}" if args.tag else ""
            fname = out_dir / f"{arch}--{shape_name}--{mesh_tag}{suffix}.json"
            fname.write_text(json.dumps(rec, indent=1))
            status = ("SKIP" if rec.get("skipped")
                      else "OK" if rec.get("ok") else "FAIL")
            print(f"[{status}] {arch} × {shape_name} × {mesh_tag}"
                  + (f"  trace={rec.get('trace_s')}s"
                     if "trace_s" in rec else "")
                  + (f"  {rec.get('error', '')}" if not rec.get("ok")
                     else ""), flush=True)
            n_fail += 0 if rec.get("ok") else 1
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
