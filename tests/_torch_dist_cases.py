"""What each rank runs in ``test_torch_distributed.py``: the port's
sharded paths on a gloo mesh of spawned CPU processes against the same
call with no context, on inputs every rank makes alike from a seed.

Each case is ``fn(rank, world, ...)`` for ``testing.Ranks`` and
returns rank 0's numbers as numpy arrays. This module imports neither
jax nor the reference (every rank imports it); the test file holds the
results to the reference.
"""
import dataclasses

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import (ShardingContext, param_specs,
                                     sharding_scope)
from repro_torch.distributed.context import collectives, reset_collectives
from repro_torch.distributed.sharding import P, place
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import attention as attn
from repro_torch.models import lm
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.train.checkpoint import CheckpointManager

#: (attn_mode, moe_mode) pairs of the whole prefills.
MODES = (("gather", "global"), ("ulysses", "ep"))


def _np(t: torch.Tensor) -> np.ndarray:
    full = getattr(t, "full_tensor", None)
    return (full() if full is not None else t).detach().numpy()


def _ctx(mesh, **kw) -> ShardingContext:
    return ShardingContext(mesh=mesh, batch_axes=("data",), **kw)


# ---------------------------------------------------------------------------
# Whole prefills
# ---------------------------------------------------------------------------

def prefill_overrides(overrides, attn_chunk) -> dict:
    """The smoke config's overrides of a whole prefill: ``attn_chunk``,
    capacity factor 8 (so that neither the global nor a rank's local
    capacity drops a slot) and ``overrides``."""
    return dict(attn_chunk=attn_chunk, capacity_factor=8.0, **overrides)


def prefill_inputs(arch, overrides, batch, seq, attn_chunk):
    """(config, parameters, tokens) of a whole prefill, made from seeds
    alike on every rank and in the test's own process."""
    cfg = dataclasses.replace(get_smoke_config(arch), **prefill_overrides(
        overrides, attn_chunk))
    p = lm.init_params(prng.PRNGKey(0), cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (batch, seq)).astype(np.int32))
    return cfg, p, tokens


def prefills(rank, world, models, model, batch, seq, attn_chunk,
             modes=MODES):
    """Each (label, arch, config overrides) of ``models``: its smoke
    config's prefill with parameters placed by ``param_specs`` under each
    (attn_mode, moe_mode) of ``modes``, and without a context: {(label,
    attn_mode, moe_mode): (sharded, plain, the collectives asked for)},
    on the inputs of :func:`prefill_inputs`."""
    mesh = make_host_mesh(model, device_type="cpu")
    out = {}
    for name, arch, overrides in models:
        cfg, p, tokens = prefill_inputs(arch, overrides, batch, seq,
                                        attn_chunk)
        want = _np(lm.prefill(p, cfg, {"tokens": tokens}))
        for attn_mode, moe_mode in modes:
            specs = param_specs(cfg, p, mesh,
                                replicate_small_banks=moe_mode == "ep")
            reset_collectives()
            with sharding_scope(_ctx(mesh, attn_mode=attn_mode,
                                     moe_mode=moe_mode)):
                got = lm.prefill(place(p, specs, mesh), cfg,
                                 {"tokens": tokens})
            out[(name, attn_mode, moe_mode)] = (_np(got), want,
                                                dict(collectives))
    return out


# ---------------------------------------------------------------------------
# Expert-parallel MoE
# ---------------------------------------------------------------------------

def _moe_cfg(n_experts, top_k, capacity_factor):
    return dataclasses.replace(get_smoke_config("granite-moe-3b-a800m"),
                               n_experts=n_experts, top_k=top_k,
                               capacity_factor=capacity_factor)


def moe_ep(rank, world, cases, x, g):
    """EP on a (4, 2) mesh: for each (name, n_experts, top_k,
    capacity_factor, sequence_parallel, params) of ``cases``, the EP
    output and the output with no context, the collectives EP asked for,
    and (where ``g`` is given) the gradients of Σ y·g in x, the banks and
    the router both ways: {name: {...}}. Without sequence parallelism x
    is whole on the model axis, so both of its ranks route every token
    of their batch rows."""
    mesh = make_host_mesh(2, device_type="cpu")
    out = {}
    for name, E, K, cf, sp, params in cases:
        ctx = _ctx(mesh, moe_mode="ep", sequence_parallel=sp)
        cfg = _moe_cfg(E, K, cf)
        p = {k: torch.from_numpy(v).requires_grad_() for k, v in
             params.items()}
        xt = torch.from_numpy(x).requires_grad_()
        y0 = moe_mod.moe_ffn(p, cfg, xt)
        specs = param_specs(cfg, {"ffn": p}, mesh,
                            replicate_small_banks=True)["ffn"]
        pd = place({k: v.detach() for k, v in p.items()}, specs, mesh)
        for v in pd.values():
            v.requires_grad_()
        xd = place(xt.detach(), ctx.spec("btd"), mesh)
        xd.requires_grad_()
        reset_collectives()
        with sharding_scope(ctx):
            y1 = moe_mod.moe_ffn(pd, cfg, xd)
        res = {"ep": _np(y1), "plain": _np(y0), "collectives":
               dict(collectives), "specs": {k: tuple(v) for k, v in
                                             specs.items()}}
        if g is not None:
            gt = torch.from_numpy(g)
            names = ("w_gate", "w_up", "w_down", "router")
            want = torch.autograd.grad((y0 * gt).sum(),
                                       [xt] + [p[n] for n in names])
            with sharding_scope(ctx):
                got = torch.autograd.grad(
                    (y1 * place(gt, P(), mesh)).sum(),
                    [xd] + [pd[n] for n in names])
            res["grads"] = {n: (_np(a), _np(b)) for n, a, b in
                            zip(("x",) + names, got, want)}
        out[name] = res
    return out


# ---------------------------------------------------------------------------
# Ulysses and the gathered fallback
# ---------------------------------------------------------------------------

def _twice(fn, p, x, g, ctx, mesh, specs, grad_of=()):
    """``fn(p, x)`` without a context and under ``ctx`` (parameters placed
    by ``specs``, x laid out ``btd``); with ``grad_of``, the gradients of
    Σ y·g in x and those parameters both ways. Returns (sharded, plain,
    {name: (sharded, plain)})."""
    p = {k: v.detach().requires_grad_(k in grad_of) for k, v in p.items()}
    xt = x.detach().requires_grad_(bool(grad_of))
    y0 = fn(p, xt)
    pd = place({k: v.detach() for k, v in p.items()}, specs, mesh)
    for k in grad_of:
        pd[k].requires_grad_()
    xd = place(xt.detach(), ctx.spec("btd"), mesh)
    xd.requires_grad_(bool(grad_of))
    with sharding_scope(ctx):
        y1 = fn(pd, xd)
    grads = {}
    if grad_of:
        want = torch.autograd.grad((y0 * g).sum(),
                                   [xt] + [p[k] for k in grad_of])
        with sharding_scope(ctx):
            got = torch.autograd.grad((y1 * place(g, P(), mesh)).sum(),
                                      [xd] + [pd[k] for k in grad_of])
        grads = {k: (_np(a), _np(b)) for k, a, b in
                 zip(("x",) + tuple(grad_of), got, want)}
    return _np(y1), _np(y0), grads


#: case → (arch, config overrides, attn_mode, mixer, parameters whose
#: gradients are taken) of :func:`ulysses`.
ULYSSES = {
    "gqa": ("qwen2-0.5b", {"attn_chunk": 16}, "ulysses", "gqa",
            ("wq", "wk", "wv", "wo")),
    "gqa_seq": ("qwen2-0.5b", {"attn_chunk": 16}, "ulysses", "gqa",
                ("wq", "wk", "wv", "wo")),
    "gqa_gather": ("qwen2-0.5b", {"attn_chunk": 16}, "gather", "gqa",
                   ("wq", "wk", "wv", "wo")),
    "gqa_fallback": ("qwen2-0.5b", {"attn_chunk": 16, "n_heads": 3,
                                    "n_kv_heads": 1}, "ulysses", "gqa", ()),
    "gqa_cross": ("qwen2-0.5b", {"attn_chunk": 16}, "gather", "cross", ()),
    "mla": ("deepseek-v3-671b", {"attn_chunk": 16}, "ulysses", "mla", ()),
    "ssd": ("mamba2-370m", {}, "ulysses", "ssd",
            ("in_proj", "conv_w", "conv_b", "a_log", "out_proj")),
    "ssd_groups": ("mamba2-370m", {"ssm_groups": 2}, "ulysses", "ssd", ()),
}

_INIT = {"gqa": attn.init_gqa_params, "cross": attn.init_gqa_params,
         "mla": attn.init_mla_params, "ssd": ssm_mod.init_ssm_params}


def mixer(kind, p, cfg, x):
    """The port's mixer of a :data:`ULYSSES` case on (B, S, D) ``x``
    ("cross": GQA cross-attention from x to x, unmasked)."""
    if kind == "ssd":
        return ssm_mod.mamba2_forward(p, cfg, x)
    if kind == "cross":
        return attn.gqa_attention(p, cfg, x, torch.arange(x.shape[1]),
                                  kv=(x,))
    fn = attn.gqa_attention if kind == "gqa" else attn.mla_attention
    return fn(p, cfg, x, torch.arange(x.shape[1]))


def ulysses_inputs(batch, seq):
    """{case: (config, parameters, x, g)} of :data:`ULYSSES`, made from
    seeds alike on every rank and in the test's own process; g is the
    cotangent of the gradient cases."""
    rng = np.random.default_rng(3)
    out = {}
    for name, (arch, overrides, _, kind, _) in ULYSSES.items():
        cfg = dataclasses.replace(get_smoke_config(arch), **overrides)
        p = _INIT[kind](prng.PRNGKey(0), cfg, device="cpu")
        shape = (batch, seq, cfg.d_model)
        x = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
        g = torch.from_numpy(np.random.default_rng(7).normal(
            0, 1, shape).astype(np.float32))
        out[name] = (cfg, p, x, g)
    return out


def ulysses(rank, world, model, batch, seq):
    """On a (world // model, model) mesh, sequence-parallel, each case of
    :data:`ULYSSES` on :func:`ulysses_inputs`: GQA with the heads
    dividing the model axis (Ulysses, with its gradients; "gqa_seq" with
    the parameters replicated, so that q, k and v come in
    sequence-sharded and are resharded to heads), GQA with 3 heads (the
    gathered fallback), MLA and the SSD mixer (one and two groups, the
    first with its gradients) under ``attn_mode="ulysses"``, and GQA
    under "gather" (with gradients) and its cross-attention: {case:
    (sharded, plain, grads, collectives)}. The other cases place their
    parameters by ``param_specs``."""
    mesh = make_host_mesh(model, device_type="cpu")
    out = {}
    for name, (cfg, p, x, g) in ulysses_inputs(batch, seq).items():
        _, _, mode, kind, grad_of = ULYSSES[name]
        ctx = _ctx(mesh, attn_mode=mode)
        specs = param_specs(cfg, p, mesh)
        if name == "gqa_seq":
            specs = {k: P(*[None] * v.ndim) for k, v in p.items()}
        reset_collectives()
        y1, y0, grads = _twice(lambda p, x: mixer(kind, p, cfg, x), p, x,
                               g, ctx, mesh, specs, grad_of)
        out[name] = (y1, y0, grads, dict(collectives))
    return out


# ---------------------------------------------------------------------------
# Elastic restore
# ---------------------------------------------------------------------------

#: The quantized and the miru smoke models, on whole tensors under a
#: context: (label, arch, config overrides).
GATHERED = (("qwen2-wbs", "qwen2-0.5b", {"quant_mode": "wbs"}),
            ("qwen2-miru", "qwen2-0.5b", {"mixer": "miru"}))


def ulysses_and_restore(rank, world, model, batch, seq, directory):
    """:func:`ulysses`, the :data:`GATHERED` prefills under (gather,
    global), then :func:`restore`, on the ranks of one group."""
    return {"ulysses": ulysses(rank, world, model, batch, seq),
            "prefills": prefills(rank, world, GATHERED, model, batch, seq,
                                 16, modes=MODES[:1]),
            "restore": restore(rank, world, directory, 1)}


def ulysses_and_prefills(rank, world, model, batch, seq, names, seq_lm):
    """:func:`ulysses` then :func:`prefills` of ``names`` on the ranks of
    one group."""
    return {"ulysses": ulysses(rank, world, model, batch, seq),
            "prefills": prefills(rank, world, [(n, n, {}) for n in names],
                                 model, 2, seq_lm, 16)}


def restore(rank, world, directory, model):
    """Rank 0 saves {"w": arange(16) as (4, 4) fp32, "b": arange(3)}; every
    rank restores "w" onto a (world // model, model) mesh as P("data",
    None) and "b" as it is. Returns each rank's local rows of "w", the
    placements, the full tensor and "b"."""
    import torch.distributed as dist

    mesh = make_host_mesh(model, device_type="cpu")
    ck = CheckpointManager(directory)
    if rank == 0:
        ck.save(1, {"w": torch.arange(16.0).reshape(4, 4),
                    "b": torch.arange(3)})
    dist.barrier()
    _, tree, _ = ck.restore(shardings={"w": (mesh, P("data", None))})
    w = tree["w"]
    locals_ = [None] * world
    dist.all_gather_object(locals_, w.to_local().numpy())
    return {"locals": locals_, "placements": repr(w.placements),
            "full": _np(w), "b": tree["b"].numpy(),
            "b_type": type(tree["b"]).__name__}
