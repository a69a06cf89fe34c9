"""Per-parameter partition specs (DP/FSDP/TP/EP) for every arch, and
their DTensor placements — counterpart of
``repro/distributed/sharding.py``.

Scheme, on mesh axes (data, model) [+ replicated pod]:
  * 2-D projections (d_in, d_out): P('data','model') — FSDP × TP. The
    residual-side dim shards over 'data' (gathered per layer under FSDP),
    the hidden/head dim over 'model' (tensor parallel).
  * back-projections to the residual (wo / w_down / out_proj):
    P('model','data') — keeps the contracting dim on 'model' so the TP
    pair (up-proj, down-proj) needs a single all-reduce.
  * MoE expert banks (E, D, F): experts over 'model' (EP) when E divides;
    otherwise TP over F. FSDP over D either way.
  * embeddings / lm_head: vocab over 'model'.
  * vectors (norms, biases, scalars): replicated.
Leading layer-stack dims are never sharded. Divisibility is checked per
dim; a dim that does not divide degrades to replicated.

A spec is a :class:`P`: one entry a tensor dim, each an axis name, a
tuple of names (the dim split over those mesh axes, the first major) or
None. As a tuple it equals the entries of the reference's
``jax.sharding.PartitionSpec``. The rules read only the mesh's axis
sizes, ``mesh.shape[name]``: they take the reference's meshes, a
``{name: size}`` dict, or a torch ``DeviceMesh`` with named dims (through
:func:`mesh_shape`). :func:`to_placements` turns a spec into DTensor
placements on a ``DeviceMesh``, and :func:`place` lays a tree out by its
specs.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig

PyTree = Any

_BACK_PROJ = ("wo", "w_down", "out_proj")
_VOCAB = ("embed", "lm_head")
# Per-layer vectors (norm scales, biases, SSM scalars): replicated even
# when stacked into (L, dim) — sharding them buys nothing and costs a
# gather per layer.
_VECTOR_NAMES = frozenset({
    "norm", "norm1", "norm2", "norm_x", "final_norm", "enc_norm",
    "q_norm", "k_norm", "kv_norm", "b", "bias", "bq", "bk", "bv", "b_h",
    "b_o", "conv_b", "a_log", "dt_bias", "d_skip",
})


class P(tuple):
    """A partition spec: ``P('data', None)`` is the tuple
    ``('data', None)``, one entry a tensor dim."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a torch ``DeviceMesh`` with named dims, or
    of anything whose ``shape`` maps names to sizes."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    return dict(mesh.shape)


def _axis_size(mesh, name: str) -> int:
    return mesh_shape(mesh)[name]


def _ok(dim: int, mesh, axis: Optional[str]) -> Optional[str]:
    if axis is None:
        return None
    return axis if dim % _axis_size(mesh, axis) == 0 else None


def _leaf_spec(path: tuple[str, ...], leaf, cfg: ModelConfig, mesh,
               fsdp_axis: str = "data", tp_axis: str = "model",
               replicate_small_banks: bool = False) -> P:
    name = path[-1]
    shape = tuple(leaf.shape)
    nd = len(shape)
    if name in _VECTOR_NAMES:
        return P(*([None] * nd))
    if name in ("router",):
        d = _ok(shape[-2], mesh, fsdp_axis)
        return P(*([None] * (nd - 2)), d, None)
    if name in ("w_gate", "w_up", "w_down") and nd >= 3 \
            and path[-2] != "shared" and cfg.n_experts > 0 \
            and shape[-3] == cfg.n_experts:
        E = shape[-3]
        ep = _ok(E, mesh, tp_axis)
        bank_bytes = E * shape[-2] * shape[-1] * 2   # bf16
        replicate = replicate_small_banks and bank_bytes <= 2.5e8
        if name == "w_down":                     # (…, E, F, D)
            if ep:
                return P(*([None] * (nd - 3)), ep, None,
                         _ok(shape[-1], mesh, fsdp_axis))
            if replicate:                        # small bank + EP-local
                return P(*([None] * nd))         # dispatch: replicate
            return P(*([None] * (nd - 3)), None,
                     _ok(shape[-2], mesh, tp_axis),
                     _ok(shape[-1], mesh, fsdp_axis))
        # (…, E, D, F)
        if ep:
            return P(*([None] * (nd - 3)), ep,
                     _ok(shape[-2], mesh, fsdp_axis), None)
        if replicate:
            return P(*([None] * nd))
        return P(*([None] * (nd - 3)), None,
                 _ok(shape[-2], mesh, fsdp_axis),
                 _ok(shape[-1], mesh, tp_axis))
    if name in _VOCAB:
        if name == "embed":                      # (V, D)
            return P(_ok(shape[0], mesh, tp_axis), None)
        return P(_ok(shape[-2], mesh, fsdp_axis),
                 _ok(shape[-1], mesh, tp_axis))  # lm_head (D, V)
    if nd >= 2 and shape[-1] > 1 and shape[-2] > 1:
        lead = [None] * (nd - 2)
        if name in _BACK_PROJ:
            return P(*lead, _ok(shape[-2], mesh, tp_axis),
                     _ok(shape[-1], mesh, fsdp_axis))
        return P(*lead, _ok(shape[-2], mesh, fsdp_axis),
                 _ok(shape[-1], mesh, tp_axis))
    return P(*([None] * nd))                     # vectors / scalars


def param_specs(cfg: ModelConfig, shapes: PyTree, mesh,
                fsdp: bool = True,
                replicate_small_banks: bool = False) -> PyTree:
    """The spec tree of a parameter tree (tensors, ``meta`` tensors from
    ``lm.param_shapes``, or anything with a ``shape``).

    ``fsdp=False`` (serving): drop the 'data' axis from the weights —
    pure TP, no per-layer weight all-gathers at decode.
    ``replicate_small_banks``: with EP-local MoE dispatch (moe_mode=ep),
    expert banks under 2.5e8 bf16 bytes are replicated on every device
    (no MoE collectives); under global dispatch they stay TP-sharded."""
    def leaf(path, x):
        spec = _leaf_spec(path, x, cfg, mesh,
                          replicate_small_banks=replicate_small_banks)
        if fsdp:
            return spec
        return P(*[None if a == "data" else a for a in spec])

    return _map_with_path(leaf, shapes)


def _map_with_path(fn, tree: PyTree) -> PyTree:
    """``fn(path, leaf)`` over a tree of dicts, NamedTuples, tuples and
    lists (a path entry a key, a field name or an index as a string)."""
    def walk(path, node):
        if isinstance(node, dict):
            return {k: walk(path + (k,), v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(path + (f,), v)
                                for f, v in zip(node._fields, node)))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(path + (str(i),), v)
                              for i, v in enumerate(node))
        return fn(path, node)
    return walk((), tree)


def batch_specs(batch_shapes: PyTree, mesh, multi_pod: bool) -> PyTree:
    """Batch leaves: the leading dim over the DP axes where it divides."""
    b = ("pod", "data") if multi_pod else "data"
    n_b = math.prod(_axis_size(mesh, a)
                    for a in (b if isinstance(b, tuple) else (b,)))

    def spec(path, leaf):
        nd = len(leaf.shape)
        if nd == 0:
            return P()
        if leaf.shape[0] % n_b != 0:
            return P(*([None] * nd))
        return P(b, *([None] * (nd - 1)))

    return _map_with_path(spec, batch_shapes)


def cache_specs(cache_shapes: PyTree, mesh, multi_pod: bool) -> PyTree:
    """Decode caches, stacked (L, B, S, …): batch over all DP axes (and
    the model axis too when it divides: decode batches are the only
    tensors big enough to need 256-way sharding); axes left unused go on
    the widest trailing dim that divides (TP over kv-channels or heads of
    long-context, small-batch caches)."""
    axes = (["pod"] if multi_pod else []) + ["data", "model"]

    def spec(path, leaf):
        nd = len(leaf.shape)
        if nd < 2:
            return P(*([None] * nd))
        B = leaf.shape[1] if nd >= 3 else leaf.shape[0]
        bdim = 1 if nd >= 3 else 0
        use = []
        rem = B
        for a in axes:
            if rem % _axis_size(mesh, a) == 0:
                use.append(a)
                rem //= _axis_size(mesh, a)
        out = [None] * nd
        if use:
            out[bdim] = tuple(use) if len(use) > 1 else use[0]
        unused = [a for a in axes if a not in use]
        for a in unused:
            n = _axis_size(mesh, a)
            for dim in range(nd - 1, bdim, -1):
                if out[dim] is None and dim != bdim \
                        and leaf.shape[dim] % n == 0 \
                        and leaf.shape[dim] >= n:
                    out[dim] = a
                    break
        return P(*out)

    return _map_with_path(spec, cache_shapes)


def opt_state_specs(opt_shapes: PyTree, pspecs: PyTree, mesh) -> PyTree:
    """Optimizer state: moments inherit their parameter's spec (the
    longest path suffix that names a parameter); 8-bit ``codes`` inherit
    it with the padded last dim replicated where it no longer divides,
    ``scales`` with the last dim replicated; other vectors shard over
    (data, model) where they divide; scalars replicate."""
    flat_specs = {tuple(p): s for p, s in _flatten(pspecs)}

    def spec(path, leaf):
        nd = len(leaf.shape)
        if nd == 0:
            return P()
        mpath = path[:-1] if path and path[-1] in ("codes", "scales") \
            else path
        for plen in range(len(mpath), 0, -1):
            cand = tuple(mpath[-plen:])
            if cand in flat_specs:
                s = flat_specs[cand]
                if len(s) == nd:
                    if path[-1] == "scales":
                        return P(*s[:-1], None)
                    if path[-1] == "codes":
                        last = s[-1]
                        if last is not None and leaf.shape[-1] % \
                                _axis_size(mesh, last) != 0:
                            last = None
                        return P(*s[:-1], last)
                    return s
        if nd == 1 and leaf.shape[0] % (_axis_size(mesh, "data")
                                        * _axis_size(mesh, "model")) == 0:
            return P(("data", "model"))
        return P(*([None] * nd))

    return _map_with_path(spec, opt_shapes)


def _flatten(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, path + (k,))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (str(i),))
    else:
        yield path, tree


# ---------------------------------------------------------------------------
# Specs as DTensor placements
# ---------------------------------------------------------------------------

def to_placements(spec: P, mesh) -> tuple:
    """The DTensor placements of ``spec`` on a ``DeviceMesh``: ``Shard(d)``
    on each mesh dim that tensor dim ``d`` names, ``Replicate()`` on the
    others. A tuple entry splits its tensor dim over those mesh dims, the
    first major, as in JAX, which DTensor writes as one ``Shard(d)`` on
    each; its names must come in the mesh's order (another order would
    need DTensor's strided sharding, which no rule here emits). A mesh
    dim of size 1 is ``Replicate()`` whatever the spec says: one rank's
    shard is the whole dim, and DTensor refuses to view a sharded dim of
    size 1 (a batch of one on one rank) away."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    placements = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"{spec}: dim {d} names {axes} out of the "
                             f"mesh's order {tuple(names)}")
        for i in order:
            if mesh.size(i) > 1:
                placements[i] = Shard(d)
    return tuple(placements)


def place(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    """Each tensor of ``tree`` as a DTensor on ``mesh``, laid out by its
    spec in ``specs`` (a tree of :class:`P` of the same structure, as
    :func:`param_specs` gives): ``distribute_tensor`` from the full
    tensor, which every rank holds alike. On a mesh of one rank every
    local tensor is the whole one, taken as it is (no copy)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(tree, dict):
        return {k: place(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        out = [place(v, s, mesh) for v, s in zip(tree, specs)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    if not isinstance(tree, torch.Tensor):
        return tree
    placements = to_placements(specs, mesh)
    if mesh.size() == 1:
        return DTensor.from_local(tree, mesh, placements, run_check=False)
    return distribute_tensor(tree, mesh, placements)
