"""Activation-sharding context — counterpart of
``repro/distributed/context.py``, on a torch ``DeviceMesh``.

Model code is mesh-agnostic; the launcher installs a ShardingContext and
the model calls ``act_constraint(x, kind)`` at a few strategic points
(post-embedding, residual stream, attention output). Without a context
(unit tests, single-device runs) the helpers are no-ops and no tensor
becomes a DTensor, so the same model code runs everywhere and the
unsharded paths are the same program as before.

Under a context the parameters are DTensors (``sharding.place``), so the
activations are too: DTensor's sharding propagation stands where the
reference's GSPMD stands, and ``act_constraint`` is a ``redistribute``
to the kind's placements (``with_sharding_constraint`` there). The
scope also turns on DTensor's implicit replication, so plain tensors
made inside the model (rope positions, masks) meet DTensors as
replicated values. Where the reference writes a ``shard_map``, the port
runs the function on each rank's local tensors under ``local_map``
(:func:`run_local`), with explicit collectives inside.

Kinds:
  "btd"  — (batch, seq, d_model) residual stream. Batch over the DP axes;
           seq over the TP axis when sequence parallelism is enabled.
  "bt"   — (batch, seq) token arrays.
  "btv"  — logits: batch over DP, vocab over TP.
  "bshd", "bshd_full", "bsh", "bshd_seq", "bs__" — the Ulysses layouts
           of attention and the SSD (see :meth:`ShardingContext.spec`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Optional

import torch

from repro_torch.distributed.sharding import P, mesh_shape, to_placements

#: Collectives the sharded paths ask for, since the last reset:
#: ``all_to_all`` issued by the expert-parallel MoE to its process
#: groups, ``all_gather`` by it (the banks) and by the SSD's causal conv
#: (the rows before a sequence shard), and ``reshard_all_to_all`` the
#: sequence ↔ heads reshards that ``act_constraint`` asks DTensor for
#: (DTensor sends nothing over a mesh dim of size 1).
collectives = {"all_to_all": 0, "all_gather": 0, "reshard_all_to_all": 0}


def reset_collectives() -> None:
    for k in collectives:
        collectives[k] = 0


@dataclasses.dataclass(frozen=True)
class ShardingContext:
    mesh: Any                                 # a torch DeviceMesh
    batch_axes: tuple[str, ...] = ("data",)   # ("pod","data") multi-pod
    model_axis: str = "model"
    sequence_parallel: bool = True
    # Attention context exchange: "gather" gathers K/V whole to every
    # rank of the model axis; "ulysses" reshards seq→heads with
    # all-to-alls (1× volume) around the attention op.
    attn_mode: str = "gather"
    # MoE dispatch: "global" sort-based capacity dispatch over the whole
    # token set; "ep" expert parallelism with explicit all-to-all (k·D
    # bytes a token).
    moe_mode: str = "global"

    def spec(self, kind: str) -> P:
        b = self.batch_axes if len(self.batch_axes) > 1 \
            else self.batch_axes[0]
        if kind == "btd":
            seq = self.model_axis if self.sequence_parallel else None
            return P(b, seq, None)
        if kind == "bt":
            return P(b, None)
        if kind == "btv":
            return P(b, None, self.model_axis)
        if kind == "bshd":       # ulysses: heads sharded, seq gathered
            return P(b, None, self.model_axis, None)
        if kind == "bshd_full":  # K/V gathered whole while still bf16
            return P(b, None, None, None)
        if kind == "bsh":        # (B, S, heads): heads over model (SSM dt)
            return P(b, None, self.model_axis)
        if kind == "bshd_seq":   # (B, S, H, d) with seq kept sharded —
            seq = self.model_axis if self.sequence_parallel else None
            return P(b, seq, None, None)    # anchor before an a2a reshard
        if kind == "bs__":       # (B, S, groups, state): seq gathered,
            return P(b, None, None, None)   # small B/C tensors replicated
        raise ValueError(kind)

    def placements(self, kind: str) -> tuple:
        """The DTensor placements of :meth:`spec` on the mesh."""
        return to_placements(self.spec(kind), self.mesh)

    def size(self, axis: str) -> int:
        return mesh_shape(self.mesh)[axis]


_tls = threading.local()


def current_context() -> Optional[ShardingContext]:
    return getattr(_tls, "ctx", None)


@contextlib.contextmanager
def sharding_scope(ctx: ShardingContext):
    """Install ``ctx`` for this thread; the outermost scope also lets
    plain tensors meet DTensors as replicated values."""
    from torch.distributed.tensor.experimental import implicit_replication

    prev = current_context()
    _tls.ctx = ctx
    try:
        with (implicit_replication() if prev is None
              else contextlib.nullcontext()):
            yield
    finally:
        _tls.ctx = prev


def is_sharded(x) -> bool:
    """Whether ``x`` is a DTensor (the sharded paths take only those)."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def act_constraint(x: torch.Tensor, kind: str) -> torch.Tensor:
    """``x`` redistributed to the kind's placements under a context; a
    plain tensor, or any tensor without a context, as it is."""
    ctx = current_context()
    if ctx is None or not is_sharded(x):
        return x
    target = ctx.placements(kind)
    if any(a.is_shard() and b.is_shard() and a != b
           for a, b in zip(x.placements, target)):
        collectives["reshard_all_to_all"] += 1
    return x.redistribute(ctx.mesh, target)


def whole_dim(x: torch.Tensor, dim: int, n: int = 0) -> torch.Tensor:
    """A DTensor ``x`` with ``dim`` gathered on each mesh dim that shards
    it; with ``n``, only as far as needed for the mesh dims left sharding
    it (in mesh order) to split it into n equal blocks each. Any other
    tensor as it is."""
    if not is_sharded(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    d, ways, pl = Shard(dim % x.ndim), 1, list(x.placements)
    for i, p in enumerate(pl):
        if p == d:
            if n and n % (ways * x.device_mesh.size(i)) == 0:
                ways *= x.device_mesh.size(i)
            else:
                pl[i] = Replicate()
    return x if tuple(pl) == tuple(x.placements) else \
        x.redistribute(x.device_mesh, tuple(pl))


def split_dim(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """x's ``dim`` (of size n·d) viewed (n, d). A DTensor first gathers
    that dim where its shards would straddle the n blocks
    (:func:`whole_dim`): DTensor cannot split it so."""
    dim %= x.ndim
    x = whole_dim(x, dim, n)
    return x.reshape(*x.shape[:dim], n, x.shape[dim] // n,
                     *x.shape[dim + 1:])


def split_last(x: torch.Tensor, n: int) -> torch.Tensor:
    """x (…, n·d) viewed (…, n, d), by :func:`split_dim`."""
    return split_dim(x, -1, n)


def write_rows_at(buf: torch.Tensor, val: torch.Tensor, idx: torch.Tensor
                  ) -> bool:
    """``buf.index_copy_(1, idx, val)`` for a DTensor ``buf`` (a cache,
    its dim 1 the sequence), on each rank's local tensors: the rank
    writes ``val`` where ``idx`` falls in its own shard of dim 1 and
    keeps what it held elsewhere (DTensor cannot update a sharded dim in
    place, and some releases have no rule for ``index_copy_`` at all).
    No host read: a rank outside the shard rewrites its first row with
    itself. Returns False, doing nothing, where ``buf`` is no DTensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not is_sharded(buf):
        return False
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh = buf.device_mesh
    _, offset = compute_local_shape_and_global_offset(
        buf.shape, mesh, buf.placements)
    pl = tuple(Replicate() if p == Shard(1) else p for p in buf.placements)
    if isinstance(val, DTensor):
        val = val.redistribute(mesh, pl).to_local()
    if isinstance(idx, DTensor):
        idx = idx.full_tensor()
    local = buf.to_local()
    rows = local.shape[1]
    li = (idx - offset[1]).clamp(0, rows - 1)
    inside = ((idx >= offset[1]) & (idx < offset[1] + rows)).reshape(
        (1, 1) + (1,) * (local.ndim - 2))
    old = local.index_select(1, li)
    local.index_copy_(1, li, torch.where(inside, val.to(local.dtype), old))
    return True


class _MergeLast(torch.autograd.Function):
    """(…, n, d) viewed (…, n·d), its gradient split back by
    :func:`split_last`."""

    @staticmethod
    def forward(ctx, x):
        ctx.n = x.shape[-2]
        return x.reshape(*x.shape[:-2], -1)

    @staticmethod
    def backward(ctx, g):
        return split_last(g, ctx.n)


def merge_last(x: torch.Tensor) -> torch.Tensor:
    """x (…, n, d) viewed (…, n·d), the inverse of :func:`split_last`. A
    DTensor first gathers d where it is sharded (no placement holds two
    sharded dims joined) and n where its shards are uneven, and its
    gradient, which may come sharded over the joined dim, goes back
    through :func:`split_last` (a reshape's own backward would split
    that dim into blocks that straddle its shards)."""
    if is_sharded(x):
        x = whole_dim(whole_dim(x, -1), -2, x.shape[-2])
        if x.requires_grad:
            return _MergeLast.apply(x)
    return x.reshape(*x.shape[:-2], -1)


def ulysses_enabled(n_heads: int) -> bool:
    """True when the context requests all-to-all attention and the head
    count divides the model axis."""
    ctx = current_context()
    if ctx is None or ctx.attn_mode != "ulysses":
        return False
    return n_heads % ctx.size(ctx.model_axis) == 0


def run_local(fn: Callable, out_placements: tuple, in_placements: tuple,
              *args, grad_placements: Optional[tuple] = None):
    """``fn`` on each rank's local tensors of ``args`` (the reference's
    ``shard_map``): each DTensor argument is first redistributed to its
    entry of ``in_placements`` (None for a non-tensor), and the outputs
    are DTensors with ``out_placements``, one placements tuple an output.
    ``grad_placements`` (default ``in_placements``) says how each input's
    local gradient is laid out: an input whole on the ranks of a mesh dim
    that each read a different part of it gets a :func:`partial` one.
    Plain tensors pass as they are. Every shard must be whole (even)."""
    from torch.distributed.tensor.experimental import local_map

    ctx = current_context()
    return local_map(fn, out_placements=out_placements,
                     in_placements=in_placements,
                     in_grad_placements=grad_placements,
                     device_mesh=ctx.mesh, redistribute_inputs=True)(*args)


def partial(placements: tuple, over: Optional[tuple] = None) -> tuple:
    """``placements`` with each ``Replicate()`` turned ``Partial()``: the
    layout of the gradient of a tensor that is whole on those mesh dims
    while each of their ranks reads it for its own part of the work.
    Given ``over``, the placements of the tensor whose parts the ranks
    work on, only the mesh dims that shard it: on the others every rank
    does the same work, and its gradient is already whole."""
    from torch.distributed.tensor import Partial

    return tuple(Partial() if p.is_replicate()
                 and (over is None or over[i].is_shard()) else p
                 for i, p in enumerate(placements))


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's shards of a local ``t`` joined along ``dim``, in
    ``t``'s dtype, inside a :func:`run_local` block. Differentiable (its
    gradient a reduce-scatter)."""
    import warnings

    import torch.distributed._functional_collectives as funcol

    collectives["all_gather"] += 1
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return funcol.all_gather_tensor_autograd(t.contiguous(), dim, group)


def replicated(fn: Callable, *args, n_out: int = 1):
    """``fn`` on whole tensors, for the ops that DTensor has no sharding
    rule for: every DTensor argument gathered to ``Replicate()`` first,
    the ``n_out`` outputs replicated DTensors. Keeps the values; costs
    the gathers."""
    from torch.distributed.tensor import Replicate

    ctx = current_context()
    rep = tuple(Replicate() for _ in ctx.mesh.mesh_dim_names)
    ins = tuple(rep if isinstance(a, torch.Tensor) else None for a in args)
    return run_local(fn, (rep,) * n_out, ins, *args)
