"""FLOPs, bytes and collective bytes of one rank's program as it is
dispatched — counterpart of ``repro/launch/hlo_analysis.py``. It reads no
HLO: the port has none. It counts the aten ops that a step dispatches,
under a ``TorchDispatchMode``.

Counted per rank. Under DTensor the mode sits below it: an op on
DTensors passes through uncounted (``NotImplemented``), and the mode sees
the local ops that DTensor runs on this rank's shards and the
``_c10d_functional`` collectives it emits, as the reference's per-device
SPMD program holds them. The fake tensors of DTensor's sharding
propagation are not counted.

  * FLOPs — ``torch.utils.flop_counter``'s formula for each op in its
    registry (mm, addmm, bmm, baddbmm, convolutions, the SDPA kernels),
    on the local arguments, plus each kernel event's own work.
  * bytes_accessed — the output bytes of every op that materialises a
    buffer. Views and other aliasing ops (the op schema's alias info, and
    ``_unsafe_view``) count nothing, nor do ``empty`` buffers that no op
    has written yet. An in-place op counts the bytes it writes: its
    ``self`` (a view where it updates a slice, as ``copy_`` into a
    cache's rows does), and for ``index_put_``, ``scatter_`` and the like
    their update operand, as the reference counts dynamic-update-slice
    and scatter. Eager PyTorch fuses nothing, so this is the traffic the
    card really moves, more than XLA's count of fused buffers. An eager
    loop dispatches every iteration, so no trip count multiplies
    anything.
  * collective bytes — each ``_c10d_functional`` collective under the
    reference's five names (all-gather, all-reduce, reduce-scatter,
    all-to-all, collective-permute), with this rank's output bytes and a
    count.
  * kernels — a hand-written kernel's wrapper (``kernels/ops.py``)
    reports one event a launch with the work of ``kernels/work.py``, and
    the aten ops of its body (pads, slices, on the CPU or ``meta`` its
    plain version) are not counted, so a step counts the same on the
    card and on ``meta``.

Live bytes are tracked beside the counts: every storage an op makes
(counted or not) is live from its op until it is freed, and
``peak_bytes`` is the most that were live at once, the step's arguments
included when :func:`count` is given them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import defaultdict
from typing import Any, Callable, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import work

# A collective op (of :data:`_COLL_NAMESPACES`) → the reference's name.
_COLL_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",      # _dtensor: a reshard
}
_COLL_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                    "_dtensor")

_DTYPE_NAMES = {torch.float64: "f64", torch.float32: "f32",
                torch.bfloat16: "bf16", torch.float16: "f16",
                torch.int64: "s64", torch.int32: "s32", torch.int16: "s16",
                torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred",
                torch.complex64: "c64", torch.complex128: "c128"}

# Ops that hand back memory nothing has written yet.
_UNWRITTEN = frozenset({"empty", "empty_strided", "empty_like", "new_empty",
                        "new_empty_strided"})

# In-place updates of part of ``self``: the argument written, by index.
_UPDATE_ARG = {"index_put_": 2, "_index_put_impl_": 2, "scatter_": 3,
               "scatter_add_": 3, "scatter_reduce_": 3, "index_copy_": 3,
               "index_add_": 3, "masked_scatter_": 2}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _sig(t: torch.Tensor) -> str:
    name = _DTYPE_NAMES.get(t.dtype, str(t.dtype).replace("torch.", ""))
    return f"{name}[{','.join(str(d) for d in t.shape)}]"


@dataclasses.dataclass
class Analysis:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    per_collective: dict = dataclasses.field(
        default_factory=lambda: defaultdict(lambda: {"count": 0.0,
                                                     "bytes": 0.0}))
    by_shape: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    kernels: dict = dataclasses.field(
        default_factory=lambda: defaultdict(lambda: {"count": 0,
                                                     "flops": 0.0,
                                                     "bytes": 0.0}))
    # Live storages: bytes now, the most at once, those of the arguments.
    live_bytes: int = 0
    peak_bytes: int = 0
    argument_bytes: int = 0

    def top_shapes(self, n: int = 12) -> list:
        return sorted(self.by_shape.items(), key=lambda kv: -kv[1])[:n]

    def as_dict(self) -> dict:
        return {"flops": self.flops,
                "bytes_accessed": self.bytes_accessed,
                "collective_bytes": self.collective_bytes,
                "per_collective": {k: dict(v) for k, v in
                                   self.per_collective.items()},
                "top_shapes": [
                    {"op_shape": f"{op} {shape}", "bytes": b}
                    for (op, shape), b in self.top_shapes()],
                "kernels": {k: dict(v) for k, v in self.kernels.items()}}


class _Counter(TorchDispatchMode):
    """The dispatch mode behind :func:`count`; also the kernel wrappers'
    :data:`kernels.work.recorder` while it is active."""

    def __init__(self, analysis: Analysis):
        super().__init__()
        self.a = analysis
        self.paused = 0
        self.storages: dict[int, int] = {}

    # -- live storages ------------------------------------------------------
    def _free(self, key: int) -> None:
        self.a.live_bytes -= self.storages.pop(key, 0)

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.storages:
            return
        n = st.nbytes()
        self.storages[key] = n
        weakref.finalize(st, self._free, key)
        self.a.live_bytes += n
        self.a.peak_bytes = max(self.a.peak_bytes, self.a.live_bytes)

    # -- kernel events ------------------------------------------------------
    def kernel(self, events, run: Callable, meta: Callable = None):
        """Count ``events`` ((name, Work) pairs), then ``run()`` the
        wrapper's body uncounted; on ``meta`` inputs ``meta()`` makes the
        outputs instead, where given."""
        for name, w in events:
            k = self.a.kernels[name]
            k["count"] += 1
            k["flops"] += w.flops + w.flops64
            k["bytes"] += w.bytes
            self.a.flops += w.flops + w.flops64
            self.a.bytes_accessed += w.bytes
        self.paused += 1
        try:
            return meta() if meta is not None else run()
        finally:
            self.paused -= 1

    # -- the ops --------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in outs) or any(
                isinstance(t, FakeTensor) for t in tree_flatten(args)[0]):
            return out
        name = func.overloadpacket.__name__
        rets = func._schema.returns
        alias = [r.alias_info for r in rets if r.alias_info is not None]
        fresh = not alias and name != "_unsafe_view"
        if fresh:
            for t in outs:
                self.track(t)
        if self.paused:
            return out
        a = self.a
        ns = func.namespace
        if ns in _COLL_NAMESPACES:
            coll = _COLL_OPS.get(name)
            if coll is not None:
                b = sum(_nbytes(t) for t in outs)
                a.collective_bytes += b
                a.per_collective[coll]["count"] += 1
                a.per_collective[coll]["bytes"] += b
                a.bytes_accessed += b
                if outs:
                    a.by_shape[(f"{ns}.{name}", _sig(outs[0]))] += b
            return out
        from torch.utils.flop_counter import flop_registry
        fn = flop_registry.get(func.overloadpacket)
        if fn is not None:
            a.flops += fn(*args, **kwargs, out_val=out)
        if fresh:
            if name in _UNWRITTEN:
                return out
            b = sum(_nbytes(t) for t in outs)
        elif any(x.is_write for x in alias):
            i = _UPDATE_ARG.get(name)
            upd = args[i] if i is not None and i < len(args) else None
            b = _nbytes(upd) if isinstance(upd, torch.Tensor) else \
                sum(_nbytes(t) for t in outs)
        else:
            return out
        if b and outs:
            a.bytes_accessed += b
            op = f"aten.{name}" if ns == "aten" else f"{ns}.{name}"
            a.by_shape[(op, _sig(outs[0]))] += b
        return out


@contextlib.contextmanager
def count(args: Any = None) -> Iterator[Analysis]:
    """Run the block under the analysis and yield it, filled in as the
    block runs. ``args``, a tree of the step's input tensors (DTensors
    count their local shards), are live from the start: their bytes are
    ``argument_bytes`` and part of ``peak_bytes``."""
    from torch.distributed.tensor import DTensor

    a = Analysis()
    mode = _Counter(a)
    for t in tree_flatten(args)[0] if args is not None else ():
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            mode.track(t)
    a.argument_bytes = a.live_bytes
    prev, work.recorder = work.recorder, mode
    try:
        with mode:
            yield a
    finally:
        work.recorder = prev


def analyze(fn: Callable, *args, **kwargs) -> Analysis:
    """``fn(*args, **kwargs)`` run under :func:`count`; its Analysis."""
    with count() as a:
        fn(*args, **kwargs)
    return a
