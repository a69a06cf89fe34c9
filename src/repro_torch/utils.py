"""Small shared helpers: integer tiling arithmetic, the initializers,
device resolution and the parameter-tree helpers."""
from __future__ import annotations

import math
from typing import Any, Callable, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch import prng

#: A ``torch.Generator`` or a :mod:`repro_torch.prng` key.
Seed = Union[torch.Generator, np.ndarray]


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return ceil_div(a, b) * b


def glorot_uniform(generator: Seed, shape: tuple[int, ...],
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Glorot/Xavier uniform over the last two axes (fan_in, fan_out).
    From a ``torch.Generator``: drawn on the generator's device. From a
    :mod:`repro_torch.prng` key: the reference's draw bit for bit, on the
    CPU."""
    limit = math.sqrt(6.0 / (shape[-2] + shape[-1]))
    if not isinstance(generator, torch.Generator):
        return prng.uniform(generator, shape, -limit, limit).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    return out.uniform_(-limit, limit, generator=generator)


def normal_init(key: np.ndarray, shape: tuple[int, ...], stddev: float,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """stddev · N(0, 1) from a :mod:`repro_torch.prng` key, on the CPU:
    the reference's ``normal_init`` to within 3 ulp of its normal draw."""
    return (float(np.float32(stddev)) * prng.normal(key, shape)).to(dtype)


_SQRT2 = np.float32(np.sqrt(2.0))
# erf(∓2/√2) rounded to float32: the truncated normal's uniform bounds.
_TN_LO = np.float32(math.erf(float(np.float32(-2.0) / _SQRT2)))
_TN_HI = np.float32(math.erf(float(np.float32(2.0) / _SQRT2)))


def truncated_normal_init(key: Optional[Seed], shape: tuple[int, ...],
                          stddev: float, dtype: torch.dtype = torch.float32,
                          device: Union[str, torch.device] = "cpu"
                          ) -> torch.Tensor:
    """stddev · N(0, 1) truncated to (-2, 2), as the reference's
    ``truncated_normal_init``: √2·erfinv(u), u uniform between erf(∓√2),
    clipped inside the bounds. From a :mod:`repro_torch.prng` key: the
    reference's float32 draw to within a few ulp (the uniform bits are
    exact, the erfinv is XLA's polynomial), computed on the CPU, then
    moved to ``device`` (a bf16 result is the float32 draw rounded, not
    the reference's bf16 draw). From a ``torch.Generator``: drawn on the
    generator's device, then moved. On the ``meta`` device: shape and
    dtype only."""
    dev = torch.device(device)
    if dev.type == "meta":
        return torch.empty(shape, dtype=dtype, device=dev)
    lo = np.nextafter(np.float32(-2.0), np.float32(np.inf))
    hi = np.nextafter(np.float32(2.0), np.float32(-np.inf))
    if isinstance(key, torch.Generator):
        u = torch.empty(shape, dtype=torch.float32, device=key.device)
        u.uniform_(float(_TN_LO), float(_TN_HI), generator=key)
        z = torch.clamp(float(_SQRT2) * torch.erfinv(u), float(lo), float(hi))
    else:
        u = prng.uniform_np(key, shape, _TN_LO, _TN_HI)
        z = torch.from_numpy(np.clip(_SQRT2 * prng.erfinv_np(u), lo, hi))
    return (float(np.float32(stddev)) * z).to(device=dev, dtype=dtype)


def split_seed(seed: Optional[Seed], num: int) -> list:
    """``num`` independent seeds from one: :func:`prng.split` of a key, or
    the same ``torch.Generator`` ``num`` times (its stream advances with
    each draw); None (shapes only, on the ``meta`` device) stays None."""
    if seed is None or isinstance(seed, torch.Generator):
        return [seed] * num
    return list(prng.split(seed, num))


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``torch.device(device)``, refusing CUDA where no card is present:
    a CUDA entry point never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev


def tree_to(tree, device: Union[str, torch.device]):
    """``tree`` with every tensor leaf moved to ``device``."""
    return tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor)
                    else t, tree)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching parts of the
    trees in ``rest``: dicts, tuples, lists and NamedTuples are nodes,
    anything else (a tensor, None) a leaf. The structure is ``tree``'s: a
    leaf of ``tree`` hands ``fn`` whatever ``rest`` holds there. The
    result has ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):                  # a NamedTuple
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in ``jax.tree.leaves``' order (dict keys sorted), None
    leaves dropped."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_size(tree) -> int:
    """Total number of elements across the leaves of a nested dict (or
    tuple) of tensors."""
    return sum(int(np.prod(x.shape)) for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    """Total bytes across the leaves."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_scale(tree, s):
    return tree_map(lambda x: x * s, tree)


def tree_global_norm(tree) -> torch.Tensor:
    """√(Σ over the leaves of Σ x²), each leaf squared in fp32."""
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(x.to(torch.float32)))
         for x in tree_leaves(tree)])))


def tree_cast(tree, dtype: torch.dtype):
    return tree_map(lambda x: x.to(dtype), tree)


def count_params(params) -> int:
    return tree_size(params)


def flatten_dict(d: Mapping[str, Any], prefix: str = "",
                 sep: str = "/") -> dict[str, Any]:
    """Flatten a nested dict-of-dicts of arrays into {path: array}."""
    out: dict[str, Any] = {}
    for k, v in d.items():
        path = f"{prefix}{sep}{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_dict(v, path, sep))
        else:
            out[path] = v
    return out


def unflatten_dict(flat: Mapping[str, Any], sep: str = "/"
                   ) -> dict[str, Any]:
    """Inverse of :func:`flatten_dict`."""
    out: dict[str, Any] = {}
    for path, v in flat.items():
        keys = path.split(sep)
        cur = out
        for k in keys[:-1]:
            cur = cur.setdefault(k, {})
        cur[keys[-1]] = v
    return out


def onehot(labels: torch.Tensor, num_classes: int,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., num_classes) one-hot rows of integer ``labels``; a label
    outside [0, num_classes) gives a row of zeros, as ``jax.nn.one_hot``."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[..., None] == classes).to(dtype)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                          ) -> torch.Tensor:
    """Mean cross-entropy; ``labels`` are integer class ids (B,)."""
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - ll)


class _TakeLabel(torch.autograd.Function):
    """``torch.gather(logits, -1, idx)`` whose backward scatters into
    ``zeros_like(logits)``: the same values and, on plain tensors, the
    same ops as autograd's gather backward, which starts from
    ``grad.new_zeros(logits.shape)``. On DTensor logits that
    ``new_zeros``, of another shape than its input, is replicated: a zero
    tensor of the whole global logits on every rank. ``zeros_like`` keeps
    the logits' placements."""

    @staticmethod
    def forward(ctx, logits, idx):
        ctx.save_for_backward(logits, idx)
        return torch.gather(logits, -1, idx)

    @staticmethod
    def backward(ctx, grad):
        logits, idx = ctx.saved_tensors
        zeros = torch.zeros_like(logits)
        if type(zeros) is torch.Tensor:          # in place, as autograd's
            return zeros.scatter_add_(-1, idx, grad), None
        return zeros.scatter_add(-1, idx, grad), None    # DTensor may reshard


def softmax_cross_entropy_masked(logits: torch.Tensor, labels: torch.Tensor,
                                 mask: torch.Tensor) -> torch.Tensor:
    """Token-masked mean cross-entropy (LM training). logits (..., V);
    labels (...,) int; mask (...,) {0, 1}. The label's logit keeps its
    trailing axis until it is subtracted: on vocab-sharded DTensor logits
    the gather's masked partial sum is reduced there, and DTensor masks
    it only in the gather's own shape."""
    logz = torch.logsumexp(logits, dim=-1)
    ll = _TakeLabel.apply(logits, labels[..., None].long())
    mask = mask.to(logits.dtype)
    return torch.sum((logz[..., None] - ll)[..., 0] * mask) / \
        torch.clamp_min(torch.sum(mask), 1.0)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Fraction of rows whose arg-max logit is the label."""
    return torch.mean((torch.argmax(logits, dim=-1) == labels)
                      .to(torch.float32))
