"""In-graph replay buffer: a device-resident rehearsal store carried
through the training steps, for training-state-dependent policies
(``loss_aware``). Counterpart of ``repro/replay/ingraph.py``.

Host policies decide slot selection while the batch schedule is built,
before training starts; loss-prioritized replay cannot, since an
example's priority is its last-seen loss. So this buffer is a dict of
tensors on the run's device — quantized feature codes, labels,
priorities, an occupancy counter (a 0-d tensor) — threaded through the
train step, with pure functions for its operations:

  ingraph_init     allocate the empty buffer
  ingraph_insert   offer a batch (fill, then evict by priority when full)
  ingraph_sample / ingraph_mix
                   priority-proportional rehearsal draw, spliced into
                   the tail of the fresh batch

Each is a deterministic function of (state, key, inputs). The keys and
the quantizer's and the Gumbel draw's uniforms come from the host's
:mod:`repro_torch.prng` chain, as the reference's do from its key chain;
everything that depends on the buffer's contents stays on the device
(``torch.where`` selections, no ``.item()``), so an insert never waits
on the card. Features are stored as stochastic-quantized codes (the
host buffer's quantizer and dtype rule) and dequantized on the paper's
1/2^n scale at sample time.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.replay import (_code_torch_dtype, dequantize,
                                     stochastic_quantize)

ReplayState = dict[str, torch.Tensor]

#: Priority floor added before the log in priority-proportional sampling:
#: keeps just-filled (zero-priority) slots drawable and the categorical
#: logits finite.
_PRIO_EPS = 1e-6


def ingraph_init(capacity: int, feature_shape: tuple[int, ...],
                 n_bits: int, device: Union[str, torch.device] = "cpu"
                 ) -> ReplayState:
    """The empty buffer on ``device``: all slots unoccupied
    (``size == 0``)."""
    return {
        "feat": torch.zeros((capacity, *feature_shape),
                            dtype=_code_torch_dtype(n_bits), device=device),
        "label": torch.zeros((capacity,), dtype=torch.int32, device=device),
        "prio": torch.zeros((capacity,), dtype=torch.float32, device=device),
        "size": torch.zeros((), dtype=torch.int32, device=device),
    }


def _class_counts(label: torch.Tensor, weight: torch.Tensor,
                  n_classes: int) -> torch.Tensor:
    """Σ weight per label over ``n_classes`` bins; labels outside the
    range are dropped (the reference's ``mode="drop"``)."""
    inside = (label >= 0) & (label < n_classes)
    out = torch.zeros((n_classes,), dtype=weight.dtype, device=label.device)
    return out.index_add_(0, torch.where(inside, label, 0).long(),
                          torch.where(inside, weight, 0))


def ingraph_insert(state: ReplayState, key: np.ndarray, xs: torch.Tensor,
                   ys: torch.Tensor, prios: torch.Tensor, n_bits: int,
                   valid: Optional[torch.Tensor] = None,
                   decay: float = 1.0,
                   n_classes: Optional[int] = None) -> ReplayState:
    """Offer a batch of (features, label, priority) rows, one row after
    the other. While the buffer fills, every valid row is appended; once
    full, a row replaces the minimum-priority slot iff its priority
    exceeds it. ``valid`` masks rows that must not be offered (rehearsed
    tail rows are never re-offered).

    ``decay`` < 1 multiplies every stored priority once, before the new
    rows compete (stored CE scores go stale as the model trains on);
    ``decay=1`` is the undecayed buffer. ``n_classes`` switches eviction
    to the class-aware rule: a row whose class holds fewer slots than
    the largest class always enters, evicting the minimum-priority slot
    of that largest class; a row of a largest class must beat the
    minimum stored priority of its own class. ``n_classes=None`` is the
    global rule.

    Row i is stochastically quantized on key ``fold_in(key, i)``, all
    rows in one call, as the reference does."""
    B = xs.shape[0]
    capacity = state["feat"].shape[0]
    dev = state["feat"].device
    if valid is None:
        valid = torch.ones((B,), dtype=torch.bool, device=dev)
    prio = state["prio"]
    if decay != 1.0:
        prio = prio * decay
    q = stochastic_quantize(xs, prng.fold_in(key, np.arange(B)), n_bits)
    feat, label = state["feat"].clone(), state["label"].clone()
    prio, size = prio.clone(), state["size"]
    slots = torch.arange(capacity, device=dev)
    ys32 = ys.to(torch.int32)
    prios = prios.to(torch.float32)
    for i in range(B):
        full = size >= capacity
        if n_classes is None:
            evict = torch.argmin(prio)
            beat = prios[i] > prio[evict]
        else:
            occ = slots < size
            counts = _class_counts(label, occ.to(torch.int32), n_classes)
            cls = ys32[i].long()
            big = torch.argmax(counts)
            under = counts[cls] < counts[big]
            victim = torch.where(under, big, cls)
            in_cls = (label == victim) & occ
            evict = torch.argmin(torch.where(in_cls, prio,
                                             torch.full_like(prio,
                                                             float("inf"))))
            beat = under | (prios[i] > prio[evict])
        slot = torch.where(full, evict, size.long()).reshape(1)
        accept = valid[i] & (~full | beat)
        feat.index_copy_(0, slot, torch.where(accept, q[i:i + 1],
                                              feat.index_select(0, slot)))
        label.index_copy_(0, slot, torch.where(accept, ys32[i:i + 1],
                                               label.index_select(0, slot)))
        prio.index_copy_(0, slot, torch.where(accept, prios[i:i + 1],
                                              prio.index_select(0, slot)))
        size = torch.clamp(size + accept.to(torch.int32), max=capacity)
    return {"feat": feat, "label": label, "prio": prio, "size": size}


def ingraph_sample(state: ReplayState, key: np.ndarray, batch: int,
                   n_bits: int, n_classes: Optional[int] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Priority-proportional rehearsal draw (with replacement) over the
    occupied slots: P(slot) ∝ priority + ε, through
    :func:`repro_torch.prng.categorical`. With ``n_classes`` the
    priorities are normalized per class first (each observed class gets
    equal total probability, split within the class by priority). On an
    empty buffer the draw is slot 0 (zeros): callers gate mixing on
    ``size > 0``. Returns dequantized features and labels."""
    capacity = state["feat"].shape[0]
    slots = torch.arange(capacity, device=state["feat"].device)
    occupied = slots < state["size"]
    pr = torch.where(occupied, state["prio"] + _PRIO_EPS,
                     torch.zeros_like(state["prio"]))
    if n_classes is not None:
        cls_sum = _class_counts(state["label"], pr, n_classes)
        per_row = cls_sum[state["label"].long().clamp(0, n_classes - 1)]
        pr = pr / torch.clamp(per_row, min=_PRIO_EPS)
    neg_inf = torch.full_like(pr, -float("inf"))
    logits = torch.where(occupied, torch.log(pr), neg_inf)
    safe = torch.where(slots == 0, torch.zeros_like(pr), neg_inf)
    logits = torch.where(state["size"] > 0, logits, safe)
    idx = prng.categorical(key, logits, (batch,))
    return dequantize(state["feat"][idx], n_bits), state["label"][idx]


def ingraph_mix(state: ReplayState, key: np.ndarray, x: torch.Tensor,
                y: torch.Tensor, n_rep: int, active: torch.Tensor,
                n_bits: int, n_classes: Optional[int] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fresh batch with its tail ``n_rep`` rows replaced by a
    rehearsal draw where ``active`` (a bool tensor: replay on, past task
    0, buffer non-empty) — the host schedule's tail layout.
    ``n_classes`` enables the class-normalized draw
    (:func:`ingraph_sample`)."""
    if n_rep <= 0:
        return x, y
    B = x.shape[0]
    active = active & (state["size"] > 0)
    xr, yr = ingraph_sample(state, key, n_rep, n_bits, n_classes)
    mixed_x = torch.cat([x[:B - n_rep], xr.to(x.dtype)])
    mixed_y = torch.cat([y[:B - n_rep], yr.to(y.dtype)])
    return torch.where(active, mixed_x, x), torch.where(active, mixed_y, y)


def per_example_ce(logits: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    """Per-example softmax cross-entropy — the ``loss_aware`` priority
    (``utils.softmax_cross_entropy`` is its batch mean)."""
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return logz - ll
