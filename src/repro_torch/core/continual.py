"""Domain-incremental continual learning — the Fig. 4 protocol.

Counterpart of ``repro/core/continual.py``. Tasks arrive one after the
other with no identity at test time and a shared output head; training
mixes fresh examples with reservoir-sampled, stochastically quantized
replay. The run is described by two records plus a device backend:

  TrainerSpec   the learning rule and its knobs. ``algo="dfa"`` (DFA
                through time + SGD + ζ sparsification, Algorithm 1) is
                ported; ``"adam"`` (BPTT + Adam) is the next slice.
  ReplaySpec    rehearsal buffer capacity, mix ratio, quantizer bits and
                the host replay policy (:mod:`repro_torch.replay`).
  DeviceBackend the substrate (:mod:`repro_torch.backends`): the forward
                VMMs, the hidden ADC and the weight writes route through
                it.

Every random draw follows the reference's key chain
(:mod:`repro_torch.prng`) and every host draw its numpy generators, so
batches, replay codes and initial weights equal the reference's bit for
bit. Not ported yet (ROADMAP queue A): the legacy ``ContinualConfig``,
the padded ragged path (``pad``), observability streams (``obs``) and
the in-graph ``loss_aware`` policy; each raises.

Reported: R[t, i] = accuracy on task i after training through task t;
MA = mean of the final row (eq. 20).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch import prng
from repro_torch.backends import DeviceBackend, get_backend
from repro_torch.core import dfa as dfa_mod
from repro_torch.core.miru import (MiRUConfig, init_dfa_feedback,
                                   init_miru_params, miru_apply_readout)
from repro_torch.data.synthetic import TaskData
from repro_torch.telemetry import meters
from repro_torch.utils import accuracy, resolve_device


# ---------------------------------------------------------------------------
# Composable run specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrainerSpec:
    """The learning rule and its hyper-parameters."""
    algo: str = "dfa"                   # dfa (adam: next slice)
    epochs_per_task: int = 1
    batch_size: int = 32
    lr: float = 0.2                     # SGD step (dfa)
    hidden_lr_scale: float = 0.3        # per-layer update shift
    kwta_keep_frac: Optional[float] = 0.57  # ζ gradient sparsification
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ReplaySpec:
    """The rehearsal pipeline (§IV-A): buffer sizing plus the policy
    (None → ``reservoir``, the paper's hardware sampler)."""
    capacity: int = 512
    ratio: float = 0.5                  # fraction of each batch from replay
    bits: int = 4                       # stochastic-quantizer precision
    policy: Optional[str] = None

    @property
    def resolved_policy(self) -> str:
        return self.policy if self.policy is not None else "reservoir"


class ContinualConfig:
    """The reference's legacy flat record. Not ported: build a
    :class:`TrainerSpec`, a :class:`ReplaySpec` and a backend."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "ContinualConfig (the legacy flat record) is not ported "
            "(ROADMAP queue A); pass TrainerSpec + ReplaySpec + a backend")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue A)")


# ---------------------------------------------------------------------------
# Backend-parameterized forward
# ---------------------------------------------------------------------------

def _meter_chip_step(backend, cfg, B: int) -> None:
    """Per-time-step chip activity the software forward does not execute
    but the streaming hardware does (metered ×T by the enclosing scaled
    scope): the readout crossbar evaluates ŷᵗ every step (eq. 3) and the
    λ-interpolator blends every candidate state."""
    tele = backend.telemetry
    if not tele.enabled:
        return
    spec = backend.spec
    deltas = {f"{meters.MACS}/w_o": B * cfg.n_h * cfg.n_y,
              f"{meters.VMM_ROWS}/w_o": B,
              f"{meters.INTERP}/h": B * cfg.n_h,
              meters.SAMPLE_STEPS: B}
    if spec.input_bits:
        deltas[f"{meters.BIT_PULSES}/w_o"] = B * cfg.n_h * spec.input_bits
        deltas[f"{meters.WBS_PHASES}/w_o"] = B * spec.input_bits
    if spec.adc_bits is not None:
        deltas[f"{meters.ADC_CONVERSIONS}/out"] = B * cfg.n_y
    tele.record(deltas)


def miru_forward_device(params: dict[str, torch.Tensor], cfg: MiRUConfig,
                        x_seq: torch.Tensor, key: Optional[np.ndarray],
                        backend: DeviceBackend, state: Optional[Any] = None
                        ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """MiRU forward with the hidden recurrence routed through a device
    backend (``device_recurrence``: per-step VMMs, or the fused scan on
    substrates that have one), then the digital readout from the last
    step. ``key`` feeds the substrate's noise, ``state`` is its device
    state (the G⁺/G⁻ pairs of ``analog_state``). Meters the streamed
    per-step readout and the interpolator when the backend's telemetry is
    on."""
    B, T, _ = x_seq.shape
    tele = backend.telemetry
    h_all, h_prev, pre = backend.device_recurrence(params, cfg, x_seq, key,
                                                   state=state)
    with tele.scaled(T):
        _meter_chip_step(backend, cfg, B)
    tele.record({meters.SEQUENCES: B})
    logits = miru_apply_readout(params, cfg, h_all[:, -1, :])
    return logits, {"h_all": h_all, "h_prev": h_prev, "pre": pre}


# ---------------------------------------------------------------------------
# Train/eval steps
# ---------------------------------------------------------------------------

def _make_raw_steps(cfg: MiRUConfig, trainer: TrainerSpec,
                    backend: DeviceBackend):
    """(train_step, evaluate) for the learning rule on ``backend``:

    ``train_step(params, opt_state, key, x, y, dev_state) -> (params,
    opt_state, loss, applied, dev_state)`` splits ``key`` into the
    forward's and the write's keys, takes the DFA gradients through the
    backend's forward, ζ-sparsifies and scales them, and hands the write
    to the device. ``evaluate(params, key, x, y, dev_state)`` is the
    accuracy of the backend's forward."""
    if trainer.algo == "adam":
        raise NotImplementedError(
            "algo='adam' (BPTT + Adam, the software baseline) is the next "
            "slice of the port (ROADMAP queue A, slice 4)")
    if trainer.algo != "dfa":
        raise ValueError(f"unknown trainer algo {trainer.algo!r}; "
                         f"expected 'adam' or 'dfa'")

    def train_step(params, opt_state, key, x, y, dev_state):
        k_fwd, k_wr = prng.split(key)
        loss, grads = dfa_mod.dfa_grads(
            params, opt_state["psi"], cfg, x, y,
            forward_fn=lambda p, c, xs: miru_forward_device(
                p, c, xs, k_fwd, backend, dev_state))
        updates = dfa_mod.scaled_sparse_updates(
            grads, trainer.lr, trainer.kwta_keep_frac,
            trainer.hidden_lr_scale)
        params, applied, dev_state = backend.device_apply_update(
            params, updates, k_wr, state=dev_state)
        return params, opt_state, loss, applied, dev_state

    def evaluate(params, key, x, y, dev_state):
        logits, _ = miru_forward_device(params, cfg, x, key, backend,
                                        dev_state)
        return accuracy(logits, y)

    return train_step, evaluate


def _to_device(state: Any, dev: torch.device) -> Any:
    """A device state (nested dicts of tensors, or None) moved to
    ``dev``."""
    if isinstance(state, dict):
        return {k: _to_device(v, dev) for k, v in state.items()}
    return state.to(dev) if isinstance(state, torch.Tensor) else state


def _init_run(cfg: MiRUConfig, trainer: TrainerSpec,
              backend: DeviceBackend,
              device: Union[str, torch.device] = "cuda"):
    """The run's initial state — (key, params, Ψ, device state) — from
    the trainer's seed, on the reference's key chain: the key splits into
    (key, k_param, k_psi), the device state's key is folded off to the
    side."""
    key = prng.PRNGKey(trainer.seed)
    key, k_param, k_psi = prng.split(key, 3)
    params = init_miru_params(k_param, cfg, device)
    psi = init_dfa_feedback(k_psi, cfg, device=device)
    dev_state = backend.init_device_state(params,
                                          prng.fold_in(key, 0x0DE5))
    return key, params, psi, dev_state


# ---------------------------------------------------------------------------
# Batch schedule — the replay-mixed training stream, materialized
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BatchSchedule:
    """The full train-batch stream for a task sequence: ``x[t]`` is
    (S_t, B, T, F), ``y[t]`` (S_t, B). Batch content (epoch shuffles,
    replay offers, quantized rehearsal draws) is a pure function of
    (trainer, replay, tasks), so the stream is materialized up front.
    ``replay_traffic`` tallies the host buffer's DRAM traffic consumed
    while building it; ``occupancy[t][s]`` is the buffer's fill after
    step s of task t."""
    x: list[np.ndarray]
    y: list[np.ndarray]
    replay_traffic: dict = dataclasses.field(default_factory=dict)
    occupancy: list[np.ndarray] = dataclasses.field(default_factory=list)

    @property
    def steps_per_task(self) -> list[int]:
        return [xt.shape[0] for xt in self.x]


def _stream_context(tasks: list[TaskData]) -> dict[str, int]:
    """The full label range and the task count, for partitioned
    policies."""
    n_classes = int(max(int(t.y_train.max()) for t in tasks)) + 1
    return {"n_classes": max(n_classes, 2), "n_tasks": len(tasks)}


def build_batch_schedule(trainer: TrainerSpec, replay: ReplaySpec,
                         tasks: list[TaskData],
                         pad: Optional[Any] = None) -> BatchSchedule:
    """Materialize the replay-mixed batch stream, consuming the host RNG
    streams (epoch shuffle, replay-policy sampler, stochastic quantizer)
    in exactly the reference's order: each epoch shuffles with
    ``default_rng(seed + 1)``; past task 0 the last round(B·ratio) rows
    of each batch are rehearsal draws; only the fresh rows are offered
    to the buffer. The final partial batch of an epoch is dropped."""
    from repro_torch.core.replay import ReplayBuffer
    from repro_torch.replay import get_policy_class, make_policy

    if pad is not None:
        raise _not_ported("the padded ragged schedule (pad=)")
    if get_policy_class(replay.resolved_policy).in_graph:
        raise _not_ported(f"the in-graph replay policy "
                          f"{replay.resolved_policy!r}")
    T, F = tasks[0].x_train.shape[1:]
    bs = trainer.batch_size
    policy = make_policy(replay.resolved_policy, replay.capacity,
                         seed=trainer.seed, **_stream_context(tasks))
    buffer = ReplayBuffer(replay.capacity, (T, F), n_bits=replay.bits,
                          seed=trainer.seed, policy=policy)
    host_rng = np.random.default_rng(trainer.seed + 1)

    xs_all, ys_all, occ_all = [], [], []
    for t, task in enumerate(tasks):
        n = task.x_train.shape[0]
        xs_t, ys_t, occ_t = [], [], []
        for _ in range(trainer.epochs_per_task):
            order = host_rng.permutation(n)
            for s in range(0, n - bs + 1, bs):
                idx = order[s:s + bs]
                xb = task.x_train[idx]
                yb = task.y_train[idx]
                n_rep = 0
                if t > 0 and buffer.size > 0 and replay.ratio > 0:
                    n_rep = int(round(bs * replay.ratio))
                    if n_rep > 0:
                        xr, yr = buffer.sample(host_rng, n_rep)
                        xb = np.concatenate([xb[:bs - n_rep],
                                             xr.reshape(-1, T, F)])
                        yb = np.concatenate([yb[:bs - n_rep], yr])
                n_fresh = bs - n_rep
                if n_fresh > 0:
                    buffer.add_batch(xb[:n_fresh], yb[:n_fresh],
                                     task_ids=np.full(n_fresh, t))
                xs_t.append(xb)
                ys_t.append(yb)
                occ_t.append(buffer.size)
        xs_all.append(np.stack(xs_t) if xs_t
                      else np.zeros((0, bs, T, F), np.float32))
        ys_all.append(np.stack(ys_t) if ys_t
                      else np.zeros((0, bs), np.int32))
        occ_all.append(np.asarray(occ_t, np.int32))
    return BatchSchedule(x=xs_all, y=ys_all,
                         replay_traffic=dict(buffer.traffic),
                         occupancy=occ_all)


def evaluate_tasks(evaluate, params, key, tasks: list[TaskData],
                   upto: int, dev_state=None,
                   device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """Accuracy on the test sets of tasks 0..``upto``, each in one batch
    on ``device``."""
    dev = resolve_device(device)
    accs = np.zeros(upto + 1)
    for i, task in enumerate(tasks[:upto + 1]):
        accs[i] = float(evaluate(params, key,
                                 torch.from_numpy(task.x_test).to(dev),
                                 torch.from_numpy(task.y_test).to(dev),
                                 dev_state))
    return accs


# ---------------------------------------------------------------------------
# Main loop
# ---------------------------------------------------------------------------

def run_continual(cfg: MiRUConfig, spec: TrainerSpec,
                  tasks: list[TaskData],
                  replay: Optional[ReplaySpec] = None,
                  device: Union[str, DeviceBackend, None] = None,
                  obs: Optional[Any] = None, pad: Optional[Any] = None,
                  torch_device: Union[str, torch.device] = "cuda",
                  init: Optional[tuple] = None) -> dict[str, Any]:
    """Train through the task sequence on ``torch_device``; return the R
    matrix, MA, the mean accuracy after each task, the per-step losses
    and the final params, plus ``device_state`` (a stateful substrate's,
    e.g. ``analog_state``'s G⁺/G⁻ pairs), ``endurance`` (the backend's
    tracker, under ``track_endurance``) and ``telemetry`` (when the
    backend's is on).

    ``device`` is a registered backend name or instance (default
    ``"ideal"``). ``init`` replaces the seeded initial state with
    (key, params, Ψ) or (key, params, Ψ, device state) — e.g. the
    reference's, carried across with
    :func:`repro_torch.convert.run_state_from_numpy` and
    :func:`~repro_torch.convert.device_state_from_numpy` — so two runs
    start from identical weights (and conductances) whatever the last bit
    of ``normal`` does; without a device state the backend programs one
    from the key.

    The loop runs under ``torch.no_grad()``; each task's batches move to
    the card once, and losses are read back once, at the end."""
    if not isinstance(spec, TrainerSpec):
        raise NotImplementedError(
            "run_continual takes a TrainerSpec; the legacy "
            "ContinualConfig is not ported (ROADMAP queue A)")
    if obs is not None:
        raise _not_ported("observability streams (obs=)")
    dev = resolve_device(torch_device)
    rspec = replay if replay is not None else ReplaySpec()
    backend = get_backend(device if device is not None else "ideal")
    if backend.tracker is not None and backend.tracker.updates_applied:
        warnings.warn(
            "device backend carries endurance statistics from a previous "
            "run; write counts will accumulate across runs — pass a fresh "
            "backend for per-run statistics", stacklevel=2)

    if init is None:
        key, params, psi, dev_state = _init_run(cfg, spec, backend, dev)
    else:
        key, params, psi = init[:3]
        params = {k: v.to(dev) for k, v in params.items()}
        psi = psi.to(dev)
        if len(init) > 3:
            dev_state = _to_device(init[3], dev)
        else:
            dev_state = backend.init_device_state(params,
                                                  prng.fold_in(key, 0x0DE5))
    schedule = build_batch_schedule(spec, rspec, tasks, pad=pad)
    train_step, evaluate = _make_raw_steps(cfg, spec, backend)
    opt_state = {"psi": psi}
    if backend.telemetry.enabled and schedule.replay_traffic:
        backend.telemetry.record(schedule.replay_traffic)

    n_tasks = len(tasks)
    R = np.zeros((n_tasks, n_tasks))
    losses: list[torch.Tensor] = []
    with torch.no_grad():
        for t in range(n_tasks):
            xs = torch.from_numpy(schedule.x[t]).to(dev)
            ys = torch.from_numpy(schedule.y[t]).to(dev)
            for s in range(xs.shape[0]):
                key, k_step = prng.split(key)
                params, opt_state, loss, applied, dev_state = train_step(
                    params, opt_state, k_step, xs[s], ys[s], dev_state)
                losses.append(loss)
                backend.record_endurance(applied)
            key, k_eval = prng.split(key)
            R[t, :t + 1] = evaluate_tasks(evaluate, params, k_eval, tasks,
                                          t, dev_state, dev)

    out: dict[str, Any] = {
        "R": R,
        "MA": float(R[-1, :].mean()),
        "acc_after_each": [float(R[t, :t + 1].mean())
                           for t in range(n_tasks)],
        "losses": (torch.stack(losses).cpu().tolist() if losses else []),
        "params": params,
    }
    if dev_state is not None:
        out["device_state"] = dev_state
    if backend.tracker is not None:
        out["endurance"] = backend.tracker
    if backend.telemetry.enabled:
        out["telemetry"] = backend.telemetry
    return out
