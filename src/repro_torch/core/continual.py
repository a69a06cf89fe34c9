"""Domain-incremental continual learning — the Fig. 4 protocol.

Counterpart of ``repro/core/continual.py``. Tasks arrive one after the
other with no identity at test time and a shared output head; training
mixes fresh examples with reservoir-sampled, stochastically quantized
replay. The run is described by two records plus a device backend:

  TrainerSpec   the learning rule and its knobs: ``algo="dfa"`` (DFA
                through time + SGD + ζ sparsification, Algorithm 1) or
                ``"adam"`` (BPTT + Adam, the paper's software baseline;
                the quantized substrates backpropagate through their
                straight-through estimators).
  ReplaySpec    rehearsal buffer capacity, mix ratio, quantizer bits and
                the replay policy (:mod:`repro_torch.replay`): a host
                policy materialized into the schedule, or ``loss_aware``
                on the device-resident buffer of
                :mod:`repro_torch.replay.ingraph`.
  DeviceBackend the substrate (:mod:`repro_torch.backends`): the forward
                VMMs, the hidden ADC and the weight writes route through
                it.

``ContinualConfig`` is the legacy flat record (trainer strings ``adam``,
``dfa``, ``dfa_hw``), mapped onto the specs by
:meth:`ContinualConfig.specs`. ``pad`` (a
:class:`repro_torch.data.ragged.PadPolicy`) runs ragged task streams
through the masked step and eval twins.

Every random draw follows the reference's key chain
(:mod:`repro_torch.prng`) and every host draw its numpy generators, so
batches, replay codes and initial weights equal the reference's bit for
bit. ``obs`` (a :class:`repro_torch.obs.ObsSpec`) records the per-step
metric streams into a :class:`~repro_torch.obs.RunLog`.

Reported: R[t, i] = accuracy on task i after training through task t;
MA = mean of the final row (eq. 20).
"""
from __future__ import annotations

import dataclasses
import hashlib
import warnings
from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch import prng
from repro_torch.analog.crossbar import CrossbarSpec
from repro_torch.backends import DeviceBackend, DeviceSpec, get_backend
from repro_torch.core import dfa as dfa_mod
from repro_torch.core.miru import (MiRUConfig, init_dfa_feedback,
                                   init_miru_params, miru_apply_readout)
from repro_torch.data.synthetic import TaskData
from repro_torch.optim.optimizers import adam
from repro_torch.telemetry import meters
from repro_torch.utils import accuracy, resolve_device, softmax_cross_entropy


# ---------------------------------------------------------------------------
# Composable run specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrainerSpec:
    """The learning rule and its hyper-parameters."""
    algo: str = "dfa"                   # adam | dfa
    epochs_per_task: int = 1
    batch_size: int = 32
    lr: float = 0.2                     # SGD step (dfa)
    hidden_lr_scale: float = 0.3        # per-layer update shift
    adam_lr: float = 1e-3               # Adam step (adam)
    kwta_keep_frac: Optional[float] = 0.57  # ζ gradient sparsification
    seed: int = 0
    # The fused recurrence where the substrate has one (bitwise equal to
    # the per-step path): None defers to the backend (fused where it is
    # valid), False forces the per-step path.
    fused_recurrence: Optional[bool] = None


@dataclasses.dataclass(frozen=True)
class ReplaySpec:
    """The rehearsal pipeline (§IV-A): buffer sizing plus the policy
    (None → ``reservoir``, the paper's hardware sampler). ``decay``
    multiplies every stored in-graph priority once an offer round, before
    the fresh rows compete (``loss_aware``; host policies ignore it)."""
    capacity: int = 512
    ratio: float = 0.5                  # fraction of each batch from replay
    bits: int = 4                       # stochastic-quantizer precision
    policy: Optional[str] = None
    decay: float = 0.9

    @property
    def resolved_policy(self) -> str:
        return self.policy if self.policy is not None else "reservoir"


# Legacy trainer string → (algorithm, backend name).
TRAINER_ALIASES: dict[str, tuple[str, str]] = {
    "adam": ("adam", "ideal"),
    "dfa": ("dfa", "ideal"),
    "dfa_hw": ("dfa", "analog"),
}


@dataclasses.dataclass(frozen=True)
class ContinualConfig:
    """Legacy flat config — a deprecation shim over the composable specs
    (:meth:`specs`). New code builds a :class:`TrainerSpec`, a
    :class:`ReplaySpec` and a backend."""
    trainer: str = "dfa"                # adam | dfa | dfa_hw
    epochs_per_task: int = 1
    batch_size: int = 32
    lr: float = 0.2
    hidden_lr_scale: float = 0.3
    adam_lr: float = 1e-3
    kwta_keep_frac: Optional[float] = 0.57
    replay_capacity: int = 512
    replay_ratio: float = 0.5
    replay_bits: int = 4
    # Hardware-like model knobs (dfa_hw):
    input_bits: int = 8
    adc_bits: int = 8
    adc_range: float = 4.0
    gain_sigma: float = 0.02            # WBS memristor-ratio variability
    write_sigma: float = 0.10           # §V-B device write variation
    weight_clip: float = 1.5            # crossbar dynamic range (logical)
    track_endurance: bool = False
    seed: int = 0
    fused_recurrence: Optional[bool] = None

    def specs(self) -> tuple[TrainerSpec, ReplaySpec, DeviceBackend]:
        """(TrainerSpec, ReplaySpec, DeviceBackend) for the flat record;
        the trainer string resolves through :data:`TRAINER_ALIASES`
        (``dfa_hw`` is DFA on ``analog``)."""
        try:
            algo, backend_name = TRAINER_ALIASES[self.trainer]
        except KeyError:
            raise ValueError(
                f"unknown trainer {self.trainer!r}; expected one of "
                f"{sorted(TRAINER_ALIASES)}") from None
        trainer = TrainerSpec(algo=algo,
                              epochs_per_task=self.epochs_per_task,
                              batch_size=self.batch_size, lr=self.lr,
                              hidden_lr_scale=self.hidden_lr_scale,
                              adam_lr=self.adam_lr,
                              kwta_keep_frac=self.kwta_keep_frac,
                              seed=self.seed,
                              fused_recurrence=self.fused_recurrence)
        replay = ReplaySpec(capacity=self.replay_capacity,
                            ratio=self.replay_ratio, bits=self.replay_bits)
        if backend_name == "analog":
            dspec = DeviceSpec(
                input_bits=self.input_bits, adc_bits=self.adc_bits,
                adc_range=self.adc_range, gain_sigma=self.gain_sigma,
                weight_clip=self.weight_clip,
                crossbar=CrossbarSpec(write_sigma=self.write_sigma,
                                      read_sigma=0.0,
                                      w_clip=self.weight_clip),
                track_endurance=self.track_endurance)
        else:
            dspec = DeviceSpec(track_endurance=self.track_endurance)
        return trainer, replay, get_backend(backend_name, spec=dspec)


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
                        backend: DeviceBackend, state: Optional[Any] = None,
                        fused: Optional[bool] = None,
                        lengths: Optional[torch.Tensor] = None
                        ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """MiRU forward with the hidden recurrence routed through a device
    backend (``device_recurrence``: per-step VMMs, or the fused scan on
    substrates that have one; ``fused=False`` forces the per-step path),
    then the digital readout. ``key`` feeds the substrate's noise,
    ``state`` is its device state (the G⁺/G⁻ pairs of ``analog_state``).
    ``lengths`` ((B,) int) reads each row's readout at its own last true
    step (zero-end-padded ragged rows; the recurrence is causal, so the
    padding never reaches the states read); None reads t = T−1, the
    historical program. Meters the streamed per-step readout and the
    interpolator when the backend's telemetry is on (the padded tail is
    metered as executed work, as in the reference)."""
    B, T, _ = x_seq.shape
    tele = backend.telemetry
    h_all, h_prev, pre = backend.device_recurrence(params, cfg, x_seq, key,
                                                   state=state, fused=fused)
    with tele.scaled(T):
        _meter_chip_step(backend, cfg, B)
    tele.record({meters.SEQUENCES: B})
    if lengths is None:
        h_last = h_all[:, -1, :]
    else:
        idx = (lengths.long() - 1)[:, None, None].expand(B, 1,
                                                         h_all.shape[-1])
        h_last = torch.gather(h_all, 1, idx)[:, 0, :]
    logits = miru_apply_readout(params, cfg, h_last)
    return logits, {"h_all": h_all, "h_prev": h_prev, "pre": pre}


def hw_miru_forward(params: dict[str, torch.Tensor], cfg: MiRUConfig,
                    x_seq: torch.Tensor, key: Optional[np.ndarray],
                    ccfg: ContinualConfig
                    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Deprecated: the old hardware forward. Equivalent to
    :func:`miru_forward_device` on the ``analog`` backend built from
    ``ccfg`` (its ``dfa_hw`` specs)."""
    warnings.warn("hw_miru_forward is deprecated; use miru_forward_device "
                  "with repro_torch.backends.get_backend('analog')",
                  DeprecationWarning, stacklevel=2)
    _, _, backend = dataclasses.replace(ccfg, trainer="dfa_hw").specs()
    return miru_forward_device(params, cfg, x_seq, key, backend)


# ---------------------------------------------------------------------------
# Train/eval steps
# ---------------------------------------------------------------------------

def _adam_step(backend, opt, loss_fn):
    """The BPTT + Adam train step around ``loss_fn(params, x, y, k_fwd,
    dev_state, *masks) -> loss``: autograd on for the loss alone (the
    loop runs under ``torch.no_grad()``), then Adam and the backend's
    write."""
    def train_step(params, opt_state, key, x, y, dev_state, *masks):
        k_fwd, k_wr = prng.split(key)
        with torch.enable_grad():
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params.items()}
            loss = loss_fn(leaves, x, y, k_fwd, dev_state, *masks)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        updates, opt_state = opt.update(dict(zip(leaves, grads)), opt_state,
                                        params)
        params, applied, dev_state = backend.device_apply_update(
            params, updates, k_wr, state=dev_state)
        return params, opt_state, loss.detach(), applied, dev_state
    return train_step


def _dfa_step(cfg, trainer, backend, fwd):
    """The DFA + ζ-SGD train step: ``fwd(params, x, k_fwd, dev_state,
    lengths)``; ``valid``/``lengths`` are the masked twin's row and time
    masks (None: the unmasked step)."""
    def train_step(params, opt_state, key, x, y, dev_state, valid=None,
                   lengths=None):
        k_fwd, k_wr = prng.split(key)
        loss, grads = dfa_mod.dfa_grads(
            params, opt_state["psi"], cfg, x, y,
            forward_fn=lambda p, c, xs: fwd(p, xs, k_fwd, dev_state,
                                            lengths),
            row_valid=valid, lengths=lengths)
        # ζ-sparsify, scale per layer, hand the write to the device.
        updates = dfa_mod.scaled_sparse_updates(
            grads, trainer.lr, trainer.kwta_keep_frac,
            trainer.hidden_lr_scale)
        params, applied, dev_state = backend.device_apply_update(
            params, updates, k_wr, state=dev_state)
        return params, opt_state, loss, applied, dev_state
    return train_step


def _check_algo(trainer: TrainerSpec) -> None:
    if trainer.algo not in ("adam", "dfa"):
        raise ValueError(f"unknown trainer algo {trainer.algo!r}; "
                         f"expected 'adam' or 'dfa'")


def _make_raw_steps(cfg: MiRUConfig, trainer: TrainerSpec,
                    backend: DeviceBackend):
    """(train_step, evaluate, opt) for the learning rule on ``backend``:

    ``train_step(params, opt_state, key, x, y, dev_state) -> (params,
    opt_state, loss, applied, dev_state)`` splits ``key`` into the
    forward's and the write's keys, takes the rule's gradients through
    the backend's forward (DFA: ζ-sparsified and scaled; Adam: true
    gradients by autograd, through the straight-through estimators on the
    quantized substrates) and hands the write to the device.
    ``evaluate(params, key, x, y, dev_state)`` is the accuracy of the
    backend's forward. ``opt`` is the Adam transform (its state is
    ``opt.init(params)``; DFA's state is ``{"psi": Ψ}``)."""
    _check_algo(trainer)
    opt = adam(trainer.adam_lr)

    def fwd(p, xs, k, st, lengths=None):
        return miru_forward_device(p, cfg, xs, k, backend, st,
                                   fused=trainer.fused_recurrence,
                                   lengths=lengths)

    if trainer.algo == "adam":
        def loss_fn(p, x, y, k, st):
            logits, _ = fwd(p, x, k, st)
            return softmax_cross_entropy(logits, y)
        train_step = _adam_step(backend, opt, loss_fn)
    else:
        train_step = _dfa_step(cfg, trainer, backend, fwd)

    def evaluate(params, key, x, y, dev_state):
        logits, _ = fwd(params, x, key, dev_state)
        return accuracy(logits, y)

    return train_step, evaluate, opt


def _make_masked_steps(cfg: MiRUConfig, trainer: TrainerSpec,
                       backend: DeviceBackend):
    """The masked twins of :func:`_make_raw_steps` for padded ragged
    schedules (:mod:`repro_torch.data.ragged`): ``train_step(params,
    opt_state, key, x, y, dev_state, valid, lengths)`` and
    ``evaluate(params, key, x, y, dev_state, valid, lengths)``. ``valid``
    is the (B,) row mask (padded rows add nothing to loss, gradients or
    accuracy), ``lengths`` the (B,) true sequence lengths (readout and
    DFA error at each row's own last step). Masks multiply by exactly
    0.0/1.0 and every mean divides by Σvalid clamped at 1, so an
    all-valid, full-length batch computes the raw steps' values to the
    last ulp."""
    _check_algo(trainer)
    opt = adam(trainer.adam_lr)

    def fwd(p, xs, k, st, lengths):
        return miru_forward_device(p, cfg, xs, k, backend, st,
                                   fused=trainer.fused_recurrence,
                                   lengths=lengths)

    if trainer.algo == "adam":
        def loss_fn(p, x, y, k, st, valid, lengths):
            logits, _ = fwd(p, x, k, st, lengths)
            m = valid.to(logits.dtype)
            logz = torch.logsumexp(logits, dim=-1)
            ll = torch.gather(logits, -1, y[:, None].long())[:, 0]
            return torch.sum((logz - ll) * m) / torch.clamp(torch.sum(m),
                                                             min=1.0)
        train_step = _adam_step(backend, opt, loss_fn)
    else:
        train_step = _dfa_step(cfg, trainer, backend, fwd)

    def evaluate(params, key, x, y, dev_state, valid, lengths):
        logits, _ = fwd(params, x, key, dev_state, lengths)
        m = valid.to(torch.float32)
        ok = (torch.argmax(logits, dim=-1) == y).to(torch.float32)
        return torch.sum(ok * m) / torch.clamp(torch.sum(m), min=1.0)

    return train_step, evaluate, opt


def _make_ingraph_replay_step(cfg: MiRUConfig, trainer: TrainerSpec,
                              rspec: ReplaySpec, backend: DeviceBackend,
                              raw_train):
    """A raw train step wrapped with the device-resident replay buffer of
    the training-state-dependent policies (``loss_aware``). The step takes
    *fresh-only* schedule batches and at run time splices a
    priority-proportional rehearsal draw into the batch tail (the host
    schedule's tail layout), trains, scores the batch's per-example loss
    with one more forward on the updated params (the last-seen-loss
    priority) and offers the fresh rows to the buffer
    (:mod:`repro_torch.replay.ingraph`). Its extra keys are folded off
    the step key, so the training and eval chains stay the host policies'.

    ``step(params, opt_state, key, x, y, dev_state, rstate, replay_on) ->
    (params, opt_state, loss, applied, dev_state, rstate)``, ``replay_on``
    a bool (past task 0). Nothing in it reads a device value back to the
    host."""
    from repro_torch.replay.ingraph import (ingraph_insert, ingraph_mix,
                                            per_example_ce)

    n_rep = (int(round(trainer.batch_size * rspec.ratio))
             if rspec.ratio > 0 else 0)
    bits = rspec.bits

    def train_step(params, opt_state, key, x, y, dev_state, rstate,
                   replay_on):
        B = x.shape[0]
        k_mix = prng.fold_in(key, 0x5E1)
        k_prio = prng.fold_in(key, 0x5E2)
        k_ins = prng.fold_in(key, 0x5E3)
        active = (rstate["size"] > 0) & bool(replay_on and n_rep > 0)
        xb, yb = ingraph_mix(rstate, k_mix, x, y, n_rep, active, bits,
                             n_classes=cfg.n_y)
        params, opt_state, loss, applied, dev_state = raw_train(
            params, opt_state, key, xb, yb, dev_state)
        logits, _ = miru_forward_device(params, cfg, xb, k_prio, backend,
                                        dev_state,
                                        fused=trainer.fused_recurrence)
        prio = per_example_ce(logits, yb)
        # Rehearsed tail rows are never re-offered (the host rule).
        fresh = torch.arange(B, device=x.device) < B - n_rep
        valid = torch.where(active, fresh, torch.ones_like(fresh))
        rstate = ingraph_insert(rstate, k_ins, xb, yb, prio, bits,
                                valid=valid, decay=rspec.decay,
                                n_classes=cfg.n_y)
        return params, opt_state, loss, applied, dev_state, rstate

    return train_step


def _ingraph_replay_traffic(rspec: ReplaySpec, batch_size: int,
                            steps_per_task: list[int],
                            feature_shape: tuple[int, ...]
                            ) -> dict[str, int]:
    """The exact DRAM traffic of the device-resident (``loss_aware``)
    buffer for one run: past task 0 every step fetches ``n_rep`` rows
    (the buffer is non-empty from task 0's first step on) and offers the
    ``B − n_rep`` fresh ones; task-0 steps offer the whole batch and
    fetch nothing. Offered rows are the programmed-traffic bound
    (acceptance depends on the data). A row is its quantized codes plus
    an int32 label."""
    from repro_torch.core.replay import code_dtype

    n_rep = (int(round(batch_size * rspec.ratio))
             if rspec.ratio > 0 else 0)
    s0 = steps_per_task[0] if steps_per_task else 0
    s_rest = sum(steps_per_task[1:])
    reads = n_rep * s_rest
    writes = batch_size * s0 + (batch_size - n_rep) * s_rest
    row_b = (code_dtype(rspec.bits).itemsize
             * int(np.prod(feature_shape)) + 4)
    return {meters.REPLAY_READS: reads,
            meters.REPLAY_READ_BYTES: reads * row_b,
            meters.REPLAY_WRITES: writes,
            meters.REPLAY_WRITE_BYTES: writes * row_b}


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


def _initial_state(cfg: MiRUConfig, trainer: TrainerSpec,
                   backend: DeviceBackend, dev: torch.device,
                   init: Optional[tuple] = None):
    """:func:`_init_run` on ``dev``, or ``init`` — (key, params, Ψ) or
    (key, params, Ψ, device state) — moved there; without a device state
    the backend programs one from the key."""
    if init is None:
        return _init_run(cfg, trainer, backend, dev)
    key, params, psi = init[:3]
    params = {k: v.to(dev) for k, v in params.items()}
    psi = psi.to(dev)
    if len(init) > 3:
        dev_state = _to_device(init[3], dev)
    else:
        dev_state = backend.init_device_state(params,
                                              prng.fold_in(key, 0x0DE5))
    return key, params, psi, dev_state


def _drifting(backend: DeviceBackend, dev_state: Any) -> bool:
    """Whether the run's device state drifts (one drift tick an update):
    the spec's drift rate, or a fleet chip's own (``"_het"``)."""
    cb = backend.spec.crossbar
    het = dev_state.get("_het") if isinstance(dev_state, dict) else None
    return (dev_state is not None and cb is not None
            and (getattr(cb, "drift_rate", 0.0) > 0
                 or (het is not None and "drift_rate" in het)))


def _obs_streams(stats: list) -> tuple[np.ndarray, ...]:
    """The per-step :func:`~repro_torch.obs.step_stats` triples read back
    in one go: (write_pulses int32, dg_mag float32, occupancy int32)."""
    if not stats:
        return (np.zeros(0, np.int32), np.zeros(0, np.float32),
                np.zeros(0, np.int32))
    return tuple(torch.stack(col).cpu().numpy() for col in zip(*stats))


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
    step s of task t. ``row_valid``/``lengths`` exist only on schedules
    built under a :class:`~repro_torch.data.ragged.PadPolicy`: per task,
    (S_t, B) bool (False on the zero rows of a kept partial batch) and
    (S_t, B) int32 true sequence lengths."""
    x: list[np.ndarray]
    y: list[np.ndarray]
    replay_traffic: dict = dataclasses.field(default_factory=dict)
    occupancy: list[np.ndarray] = dataclasses.field(default_factory=list)
    row_valid: Optional[list] = None
    lengths: Optional[list] = None

    def digest(self) -> str:
        """sha256 over the materialized stream, the masks included on a
        masked schedule (the reference's schedule identity)."""
        h = hashlib.sha256()
        for arr in self.x + self.y:
            h.update(np.ascontiguousarray(arr).tobytes())
        if self.row_valid is not None:
            for arr in self.row_valid + self.lengths:
                h.update(np.ascontiguousarray(arr).tobytes())
        return h.hexdigest()

    @property
    def has_masks(self) -> bool:
        """Whether any row is padding or any sequence is short."""
        if self.row_valid is None:
            return False
        if any(not rv.all() for rv in self.row_valid):
            return True
        return any(ln.size and int(ln.min()) < xt.shape[2]
                   for ln, xt in zip(self.lengths, self.x))

    @property
    def steps_per_task(self) -> list[int]:
        return [xt.shape[0] for xt in self.x]

    @property
    def uniform(self) -> bool:
        """True when every task has the same step count and batch shape —
        the precondition of the unpadded compiled run."""
        return len({xt.shape for xt in self.x}) == 1

    def occupancy_stream(self) -> np.ndarray:
        """The per-step buffer-fill series flattened across tasks,
        ``(total_steps,)`` int32 (zeros for in-graph fresh-only
        schedules, which carry no host buffer)."""
        if not self.occupancy:
            return np.zeros(sum(self.steps_per_task), np.int32)
        return np.concatenate(
            [np.asarray(o, np.int32) for o in self.occupancy])


# Pinned digest of the permuted reference schedule (permuted scenario,
# seed 0, 2 tasks × 64 train / 16 test, dfa × 1 epoch × seed 0,
# ReplaySpec(capacity=32)), the reference's constant verbatim. The
# reference's own golden test fails under jax 0.9, so the port's tests
# hold its schedule to the live reference's digest instead.
GOLDEN_PERMUTED_SCHEDULE_SHA256 = ("2fe9e2b677cf741551717cd54502398f"
                                   "ddf8094b6d6ab35df1ec113f068b12ee")


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
    to the buffer. For an in-graph policy (``loss_aware``) the schedule
    is the fresh-only stream (no replay rows, no host buffer): the
    trainer splices rehearsal from the device buffer at run time.

    ``pad`` (a :class:`~repro_torch.data.ragged.PadPolicy`) builds the
    masked schedule of a ragged stream (tasks already time-padded by
    :func:`~repro_torch.data.ragged.pad_tasks`): per-row true lengths go
    to :attr:`BatchSchedule.lengths`, and ``pad.last_batch`` decides the
    final partial batch of an epoch — ``"drop"`` discards it (as the
    default build always does), ``"pad"`` keeps it zero-padded with its
    pad rows invalid in :attr:`BatchSchedule.row_valid` (never offered to
    the buffer). With ``pad`` but nothing partial or short, the stream —
    content, offers, host RNG consumption — is the default build's,
    byte for byte."""
    from repro_torch.core.replay import ReplayBuffer
    from repro_torch.replay import get_policy_class, make_policy

    T, F = tasks[0].x_train.shape[1:]
    bs = trainer.batch_size
    keep_partial = pad is not None and pad.last_batch == "pad"
    buffer = None
    if not get_policy_class(replay.resolved_policy).in_graph:
        policy = make_policy(replay.resolved_policy, replay.capacity,
                             seed=trainer.seed, **_stream_context(tasks))
        buffer = ReplayBuffer(replay.capacity, (T, F), n_bits=replay.bits,
                              seed=trainer.seed, policy=policy)
    host_rng = np.random.default_rng(trainer.seed + 1)

    xs_all, ys_all, occ_all, rv_all, ln_all = [], [], [], [], []
    for t, task in enumerate(tasks):
        n = task.x_train.shape[0]
        row_len = (np.asarray(task.train_lengths, np.int32)
                   if task.train_lengths is not None
                   else np.full(n, T, np.int32))
        xs_t, ys_t, occ_t, rv_t, ln_t = [], [], [], [], []
        stop = n + 1 if keep_partial else n - bs + 1
        for _ in range(trainer.epochs_per_task):
            order = host_rng.permutation(n)
            for s in range(0, stop, bs):
                idx = order[s:s + bs]
                n_real = len(idx)
                if n_real == 0:
                    continue
                xb = task.x_train[idx]
                yb = task.y_train[idx]
                rv = np.ones(bs, bool)
                ln = np.full(bs, T, np.int32)
                ln[:n_real] = row_len[idx]
                if n_real < bs:
                    # Kept partial batch: zero rows, marked invalid.
                    xb = np.concatenate(
                        [xb, np.zeros((bs - n_real, T, F), xb.dtype)])
                    yb = np.concatenate(
                        [yb, np.zeros(bs - n_real, yb.dtype)])
                    rv[n_real:] = False
                    ln[n_real:] = 1
                n_rep = 0
                if (buffer is not None and t > 0 and buffer.size > 0
                        and replay.ratio > 0):
                    n_rep = int(round(bs * replay.ratio))
                    if n_rep > 0:
                        xr, yr = buffer.sample(host_rng, n_rep)
                        xb = np.concatenate([xb[:bs - n_rep],
                                             xr.reshape(-1, T, F)])
                        yb = np.concatenate([yb[:bs - n_rep], yr])
                        # Rehearsal rows are real work at full T.
                        rv[bs - n_rep:] = True
                        ln[bs - n_rep:] = T
                n_fresh = bs - n_rep
                if buffer is not None and n_fresh > 0:
                    # ``valid`` only on padded schedules, as in the
                    # reference.
                    mask_kw = ({"valid": rv[:n_fresh]}
                               if pad is not None else {})
                    buffer.add_batch(xb[:n_fresh], yb[:n_fresh],
                                     task_ids=np.full(n_fresh, t),
                                     **mask_kw)
                xs_t.append(xb)
                ys_t.append(yb)
                occ_t.append(buffer.size if buffer is not None else 0)
                rv_t.append(rv)
                ln_t.append(ln)
        xs_all.append(np.stack(xs_t) if xs_t
                      else np.zeros((0, bs, T, F), np.float32))
        ys_all.append(np.stack(ys_t) if ys_t
                      else np.zeros((0, bs), np.int32))
        occ_all.append(np.asarray(occ_t, np.int32))
        rv_all.append(np.stack(rv_t) if rv_t else np.zeros((0, bs), bool))
        ln_all.append(np.stack(ln_t) if ln_t
                      else np.zeros((0, bs), np.int32))
    return BatchSchedule(x=xs_all, y=ys_all,
                         replay_traffic=(dict(buffer.traffic)
                                         if buffer is not None else {}),
                         occupancy=occ_all,
                         row_valid=rv_all if pad is not None else None,
                         lengths=ln_all if pad is not None else None)


# ---------------------------------------------------------------------------
# One seed's run: prepared, uploaded, executed — the loop of run_continual
# and of repro_torch.scenarios.run_compiled
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _SeedRun:
    """One seed's run before its first step: the schedule, the step
    closures, the initial state and the whole key chain."""
    schedule: BatchSchedule
    train_step: Any
    evaluate: Any
    masked: bool
    in_graph: bool
    params: dict
    opt_state: Any
    dev_state: Any
    rstate: Any
    step_keys: list             # per task, one key a real step
    eval_keys: list             # per task, the key of its evaluation
    ev_masks: Optional[tuple]   # (valid, lengths) of the test sets
    replay_traffic: dict


def _prepare_run(cfg: MiRUConfig, trainer: TrainerSpec, rspec: ReplaySpec,
                 backend: DeviceBackend, tasks: list[TaskData],
                 schedule: BatchSchedule, dev: torch.device, *,
                 pad=None, eval_padded: bool = False,
                 init: Optional[tuple] = None) -> _SeedRun:
    """The seed's initial state, step closures and key chain for
    ``schedule`` on ``dev``. The key chain is the reference's: per task,
    one split a real step, then one for the task's evaluation.
    ``pad``/``eval_padded`` (from :func:`~repro_torch.data.ragged.pad_tasks`)
    decide whether the masked twins run."""
    from repro_torch.replay import get_policy_class
    from repro_torch.replay.ingraph import ingraph_init
    masked, ev_masks = False, None
    if pad is not None:
        from repro_torch.data.ragged import eval_masks, needs_masked_program
        masked = needs_masked_program(pad, eval_padded, schedule)
        if masked:
            ev_masks = eval_masks(tasks)
    key, params, psi, dev_state = _initial_state(cfg, trainer, backend, dev,
                                                 init)
    train_step, evaluate, opt = (_make_masked_steps if masked
                                 else _make_raw_steps)(cfg, trainer, backend)
    opt_state = (opt.init(params) if trainer.algo == "adam"
                 else {"psi": psi})
    in_graph = get_policy_class(rspec.resolved_policy).in_graph
    rstate = None
    if in_graph:
        T, F = tasks[0].x_train.shape[1:]
        rstate = ingraph_init(rspec.capacity, (T, F), rspec.bits, dev)
        train_step = _make_ingraph_replay_step(cfg, trainer, rspec, backend,
                                               train_step)
        traffic = _ingraph_replay_traffic(
            rspec, trainer.batch_size, schedule.steps_per_task, (T, F))
    else:
        traffic = schedule.replay_traffic
    step_keys, eval_keys = [], []
    for S in schedule.steps_per_task:
        keys = []
        for _ in range(S):
            key, k_step = prng.split(key)
            keys.append(k_step)
        step_keys.append(keys)
        key, k_eval = prng.split(key)
        eval_keys.append(k_eval)
    return _SeedRun(schedule=schedule, train_step=train_step,
                    evaluate=evaluate, masked=masked, in_graph=in_graph,
                    params=params, opt_state=opt_state, dev_state=dev_state,
                    rstate=rstate, step_keys=step_keys, eval_keys=eval_keys,
                    ev_masks=ev_masks, replay_traffic=traffic)


def _upload(run: _SeedRun, tasks: list[TaskData],
            dev: torch.device) -> dict:
    """The run's batches (and masks) and every task's test set (and
    masks) on ``dev``, one copy each, per task."""
    def put(arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrays]
    sched = run.schedule
    data = {"x": put(sched.x), "y": put(sched.y),
            "test_x": put(t.x_test for t in tasks),
            "test_y": put(t.y_test for t in tasks)}
    if run.masked:
        data["row_valid"] = put(sched.row_valid)
        data["lengths"] = put(sched.lengths)
        data["test_masks"] = list(zip(*(put(m) for m in run.ev_masks)))
    return data


def _execute(run: _SeedRun, data: dict, backend: DeviceBackend, *,
             all_tasks: bool, baseline: bool, obs_on: bool) -> dict:
    """Every step and evaluation of ``run`` on ``data`` (from
    :func:`_upload`), with no host read until the end: losses,
    accuracies and the :func:`~repro_torch.obs.step_stats` scalars stay
    on the device and are read back once. After each task the seen
    tasks are evaluated, or with ``all_tasks`` every task (``R`` then has
    its upper triangle); ``baseline`` first evaluates every task
    untrained, with task 0's evaluation key. Each task is its own
    ``evaluate`` call on its own test set. Writes are metered a step
    (``record_endurance``)."""
    if obs_on:
        from repro_torch.obs import step_stats
    n_tasks = len(data["test_x"])
    step = run.train_step
    params, opt_state = run.params, run.opt_state
    dev_state, rstate = run.dev_state, run.rstate

    def accuracies(p, k_eval, dstate, upto):
        return [run.evaluate(p, k_eval, data["test_x"][i], data["test_y"][i],
                             dstate, *(data["test_masks"][i]
                                       if run.masked else ()))
                for i in range(upto)]

    losses, stats, accs = [], [], []
    with torch.no_grad():
        if baseline:
            accs += accuracies(params, run.eval_keys[0], dev_state, n_tasks)
        for t, keys in enumerate(run.step_keys):
            xs, ys = data["x"][t], data["y"][t]
            for s, k_step in enumerate(keys):
                args = (params, opt_state, k_step, xs[s], ys[s], dev_state)
                if run.in_graph:
                    (params, opt_state, loss, applied, dev_state,
                     rstate) = step(*args, rstate, t > 0)
                elif run.masked:
                    params, opt_state, loss, applied, dev_state = step(
                        *args, data["row_valid"][t][s],
                        data["lengths"][t][s])
                else:
                    params, opt_state, loss, applied, dev_state = step(*args)
                losses.append(loss)
                if obs_on:
                    stats.append(step_stats(applied, rstate))
                backend.record_endurance(applied)
            accs += accuracies(params, run.eval_keys[t], dev_state,
                               n_tasks if all_tasks else t + 1)

    # The read-back.
    flat = (torch.stack(accs).cpu().numpy() if accs
            else np.zeros(0, np.float32))
    base_row = None
    if baseline:
        base_row, flat = flat[:n_tasks], flat[n_tasks:]
    R = np.zeros((n_tasks, n_tasks))
    at = 0
    for t in range(n_tasks):
        n = n_tasks if all_tasks else t + 1
        R[t, :n] = flat[at:at + n]
        at += n
    return {"R": R, "baseline_row": base_row,
            "losses": (torch.stack(losses).cpu().numpy() if losses
                       else np.zeros(0, np.float32)),
            "obs": _obs_streams(stats) if obs_on else None,
            "params": params, "dev_state": dev_state, "rstate": rstate}


def _obs_stream_args(run: _SeedRun, raw: dict,
                     backend: DeviceBackend) -> dict:
    """One run's per-step streams, as :func:`~repro_torch.obs.build_runlog`
    takes them. Host policies' buffer fill was recorded when the schedule
    was built; an in-graph buffer's comes from its step stats."""
    from repro_torch.obs import drift_stream
    pulses, dg, occ = raw["obs"]
    steps = run.schedule.steps_per_task
    return {"loss": raw["losses"], "write_pulses": pulses, "dg_mag": dg,
            "replay_occupancy": (occ if run.in_graph
                                 else run.schedule.occupancy_stream()),
            "drift_ticks": drift_stream(
                sum(steps), drifting=_drifting(backend, raw["dev_state"]))}


# ---------------------------------------------------------------------------
# Main loop
# ---------------------------------------------------------------------------

def evaluate_tasks(evaluate, params: dict[str, torch.Tensor],
                   key: Optional[np.ndarray], tasks: list[TaskData],
                   upto: int, dev_state: Any = None) -> np.ndarray:
    """Accuracies (upto + 1,) of ``evaluate(params, key, x, y,
    dev_state)`` (the ``evaluate`` of a run's steps) on the test sets of
    ``tasks[:upto + 1]``, moved to the parameters' device: one row of the
    R matrix."""
    dev = next(iter(params.values())).device
    accs = np.zeros(upto + 1)
    for i, task in enumerate(tasks[:upto + 1]):
        accs[i] = float(evaluate(params, key,
                                 torch.from_numpy(task.x_test).to(dev),
                                 torch.from_numpy(task.y_test).to(dev),
                                 dev_state))
    return accs


def _resolve_specs(spec: Union[ContinualConfig, TrainerSpec],
                   replay: Optional[ReplaySpec],
                   device: Union[str, DeviceBackend, None]
                   ) -> tuple[TrainerSpec, ReplaySpec, DeviceBackend]:
    if isinstance(spec, ContinualConfig):
        if replay is not None or device is not None:
            raise ValueError("pass either a legacy ContinualConfig or "
                             "TrainerSpec + replay/device, not both")
        warnings.warn(
            "passing ContinualConfig to run_continual is deprecated; use "
            "TrainerSpec/ReplaySpec + a repro_torch.backends device backend",
            DeprecationWarning, stacklevel=3)
        return spec.specs()
    if not isinstance(spec, TrainerSpec):
        raise TypeError(f"expected ContinualConfig or TrainerSpec, got "
                        f"{type(spec).__name__}")
    backend = get_backend(device if device is not None else "ideal")
    if backend.tracker is not None and backend.tracker.updates_applied:
        warnings.warn(
            "device backend carries endurance statistics from a previous "
            "run; write counts will accumulate across runs — pass a fresh "
            "backend for per-run statistics", stacklevel=3)
    return spec, replay if replay is not None else ReplaySpec(), backend


def run_continual(cfg: MiRUConfig,
                  spec: Union[ContinualConfig, TrainerSpec],
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
    tracker, under ``track_endurance``), ``telemetry`` (when the
    backend's is on), ``replay_state`` (the device buffer of an
    in-graph policy) and ``runlog`` (under ``obs``, a
    :class:`repro_torch.obs.ObsSpec`: the per-step streams of
    :func:`repro_torch.obs.step_stats`, kept on the device and read back
    once, at the end).

    ``spec`` is a :class:`TrainerSpec` (with ``replay`` and ``device`` —
    a registered backend name or instance, default ``"ideal"`` — given
    separately) or a legacy :class:`ContinualConfig` that maps onto all
    three (deprecated; it warns). ``pad`` (a
    :class:`~repro_torch.data.ragged.PadPolicy`) pads a ragged stream
    onto one shape and runs the masked step and eval twins over the
    masked schedule — or, when nothing is ragged and ``pad.force`` is
    off, the exact unmasked program. ``init`` replaces the seeded
    initial state with (key, params, Ψ) or (key, params, Ψ, device
    state) — e.g. the reference's, carried across with
    :func:`repro_torch.convert.run_state_from_numpy` and
    :func:`~repro_torch.convert.device_state_from_numpy` — so two runs
    start from identical weights (and conductances) whatever the last bit
    of ``normal`` does; without a device state the backend programs one
    from the key.

    The loop runs under ``torch.no_grad()`` (Adam enables autograd
    around its loss alone); the batches and test sets move to the card
    once, and losses and accuracies are read back once, at the end."""
    trainer, rspec, backend = _resolve_specs(spec, replay, device)
    _check_algo(trainer)
    from repro_torch.replay import get_policy_class
    dev = resolve_device(torch_device)
    eval_padded = False
    if pad is not None:
        from repro_torch.data.ragged import pad_tasks
        if get_policy_class(rspec.resolved_policy).in_graph:
            raise ValueError(
                "in-graph replay policies (loss_aware) are not supported "
                "on the padded ragged path; pick a host-materialized "
                "policy (reservoir/ring/class_balanced/task_stratified)")
        tasks, eval_padded = pad_tasks(tasks, pad)

    schedule = build_batch_schedule(trainer, rspec, tasks, pad=pad)
    run = _prepare_run(cfg, trainer, rspec, backend, tasks, schedule, dev,
                       pad=pad, eval_padded=eval_padded, init=init)
    if backend.telemetry.enabled and run.replay_traffic:
        backend.telemetry.record(run.replay_traffic)
    # Observability streams (repro_torch.obs): step_stats a step, kept on
    # the device.
    obs_on = obs is not None and getattr(obs, "metrics", False)
    raw = _execute(run, _upload(run, tasks, dev), backend, all_tasks=False,
                   baseline=False, obs_on=obs_on)

    R = raw["R"]
    n_tasks = len(tasks)
    out: dict[str, Any] = {
        "R": R,
        "MA": float(R[-1, :].mean()),
        "acc_after_each": [float(R[t, :t + 1].mean())
                           for t in range(n_tasks)],
        "losses": raw["losses"].tolist(),
        "params": raw["params"],
    }
    if obs_on:
        from repro_torch.obs import build_runlog
        out["runlog"] = build_runlog(
            cadence=obs.cadence, steps_per_task=schedule.steps_per_task,
            task_acc=R, **_obs_stream_args(run, raw, backend))
    if raw["rstate"] is not None:
        out["replay_state"] = raw["rstate"]
    if raw["dev_state"] is not None:
        out["device_state"] = raw["dev_state"]
    if backend.tracker is not None:
        out["endurance"] = backend.tracker
    if backend.telemetry.enabled:
        out["telemetry"] = backend.telemetry
    return out
