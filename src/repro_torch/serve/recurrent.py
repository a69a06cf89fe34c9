"""Continuous-batching serve engine for recurrent (MiRU) streams.

Counterpart of ``repro/serve/recurrent.py``. For a recurrent model the
per-user serving cache is one fixed-size hidden vector, so:

  * state lives in a :class:`~repro_torch.serve.slab.StateSlab` — one
    (batch_slots, n_h) tensor on the device; users beyond the slab
    LRU-spill to host and reload bit-identically on their next burst;
  * every engine step advances all scheduled streams together through
    the backend's ``device_recurrence`` (on ``wbs``: the hoisted
    ``wbs_matmul`` drive and the fused ``wbs_miru_scan`` kernel) resumed
    from the slab via ``h0``, then the per-frame readout;
  * every lane is computed row-independently, so a request's output
    stream is bitwise identical whichever requests ride along and
    whichever slot it lands in, at a fixed slab shape (the determinism
    contract);
  * admission control: a bounded queue (``max_queue``) with per-user
    FIFO ordering;
  * host/device pipelining: the engine dispatches step k+1 before it
    reads step k's logits back (``pipeline=False`` drains every step);
  * per-request queue deadlines and simulated chip failures
    (``fail_at_steps``), with bit-exact migration of the slab's rows.

Wall-clock reads go through an injectable ``clock``. The engine runs on
``torch_device`` ("cuda" unless the caller asks for the CPU); with no
card present and CUDA requested it raises.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from collections import deque
from typing import Any, Callable, Hashable, Optional, Union

import numpy as np
import torch

from repro_torch import prng
from repro_torch.backends import DeviceBackend, get_backend
from repro_torch.core.continual import _meter_chip_step
from repro_torch.core.miru import MiRUConfig, miru_apply_readout
from repro_torch.obs import Histogram
from repro_torch.serve.slab import StateSlab
from repro_torch.telemetry.meters import SEQUENCES
from repro_torch.utils import resolve_device

__all__ = ["RecurrentServeConfig", "RecurrentServeEngine", "StreamRequest",
           "serve_backend"]


@functools.lru_cache(maxsize=None)
def serve_backend(name: str) -> DeviceBackend:
    """Shared per-name backend instance for recurrent serving, with the
    substrate's native spec (so served steps run the training forward's
    fixed-point path). Engines serving one name share its telemetry;
    ``RecurrentServeConfig.fresh_meter`` gives an engine its own."""
    return get_backend(name)


@dataclasses.dataclass
class RecurrentServeConfig:
    #: Slab slots == batch width. Users beyond this spill.
    batch_slots: int = 8
    #: Frames consumed per stream per engine step. Chunking is bitwise
    #: invariant: the recurrence is causal.
    chunk: int = 8
    #: Queued requests beyond this are rejected at submit. None = unbounded.
    max_queue: Optional[int] = None
    #: A backend registry name (resolved through :func:`serve_backend`) or
    #: a built DeviceBackend (the caller owns its telemetry isolation).
    device: Union[str, DeviceBackend] = "wbs"
    #: Enable telemetry on the substrate.
    meter: bool = False
    #: A private backend instance instead of the shared per-name one, so
    #: this engine's counters are its own. Only for a registry name.
    fresh_meter: bool = False
    #: None lets the backend fuse where it can; False forces the per-step
    #: device_vmm loop.
    fused: Optional[bool] = None
    #: Dispatch one step ahead of retirement (host/device overlap).
    pipeline: bool = True
    #: Per-request queue deadline (seconds, on the injectable clock): a
    #: request older than this at admission is dropped with
    #: ``timed_out=True``. The clock is read for it only when set.
    deadline_s: Optional[float] = None
    #: 0-based dispatch-attempt indices at which the serving chip "fails"
    #: mid-step: the dispatch aborts, the slab's rows migrate to a fresh
    #: slab through the host-spill path and the streams retry from their
    #: pre-dispatch cursors — the outputs stay bitwise identical.
    fail_at_steps: tuple = ()
    #: Seed of the per-dispatch key chain that feeds a noisy substrate
    #: (``analog``'s plane gains and read noise), as the reference's.
    seed: int = 0
    #: Injectable wall clock (seconds).
    clock: Callable[[], float] = time.perf_counter
    #: A :class:`repro_torch.obs.Tracer`: a ``serve.step`` span per engine
    #: step. None is free.
    tracer: Optional[Any] = None


@dataclasses.dataclass
class StreamRequest:
    """One burst of frames from one user session."""
    rid: int
    uid: Hashable
    frames: np.ndarray              # (T, n_x) float32
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_done: float = 0.0
    cursor: int = 0                 # frames consumed so far
    emitted: int = 0                # frames whose logits materialized
    done: bool = False
    rejected: bool = False
    timed_out: bool = False
    _logits: Optional[np.ndarray] = None

    @property
    def n_frames(self) -> int:
        return int(self.frames.shape[0])

    @property
    def steps(self) -> int:
        """Frames served — the pJ/request allocation unit."""
        return self.emitted

    @property
    def logits(self) -> np.ndarray:
        """(T, n_y) per-frame readout logits (filled as frames retire)."""
        if self._logits is None:
            raise ValueError("no frames served yet")
        return self._logits

    @property
    def predictions(self) -> np.ndarray:
        """(T,) per-frame argmax class stream."""
        return np.argmax(self.logits, axis=-1)


class RecurrentServeEngine:
    """Continuous batching of recurrent state over a device slab."""

    def __init__(self, cfg: MiRUConfig, scfg: RecurrentServeConfig,
                 params: dict[str, torch.Tensor],
                 torch_device: Union[str, torch.device] = "cuda"):
        if isinstance(scfg.device, DeviceBackend):
            self.backend = scfg.device
        elif scfg.fresh_meter:
            self.backend = get_backend(scfg.device)
        else:
            self.backend = serve_backend(scfg.device)
        if scfg.meter:
            self.backend.telemetry.enable()
        self.cfg = cfg
        self.scfg = scfg
        self.device = resolve_device(torch_device)
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.slab = self._new_slab()
        self._waiting: deque[StreamRequest] = deque()
        self._active: dict[Hashable, StreamRequest] = {}   # uid → request
        self._inflight: deque[tuple[torch.Tensor, list]] = deque()
        self._next_rid = 0
        self._anon = 0
        self.steps_run = 0
        self.rejected = 0
        self.timed_out = 0
        self.chip_failures = 0
        self.retried = 0
        self._dispatch_attempts = 0
        self._rng = prng.PRNGKey(scfg.seed)

        self.latency = Histogram()       # submit → done, ms
        self.queue_wait = Histogram()    # submit → admit, ms
        self.decode = Histogram()        # admit → done, ms
        self._finished: list[StreamRequest] = []
        self._t_first_submit: Optional[float] = None
        self._t_last_done: Optional[float] = None

    @property
    def telemetry(self):
        return self.backend.telemetry

    def _new_slab(self) -> StateSlab:
        return StateSlab(self.scfg.batch_slots, self.cfg.n_h, self.cfg.dtype,
                         self.device)

    @torch.no_grad()
    def _step_fn(self, h_slab: torch.Tensor, x_chunk: torch.Tensor,
                 n_steps: torch.Tensor, key: Optional[np.ndarray]
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        S, C, _ = x_chunk.shape
        h_all, _, _ = self.backend.device_recurrence(
            self.params, cfg, x_chunk, key, fused=self.scfg.fused, h0=h_slab)
        # State writeback: slot i advances by its own n_steps[i] frames;
        # idle lanes (n_steps == 0) keep their state bit-exactly.
        idx = (n_steps - 1).clamp(min=0)
        h_sel = h_all[torch.arange(S, device=self.device), idx]
        h_new = torch.where((n_steps > 0)[:, None], h_sel, h_slab)
        # Per-frame readout (eq. 3), digital like the training forward.
        logits = miru_apply_readout(self.params, cfg,
                                    h_all.reshape(S * C, cfg.n_h))
        with self.telemetry.scaled(C):
            _meter_chip_step(self.backend, cfg, S)
        return h_new, logits.reshape(S, C, -1)

    # ------------------------------------------------------------------
    # Submission / admission
    # ------------------------------------------------------------------
    def submit(self, frames: np.ndarray,
               uid: Optional[Hashable] = None) -> StreamRequest:
        """Queue one burst. ``uid`` names the user session whose slab
        state the burst continues; None serves a fresh anonymous session.
        Rejected requests (queue full) return with ``rejected=True``."""
        frames = np.asarray(frames, np.float32)
        if frames.ndim != 2 or frames.shape[0] < 1 \
                or frames.shape[1] != self.cfg.n_x:
            raise ValueError(f"frames must be (T>=1, n_x={self.cfg.n_x}), "
                             f"got {frames.shape}")
        if uid is None:
            uid = f"_anon{self._anon}"
            self._anon += 1
        req = StreamRequest(rid=self._next_rid, uid=uid, frames=frames)
        self._next_rid += 1
        req.t_submit = self.scfg.clock()
        if self._t_first_submit is None:
            self._t_first_submit = req.t_submit
        if self.scfg.max_queue is not None \
                and len(self._waiting) >= self.scfg.max_queue:
            req.rejected = True
            self.rejected += 1
            return req
        req._logits = np.zeros((req.n_frames, self.cfg.n_y), np.float32)
        self._waiting.append(req)
        return req

    def end_session(self, uid: Hashable) -> None:
        """Drop a user's slab state (resident or spilled)."""
        if uid in self._active:
            raise ValueError(f"uid {uid!r} has an active stream")
        self.slab.release(uid)

    def _admit(self) -> None:
        """Move waiting requests into the slab. Per-user FIFO: a burst
        whose user is mid-stream stays queued (later users may overtake
        it); otherwise requests admit in submit order while a slot can be
        acquired without evicting a pinned stream."""
        now = self.scfg.clock() if self.scfg.deadline_s is not None \
            else None
        kept: deque[StreamRequest] = deque()
        while self._waiting:
            req = self._waiting.popleft()
            if now is not None \
                    and now - req.t_submit > self.scfg.deadline_s:
                req.timed_out = True
                req.done = True
                req.t_done = now
                self.timed_out += 1
                continue
            if req.uid in self._active:
                kept.append(req)
                continue
            if len(self._active) >= self.scfg.batch_slots \
                    or not self.slab.can_acquire(req.uid):
                kept.appendleft(req)
                # Everything behind a capacity-blocked head stays in
                # order; only user-busy requests were bypassed.
                kept.extend(self._waiting)
                self._waiting.clear()
                break
            self.slab.acquire(req.uid)
            self.slab.pin(req.uid)
            self._active[req.uid] = req
            req.t_admit = self.scfg.clock()
            self.queue_wait.add((req.t_admit - req.t_submit) * 1e3)
        self._waiting = kept

    # ------------------------------------------------------------------
    # The engine step
    # ------------------------------------------------------------------
    def step(self) -> int:
        """Admit, advance every scheduled stream by up to ``chunk``
        frames, retire materialized output. Returns the number of streams
        scheduled into this step's batch."""
        tracer = self.scfg.tracer
        if tracer is None:
            return self._step_inner()
        with tracer.span("serve.step", step=self.steps_run):
            return self._step_inner()

    def _step_inner(self) -> int:
        self._admit()
        S, C = self.scfg.batch_slots, self.scfg.chunk
        entries = []
        x = np.zeros((S, C, self.cfg.n_x), np.float32)
        n_steps = np.zeros((S,), np.int64)
        for uid, req in self._active.items():
            if req.cursor >= req.n_frames:
                continue                     # retiring via the pipeline
            slot = self.slab.slot(uid)
            c = min(C, req.n_frames - req.cursor)
            x[slot, :c] = req.frames[req.cursor:req.cursor + c]
            n_steps[slot] = c
            entries.append((req, slot, req.cursor, c))
            req.cursor += c
            self.slab.touch(uid)
        if entries:
            # Fault-injection point: the chip dies mid-step, before the
            # dispatch ran, so the retry recomputes the same streams.
            attempt = self._dispatch_attempts
            self._dispatch_attempts += 1
            if attempt in self.scfg.fail_at_steps:
                self._chip_failure(entries)
                return len(entries)
            # The reference splits its key chain once a dispatch; only a
            # substrate that draws noise consumes the subkey.
            sub = None
            if self.backend.draws_noise:
                self._rng, sub = prng.split(self._rng)
            self.slab.h, logits = self._step_fn(
                self.slab.h, torch.from_numpy(x).to(self.device),
                torch.from_numpy(n_steps).to(self.device), sub)
            self._inflight.append((logits, entries))
            self.steps_run += 1
        # Retire: with pipelining keep one dispatch in flight so the host
        # gather above overlapped the device step; else drain now.
        depth = 1 if (self.scfg.pipeline and entries) else 0
        while len(self._inflight) > depth:
            self._retire(*self._inflight.popleft())
        return len(entries)

    def _chip_failure(self, entries: list) -> None:
        """Recover from a simulated chip death mid-dispatch: the aborted
        streams roll back to their pre-dispatch cursors and retry; every
        surviving state row migrates to a fresh slab (the replacement
        chip) through the bit-exact host-spill path."""
        for req, _slot, start, _c in entries:
            req.cursor = start
        self.chip_failures += 1
        self.retried += len(entries)
        self.flush()
        old = self.slab
        rows = {uid: old.read(uid)
                for uid in set(old.resident) | set(old.spilled)}
        self.slab = self._new_slab()
        for uid, row in rows.items():
            self.slab.preload(uid, row)
        for uid in self._active:
            self.slab.acquire(uid)
            self.slab.pin(uid)

    def _retire(self, logits: torch.Tensor, entries: list) -> None:
        arr = logits.cpu().numpy()           # waits for the step
        for req, slot, start, c in entries:
            req._logits[start:start + c] = arr[slot, :c]
            req.emitted += c
            if req.emitted >= req.n_frames:
                self._finish(req)

    def _finish(self, req: StreamRequest) -> None:
        req.done = True
        req.t_done = self.scfg.clock()
        self._t_last_done = req.t_done
        self.latency.add((req.t_done - req.t_submit) * 1e3)
        self.decode.add((req.t_done - req.t_admit) * 1e3)
        self._finished.append(req)
        del self._active[req.uid]
        self.slab.unpin(req.uid)             # state stays resident (LRU)
        self.telemetry.record({SEQUENCES: 1})

    @property
    def pending(self) -> int:
        """Requests queued, active, or with output in flight."""
        return (len(self._waiting) + len(self._active)
                + sum(len(e) for _, e in self._inflight))

    def flush(self) -> None:
        """Materialize every in-flight dispatch."""
        while self._inflight:
            self._retire(*self._inflight.popleft())

    def run_until_drained(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if self.step() == 0 and not self._waiting \
                    and not self._inflight:
                return
        raise RuntimeError(f"not drained after {max_steps} engine steps")

    # ------------------------------------------------------------------
    def request_stats(self, model: Optional[Any] = None) -> dict[str, Any]:
        """Serving figures over the finished requests: end-to-end /
        queue-wait / decode latency percentiles (ms), sequences/s,
        frames/s and slab spill counters — and, on a metered substrate,
        the metered power (mW) plus a pJ/request distribution (each
        request charged its frame share of the metered energy), under
        ``energy``. ``model`` defaults to an
        :class:`~repro_torch.analog.costmodel.M2RUCostModel` of this
        engine's network geometry; ``cmos`` is charged the digital
        baseline's energy, every other substrate the mixed-signal
        chip's."""
        out: dict[str, Any] = {
            "requests": len(self._finished),
            "rejected": self.rejected,
            "timed_out": self.timed_out,
            "steps_run": self.steps_run,
            "chip_failures": self.chip_failures,
            "retried": self.retried,
            "latency_ms": self.latency.summary(),
            "queue_wait_ms": self.queue_wait.summary(),
            "decode_ms": self.decode.summary(),
            "slab": self.slab.stats(),
        }
        if self._finished and self._t_last_done is not None:
            span = self._t_last_done - self._t_first_submit
            n_frames = sum(r.emitted for r in self._finished)
            out["sequences_per_s"] = len(self._finished) / span \
                if span > 0 else float("inf")
            out["frames_per_s"] = n_frames / span if span > 0 \
                else float("inf")
            out["frames_served"] = n_frames
        tele = self.telemetry
        if tele.enabled and self._finished:
            from repro_torch.analog.costmodel import M2RUCostModel
            from repro_torch.telemetry.energy import MeteredEnergy
            if model is None:
                model = M2RUCostModel(n_x=self.cfg.n_x, n_h=self.cfg.n_h,
                                      n_y=self.cfg.n_y)
            kind = "cmos" if self.backend.name == "cmos" else "analog"
            rep = MeteredEnergy(model).report(tele.snapshot(), kind=kind)
            total_steps = sum(r.steps for r in self._finished)
            pj = Histogram()
            if rep.energy_j > 0 and total_steps > 0:
                for r in self._finished:
                    pj.add(rep.energy_j * r.steps / total_steps * 1e12)
            out["energy"] = {
                "total_j": rep.energy_j,
                "power_mw": rep.power_w * 1e3,
                "gops_per_w": rep.gops_per_w,
                "pj_per_op": rep.pj_per_op,
                "pj_per_request": pj.summary(),
            }
        return out
