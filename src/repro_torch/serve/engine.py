"""Batched LM decode engine with slot-based continuous batching —
counterpart of ``repro/serve/engine.py``.

A fixed pool of B slots shares one KV-cache allocation. Requests occupy
free slots; a newly admitted request's prompt is prefilled token by token
through the decode path; each engine step decodes one token for every
active slot, slots grouped by their position; finished sequences (EOS,
``max_new`` or ``max_len``) free their slot for the next queued request.

Two differences from the reference, by design. The reference writes
every slot's cache row at the position it steps (``cache_insert`` over
all B rows) and advances every slot's SSM state in every decode, so a
request admitted later overwrites the history of the slots already
decoding, or moves their state, and a slot's tokens depend on what else
is being served. Here every decode writes only the rows of the slots it
steps (``decode_step(write_rows=...)``), the KV caches and the SSM
states alike. And the reference hands a freed slot to the next request
with the last request's SSM state in it; here admission zeroes the
slot's cache rows (``lm.clear_cache_rows``). So each request of the
dense, ssm and (without MoE) hybrid families decodes the tokens it would
decode alone: the batch-composition contract the MiRU engine
(``serve/recurrent.py``) holds too.

The MoE families keep the reference's semantics and do not hold that
contract: every decode routes all B rows through ``moe_ffn``, idle rows
(token 0) included, and an expert takes at most
``C = max(1, int(ceil(B·K / E) · capacity_factor))`` of them (granite at
8 slots: 2), earlier rows first. So which other requests share a decode
can change a request's tokens; only slot 0 is never dropped.

A quantized model (``ServeConfig.device``, or a ``cfg.quant_mode`` that
names a device backend) keeps the reference's semantics too and does not
hold that contract either: every projection normalises its input by one
absmax over all B rows, idle rows included (``layers.dense``), so the
other rows of a decode move a request's quantization and can change its
tokens. One request in slot 0 of an otherwise idle engine decodes the
reference engine's tokens.

On the card the decode step is captured once as a CUDA graph (at the
engine's first decode) and replayed for every call with the tokens, the
position and the row mask copied into its input buffers: the same
kernels on the same inputs as the eager step, without its host cost a
launch. The CPU runs the step eagerly.

The execution substrate resolves through ``repro_torch.backends``:
``ServeConfig.device`` (a registered backend name) overrides the model's
``quant_mode``, and either way the engine holds the name's shared
inference instance (``backends.inference_backend``), validated at
construction; ``ServeConfig.meter`` turns on its telemetry. The eager
step meters as it runs; a replayed graph runs no host code, so the
engine records one decode call's counts at the capture (they depend on
the shapes alone), meters neither the capture nor its warm-up run, and
adds those counts on every replay: the reference's one flush per
compiled execution.

The engine runs on ``torch_device`` ("cuda" unless the caller asks for
the CPU). A :class:`repro_torch.obs.Tracer` (``tracer=``) gets a
``serve.step`` span per engine step and a ``serve.prefill`` span per
admitted prompt.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from repro_torch import prng
from repro_torch.analog.costmodel import DenseCostModel
from repro_torch.backends import DeviceBackend, inference_backend
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.obs import Histogram
from repro_torch.telemetry.energy import MeteredEnergy
from repro_torch.utils import resolve_device, tree_to


@dataclasses.dataclass
class ServeConfig:
    batch_slots: int = 8
    max_len: int = 256
    eos_token: int = 0
    greedy: bool = True
    temperature: float = 1.0
    seed: int = 0
    #: The device substrate of the quantized projections: a registry
    #: *name* (``repro_torch.backends``); None keeps the model config's
    #: ``quant_mode``. The layers resolve one shared inference instance a
    #: name, so a built :class:`DeviceBackend` cannot be honoured and
    #: raises: register a configured backend under its own name instead.
    device: Union[str, DeviceBackend, None] = None
    #: Turn on the substrate's telemetry. Counters accumulate on the
    #: process-wide shared instance of the name: engines serving one name
    #: share one accumulator; use distinct names to meter apart.
    meter: bool = False
    #: A :class:`repro_torch.obs.Tracer`: a ``serve.step`` span per engine
    #: step (entering ``torch.profiler.record_function``) and a
    #: ``serve.prefill`` span per admitted prompt. None is free.
    tracer: Optional[Any] = None
    #: Injectable wall clock (seconds); every latency reads only this.
    clock: Callable[[], float] = time.perf_counter
    #: Per-request queue deadline (seconds); None waits forever.
    deadline_s: Optional[float] = None
    #: Where the model and caches live: "cuda" unless asked for the CPU.
    torch_device: Union[str, torch.device] = "cuda"
    #: Keep each generated token's logits (fp32, on the CPU) in
    #: ``Request.logits``. A switch for the checks that hold two runs'
    #: logits against each other (``chip_smoke.py``'s serve twin,
    #: ``tools/parity_reach.py``, the tests); serving leaves it off, and
    #: the reference's engine has no such field.
    keep_logits: bool = False


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int = 32
    tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    timed_out: bool = False
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_done: float = 0.0
    #: Decode dispatches this request consumed (prefill + generated).
    steps: int = 0
    pending_token: int = 0
    #: (V,) logits of each generated token when ``keep_logits`` is set.
    logits: list = dataclasses.field(default_factory=list)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, scfg: ServeConfig, params: dict):
        # The substrate resolves here: an unknown name fails at
        # construction, not mid-decode.
        if scfg.device is not None:
            if isinstance(scfg.device, DeviceBackend):
                raise TypeError(
                    "ServeConfig.device takes a registry name, not a "
                    "DeviceBackend instance: the model layers resolve a "
                    "shared per-name inference instance, so a built "
                    "instance's spec would be silently ignored. Register "
                    "the configured backend (register_backend) and pass "
                    "its name.")
            self.backend: Optional[DeviceBackend] = \
                inference_backend(scfg.device)
            cfg = dataclasses.replace(cfg, quant_mode=scfg.device)
        elif cfg.quant_mode != "none":
            self.backend = inference_backend(cfg.quant_mode)
        else:
            self.backend = None
        if scfg.meter:
            if self.backend is None:
                raise ValueError("ServeConfig.meter requires a quantized "
                                 "substrate (device= or quant_mode)")
            self.backend.telemetry.enable()
        self.cfg = cfg
        self.scfg = scfg
        self.device = resolve_device(scfg.torch_device)
        self.params = tree_to(params, self.device)
        self.caches = lm.init_cache(cfg, scfg.batch_slots, scfg.max_len,
                                    self.device)
        B = scfg.batch_slots
        # The decode step's inputs (the CUDA graph's, on the card).
        self._tokens = torch.zeros((B, 1), dtype=torch.int64,
                                   device=self.device)
        self._pos = torch.zeros((), dtype=torch.int64, device=self.device)
        self._rows = torch.zeros((B,), dtype=torch.bool, device=self.device)
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._logits: Optional[torch.Tensor] = None
        # One decode call's telemetry counts, recorded at the capture.
        self._graph_counts: dict = {}
        self.slot_req: list[Optional[Request]] = [None] * scfg.batch_slots
        self.slot_pos = np.zeros(scfg.batch_slots, dtype=np.int64)
        self.queue: deque[Request] = deque()
        self._rng = prng.PRNGKey(scfg.seed)
        self.steps_run = 0
        #: Decode dispatches (model calls), prefill tokens included.
        self.decode_calls = 0
        self.timed_out = 0
        self.latency = Histogram()
        self.queue_wait = Histogram()
        self.decode = Histogram()
        self._finished: list[Request] = []
        self._t_first_submit: Optional[float] = None
        self._t_last_done: Optional[float] = None

    @property
    def telemetry(self):
        """The substrate's activity accumulator (None when unquantized)."""
        return self.backend.telemetry if self.backend is not None else None

    # ------------------------------------------------------------------
    def submit(self, prompt: list[int], max_new: int = 32) -> Request:
        req = Request(rid=len(self.queue) + 1000 * self.steps_run,
                      prompt=list(prompt), max_new=max_new)
        req.t_submit = self.scfg.clock()
        if self._t_first_submit is None:
            self._t_first_submit = req.t_submit
        self.queue.append(req)
        return req

    def _tracer_span(self, name: str, **args):
        tracer = self.scfg.tracer
        return tracer.span(name, **args) if tracer is not None \
            else contextlib.nullcontext()

    def _finish(self, req: Request) -> None:
        req.done = True
        req.t_done = self.scfg.clock()
        self._t_last_done = req.t_done
        self.latency.add((req.t_done - req.t_submit) * 1e3)
        self.decode.add((req.t_done - req.t_admit) * 1e3)
        self._finished.append(req)

    def _decode_inputs(self) -> torch.Tensor:
        """The decode step on the engine's input buffers (logits (B, 1,
        V)); the caches are written in place."""
        return lm.decode_step(self.params, self.cfg, self.caches,
                              self._tokens, self._pos,
                              write_rows=self._rows)[0]

    def _capture(self) -> None:
        """Capture the decode step in a CUDA graph, after one eager run on
        a side stream (which builds what the step caches: the rope
        frequencies, the int8 cache's draws). Both write no row: the
        capture runs with an empty row mask. Neither is metered: the
        capture's counts, one decode call's, are kept for the replays."""
        tele = self.telemetry
        metering = tele.diverted if tele is not None \
            else contextlib.nullcontext
        self._rows.zero_()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side), metering():
            self._decode_inputs()
        torch.cuda.current_stream(self.device).wait_stream(side)
        self._graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self._graph), metering() as counts:
            self._logits = self._decode_inputs()
        self._graph_counts = dict(counts or {})

    def _decode(self, tokens: dict[int, int], pos: int) -> torch.Tensor:
        """One decode at ``pos`` of the slots in ``tokens`` ({slot: token};
        idle rows get token 0, and their cache rows are not written).
        Returns the (len(tokens), V) last-position logits, slot order.
        On the card the step is a CUDA graph, captured at the first call
        and replayed with the tokens, the position and the row mask
        copied into its input buffers."""
        slots = list(tokens)
        B = self.scfg.batch_slots
        toks = np.zeros((B, 1), np.int64)
        toks[slots, 0] = [tokens[s] for s in slots]
        mask = np.zeros(B, np.bool_)
        mask[slots] = True
        if self.device.type == "cuda" and self._graph is None:
            self._capture()
        self._tokens.copy_(torch.from_numpy(toks))
        self._pos.fill_(int(pos))
        self._rows.copy_(torch.from_numpy(mask))
        if self._graph is not None:
            self._graph.replay()
            if self.telemetry is not None:
                self.telemetry.record(self._graph_counts)
            logits = self._logits
        else:
            logits = self._decode_inputs()
        self.decode_calls += 1
        return logits[torch.tensor(slots, device=self.device), -1, :]

    def _admit(self) -> None:
        if self.scfg.deadline_s is not None and self.queue:
            now = self.scfg.clock()
            kept: deque[Request] = deque()
            while self.queue:
                req = self.queue.popleft()
                if now - req.t_submit > self.scfg.deadline_s:
                    req.timed_out = req.done = True
                    req.t_done = now
                    self.timed_out += 1
                else:
                    kept.append(req)
            self.queue = kept
        for slot in range(self.scfg.batch_slots):
            if self.slot_req[slot] is None and self.queue:
                req = self.queue.popleft()
                self.slot_req[slot] = req
                self.slot_pos[slot] = 0
                lm.clear_cache_rows(self.caches, slot)
                req.t_admit = self.scfg.clock()
                self.queue_wait.add((req.t_admit - req.t_submit) * 1e3)
                # Prefill the prompt token by token through the decode
                # path, as the reference does.
                with self._tracer_span("serve.prefill", rid=req.rid,
                                       prompt_len=len(req.prompt)):
                    for t in req.prompt[:-1]:
                        self._decode({slot: t}, int(self.slot_pos[slot]))
                        self.slot_pos[slot] += 1
                        req.steps += 1
                req.tokens = []
                req.pending_token = req.prompt[-1]

    def _pick(self, logits: torch.Tensor) -> list[int]:
        """The next token of each row of (n, V) logits."""
        if self.scfg.greedy:
            return torch.argmax(logits, dim=-1).tolist()
        # jax.random.categorical: argmax(gumbel + logits / T), one key
        # split per row, the Gumbel noise -log(-log(u)) from uniform
        # draws on [tiny, 1).
        out = []
        tiny = float(np.finfo(np.float32).tiny)
        for row in logits:
            self._rng, sub = prng.split(self._rng)
            u = prng.uniform(sub, row.shape, tiny, 1.0, device=row.device)
            g = -torch.log(-torch.log(u))
            out.append(int(torch.argmax(
                g + row.to(torch.float32) / self.scfg.temperature)))
        return out

    # ------------------------------------------------------------------
    def step(self) -> int:
        """Advance every active slot one token. Returns #active slots."""
        with self._tracer_span("serve.step", step=self.steps_run):
            return self._step_inner()

    def _step_inner(self) -> int:
        self._admit()
        active = [s for s in range(self.scfg.batch_slots)
                  if self.slot_req[s] is not None]
        if not active:
            return 0
        by_pos: dict[int, dict[int, int]] = {}
        for s in active:
            req = self.slot_req[s]
            tok = req.tokens[-1] if req.tokens else req.pending_token
            by_pos.setdefault(int(self.slot_pos[s]), {})[s] = tok
        for pos_val, tokens in by_pos.items():
            logits = self._decode(tokens, pos_val)
            picks = self._pick(logits)
            kept = logits.to(torch.float32).cpu() \
                if self.scfg.keep_logits else None
            for i, (s, nxt) in enumerate(zip(tokens, picks)):
                req = self.slot_req[s]
                req.tokens.append(nxt)
                if kept is not None:
                    req.logits.append(kept[i])
                req.steps += 1
                self.slot_pos[s] += 1
                if (nxt == self.scfg.eos_token
                        or len(req.tokens) >= req.max_new
                        or self.slot_pos[s] >= self.scfg.max_len - 1):
                    self._finish(req)
                    self.slot_req[s] = None
        self.steps_run += 1
        return len(active)

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if self.step() == 0 and not self.queue:
                return

    # ------------------------------------------------------------------
    def request_stats(self, model: Optional[Any] = None) -> dict:
        """Per-request serving figures over the finished requests:
        ``requests``, ``timed_out``, ``steps_run``, ``decode_calls``,
        ``latency_ms`` / ``queue_wait_ms`` / ``decode_ms`` summaries and,
        once a request finished, ``sequences_per_s``, ``tokens_per_s``
        and ``tokens_generated`` over first submit → last done.

        On a metered substrate, adds ``energy``: the run's metered joules
        (``total_j``) and a pJ/request distribution (``pj_per_request``),
        each finished request charged its share of the total by its
        decode dispatches (prefill + generated tokens). ``model`` picks
        the energy model: None is the served architecture's
        :class:`~repro_torch.analog.costmodel.DenseCostModel` (adding
        ``power_mw``, ``gops_per_w`` and ``pj_per_op``); an
        :class:`~repro_torch.analog.costmodel.M2RUCostModel` charges the
        M2RU chip's geometry, or its per-op energy where the LM's meter
        tags do not map onto it."""
        out: dict[str, Any] = {
            "requests": len(self._finished),
            "timed_out": self.timed_out,
            "steps_run": self.steps_run,
            "decode_calls": self.decode_calls,
            "latency_ms": self.latency.summary(),
            "queue_wait_ms": self.queue_wait.summary(),
            "decode_ms": self.decode.summary(),
        }
        if self._finished and self._t_last_done is not None:
            span = self._t_last_done - self._t_first_submit
            n_tok = sum(len(r.tokens) for r in self._finished)
            out["sequences_per_s"] = len(self._finished) / span \
                if span > 0 else float("inf")
            out["tokens_per_s"] = n_tok / span if span > 0 else float("inf")
            out["tokens_generated"] = n_tok
        tele = self.telemetry
        if tele is not None and tele.enabled and self._finished:
            energy = self._energy(tele.snapshot(), model)
            if energy is not None:
                out["energy"] = energy
        return out

    def _energy(self, counters: dict, model: Optional[Any]
                ) -> Optional[dict]:
        """The ``energy`` block of :meth:`request_stats` from the
        substrate's counters, as the reference computes it; None when
        nothing was charged."""
        kind = "cmos" if self.cfg.quant_mode == "cmos" else "analog"
        en = MeteredEnergy() if model is None else MeteredEnergy(model)
        extra: dict[str, Any] = {}
        if model is None or isinstance(model, DenseCostModel):
            dm = model if model is not None \
                else DenseCostModel.from_model_config(self.cfg)
            rep = en.dense_report(counters, dm)
            total_j = rep.energy_j
            extra = {"power_mw": rep.power_w * 1e3,
                     "gops_per_w": rep.gops_per_w,
                     "pj_per_op": rep.pj_per_op}
        else:
            try:
                total_j = en.report(counters, kind=kind).energy_j
            except ValueError:
                # The LM's meter tags do not map onto the M2RU chip's
                # cycle model: charge the metered ops at its per-op energy.
                pj_op = model.digital_pj_per_op() if kind == "cmos" \
                    else model.pj_per_op()
                total_j = en.ops(counters) * pj_op * 1e-12
        total_steps = sum(r.steps for r in self._finished)
        if total_j <= 0 or total_steps <= 0:
            return None
        pj = Histogram()
        for r in self._finished:
            pj.add(total_j * r.steps / total_steps * 1e12)
        return {"total_j": total_j, "pj_per_request": pj.summary(), **extra}
