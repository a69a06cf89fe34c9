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

On the card the decode step is captured once as a CUDA graph (at the
engine's first decode) and replayed for every call with the tokens, the
position and the row mask copied into its input buffers: the same
kernels on the same inputs as the eager step, without its host cost a
launch. The CPU runs the step eagerly.

The engine runs on ``torch_device`` ("cuda" unless the caller asks for
the CPU). A :class:`repro_torch.obs.Tracer` (``tracer=``) gets a
``serve.step`` span per engine step and a ``serve.prefill`` span per
admitted prompt. Not ported yet, each raising with its ROADMAP item: a
device substrate (``device=``, ``meter=``, the ``energy`` block of
:meth:`ServeEngine.request_stats`).
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
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.obs import Histogram
from repro_torch.utils import resolve_device, tree_to


@dataclasses.dataclass
class ServeConfig:
    batch_slots: int = 8
    max_len: int = 256
    eos_token: int = 0
    greedy: bool = True
    temperature: float = 1.0
    seed: int = 0
    #: A device substrate for the projections (a backend name); not ported
    #: yet (ROADMAP queue A, LM on a substrate): anything but None raises.
    device: Any = None
    #: Telemetry on the substrate; not ported yet (raises if True).
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
        for name, unported in (("device", scfg.device is not None),
                               ("meter", scfg.meter)):
            if unported:
                raise NotImplementedError(
                    f"ServeConfig.{name} is not ported yet (ROADMAP queue "
                    f"A, LM on a substrate)")
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
        capture runs with an empty row mask."""
        self._rows.zero_()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._decode_inputs()
        torch.cuda.current_stream(self.device).wait_stream(side)
        self._graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self._graph):
            self._logits = self._decode_inputs()

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
        and ``tokens_generated`` over first submit → last done. The
        metered ``energy`` block needs a substrate (not ported yet):
        ``model`` raises."""
        if model is not None:
            raise NotImplementedError(
                "the metered energy block needs an LM on a substrate, not "
                "ported yet (ROADMAP queue A, LM on a substrate)")
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
        return out
