"""The LM training loop: gradient accumulation, checkpoint/restart, fault
tolerance, logging — counterpart of ``repro/train/trainer.py``.

One device: the parameters, the optimizer state and each batch live on
``device`` (the card unless the caller asks for the CPU); ``run`` moves
each batch there, so the batcher needs no ``device`` of its own. A step takes
``torch.autograd.grad`` of ``lm.loss_fn`` — through the flash kernels on
the flash branch, each layer recomputed in the backward under
``cfg.remat``; on a quantized model (``cfg.quant_mode``) through the
substrate's straight-through products — and applies
``optim.adamw(warmup_cosine(...))``, with ζ
sparsification and top-k compression as the reference offers them. The
step is functional, as the reference's jitted step: new parameter and
state trees replace the old ones (no in-place updates).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional, Union

import torch

from repro_torch import optim as optim_mod
from repro_torch import prng
from repro_torch.backends import get_backend
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import ShardedBatcher
from repro_torch.models import lm
from repro_torch.train.checkpoint import CheckpointManager, cast_like
from repro_torch.train.faults import HealthMonitor, PreemptionGuard
from repro_torch.utils import (resolve_device, tree_leaves, tree_map,
                               tree_size, tree_to)

PyTree = Any


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    lr: float = 3e-4
    warmup_steps: int = 10
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0
    grad_accum: int = 1
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3
    seed: int = 0
    # Paper-derived options:
    kwta_grad_keep: Optional[float] = None    # ζ sparsification
    grad_compression_keep: Optional[float] = None  # top-k + error feedback


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig,
                 batcher: ShardedBatcher, params: Optional[PyTree] = None,
                 device: Union[str, torch.device] = "cuda"):
        # The quantized mode resolves through the backend registry up
        # front: an unknown name fails here, not in the first step
        # (models/layers.dense builds the shared inference instance).
        if cfg.quant_mode != "none":
            get_backend(cfg.quant_mode)
        self.cfg = cfg
        self.tcfg = tcfg
        self.batcher = batcher
        self.device = resolve_device(device)
        # Without params: the reference's draw from PRNGKey(seed), on the
        # host (seconds per million parameters; a full-size model takes
        # params drawn on the card).
        self.params = tree_to(params, self.device) if params is not None \
            else lm.init_params(prng.PRNGKey(tcfg.seed), cfg, self.device)

        schedule = optim_mod.warmup_cosine(tcfg.lr, tcfg.warmup_steps,
                                           tcfg.steps)
        opt = optim_mod.adamw(schedule, weight_decay=tcfg.weight_decay,
                              max_grad_norm=tcfg.max_grad_norm)
        if tcfg.kwta_grad_keep is not None:
            opt = optim_mod.kwta_sparsify(opt, tcfg.kwta_grad_keep)
        if tcfg.grad_compression_keep is not None:
            opt = optim_mod.topk_compress_error_feedback(
                opt, tcfg.grad_compression_keep)
        self.optimizer = opt
        self.opt_state = opt.init(self.params)

        self.step = 0
        self.ckpt = CheckpointManager(tcfg.checkpoint_dir,
                                      keep=tcfg.keep_checkpoints) \
            if tcfg.checkpoint_dir else None
        self.monitor = HealthMonitor()
        self.history: list[dict] = []

    # ------------------------------------------------------------------
    def _value_and_grad(self, batch: dict) -> tuple[torch.Tensor, PyTree]:
        p = tree_map(lambda t: t.detach().requires_grad_(), self.params)
        loss = lm.loss_fn(p, self.cfg, batch)
        leaves = tree_leaves(p)
        by_id = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
        return loss.detach(), tree_map(lambda t: by_id[id(t)], p)

    def _train_step(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        accum = self.tcfg.grad_accum
        if accum == 1:
            loss, grads = self._value_and_grad(batch)
        else:
            # Microbatch split along the batch axis; sums from zeros, then
            # one division, as the reference's scan.
            micro = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
                     for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            grads = tree_map(torch.zeros_like, self.params)
            for i in range(accum):
                l, g = self._value_and_grad({k: v[i]
                                             for k, v in micro.items()})
                loss = loss + l
                grads = tree_map(torch.add, grads, g)
            loss = loss / accum
            grads = tree_map(lambda g: g / accum, grads)
        updates, self.opt_state = self.optimizer.update(
            grads, self.opt_state, self.params)
        self.params = optim_mod.apply_updates(self.params, updates)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                               for g in tree_leaves(grads)))
        return loss, gnorm

    # ------------------------------------------------------------------
    def maybe_restore(self) -> bool:
        """Auto-restore from the latest checkpoint (restart-after-failure
        path). Returns True if restored."""
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return False
        step, tree, extra = self.ckpt.restore()
        self.params = cast_like(tree["params"], self.params)
        self.opt_state = cast_like(tree["opt"], self.opt_state)
        self.step = step
        if "data" in extra:
            self.batcher.load_state_dict(extra["data"])
        return True

    def save(self, async_: bool = True) -> None:
        if self.ckpt is None:
            return
        tree = {"params": self.params, "opt": self.opt_state}
        extra = {"data": self.batcher.state_dict()}
        if async_:
            self.ckpt.save_async(self.step, tree, extra)
        else:
            self.ckpt.save(self.step, tree, extra)

    # ------------------------------------------------------------------
    def run(self, steps: Optional[int] = None,
            guard: Optional[PreemptionGuard] = None) -> list[dict]:
        target = self.step + (steps if steps is not None
                              else self.tcfg.steps)
        while self.step < target:
            t0 = time.time()
            batch = {k: torch.as_tensor(v).to(self.device)
                     for k, v in self.batcher.next().items()}
            loss, gnorm = self._train_step(batch)
            loss = float(loss)
            dt = time.time() - t0
            self.step += 1
            straggler = self.monitor.record(self.step, dt)
            rec = {"step": self.step, "loss": loss,
                   "grad_norm": float(gnorm), "sec": round(dt, 4),
                   "straggler": straggler}
            self.history.append(rec)
            if self.step % self.tcfg.log_every == 0:
                print(f"step {self.step:5d}  loss {loss:.4f}  "
                      f"gnorm {float(gnorm):.3f}  {dt*1e3:.0f} ms",
                      flush=True)
            if self.ckpt and self.step % self.tcfg.checkpoint_every == 0:
                self.save()
            if guard is not None and guard.requested:
                self.save(async_=False)
                print(f"preempted at step {self.step}; checkpoint saved",
                      flush=True)
                break
        if self.ckpt:
            self.ckpt.wait()
        return self.history

    @property
    def n_params(self) -> int:
        return tree_size(self.params)

