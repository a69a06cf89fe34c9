#!/usr/bin/env python3
"""Host-side times of the port's training paths on one NVIDIA GPU.

Run from the repository root (the tree whose ``src/repro_torch`` and
``chip_smoke.py`` it times is the one this file sits in):

    python3 tools/train_host_time.py [--repeats 3] [--out FILE]

Prints one JSON line per repeat with:

- ``split_us``: microseconds per ``prng.split(key)`` on the host, the
  call the trainer makes twice a step and the replay buffer once per
  stored row;
- ``schedule_s``: seconds to build the Fig. 4 protocol's batch schedule
  (3 tasks, reservoir replay of 512; ``build_batch_schedule``);
- ``sw_ms_per_step``: the software DFA step of ``chip_smoke.py`` train (a)
  (batch 64, 400 steps), host clock around a run that ends in a
  synchronize;
- ``ideal_ms_per_step``/``wbs_ms_per_step``: the protocol's train step
  (batch 32, 100 steps; ``chip_smoke.train_step_ms``);
- ``ideal_wall_s``/``wbs_wall_s``: one whole ``run_continual`` of the
  protocol;
- ``analog_ms_per_step``/``analog_state_ms_per_step``/
  ``read_noise_ms_per_step``: the same step on ``analog`` (train (c)),
  ``analog_state`` and ``analog`` with read noise (train (d));
- ``write_noise_draw_ms``: the host's write-noise draws of one
  ``analog`` update (one key per parameter, ``prng.normal`` of each
  parameter's shape, about 14k normals at 28×100×10), moved to the card;
- ``analog_update_ms``/``analog_state_update_ms``: one
  ``device_apply_update`` at the protocol's shapes, draws included,
  ending in a synchronize;
- ``read_noise_vmm_ms``: one ``analog`` ``vmm`` with read noise at the
  per-step shape (32, 100) × (100, 100): the key split, the plane-gain
  draw, the quantizer and the kernel, ending in a synchronize.

Two trees are compared by running each tree's copy of this file in one
call, alternating (A, B, B, A), since host times spread between calls.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def split_us(n: int = 5000) -> float:
    from repro_torch import prng
    key = prng.PRNGKey(0)
    for _ in range(100):
        key, _ = prng.split(key)
    t0 = time.perf_counter()
    for _ in range(n):
        key, _ = prng.split(key)
    return 1e6 * (time.perf_counter() - t0) / n


def schedule_s() -> float:
    from repro_torch.core.continual import (ReplaySpec, TrainerSpec,
                                            build_batch_schedule)
    from repro_torch.data.synthetic import make_permuted_tasks
    tasks = make_permuted_tasks(0, n_tasks=cs.CL_TASKS, n_train=cs.CL_TRAIN,
                                n_test=cs.CL_TEST)
    trainer = TrainerSpec(epochs_per_task=cs.CL_EPOCHS,
                          batch_size=cs.CL_BATCH)
    t0 = time.perf_counter()
    build_batch_schedule(trainer, ReplaySpec(capacity=cs.CL_CAPACITY), tasks)
    return time.perf_counter() - t0


def median_ms(fn, n: int = 50) -> float:
    """Median milliseconds of ``fn()`` (which ends in a synchronize) over
    ``n`` calls after 5 warm-up calls."""
    import statistics
    for _ in range(5):
        fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def noise_times(dev) -> dict:
    """The host-side noise draws and the calls that make them."""
    import torch
    from repro_torch import prng
    from repro_torch.backends import get_backend
    from repro_torch.core.miru import MiRUConfig, init_miru_params
    cfg = MiRUConfig(n_x=cs.N_X, n_h=cs.N_H, n_y=cs.N_Y)
    params = init_miru_params(prng.PRNGKey(0), cfg, dev)
    g = torch.Generator().manual_seed(0)
    updates = {k: (torch.randn(p.shape, generator=g) * 0.01
                   * (torch.rand(p.shape, generator=g) < 0.57)).to(dev)
               for k, p in params.items()}
    key = prng.PRNGKey(1)

    def draws():
        for kw, (name, p) in zip(prng.split(key, len(params)),
                                 sorted(params.items())):
            prng.normal(kw, p.shape, device=dev)
        torch.cuda.synchronize()
    out = {"write_noise_draw_ms": median_ms(draws)}
    for name in ("analog", "analog_state"):
        be = get_backend(name)
        state = be.init_device_state(params, prng.PRNGKey(2))

        def update():
            be.device_apply_update(params, updates, key, state=state)
            torch.cuda.synchronize()
        out[f"{name}_update_ms"] = median_ms(update)
    be = cs.read_noise_backend()
    x = torch.rand((cs.CL_BATCH, cs.N_H), generator=g).to(dev)

    def vmm():
        be.vmm(x, params["u_h"], key)
        torch.cuda.synchronize()
    out["read_noise_vmm_ms"] = median_ms(vmm)
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=None,
                    help="also append the JSON lines to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_host_time: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build
    _build.build()
    dev = torch.device("cuda", 0)
    cs.software_run(dev, steps=3)
    for backend in ("ideal", "wbs"):
        cs.protocol_run(dev, backend, n_tasks=1)
    for rep in range(args.repeats):
        row = {"tree": str(ROOT), "repeat": rep, "split_us": split_us(),
               "schedule_s": schedule_s(),
               "sw_ms_per_step": 1e3 * cs.software_run(dev)["wall_s"]
               / cs.SW_STEPS}
        for backend in ("ideal", "wbs"):
            row[f"{backend}_ms_per_step"] = cs.train_step_ms(dev, backend)
            row[f"{backend}_wall_s"] = cs.protocol_run(dev, backend)["wall_s"]
        for backend in ("analog", "analog_state"):
            row[f"{backend}_ms_per_step"] = cs.train_step_ms(dev, backend)
        row["read_noise_ms_per_step"] = cs.train_step_ms(
            dev, cs.read_noise_backend(), steps=30)
        row.update(noise_times(dev))
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
