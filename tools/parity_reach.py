#!/usr/bin/env python3
"""How far the training checks of ``chip_smoke.py`` reach: card-vs-CPU
distances of sound runs beside those of runs with a fault planted on the
card side.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 tools/parity_reach.py [--out FILE]

``chip_smoke.py`` holds each training path on the card against the port's
own CPU run of the same work: train (a) by its losses, final params and
test accuracy, train (b) by its leading losses (``LOSS_AGREE_STEPS``)
and the R matrix (``R_TOLERANCE``). A check is worth only as much as the
gap between the distances it allows and those a wrong card path
produces. This script prints, one JSON line per run:

- ``loss_agree_steps``: how many leading steps' losses agree with the
  sound CPU run at ``chip_smoke.LOSS_RTOL`` / ``LOSS_ATOL`` (rtol 1e-4,
  atol 1e-5);
- train (a): test accuracy and the final params' largest difference;
- train (b): R, MA, the largest R difference in test examples and the MA
  difference, and whether ``R_TOLERANCE`` would pass it.

Sound runs: the card, and the CPU at its default thread count and at 2
threads (another summation order in the CPU's BLAS). Planted faults,
each made in this process without touching the package's files:

- train (a) ``stale_h_prev``: the forward hands DFA h_t where h_{t-1}
  belongs (the shift of ``miru_forward`` dropped);
- train (b) on ``wbs``: ``clip_off`` (no weight clip: ``weight_clip``
  None), ``adc_off`` (the ADC skipped: ``adc_bits`` None), ``input_7bit``
  (the drive quantized to 7 bits instead of 8), ``u_writes_lost`` (the
  recurrent matrix's writes never land);
- train (c) on ``analog``: ``write_noise_off`` (``write_sigma`` 0),
  ``gain_noise_off`` (``gain_sigma`` 0), ``adc_off``,
  ``u_writes_lost``;
- train (d), ``analog`` with read noise (held, as in ``chip_smoke.py``,
  against a CPU run of its first epoch): ``read_noise_off`` (σ = 0) and
  ``read_sigma_0.05`` (half the noise).

``--paths`` picks some of ``software ideal wbs analog read_noise`` (all
by default).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

_OUT = None
PATHS = ("software", "ideal", "wbs", "analog", "read_noise")


def emit(**row) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    if _OUT:
        with open(_OUT, "a") as f:
            f.write(line + "\n")


@contextlib.contextmanager
def threads(n: int):
    import torch
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


@contextlib.contextmanager
def stale_h_prev():
    """DFA sees h_t in place of h_{t-1}."""
    from repro_torch.core import dfa
    orig = dfa.miru_forward

    def forward(*args, **kwargs):
        logits, inter = orig(*args, **kwargs)
        return logits, dict(inter, h_prev=inter["h_all"])
    dfa.miru_forward = forward
    try:
        yield
    finally:
        dfa.miru_forward = orig


def lost_u_writes(name: str = "wbs"):
    """A ``name`` backend whose writes to u_h never land."""
    import torch
    from repro_torch.backends import get_backend
    be = get_backend(name)
    orig = be.apply_update

    def apply_update(params, updates, key=None):
        updates = dict(updates, u_h=torch.zeros_like(updates["u_h"]))
        return orig(params, updates, key)
    be.apply_update = apply_update
    return be


def software(dev, cpu) -> None:
    import numpy as np
    import torch

    def row(name, run):
        d = max(float((run["params"][k].cpu() - cpu["params"][k]).abs()
                      .max()) for k in cpu["params"])
        emit(path="train_software", run=name,
             loss_agree_steps=cs.loss_agree_steps(run["losses"],
                                                  cpu["losses"]),
             steps=len(cpu["losses"]), test_acc=run["acc"],
             cpu_test_acc=cpu["acc"],
             d_test_examples=round(abs(run["acc"] - cpu["acc"])
                                   * cs.SW_TEST),
             max_abs_d_params=d,
             max_rel_d_loss=float(np.max(
                 np.abs(run["losses"] - cpu["losses"])
                 / np.abs(cpu["losses"]))))
    row("card", cs.software_run(dev))
    with threads(2):
        row("cpu_2_threads", cs.software_run(torch.device("cpu")))
    with stale_h_prev():
        row("card_stale_h_prev", cs.software_run(dev))


def analog_spec(**crossbar):
    """``analog``'s default spec with some crossbar fields replaced."""
    import dataclasses
    from repro_torch.backends.analog import AnalogBackend
    spec = AnalogBackend.default_spec()
    return {"crossbar": dataclasses.replace(spec.crossbar, **crossbar)}


def read_noise(dev) -> None:
    """Train (d): the card's read-noise run against the CPU's first
    epoch, beside planted faults."""
    import torch
    from repro_torch.backends import get_backend
    cpu = cs.protocol_run(torch.device("cpu"), cs.read_noise_backend(),
                          n_tasks=1, epochs=cs.RN_CPU_EPOCHS)
    sigma = lambda s: get_backend("analog", spec_overrides=analog_spec(
        read_sigma=s, w_clip=cs.W_SCALE))
    runs = {"card": lambda: cs.protocol_run(dev, cs.read_noise_backend(),
                                            n_tasks=1),
            "card_read_noise_off": lambda: cs.protocol_run(
                dev, sigma(0.0), n_tasks=1),
            "card_read_sigma_0.05": lambda: cs.protocol_run(
                dev, sigma(0.05), n_tasks=1)}
    for name, fn in runs.items():
        run = fn()
        n = len(cpu["losses"])
        emit(path="train_read_noise", run=name,
             loss_agree_steps=cs.loss_agree_steps(run["losses"][:n],
                                                  cpu["losses"]),
             steps=n, acc=float(run["R"][0][0]))


def protocol(dev, backends) -> None:
    import numpy as np
    import torch
    from repro_torch.backends import get_backend
    faults = {
        "wbs": {"clip_off": {"weight_clip": None},
                "adc_off": {"adc_bits": None},
                "input_7bit": {"input_bits": 7}},
        "analog": {"write_noise_off": analog_spec(write_sigma=0.0),
                   "gain_noise_off": {"gain_sigma": 0.0},
                   "adc_off": {"adc_bits": None}}}
    for backend in backends:
        cpu = cs.protocol_run(torch.device("cpu"), backend)
        runs = {"card": lambda: cs.protocol_run(dev, backend)}
        runs["cpu_2_threads"] = lambda: cs.protocol_run(
            torch.device("cpu"), backend)
        for name, over in faults.get(backend, {}).items():
            runs[f"card_{name}"] = (
                lambda over=over: cs.protocol_run(
                    dev, get_backend(backend, spec_overrides=over)))
        if backend in faults:
            runs["card_u_writes_lost"] = lambda: cs.protocol_run(
                dev, lost_u_writes(backend))
        for name, fn in runs.items():
            if name == "cpu_2_threads":
                with threads(2):
                    run = fn()
            else:
                run = fn()
            R, cR = np.asarray(run["R"]), np.asarray(cpu["R"])
            d_ex = float(np.abs(R - cR).max()) * cs.CL_TEST
            d_ma = abs(run["MA"] - cpu["MA"])
            emit(path="train_protocol", backend=backend, run=name,
                 loss_agree_steps=cs.loss_agree_steps(run["losses"],
                                                      cpu["losses"]),
                 steps=len(cpu["losses"]), R=R.tolist(), MA=run["MA"],
                 cpu_R=cR.tolist(), cpu_MA=cpu["MA"],
                 max_d_test_examples=d_ex, d_MA=d_ma,
                 passes_R_tolerance=cs.r_within(backend, run, cpu))


def main() -> int:
    global _OUT
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also append the JSON lines to this file")
    ap.add_argument("--paths", nargs="+", default=list(PATHS),
                    choices=PATHS)
    args = ap.parse_args()
    _OUT = args.out
    paths = args.paths
    if not torch.cuda.is_available():
        print("parity_reach: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build
    _build.build()
    dev = torch.device("cuda", 0)
    if "software" in paths:
        software(dev, cs.software_run(torch.device("cpu")))
    protocol(dev, [p for p in ("ideal", "wbs", "analog") if p in paths])
    if "read_noise" in paths:
        read_noise(dev)
    emit(nvidia_smi=cs.nvidia_smi(), cpu_threads=torch.get_num_threads())
    return 0


if __name__ == "__main__":
    sys.exit(main())
