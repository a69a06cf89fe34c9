#!/usr/bin/env python3
"""The moves behind ``chip_smoke.py``'s ``lm_quant`` tolerances, on the CPU.

Run from the repository root:

    python3 tools/lmq_tolerances.py {prefill,train,serve} [--tokens N]
        [--threads 8]

Each part runs one of the phase's CPU twins as the script builds it, then
again with one perturbation at a time, and prints one JSON line a run
with how far the result moved:

- ``prefill``: the quantized 2-layer fp32 twin's logits on ``--tokens``
  tokens (``chip_smoke.LMQ_TWIN_S`` by default): one ulp up on every
  weight of one norm of one layer (each norm and layer in turn), and the
  planted fault, a 7-bit drive (``LMQ_FAULT_BITS``); max and mean
  |Δ logit| (``chip_smoke.lmq_distance``);
- ``train``: one quantized ``Trainer`` step of that twin: one ulp up on
  every norm weight of layer 0, and the 7-bit drive; the relative moves
  of the loss and the global grad norm;
- ``serve``: the metered engine's traffic at qwen2's smoke width: one ulp
  up on every norm weight of one layer, then on the final norm; the
  tie-aware token comparison's largest |Δ logit| and flipped streams
  (``testing.compare_tokens``).

A last-bit difference between the card and the CPU outside the WBS
products (a norm's reduction, the attention) moves results by about
these amounts; the script's tolerances lie above them and below the
fault. A 256-token prefill twin takes one to several minutes of one CPU
thread; ``--threads`` sets torch's threads.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def norm_weights(params) -> list:
    """(path, tensor) of every norm weight in ``params``; a stacked
    layer tensor has the layer on its first axis."""
    import torch
    out = []

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        elif torch.is_tensor(tree) and any("norm" in str(p) for p in path):
            out.append(("/".join(map(str, path)), tree))
    walk(params, ())
    return out


def ulp_up(t) -> None:
    import torch
    t.copy_(torch.nextafter(t, torch.full_like(t, float("inf"))))


def seven_bit_drive():
    """A context in which every quantized product drives LMQ_FAULT_BITS
    bits (chip_smoke's planted fault)."""
    import contextlib

    import chip_smoke as cs
    from repro_torch.kernels import ops

    @contextlib.contextmanager
    def ctx():
        wbs_dense = ops.wbs_dense
        ops.wbs_dense = lambda x, w, n_bits=8, **kw: wbs_dense(
            x, w, cs.LMQ_FAULT_BITS, **kw)
        try:
            yield
        finally:
            ops.wbs_dense = wbs_dense
    return ctx()


def prefill(S: int) -> None:
    import torch

    import chip_smoke as cs
    cpu = torch.device("cpu")
    cfg, params = cs.lmq_twin_model(cpu, quant_mode="wbs")
    base = cs.lmq_logits(cfg, params, S)
    print(json.dumps({"part": "prefill", "tokens": S,
                      "attn_chunk": cfg.attn_chunk,
                      "max_abs_logit": float(base.abs().max())}), flush=True)
    with seven_bit_drive():
        d = cs.lmq_distance(cs.lmq_logits(cfg, params, S), base)
    print(json.dumps({"perturbation": "7-bit drive", **d}), flush=True)
    for name, t in norm_weights(params):
        for layer in range(t.shape[0] if t.dim() > 1 else 1):
            w = t[layer] if t.dim() > 1 else t
            old = w.clone()
            ulp_up(w)
            d = cs.lmq_distance(cs.lmq_logits(cfg, params, S), base)
            w.copy_(old)
            print(json.dumps({"perturbation": f"1 ulp {name}",
                              "layer": layer if t.dim() > 1 else None,
                              **d}), flush=True)


def train(S: int) -> None:
    import torch

    import chip_smoke as cs
    cpu = torch.device("cpu")
    cs.LMQ_TWIN_S = S
    base = cs.lmq_train_twin_run(cpu)
    print(json.dumps({"part": "train", "tokens": S, **base}), flush=True)

    def rel(run, what):
        return {k: abs(run[k] - base[k]) / abs(base[k])
                for k in ("loss", "grad_norm")} | {"perturbation": what}
    zoo_model = cs.zoo_model

    def bumped(*a, **kw):
        cfg, params = zoo_model(*a, **kw)
        for name, t in norm_weights(params):
            if t.dim() > 1:
                ulp_up(t[0])
        return cfg, params
    cs.zoo_model = bumped
    try:
        print(json.dumps(rel(cs.lmq_train_twin_run(cpu),
                             "1 ulp every norm of layer 0")), flush=True)
    finally:
        cs.zoo_model = zoo_model
    with seven_bit_drive():
        print(json.dumps(rel(cs.lmq_train_twin_run(cpu), "7-bit drive")),
              flush=True)


def serve() -> None:
    import torch

    import chip_smoke as cs
    from repro_torch import testing
    cpu = torch.device("cpu")
    _, reqs = cs.lmq_smoke_serve(cpu)
    tokens = [r.tokens for r in reqs]
    logits = [torch.stack(r.logits) for r in reqs]
    print(json.dumps({"part": "serve", "requests": len(reqs),
                      "max_abs_logit": max(float(x.abs().max())
                                           for x in logits)}), flush=True)
    zoo_model = cs.zoo_model
    cfg, _ = zoo_model(cs.LM, cpu, dtype=torch.float32, seed=1, smoke=True)
    for layer in list(range(cfg.n_layers)) + [None]:
        def bumped(*a, layer=layer, **kw):
            c, params = zoo_model(*a, **kw)
            for name, t in norm_weights(params):
                final = name.startswith("final_norm")
                if layer is None and final:
                    ulp_up(t)
                elif layer is not None and not final:
                    ulp_up(t[layer])
            return c, params
        cs.zoo_model = bumped
        try:
            _, got = cs.lmq_smoke_serve(cpu)
        finally:
            cs.zoo_model = zoo_model
        rep = testing.compare_tokens([r.tokens for r in got], tokens,
                                     [r.logits for r in got], logits,
                                     atol=1.0)
        print(json.dumps({"perturbation": "1 ulp on the final norm"
                          if layer is None
                          else f"1 ulp every norm of layer {layer}",
                          "tokens_equal": [r.tokens for r in got] == tokens,
                          **rep.as_dict()}), flush=True)


def main() -> int:
    import torch

    import chip_smoke as cs
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("part", choices=("prefill", "train", "serve"))
    ap.add_argument("--tokens", type=int, default=cs.LMQ_TWIN_S)
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    if args.part == "prefill":
        prefill(args.tokens)
    elif args.part == "train":
        train(args.tokens)
    else:
        serve()
    return 0


if __name__ == "__main__":
    sys.exit(main())
