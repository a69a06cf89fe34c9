"""Roofline analysis from the dry-run records — counterpart of
``repro/launch/roofline.py``, at an NVIDIA H100's peaks.

Hardware model: NVIDIA's datasheet figures for the H100 SXM5 80GB, not
measurements (a card set below 700 W runs slower under load):
    989 TFLOP/s bf16 dense on the tensor cores · 3.35 TB/s HBM3 ·
    50 GB/s a link: one 400 Gb/s NIC a GPU, as in NVIDIA's DGX H100, the
    slowest link that a 16-wide mesh axis crosses
and, for the hand-written kernels' bounds (``chip_smoke.py``), 67 TFLOP/s
fp32 and 34 TFLOP/s fp64 on the CUDA cores.

Terms, per (arch × shape × mesh), all in seconds *per step*:
    compute    = FLOPs            / peak
    memory     = bytes            / hbm_bw
    collective = collective_bytes / link_bw

FLOPs, bytes and collective bytes are one rank's, from
``launch/hlo_analysis.py`` (the dispatched program, each hand-written
kernel's launch at its ``kernels/work.py`` work), × chips for the global
figure. The dominant term is the bottleneck.

MODEL_FLOPS (the "useful" fraction):
    train  : 6 · N(active) · tokens  (+ 12·L·S²·H·hd attention term)
    prefill: 2 · N(active) · tokens  (+ attention term)
    decode : 2 · N(active) · batch   (+ 4·L·S·H·hd cache-attention term)
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES

PEAK_FLOPS = 989e12          # bf16 dense, tensor cores (datasheet)
HBM_BW = 3.35e12             # bytes/s, HBM3 (datasheet)
LINK_BW = 50e9               # bytes/s, one 400 Gb/s NIC a GPU (DGX H100)
PEAK_FP32_FLOPS = 67e12      # CUDA cores (datasheet)
PEAK_FP64_FLOPS = 34e12      # CUDA cores (datasheet)

RESULTS_DIR = Path(__file__).resolve().parents[3] / "dryrun_out"


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops: float
    useful_ratio: float
    bound: str
    step_s: float                 # max of the three (no-overlap bound)
    roofline_frac: float          # compute_s / step_s ("% of roofline")
    per_collective: dict
    note: str = ""

    def row(self) -> str:
        return (f"| {self.arch} | {self.shape} | {self.mesh} "
                f"| {self.compute_s*1e3:.2f} | {self.memory_s*1e3:.2f} "
                f"| {self.collective_s*1e3:.2f} | {self.bound} "
                f"| {self.useful_ratio:.2f} | {self.roofline_frac*100:.0f}% |")


def model_flops(arch: str, shape_name: str) -> float:
    """Analytical 'useful' FLOPs per step."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    counts = cfg.param_counts()
    n_active = counts["active"]
    B, S = shape.global_batch, shape.seq_len

    # Attention score/value FLOPs (not in 6·N·D).
    hd = cfg.hd()
    n_attn_layers = sum(0 if cfg.is_ssm_layer(i) else 1
                        for i in range(cfg.n_layers))
    if cfg.use_mla:
        qk_dim = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        attn_per_tok_pair = 2 * cfg.n_heads * (qk_dim + cfg.v_head_dim)
    else:
        attn_per_tok_pair = 4 * cfg.n_heads * hd

    if shape.kind == "train":
        tokens = B * S
        flops = 6 * n_active * tokens
        flops += 3 * n_attn_layers * attn_per_tok_pair * B * S * S / 2
    elif shape.kind == "prefill":
        tokens = B * S
        flops = 2 * n_active * tokens
        flops += n_attn_layers * attn_per_tok_pair * B * S * S / 2
    else:  # decode: one token per sequence, attention over S cache
        flops = 2 * n_active * B
        flops += n_attn_layers * attn_per_tok_pair * B * S
    return float(flops)


def load_record(arch: str, shape: str, mesh: str,
                tag: str = "", out_dir: Path = RESULTS_DIR
                ) -> Optional[dict]:
    suffix = f"-{tag}" if tag else ""
    f = Path(out_dir) / f"{arch}--{shape}--{mesh}{suffix}.json"
    if not f.exists():
        return None
    return json.loads(f.read_text())


def attention_score_bytes(rec: dict, kv_len: Optional[int] = None
                          ) -> float:
    """Traffic of materialised attention score and probability buffers:
    the per-shape breakdown's buffers of four or more dims whose last dim
    is the key length (``kv_len``, default the shape's sequence length).
    The port materialises them only where it takes ``full_attention``: a
    decode, a query offset (a sequence shard past the first under the
    gathered attention) or per-row key lengths. A flash prefill has none:
    the kernel event carries its traffic. Used for the 'flash' adjusted
    memory term, which takes them away."""
    if kv_len is None:
        kv_len = SHAPES[rec["shape"]].seq_len
    hlo = rec.get("hlo_analysis") or {}
    total = 0.0
    for ent in hlo.get("top_shapes", []):
        dims = ent["op_shape"].split("[")[-1].rstrip("]").split(",")
        if len(dims) >= 4 and dims[-1] == str(kv_len):
            total += ent["bytes"]
    return total


def roofline_from_record(rec: dict, flash_adjust: bool = False
                         ) -> Optional[Roofline]:
    if rec.get("skipped") or not rec.get("ok"):
        return None
    hlo = rec.get("hlo_analysis")
    if not hlo:
        return None
    chips = rec["chips"]
    # hlo_analysis numbers are per rank; wall-clock per step:
    compute_s = hlo["flops"] / PEAK_FLOPS
    bytes_acc = hlo["bytes_accessed"]
    note = ""
    if flash_adjust:
        adj = attention_score_bytes(rec)
        if adj:
            bytes_acc -= adj
            note = f"flash −{adj:.2e} B score traffic"
    memory_s = bytes_acc / HBM_BW
    collective_s = hlo["collective_bytes"] / LINK_BW
    mf = model_flops(rec["arch"], rec["shape"])
    hlo_global = hlo["flops"] * chips
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bound = max(terms, key=terms.get)
    step_s = max(terms.values())
    return Roofline(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, model_flops=mf, hlo_flops=hlo_global,
        useful_ratio=mf / hlo_global if hlo_global else 0.0,
        bound=bound, step_s=step_s,
        roofline_frac=compute_s / step_s if step_s else 0.0,
        per_collective=hlo.get("per_collective", {}), note=note)


def summarize(mesh: str = "16x16", tag: str = "",
              out_dir: Path = RESULTS_DIR,
              flash_adjust: bool = False) -> list[Roofline]:
    from repro_torch.configs import list_archs
    out = []
    for arch in list_archs():
        for shape in SHAPES:
            rec = load_record(arch, shape, mesh, tag, out_dir)
            if rec is None:
                continue
            r = roofline_from_record(rec, flash_adjust)
            if r is not None:
                out.append(r)
    return out


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out-dir", default=str(RESULTS_DIR))
    args = ap.parse_args()
    rows = summarize(args.mesh, args.tag, Path(args.out_dir))
    print("| arch | shape | mesh | compute ms | memory ms | collective ms "
          "| bound | useful | roofline |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(r.row())


if __name__ == "__main__":
    main()
