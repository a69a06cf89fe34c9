"""Render the dry-run and roofline tables from the dry-run records —
counterpart of ``repro/launch/make_report.py``. The dry-run table's
"trace s" is the seconds to run the rank's program (the reference's
"compile s"). Each table reads records of one program only: one torch
release, and one pricing of reshards a mesh (the records'
``torch_version`` and ``reshard_costs``, ``launch/dryrun.py``), else it
raises (:func:`provenance`).

    PYTHONPATH=src python -m repro_torch.launch.make_report > report.md
"""
from __future__ import annotations

from repro_torch.configs import list_archs
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.roofline import load_record, summarize


def provenance(*cells: tuple[str, str]) -> dict:
    """The program that the traced records at each (mesh, tag) of
    ``cells`` count: {"torch": version, "reshard_costs": {mesh:
    pricing}}. Raises ValueError where two of them were traced by
    different torch releases, or two of one mesh under different reshard
    pricing: DTensor chose their placements by different rules, so their
    counts are of different programs."""
    versions, pricing = set(), {}
    for mesh, tag in cells:
        for arch in list_archs():
            for shape in SHAPES:
                rec = load_record(arch, shape, mesh, tag)
                if rec is None or rec.get("skipped") or not rec.get("ok"):
                    continue
                versions.add(rec.get("torch_version"))
                pricing.setdefault(mesh, set()).add(
                    rec.get("reshard_costs"))
    mixed = [f"{m} priced by {sorted(map(str, p))}"
             for m, p in pricing.items() if len(p) > 1]
    if len(versions) > 1:
        mixed.insert(0, f"torch {sorted(map(str, versions))}")
    if mixed:
        raise ValueError("the records mix programs: " + "; ".join(mixed)
                         + "; trace them again under one")
    return {"torch": next(iter(versions), None),
            "reshard_costs": {m: next(iter(p)) for m, p in pricing.items()}}


def _gb(x) -> str:
    return f"{x / 2**30:.2f}"


def dryrun_table(mesh: str, tag: str = "") -> str:
    provenance((mesh, tag))
    rows = ["| arch | shape | status | trace s | args GB/dev | "
            "temp GB/dev | collective ops (count) |",
            "|---|---|---|---|---|---|---|"]
    for arch in list_archs():
        for shape in SHAPES:
            rec = load_record(arch, shape, mesh, tag)
            if rec is None:
                continue
            if rec.get("skipped"):
                rows.append(f"| {arch} | {shape} | SKIP (sub-quadratic "
                            f"attention required) | — | — | — | — |")
                continue
            if not rec.get("ok"):
                rows.append(f"| {arch} | {shape} | **FAIL** | — | — | — | "
                            f"{rec.get('error', '')[:60]} |")
                continue
            mem = rec.get("memory_analysis", {})
            colls = rec.get("hlo_analysis", {}).get("per_collective", {})
            coll_str = ", ".join(
                f"{k}×{int(v['count'])}" for k, v in sorted(colls.items()))
            rows.append(
                f"| {arch} | {shape} | OK | {rec.get('trace_s', '?')} "
                f"| {_gb(mem.get('argument_size_in_bytes', 0))} "
                f"| {_gb(mem.get('temp_size_in_bytes', 0))} "
                f"| {coll_str or '—'} |")
    return "\n".join(rows)


def roofline_table(mesh: str, tag: str = "",
                   flash_adjust: bool = False) -> str:
    provenance((mesh, tag))
    rows = ["| arch | shape | compute ms | memory ms | collective ms | "
            "bound | MODEL/HLO flops | roofline frac |",
            "|---|---|---|---|---|---|---|---|"]
    for r in summarize(mesh, tag, flash_adjust=flash_adjust):
        rows.append(r.row())
    return "\n".join(rows)


def perf_compare_table() -> str:
    """Baseline vs optimized per-cell step-time bound comparison."""
    provenance(("16x16", ""), ("16x16", "opt"))
    rows = ["| arch | shape | baseline step ms (bound) | optimized step "
            "ms (bound) | +flash ms | Δ total |",
            "|---|---|---|---|---|---|"]
    base = {(r.arch, r.shape): r for r in summarize("16x16", "")}
    opt = {(r.arch, r.shape): r for r in summarize("16x16", "opt")}
    fl = {(r.arch, r.shape): r
          for r in summarize("16x16", "opt", flash_adjust=True)}
    for key, b in base.items():
        o = opt.get(key)
        f = fl.get(key)
        if o is None:
            continue
        gain = b.step_s / f.step_s if f and f.step_s else 1.0
        rows.append(
            f"| {key[0]} | {key[1]} | {b.step_s*1e3:.1f} ({b.bound}) "
            f"| {o.step_s*1e3:.1f} ({o.bound}) "
            f"| {f.step_s*1e3:.1f} | {gain:.2f}× |")
    return "\n".join(rows)


def main() -> None:
    prov = provenance(("16x16", ""), ("2x16x16", ""), ("16x16", "opt"))
    print(f"Traced by torch {prov['torch']}; reshard costs "
          + ", ".join(f"{m}: {p}" for m, p in prov["reshard_costs"].items())
          + ".\n")
    print("## Dry-run — 16×16 (one pod, 256 ranks), baseline\n")
    print(dryrun_table("16x16"))
    print("\n## Dry-run — 2×16×16 (two pods, 512 ranks), baseline\n")
    print(dryrun_table("2x16x16"))
    print("\n## Roofline — baseline (16×16)\n")
    print(roofline_table("16x16"))
    print("\n## Roofline — optimized (ulysses + EP MoE, 16×16)\n")
    print(roofline_table("16x16", "opt"))
    print("\n## Roofline — optimized + flash adjustment\n")
    print(roofline_table("16x16", "opt", flash_adjust=True))
    print("\n## Baseline vs optimized\n")
    print(perf_compare_table())


if __name__ == "__main__":
    main()
