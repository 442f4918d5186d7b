"""The dry-run and roofline tables, in Markdown, from saved dry runs.

    PYTHONPATH=src python -m repro_torch.roofline.report \\
        --baseline experiments/dryrun_torch [--optimized DIR] [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import pathlib
from typing import List

from repro_torch.roofline.analysis import MESH_TAG, Roofline, analyze_dir


def dryrun_table(dirpath, mesh_tag: str = MESH_TAG) -> str:
    out = ["| arch | shape | status | trace_s | flops | peak GiB | fits | "
           "note |",
           "|---|---|---|---|---|---|---|---|"]
    for jf in sorted(pathlib.Path(dirpath).glob(f"*__{mesh_tag}.json")):
        m = json.loads(jf.read_text())
        out.append(
            f"| {m['arch']} | {m['shape']} | {m['status']} | "
            f"{m['trace_s']} | {m['flops']:.2e} | "
            f"{m['peak_memory_per_device'] / 2**30:.2f} | {m['fits']} | "
            f"{m['note'][:70]} |")
    return "\n".join(out)


def roofline_table(rows: List[Roofline]) -> str:
    out = ["| arch | shape | compute_s | memory_s | memory_hi_s | cxl_s | "
           "dominant | MODEL/traced | MFU-bound |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append(
            f"| {r.arch} | {r.shape} | {r.compute_s:.2e} | {r.memory_s:.2e} "
            f"| {r.memory_hi_s:.2e} | {r.cxl_s:.2e} | **{r.dominant}** | "
            f"{r.useful_ratio:.2f} | {r.mfu_bound:.1%} |")
    return "\n".join(out)


def compare_table(base: List[Roofline], opt: List[Roofline]) -> str:
    bidx = {(r.arch, r.shape): r for r in base}
    out = ["| arch | shape | MFU before | MFU after | memory_s before | "
           "memory_s after | speedup(bound) |",
           "|---|---|---|---|---|---|---|"]
    for r in opt:
        b = bidx.get((r.arch, r.shape))
        if b is None:
            continue
        b_bound = max(b.terms().values())
        r_bound = max(r.terms().values())
        out.append(
            f"| {r.arch} | {r.shape} | {b.mfu_bound:.1%} | "
            f"**{r.mfu_bound:.1%}** | {b.memory_s:.2e} | {r.memory_s:.2e} | "
            f"{b_bound / max(r_bound, 1e-9):.1f}x |")
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", default="experiments/dryrun_torch")
    ap.add_argument("--optimized", default="experiments/dryrun_torch_opt")
    ap.add_argument("--out", default="experiments/tables_torch")
    args = ap.parse_args(argv)
    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    base = analyze_dir(args.baseline)
    (outdir / "roofline_baseline.md").write_text(roofline_table(base))
    (outdir / "roofline_baseline.json").write_text(
        json.dumps([r.row() for r in base], indent=1))
    (outdir / f"dryrun_{MESH_TAG}.md").write_text(
        dryrun_table(args.baseline))
    opt_dir = pathlib.Path(args.optimized)
    if opt_dir.exists() and list(opt_dir.glob(f"*__{MESH_TAG}.json")):
        opt = analyze_dir(opt_dir)
        (outdir / "roofline_optimized.md").write_text(roofline_table(opt))
        (outdir / "roofline_optimized.json").write_text(
            json.dumps([r.row() for r in opt], indent=1))
        (outdir / "before_after.md").write_text(compare_table(base, opt))
    print(f"tables written to {outdir}")


if __name__ == "__main__":
    main()
