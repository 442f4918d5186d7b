"""Command-line front end: ``python -m repro_torch.analysis`` /
``tools/repro_torch_lint.py``.

Exit code 0 when every finding is covered by the committed baseline (or
there are none); 1 when anything *new* shows up.  The last line of text
output is the JAX package's machine-greppable one-liner::

    repro-lint: files=90 total=0 new=0 baselined=0 suppressed=0 audit=ok

so the CI log carries the per-rule counts even on success.  The audit
runs on ``--device`` (default: the CUDA card, which it needs; ``cpu``
runs the plain versions); ``--no-audit`` lints only and needs no card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import List, Optional, Sequence

from repro_torch.analysis.findings import (
    Finding,
    count_by_rule,
    load_baseline,
    save_baseline,
    split_new,
)
from repro_torch.analysis.visitor import iter_source_files, lint_paths


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch_lint",
        description=("Determinism & parity-contract static analyzer (AST "
                     "lint + torch-graph audit)."),
    )
    ap.add_argument(
        "paths",
        nargs="*",
        default=["src/repro_torch"],
        help="files or directories to lint (default: src/repro_torch)",
    )
    ap.add_argument(
        "--format",
        choices=("text", "json"),
        default="text",
        help="output format (default: text)",
    )
    ap.add_argument(
        "--baseline",
        type=pathlib.Path,
        default=None,
        help="committed baseline JSON; matched findings do not fail",
    )
    ap.add_argument(
        "--write-baseline",
        type=pathlib.Path,
        default=None,
        help="write every current finding to this baseline file and exit 0",
    )
    ap.add_argument(
        "--no-audit",
        action="store_true",
        help="skip the graph audit (AST lint only; needs no card)",
    )
    ap.add_argument(
        "--device",
        default=None,
        help="torch device the audit runs on (default: the CUDA card)",
    )
    ap.add_argument(
        "--root",
        type=pathlib.Path,
        default=None,
        help="repo root for relative paths (default: cwd)",
    )
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    paths = [pathlib.Path(p) for p in args.paths]
    n_files = len(iter_source_files(paths))

    findings, suppressed = lint_paths(paths, root=args.root)
    audit_status = "skipped"
    if not args.no_audit:
        from repro_torch.analysis.contracts import run_audit

        audit_findings = run_audit(device=args.device)
        findings = findings + audit_findings
        audit_status = "ok" if not audit_findings else "fail"

    if args.write_baseline is not None:
        save_baseline(args.write_baseline, findings)
        print(f"wrote {len(findings)} baseline entries to {args.write_baseline}")
        return 0

    baseline = load_baseline(args.baseline) if args.baseline else []
    new, baselined = split_new(findings, baseline)

    if args.format == "json":
        payload = {
            "files": n_files,
            "counts": count_by_rule(findings),
            "findings": [f.to_dict() for f in findings],
            "new": [f.to_dict() for f in new],
            "baselined": len(baselined),
            "suppressed": len(suppressed),
            "audit": audit_status,
            "exit": 1 if new else 0,
        }
        print(json.dumps(payload, indent=2))
    else:
        for f in new:
            print(f.format())
        print(_summary_line(n_files, findings, new, baselined, suppressed, audit_status))
    return 1 if new else 0


def _summary_line(
    n_files: int,
    findings: Sequence[Finding],
    new: Sequence[Finding],
    baselined: Sequence[Finding],
    suppressed: Sequence[Finding],
    audit_status: str,
) -> str:
    counts = count_by_rule(findings)
    per_rule = " ".join(f"{code}={n}" for code, n in counts.items())
    parts: List[str] = [f"repro-lint: files={n_files}"]
    if per_rule:
        parts.append(per_rule)
    parts.append(
        f"total={len(findings)} new={len(new)} "
        f"baselined={len(baselined)} suppressed={len(suppressed)} "
        f"audit={audit_status}"
    )
    return " ".join(parts)


if __name__ == "__main__":
    sys.exit(main())
