"""Finding model, inline suppressions, and the committed baseline.

A :class:`Finding` is one rule hit at one source location.  Two escape
hatches exist, both deliberate decisions a reviewer can see in a diff:

* an inline ``# repro-lint: disable=CODE[,CODE...]`` comment on the
  offending line (or on its own line directly above) silences that line;
* a committed **baseline** file records accepted findings by
  ``(code, path, symbol, message)`` — line numbers are excluded so
  unrelated edits above a finding do not invalidate the baseline.  Each
  baseline entry absorbs exactly one identical finding (multiset
  semantics), so a *second* occurrence of an accepted pattern is still
  new.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import re
from collections import Counter
from typing import Dict, Iterable, List, Sequence, Tuple

ERROR = "error"
WARNING = "warning"

_DISABLE_RE = re.compile(r"#\s*repro-lint:\s*disable=([A-Z0-9, ]+)")

BaselineKey = Tuple[str, str, str, str]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one location.

    Attributes
    ----------
    code : str
        Stable rule id (``RL1xx`` lint, ``RA4xx`` audit) — the token
        suppressions and the baseline match on.
    name : str
        Human-readable rule slug (``seedless-rng``).
    severity : str
        ``"error"`` or ``"warning"`` — reporting metadata only; *any*
        non-baselined finding fails the run.
    path : str
        Repo-relative source path, or ``<graph:entry>`` for audit
        findings that have no single source line.
    line, col : int
        1-based line and 0-based column (0/0 for audit findings).
    message : str
        What is wrong and what to do instead.
    symbol : str
        Enclosing function/class scope (``<module>`` at top level).
    """

    code: str
    name: str
    severity: str
    path: str
    line: int
    col: int
    message: str
    symbol: str = "<module>"

    @property
    def baseline_key(self) -> BaselineKey:
        """Line-number-free identity used by the baseline file."""
        return (self.code, self.path, self.symbol, self.message)

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    def format(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: {self.code} "
            f"[{self.name}] {self.message} (in {self.symbol})"
        )


def parse_suppressions(source: str) -> Dict[int, frozenset]:
    """Map line number -> codes disabled there.

    A trailing comment applies to its own line; a comment that is the
    only thing on its line also applies to the next line (so a long
    statement can carry its justification above itself).
    """
    out: Dict[int, set] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _DISABLE_RE.search(text)
        if not m:
            continue
        codes = {c.strip() for c in m.group(1).split(",") if c.strip()}
        out.setdefault(i, set()).update(codes)
        if text.lstrip().startswith("#"):
            out.setdefault(i + 1, set()).update(codes)
    return {ln: frozenset(cs) for ln, cs in out.items()}


def apply_suppressions(
    findings: Iterable[Finding], suppressions: Dict[int, frozenset]
) -> Tuple[List[Finding], List[Finding]]:
    """Split findings into (kept, suppressed) per the inline comments."""
    kept: List[Finding] = []
    dropped: List[Finding] = []
    for f in findings:
        if f.code in suppressions.get(f.line, frozenset()):
            dropped.append(f)
        else:
            kept.append(f)
    return kept, dropped


def load_baseline(path: pathlib.Path) -> List[BaselineKey]:
    """Read the committed baseline; missing file means an empty baseline."""
    if not path.exists():
        return []
    data = json.loads(path.read_text())
    entries = data["findings"] if isinstance(data, dict) else data
    return [(e["code"], e["path"], e["symbol"], e["message"]) for e in entries]


def save_baseline(path: pathlib.Path, findings: Sequence[Finding]) -> None:
    """Write every current finding as an accepted baseline entry."""
    entries = [
        {
            "code": f.code,
            "path": f.path,
            "symbol": f.symbol,
            "message": f.message,
        }
        for f in sorted(findings, key=lambda f: f.baseline_key)
    ]
    path.write_text(json.dumps({"findings": entries}, indent=2) + "\n")


def split_new(
    findings: Sequence[Finding], baseline: Sequence[BaselineKey]
) -> Tuple[List[Finding], List[Finding]]:
    """Partition findings into (new, baselined) under multiset matching."""
    budget = Counter(baseline)
    new: List[Finding] = []
    matched: List[Finding] = []
    for f in findings:
        if budget[f.baseline_key] > 0:
            budget[f.baseline_key] -= 1
            matched.append(f)
        else:
            new.append(f)
    return new, matched


def count_by_rule(findings: Iterable[Finding]) -> Dict[str, int]:
    """Per-rule finding counts (the CI one-liner's payload)."""
    counts: Counter = Counter(f.code for f in findings)
    return dict(sorted(counts.items()))
