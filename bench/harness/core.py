"""The benchmark's common parts: the cell's files found by name, the
loaded-module check, the percentile, the compared numbers and the result
line.

Everything a cell needs is found from its entry in ``BENCHMARK.json``:

- ``bench/configs/<config>.json``: the configuration as it is run; its
  ``reference`` names the plain reference, ``bench/reference/<name>.py``;
- ``bench/traffic/<traffic>.json``: the mix's parameters; its ``generator``
  names the general generator that runs it, ``bench/generators/<name>.py``;
- ``bench/metrics/<metric>.py``: one reader per per-layer metric.
"""
from __future__ import annotations

import importlib.util
import json
import math
import pathlib
import re
import sys
from typing import Dict, List, Optional, Sequence

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_module(path: pathlib.Path, prefix: str):
    """Import the file at `path` under a private module name."""
    name = prefix + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def read_json(path: pathlib.Path) -> Dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic
    and metrics, each read from its own file."""

    def __init__(self, name: str, benchmark: Optional[Dict] = None,
                 bench_dir: pathlib.Path = BENCH):
        self.bench_dir = bench_dir
        bm = benchmark or read_json(bench_dir.parent / "BENCHMARK.json")
        cells = {w["name"]: w for w in bm["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = cells[name]
        self.name = name
        cfg_entry = next(c for c in bm["configs"]
                         if c["name"] == self.entry["config"])
        self.config = read_json(bench_dir.parent / cfg_entry["file"])
        self.traffic = read_json(bench_dir / "traffic"
                                 / f"{self.entry['traffic']}.json")
        self.end_to_end = [m for m in bm["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bm["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]

    def generator(self):
        return load_module(self.bench_dir / "generators"
                           / f"{self.traffic['generator']}.py", "bench_generator_")

    def reference(self):
        return load_module(self.bench_dir / "reference"
                           / f"{self.config['reference']}.py",
                           "bench_reference_")

    def metric_reader(self, name: str):
        return load_module(self.bench_dir / "metrics" / f"{name}.py",
                           "bench_metric_")


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (``repro_torch`` is neither)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def percentile(values: Sequence[float], q: float) -> float:
    """The `q`-th percentile (0-100) by linear interpolation between the
    closest ranks, over all values."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class Checks:
    """Numbers compared with the reference, each beside its limit."""

    def __init__(self):
        self.items: Dict[str, Dict[str, float]] = {}

    def add(self, name: str, value: float, limit: float) -> None:
        self.items[name] = {"value": value, "limit": limit}

    def ok(self, name: str) -> bool:
        it = self.items[name]
        return (not math.isnan(it["value"])) and it["value"] <= it["limit"]

    @property
    def all_ok(self) -> bool:
        return bool(self.items) and all(self.ok(n) for n in self.items)

    def lines(self) -> List[str]:
        return [f"check {n} = {it['value']!r} (limit {it['limit']!r}) "
                f"{'ok' if self.ok(n) else 'FAILED'}"
                for n, it in self.items.items()]


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, Dict], device: Dict,
                checks: Checks, breakdown: Optional[Dict] = None,
                extra: Optional[Dict] = None) -> str:
    """The JSON object of the run's last line; ``checks`` comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out.update(extra or {})
    out["checks"] = checks.items
    return json.dumps(out)
