"""General generator of placement sweeps: one architect's closed loop of
``CXLRAMSim.sweep`` calls, the next sent when the rows of the last return.

The traffic file gives the grid (STREAM kernel, footprints in multiples of
L2, placements, CPU models) and the CXL-CLI onlining mode.  A placement
``{"kind": "interleave", "seeded": [lo, hi]}`` takes its DRAM and CXL
weights from ``--seed``, each in lo..hi; the seed changes the placement and
never the number of accesses.  A grid with ``workloads`` (each a ``kind``
of :data:`WORKLOADS` with its ``params``; ``"seeded": "seed"`` draws that
parameter from ``--seed``) and ``tiering`` (``null`` for static placement,
else :class:`DynamicTiering`'s fields) runs the dynamic-tiering path.
Every sweep of a run is the same grid.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from harness.core import Checks, percentile
from harness.trace import Profile, ranged

# the MESI kernels' entry points: (range, position of the trace's first
# field); K1/K2 static, K3 the epoch kernel of dynamic tiering
KERNEL_ENTRIES = {"mesi_cache_sim": ("k1", 0), "mesi_run_segment": ("k1", 1),
                  "mesi_dyn_segment": ("k3", 1)}
# the program's workload generators by the traffic's ``kind``
WORKLOADS = {"hot_cold": "HotCold", "gups": "Gups", "kv_decode": "KVDecode"}


def resolve_grid(traffic: Dict, seed: int) -> Dict:
    """The traffic's grid with seeded placements and workload parameters
    drawn from `seed`."""
    rng = np.random.default_rng(seed)
    placements = []
    for p in traffic["placements"]:
        if "seeded" in p:
            # redrawn until it differs from every placement of the grid: a
            # repeated placement shares its row, which would cut the work
            lo, hi = p["seeded"]
            while True:
                d, c = (int(x) for x in rng.integers(lo, hi + 1, size=2))
                q = {"kind": p["kind"], "dram_weight": d, "cxl_weight": c}
                if q not in traffic["placements"] and q not in placements:
                    break
            p = q
        placements.append(p)
    grid = {"kernel": traffic.get("kernel", "triad"),
            "footprint_x_l2": list(traffic["footprint_x_l2"]),
            "placements": placements, "cpus": list(traffic["cpus"])}
    if "tiering" in traffic:
        workloads = []
        for w in traffic["workloads"]:
            w = dict(w, params=dict(w["params"]))
            if "seeded" in w:
                w["params"][w.pop("seeded")] = int(rng.integers(0, 2**31))
            workloads.append(w)
        grid.update(workloads=workloads, tiering=list(traffic["tiering"]))
    return grid


def accesses_per_sweep(grid: Dict, config: Dict) -> int:
    """Simulated accesses of one sweep: each STREAM element makes its
    reads and its write, in every placement (CPU models share them); a
    dynamic-tiering grid's are its rows' trace lengths, as the reference
    rebuilds them."""
    if "tiering" in grid:
        from reference import dyn_sweep
        return dyn_sweep.accesses_per_sweep(grid, config)
    reads = {"copy": 1, "scale": 1, "add": 2, "triad": 2}[grid["kernel"]]
    elem = config["trace"]["elem_bytes"]
    line = config["trace"]["line_bytes"]
    l2 = config["cache"]["l2_bytes"]
    n = sum(max(k * l2 // (3 * elem), line // elem)
            for k in grid["footprint_x_l2"])
    return n * (reads + 1) * len(grid["placements"])


def _program_objects(config: Dict, grid: Dict):
    from repro_torch.core import CXLRAMSim, SimConfig
    from repro_torch.core import numa
    from repro_torch.core.cache import CacheParams
    from repro_torch.core.machine import CPUModel
    from repro_torch.core.timing import CXLTiming, DramTiming, TimingConfig

    c, t, s = config["cache"], config["timing"], config["system"]
    cache = CacheParams(l1_bytes=c["l1_bytes"], l1_ways=c["l1_ways"],
                        l2_bytes=c["l2_bytes"], l2_ways=c["l2_ways"],
                        line_bytes=c["line_bytes"], cores=c["cores"])
    d, x = t["dram"], t["cxl"]
    timing = TimingConfig(
        dram=DramTiming(idle_ns=d["idle_ns"], channels=d["channels"],
                        channel_gbps=d["channel_gbps"],
                        service_ns=d["service_ns"]),
        cxl=CXLTiming(packetize_ns=x["packetize_ns"],
                      link_prop_ns=x["link_prop_ns"],
                      depacketize_ns=x["depacketize_ns"],
                      backend_ns=x["backend_ns"], lanes=x["lanes"],
                      pcie_gen=x["pcie_gen"], backend_gbps=x["backend_gbps"],
                      service_ns=x["service_ns"]))
    sim_cfg = SimConfig(dram_gib=s["dram_gib"],
                        expander_gib=tuple(s["expander_gib"]),
                        n_cores=s["n_cores"], cache=cache, timing=timing)
    policies = [numa.ZNuma(p["cxl_fraction"]) if p["kind"] == "znuma"
                else numa.WeightedInterleave(p["dram_weight"],
                                             p["cxl_weight"])
                for p in grid["placements"]]
    cpus = [CPUModel(**c) for c in grid["cpus"]]
    extra = {}
    if "tiering" in grid:
        from repro_torch import workloads as wl
        from repro_torch.core.tiering_dyn import DynamicTiering
        extra = {"workloads": tuple(getattr(wl, WORKLOADS[w["kind"]])(
                     **w["params"]) for w in grid["workloads"]),
                 "tiering": tuple(None if x is None else DynamicTiering(**x)
                                  for x in grid["tiering"])}
    return sim_cfg, policies, cpus, extra


def launch_bytes(name: str, first: int, args, kwargs) -> Dict:
    """The bytes of one MESI kernel launch from its arguments, K1/K2
    (`name` ``"k1"``) or K3 (``"k3"``), the trace's first field at
    ``args[first]``: ``field_bytes`` per simulated access (its trace
    fields), and ``fixed_bytes`` for the rest: the carry read and written;
    for K3 also the per-row scalars and page table read and the per-slot
    counters, snapshots and flags written."""
    p = kwargs["params"]
    trace = args[first:first + 4]
    b = trace[0].shape[0]
    if name == "k1":
        fixed = 2 * 4 * b * (p.cores * p.l1_sets * p.l1_ways * 3
                             + p.l2_sets * p.l2_ways * 5 + 8
                             + 2 * p.n_targets + 1)
    else:
        carry, rest = args[0], args[first + 4:]
        e, ns = trace[0].shape[1], carry[2].shape[1]
        fixed = (2 * sum(x.numel() * x.element_size() for x in carry)
                 + sum(x.numel() * x.element_size() for x in rest)
                 + 4 * b * e * (4 + ns + 1))
    return {"rows": b, "fixed_bytes": fixed,
            "field_bytes": sum(a.element_size() for a in trace)}


class Run:
    """One run of a sweep cell: set-up, window, check."""

    def __init__(self, cell, seed: int, device: torch.device):
        from repro_torch.core import CXLRAMSim
        from repro_torch.kernels import build

        self.cell, self.seed, self.device = cell, seed, device
        self.reference = cell.reference()
        self.grid = resolve_grid(cell.traffic, seed)
        self.accesses = None      # counted once the window has closed
        sim_cfg, self.policies, self.cpus, self.extra = _program_objects(
            cell.config, self.grid)
        t0 = time.perf_counter()
        if device.type == "cuda":
            build.build(tuple(cell.traffic["kernels"]))
        self.build_s = time.perf_counter() - t0
        self.sim = CXLRAMSim(sim_cfg, device=device)
        self.sim.online(cell.traffic["online"])
        self.rows: List[List[Dict]] = []
        self.sweep()                       # warm-up: the cell's own shapes
        self.rows.clear()

    def sweep(self) -> List[Dict]:
        rows = self.sim.sweep(tuple(self.grid["footprint_x_l2"]),
                              policies=self.policies, cpus=self.cpus,
                              kernel=self.grid["kernel"], **self.extra)
        self.rows.append(rows)
        return rows

    def window(self, seconds: float) -> Dict[str, float]:
        """Sweeps back to back until `seconds` have passed (one at least)."""
        lat = []
        t0 = time.perf_counter()
        while not lat or time.perf_counter() - t0 < seconds:
            s = time.perf_counter()
            self.sweep()
            lat.append(time.perf_counter() - s)
        wall = time.perf_counter() - t0
        self.accesses = accesses_per_sweep(self.grid, self.cell.config)
        self.notes = {"sweeps": len(lat), "wall_s": wall,
                      "p50_ms": percentile(lat, 50) * 1e3,
                      "max_ms": max(lat) * 1e3}
        return {"sweep_maccess_per_s": self.accesses * len(lat) / wall / 1e6,
                "sweep_p95_ms": percentile(lat, 95) * 1e3}

    def traced(self, n: int) -> Profile:
        """`n` more sweeps under the profiler, K1/K2's entries in
        ``bench.k1`` ranges and K3's in ``bench.k3``; each launch's bytes
        are recorded: its trace fields' per access, and the rest (carry
        read and written, per-row inputs, per-slot outputs) in all."""
        from repro_torch.kernels import ops

        self.kernel_calls: Dict[str, List[Dict]] = {"k1": [], "k3": []}

        def recorder(name, first):
            def record(args, kwargs):
                self.kernel_calls[name].append(
                    launch_bytes(name, first, args, kwargs))
            return record

        saved = {n_: getattr(ops, n_) for n_ in KERNEL_ENTRIES}
        for n_, fn in saved.items():
            rng, first = KERNEL_ENTRIES[n_]
            setattr(ops, n_, ranged(fn, rng, recorder(rng, first)))
        try:
            with Profile(self.device) as prof:
                with prof.window():
                    for _ in range(n):
                        self.sweep()
        finally:
            for n_, fn in saved.items():
                setattr(ops, n_, fn)
        self.traced_sweeps = n
        return prof

    def counters(self) -> Dict:
        calls = getattr(self, "kernel_calls", {})
        return {"accesses_per_sweep": self.accesses,
                "traced_sweeps": getattr(self, "traced_sweeps", 0),
                "k1_calls": calls.get("k1", []),
                "k3_calls": calls.get("k3", [])}

    def release(self) -> None:
        del self.sim

    def check(self, limits: Dict) -> Checks:
        """Every sweep's rows against the reference's, which rebuilds the
        traces from the grid: counters, labels and a tiering row's migrated
        pages and per-epoch DRAM shares exactly, the timed columns (and the
        migration bandwidth) by their largest relative difference."""
        reference = self.reference
        ref = reference.sweep_rows(self.grid, self.cell.config,
                                   device=self.device)
        names, timed = reference.STAT_NAMES, reference.TIMED_KEYS
        mismatch, err, self.failed = 0, 0.0, 0
        for rows in self.rows:
            bad, worst = abs(len(rows) - len(ref)) * len(names), 0.0
            for p, r in zip(rows, ref):
                bad += sum(p["stats"].get(k) != r["stats"][k] for k in names)
                bad += (p["cpu"], p["footprint_x_l2"]) != (
                    r["cpu"], r["footprint_x_l2"])
                bad += "workload" in r and p.get("workload") != r["workload"]
                for k in ("migrated_pages", "epoch_dram_frac"):
                    bad += (k in p or k in r) and p.get(k) != r.get(k)
                for k in timed + (("migration_gbps",)
                                  if "migration_gbps" in r else ()):
                    if k not in p:
                        bad += 1
                        continue
                    e = abs(p[k] - r[k]) / max(abs(r[k]), 1e-300)
                    worst = max(worst, e if math.isfinite(e) else math.inf)
            mismatch += bad
            err = max(err, worst)
            self.failed += (bad > limits["counter_mismatch"]
                            or worst > limits["timing_rel_err"])
        checks = Checks()
        checks.add("counter_mismatch", mismatch,
                   limits["counter_mismatch"])
        checks.add("timing_rel_err", err, limits["timing_rel_err"])
        if not self.rows:
            checks.add("sweeps_compared", 0, -1)
        return checks

    @property
    def attempted(self) -> int:
        return len(self.rows)


def control_readings(run: Run, limits: Dict) -> Dict[str, float]:
    """The control: the reference put in the program's place with its
    timing fixed point in float32, read by the program's comparison."""
    saved = run.rows
    run.rows = [run.reference.sweep_rows(run.grid, run.cell.config,
                                         np.float32, device=run.device)]
    try:
        ctrl = run.check(limits)
    finally:
        run.rows = saved
    return {n: it["value"] for n, it in ctrl.items.items()}
