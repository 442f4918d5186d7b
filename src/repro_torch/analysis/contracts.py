"""Registered entry points and the cross-layer contract checks.

This module is the audit's registry: every parity-critical entry point
gets traced on a tiny concrete example and handed to
:func:`~repro_torch.analysis.graph_audit.audit_graph`, and two structural
contracts are checked directly:

* **workload twins** (RA403) — every registered workload must expose
  both ``device_trace`` and ``host_trace``, and at one small footprint
  the two must agree bitwise (full-trace parity across footprints stays
  the tests' job; this is the cheap always-on gate);
* **stat layout** (RA404) — ``nstats``/``stat_names``/
  ``mem_write_base``/``coherence_base`` must satisfy the layout
  identities at T = 2, 3 and 4 targets, the kernel wrapper
  (:mod:`repro_torch.kernels.cache_sim`) must import the names it uses
  from :mod:`repro_torch.core.cache` (single source of truth), and the
  backends must produce bitwise-identical stats of width ``nstats`` on one
  small trace that moves every counter (triangulation): on every device
  the plain per-access scan (``simulate_trace``), the engine path
  (``run_traces(backend="reference")``) and the engine's two-segment
  carry; on a CUDA device also the MESI kernel (``run_traces`` and two
  ``run_batch_segment`` calls with ``backend="cuda"``) and the epoch
  kernel (``run_dynamic(backend="cuda")``, two-tier and three-tier)
  against the reference.  The CUDA kernels keep their own copy of the
  layout in C (``csrc/mesi_access.cuh``), which no identity check can
  see; this triangulation holds it whenever the analyzer runs on the
  card (``chip_smoke.py``'s parity batches hold it as well).

Every check takes ``device``: ``None`` means the CUDA card (and raises
without one), ``"cpu"`` runs everything on the CPU with the plain
versions.  The kernel entry points ``run_batch_segment[cuda]`` and
``run_dynamic[cuda]`` are registered only on a CUDA device; their graphs
show the wrapper's torch operations around the ctypes launch (an RNG
operation or a float on the way to the outputs there is caught), not the
kernel, which RA404 holds instead.

Entry points are registered in :func:`entry_points`; adding a new
parity-critical device program to the engine means adding one line here.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.findings import ERROR, Finding
from repro_torch.analysis.graph_audit import audit_graph, trace_entry

# Footprint used for the tiny workload twin check: two L2s of the tiny
# geometry below — enough for every registered generator to produce a
# non-degenerate trace, small enough to stay sub-second on CPU.
TWIN_FOOTPRINT_BYTES = 1 << 15

#: target counts the layout identities and the triangulation run at
LAYOUT_TARGETS = (2, 3, 4)
#: the layout functions of core.cache a kernel wrapper may import
LAYOUT_NAMES = ("nstats", "mem_write_base", "coherence_base")

Entry = Tuple[str, Callable, bool]


def _device(device) -> torch.device:
    from repro_torch.core.device import resolve_device

    return resolve_device(device)


def _tiny_params(n_targets: int = 2):
    from repro_torch.core.cache import CacheParams

    return CacheParams(l1_bytes=2048, l1_ways=2, l2_bytes=8192, l2_ways=4,
                       cores=2, n_targets=n_targets)


def _tiny_trace(device, n: int = 16, n_targets: int = 2):
    i = torch.arange(n, dtype=torch.int32, device=device)
    addr = i % 12
    is_write = (i % 3 == 0).to(torch.int32)
    core = i % 2
    tier = addr % n_targets
    return addr, is_write, core, tier


def _triangulation_trace(device, n_targets: int = 2, dyn: bool = False):
    """RA404's triangulation trace: 120 accesses over the tiny geometry
    that move every counter at each T.  Eight lines are read by core 0
    and core 1, written and read twice by core 1, then read by core 0
    again (upgrades, invalidations, L1 and L2 hits); four lines are
    written by core 1 after core 0 read them (invalidations without an
    upgrade); 64 accesses then sweep 32 lines, 8 in each of four L2 sets
    (twice the ways), a third of them writes, from each core in turn
    (dirty evictions to every target, back-invalidations, L1
    write-backs).  ``dyn`` gives each line a CXL decode target (1..T-1),
    as a dynamic row's ``tier`` carries, in place of its final target."""
    share = [(x, w, c) for x in range(8)
             for c, w in ((0, 0), (1, 0), (1, 1), (1, 0), (1, 0), (0, 0))]
    rfo = [(x, w, c) for x in range(8, 12) for c, w in ((0, 0), (1, 1))]
    sweep = [(64 + 32 * (j // 4) + j % 4, int(i % 3 == 0), (i // 3) % 2)
             for i, j in ((i, (7 * i) % 32) for i in range(64))]
    addr, is_write, core = torch.tensor(
        share + rfo + sweep, dtype=torch.int32, device=device).T.contiguous()
    tier = 1 + addr % (n_targets - 1) if dyn else addr % n_targets
    return addr, is_write, core, tier


def _triangulation_dyn_scalars(n_targets: int, ssd: bool):
    """The dynamic row the triangulation runs: four pages (the shared
    lines' page in DRAM, the swept lines' three on CXL), room for two in
    DRAM, so pages are promoted and demoted (and, three-tier, sent to the
    SSD) while the trace runs."""
    sc = (_tiny_dyn_ssd_scalars if ssd else _tiny_dyn_scalars)(n_targets)
    sc.update(
        page_map0=np.asarray([[0, 1, 1, 1]], np.int32),
        n_pages=np.asarray([4], np.int32),
        dram_cap=np.asarray([2], np.int32),
        page_target_lines=np.ones((1, 4, n_targets), np.int32),
    )
    return sc


def _batched(device, n: int = 16, n_targets: int = 2):
    return tuple(x[None] for x in _tiny_trace(device, n, n_targets))


def _tiny_dyn_scalars(n_targets: int = 2):
    """One dynamic-tiering row's host-side scalars (shared by the
    dynamic entry points and the RA404 dyn triangulation), with
    ``page_target_lines`` in the documented (B, P, T) shape."""
    return dict(
        dyn_flag=np.asarray([1], np.int32),
        page_map0=np.zeros((1, 2), np.int32),
        n_pages=np.asarray([2], np.int32),
        budget=np.asarray([1], np.int32),
        threshold=np.asarray([1], np.int32),
        period=np.asarray([1], np.int32),
        dram_cap=np.asarray([2], np.int32),
        page_target_lines=np.ones((1, 2, n_targets), np.int32),
    )


def _tiny_dyn_sampling_scalars(n_targets: int = 2):
    """One sampled row: warm 1 / measure 1 / period 2 in slots.  The
    stat-masking select rides the same slot step as the exact row; the
    audit traces it with non-zero sampling scalars so a float or
    forbidden operation in the masking arithmetic is caught even if the
    exact path stays clean."""
    sc = _tiny_dyn_scalars(n_targets)
    sc.update(
        s_warm=np.asarray([1], np.int32),
        s_meas=np.asarray([1], np.int32),
        s_per=np.asarray([2], np.int32),
    )
    return sc


def _tiny_dyn_ssd_scalars(n_targets: int = 2):
    """Three-tier variant of the tiny dynamic row: a non-zero ``ssd_tid``
    plus a finite ``cxl_cap`` turn on the Stage-B promote/demote path —
    the device program behind the CXL-SSD tier and the distribution
    timing rows (percentiles are host-side NumPy over these integer
    stats, so this graph IS the distribution entry point)."""
    sc = _tiny_dyn_scalars(n_targets)
    sc.update(
        ssd_tid=np.asarray([1], np.int32),
        cxl_cap=np.asarray([1], np.int32),
    )
    return sc


def _trace_simulate_trace(device):
    from repro_torch.core import cache

    p = _tiny_params()
    return trace_entry(
        lambda a, w, c, t: cache.simulate_trace(
            p, cache.init_state(p, device), a, w, c, t),
        *_tiny_trace(device),
    )


def _trace_run_traces_reference(device):
    from repro_torch.core import engine

    p = _tiny_params()
    return trace_entry(
        lambda a, w, c, t: engine.run_traces(p, a, w, c, t,
                                             backend="reference"),
        *_batched(device),
    )


def _trace_run_dynamic(device, scalars, backend="reference"):
    from repro_torch.core import tiering_dyn

    p = _tiny_params()

    def entry(a, w, c, t):
        return tiering_dyn.run_dynamic(p, a, w, c, t, slot_len=4, k_max=1,
                                       backend=backend, **scalars)

    # a kernel launch reads data_ptr(): no functionalization around it
    return trace_entry(entry, *_batched(device, n=8),
                       functional=backend == "reference")


def _trace_run_segment_cuda(device):
    from repro_torch.core import engine

    p = _tiny_params()
    carry = engine.init_batch_carry(p, 1, device)

    def entry(carry, a, w, c, t):
        return engine.run_batch_segment(p, carry, a, w, c, t,
                                        backend="cuda", chunk=8)

    return trace_entry(entry, carry, *_batched(device), functional=False)


def _fresh_kv_scenario() -> None:
    """Empty KVDecode's cache of serving runs, so its device trace always
    records the serving stack, whatever traced or ran before it."""
    from repro_torch.workloads import kv_decode

    kv_decode._kv_scenario.cache_clear()


def _trace_workload(wl, device):
    # WorkloadTrace is a plain dataclass: trace the tensor fields as a
    # tuple.
    def entry():
        wt = wl.device_trace(TWIN_FOOTPRINT_BYTES, device=device)
        out = (wt.addr, wt.is_write)
        return out if wt.tier is None else out + (wt.tier,)

    _fresh_kv_scenario()
    try:
        return trace_entry(entry)
    finally:
        _fresh_kv_scenario()


def _workload_entries(device) -> List[Entry]:
    from repro_torch import workloads

    return [(f"{name}.device_trace",
             functools.partial(_trace_workload, workloads.get(name), device),
             False)
            for name in sorted(workloads.REGISTRY)]


def entry_points(device=None) -> List[Entry]:
    """``(name, thunk -> GraphModule, allow_floats)`` per entry point on
    `device` (``None``: the CUDA card); the kernel entry points only on a
    CUDA device."""
    device = _device(device)
    part = functools.partial
    static: List[Entry] = [
        ("simulate_trace", part(_trace_simulate_trace, device), False),
        ("run_traces[reference]",
         part(_trace_run_traces_reference, device), False),
        ("run_dynamic",
         part(_trace_run_dynamic, device, _tiny_dyn_scalars()), False),
        ("run_dynamic[sampling]",
         part(_trace_run_dynamic, device, _tiny_dyn_sampling_scalars()),
         False),
    ]
    if device.type == "cuda":
        static += [
            ("run_batch_segment[cuda]",
             part(_trace_run_segment_cuda, device), False),
            ("run_dynamic[cuda]",
             part(_trace_run_dynamic, device, _tiny_dyn_scalars(), "cuda"),
             False),
        ]
    static.append(("run_dynamic[ssd]",
                   part(_trace_run_dynamic, device, _tiny_dyn_ssd_scalars()),
                   False))
    return static + _workload_entries(device)


def trace_entry_points(device=None) -> Dict[str, object]:
    """Every registered entry point's graph on `device`, by name (a trace
    that fails maps to its exception)."""
    graphs: Dict[str, object] = {}
    for name, thunk, _ in entry_points(device):
        try:
            graphs[name] = thunk()
        except Exception as exc:  # reported as RA402 by run_audit
            graphs[name] = exc
    return graphs


def _audit_finding(code: str, name: str, where: str, msg: str) -> Finding:
    return Finding(
        code=code,
        name=name,
        severity=ERROR,
        path=f"<graph:{where}>",
        line=0,
        col=0,
        message=msg,
        symbol=where,
    )


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def check_workload_twins(device=None) -> List[Finding]:
    """RA403: every registered workload has an agreeing host twin."""
    from repro_torch import workloads

    device = _device(device)
    findings: List[Finding] = []
    for name in sorted(workloads.REGISTRY):
        wl = workloads.get(name)
        for attr in ("device_trace", "host_trace"):
            if not callable(getattr(wl, attr, None)):
                findings.append(
                    _audit_finding(
                        "RA403",
                        "missing-host-twin",
                        name,
                        f"workload `{name}` lacks a callable {attr}; "
                        f"the device/host twin contract requires both",
                    )
                )
        if findings and findings[-1].symbol == name:
            continue
        dt = wl.device_trace(TWIN_FOOTPRINT_BYTES, device=device)
        ht = wl.host_trace(TWIN_FOOTPRINT_BYTES)
        d_addr = _host(dt.addr)
        h_addr = _host(ht.addr)
        if dt.n_pages != ht.n_pages:
            findings.append(
                _audit_finding(
                    "RA403",
                    "missing-host-twin",
                    name,
                    f"workload `{name}` twin mismatch: device n_pages "
                    f"{dt.n_pages} != host n_pages {ht.n_pages}",
                )
            )
        elif d_addr.shape != h_addr.shape or not (
            np.array_equal(d_addr, h_addr)
            and np.array_equal(_host(dt.is_write), _host(ht.is_write))
        ):
            findings.append(
                _audit_finding(
                    "RA403",
                    "missing-host-twin",
                    name,
                    f"workload `{name}` device_trace != host_trace at "
                    f"footprint {TWIN_FOOTPRINT_BYTES}: the twins must "
                    f"be bitwise-equal",
                )
            )
    return findings


def _same(a, b) -> bool:
    a, b = _host(a), _host(b)
    return a.shape == b.shape and np.array_equal(a, b)


def _two_segments(p, device, trace, backend: str):
    from repro_torch.core import engine

    n = int(trace[0].shape[-1])
    carry = engine.init_batch_carry(p, 1, device)
    for lo, hi in ((0, n // 2), (n // 2, n)):
        carry = engine.run_batch_segment(
            p, carry, *(x[:, lo:hi] for x in trace), backend=backend,
            chunk=8)
    return carry[2][0]


def _layout_identities(fail) -> None:
    from repro_torch.core import cache, sampling

    for t in LAYOUT_TARGETS:
        names = cache.stat_names(t)
        if len(names) != cache.nstats(t):
            fail(f"len(stat_names({t})) == {len(names)} != nstats({t}) == {cache.nstats(t)}")
        if len(set(names)) != len(names):
            fail(f"stat_names({t}) has duplicate counter names")
        if cache.coherence_base(t) - cache.mem_write_base(t) != t:
            fail(
                f"mem-write block width at T={t} is "
                f"{cache.coherence_base(t) - cache.mem_write_base(t)}, "
                f"expected {t}"
            )
        if cache.nstats(t) - cache.coherence_base(t) != 4:
            fail(
                f"coherence block at T={t} has "
                f"{cache.nstats(t) - cache.coherence_base(t)} counters, "
                f"expected 4"
            )
        # The sampling ci-column family must derive offsets from the one
        # stats layout: column i of ci_column_names(t) is stat_names(t)[i]
        # with the `_ci95` suffix, width exactly nstats(t).
        ci_names = sampling.ci_column_names(t)
        if len(ci_names) != cache.nstats(t):
            fail(
                f"len(ci_column_names({t})) == {len(ci_names)} != "
                f"nstats({t}) == {cache.nstats(t)}"
            )
        if ci_names != tuple(f"{n}_ci95" for n in names):
            fail(
                f"ci_column_names({t}) does not derive from "
                f"stat_names({t}): the ci family has drifted from the "
                f"stats layout"
            )


def _kernel_imports(fail) -> None:
    # The kernel wrapper must read its layout from core.cache, not a copy.
    from repro_torch.core import cache
    from repro_torch.kernels import cache_sim

    if not hasattr(cache_sim, "nstats"):
        fail("kernels.cache_sim does not import nstats from "
             "repro_torch.core.cache: the wrapper sizes the stats itself")
    for fname in LAYOUT_NAMES:
        if hasattr(cache_sim, fname) and getattr(cache_sim, fname) \
                is not getattr(cache, fname):
            fail(
                f"kernels.cache_sim.{fname} is not repro_torch.core.cache."
                f"{fname}: the stats layout has a second source of truth"
            )


def _still(fail, names, stats, label: str, t: int) -> None:
    """Fail for each counter `stats` leaves at 0: a counter no backend
    moves cannot show where the layout puts it."""
    zero = [n for n, v in zip(names, _host(stats).reshape(-1).tolist())
            if v == 0]
    if zero:
        fail(f"the {label} triangulation trace leaves {zero} at 0 at "
             f"T={t}: a wrong offset for them would pass")


def _triangulate(fail, device, t: int):
    """The backends on the T-target triangulation trace; returns the
    reference stats."""
    from repro_torch.core import cache, engine, tiering_dyn

    p = _tiny_params(t)
    addr, is_write, core, tier = _triangulation_trace(device, t)
    trace = tuple(x[None] for x in (addr, is_write, core, tier))
    width = cache.nstats(t)
    _, ref = cache.simulate_trace(p, cache.init_state(p, device), addr,
                                  is_write, core, tier)
    _still(fail, cache.stat_names(t), ref, "static", t)
    runs = [("simulate_trace", ref),
            ("run_traces[reference]",
             engine.run_traces(p, *trace, backend="reference")[0][0]),
            ("run_batch_segment[reference] x2",
             _two_segments(p, device, trace, "reference"))]
    if device.type == "cuda":
        runs += [("run_traces[cuda]",
                  engine.run_traces(p, *trace, backend="cuda")[0][0]),
                 ("run_batch_segment[cuda] x2",
                  _two_segments(p, device, trace, "cuda"))]
    for label, stats in runs:
        got = int(stats.shape[-1])
        if got != width:
            fail(
                f"{label} returned a {got}-wide stats vector at T={t}, "
                f"expected nstats({t}) == {width}"
            )
        elif not _same(stats, ref):
            fail(
                f"stats triangulation failed at T={t}: {label} disagrees "
                f"with the reference scan on the triangulation trace — the "
                f"backends no longer share one stats layout"
            )
    if device.type != "cuda":
        return ref
    # The epoch kernel: one dynamic-tiering row, reference vs CUDA, every
    # DynOutputs field bitwise, two-tier and three-tier (CXL-SSD).
    dyn = tuple(x[None] for x in _triangulation_trace(device, t, dyn=True))
    for label, ssd in (("dynamic", False), ("three-tier dynamic", True)):
        scalars = _triangulation_dyn_scalars(t, ssd)
        d_ref = tiering_dyn.run_dynamic(p, *dyn, slot_len=4, k_max=1,
                                        backend="reference", **scalars)
        _still(fail, cache.stat_names(t), d_ref.stats, label, t)
        d_cuda = tiering_dyn.run_dynamic(p, *dyn, slot_len=4, k_max=1,
                                         backend="cuda", **scalars)
        for f in d_ref._fields:
            if not _same(getattr(d_ref, f), getattr(d_cuda, f)):
                fail(
                    f"{label} triangulation failed on `{f}` at T={t}: the "
                    f"CUDA epoch kernel disagrees with the reference "
                    f"dynamic scan on the triangulation trace"
                )
    return ref


def check_stat_layout(device=None) -> List[Finding]:
    """RA404: layout identities + stats triangulation across backends."""
    device = _device(device)
    findings: List[Finding] = []

    def fail(msg: str) -> None:
        findings.append(_audit_finding("RA404", "stat-layout-mismatch", "stat_layout", msg))

    _layout_identities(fail)
    _kernel_imports(fail)
    refs = [_triangulate(fail, device, t) for t in LAYOUT_TARGETS]
    # Distribution timing is host-side NumPy over these integer stats;
    # its seeding contract rides RA404: counter-seeded strata must be
    # deterministic across instances, sorted (so p50 <= p95 <= p99 by
    # construction), and zero queueing excess must collapse every
    # percentile to the deterministic fixed point — the legacy number.
    from repro_torch.core.timing import LatencyDistribution

    dist = LatencyDistribution(n_samples=64, seed=5)
    for tid in range(3):
        x1 = dist.exp_strata(tid)
        x2 = LatencyDistribution(n_samples=64, seed=5).exp_strata(tid)
        if not np.array_equal(x1, x2):
            fail(
                f"distribution strata for target {tid} are not "
                f"deterministic across LatencyDistribution instances"
            )
        if not np.all(np.diff(x1) >= 0):
            fail(
                f"distribution strata for target {tid} are not sorted: "
                f"percentile monotonicity no longer holds by construction"
            )
    flat = dist.latency_percentiles(100.0, 100.0, 0)
    if not np.all(np.asarray(flat) == 100.0):
        fail(
            "zero queueing excess does not collapse the latency "
            "distribution to the deterministic fixed point"
        )
    for ref in refs:
        if ref.dtype.is_floating_point or ref.dtype.is_complex:
            fail(f"simulate_trace stats dtype {ref.dtype} is not integer")
    return findings


def audit_entry_points(
    device=None, graphs: Optional[Dict[str, object]] = None
) -> List[Finding]:
    """Audit every registered entry point's graph (traced here unless
    `graphs`, from :func:`trace_entry_points`, holds it)."""
    findings: List[Finding] = []
    for name, thunk, allow_floats in entry_points(device):
        graph = graphs[name] if graphs and name in graphs else None
        if graph is None:
            try:
                graph = thunk()
            except Exception as exc:  # a trace regression: RA402 below
                graph = exc
        if isinstance(graph, Exception):
            findings.append(
                _audit_finding(
                    "RA402",
                    "forbidden-primitive",
                    name,
                    f"entry point {name} failed to trace: "
                    f"{type(graph).__name__}: {graph}",
                )
            )
            continue
        findings.extend(audit_graph(name, graph, allow_floats=allow_floats))
    return findings


def run_audit(
    device=None, graphs: Optional[Dict[str, object]] = None
) -> List[Finding]:
    """Run the full graph audit on `device` (``None``: the CUDA card):
    entry points + both contract checks."""
    device = _device(device)
    findings = audit_entry_points(device, graphs)
    findings.extend(check_workload_twins(device))
    findings.extend(check_stat_layout(device))
    return findings
