"""Full-system machine model: CPU issue models -> caches -> tiered memory.

gem5 gives the paper two CPU models ("Timing"/in-order and O3).  This model
replaces the cycle-accurate pipelines with two analytic issue models layered
on the *exact* cache/tier state from :mod:`repro_torch.core.cache`:

  * ``inorder`` — one outstanding miss (MLP=1): every L2 miss stalls for the
    full loaded memory latency.
  * ``o3``      — memory-level parallelism up to `mlp` outstanding misses
    (MSHR-bound), so miss stalls overlap; bandwidth-bound when the overlapped
    demand exceeds the tier's payload bandwidth.

Timing closes a fixed point: loaded latency depends on achieved bandwidth,
which depends on runtime, which depends on loaded latency.  A few Picard
iterations converge (monotone curve).  The fixed point is host NumPy
float64, the same arithmetic as the JAX package's, so rows match it to the
last ulp.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import cache as cache_sim
from repro_torch.core import numa as numa_mod
from repro_torch.core.spec import CACHELINE_BYTES
from repro_torch.core.switch import shared_usp_latency_ns
from repro_torch.core.timing import LatencyDistribution, TimingConfig
from repro_torch.runtime.trace import span


@dataclasses.dataclass(frozen=True)
class CPUModel:
    """Analytic CPU issue model (the gem5 'Timing'/O3 stand-ins).

    Attributes
    ----------
    kind : str
        ``'inorder'`` (one outstanding miss) or ``'o3'`` (MSHR-bound
        overlap).
    freq_ghz : float
        Core clock.
    ipc_core : float
        Non-memory instructions per cycle.
    l1_hit_ns, l2_hit_ns : float
        Hit service times (L1 folded into issue; L2 divided by MLP).
    mlp : int
        Maximum outstanding L2 misses (MSHRs) for the O3 model.
    """
    kind: str = "o3"             # 'inorder' | 'o3'
    freq_ghz: float = 3.0
    ipc_core: float = 2.0        # non-memory IPC
    l1_hit_ns: float = 1.3       # 4 cycles @3GHz
    l2_hit_ns: float = 12.0
    mlp: int = 8                 # max outstanding L2 misses (MSHRs)

    @property
    def effective_mlp(self) -> int:
        """Outstanding-miss budget the timing layer actually uses."""
        return 1 if self.kind == "inorder" else self.mlp


@dataclasses.dataclass
class RunResult:
    """One timed configuration: counters + the closed timing fixed point.

    Attributes
    ----------
    stats : dict
        Raw cache/tier counters, keys as `cache.stat_names(T)`.
    miss_rates : dict
        ``l1_miss_rate`` / ``l2_miss_rate`` (LLC, the paper's Fig. 5
        metric) / ``llc_mpki``.
    time_ns : float
        Converged runtime (0.0 when the trace had no memory accesses).
    achieved_gbps : dict
        Per-target achieved bandwidth (``dram``, ``cxl0``...), plus the
        ``cxl`` aggregate and ``total``.
    loaded_latency_ns : dict
        Per-target loaded latency at the converged operating point; a
        target with no traffic keeps its *idle* latency.
    cpu : str
        The CPU model kind that timed this row.
    migrated_pages : int
        Pages moved by the dynamic tierer (promotions + demotions); 0
        for static rows.
    migration_gbps : float
        Achieved bandwidth the migration traffic itself consumed at the
        converged operating point (it contends inside the fixed point —
        see `time_batch(mig_lines=...)`).
    epoch_dram_frac : list of float, optional
        Per-epoch DRAM hit-tier fractions (fraction of the epoch's
        accesses whose backing tier was local DRAM).  ``None`` on rows
        not timed under dynamic tiering — `row()` then omits the
        migration columns entirely, keeping legacy rows bit-identical.
    stats_ci95 : dict, optional
        Per-counter confidence-interval half-widths of a SMARTS-sampled
        row, keyed like ``stats``.  ``None``
        on exact rows — `row()` then omits every sampling column,
        keeping the legacy schema bit-identical.
    sampled_frac : float, optional
        Fraction of the trace's accesses that fell in detailed
        measurement windows (sampled rows only).
    sample_windows : int, optional
        Number of (non-empty) measurement windows the estimate used.
    l2_miss_rate_ci95 : float, optional
        CI half-width of the L2 miss rate (sampled rows only).
    lat_percentiles : dict, optional
        Per-target latency percentiles (``{label: {"p50": ..., "p95":
        ..., "p99": ...}}``) sampled from the queueing-derived latency
        distribution (:class:`repro_torch.core.timing.LatencyDistribution`).
        ``None`` on deterministic rows — `row()` then omits every
        ``lat_*_p*_ns`` column, keeping the legacy schema bit-identical.
    """
    stats: Dict[str, int]
    miss_rates: Dict[str, float]
    time_ns: float
    achieved_gbps: Dict[str, float]      # per target + 'cxl' aggregate+total
    loaded_latency_ns: Dict[str, float]
    cpu: str
    migrated_pages: int = 0
    migration_gbps: float = 0.0
    epoch_dram_frac: Optional[List[float]] = None
    stats_ci95: Optional[Dict[str, float]] = None
    sampled_frac: Optional[float] = None
    sample_windows: Optional[int] = None
    l2_miss_rate_ci95: Optional[float] = None
    lat_percentiles: Optional[Dict[str, Dict[str, float]]] = None

    def per_target_keys(self) -> List[str]:
        """Ordered per-target labels ('cxl0', ..., 'ssd0', ...) if routed."""
        per = [k for k in self.achieved_gbps
               if (k.startswith("cxl") and k != "cxl")
               or (k.startswith("ssd") and k != "ssd")]
        return sorted(per, key=lambda s: (len(s), s))

    def row(self) -> Dict[str, float]:
        """Flatten into the sweep row schema (`bw_*`, `lat_*`, per-target
        columns appended for multi-expander routes)."""
        out = {
            "time_ns": self.time_ns,
            "bw_total_gbps": self.achieved_gbps["total"],
            "bw_dram_gbps": self.achieved_gbps["dram"],
            "bw_cxl_gbps": self.achieved_gbps["cxl"],
            "l2_miss_rate": self.miss_rates["l2_miss_rate"],
            "lat_dram_ns": self.loaded_latency_ns["dram"],
            "lat_cxl_ns": self.loaded_latency_ns["cxl"],
        }
        # ssd aggregate (only when the route has a flash-backed tier)
        if "ssd" in self.achieved_gbps:
            out["bw_ssd_gbps"] = self.achieved_gbps["ssd"]
            out["lat_ssd_ns"] = self.loaded_latency_ns["ssd"]
        # per-target columns (multi-expander routes: cxl0, cxl1, ...)
        for k in self.per_target_keys():
            out[f"bw_{k}_gbps"] = self.achieved_gbps[k]
            out[f"lat_{k}_ns"] = self.loaded_latency_ns[k]
        # dynamic-tiering columns (only on rows the tierer timed)
        if self.epoch_dram_frac is not None:
            out["migrated_pages"] = self.migrated_pages
            out["migration_gbps"] = self.migration_gbps
            out["epoch_dram_frac"] = list(self.epoch_dram_frac)
        # sampling columns (only on SMARTS-sampled rows; legacy rows
        # keep the exact schema of today — test-enforced)
        if self.stats_ci95 is not None:
            for k, v in self.stats_ci95.items():
                out[f"{k}_ci95"] = v
            out["sampled_frac"] = self.sampled_frac
            out["sample_windows"] = self.sample_windows
            out["l2_miss_rate_ci95"] = self.l2_miss_rate_ci95
        # latency-distribution columns (only on distribution-enabled
        # rows; deterministic rows keep the exact schema of today)
        if self.lat_percentiles is not None:
            for k, qs in self.lat_percentiles.items():
                for pname, v in qs.items():
                    out[f"lat_{k}_{pname}_ns"] = v
        return out


class Machine:
    """Cache hierarchy + tiered memory + CPU issue model."""

    def __init__(self, cache_params: cache_sim.CacheParams,
                 timing: TimingConfig, cpu: CPUModel):
        self.cache_params = cache_params
        self.timing = timing
        self.cpu = cpu

    # -- cache simulation (exact) -----------------------------------------
    def simulate(self, addr: torch.Tensor, is_write: torch.Tensor,
                 tier: torch.Tensor, core: Optional[torch.Tensor] = None
                 ) -> "Tuple[Dict[str, int], Dict[str, float]]":
        """Run one trace through the sequential cache model.

        Parameters
        ----------
        addr, is_write, tier : (N,) tensors
            Line-granular trace; `tier` carries target ids.
        core : (N,) tensor, optional
            Issuing core per access (default 0).

        Returns
        -------
        (stats, miss_rates) : tuple of dict
            Counter dict (`cache.stat_names`) and derived miss rates.
        """
        state = cache_sim.init_state(self.cache_params, addr.device)
        _, stats = cache_sim.simulate_trace(
            self.cache_params, state, addr, is_write, core=core, tier=tier)
        return cache_sim.stats_dict(stats), cache_sim.miss_rates(stats)

    # -- timing fixed point -------------------------------------------------
    def _time(self, stats: Dict[str, int], route=None) -> RunResult:
        t = 2 if route is None else route.n_targets
        vec = np.asarray([[stats[n] for n in cache_sim.stat_names(t)]],
                         np.int64)
        return time_batch(self.timing, [self.cpu], vec, route=route)[0]

    def run_trace(self, addr: torch.Tensor, is_write: torch.Tensor,
                  policy: numa_mod.Policy, n_pages: int,
                  core: Optional[torch.Tensor] = None,
                  backend: Optional[str] = None, route=None) -> RunResult:
        """One trace through the batched engine (B=1) + timing fixed point.

        Parameters
        ----------
        addr, is_write : (N,) tensors
            Line-granular trace, on the device the simulation runs on.
        policy : numa.Policy
            Page-placement policy deciding each page's DRAM/CXL intent.
        n_pages : int
            The policy's domain (pages the footprint spans).
        core : (N,) tensor, optional
            Issuing core per access.
        backend : str, optional
            ``None`` (follow the device), ``'reference'`` or ``'cuda'``.
        route : repro_torch.core.route.RouteMap, optional
            Switches from the binary DRAM/CXL tier map to N-target
            routing through the route map's committed HDM programs.

        Returns
        -------
        RunResult
            Stats + the closed timing fixed point for this machine's CPU.
        """
        from repro_torch.core import engine  # deferred: engine builds on machine
        addr = addr.to(torch.int32)
        if route is None:
            tier = numa_mod.tier_of_lines(policy, addr, n_pages)
            p = self.cache_params
        else:
            tier = route.target_of_lines(policy, addr, n_pages)
            p = dataclasses.replace(self.cache_params,
                                    n_targets=route.n_targets)
        stats, _ = engine.run_traces(
            p, addr[None], is_write[None],
            core=None if core is None else core[None],
            tier=tier[None], backend=backend)
        return self._time(cache_sim.stats_dict(stats[0].cpu()), route=route)


def per_target_bw_columns(row: Dict) -> List[str]:
    """Ordered per-target bandwidth columns (`bw_cxl{k}_gbps`) of a sweep
    row dict — the reporting-side companion of `RunResult.per_target_keys`.
    """
    per = [k for k in row if k.startswith("bw_cxl") and k != "bw_cxl_gbps"]
    return sorted(per, key=lambda s: (len(s), s))


# ---------------------------------------------------------------------------
# Vectorized timing fixed point (used by the batched trace engine)
# ---------------------------------------------------------------------------
def time_batch(timing: TimingConfig, cpus: Sequence[CPUModel],
               stats: np.ndarray,
               route=None,
               mig_lines: Optional[np.ndarray] = None,
               dist: Optional[LatencyDistribution] = None
               ) -> List[RunResult]:
    """Close the Picard timing fixed point for a whole batch at once.

    The loaded-latency curve is monotone, so a handful of Picard iterations
    converge; here every iteration updates all `B` configurations with
    vectorized numpy instead of a Python loop per configuration.  Elements
    freeze (both `t` and the per-target latencies) the iteration they
    converge, so each element's trajectory is independent of what else
    shares the batch.

    Targets: without `route`, the classic two-target machine — target 0 is
    local DRAM (`timing.dram`), target 1 the CXL pool (`timing.cxl`).  With
    a route map, one target per routed endpoint
    with its *effective* (possibly switch-derived) timing; targets sharing
    an upstream switch port (`Target.group`) are coupled: their loaded
    latency is the shared-USP queue evaluated at the *aggregate* group
    utilization, and the group's bandwidth floor is the stricter of
    aggregate bytes over the USP payload and the busiest member's
    own-device ceiling — head-of-line coupling that makes switched pools
    slower than per-device curves suggest.

    Guards:
      * zero memory accesses => `time_ns == 0.0` and idle latencies,
        rather than the issue-time floor leaking into the result;
      * a target with zero lines keeps its *idle* latency untouched in
        `RunResult.loaded_latency_ns` — the queueing curve is never
        evaluated for traffic that does not exist.

    Parameters
    ----------
    timing : TimingConfig
        The per-tier timing model (DRAM path; CXL path when no route).
    cpus : sequence of CPUModel
        One per batch row (sweeps pass workload-adjusted models, e.g.
        MLP collapsed to 1 for dependent-load traces).
    stats : (B, nstats(T)) int array
        Counter matrix, rows ordered as `cache.stat_names(T)` with T the
        number of targets.
    route : optional
        A route map (``targets`` with ``kind``, ``timing``, ``group``,
        ``group_payload_gbps`` and ``device_payload_gbps``) supplying
        per-target timings + shared-USP groups.  The port builds none yet
        (ROADMAP queue 1, item 4); the arithmetic is kept whole so it
        stays the reference's.
    mig_lines : (B, 2, T) int array, optional
        Dynamic-tiering migration traffic (``[:, 0]`` lines read,
        ``[:, 1]`` lines written, per target) from
        the dynamic tierer.  The lines are added
        to each target's demand inside the Picard iteration, so
        migration contends for the same loaded-latency curves, USP
        groups and bandwidth floors as the workload's own misses —
        first-class bandwidth contention, reported per row as
        ``RunResult.migration_gbps``.
    dist : LatencyDistribution, optional
        Widen each target's converged latency point into a
        queueing-derived distribution and attach per-target
        ``lat_percentiles`` to every row (counter-seeded SplitMix64
        jitter: pure host-side numpy over the converged fixed point, so
        distribution rows inherit the integer stats' bitwise
        backend/segment invariance).  ``None`` (default) keeps the
        legacy deterministic result, bitwise.

    Backpressure: a target timing with ``mshr`` set caps its
    sustainable bandwidth at ``mshr * CACHELINE_BYTES / latency``
    (Little's law on the outstanding-request window) *inside* the
    Picard iteration — latency growth under load feeds back into the
    bandwidth floor.  ``mshr=None`` (default) is the legacy unlimited
    window.

    Returns
    -------
    list of RunResult
        One per row.
    """
    with span("machine.time_batch"):
        stats = np.asarray(stats, np.int64)
        if route is None:
            kinds = ["dram", "cxl"]
            timings = [timing.dram, timing.cxl]
            groups = [-1, -1]
            group_payload = [0.0, 0.0]
            device_payload = [0.0, 0.0]
        else:
            kinds = [tg.kind for tg in route.targets]
            timings = [tg.timing for tg in route.targets]
            groups = [tg.group for tg in route.targets]
            group_payload = [tg.group_payload_gbps for tg in route.targets]
            device_payload = [tg.device_payload_gbps for tg in route.targets]
        n_t = len(timings)
        if stats.ndim != 2 or stats.shape[1] != cache_sim.nstats(n_t):
            raise ValueError(f"stats must be (B, {cache_sim.nstats(n_t)}) "
                             f"for {n_t} targets, got {stats.shape}")
        b = stats.shape[0]
        if len(cpus) != b:
            raise ValueError("need one CPUModel per stats row")

        ipc = np.asarray([c.ipc_core for c in cpus])
        freq = np.asarray([c.freq_ghz for c in cpus])
        l2_hit_ns = np.asarray([c.l2_hit_ns for c in cpus])
        mlp = np.asarray([float(c.effective_mlp) for c in cpus])

        n_acc = stats[:, cache_sim.L1_HIT] + stats[:, cache_sim.L1_MISS]
        wbase = cache_sim.mem_write_base(n_t)
        reads = [stats[:, cache_sim.MEM_READ + k].astype(np.float64)
                 for k in range(n_t)]
        writes = [stats[:, wbase + k].astype(np.float64) for k in range(n_t)]
        if mig_lines is not None:
            mig = np.asarray(mig_lines, np.int64)
            if mig.shape != (b, 2, n_t):
                raise ValueError(f"mig_lines must be ({b}, 2, {n_t}), "
                                 f"got {mig.shape}")
            # migration demand rides the same per-target queues/floors as
            # the workload's own miss traffic
            reads = [reads[k] + mig[:, 0, k] for k in range(n_t)]
            writes = [writes[k] + mig[:, 1, k] for k in range(n_t)]
            mig_bytes = mig.sum(axis=(1, 2)).astype(np.float64) \
                * CACHELINE_BYTES
        else:
            mig_bytes = np.zeros(b)
        lines = [reads[k] + writes[k] for k in range(n_t)]
        bytes_ = [v * CACHELINE_BYTES for v in lines]
        gids = sorted({g for g in groups if g >= 0})
        gpay = {g: next(group_payload[k] for k in range(n_t) if groups[k] == g)
                for g in gids}
        gbytes = {g: sum(bytes_[k] for k in range(n_t) if groups[k] == g)
                  for g in gids}

        base_ns = (n_acc / (ipc * freq)                       # issue
                   + stats[:, cache_sim.L2_HIT] * l2_hit_ns / mlp)
        t = np.maximum(base_ns, 1.0)
        lat = [np.full(b, timings[k].idle_ns) for k in range(n_t)]
        done = np.zeros(b, bool)
        for _ in range(8):  # Picard iteration on the loaded-latency curve
            stall = np.zeros(b)
            offered = [bytes_[k] / np.maximum(t, 1.0)         # B/ns == GB/s
                       for k in range(n_t)]
            goff = {g: sum(offered[k] for k in range(n_t) if groups[k] == g)
                    for g in gids}
            glat = {g: np.zeros(b) for g in gids}
            gbw = {g: np.zeros(b) for g in gids}      # per-device floors, max
            for k in range(n_t):
                has = lines[k] > 0
                rf = reads[k] / np.maximum(lines[k], 1.0)
                if groups[k] >= 0:
                    # shared USP: the queue sees the whole group's load
                    loaded = shared_usp_latency_ns(
                        timings[k], gpay[groups[k]], goff[groups[k]])
                elif kinds[k] in ("cxl", "ssd"):
                    loaded = np.asarray(
                        timings[k].loaded_latency_ns(offered[k], rf),
                        np.float64)
                else:
                    loaded = np.asarray(
                        timings[k].loaded_latency_ns(offered[k]), np.float64)
                lat[k] = np.where(done | ~has, lat[k], loaded)
                # MLP-overlapped stalls, floored by the bandwidth bound
                t_lat = lines[k] * lat[k] / mlp
                mshr = getattr(timings[k], "mshr", None)
                if groups[k] >= 0:
                    glat[groups[k]] = glat[groups[k]] + np.where(has, t_lat,
                                                                 0.0)
                    # this endpoint's own link/media ceiling (devices drain in
                    # parallel, so the group keeps the max member floor)
                    if mshr is None:
                        t_bw = bytes_[k] / device_payload[k]
                    else:
                        eff = np.minimum(
                            device_payload[k],
                            mshr * CACHELINE_BYTES / np.maximum(lat[k], 1.0))
                        t_bw = bytes_[k] / np.maximum(eff, 1e-9)
                    gbw[groups[k]] = np.maximum(gbw[groups[k]],
                                                np.where(has, t_bw, 0.0))
                else:
                    peak = (timings[k].peak_gbps if kinds[k] == "dram"
                            else timings[k].payload_gbps(rf))
                    if mshr is None:
                        t_bw = bytes_[k] / peak
                    else:
                        # Little's law: at most `mshr` lines in flight, each
                        # resident for the current loaded latency
                        eff = np.minimum(
                            peak,
                            mshr * CACHELINE_BYTES / np.maximum(lat[k], 1.0))
                        t_bw = bytes_[k] / np.maximum(eff, 1e-9)
                    stall += np.where(has, np.maximum(t_lat, t_bw), 0.0)
            for g in gids:
                # group bandwidth floor: aggregate bytes over the USP payload,
                # or the busiest member's own-device floor if that is stricter
                floor = np.maximum(gbytes[g] / gpay[g], gbw[g])
                stall += np.where(gbytes[g] > 0,
                                  np.maximum(glat[g], floor), 0.0)
            t_new = base_ns + stall
            newly = ~done & (np.abs(t_new - t) / np.maximum(t, 1.0) < 1e-6)
            t = np.where(done, t, t_new)
            done |= newly
            if done.all():
                break

        t_rep = np.where(n_acc > 0, t, 0.0)
        ach = [bytes_[k] / np.maximum(t, 1.0) for k in range(n_t)]
        has_ssd = any(kind == "ssd" for kind in kinds)
        if n_t == 2 and not has_ssd:
            labels = ["dram", "cxl"]
        else:
            labels, counters = ["dram"], {"cxl": 0, "ssd": 0}
            for kind in kinds[1:]:
                key = "ssd" if kind == "ssd" else "cxl"
                labels.append(f"{key}{counters[key]}")
                counters[key] += 1
        if dist is not None:
            pnames = [f"p{round(p * 100)}" for p in dist.percentiles]
            qfac = [dist.quantile_factors(k) for k in range(n_t)]
            idle = [timings[k].idle_ns for k in range(n_t)]
        names = cache_sim.stat_names(n_t)
        results: List[RunResult] = []
        for i in range(b):
            s = {n: int(stats[i, j]) for j, n in enumerate(names)}
            na = max(int(n_acc[i]), 1)
            l2a = max(s["l2_hit"] + s["l2_miss"], 1)
            mr = {"l1_miss_rate": s["l1_miss"] / na,
                  "l2_miss_rate": s["l2_miss"] / l2a,
                  "llc_mpki": 1000.0 * s["l2_miss"] / na}
            a = {labels[k]: float(ach[k][i]) for k in range(n_t)}
            latd = {labels[k]: float(lat[k][i]) for k in range(n_t)}
            if n_t != 2 or has_ssd:
                # aggregates per kind: total bw, line-weighted latency
                for agg, member in (("cxl", lambda k: kinds[k] != "ssd"),
                                    ("ssd", lambda k: kinds[k] == "ssd")):
                    if agg == "ssd" and not has_ssd:
                        continue
                    ks = [k for k in range(1, n_t) if member(k)]
                    a[agg] = float(sum(ach[k][i] for k in ks))
                    agg_lines = float(sum(lines[k][i] for k in ks))
                    agg_lats = [lat[k][i] for k in ks]
                    if agg_lines > 0:
                        latd[agg] = float(sum(lines[k][i] * lat[k][i]
                                              for k in ks)) / agg_lines
                    else:
                        latd[agg] = (float(np.mean(agg_lats)) if agg_lats
                                     else 0.0)
            a["total"] = a["dram"] + a["cxl"] + a.get("ssd", 0.0)
            lp = None
            if dist is not None:
                lp = {labels[k]: {pn: float(idle[k]
                                            + max(lat[k][i] - idle[k], 0.0)
                                            * qfac[k][j])
                                  for j, pn in enumerate(pnames)}
                      for k in range(n_t)}
            results.append(RunResult(
                stats=s, miss_rates=mr, time_ns=float(t_rep[i]),
                achieved_gbps=a, loaded_latency_ns=latd,
                cpu=cpus[i].kind,
                migration_gbps=float(mig_bytes[i] / max(t[i], 1.0)),
                lat_percentiles=lp))
        return results
