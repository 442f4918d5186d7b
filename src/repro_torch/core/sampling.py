"""SMARTS-style sampled simulation: windows, estimates, confidence intervals.

Exact simulation of every access caps realistic trace lengths; SMARTS
(Wunderlich et al.) showed that alternating **functional warming** (the
state machine advances, statistics are not collected) with short
**detailed measurement windows** recovers whole-trace statistics to a
quantifiable error.  This module is that layer for the batched trace
engine (:mod:`repro_torch.core.engine`):

  * a :class:`SamplingSpec` rides the ``SweepSpec.sampling`` axis and
    is compiled into three per-row scalars (warm/measure/period, in
    epoch-scan slots) for the epoch program of
    :mod:`repro_torch.core.tiering_dyn`, which masks the *stat*
    accumulation outside measurement windows while the cache/tier state
    machine runs every access (functional warming), so a measured
    window's counters equal the same window of an exact run, bit for
    bit.  The CUDA epoch kernel and its plain version gate the stats
    alike;
  * :func:`estimate` scales the measured windows to whole-trace
    estimates with CLT confidence intervals: per-window per-access
    rates are the samples, the point estimate is ``total accesses x
    mean rate`` and the half-width is ``t_{conf,n-1} x total accesses x
    s / sqrt(n)`` over the ``n`` windows;
  * :func:`host_estimate` is the NumPy twin: it recomputes the window
    flags with host arithmetic (:func:`measure_flags` mirrors the
    device slot counter bit for bit) and runs the same estimator.

This module is host NumPy and ``math`` only, the same arithmetic as the
JAX package's, so estimates and intervals match it to the last ulp.

Units
-----
``SamplingSpec`` counts in **sampling slots** of :data:`SLOT_LEN`
accesses each, independent of what else shares the sweep: the engine
scans at ``gcd(SLOT_LEN, dynamic epoch lengths)`` and rescales the
per-row scalars, so the same spec means the same access windows whether
or not dynamic tiering rides along.

Trust
-----
The intervals are honest only when the window rates behave like
independent draws: short traces (few windows), strong phase lock
between the workload period and the sampling period, or a cold-start
transient spanning a significant fraction of the windows all produce
intervals that are too narrow; ``n_windows`` is reported per row so
the caller can judge.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import cache as cache_mod

#: Accesses per sampling slot.  ``SamplingSpec`` counts windows in this
#: unit so a spec's meaning never depends on the sweep's epoch-scan
#: granularity (the engine rescales to its own slot length).
SLOT_LEN = 512


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SamplingSpec:
    """One sampled-simulation policy (an entry of ``SweepSpec.sampling``).

    The trace is tiled into periods of ``period_slots`` sampling slots
    (:data:`SLOT_LEN` accesses each).  Within every period, slots
    ``[warm_slots, warm_slots + measure_slots)`` are the detailed
    measurement window; every other slot functionally warms (cache and
    tier state advance exactly, stats are masked off).

    Parameters
    ----------
    warm_slots : int
        Slots at the start of each period that only warm state.
    measure_slots : int
        Detailed-measurement slots per period (>= 1).
    period_slots : int
        Slots per period; must fit ``warm_slots + measure_slots``.
    confidence : float
        Two-sided confidence level of the reported intervals.
    """
    warm_slots: int = 1
    measure_slots: int = 1
    period_slots: int = 8
    confidence: float = 0.95

    def __post_init__(self) -> None:
        if self.warm_slots < 0:
            raise ValueError(f"warm_slots must be >= 0, got {self.warm_slots}")
        if self.measure_slots < 1:
            raise ValueError(
                f"measure_slots must be >= 1, got {self.measure_slots}")
        if self.period_slots < self.warm_slots + self.measure_slots:
            raise ValueError(
                f"period_slots ({self.period_slots}) must cover warm + "
                f"measure ({self.warm_slots} + {self.measure_slots})")
        if not 0.0 < self.confidence < 1.0:
            raise ValueError(
                f"confidence must be in (0, 1), got {self.confidence}")

    @property
    def detail_frac(self) -> float:
        """Upper bound on the fraction of accesses simulated in detail."""
        return self.measure_slots / self.period_slots

    @property
    def label(self) -> str:
        conf = ("" if self.confidence == 0.95
                else f",c={self.confidence:g}")
        return (f"smarts(w={self.warm_slots},m={self.measure_slots},"
                f"p={self.period_slots}{conf})")


def describe(sampling: Optional[SamplingSpec]) -> str:
    """Row label for the ``sampling`` sweep axis (``'exact'`` for None)."""
    return "exact" if sampling is None else sampling.label


def slot_scale(slot_len: int) -> int:
    """Sampling slots -> engine scan slots conversion factor.

    The engine scans at ``slot_len`` accesses per slot (a divisor of
    :data:`SLOT_LEN` by construction — the sweep slot is the gcd of
    ``SLOT_LEN`` and the dynamic epoch lengths); one sampling slot is
    ``SLOT_LEN // slot_len`` scan slots.
    """
    if slot_len < 1 or SLOT_LEN % slot_len:
        raise ValueError(f"engine slot length {slot_len} does not divide "
                         f"the sampling slot ({SLOT_LEN} accesses)")
    return SLOT_LEN // slot_len


def scan_scalars(sampling: Optional[SamplingSpec], slot_len: int
                 ) -> Tuple[int, int, int]:
    """Per-row ``(s_warm, s_meas, s_per)`` scalars in scan-slot units.

    ``(0, 0, 0)`` for exact rows — the scan body then measures every
    slot, keeping ``sampling=None`` rows bitwise-equal to the legacy
    path (test-enforced).
    """
    if sampling is None:
        return (0, 0, 0)
    k = slot_scale(slot_len)
    return (sampling.warm_slots * k, sampling.measure_slots * k,
            sampling.period_slots * k)


# ---------------------------------------------------------------------------
# Quantiles (no scipy: Acklam inverse normal + Hill t expansion)
# ---------------------------------------------------------------------------
def z_score(confidence: float) -> float:
    """Two-sided standard-normal quantile ``Phi^-1((1+confidence)/2)``.

    Acklam's rational approximation (|relative error| < 1.15e-9 over the
    full open interval) — deterministic float64 host arithmetic, no
    scipy dependency.
    """
    if not 0.0 < confidence < 1.0:
        raise ValueError(f"confidence must be in (0, 1), got {confidence}")
    p = (1.0 + confidence) / 2.0
    a = (-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00)
    p_low = 0.02425
    if p < p_low:
        q = math.sqrt(-2.0 * math.log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4])
                * q + c[5]) / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3])
                               * q + 1.0)
    if p > 1.0 - p_low:
        q = math.sqrt(-2.0 * math.log(1.0 - p))
        return -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4])
                 * q + c[5]) / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3])
                                * q + 1.0)
    q = p - 0.5
    r = q * q
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4])
            * r + a[5]) * q / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3])
                                * r + b[4]) * r + 1.0)


def t_score(confidence: float, df: int) -> float:
    """Two-sided Student-t quantile via Hill's Cornish–Fisher expansion.

    Expands around :func:`z_score`; accurate to ~4 decimals for
    ``df >= 3`` and within a few percent at ``df in (1, 2)`` — where the
    interval is statistically untrustworthy anyway.
    ``df < 1`` returns ``inf`` (no variance estimate exists).
    """
    if df < 1:
        return math.inf
    z = z_score(confidence)
    z3, z5, z7, z9 = z ** 3, z ** 5, z ** 7, z ** 9
    g1 = (z3 + z) / 4.0
    g2 = (5.0 * z5 + 16.0 * z3 + 3.0 * z) / 96.0
    g3 = (3.0 * z7 + 19.0 * z5 + 17.0 * z3 - 15.0 * z) / 384.0
    g4 = (79.0 * z9 + 776.0 * z7 + 1482.0 * z5 - 1920.0 * z3
          - 945.0 * z) / 92160.0
    d = float(df)
    return z + g1 / d + g2 / d ** 2 + g3 / d ** 3 + g4 / d ** 4


# ---------------------------------------------------------------------------
# Window arithmetic (the host twin of the device slot counter)
# ---------------------------------------------------------------------------
def measure_flags(n_slots: int, s_warm: int, s_meas: int, s_per: int
                  ) -> np.ndarray:
    """Per-slot 0/1 measurement flags — bit-for-bit the device rule.

    The scan body computes, at entry to 0-based slot ``e``:
    ``pos = e % s_per; meas = (pos >= s_warm) & (pos < s_warm + s_meas)``
    with ``s_per <= 0`` meaning *measure everything* (exact rows).  This
    NumPy twin must stay bitwise-equal to the device-emitted flags
    (``DynOutputs.meas``, parity test-enforced).
    """
    if s_per <= 0:
        return np.ones(n_slots, np.int32)
    pos = np.arange(n_slots, dtype=np.int64) % s_per
    return ((pos >= s_warm) & (pos < s_warm + s_meas)).astype(np.int32)


def window_spans(flags: np.ndarray) -> List[Tuple[int, int]]:
    """Maximal runs of measured slots as ``[start, stop)`` slot spans."""
    f = np.asarray(flags, np.int32)
    edges = np.flatnonzero(np.diff(np.concatenate(
        ([0], (f != 0).astype(np.int32), [0]))))
    return [(int(edges[i]), int(edges[i + 1]))
            for i in range(0, len(edges), 2)]


# ---------------------------------------------------------------------------
# The estimator
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Estimate:
    """Whole-trace estimates from the measured windows of one row.

    Attributes
    ----------
    stats : (nstats,) int64
        Point estimates per stat column (``total_acc x mean window
        rate``, rounded to the nearest count).
    ci : (nstats,) float64
        Half-width of the two-sided confidence interval per column
        (``inf`` with fewer than two non-empty windows).
    n_windows : int
        Non-empty measurement windows the estimate is built from.
    total_acc : int
        Valid (non-sentinel) accesses in the whole trace.
    measured_acc : int
        Valid accesses inside measurement windows (simulated in detail).
    confidence : float
        The interval's two-sided confidence level.
    window_sums : (W, nstats) int64
        Per-window stat sums — the bitwise parity surface between the
        device program and :func:`host_estimate`.
    window_acc : (W,) int64
        Valid accesses per window.
    """
    stats: np.ndarray
    ci: np.ndarray
    n_windows: int
    total_acc: int
    measured_acc: int
    confidence: float
    window_sums: np.ndarray
    window_acc: np.ndarray

    @property
    def sampled_frac(self) -> float:
        """Fraction of valid accesses simulated in detail."""
        return self.measured_acc / self.total_acc if self.total_acc else 0.0

    def l2_miss_rate_ci(self) -> Tuple[float, float]:
        """``(estimate, half-width)`` of the L2 miss rate over windows.

        Per-window miss rates ``l2_miss / (l2_hit + l2_miss)`` are the
        CLT samples (windows without L2 traffic are dropped); the same
        t-quantile as the counter intervals closes the half-width.
        """
        hit = self.window_sums[:, cache_mod.L2_HIT].astype(np.float64)
        miss = self.window_sums[:, cache_mod.L2_MISS].astype(np.float64)
        acc = hit + miss
        keep = acc > 0
        if not keep.any():
            return 0.0, math.inf
        rates = miss[keep] / acc[keep]
        n = int(keep.sum())
        if n < 2:
            return float(rates.mean()), math.inf
        t = t_score(self.confidence, n - 1)
        return (float(rates.mean()),
                float(t * rates.std(ddof=1) / math.sqrt(n)))


def estimate(slot_deltas: np.ndarray, slot_acc: np.ndarray,
             flags: np.ndarray, confidence: float = 0.95) -> Estimate:
    """Scale measured windows to whole-trace estimates + CLT intervals.

    Parameters
    ----------
    slot_deltas : (E, nstats) int array
        Per-slot stat deltas.  Warm slots must be all-zero (the scan
        body masks them; the masking invariant is test-enforced).
    slot_acc : (E,) int array
        Valid accesses per slot (warm and measured alike — this is the
        denominator of the scaling, so it must count *every* access).
    flags : (E,) 0/1 array
        Measurement flags (:func:`measure_flags` / ``DynOutputs.meas``).
    confidence : float
        Two-sided confidence level.

    Returns
    -------
    Estimate
        Windows with zero valid accesses (batch padding) are dropped;
        with no non-empty window at all the estimates are zero with
        infinite intervals.
    """
    deltas = np.asarray(slot_deltas, np.int64)
    acc = np.asarray(slot_acc, np.int64)
    flags = np.asarray(flags, np.int32)
    if deltas.ndim != 2 or deltas.shape[0] != acc.shape[0] \
            or flags.shape[0] != acc.shape[0]:
        raise ValueError(
            f"shape mismatch: deltas {deltas.shape}, acc {acc.shape}, "
            f"flags {flags.shape}")
    nstats = deltas.shape[1]
    spans = window_spans(flags)
    w_sums = np.stack([deltas[lo:hi].sum(axis=0) for lo, hi in spans]) \
        if spans else np.zeros((0, nstats), np.int64)
    w_acc = np.asarray([acc[lo:hi].sum() for lo, hi in spans], np.int64)
    keep = w_acc > 0
    w_sums, w_acc = w_sums[keep], w_acc[keep]
    n = int(w_acc.shape[0])
    total = int(acc.sum())
    if n == 0:
        return Estimate(stats=np.zeros(nstats, np.int64),
                        ci=np.full(nstats, math.inf),
                        n_windows=0, total_acc=total, measured_acc=0,
                        confidence=confidence,
                        window_sums=w_sums, window_acc=w_acc)
    rates = w_sums.astype(np.float64) / w_acc[:, None].astype(np.float64)
    mean = rates.mean(axis=0)
    est = np.rint(total * mean).astype(np.int64)
    if n < 2:
        ci = np.full(nstats, math.inf)
    else:
        t = t_score(confidence, n - 1)
        ci = t * total * rates.std(axis=0, ddof=1) / math.sqrt(n)
    return Estimate(stats=est, ci=ci, n_windows=n, total_acc=total,
                    measured_acc=int(w_acc.sum()), confidence=confidence,
                    window_sums=w_sums, window_acc=w_acc)


def host_estimate(sampling: SamplingSpec, slot_deltas: np.ndarray,
                  slot_acc: np.ndarray, *, slot_len: int = SLOT_LEN
                  ) -> Estimate:
    """NumPy twin of the device sampled path for one row.

    Recomputes the measurement flags with host arithmetic
    (:func:`measure_flags`, bit-for-bit the device slot-counter rule)
    and runs :func:`estimate` on per-slot deltas from an **exact** run.
    Because functional warming keeps the state machine exact, the
    device's masked windows must be bitwise-equal to the same windows
    of the exact run — so this twin's ``window_sums`` / ``stats`` /
    ``ci`` must match the device path's exactly (test-enforced).

    Parameters
    ----------
    sampling : SamplingSpec
        The window policy.
    slot_deltas : (E, nstats) int array
        Per-slot stat deltas of the row (exact or device-masked run —
        measured windows agree either way).
    slot_acc : (E,) int array
        Valid accesses per slot.
    slot_len : int
        Accesses per scan slot the deltas were taken at (defaults to
        one sampling slot).
    """
    s_warm, s_meas, s_per = scan_scalars(sampling, slot_len)
    acc = np.asarray(slot_acc, np.int64)
    flags = measure_flags(acc.shape[0], s_warm, s_meas, s_per)
    return estimate(slot_deltas, acc, flags, sampling.confidence)


# ---------------------------------------------------------------------------
# Reporting: the ci column family (offsets derive from cache.nstats)
# ---------------------------------------------------------------------------
def ci_column_names(n_targets: int) -> Tuple[str, ...]:
    """Ordered ``*_ci95`` row-column labels, one per stat counter.

    Column ``i`` is the interval of stat column ``i`` — the offsets are
    *defined* by :func:`repro_torch.core.cache.stat_names` /
    :func:`~repro_torch.core.cache.nstats`, so the ci family can never drift
    from the stats layout.
    """
    return tuple(f"{n}_ci95" for n in cache_mod.stat_names(n_targets))
