"""The two-level MESI + tier cache kernels: CUDA wrappers and plain versions.

:func:`mesi_segment` advances the engine's packed batch carry
``(l1p, l2p, stats, t)`` over a (B, N) trace segment — the port of the
Pallas kernels ``mesi_segment`` and ``mesi_cache_sim`` of the JAX package
(``src/repro/kernels/cache_sim.py``).  :func:`mesi_cache_sim` is the same
kernel run from a fresh carry.  Both dispatch on the device of the trace:

* a CUDA tensor launches the hand-written kernel in ``csrc/mesi.cu`` (built
  with `nvcc` at first use, see :mod:`repro_torch.kernels.build`), or
  raises;
* a CPU tensor runs the plain PyTorch version, :func:`mesi_segment_ref`;
* ``backend="reference"`` selects the plain version on either device and
  ``backend="cuda"`` insists on the kernel.

The plain version loops :func:`repro_torch.core.cache._packed_step` over
the trace, one access for all B rows at a time.  Kernel and plain version
thread the identical carry, so segments may alternate between them with
bitwise-equal results.  Sentinel entries (``addr == SENTINEL``) change no
state or counter; the clock advances across them and ends at ``t + N``.

:func:`mesi_dyn_segment` is the epoch-structured twin for dynamic tiering,
sampling and the CXL-SSD tier: the port of the Pallas kernel
``mesi_dyn_segment``.  It advances the 9-tuple carry of
:func:`repro_torch.core.tiering_dyn.init_dyn_carry` over a (B, E, slot_len)
segment; its CUDA kernel is ``csrc/mesi_dyn.cu``, which shares the
per-access body (``csrc/mesi_access.cuh``) with ``csrc/mesi.cu``, and its
plain version, :func:`mesi_dyn_segment_ref`, loops
:func:`repro_torch.core.tiering_dyn._slot_step` over the slots.

:func:`cache_sim` (K6) is the single-level set-associative LRU cache, the
port of the Pallas kernel ``cache_sim`` (``src/repro/kernels/cache_sim.py:
127``, its ``pallas_call`` at line 150): per-access hits and the final tags
and use clocks of an (N,) line trace.  Its CUDA kernel is
``csrc/cache_sim.cu``: a bucket pre-pass groups the trace by set, then one
warp walks each set's accesses (:func:`cache_sim_bits` gives the chain
count, :func:`cache_sim_tile` the pre-pass's tile); its plain version,
:func:`cache_sim_ref`, steps all sets at once.  Negative addresses raise:
the Pallas body skips them as padding, its oracle
``repro.kernels.ref.cache_sim`` treats them as live lines.

The wrappers count kernel launches (``"mesi_segment"``,
``"mesi_dyn_segment"``, ``"cache_sim"``) and plain-version calls
(``"mesi_segment_ref"``, ``"mesi_dyn_segment_ref"``, ``"cache_sim_ref"``)
in :data:`repro_torch.kernels.build.LAUNCHES`.

Both MESI kernels split each row into ``2**chain_bits(params)``
independent set chains (:func:`chain_bits`; K3's plan may take fewer), one
warp each, and gather each chain's accesses with a bucket pre-pass
(:func:`bucket`) before they walk them.  ``chunk``, the JAX package's
trace elements per Pallas grid step, is a TPU tiling parameter: the entry
points accept it (>= 1) and ignore it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import tiering_dyn
from repro_torch.core.cache import (
    SENTINEL, CacheParams, CacheState, _packed_step, init_batch_carry,
    nstats, unpack_state,
)
from repro_torch.kernels import build
from repro_torch.kernels.build import LAUNCHES

BACKENDS = ("reference", "cuda")
#: a row splits into at most 2**MAX_CHAIN_BITS chains
MAX_CHAIN_BITS = 12


def check_chunk(chunk: int) -> None:
    """Accept the JAX package's ``chunk`` keyword (trace elements per
    Pallas grid step, a TPU tiling parameter): it must be >= 1 and changes
    nothing here."""
    if int(chunk) < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")


def chain_bits(params: CacheParams) -> int:
    """log2 of the chain count m a MESI kernel splits each row into.

    Set counts are powers of two and set indices are address masks, so the
    accesses of line ``a`` touch only sets whose index is ``a`` modulo
    ``min(l1_sets, l2_sets)``; with m that minimum (at most
    ``2**MAX_CHAIN_BITS``), chain ``a & (m - 1)`` shares no cache state with
    the others.  128 chains at the Table-I geometry.
    """
    m = min(params.l1_sets, params.l2_sets)
    return min(m.bit_length() - 1, MAX_CHAIN_BITS)


def bucket_tile(bits: int) -> int:
    """Trace entries per tile of the bucket pre-pass: at least 4096, and
    enough that the per-tile chain counts take no more room than the
    trace."""
    return max(4096, 32 << bits)


def bucket_scratch(b: int, n: int, bits: int, device):
    """The bucket pre-pass's buffers for a (b, n) trace split into at most
    ``2**bits`` chains: ``(hist, start, rec, tile)``, uninitialised."""
    m, tile = 1 << bits, bucket_tile(bits)
    empty = functools.partial(torch.empty, dtype=torch.int32, device=device)
    return (empty((b, -(-n // tile), m)), empty((b, m + 1)),
            empty((b, n, 4)), tile)


def resolve_backend(backend: Optional[str], device: torch.device) -> str:
    """The backend a call runs on: ``None`` follows the tensor's device.

    The JAX package's name for its kernel backend, ``"pallas"``, selects
    the CUDA kernel.
    """
    if backend is None:
        return "cuda" if device.type == "cuda" else "reference"
    if backend == "pallas":
        backend = "cuda"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; pick from "
                         f"{BACKENDS} or None (follow the device)")
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(f"backend='cuda' needs CUDA tensors, got a trace "
                         f"on {device}")
    return backend


def pad_trace(chunk: int, addr: torch.Tensor, *fields: torch.Tensor
              ) -> Tuple[torch.Tensor, ...]:
    """Pad a trace to a multiple of `chunk` with sentinel entries.

    `addr` is padded with :data:`SENTINEL`; every extra field (is_write,
    core, tier, ...) with zeros.  Works on 1-D traces and (B, N) batches
    (padding along the last axis); every result is int32.
    """
    n = addr.shape[-1]
    pad = (-n) % chunk
    out = [addr.to(torch.int32)] + [f.to(torch.int32) for f in fields]
    if pad == 0:
        return tuple(out)
    return tuple(torch.nn.functional.pad(x, (0, pad), value=v)
                 for x, v in zip(out, [SENTINEL] + [0] * len(fields)))


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------
def mesi_segment_ref(carry, addr, is_write, core, tier, *,
                     params: CacheParams):
    """Plain PyTorch version of :func:`mesi_segment` (same contract).

    A per-access Python loop over :func:`~repro_torch.core.cache.
    _packed_step`, vectorized over the B rows.  The input carry is not
    modified.
    """
    LAUNCHES["mesi_segment_ref"] += 1
    l1p, l2p, stats, t = carry
    state = (l1p.clone(), l2p.clone(), stats.clone(), t.to(torch.int32))
    # one column per access, in the dtypes `_packed_step` takes
    cols = zip(addr.to(torch.int32).t(), (is_write != 0).t(),
               core.to(torch.int32).t(), tier.to(torch.int32).t(),
               (addr != SENTINEL).t())
    for x in cols:
        state = _packed_step(params, state, x)
    return state


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _library() -> ctypes.CDLL:
    lib = build.load("mesi")
    lib.mesi_plan.argtypes = [_P] + [_I] * 8
    lib.mesi_plan.restype = _I
    lib.mesi_bucket.argtypes = [_P] * 4 + [_I, _L, _I, _I] + [_P] * 3 + [
        _I, _P]
    lib.mesi_bucket.restype = _I
    lib.mesi_segment.argtypes = [_P] * 11 + [_I] * 11 + [_P]
    lib.mesi_segment.restype = _I
    lib.mesi_error_string.argtypes = [_I]
    lib.mesi_error_string.restype = ctypes.c_char_p
    return lib


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else \
        torch.cuda.current_device()


def _raise_on(rc: int, what: str, error_string) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc} "
                           f"({error_string(rc).decode()})")


PLAN_FIELDS = ("bits", "warps_per_block", "blocks_per_row",
               "l1_in_smem", "l2_in_smem", "smem_bytes", "sms")


def mesi_plan(params: CacheParams, device):
    """The MESI kernel's launch shape for `params` on CUDA `device`:
    ``{field: int for field in PLAN_FIELDS}`` (chain count ``2**bits``)."""
    lib = _library()
    out = (ctypes.c_int * len(PLAN_FIELDS))()
    rc = lib.mesi_plan(out, params.cores, params.l1_sets, params.l1_ways,
                       params.l2_sets, params.l2_ways, params.n_targets,
                       chain_bits(params),
                       _device_index(torch.device(device)))
    _raise_on(rc, "mesi_plan", lib.mesi_error_string)
    return dict(zip(PLAN_FIELDS, out))


def bucket(addr, is_write, core, tier, bits: int):
    """The bucket pre-pass that both MESI kernels run first, alone (to time
    it): a (B, N) int32 CUDA trace split into ``2**bits`` chains, each
    row's live accesses as (pos, addr, is_write | core << 1, tier) records
    grouped by chain, in row order within a chain.  Returns ``(rec (B, N,
    4), start (B, 2**bits + 1))``: chain k of row r is ``rec[r, start[r,
    k]:start[r, k + 1]]``."""
    addr, is_write, core, tier = _as_int32(addr, is_write, core, tier)
    b, n = addr.shape
    device = addr.device
    hist, start, rec, tile = bucket_scratch(b, n, bits, device)
    lib = _library()
    rc = lib.mesi_bucket(
        addr.data_ptr(), is_write.data_ptr(), core.data_ptr(),
        tier.data_ptr(), b, n, bits, tile, hist.data_ptr(), start.data_ptr(),
        rec.data_ptr(), _device_index(device),
        torch.cuda.current_stream(device).cuda_stream)
    _raise_on(rc, "the bucket pre-pass", lib.mesi_error_string)
    return rec, start


def _check_inputs(carry, trace, params: CacheParams) -> None:
    l1p, l2p, stats, t = carry
    b, n = trace[0].shape
    want = {
        "l1p": (l1p, (b, params.cores, params.l1_sets, params.l1_ways, 3)),
        "l2p": (l2p, (b, params.l2_sets, params.l2_ways, 5)),
        "stats": (stats, (b, nstats(params.n_targets))),
        "t": (t, (b,)),
        "addr": (trace[0], (b, n)), "is_write": (trace[1], (b, n)),
        "core": (trace[2], (b, n)), "tier": (trace[3], (b, n)),
    }
    device = trace[0].device
    for name, (x, shape) in want.items():
        if x.device != device or x.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {device}, "
                             f"got {x.device}")
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, "
                             f"got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if params.l1_ways > 32 or params.l2_ways > 32:
        raise ValueError("the kernel spans ways with one warp: l1_ways and "
                         "l2_ways must be <= 32")
    core = trace[2]
    if core.numel() and (int(core.min()) < 0
                         or int(core.max()) >= params.cores):
        raise ValueError(f"core ids must lie in [0, {params.cores})")


def _launch(carry, addr, is_write, core, tier, params: CacheParams):
    """Launch the kernel on copies of the carry; return the advanced carry."""
    _check_inputs(carry, (addr, is_write, core, tier), params)
    bits = chain_bits(params)
    l1p, l2p, stats, t = (x.clone() for x in carry)
    b, n = addr.shape
    lib = _library()
    device = addr.device
    hist, start, rec, tile = bucket_scratch(b, n, bits, device)
    rc = lib.mesi_segment(
        addr.data_ptr(), is_write.data_ptr(), core.data_ptr(),
        tier.data_ptr(), t.data_ptr(), hist.data_ptr(), start.data_ptr(),
        rec.data_ptr(), l1p.data_ptr(), l2p.data_ptr(), stats.data_ptr(), b,
        n, params.cores, params.l1_sets, params.l1_ways, params.l2_sets,
        params.l2_ways, params.n_targets, bits, tile, _device_index(device),
        torch.cuda.current_stream(device).cuda_stream)
    _raise_on(rc, "mesi_segment kernel", lib.mesi_error_string)
    LAUNCHES["mesi_segment"] += 1
    return l1p, l2p, stats, t + n


def _as_int32(*xs: torch.Tensor):
    return tuple(x.to(torch.int32).contiguous() for x in xs)


def mesi_segment(carry, addr, is_write, core, tier, *,
                 params: CacheParams, backend: Optional[str] = None,
                 chunk: int = 512):
    """Advance the packed batch carry over one (B, N) trace segment.

    Args:
      carry: ``(l1p, l2p, stats, t)`` — (B, cores, s1, w1, 3),
        (B, s2, w2, 5), (B, nstats) and (B,) int32, as
        :func:`repro_torch.core.cache.init_batch_carry` builds it.
      addr: (B, N) line addresses; :data:`SENTINEL` marks padding.
      is_write/core/tier: (B, N) integer tensors on the same device.
      params: cache geometry.
      backend: ``None`` (follow the device), ``"reference"`` or ``"cuda"``.
      chunk: the JAX package's Pallas grid step, accepted and ignored.

    Returns the advanced carry (new tensors; the input is unchanged).  The
    clock advances by N.
    """
    check_chunk(chunk)
    if addr.ndim != 2:
        raise ValueError("mesi_segment expects a (B, N) batch")
    backend = resolve_backend(backend, addr.device)
    addr, is_write, core, tier = _as_int32(addr, is_write, core, tier)
    if backend == "reference":
        return mesi_segment_ref(carry, addr, is_write, core, tier,
                                params=params)
    return _launch(carry, addr, is_write, core, tier, params)


def mesi_cache_sim(addr, is_write, core, tier, *, params: CacheParams,
                   backend: Optional[str] = None, chunk: int = 512
                   ) -> Tuple[torch.Tensor, CacheState]:
    """Two-level MESI + tier simulation of a (B, N) trace batch.

    :func:`mesi_segment` from a fresh carry (``chunk`` is accepted and
    ignored).  Returns ``(stats (B, nstats(params.n_targets)) int32,
    batched CacheState)``.
    """
    check_chunk(chunk)
    if addr.ndim != 2:
        raise ValueError("mesi_cache_sim expects a (B, N) batch")
    carry = init_batch_carry(params, addr.shape[0], device=addr.device)
    l1p, l2p, stats, _ = mesi_segment(carry, addr, is_write, core, tier,
                                      params=params, backend=backend)
    return stats, unpack_state(l1p, l2p)


# ---------------------------------------------------------------------------
# The epoch-structured kernel (dynamic tiering, sampling, CXL-SSD tier)
# ---------------------------------------------------------------------------
#: Column order of the packed per-row scalar input of the kernel: the
#: per-row scalars of :func:`repro_torch.core.tiering_dyn.
#: run_dynamic_segment` followed by the two scalar carry components
#: (logical clock, epoch-slot index).
DYN_SCALARS = ("dyn_flag", "n_pages", "budget", "threshold", "period",
               "dram_cap", "ssd_tid", "cxl_cap", "s_warm", "s_meas",
               "s_per", "t0", "eidx0")


def mesi_dyn_segment_ref(carry, addr, is_write, core, tier, dyn_flag,
                         n_pages, budget, threshold, period, dram_cap,
                         ssd_tid, cxl_cap, page_target_lines, s_warm,
                         s_meas, s_per, *, params: CacheParams, k_max: int,
                         count_bound: int):
    """Plain PyTorch version of :func:`mesi_dyn_segment` (same contract).

    :func:`repro_torch.core.tiering_dyn._slot_step` — the packed MESI step
    per access for all B rows at once, then the migration stages with
    ``torch.topk`` — looped over the E slots.  The input carry is not
    modified.
    """
    LAUNCHES["mesi_dyn_segment_ref"] += 1
    b, e, _ = addr.shape
    n_p = page_target_lines.shape[1]
    k_max = min(int(k_max), n_p)
    consts = tiering_dyn.slot_consts(
        (dyn_flag, n_pages, budget, threshold, period, dram_cap, ssd_tid,
         cxl_cap, page_target_lines, s_warm, s_meas, s_per), n_p, k_max)
    state = tuple(x.clone() for x in carry)
    valid = addr != SENTINEL
    slots, snaps, meas = [], [], []
    for j in range(e):
        state, (ys, st, ms) = tiering_dyn._slot_step(
            params, k_max, count_bound, n_p, consts, state,
            (addr[:, j], is_write[:, j] != 0, core[:, j], tier[:, j],
             valid[:, j]))
        slots.append(ys)
        snaps.append(st.clone())
        meas.append(ms)
    if e == 0:
        zeros = functools.partial(torch.zeros, dtype=torch.int32,
                                  device=addr.device)
        return (state, zeros((b, 0, 4)),
                zeros((b, 0, nstats(params.n_targets))), zeros((b, 0)))
    return (state, torch.stack(slots, dim=1), torch.stack(snaps, dim=1),
            torch.stack(meas, dim=1))


def _dyn_library() -> ctypes.CDLL:
    lib = build.load("mesi_dyn")
    lib.mesi_dyn_plan.argtypes = [_P] + [_I] * 11
    lib.mesi_dyn_plan.restype = _I
    lib.mesi_dyn_segment.argtypes = [_P] * 20 + [_I] * 16 + [_P]
    lib.mesi_dyn_segment.restype = _I
    lib.mesi_dyn_error_string.argtypes = [_I]
    lib.mesi_dyn_error_string.restype = ctypes.c_char_p
    return lib


DYN_PLAN_FIELDS = ("bits", "warps_per_block", "blocks_per_row",
                   "rows_per_launch", "l1_in_smem", "l2_in_smem",
                   "page_map_in_smem", "smem_bytes", "sms", "blocks_per_sm")


def mesi_dyn_plan(params: CacheParams, b: int, n_pages: int, device, *,
                  meet: bool):
    """The epoch kernel's launch shape for `b` rows of `n_pages` pages on
    CUDA `device`, as the kernel's entry plans it: ``{field: int for field
    in DYN_PLAN_FIELDS}``.  `meet` says whether some row migrates at a
    boundary inside the segment (its chains must then be resident
    together, which may cut the chain count below ``2**chain_bits(params)``
    or split the rows over several launches)."""
    lib = _dyn_library()
    out = (ctypes.c_int * len(DYN_PLAN_FIELDS))()
    rc = lib.mesi_dyn_plan(out, b, n_pages, params.cores, params.l1_sets,
                           params.l1_ways, params.l2_sets, params.l2_ways,
                           params.n_targets, chain_bits(params), int(meet),
                           _device_index(torch.device(device)))
    _raise_on(rc, "mesi_dyn_plan", lib.mesi_dyn_error_string)
    return dict(zip(DYN_PLAN_FIELDS, out))


def meets(budget, period, eidx0, e: int) -> bool:
    """Whether some row migrates at an epoch boundary inside an `e`-slot
    segment: budget > 0 and a slot index eidx0 + j (j < e) with
    (eidx0 + j + 1) % period == 0; (B,) tensors.  One host sync."""
    period, eidx0 = period.long(), eidx0.long()
    return bool(((budget > 0) & (eidx0 % period + e >= period)).any())


def _check_dyn_inputs(tensors, params: CacheParams) -> None:
    device = tensors["addr"][0].device
    for name, (x, shape) in tensors.items():
        if x.device != device or x.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {device}, "
                             f"got {x.device}")
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, "
                             f"got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if params.l1_ways > 32 or params.l2_ways > 32:
        raise ValueError("the kernel spans ways with one warp: l1_ways and "
                         "l2_ways must be <= 32")
    core = tensors["core"][0]
    if core.numel() and (int(core.min()) < 0
                         or int(core.max()) >= params.cores):
        raise ValueError(f"core ids must lie in [0, {params.cores})")
    if int(tensors["sc"][0][:, 4].min()) < 1:
        raise ValueError("every row's period must be >= 1")


def _launch_dyn(carry, addr, is_write, core, tier, sc, ptl, *,
                params: CacheParams, k_max: int, count_bound: int):
    """Launch the kernel on copies of the carry; return the advanced
    carry and the per-slot outputs."""
    b, e, slot_len = addr.shape
    n_p, n_t = ptl.shape[1], params.n_targets
    ns = nstats(n_t)
    l1p, l2p, stats, t, pmap, counts, mig_rd, mig_wr, eidx = carry
    _check_dyn_inputs({
        "l1p": (l1p, (b, params.cores, params.l1_sets, params.l1_ways, 3)),
        "l2p": (l2p, (b, params.l2_sets, params.l2_ways, 5)),
        "stats": (stats, (b, ns)), "t": (t, (b,)),
        "page_map": (pmap, (b, n_p)), "counts": (counts, (b, n_p)),
        "mig_rd": (mig_rd, (b, n_t)), "mig_wr": (mig_wr, (b, n_t)),
        "eidx": (eidx, (b,)), "sc": (sc, (b, len(DYN_SCALARS))),
        "page_target_lines": (ptl, (b, n_p, n_t)),
        "addr": (addr, (b, e, slot_len)),
        "is_write": (is_write, (b, e, slot_len)),
        "core": (core, (b, e, slot_len)), "tier": (tier, (b, e, slot_len)),
    }, params)
    l1p, l2p, stats, pmap, counts, mig_rd, mig_wr = (
        x.clone() for x in (l1p, l2p, stats, pmap, counts, mig_rd, mig_wr))
    device = addr.device
    zeros = functools.partial(torch.zeros, dtype=torch.int32, device=device)
    slots, snaps, bar = zeros((b, e, 4)), zeros((b, e, ns)), zeros((b, 2))
    meas = torch.empty((b, e), dtype=torch.int32, device=device)
    meet = meets(sc[:, 2], sc[:, 4], sc[:, 12], e)
    bits = chain_bits(params)    # the most chains; the plan may take fewer
    hist, start, rec, tile = bucket_scratch(b, e * slot_len, bits, device)
    lib = _dyn_library()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.mesi_dyn_segment(
        addr.data_ptr(), is_write.data_ptr(), core.data_ptr(),
        tier.data_ptr(), sc.data_ptr(), ptl.data_ptr(), hist.data_ptr(),
        start.data_ptr(), rec.data_ptr(), bar.data_ptr(),
        l1p.data_ptr(), l2p.data_ptr(), stats.data_ptr(), pmap.data_ptr(),
        counts.data_ptr(), mig_rd.data_ptr(), mig_wr.data_ptr(),
        slots.data_ptr(), snaps.data_ptr(), meas.data_ptr(),
        b, e, slot_len, n_p, k_max, count_bound, params.cores,
        params.l1_sets, params.l1_ways, params.l2_sets, params.l2_ways,
        n_t, bits, tile, int(meet), _device_index(device), stream)
    _raise_on(rc, "mesi_dyn_segment kernel", lib.mesi_dyn_error_string)
    LAUNCHES["mesi_dyn_segment"] += 1
    carry = (l1p, l2p, stats, t + e * slot_len, pmap, counts, mig_rd,
             mig_wr, eidx + e)
    return carry, slots, snaps, meas


def mesi_dyn_segment(carry, addr, is_write, core, tier, dyn_flag, n_pages,
                     budget, threshold, period, dram_cap, ssd_tid, cxl_cap,
                     page_target_lines, s_warm, s_meas, s_per, *,
                     params: CacheParams, k_max: int, count_bound: int,
                     backend: Optional[str] = None):
    """Advance the batched epoch carry over a (B, E, slot_len) segment.

    Args:
      carry: the 9-tuple ``(l1p, l2p, stats, t, page_map, counts, mig_rd,
        mig_wr, eidx)`` of :func:`repro_torch.core.tiering_dyn.
        init_dyn_carry`, int32 on the trace's device.
      addr/is_write/core/tier: (B, E, slot_len) integer tensors;
        :data:`SENTINEL` addresses mark padding.
      dyn_flag ... cxl_cap, s_warm, s_meas, s_per: (B,) per-row scalars in
        :func:`repro_torch.core.tiering_dyn.run_dynamic_segment`'s order.
      page_target_lines: (B, P, T) int32.
      params: cache geometry (``T == params.n_targets``).
      k_max: top-k width, clamped to P.
      count_bound: the coldness-key bound from
        :func:`repro_torch.core.tiering_dyn.prep_dynamic_inputs`.
      backend: ``None`` (follow the device), ``"reference"`` or ``"cuda"``.

    Returns ``(carry, slots (B, E, 4), snaps (B, E, nstats), meas (B, E))``:
    new tensors, the input carry unchanged.  The clock advances by
    ``E * slot_len`` and the slot index by E.
    """
    if addr.ndim != 3:
        raise ValueError("mesi_dyn_segment expects a (B, E, slot_len) batch")
    backend = resolve_backend(backend, addr.device)
    addr, is_write, core, tier = (x.to(torch.int32).contiguous()
                                  for x in (addr, is_write, core, tier))
    scalars = [x.to(torch.int32) for x in (
        dyn_flag, n_pages, budget, threshold, period, dram_cap, ssd_tid,
        cxl_cap, s_warm, s_meas, s_per)]
    ptl = page_target_lines.to(torch.int32).contiguous()
    k_max = min(int(k_max), ptl.shape[1])
    if backend == "reference":
        return mesi_dyn_segment_ref(
            carry, addr, is_write, core, tier, *scalars[:8], ptl,
            *scalars[8:], params=params, k_max=k_max,
            count_bound=count_bound)
    sc = torch.stack(scalars + [carry[3].to(torch.int32),
                                carry[8].to(torch.int32)], dim=1)
    return _launch_dyn(carry, addr, is_write, core, tier, sc.contiguous(),
                       ptl, params=params, k_max=k_max,
                       count_bound=count_bound)


# ---------------------------------------------------------------------------
# The single-level LRU cache (K6)
# ---------------------------------------------------------------------------
#: the CUDA kernel spans the ways of a set with one warp
MAX_WAYS = 32
_INT32_MAX = 2**31 - 1


def _check_cache_sim(addr: torch.Tensor, n_sets: int, n_ways: int) -> None:
    if addr.ndim != 1:
        raise ValueError(f"cache_sim expects an (N,) trace, got shape "
                         f"{tuple(addr.shape)}")
    if addr.dtype != torch.int32:
        raise TypeError(f"addr must be int32, got {addr.dtype}")
    if n_sets <= 0 or n_sets & (n_sets - 1) != 0:
        raise ValueError(f"n_sets must be a power of two, got {n_sets}")
    if n_ways < 1:
        raise ValueError(f"n_ways must be >= 1, got {n_ways}")
    if addr.shape[0] > _INT32_MAX:
        raise ValueError("the use clock is int32: at most 2**31 - 1 "
                         "accesses")
    # one host sync.  The Pallas body treats a negative address as padding
    # and the jnp oracle as a live line; the port takes neither side.
    if addr.numel() and bool((addr < 0).any()):
        raise ValueError("cache_sim takes line addresses >= 0: the trace "
                         "holds a negative one")


def cache_sim_ref(addr: torch.Tensor, *, n_sets: int, n_ways: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`cache_sim` (same contract).

    Sets never interact, so the trace is grouped by set (keeping each
    set's order) and stepped one access per set at a time, all sets
    together: step k applies the k-th access of every set.  A hit takes the
    first matching way, a miss the first way of least use clock
    (``argmax`` / ``argmin`` return the first index), and the clock is the
    access's 1-based position in the trace.
    """
    LAUNCHES["cache_sim_ref"] += 1
    dev = addr.device
    n = addr.shape[0]
    tags = torch.full((n_sets, n_ways), -1, dtype=torch.int32, device=dev)
    use = torch.zeros((n_sets, n_ways), dtype=torch.int32, device=dev)
    sets = (addr & (n_sets - 1)).to(torch.int64)
    order = torch.argsort(sets, stable=True)
    counts = torch.bincount(sets, minlength=n_sets)
    set_of = sets[order]
    rank = torch.arange(n, device=dev) - (torch.cumsum(counts, 0)
                                          - counts)[set_of]
    steps = int(counts.max())
    # (n_sets, steps): each set's addresses and clocks in trace order;
    # clock 0 marks a step the set does not take
    grid_addr = torch.zeros((n_sets, steps), dtype=torch.int32, device=dev)
    grid_clock = torch.zeros((n_sets, steps), dtype=torch.int32, device=dev)
    grid_addr[set_of, rank] = addr[order]
    grid_clock[set_of, rank] = (order + 1).to(torch.int32)
    grid_hit = torch.zeros((n_sets, steps), dtype=torch.int32, device=dev)
    rows = torch.arange(n_sets, device=dev)
    for k in range(steps):
        a, t = grid_addr[:, k], grid_clock[:, k]
        live = t > 0
        match = tags == a[:, None]
        hit = match.any(dim=1) & live
        way = torch.where(hit, match.to(torch.int32).argmax(dim=1),
                          use.argmin(dim=1))
        tags[rows, way] = torch.where(live, a, tags[rows, way])
        use[rows, way] = torch.where(live, t, use[rows, way])
        grid_hit[:, k] = hit.to(torch.int32)
    hits = torch.empty(n, dtype=torch.int32, device=dev)
    hits[order] = grid_hit[set_of, rank]
    return hits, tags, use


def _cache_sim_library() -> ctypes.CDLL:
    lib = build.load("cache_sim")
    lib.cache_sim_plan.argtypes = [_P] + [_I] * 4
    lib.cache_sim_plan.restype = _I
    lib.cache_sim.argtypes = [_P] * 7 + [_L] + [_I] * 5 + [_P]
    lib.cache_sim.restype = _I
    lib.cache_sim_error_string.argtypes = [_I]
    lib.cache_sim_error_string.restype = ctypes.c_char_p
    return lib


def cache_sim_bits(n_sets: int) -> int:
    """log2 of the chain count K6 splits a trace into: one set per chain up
    to ``2**MAX_CHAIN_BITS`` sets (2048 chains at the Table-I L2), then
    ``n_sets / 2**MAX_CHAIN_BITS`` sets per chain."""
    return min(n_sets.bit_length() - 1, MAX_CHAIN_BITS)


def cache_sim_tile(bits: int) -> int:
    """Trace entries per tile of K6's bucket pre-pass: at least 1024, and
    enough that the per-tile chain counts take no more room than the trace.

    K6's own rule: its scan runs across the chains' columns, so small tiles
    cost it little, and each scatter warp walks one tile.  The MESI
    kernels' rule (:func:`bucket_tile`) keeps the counts 32 times smaller
    than the trace, which at 2048 chains leaves a 2 M-access trace 32
    tiles, one scatter warp each."""
    return max(1024, 1 << bits)


CACHE_SIM_PLAN_FIELDS = ("bits", "warps_per_block", "blocks", "in_regs",
                         "in_smem", "smem_bytes", "sms")


def cache_sim_plan(n_sets: int, n_ways: int, device):
    """K6's launch shape on CUDA `device`: ``{field: int for field in
    CACHE_SIM_PLAN_FIELDS}`` (chain count ``2**bits``; where each chain
    keeps its sets: registers, shared memory, or the outputs)."""
    lib = _cache_sim_library()
    out = (ctypes.c_int * len(CACHE_SIM_PLAN_FIELDS))()
    rc = lib.cache_sim_plan(out, n_sets, n_ways, cache_sim_bits(n_sets),
                            _device_index(torch.device(device)))
    _raise_on(rc, "cache_sim_plan", lib.cache_sim_error_string)
    return dict(zip(CACHE_SIM_PLAN_FIELDS, out))


def _cache_sim_scratch(n: int, bits: int, device):
    """The pre-pass's buffers: ``(hist, start, rec, tile)``."""
    m, tile = 1 << bits, cache_sim_tile(bits)
    empty = functools.partial(torch.empty, dtype=torch.int32, device=device)
    return empty((-(-n // tile), m)), empty(m + 1), empty((n, 4)), tile


def _launch_cache_sim(addr: torch.Tensor, n_sets: int, n_ways: int):
    """The kernel itself, after :func:`_check_cache_sim`."""
    if n_ways > MAX_WAYS:
        raise ValueError(f"the kernel spans ways with one warp: n_ways "
                         f"must be <= {MAX_WAYS}, got {n_ways}")
    a32 = addr.contiguous()
    dev = addr.device
    n, bits = a32.shape[0], cache_sim_bits(n_sets)
    hist, start, rec, tile = _cache_sim_scratch(n, bits, dev)
    hits = torch.empty(n, dtype=torch.int32, device=dev)
    tags = torch.empty((n_sets, n_ways), dtype=torch.int32, device=dev)
    use = torch.empty((n_sets, n_ways), dtype=torch.int32, device=dev)
    lib = _cache_sim_library()
    rc = lib.cache_sim(
        a32.data_ptr(), hist.data_ptr(), start.data_ptr(), rec.data_ptr(),
        hits.data_ptr(), tags.data_ptr(), use.data_ptr(), n,
        n_sets, n_ways, bits, tile, _device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "cache_sim kernel", lib.cache_sim_error_string)
    LAUNCHES["cache_sim"] += 1
    return hits, tags, use


def cache_sim(addr: torch.Tensor, *, n_sets: int, n_ways: int,
              chunk: int = 512
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-level set-associative LRU cache over an (N,) line trace.

    ``addr`` is int32 and holds no negative address; ``n_sets`` must be a
    power of two.
    Returns ``(hits (N,) int32, tags (n_sets, n_ways) int32, use
    (n_sets, n_ways) int32)``: per-access hit flags, the final tags (-1 =
    empty) and the final use clocks (the 1-based position of each way's
    last access).  A CUDA ``addr`` launches the kernel ``csrc/cache_sim.cu``
    (or raises); a CPU ``addr`` runs :func:`cache_sim_ref`.  ``chunk`` (the
    JAX package's Pallas grid step) is accepted and ignored.
    """
    check_chunk(chunk)
    _check_cache_sim(addr, n_sets, n_ways)
    if addr.device.type == "cuda":
        return _launch_cache_sim(addr, n_sets, n_ways)
    if addr.device.type != "cpu":
        raise ValueError(f"cache_sim runs on CUDA or CPU tensors, got "
                         f"{addr.device}")
    return cache_sim_ref(addr, n_sets=n_sets, n_ways=n_ways)


def cache_sim_bound_bytes(n: int, n_sets: int, n_ways: int) -> int:
    """Bytes one call must move at least: the trace read and the hit flags
    written (4 B each per access), the final tags and clocks written."""
    return 8 * n + 8 * n_sets * n_ways
