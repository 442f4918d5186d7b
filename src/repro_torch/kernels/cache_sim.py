"""The two-level MESI + tier cache kernel: CUDA wrapper and plain version.

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

``LAUNCHES`` counts kernel launches (``"mesi_segment"``) and plain-version
calls (``"mesi_segment_ref"``) since :func:`reset_launches`.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.cache import (
    SENTINEL, CacheParams, CacheState, _packed_step, init_batch_carry,
    nstats, unpack_state,
)
from repro_torch.kernels import build

BACKENDS = ("reference", "cuda")

LAUNCHES: Dict[str, int] = {"mesi_segment": 0, "mesi_segment_ref": 0}


def reset_launches() -> None:
    """Set every launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def resolve_backend(backend: Optional[str], device: torch.device) -> str:
    """The backend a call runs on: ``None`` follows the tensor's device."""
    if backend is None:
        return "cuda" if device.type == "cuda" else "reference"
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


def _library() -> ctypes.CDLL:
    lib = build.load("mesi")
    lib.mesi_segment.argtypes = [_P] * 8 + [_I] * 9 + [_P]
    lib.mesi_segment.restype = _I
    lib.mesi_error_string.argtypes = [_I]
    lib.mesi_error_string.restype = ctypes.c_char_p
    return lib


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
    l1p, l2p, stats, t = (x.clone() for x in carry)
    b, n = addr.shape
    lib = _library()
    device = addr.device
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.mesi_segment(
        addr.data_ptr(), is_write.data_ptr(), core.data_ptr(),
        tier.data_ptr(), t.data_ptr(), l1p.data_ptr(), l2p.data_ptr(),
        stats.data_ptr(), b, n, params.cores, params.l1_sets,
        params.l1_ways, params.l2_sets, params.l2_ways, params.n_targets,
        device.index if device.index is not None else
        torch.cuda.current_device(), stream)
    if rc != 0:
        raise RuntimeError(f"mesi_segment kernel failed: CUDA error {rc} "
                           f"({lib.mesi_error_string(rc).decode()})")
    LAUNCHES["mesi_segment"] += 1
    return l1p, l2p, stats, t + n


def _as_int32(*xs: torch.Tensor):
    return tuple(x.to(torch.int32).contiguous() for x in xs)


def mesi_segment(carry, addr, is_write, core, tier, *,
                 params: CacheParams, backend: Optional[str] = None):
    """Advance the packed batch carry over one (B, N) trace segment.

    Args:
      carry: ``(l1p, l2p, stats, t)`` — (B, cores, s1, w1, 3),
        (B, s2, w2, 5), (B, nstats) and (B,) int32, as
        :func:`repro_torch.core.cache.init_batch_carry` builds it.
      addr: (B, N) line addresses; :data:`SENTINEL` marks padding.
      is_write/core/tier: (B, N) integer tensors on the same device.
      params: cache geometry.
      backend: ``None`` (follow the device), ``"reference"`` or ``"cuda"``.

    Returns the advanced carry (new tensors; the input is unchanged).  The
    clock advances by N.
    """
    if addr.ndim != 2:
        raise ValueError("mesi_segment expects a (B, N) batch")
    backend = resolve_backend(backend, addr.device)
    addr, is_write, core, tier = _as_int32(addr, is_write, core, tier)
    if backend == "reference":
        return mesi_segment_ref(carry, addr, is_write, core, tier,
                                params=params)
    return _launch(carry, addr, is_write, core, tier, params)


def mesi_cache_sim(addr, is_write, core, tier, *, params: CacheParams,
                   backend: Optional[str] = None
                   ) -> Tuple[torch.Tensor, CacheState]:
    """Two-level MESI + tier simulation of a (B, N) trace batch.

    :func:`mesi_segment` from a fresh carry.  Returns
    ``(stats (B, nstats(params.n_targets)) int32, batched CacheState)``.
    """
    if addr.ndim != 2:
        raise ValueError("mesi_cache_sim expects a (B, N) batch")
    carry = init_batch_carry(params, addr.shape[0], device=addr.device)
    l1p, l2p, stats, _ = mesi_segment(carry, addr, is_write, core, tier,
                                      params=params, backend=backend)
    return stats, unpack_state(l1p, l2p)
