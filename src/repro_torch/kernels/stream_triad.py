"""STREAM triad (K7): the CUDA wrapper and its plain version.

The port of the Pallas kernel ``stream_triad`` of the JAX package
(``src/repro/kernels/stream_triad.py:26``, its ``pallas_call`` at line 42):
``a = b + s * c`` over two equal-shape (R, L) arrays, the bandwidth probe
of the STREAM benchmark that the §IV characterization is built on.

The contract is the JAX op's: ``b`` and ``c`` are equal-shape 2-D arrays
with ``R % 8 == 0`` (its row tile), or :class:`ValueError`; ``s`` is rounded
to the arrays' type before it is used (``jnp.asarray([s], b.dtype)``), so
``s = 0.1`` in bf16 is 0.10009765625.  The result has ``b``'s type.

:func:`stream_triad` dispatches on the device of ``b``: a CUDA tensor
launches the hand-written kernel ``csrc/stream_triad.cu`` (built with `nvcc`
at first use, see :mod:`repro_torch.kernels.build`) or raises; a CPU tensor
runs :func:`stream_triad_ref`.  The kernel takes f32 and bf16 and rounds
after the product and after the sum, as eager PyTorch does, so on the card
it equals the plain version bitwise.

Bound: bytes, ``3 * R * L * itemsize`` over 3.35 TB/s (:func:`bound_bytes`).

The wrapper counts kernel launches (``"stream_triad"``) and plain-version
calls (``"stream_triad_ref"``) in :data:`repro_torch.kernels.build.LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import LAUNCHES

#: the JAX op's row tile: R must be a multiple of it
BLOCK_ROWS = 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(b: torch.Tensor, c: torch.Tensor) -> None:
    if b.shape != c.shape or b.ndim != 2:
        raise ValueError(f"b and c must be equal-shape 2-D arrays, got "
                         f"{tuple(b.shape)} and {tuple(c.shape)}")
    if b.shape[0] % BLOCK_ROWS != 0:
        raise ValueError(f"pad rows to block multiple: rows={b.shape[0]} "
                         f"block_rows={BLOCK_ROWS}")
    if b.dtype != c.dtype:
        raise TypeError(f"b and c must share a dtype, got {b.dtype} and "
                        f"{c.dtype}")
    if b.device != c.device:
        raise ValueError(f"b lies on {b.device}, c on {c.device}")


def _rounded_scalar(s: float, dtype: torch.dtype) -> torch.Tensor:
    """``s`` rounded to `dtype`, as a 0-d CPU tensor."""
    return torch.tensor(s, dtype=dtype)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------
def stream_triad_ref(b: torch.Tensor, c: torch.Tensor, s) -> torch.Tensor:
    """Plain PyTorch version of :func:`stream_triad` (same contract):
    ``b + c * s`` in eager PyTorch, ``s`` rounded to ``b.dtype`` first."""
    LAUNCHES["stream_triad_ref"] += 1
    return b + c * _rounded_scalar(s, b.dtype)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("stream_triad")
    lib.stream_triad.argtypes = [_P, _P, _P, ctypes.c_float,
                                 ctypes.c_longlong, _I, _I, _P]
    lib.stream_triad.restype = _I
    lib.stream_triad_error_string.argtypes = [_I]
    lib.stream_triad_error_string.restype = ctypes.c_char_p
    return lib


def _launch(b: torch.Tensor, c: torch.Tensor, s) -> torch.Tensor:
    """The kernel itself, after :func:`_check`."""
    if b.dtype not in _DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got "
                        f"{b.dtype}")
    b_c, c_c = b.contiguous(), c.contiguous()
    out = torch.empty_like(b_c)
    device = b.device
    lib = _library()
    rc = lib.stream_triad(
        b_c.data_ptr(), c_c.data_ptr(), out.data_ptr(),
        float(_rounded_scalar(s, b.dtype)), b_c.numel(), _DTYPES[b.dtype],
        device.index if device.index is not None
        else torch.cuda.current_device(),
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stream_triad kernel failed: CUDA error {rc} "
                           f"({lib.stream_triad_error_string(rc).decode()})")
    LAUNCHES["stream_triad"] += 1
    return out


def stream_triad(b: torch.Tensor, c: torch.Tensor, s) -> torch.Tensor:
    """``a = b + s * c`` over equal-shape (R, L) arrays, R a multiple of 8.

    A CUDA ``b`` launches the kernel (or raises); a CPU ``b`` runs
    :func:`stream_triad_ref`.
    """
    _check(b, c)
    if b.device.type == "cuda":
        return _launch(b, c, s)
    if b.device.type != "cpu":
        raise ValueError(f"stream_triad runs on CUDA or CPU tensors, got "
                         f"{b.device}")
    return stream_triad_ref(b, c, s)


def bound_bytes(b: torch.Tensor) -> int:
    """Bytes one call must move at least: b and c read, a written, once."""
    return 3 * b.numel() * b.element_size()
