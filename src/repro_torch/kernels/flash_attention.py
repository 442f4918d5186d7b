"""Blockwise causal / windowed attention (K5): the CUDA wrapper and its plain
version.

The port of the Pallas kernel ``flash_attention`` of the JAX package
(``src/repro/kernels/flash_attention.py:90``, its ``pallas_call`` at line
109): softmax attention with causal masking and an optional sliding window,
as the prefill of h2o-danube-3-4b (window 4096) runs it.

Shapes: ``q`` (B, H, Sq, D); ``k``, ``v`` (B, H, Sk, D) -> (B, H, Sq, D) in
``q.dtype``.  GQA is the caller's: heads are pre-broadcast, as the JAX
contract says.  Positions are end-aligned: query row r sits at
``r + Sk - Sq``.  Causal: key j is live for row r when ``j <= qpos``; with a
window W also when ``j > qpos - W``.  A row with no live key gives 0.
Logits are ``(q . k) * D**-0.5``, scaled after the product as the JAX
oracle ``repro.kernels.ref.flash_attention`` does (the Pallas body scales
``q`` first).  The JAX op's shape contract stands: ``Sq`` and ``Sk`` must be
multiples of ``min(128, S)``, or :class:`ValueError`.

:func:`flash_attention` dispatches on the device of ``q``: a CUDA tensor
launches a hand-written kernel of ``csrc/flash_attention.cu`` (built with
`nvcc` at first use, see :mod:`repro_torch.kernels.build`) or raises; a CPU
tensor runs :func:`flash_attention_ref`.  The library holds two variants,
and :func:`variant` picks one from the dtype and D alone: bf16 with
``D % 8 == 0`` goes to the tensor-core kernel (wgmma, TMA), f32 and any
other bf16 D to the CUDA-core kernel.  Both take D <= 128 (q, k and v of one
type) and accumulate in f32.  No variant is ever tried because the other
failed.

Bound: the larger of the bytes (q, k, v read and the output written once)
over 3.35 TB/s and the operations (4 * D flops per live (row, key) pair,
:func:`live_pairs`) over the card's peak for the type; see
:func:`bound_ms`.

The wrapper counts kernel launches of either variant
(``"flash_attention"``) and plain-version calls (``"flash_attention_ref"``)
in :data:`repro_torch.kernels.build.LAUNCHES`, and the launches of each
variant apart in :data:`VARIANT_LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import LAUNCHES

#: head_dim limit of the CUDA kernel
MAX_HEAD_DIM = 128
#: the JAX op's tile: Sq and Sk must be multiples of min(TILE, S)
TILE = 128
_MAX_HEADS = 65535
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: H100 SXM data sheet: device memory rate, and the peak rate of the
#: products for each input type (bf16 dense tensor cores, f32 CUDA cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
#: launches of each kernel variant (``LAUNCHES["flash_attention"]`` counts
#: them together)
VARIANT_LAUNCHES = {"tensor_cores": 0, "cuda_cores": 0}


def reset_variant_launches() -> None:
    """Set the count of each variant to 0."""
    for key in VARIANT_LAUNCHES:
        VARIANT_LAUNCHES[key] = 0


def variant(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that takes (dtype, head_dim): ``"tensor_cores"`` for bf16
    with ``head_dim % 8 == 0`` (TMA needs 16-byte rows, wgmma depths of 16
    are padded with zeros), ``"cuda_cores"`` otherwise (f32 is held to
    3e-5, which no tensor-core input type meets)."""
    if dtype == torch.bfloat16 and head_dim % 8 == 0:
        return "tensor_cores"
    return "cuda_cores"


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"q must be (B, H, Sq, D) and k, v (B, H, Sk, D); "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}")
    if v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    b, h, sq, d = q.shape
    if tuple(k.shape[:2]) != (b, h) or k.shape[3] != d:
        raise ValueError(f"k must be (B={b}, H={h}, Sk, D={d}), got "
                         f"{tuple(k.shape)}")
    sk = k.shape[2]
    if sq == 0 or sk == 0:
        raise ValueError(f"empty sequence: sq={sq} sk={sk}")
    bq, bk = min(TILE, sq), min(TILE, sk)
    if sq % bq != 0 or sk % bk != 0:
        raise ValueError(f"pad seq to block multiples: sq={sq} bq={bq} "
                         f"sk={sk} bk={bk}")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} must lie on {q.device}, got {x.device}")


def live_pairs(sq: int, sk: int, causal: bool = True,
               window: Optional[int] = None) -> int:
    """Live (query row, key) pairs of one head under the mask."""
    qpos = torch.arange(sq, dtype=torch.int64) + (sk - sq)
    hi = torch.clamp(qpos, max=sk - 1) if causal else \
        torch.full_like(qpos, sk - 1)
    lo = torch.clamp(qpos - window + 1, min=0) if window is not None else \
        torch.zeros_like(qpos)
    return int(torch.clamp(hi - lo + 1, min=0).sum())


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------
def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention` (same contract;
    `scale` defaults to ``D ** -0.5``, as the kernel's).

    The JAX oracle's arithmetic: f32 logits scaled after the product, a
    masked softmax with fully masked rows set to 0, an f32 value sum.
    """
    LAUNCHES["flash_attention_ref"] += 1
    sq, d = q.shape[-2:]
    sk = k.shape[-2]
    scale = d ** -0.5 if scale is None else scale
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits.masked_fill_(~mask, -math.inf)
    probs = torch.softmax(logits, dim=-1).nan_to_num_(nan=0.0)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    lib.flash_attention.argtypes = ([_P] * 4 + [_I] * 7 + [ctypes.c_float]
                                    + [_I] * 2 + [_P])
    lib.flash_attention.restype = _I
    lib.flash_attention_tc.argtypes = ([_P] * 4 + [_I] * 7 + [ctypes.c_float]
                                       + [_I] + [_P])
    lib.flash_attention_tc.restype = _I
    lib.flash_attention_error_string.argtypes = [_I]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """`x` contiguous and 16-byte aligned, as TMA reads it."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(q, k, v, causal: bool, window: Optional[int]) -> torch.Tensor:
    """The kernel itself, after :func:`_check`: the variant :func:`variant`
    picks."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{x.dtype}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError("q, k and v must share a dtype")
    if d > MAX_HEAD_DIM or b * h > _MAX_HEADS:
        raise ValueError(f"the kernel takes head_dim <= {MAX_HEAD_DIM} and "
                         f"B * H <= {_MAX_HEADS}; got {d} and {b * h}")
    # any window of at least Sq + Sk masks like an infinite one (and one of
    # at most -(Sq + Sk) like -infinity): clamp it into int32
    span = sq + sk
    win = 0 if window is None else max(-span, min(int(window), span))
    which = variant(q.dtype, d)
    q_c, k_c, v_c = (_aligned(x) for x in (q, k, v))
    out = torch.empty_like(q_c)
    device = q.device
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    stream = torch.cuda.current_stream(device).cuda_stream
    lib = _library()
    args = (q_c.data_ptr(), k_c.data_ptr(), v_c.data_ptr(), out.data_ptr(),
            b * h, sq, sk, d, int(bool(causal)), int(window is not None), win,
            d ** -0.5)
    if which == "tensor_cores":
        rc = lib.flash_attention_tc(*args, index, stream)
    else:
        rc = lib.flash_attention(*args, _DTYPES[q.dtype], index, stream)
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention kernel ({which}) failed: CUDA "
                           f"error {rc} ({msg})")
    LAUNCHES["flash_attention"] += 1
    VARIANT_LAUNCHES[which] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Blockwise attention. q (B,H,Sq,D); k,v (B,H,Sk,D) -> (B,H,Sq,D).

    A CUDA ``q`` launches the kernel (or raises); a CPU ``q`` runs
    :func:`flash_attention_ref`.
    """
    _check(q, k, v)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, window)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    return flash_attention_ref(q, k, v, causal=causal, window=window)


def bound_ms(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
             window: Optional[int] = None):
    """The least time one call can take on the card, in ms, and what sets
    it: ``(ms, "bytes" or "operations", bytes, flops)``.

    Bytes: q, k and v read and the output written, once each, over
    :data:`HBM_BYTES_PER_S`.  Operations: 4 * D flops per live (row, key)
    pair per head, over the peak rate for ``q.dtype`` (:data:`PEAK_FLOPS`).
    """
    b, h, sq, d = q.shape
    sk = k.shape[2]
    n_bytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    flops = 4 * d * b * h * live_pairs(sq, sk, causal, window)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[q.dtype] * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", n_bytes, flops)
