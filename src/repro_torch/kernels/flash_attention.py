"""Blockwise causal / windowed attention (K5): the CUDA wrapper and its plain
version.

The port of the Pallas kernel ``flash_attention`` of the JAX package
(``src/repro/kernels/flash_attention.py:90``, its ``pallas_call`` at line
109): softmax attention with causal masking and an optional sliding window,
as the prefill of h2o-danube-3-4b (window 4096) runs it.

Shapes: ``q`` (B, H, Sq, D); ``k`` (B, K, Sk, D), ``v`` (B, K, Sk, Dv) ->
(B, H, Sq, Dv) in ``q.dtype``, with H a multiple of K: query head h reads
KV head ``h // (H // K)`` (the JAX contract's pre-broadcast heads are
K = H).  Positions are end-aligned: query row r sits at ``r + Sk - Sq``.
Causal: key j is live for row r when ``j <= qpos``; with a window W also
when ``j > qpos - W``.  A row with no live key gives 0.  Logits are
``(q . k) * D**-0.5``, scaled after the product as the JAX oracle
``repro.kernels.ref.flash_attention`` does (the Pallas body scales ``q``
first).  Optional ``sinks`` (H,), an f32 logit per query head, take softmax
mass and add no value (MiMo-V2-Flash's window layers).  The JAX op's shape
contract stands: ``Sq`` and ``Sk`` must be multiples of ``min(128, S)``, or
:class:`ValueError`.

:func:`flash_attention` dispatches on the device of ``q``: a CUDA tensor
launches a hand-written kernel of ``csrc/flash_attention.cu`` (built with
`nvcc` at first use, see :mod:`repro_torch.kernels.build`) or raises; a CPU
tensor runs :func:`flash_attention_ref`.  The library holds two variants,
the tensor-core one compiled in two forms, and :func:`variant` picks one
from the dtype, the widths and whether there are sinks alone: bf16 with
D % 8 == 0, D <= 128, v as wide and no sinks goes to the tensor-core
kernel's first form (``"tensor_cores"``, wgmma, TMA; K and V broadcast to
the query heads beforehand); bf16 with D <= 192 and Dv <= 128, both
multiples of 8, otherwise to its second form (``"tensor_cores_own_v"``:
V's own width, KV heads read in place, sinks); f32 and any other bf16 D to
the CUDA-core kernel, which takes D <= 128, v as wide and no sinks.  All
accumulate in f32.  No variant is ever tried because another failed.

Bound: the larger of the bytes (q, k, v read and the output written once)
over 3.35 TB/s and the operations (2 * (D + Dv) flops per live (row, key)
pair, :func:`live_pairs`) over the card's peak for the type; see
:func:`bound_ms`.

The wrapper counts kernel launches of any variant (``"flash_attention"``),
those with sinks (``"flash_attention_sinks"``) and plain-version calls
(``"flash_attention_ref"``, ``"flash_attention_sinks_ref"``) in
:data:`repro_torch.kernels.build.LAUNCHES`, and the launches of each
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

#: head_dim limit of the CUDA-core kernel and the tensor-core kernel's
#: first form
MAX_HEAD_DIM = 128
#: the tensor-core kernel's second form: q / k and v width limits
MAX_QK_DIM = 192
MAX_V_DIM = 128
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
VARIANT_LAUNCHES = {"tensor_cores": 0, "tensor_cores_own_v": 0,
                    "cuda_cores": 0}


def reset_variant_launches() -> None:
    """Set the count of each variant to 0."""
    for key in VARIANT_LAUNCHES:
        VARIANT_LAUNCHES[key] = 0


def variant(dtype: torch.dtype, head_dim: int, v_dim: Optional[int] = None,
            sinks: bool = False) -> str:
    """The kernel that takes (dtype, q/k width, v width, sinks), v as wide
    as q by default.  For bf16 with both widths multiples of 8 (TMA needs
    16-byte rows, wgmma depths of 16 are padded with zeros):
    ``"tensor_cores"`` where v is as wide as q, up to
    :data:`MAX_HEAD_DIM`, with no sinks; else ``"tensor_cores_own_v"``
    where q / k are up to :data:`MAX_QK_DIM` and v up to
    :data:`MAX_V_DIM`.  ``"cuda_cores"`` otherwise (f32 is held to 3e-5,
    which no tensor-core input type meets); it takes D <= 128, v as wide
    and no sinks, and the wrapper refuses the rest."""
    v_dim = head_dim if v_dim is None else v_dim
    if dtype == torch.bfloat16 and head_dim % 8 == 0 and v_dim % 8 == 0:
        if v_dim == head_dim and not sinks and head_dim <= MAX_HEAD_DIM:
            return "tensor_cores"
        if head_dim <= MAX_QK_DIM and v_dim <= MAX_V_DIM:
            return "tensor_cores_own_v"
    return "cuda_cores"


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           sinks: Optional[torch.Tensor] = None) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q must be (B, H, Sq, D), k (B, K, Sk, D) and v "
                         f"(B, K, Sk, Dv); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if v.shape[:3] != k.shape[:3]:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ "
                         f"in (B, K, Sk)")
    b, h, sq, d = q.shape
    kh = k.shape[1]
    if k.shape[0] != b or k.shape[3] != d or kh == 0 or h % kh != 0:
        raise ValueError(f"k must be (B={b}, K, Sk, D={d}) with H={h} a "
                         f"multiple of K, got {tuple(k.shape)}")
    if sinks is not None and (sinks.shape != (h,)
                              or sinks.device != q.device):
        raise ValueError(f"sinks must be ({h},) on {q.device}, got "
                         f"{tuple(sinks.shape)} on {sinks.device}")
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
                        scale: Optional[float] = None,
                        sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention` (same contract;
    `scale` defaults to ``D ** -0.5``, as the kernel's).

    The JAX oracle's arithmetic: f32 logits scaled after the product, a
    masked softmax with fully masked rows set to 0, an f32 value sum.  KV
    heads are broadcast to the query heads; `sinks` join each row's softmax
    as one more logit that carries no value.
    """
    LAUNCHES["flash_attention_ref"] += 1
    LAUNCHES["flash_attention_sinks_ref"] += sinks is not None
    h, sq, d = q.shape[1:]
    sk = k.shape[-2]
    g = h // k.shape[1]
    if g > 1:
        k, v = (x.repeat_interleave(g, dim=1) for x in (k, v))
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
    if sinks is None:
        probs = torch.softmax(logits, dim=-1).nan_to_num_(nan=0.0)
    else:
        sink = sinks.float().reshape(1, h, 1, 1).expand(*logits.shape[:3], 1)
        probs = torch.softmax(torch.cat([logits, sink], dim=-1),
                              dim=-1)[..., :sk]
        # a row with no live key gives 0, as without sinks
        probs = probs.masked_fill(~mask.any(dim=-1)[:, None], 0.0)
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
    lib.flash_attention_tc_own_v.argtypes = ([_P] * 4 + [_I] * 10
                                             + [ctypes.c_float, _P, _I, _P])
    lib.flash_attention_tc_own_v.restype = _I
    lib.flash_attention_error_string.argtypes = [_I]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """`x` contiguous and 16-byte aligned, as TMA reads it."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(q, k, v, causal: bool, window: Optional[int],
            sinks: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernel itself, after :func:`_check`: the variant :func:`variant`
    picks.  The first tensor-core form and the CUDA-core kernel read K and
    V broadcast to the query heads; the second form reads them in place."""
    b, h, sq, d = q.shape
    kh, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{x.dtype}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError("q, k and v must share a dtype")
    which = variant(q.dtype, d, dv, sinks is not None)
    if which == "cuda_cores" and (d > MAX_HEAD_DIM or dv != d
                                  or sinks is not None):
        raise ValueError(f"the kernel takes head_dim <= {MAX_HEAD_DIM} "
                         f"with v as wide and no sinks (bf16: head_dim <= "
                         f"{MAX_QK_DIM}, v <= {MAX_V_DIM}, multiples of 8); "
                         f"got {d}, v {dv}, sinks {sinks is not None}")
    if b * h > _MAX_HEADS:
        raise ValueError(f"the kernel takes B * H <= {_MAX_HEADS}; got "
                         f"{b * h}")
    # any window of at least Sq + Sk masks like an infinite one (and one of
    # at most -(Sq + Sk) like -infinity): clamp it into int32
    span = sq + sk
    win = 0 if window is None else max(-span, min(int(window), span))
    if which != "tensor_cores_own_v" and kh != h:
        k, v = (x.repeat_interleave(h // kh, dim=1) for x in (k, v))
    q_c, k_c, v_c = (_aligned(x) for x in (q, k, v))
    out = q_c.new_empty((b, h, sq, dv))
    device = q.device
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    stream = torch.cuda.current_stream(device).cuda_stream
    lib = _library()
    tensors = (q_c.data_ptr(), k_c.data_ptr(), v_c.data_ptr(),
               out.data_ptr(), b * h, sq, sk, d)
    band = (int(bool(causal)), int(window is not None), win, d ** -0.5)
    if which == "tensor_cores_own_v":
        s_c = None if sinks is None else sinks.float().contiguous()
        rc = lib.flash_attention_tc_own_v(
            *tensors, dv, h // kh, h, *band,
            None if s_c is None else s_c.data_ptr(), index, stream)
    elif which == "tensor_cores":
        rc = lib.flash_attention_tc(*tensors, *band, index, stream)
    else:
        rc = lib.flash_attention(*tensors, *band, _DTYPES[q.dtype], index,
                                 stream)
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention kernel ({which}) failed: CUDA "
                           f"error {rc} ({msg})")
    LAUNCHES["flash_attention"] += 1
    LAUNCHES["flash_attention_sinks"] += sinks is not None
    VARIANT_LAUNCHES[which] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Blockwise attention. q (B,H,Sq,D); k (B,K,Sk,D), v (B,K,Sk,Dv) ->
    (B,H,Sq,Dv); `sinks` (H,) or None.

    A CUDA ``q`` launches the kernel (or raises); a CPU ``q`` runs
    :func:`flash_attention_ref`.
    """
    _check(q, k, v, sinks)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, window, sinks)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    return flash_attention_ref(q, k, v, causal=causal, window=window,
                               sinks=sinks)


def bound_ms(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
             window: Optional[int] = None, v: Optional[torch.Tensor] = None):
    """The least time one call can take on the card, in ms, and what sets
    it: ``(ms, "bytes" or "operations", bytes, flops)``; `v` defaults to a
    tensor of k's shape.

    Bytes: q, k and v read and the (B, H, Sq, Dv) output written, once
    each, over :data:`HBM_BYTES_PER_S`.  Operations: 2 * (D + Dv) flops per
    live (row, key) pair per query head (the logit and the value sum), over
    the peak rate for ``q.dtype`` (:data:`PEAK_FLOPS`).
    """
    b, h, sq, d = q.shape
    sk = k.shape[2]
    v_numel, dv = (k.numel(), d) if v is None else (v.numel(), v.shape[3])
    n_bytes = (q.numel() + k.numel() + v_numel
               + b * h * sq * dv) * q.element_size()
    flops = 2 * (d + dv) * b * h * live_pairs(sq, sk, causal, window)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[q.dtype] * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", n_bytes, flops)
