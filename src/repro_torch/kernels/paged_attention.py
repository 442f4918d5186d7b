"""Paged-KV decode attention (K4): the CUDA wrapper and its plain version.

The port of the Pallas kernel ``paged_attention`` of the JAX package
(``src/repro/kernels/paged_attention.py:76``, its ``pallas_call`` at line
93): decode attention for one new token per sequence against KV that lives
in fixed-size pages of a global pool, addressed through a per-sequence
block table — the layout of the tier-aware paged KV cache
(:mod:`repro_torch.memory.kvcache`).

Shapes: ``q`` (B, H, D); ``k_pages`` (P, page, K, D); ``v_pages`` (P,
page, K, W), rows of their own width W <= D (W = D for the JAX package's
pools); ``block_table`` (B, nblk) int32; ``context_lens`` (B,) int32 ->
(B, H, Dv) in ``q.dtype``, the values being the first ``Dv = v_dim``
(default W) columns of the V rows.  GQA: ``H % K == 0``, query head h
reads kv head ``h // (H / K)``.  Positions ``>= context_lens[b]`` are
masked; an empty context gives 0.  Logits are ``(q . k) * scale``
(default ``D**-0.5``), scaled after the product as the JAX oracle
``repro.kernels.ref.paged_attention`` does (the Pallas body scales ``q``
first).  Optional ``sinks`` (H,) f32, a logit per query head, take softmax
mass and add no value (MiMo-V2-Flash's window layers): ``out = sum_p
e^(s_p) v_p / (sum_p e^(s_p) + e^(sink))``, added once where the
partitions are combined.

MLA's absorbed decode over the latent pool is the case K = 1, H = 128,
D = 576 (the latent and the rope key), Dv = 512 (the latent), with
``v_pages`` the same tensor as ``k_pages``: the kernel then reads each row
once, as keys and as values, and takes the model's softmax scale.

Block-table entries past the live ones (``j >= ceil(ctx / page)``) are
padding and may hold any value: the kernel never reads them, and the plain
version masks them to page 0 before it gathers, so the two agree on padded
tables.  The wrapper checks the live entries against ``P`` and raises on an
out-of-range one.

:func:`paged_attention` dispatches on the device of ``q``: a CUDA tensor
launches the hand-written kernel ``csrc/paged_attention.cu`` (built with
`nvcc` at first use, see :mod:`repro_torch.kernels.build`) or raises; a
CPU tensor runs :func:`paged_attention_ref`.  The kernel takes f32 and
bf16 ``q`` and pools and accumulates in f32.

Bound (the least time on the card): bytes.  Each live position's K and V
rows of each kv head are read once (``sum_b ctx_b * K * 2 * D`` elements),
``q`` read and the output written once, plus the live table entries and
the lengths, over 3.35 TB/s; see :func:`bound_bytes`.  At the serve shapes
(B = 8, H = 32, K = 8, D = 120, contexts ~64) that is well under a
microsecond and the kernel is launch-bound; at a 4096-token context
(B = 8, f32 pools) it is 252 MB, about 75 us.  Design (flash-decoding,
see the source note): each (kv head, sequence) context split into
partitions, one block each per ``HEAD_BLOCK`` query heads of the kv head
(:func:`split_plan` picks them from the shapes and the card's occupancy:
one partition at the serve shapes), tiles of 32
positions double-buffered by ``cp.async``, and where there are several
partitions a second pass that combines them in a fixed order.

A second launch entry, :func:`decode_attention`, runs the kernel over the
dense per-sequence caches of a model's decode step, (B, S, K, D) each: the
caches are viewed, not copied, as a pool of ``B * S / page`` pages read
through an identity block table (:func:`dense_pages`).  It skips the
wrapper's check, which reads the table back to the host, so it can be
captured into a CUDA graph.

The wrappers count kernel launches (``"paged_attention"``, and
``"decode_attention"`` for the dense entry) and plain-version calls
(``"paged_attention_ref"``) in :data:`repro_torch.kernels.build.LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import LAUNCHES

#: key width limit of the CUDA kernel; its blocks take at most
#: ``HEAD_BLOCK`` query heads of one kv head, and ``HEAD_BLOCK * Dv`` at
#: most ``MAX_BLOCK_ELEMS`` accumulated elements
MAX_HEAD_DIM = 576
HEAD_BLOCK = 16
MAX_BLOCK_ELEMS = 8192
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: positions per tile of the kernel
TILE = 32
#: no partition of a context is shorter than this
MIN_PARTITION = 256
#: the split prefers at least this many partition blocks per SM
FILL = 2
#: page sizes :func:`dense_layout` tries on a dense cache, largest first
DENSE_PAGES = (16, 8, 4, 2, 1)
#: cache shapes whose block tables :func:`dense_layout` keeps
DENSE_LAYOUTS = 16


def split_plan(b: int, kv_heads: int, capacity: int, page: int, sms: int,
               resident: int = 2) -> tuple:
    """``(parts, part_len)``: how the kernel cuts each context of at most
    `capacity` (= nblk * page) positions, on a card of `sms` SMs that each
    hold `resident` partition blocks at once.

    A partition is a whole number of tiles and pages and at least
    ``MIN_PARTITION`` positions; ``parts * part_len >= capacity``.  The
    ``b * kv_heads * parts`` blocks run in waves of ``sms * resident``, so
    the busiest SM walks about ``waves * part_len / TILE`` tiles: the plan
    takes the fewest such tiles among the splits that give at least
    ``FILL * sms`` blocks (all splits where none does), and of those the
    fewest partitions.  A capacity that fits in the shortest partition gets
    one partition (no combine pass).
    """
    unit = math.lcm(page, TILE)
    whole = -(-max(capacity, 1) // unit) * unit
    shortest = -(-MIN_PARTITION // unit) * unit
    pairs = b * kv_heads
    if whole <= shortest or pairs == 0:
        return 1, whole
    best = None
    for s in range(1, -(-capacity // shortest) + 1):
        part_len = max(shortest, -(-capacity // (s * unit)) * unit)
        parts = -(-capacity // part_len)
        blocks = pairs * parts
        waves = -(-blocks // (sms * max(resident, 1)))
        key = (blocks < FILL * sms, waves * (part_len // TILE), parts)
        if best is None or key < best[0]:
            best = key, parts, part_len
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def n_live_blocks(context_lens: torch.Tensor, page: int, nblk: int
                  ) -> torch.Tensor:
    """Live block-table entries per sequence: ``ceil(ctx / page)``, clamped
    to [0, nblk]."""
    ctx = context_lens.to(torch.int64).clamp(min=0)
    return ((ctx + page - 1) // page).clamp(max=nblk)


def live_mask(block_table: torch.Tensor, context_lens: torch.Tensor,
              page: int) -> torch.Tensor:
    """(B, nblk) bool: which block-table entries are live."""
    nblk = block_table.shape[1]
    j = torch.arange(nblk, device=block_table.device)
    return j[None, :] < n_live_blocks(context_lens, page, nblk)[:, None]


def takes(h: int, kv_heads: int, d: int, dv: int) -> bool:
    """Whether the kernel takes these widths: `h` query heads over
    `kv_heads`, keys `d` wide, values the leading `dv` columns; at most
    ``MAX_HEAD_DIM`` wide and ``MAX_BLOCK_ELEMS`` values in a block of
    ``HEAD_BLOCK`` query heads."""
    return (kv_heads > 0 and h % kv_heads == 0 and 0 < dv <= d <= MAX_HEAD_DIM
            and min(h // kv_heads, HEAD_BLOCK) * dv <= MAX_BLOCK_ELEMS)


def head_blocks(h: int, kv_heads: int) -> int:
    """Blocks of at most ``HEAD_BLOCK`` query heads per kv head."""
    return -(-(h // kv_heads) // HEAD_BLOCK)


def _check(q, k_pages, v_pages, block_table, context_lens, v_dim,
           sinks=None) -> None:
    if q.ndim != 3 or k_pages.ndim != 4 or v_pages.ndim != 4:
        raise ValueError(f"q must be (B, H, D) and the pools (P, page, K, D);"
                         f" got {tuple(q.shape)} and {tuple(k_pages.shape)}")
    b, h, d = q.shape
    p_, page, kh, dk = k_pages.shape
    if v_pages.shape[:3] != k_pages.shape[:3] or v_pages.shape[3] > dk:
        raise ValueError(f"k_pages {tuple(k_pages.shape)} and v_pages "
                         f"{tuple(v_pages.shape)} differ")
    if dk != d:
        raise ValueError(f"head_dim of q ({d}) and the pools ({dk}) differ")
    if not 0 < v_dim <= v_pages.shape[3]:
        raise ValueError(f"v_dim must lie in [1, {v_pages.shape[3]}], got "
                         f"{v_dim}")
    if sinks is not None and (tuple(sinks.shape) != (h,)
                              or sinks.dtype != torch.float32):
        raise ValueError(f"sinks must be float32 (H={h},), got "
                         f"{sinks.dtype} {tuple(sinks.shape)}")
    if h % kh != 0:
        raise ValueError(f"q heads {h} must be a multiple of kv heads {kh}")
    if block_table.ndim != 2 or block_table.shape[0] != b:
        raise ValueError(f"block_table must be (B={b}, nblk), got "
                         f"{tuple(block_table.shape)}")
    if tuple(context_lens.shape) != (b,):
        raise ValueError(f"context_lens must be (B={b},), got "
                         f"{tuple(context_lens.shape)}")
    # one host sync: a masked `any`, not a gather of the live ids
    bad = (block_table < 0) | (block_table >= p_)
    if bool((bad & live_mask(block_table, context_lens, page)).any()):
        raise ValueError(f"a live block-table entry lies outside the pool's "
                         f"{p_} pages")


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------
def paged_attention_ref(q, k_pages, v_pages, block_table, context_lens,
                        *, scale: Optional[float] = None,
                        v_dim: Optional[int] = None,
                        sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`paged_attention` (same contract;
    `scale` defaults to ``D ** -0.5`` and `v_dim` to the V rows' width, as
    the kernel's).

    The JAX oracle's arithmetic: gather every page of the block table
    (padded entries masked to page 0 first), f32 logits scaled after the
    product, a masked softmax with empty rows set to 0, f32 value sum;
    with `sinks`, the softmax over the logits and the head's sink.
    """
    LAUNCHES["paged_attention_ref"] += 1
    if sinks is not None:
        LAUNCHES["attention_sinks_ref"] += 1
    b, h, d = q.shape
    _, page, kh, _ = k_pages.shape
    nblk = block_table.shape[1]
    groups = h // kh
    bt = torch.where(live_mask(block_table, context_lens, page),
                     block_table.to(torch.int64), 0)
    dv = v_pages.shape[-1] if v_dim is None else v_dim
    k = k_pages[bt].reshape(b, nblk * page, kh, d)     # (B, S, K, D)
    v = v_pages[bt][..., :dv].reshape(b, nblk * page, kh, dv)
    qf = q.reshape(b, kh, groups, d).to(torch.float32)
    scale = d ** -0.5 if scale is None else scale
    logits = torch.einsum("bkgd,bskd->bkgs", qf, k.to(torch.float32)) * scale
    pos = torch.arange(nblk * page, device=q.device)[None, None, None, :]
    mask = pos < context_lens.to(q.device)[:, None, None, None]
    logits = torch.where(mask, logits, -math.inf)
    if sinks is not None:
        sink = sinks.to(torch.float32).reshape(1, kh, groups, 1)
        logits = torch.cat([logits, sink.expand(b, kh, groups, 1)], dim=-1)
        probs = torch.softmax(logits, dim=-1)[..., :nblk * page]
    else:
        probs = torch.nan_to_num(torch.softmax(logits, dim=-1), nan=0.0)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v.to(torch.float32))
    return out.reshape(b, h, dv).to(q.dtype)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    lib.paged_attention.argtypes = ([_P] * 8 + [_I] * 8 + [ctypes.c_float]
                                    + [_I] * 6 + [_P])
    lib.paged_attention.restype = _I
    lib.paged_attention_resident.argtypes = [_P] + [_I] * 11
    lib.paged_attention_resident.restype = _I
    lib.paged_attention_error_string.argtypes = [_I]
    lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q, k_pages, v_pages, block_table, context_lens, scale=None,
            v_dim=None, sinks=None) -> torch.Tensor:
    """The kernel itself, without :func:`_check`'s validation and without
    counting the launch."""
    b, h, d = q.shape
    dv = v_pages.shape[-1] if v_dim is None else v_dim
    _, page, kh, _ = k_pages.shape
    device = q.device
    inputs = [("k_pages", k_pages), ("v_pages", v_pages),
              ("block_table", block_table), ("context_lens", context_lens)]
    for name, x in inputs + ([] if sinks is None else [("sinks", sinks)]):
        if x.device != device:
            raise ValueError(f"{name} must lie on {device}, got {x.device}")
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if x.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{x.dtype}")
    if k_pages.dtype != v_pages.dtype:
        raise TypeError("k_pages and v_pages must share a dtype")
    if not takes(h, kh, d, dv):
        raise ValueError(f"the kernel takes head_dim <= {MAX_HEAD_DIM} and "
                         f"<= {MAX_BLOCK_ELEMS} values in a block of "
                         f"{HEAD_BLOCK} query heads; got {d} and "
                         f"{min(h // kh, HEAD_BLOCK)} x {dv}")
    shared = v_dim is not None and v_pages is k_pages
    q_c, k_c = q.contiguous(), k_pages.contiguous()
    v_c = k_c if shared else v_pages.contiguous()
    bt = block_table.to(torch.int32).contiguous()
    cl = context_lens.to(torch.int32).contiguous()
    sk = None if sinks is None else sinks.to(torch.float32).contiguous()
    out = torch.empty((b, h, dv), dtype=q.dtype, device=device)
    plan = launch_plan(q_c, k_c, v_c, bt, v_dim, sk)
    # (m, l, acc) of every partition of every (sequence, head), in f32
    ws = torch.empty((b, h, plan["parts"], dv + 2), dtype=torch.float32,
                     device=device) if plan["parts"] > 1 else None
    lib = _library()
    rc = lib.paged_attention(
        q_c.data_ptr(), k_c.data_ptr(), v_c.data_ptr(), bt.data_ptr(),
        cl.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
        None if sk is None else sk.data_ptr(),
        b, h, d, page, kh, bt.shape[1], plan["part_len"], plan["parts"],
        d ** -0.5 if scale is None else scale, _DTYPES[q.dtype],
        _DTYPES[k_pages.dtype], dv, v_c.shape[-1], int(shared),
        _device_index(device), torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel failed: CUDA error {rc} "
                           f"({lib.paged_attention_error_string(rc).decode()})")
    return out


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


@functools.lru_cache(maxsize=None)
def _resident(h, d, kh, q_dtype, kv_dtype, aligned, index, dv, shared,
              v_row, sinks) -> int:
    """Partition blocks an SM of card `index` holds at once (the CUDA
    occupancy of the kernel variant these shapes and dtypes launch)."""
    lib = _library()
    out = ctypes.c_int(0)
    rc = lib.paged_attention_resident(ctypes.byref(out), h, d, kh, aligned,
                                      q_dtype, kv_dtype, dv, shared, v_row,
                                      sinks, index)
    if rc != 0:
        raise RuntimeError(
            f"paged_attention_resident failed: CUDA error {rc} "
            f"({lib.paged_attention_error_string(rc).decode()})")
    return out.value


@functools.lru_cache(maxsize=1024)
def _plan(b, h, d, kh, page, nblk, q_dtype, kv_dtype, aligned, index, dv,
          shared, v_row, sinks):
    """(parts, part_len, resident) of a call, cached by its shapes."""
    resident = _resident(h, d, kh, q_dtype, kv_dtype, aligned, index, dv,
                         shared, v_row, sinks)
    parts, part_len = split_plan(b, kh * head_blocks(h, kh), nblk * page,
                                 page, _sm_count(index), resident)
    return parts, part_len, resident


def launch_plan(q, k_pages, v_pages, block_table, v_dim=None,
                sinks=None) -> dict:
    """How the kernel splits a CUDA call: ``{"parts", "part_len",
    "blocks", "resident"}`` (blocks of the partition pass, and how many an
    SM holds at once).  With `v_dim` given and ``v_pages`` the same tensor
    as ``k_pages``, the kernel reads each row once, as keys and values."""
    b, h, d = q.shape
    _, page, kh, _ = k_pages.shape
    shared = v_dim is not None and v_pages is k_pages
    aligned = int(k_pages.data_ptr() % 16 == 0
                  and v_pages.data_ptr() % 16 == 0)
    parts, part_len, resident = _plan(
        b, h, d, kh, page, block_table.shape[1], _DTYPES[q.dtype],
        _DTYPES[k_pages.dtype], aligned, _device_index(q.device),
        v_pages.shape[-1] if v_dim is None else v_dim, int(shared),
        v_pages.shape[-1], int(sinks is not None))
    return dict(parts=parts, part_len=part_len,
                blocks=kh * head_blocks(h, kh) * b * parts,
                resident=resident)


def paged_attention(q, k_pages, v_pages, block_table, context_lens, *,
                    scale: Optional[float] = None,
                    v_dim: Optional[int] = None,
                    sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode attention over a paged KV pool.

    Shapes: q (B,H,D); k_pages (P, page, K, D), v_pages (P, page, K, W);
    block_table (B, nblk) int32; context_lens (B,) int32; sinks (H,) f32
    or None -> out (B,H,Dv) in q.dtype, ``Dv = v_dim`` (default W) the
    leading columns of the V rows; the logits scaled by `scale` (default
    ``D ** -0.5``).  A CUDA ``q`` launches the kernel (or raises); a CPU
    ``q`` runs :func:`paged_attention_ref`.
    """
    _check(q, k_pages, v_pages, block_table, context_lens,
           v_pages.shape[-1] if v_dim is None else v_dim, sinks)
    if q.device.type == "cuda":
        out = _launch(q, k_pages, v_pages, block_table, context_lens, scale,
                      v_dim, sinks)
        LAUNCHES["paged_attention"] += 1
        LAUNCHES["attention_sinks"] += sinks is not None
        return out
    if q.device.type != "cpu":
        raise ValueError(f"paged_attention runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    return paged_attention_ref(q, k_pages, v_pages, block_table,
                               context_lens, scale=scale, v_dim=v_dim,
                               sinks=sinks)


def dense_layout(b: int, s: int, device) -> tuple:
    """``(page, block_table)`` that view `b` dense caches of `s` slots as
    a pool of ``b * s / page`` pages: the largest page of
    :data:`DENSE_PAGES` dividing `s`, and the identity table (sequence i
    holds pages ``i * nblk .. i * nblk + nblk - 1``), int32 on `device`.

    A pure function of the shape, built once and kept for the last
    :data:`DENSE_LAYOUTS` shapes (``cuda`` is read as the current card, so
    it and ``cuda:<n>`` share a table).  Its build may not fall inside a
    CUDA graph capture, which would record the table's fill instead of
    running it: the eager step before the capture builds it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _dense_layout(b, s, dev)


@functools.lru_cache(maxsize=DENSE_LAYOUTS)
def _dense_layout(b: int, s: int, dev: torch.device) -> tuple:
    if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("dense_layout: build the table before a capture "
                           "(run the step once eagerly)")
    page = next(p for p in DENSE_PAGES if s % p == 0)
    nblk = s // page
    table = torch.arange(b * nblk, dtype=torch.int32, device=dev)
    return page, table.reshape(b, nblk)


def dense_pages(k_cache, v_cache, context_lens) -> tuple:
    """Dense caches (B, S, K, D), slot j of sequence b at ``[b, j]``, and
    an int, a 0-d or a (B,) tensor of valid slots -> ``(k_pages, v_pages,
    block_table, context_lens)`` as K4 reads them: the caches viewed, not
    copied, as pages (:func:`dense_layout`), the lengths int32 (B,),
    converted on the cache's device (a tensor there is read with no host
    round trip)."""
    b, s = k_cache.shape[:2]
    page, table = dense_layout(b, s, k_cache.device)
    lens = torch.as_tensor(context_lens, device=k_cache.device)
    return (k_cache.reshape(b * s // page, page, *k_cache.shape[2:]),
            v_cache.reshape(b * s // page, page, *v_cache.shape[2:]),
            table, lens.to(torch.int32).reshape(-1).expand(b))


def decode_attention(q, k_cache, v_cache, context_lens, sinks=None
                     ) -> torch.Tensor:
    """Decode attention on the card over dense caches: q (B, H, D) CUDA;
    k_cache (B, S, K, D), v_cache (B, S, K, W) and `context_lens` as
    :func:`dense_pages` takes them; `sinks` (H,) f32 or None -> (B, H, W)
    in q.dtype, logits scaled by ``D ** -0.5`` after the product.

    The kernel reads the caches' rows where they lie, in their own dtype,
    with neither :func:`_check` nor any host read: the table is whole by
    construction and the output and workspace come from PyTorch's
    allocator, so the call can be captured into a CUDA graph and replayed
    at other lengths.  Widths must be what :func:`takes` admits.
    """
    out = _launch(q, *dense_pages(k_cache, v_cache, context_lens),
                  sinks=sinks)
    LAUNCHES["decode_attention"] += 1
    LAUNCHES["attention_sinks"] += sinks is not None
    return out


def bound_bytes(q, k_pages, block_table, context_lens, *,
                v_dim: Optional[int] = None, shared_kv: bool = False,
                sinks: bool = False) -> int:
    """Bytes one call must move at least: q read, each live position's K and
    V rows of every kv head read (one row where the values are the keys'
    leading columns, `shared_kv`), the live table entries and the lengths
    read, the sinks read (f32, one a query head), the output written —
    each once."""
    b, h, d = q.shape
    _, page, kh, _ = k_pages.shape
    dv = d if v_dim is None else v_dim
    nblk = block_table.shape[1]
    ctx = context_lens.to(torch.int64).clamp(0, nblk * page)
    kv_elems = int(ctx.sum()) * kh * (d if shared_kv else d + dv)
    live = int(n_live_blocks(context_lens, page, nblk).sum())
    return (b * h * (d + dv) * q.element_size()
            + kv_elems * k_pages.element_size() + 4 * (live + b)
            + 4 * h * sinks)
