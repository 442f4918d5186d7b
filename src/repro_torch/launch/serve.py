"""Serving entry point: batched decode over the tier-aware paged KV cache.

The paper's flagship use-case end to end: requests prefill, their layer-0
KV fills a paged pool, and every decode step runs the paged-attention
kernel (:func:`repro_torch.kernels.ops.paged_attention`, K4) over the
pool while pages spill to / are fetched from the simulated CXL pool with
costs charged by the calibrated timing model.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 8 --decode 16
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

:func:`run` is the loop of the JAX package's ``repro.launch.serve.main``,
step for step, on any configuration (``main`` passes the smoke config of
``--arch``, as the reference does).  Prompt tokens and the decode queries
come from ``numpy.random.default_rng(0)`` drawn in the reference's
order, so both packages see the same inputs; the weights are drawn from
seed 0 (:func:`repro_torch.models.transformer.init_params`) or passed in,
e.g. carried over from JAX by :func:`repro_torch.convert.model_params`.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_smoke
from repro_torch.core.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.memory.kvcache import PagedKVCache
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tf
from repro_torch.runtime.trace import span


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg, *, requests: int = 8, prefill: int = 48, decode: int = 16,
        page_size: int = 16, hbm_pages: int = 24, device=None,
        params: Optional[Dict] = None) -> Dict:
    """Prefill `requests` prompts, then decode `decode` tokens for each.

    Per decode step: ``gather_args`` (charges CXL fetches, promotes hot
    pages), one K4 launch over the f32-cast layer-0 pool, then one
    ``decode_step`` per sequence.  Where the step can be captured
    (:func:`~repro_torch.models.transformer.graphable`: the CUDA card,
    attention blocks, RoPE or M-RoPE), each sequence's caches are a
    :class:`~repro_torch.models.transformer.StepGraph`: its first step
    runs eagerly, the second captures the step as a CUDA graph
    (``serve.capture#<sid>``) and every step from then on replays it;
    elsewhere every step runs eagerly.  The prefill stashes the rows that
    :func:`~repro_torch.models.attention.pool_rows` takes from layer 0's
    cache, and K4 runs with
    :func:`~repro_torch.models.attention.pool_kernel_kwargs`: the pool's
    row format is the attention's; a model whose first block keeps no K/V
    stashes nothing, and only the decode steps' zero rows fill its pool.
    Runs on `device` (default: the CUDA card).  Under a profiler each
    request's prefill and each decode step is a span
    (``serve.prefill#<sid>``, ``serve.step``), with the step's stages
    inside (:mod:`repro_torch.runtime.trace`).

    Returns a dict: ``tokens`` ({seq: [token, ...]}), ``kv_stats`` (:class:`KVStats` as a
    dict), ``tier_histogram``, ``attn_out`` (every step's K4 output),
    ``last_attn_inputs`` (q, k_pool, v_pool, block_table, context_lens of
    the last step), ``logits_finite``, ``n_params``, ``prefill_s`` and
    ``decode_s`` (host wall time, synchronized), ``kv`` (the cache) and
    ``decode_graph`` (the steps ``captured``, ``replayed`` and run
    ``eager``, summed over the sequences).
    """
    dev = resolve_device(device)
    if params is None:
        params = tf.init_params(cfg, device=dev)
    rng = np.random.default_rng(0)

    max_blocks = (prefill + decode) // page_size + 2
    kv = PagedKVCache(cfg, n_pages=requests * max_blocks + 8,
                      page_size=page_size, max_blocks=max_blocks,
                      hbm_page_budget=hbm_pages, n_layers=1, device=dev)

    # ---- prefill: run the model once per request, stash layer-0 KV pages
    # (one layer's pool feeds the kernel; every layer's cache rides in the
    # dense per-request cache that the decode steps use)
    seqs: List[int] = []
    dense_caches, ctxs, next_tok = {}, {}, {}
    finite = torch.ones((), dtype=torch.bool, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    for sid in range(requests):
        with span("serve.prefill", sid):
            toks = torch.from_numpy(
                rng.integers(0, cfg.vocab_size, (1, prefill)).astype(np.int32)
            ).to(dev)
            logits, cache = tf.forward_prefill(params, cfg, toks)
            cache = tf.pad_cache(cache, cfg, prefill + decode)
            kv.allocate(sid)
            rows = attn_mod.pool_rows(cache[0][0]["b0"], prefill)
            if rows is not None:
                kv.append_tokens(sid, 0, *rows)
            seqs.append(sid)
            dense_caches[sid] = (tf.StepGraph(cache, params, cfg)
                                 if tf.graphable(cfg, dev) else cache)
            ctxs[sid] = prefill
            finite &= torch.isfinite(logits).all()
            next_tok[sid] = int(torch.argmax(logits[0, -1]))
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    # ---- decode loop: batched paged-attention lookups + per-seq decode
    t0 = time.perf_counter()
    tokens_out = {sid: [] for sid in seqs}
    attn_out = []
    captured = 0
    heads, width = kv.row()
    zeros = np.zeros((1, heads, width), np.float32)
    k4_kwargs = attn_mod.pool_kernel_kwargs(cfg)
    for _ in range(decode):
        with span("serve.step"):
            bt, cl = kv.gather_args(seqs)      # charges CXL fetches
            q = torch.from_numpy(rng.standard_normal(
                (len(seqs), cfg.n_heads, width)).astype(np.float32)
            ).to(dev)
            with span("serve.pool_cast"):
                kp, vp = kv.f32_pools(0)
            attn_out.append(ops.paged_attention(q, kp, vp, bt, cl,
                                                **k4_kwargs))
            for sid in seqs:
                tok = torch.tensor([next_tok[sid]], dtype=torch.int32,
                                   device=dev)
                cache = dense_caches[sid]
                if (isinstance(cache, tf.StepGraph) and cache.warm
                        and cache.graph is None):
                    with span("serve.capture", sid):
                        cache.capture()
                    captured += 1
                with span("serve.model", sid):
                    logits, dense_caches[sid] = tf.decode_step(
                        params, cfg, tok, cache, ctxs[sid])
                with span("serve.sample", sid):
                    finite &= torch.isfinite(logits).all()
                    nxt = int(torch.argmax(logits[0, 0]))
                next_tok[sid] = nxt
                tokens_out[sid].append(nxt)
                ctxs[sid] += 1
                kv.append_tokens(sid, 0, zeros, zeros)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    replayed = sum(c.replayed for c in dense_caches.values()
                   if isinstance(c, tf.StepGraph))

    out = {"tokens": tokens_out, "kv_stats": dataclasses.asdict(kv.stats),
           "tier_histogram": kv.tier_histogram(), "attn_out": attn_out,
           "logits_finite": bool(finite),
           "n_params": tf.n_param_elements(params),
           "prefill_s": prefill_s, "decode_s": decode_s, "kv": kv,
           "decode_graph": {"captured": captured, "replayed": replayed,
                            "eager": len(seqs) * decode - replayed}}
    if decode:
        out["last_attn_inputs"] = (q, kp, vp, bt, cl)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="h2o-danube-3-4b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prefill", type=int, default=48)
    ap.add_argument("--decode", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--hbm-pages", type=int, default=24,
                    help="HBM page budget (force CXL spill when small)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    cfg = get_smoke(args.arch)
    r = run(cfg, requests=args.requests, prefill=args.prefill,
            decode=args.decode, page_size=args.page_size,
            hbm_pages=args.hbm_pages, device=args.device)
    dev = resolve_device(args.device)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "CPU")
    n_tok = args.requests * args.decode
    print(f"arch={cfg.arch} requests={args.requests} "
          f"prefill={args.prefill} decode={args.decode}")
    print(f"prefill: {r['prefill_s']:.2f}s   decode: {r['decode_s']:.2f}s "
          f"({n_tok / r['decode_s']:.1f} tok/s on {where})")
    print("tier stats:", r["tier_histogram"])
    s = r["kv_stats"]
    print(f"kv: allocs={s['allocs']} hbm_hits={s['hbm_hits']} "
          f"cxl_fetches={s['cxl_fetches']} promos={s['promotions']} "
          f"demos={s['demotions']} cxl_bytes={s['cxl_bytes']:,} "
          f"simulated_cxl_time={s['sim_seconds'] * 1e3:.2f}ms")
    print("sample continuation:", r["tokens"][0][:10])


if __name__ == "__main__":
    main()
