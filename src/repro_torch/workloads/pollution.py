"""Cache-pollution probe: what CXL traffic does to a DRAM-resident tenant.

The paper highlights that expander traffic does not just add latency — it
*pollutes* the shared LLC, evicting the DRAM-resident working set of
co-running code.  STREAM cannot show this (it has no resident tenant);
the probe below can, and it is exact rather than sampled:

* the **probe** is one pointer-chase lap over a working set that fits the
  L2 — after a warm-up lap it hits in cache, so its steady-state L2 miss
  rate is ~0;
* the **pollutor** is a GUPS burst over a CXL-resident table several times
  the L2, address-disjoint from the probe.

Because the cache model is deterministic and stats are cumulative along
the trace, the miss rate of the probe's *measured* lap is recovered
bitwise by running a trace and its prefix and differencing the counters:

    miss_rate(measured lap) = (L2_miss(full) - L2_miss(prefix)) / lap_len

Four sentinel-stacked rows — {clean, polluted} x {full, prefix} — run as
one batched call of the MESI kernel; the reported ``pollution_delta`` is
the measured lap's miss-rate increase caused by the interleaved CXL burst.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import cache as cache_mod
from repro_torch.core import engine as engine_mod
from repro_torch.core.device import resolve_device
from repro_torch.core.numa import LINES_PER_PAGE
from repro_torch.workloads.base import pages_for_lines
from repro_torch.workloads.microbench import Gups, PointerChase


def pollution_probe(cache: cache_mod.CacheParams, *,
                    probe_fraction: float = 0.5,
                    pollutor_factor: int = 4,
                    seed: int = 0,
                    backend: Optional[str] = None,
                    chunk: int = 512,
                    device=None) -> Dict[str, float]:
    """Measure the L2 miss-rate delta a CXL burst inflicts on a resident
    probe.

    Parameters
    ----------
    cache : CacheParams
        Geometry under test; the probe is sized to ``probe_fraction *
        l2_bytes`` (resident), the pollutor to ``pollutor_factor *
        l2_bytes`` (thrashing).
    probe_fraction, pollutor_factor : float, int
        Footprint knobs, in units of the L2 size.
    seed : int
        Seeds both generators.
    backend, chunk : str, int
        Forwarded to :func:`repro_torch.core.engine.run_traces`; ``backend
        =None`` follows the device (the kernel on the card, the plain
        version on the CPU), and the rows are padded to a multiple of
        ``chunk`` as the JAX package pads them.
    device : str or torch.device, optional
        Where the traces are built and simulated; ``None`` means the CUDA
        card (raises when there is none).

    Returns
    -------
    dict
        ``probe_miss_rate_clean`` / ``probe_miss_rate_polluted`` — L2 miss
        rate of the probe's measured lap without/with the concurrent burst
        — plus ``pollution_delta`` (their difference), and the access
        counts.
    """
    device = resolve_device(device)
    probe = PointerChase(seed=seed, hops_per_line=1).device_trace(
        max(int(cache.l2_bytes * probe_fraction), 2 * 64), device)
    burst = Gups(seed=seed).device_trace(pollutor_factor * cache.l2_bytes,
                                         device)
    # address-disjoint: the burst's table starts past the probe's pages
    offset = pages_for_lines(int(probe.addr.shape[0])) * LINES_PER_PAGE
    p_addr = probe.addr.to(torch.int32)
    g_addr = burst.addr.to(torch.int32) + offset
    p_wr = probe.is_write.to(torch.int32)
    g_wr = burst.is_write.to(torch.int32)
    zeros, ones = torch.zeros_like(p_addr), torch.ones_like(g_addr)

    cat = torch.cat
    rows = [
        (cat([p_addr, p_addr]), cat([p_wr, p_wr]), None,
         cat([zeros, zeros])),                               # clean full
        (p_addr, p_wr, None, zeros),                         # clean prefix
        (cat([p_addr, g_addr, p_addr]), cat([p_wr, g_wr, p_wr]), None,
         cat([zeros, ones, zeros])),                         # polluted full
        (cat([p_addr, g_addr]), cat([p_wr, g_wr]), None,
         cat([zeros, ones])),                                # polluted prefix
    ]
    batch = engine_mod.stack_device_traces(rows, pad_to_multiple=chunk)
    stats, _ = engine_mod.run_traces(cache, batch.addr, batch.is_write,
                                     core=None, tier=batch.tier,
                                     backend=backend, chunk=chunk)
    miss = stats.cpu().numpy().astype(np.int64)[:, cache_mod.L2_MISS]
    n = int(p_addr.shape[0])
    clean = (miss[0] - miss[1]) / n
    polluted = (miss[2] - miss[3]) / n
    return {
        "probe_lines": n,
        "pollutor_accesses": int(g_addr.shape[0]),
        "probe_miss_rate_clean": float(clean),
        "probe_miss_rate_polluted": float(polluted),
        "pollution_delta": float(polluted - clean),
    }
