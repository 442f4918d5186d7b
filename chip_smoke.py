"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
(sm_90a) and the CUDA toolkit (`nvcc`).  Phases, each of which passes or
makes the script exit non-zero:

1. print the card's name and power limit, and build the kernel library
   from ``src/repro_torch/kernels/csrc`` (timed);
2. hold the MESI kernel against its plain PyTorch version on the card,
   bitwise: random small-geometry batches (1, 2 and 4 cores, 2 and 3
   targets, sentinel tails) resident and in segments that alternate
   between kernel and plain version; a 31-core case whose L1 planes exceed
   shared memory; and, at the full Table-I geometry, a batch of the first
   16,384 accesses of the 8 x L2 STREAM triad trace beside three rows
   crowded into a few sets, which force L1 and L2 evictions, dirty
   writebacks and back-invalidations across all 16 L2 ways;
3. run the main path — ``CXLRAMSim(SimConfig(), device="cuda")``, the
   CXL-CLI flow, ``stream_suite((2, 4, 6, 8))`` and a three-policy
   ``sweep((4,))`` — with the launch counts reset just before, check that
   the kernel carried it and the plain version did not, check row
   invariants, the 8 x L2 row resident against two segmentations, and
   ``tests/golden/engine.json`` reproduced on the card;
4. time the kernel per STREAM row with CUDA events (after a warm-up),
   the plain version on the 16,384-access prefix, compute the bytes
   bound, and profile the main path once to split its wall time into
   device kernels and the rest;
5. print ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.

It exits non-zero, printing no result, when no CUDA device is present or
when the port's sources are not beside it.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
PREFIX = 16_384


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(2)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 1, reps: int = 1) -> float:
    """Mean device time of `fn()` in ms, by CUDA events, after warm-ups."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def same_run(a, b) -> int:
    """Max |a - b| over stats and every state plane of two runs (must be 0)."""
    import torch
    (sa, sta), (sb, stb) = a, b
    pairs = [(sa, sb)] + [(getattr(sta, f), getattr(stb, f))
                          for f in sta._fields]
    err = 0
    for x, y in pairs:
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"shape/dtype mismatch {x.shape} {y.shape}")
        err = max(err, int((x.to(torch.int64) - y.to(torch.int64))
                           .abs().max()))
    return err


def crowded(p, n_sets: int, n_tags: int, n: int, gen):
    """`n` line addresses spread over `n_sets` L2 sets, `n_tags` lines each.

    With more lines per set than ways, nearly every access misses and
    evicts, in L1 (whose sets divide the L2's) and in L2 alike.
    """
    import torch
    sets = torch.randint(0, n_sets, (n,), generator=gen, dtype=torch.int32)
    tags = torch.randint(0, n_tags, (n,), generator=gen, dtype=torch.int32)
    return sets + p.l2_sets * tags


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"the repro_torch sources are not beside {__file__}")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import cache as cache_mod
    from repro_torch.core import engine, numa, stream
    from repro_torch.core.machine import CPUModel
    from repro_torch.core.simulator import CXLRAMSim, SimConfig
    from repro_torch.core.timing import TimingConfig
    from repro_torch.kernels import build, cache_sim, ops

    dev = torch.device("cuda")
    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    reports = build.build()
    build_s = time.perf_counter() - t0
    print(f"[build] {sorted(reports) or 'cached'} in {build_s:.2f} s")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    # ---- 2. kernel against plain version, on the card -------------------
    max_err = 0
    gen = torch.Generator().manual_seed(0)
    small = dict(l1_bytes=1024, l1_ways=2, l2_bytes=4096, l2_ways=4)
    cases = [(dict(small, cores=c, n_targets=t), 4, 4096)
             for c in (1, 2, 4) for t in (2, 3)]
    # L1 planes in global memory; two crowded sets, so the 31 cores' copies
    # are shared, upgraded, invalidated and back-invalidated
    cases.append((dict(cores=31), 2, 1024))
    t0 = time.perf_counter()
    for kw, b, n in cases:
        p = cache_mod.CacheParams(**kw)
        if p.cores == 31:
            addr = torch.stack([crowded(p, 2, 48, n, gen) for _ in range(b)])
        else:
            addr = torch.randint(0, 8 * p.l2_sets * p.l2_ways, (b, n),
                                 generator=gen, dtype=torch.int32)
            addr[1] = torch.randint(0, 24, (n,), generator=gen,
                                    dtype=torch.int32)
            addr[2, n - n // 8:] = cache_mod.SENTINEL
            addr[3, n - 1:] = cache_mod.SENTINEL
        wr = torch.randint(0, 2, (b, n), generator=gen, dtype=torch.int32)
        core = torch.randint(0, p.cores, (b, n), generator=gen,
                             dtype=torch.int32)
        tier = torch.randint(0, p.n_targets, (b, n), generator=gen,
                             dtype=torch.int32)
        trace = [x.to(dev) for x in (addr, wr, core, tier)]
        kern = cache_sim.mesi_cache_sim(*trace, params=p)
        plain = cache_sim.mesi_cache_sim(*trace, params=p,
                                         backend="reference")
        err = same_run(kern, plain)
        # segments alternate kernel / plain version through one carry
        carry = cache_mod.init_batch_carry(p, b, device=dev)
        seg = max(n // 4, 1)
        for i, s in enumerate(range(0, n, seg)):
            piece = [x[:, s:s + seg].contiguous() for x in trace]
            carry = cache_sim.mesi_segment(
                carry, *piece, params=p,
                backend="cuda" if i % 2 == 0 else "reference")
        if int((carry[3] - (1 + n)).abs().max()) != 0:
            raise AssertionError("segmented clock did not advance by N")
        err = max(err, same_run(kern, (carry[2], cache_mod.unpack_state(
            carry[0], carry[1]))))
        torch.cuda.synchronize()
        print(f"[parity] {kw} B={b} N={n}: max|kernel - plain| = {err}")
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"kernel disagrees with plain version: {kw}")

    table1 = cache_mod.CacheParams()          # 64 KiB/8w L1, 2 MiB/16w L2
    lay8 = stream.layout_for_footprint(8 * table1.l2_bytes)
    a8, w8 = stream.stream_trace("triad", lay8, dev)
    tier8 = numa.tier_of_lines(numa.WeightedInterleave(1, 1), a8,
                               lay8.n_pages)
    # row 0: the triad prefix; rows 1-3: (sets, lines per set) crowded,
    # random writes and tiers, row 3 with a sentinel tail
    addr_t = [a8[:PREFIX].to(torch.int32).cpu()] + [
        crowded(table1, s, k, PREFIX, gen) for s, k in ((4, 64), (16, 32),
                                                        (1, 24))]
    addr_t[3][PREFIX - PREFIX // 8:] = cache_mod.SENTINEL
    wr_t = torch.randint(0, 2, (4, PREFIX), generator=gen, dtype=torch.int32)
    tier_t = torch.randint(0, 2, (4, PREFIX), generator=gen,
                           dtype=torch.int32)
    wr_t[0], tier_t[0] = w8[:PREFIX].cpu(), tier8[:PREFIX].cpu()
    prefix = [x.to(dev).contiguous() for x in (
        torch.stack(addr_t), wr_t, torch.zeros_like(wr_t), tier_t)]
    kern = cache_sim.mesi_cache_sim(*prefix, params=table1)
    cache_sim.mesi_cache_sim(*[x[:, :64] for x in prefix], params=table1,
                             backend="reference")            # warm-up
    plain_box = []
    plain_ms = cuda_ms(lambda: plain_box.append(cache_sim.mesi_cache_sim(
        *prefix, params=table1, backend="reference")), warmup=0)
    err = same_run(kern, plain_box[0])
    max_err = max(max_err, err)
    print(f"[parity] Table-I B=4 N={PREFIX} (8xL2 triad prefix + 3 crowded "
          f"rows): max|kernel - plain| = {err}")
    for i, row in enumerate(kern[0].cpu()):
        s = cache_mod.stats_dict(row)
        print(f"[parity]   row {i} stats {s}")
        if i > 0 and not (s["writebacks_l1"] and s["back_invalidations"]
                          and s["mem_write_dram"] + s["mem_write_cxl"]):
            raise AssertionError(f"crowded row {i} evicted too little: {s}")
    if err:
        raise AssertionError("kernel disagrees at the Table-I geometry")
    prefix_ms = cuda_ms(lambda: cache_sim.mesi_cache_sim(*prefix,
                                                         params=table1),
                        reps=5)
    print(f"[parity] phase took {time.perf_counter() - t0:.1f} s")
    plain_shape = list(prefix[0].shape)

    # ---- 3. the main path -------------------------------------------------
    ops.reset_launches()
    t0 = time.perf_counter()
    sim = CXLRAMSim(SimConfig(), device="cuda")
    memdevs = sim.memdevs()
    regions = sim.online("znuma")
    numastat = sim.numastat()
    breakdown = sim.latency_breakdown()
    suite = sim.stream_suite((2, 4, 6, 8))
    policies = sim.sweep((4,), policies=[numa.ZNuma(0.0),
                                         numa.WeightedInterleave(1, 1),
                                         numa.ZNuma(1.0)])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    print(f"[main] memdevs {memdevs}")
    print(f"[main] regions {regions}")
    print(f"[main] numastat {numastat}")
    print(f"[main] CXL latency breakdown {breakdown}")
    print(f"[main] stream_suite + sweep took {main_s:.2f} s wall; "
          f"launch counts {launches}")
    if launches["mesi_segment"] < 2 or launches["mesi_segment_ref"] != 0:
        raise AssertionError(f"main path did not run on the kernel: "
                             f"{launches}")
    cols = ("footprint_x_l2", "policy", "cpu", "time_ns", "bw_total_gbps",
            "bw_dram_gbps", "bw_cxl_gbps", "l2_miss_rate", "lat_dram_ns",
            "lat_cxl_ns")
    for r in suite + policies:
        print("[row] " + json.dumps({k: r[k] for k in cols}
                                    | {"stats": r["stats"]}))
        s = r["stats"]
        n = 3 * stream.layout_for_footprint(
            r["footprint_x_l2"] * table1.l2_bytes).n_elems
        checks = {
            "l1 accesses == trace length": s["l1_hit"] + s["l1_miss"] == n,
            "l2 accesses == l1 misses":
                s["l2_hit"] + s["l2_miss"] == s["l1_miss"],
            "memory reads == l2 misses":
                s["mem_read_dram"] + s["mem_read_cxl"] == s["l2_miss"],
            "finite floats": all(
                isinstance(v, float) and v == v and abs(v) != float("inf")
                for v in r.values() if isinstance(v, float)),
        }
        if r["policy"] == "znuma(cxl=100%)":
            checks["no DRAM traffic"] = (
                s["mem_read_dram"] == s["mem_write_dram"] == 0
                and r["bw_dram_gbps"] == 0.0)
        if r["policy"] == "znuma(cxl=0%)":
            checks["no CXL traffic"] = (
                s["mem_read_cxl"] == s["mem_write_cxl"] == 0
                and r["bw_cxl_gbps"] == 0.0)
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(f"row invariants failed {bad}: {r}")

    # the 8 x L2 row: resident against two segmentations, and the suite row
    tier_c = numa.tier_of_lines(numa.ZNuma(1.0), a8, lay8.n_pages)
    row8 = [x[None].to(torch.int32).contiguous()
            for x in (a8, w8, torch.zeros_like(a8), tier_c)]
    resident = engine.run_traces(table1, *row8)
    for seg in (1 << 18, 1 << 20):
        err = same_run(resident, engine.run_traces(table1, *row8,
                                                   segment=seg))
        print(f"[main] 8xL2 row resident vs segment={seg}: max|diff| = {err}")
        if err:
            raise AssertionError("segmented run differs from resident")
    if cache_mod.stats_dict(resident[0][0].cpu()) != suite[-1]["stats"]:
        raise AssertionError("8xL2 suite row differs from a resident run")

    # the repo's golden row, reproduced on the card
    golden = json.loads((ROOT / "tests" / "golden" / "engine.json")
                        .read_text())
    spec = engine.SweepSpec(footprint_factors=(2,),
                            policies=(numa.WeightedInterleave(1, 1),),
                            cpus=(CPUModel(kind="o3", mlp=8),))
    got = engine.run_sweep(
        spec, cache_mod.CacheParams(l1_bytes=8 * 1024, l1_ways=2,
                                    l2_bytes=16 * 1024, l2_ways=8),
        TimingConfig(), device="cuda")
    if json.loads(json.dumps(got)) != [golden]:
        raise AssertionError(f"golden engine row differs: {got}")
    print("[main] tests/golden/engine.json reproduced exactly on the card")

    # ---- 4. times ---------------------------------------------------------
    batch, _ = engine.build_sweep_batch(
        engine.SweepSpec(footprint_factors=(2, 4, 6, 8)), table1,
        device=dev)
    main_args = (batch.addr, batch.is_write, batch.core, batch.tier)
    main_ms = cuda_ms(lambda: cache_sim.mesi_cache_sim(*main_args,
                                                       params=table1))
    for i, k in enumerate((2, 4, 6, 8)):
        n = int(batch.n_valid[i])
        one = [x[i:i + 1, :n].contiguous() for x in main_args]
        ms = cuda_ms(lambda: cache_sim.mesi_cache_sim(*one, params=table1))
        print(f"[time] {k}xL2 row: N={n} accesses, kernel {ms:.3f} ms, "
              f"{n / ms / 1e3:.3f} M accesses/s ({card})")
    b, n_pad = batch.addr.shape
    carry = cache_mod.init_batch_carry(table1, b, device=dev)
    carry_bytes = sum(x.numel() * x.element_size() for x in carry)
    accesses = int(batch.n_valid.sum())
    trace_bytes = 16 * accesses      # addr, is_write, core, tier: int32 each
    bound_ms = (trace_bytes + 2 * carry_bytes) / HBM_BYTES_PER_S * 1e3
    print(f"[time] main-path launch B={b} x N={n_pad}: kernel {main_ms:.3f} "
          f"ms ({accesses / main_ms / 1e3:.3f} M accesses/s), bytes bound "
          f"{bound_ms:.4f} ms ({trace_bytes + 2 * carry_bytes} B at "
          f"3.35 TB/s)")
    print(f"[time] Table-I parity batch {plain_shape}: kernel "
          f"{prefix_ms:.3f} ms, plain version {plain_ms:.1f} ms ({card})")

    # the main path once more under the profiler: where its time goes
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.stream_suite((2, 4, 6, 8))
        sim.sweep((4,), policies=[numa.ZNuma(0.0),
                                  numa.WeightedInterleave(1, 1),
                                  numa.ZNuma(1.0)])
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    device_us = sorted(((e.self_device_time_total, e.key, e.count)
                        for e in prof.key_averages()
                        if e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(us for us, _, _ in device_us) / 1e3
    if busy_ms > 0:
        print(f"[profile] main path: wall {prof_wall_ms:.1f} ms, device "
              f"kernels {busy_ms:.1f} ms ({100 * busy_ms / prof_wall_ms:.1f}"
              f"% of wall; only B of the card's SMs are busy meanwhile)")
        for us, key, count in device_us[:6]:
            print(f"[profile]   {us / 1e3:10.3f} ms  x{count:<4d} {key[:70]}")
    else:
        print(f"[profile] main path: wall {prof_wall_ms:.1f} ms; the "
              f"profiler saw no device time (device busy share not measured)")

    # ---- 5. results -------------------------------------------------------
    print(card)
    print(json.dumps({"kernels": [{
        "name": "mesi_segment", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mesi.cu",
        "replaces": "src/repro/kernels/cache_sim.py:428",
        "also_replaces": "src/repro/kernels/cache_sim.py:587",
        "launches": launches["mesi_segment"],
        "max_abs_err": max_err,
        "ms": main_ms, "shape": [b, n_pad],
        "plain_ms": plain_ms, "plain_shape": plain_shape,
        "ms_on_plain_shape": prefix_ms,
        "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
