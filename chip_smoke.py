"""Drive the PyTorch/CUDA port's main paths on one CUDA card and check them.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
(sm_90a) and the CUDA toolkit (`nvcc`).  Phases, each of which passes or
makes the script exit non-zero:

1. print the card's name and power limit, and build the six kernel
   libraries from ``src/repro_torch/kernels/csrc`` (one `nvcc` each, started
   together; timed, with the ptxas report); count the tensor-core
   instructions (``HGMMA``, ``HMMA``) in the flash-attention library's SASS
   (``cuobjdump -sass``), and fail if it has no ``HGMMA``;
2. hold each MESI kernel against its plain PyTorch version on the card,
   bitwise.  Both split each row into independent set chains, one warp
   each (``mesi_chain.cuh``).  The MESI kernel (K1/K2, ``mesi.cu``):
   random small-geometry
   batches (1, 2 and 4 cores, 2 and 3 targets, sentinel tails) resident
   and in segments that alternate between kernel and plain version; a
   31-core case (a chain's L1 sets of 31 cores); and, at the Table-I
   geometry, the first 16,384 accesses of the 8 x L2 STREAM triad trace
   beside three rows crowded into a few sets.  The epoch kernel (K3,
   ``mesi_dyn.cu``), at the golden geometry, B = 4, N = 2048: 1/2/4 cores
   at three targets and 2 cores at two, each batch holding a two-tier row
   under DRAM pressure, a sampled row whose budget exceeds the page count,
   a three-tier (or third two-tier) row and a static ride-along row (whose
   stats must equal K1's); segments that alternate kernel and plain
   version; a page count (30,000) that puts the page map and counts in
   global memory; a Table-I prefix, 8,192 accesses of HotCold at 8 x L2
   with 512-access epochs and a budget of 16; and the launches that sweeps
   A, B and C make, as the engine derives them, cut to their first 8,192
   accesses (sweep A's KVDecode rows included).  The split's edge cases,
   K1 and K3: L1 sets equal to L2 sets; one L1 set (one chain per row, the
   L2 sets in global memory); every access in one chain; 31 cores with the
   Table-I L1 over a 4-set L2 (the L1 sets in global memory); K3's batch
   holding a sampled row with period 2 and a three-tier row (the SSD
   stage); each case's plan must keep the sets where the case says; and
   320 K3 rows whose chains meet, more than the card holds at once, so the
   plan splits them over several cooperative launches;
3. run the main paths with the launch counts reset just before each and
   read just after: PR 11's ``stream_suite((2, 4, 6, 8))`` plus a
   three-policy ``sweep((4,))`` on the MESI kernel, then the dynamic path
   at the Table-I host — sweep A (HotCold, GUPS and KVDecode under static
   and two dynamic tierers), sweep B (a 10.5 M-access GUPS trace exact and
   SMARTS sampled) and sweep C (HotCold on a DRAM -> CXL -> CXL-SSD
   hierarchy, point timing and a latency distribution) — on the epoch
   kernel, with no plain-version call; check row invariants, KVDecode's
   device trace and row against its host trace, and reproduce
   ``tests/golden/{engine,topology,workloads,sampling,fidelity}.json``
   exactly on the card; then slice 3's path, ``launch.serve.run`` at the
   full width of h2o-danube-3-4b (3.96 B parameters in bf16, random from
   a seed) with serve.py's defaults (8 requests, prefill 48, decode 16,
   16-token pages, 24 HBM pages): one paged-attention (K4) launch per
   decode step, finite logits, and the same loop at smoke size in float32
   equal on the card and on the CPU; mimo-v2-flash-309b's smoke serve
   (``hybrid_serve_path``: every prefill attention on K5's second form,
   none on the loop, two K4 pool launches a step, every decode
   attention on K4's dense entry, the sinks' launches, no einsum, the
   pool's counters as on the CPU); kimi-linear-48b-a3b's serve at its
   published widths and all 27 layers on 8 held experts
   (``kda_serve_path``: every MLA prefill on K5's second form, none on
   the loop, every KDA layer's chunks and decode steps counted, one K4
   pool launch a step, graphed, the state kind's counters; K5's second
   form and K4's latent pool at the Kimi cell's shapes against their
   plain versions, ``k5_kimi_times``, ``k4_kimi_cell``); the goldens
   also include
   ``tests/golden/{distribute,resilience}.json``, run as
   ``tests/test_golden_stats.py`` runs them (2 shards x 8 streamed
   segments; a crash at segment 2, then the resumed run's 6 launches);
   3c. slice 8: shard padding rows (all sentinel from their first access)
   through K2 and K3 against their plain versions, idle and meeting at no
   boundary, and a segment call that leaves its input carry unchanged;
   then, through ``CXLRAMSim.sweep`` and ``pollution_probe`` at the
   Table-I host with the launch counts reset before each step and no
   plain-version call: (a) the §IV suite with ``mesh=4,
   stream_chunk=262144`` (32 K2 launches) and ``mesh=Mesh(3)`` (the last
   shard all padding), three policies with ``stream_chunk=65536``; (b)
   sweep A with ``mesh=3, stream_chunk=131072`` (64 slots a segment, 24
   K3 launches) and ``mesh=4``; (c) sweep A crashed at shard 1, segment
   3, and resumed from its checkpoints (fewer K3 launches than the
   uninterrupted run), and again with a transient and an OOM fault — every
   row equal to the resident rows bitwise; (d) ``pollution_probe`` at
   Table-I (default knobs and 0.25 / 1) equal to the JAX package's dicts,
   and at the golden geometry kernel against plain version; (e)
   ``MoEStream`` at Table-I, device trace equal to host trace, a
   three-policy sweep in one K1 launch, and streamed;
   2b. hold K4 (``paged_attention.cu``) against its plain version: head
   dims 16/64/120/128, 1 and 4 query heads per kv head, f32 and bf16, with
   empty contexts, partial last pages and out-of-range padding in the
   block tables; split over the context (6 sequences of 4096 positions'
   capacity, contexts 0, 1, L - 1, L, L + 1 and 4096 for partition
   length L, 1, 4 and 16 query heads per kv head, two calls bitwise
   equal); and the serve loop's own last step (rtol = atol = 3e-5 in f32,
   2e-2 in bf16);
   2c. hold slice 4's kernels against their plain versions: the
   single-level LRU cache (K6, ``cache_sim.cu``) bitwise on hits, tags and
   clocks at the JAX test's geometries, a trace that is no multiple of 32,
   the Table-I L2 (2048 x 16) on the 8 x L2 triad prefix and on a trace
   crowded into four sets, and the set chains' edge cases (1, 2 and 8192
   sets, 1 and 32 ways, an empty trace, every access in one set); the STREAM triad (K7, ``stream_triad.cu``)
   bitwise in f32 and bf16 with s = 2.5 and 0.1 from (8, 128) up to
   (32768, 4096); blockwise attention (K5, ``flash_attention.cu``: bf16
   with D % 8 == 0 on its tensor-core kernel, the rest on its CUDA-core
   kernel) on the JAX test's five cases, D = 120, Sq < Sk and Sq > Sk,
   windows shorter than a tile and longer than the sequence, and
   non-causal (rtol = atol = 3e-5 in f32, 3e-2 in bf16);
   3b. slice 4's path through ``kernels.ops`` at full width, each call one
   kernel launch and no plain-version call (K5's on its tensor-core
   variant, by the per-variant count): K5 on h2o-danube-3-4b's
   layer-0 attention on a 4096-token prompt (the served model's weights,
   kv heads repeated to 32), and on a seeded (1, 32, 8192, 120) bf16 case
   at the model's 4096 window, both held against the plain version
   (rtol = atol = 5e-3, and the error's RMS within 1e-3 of the output's),
   the first also against the port's prefill attention
   ``blockwise_attention`` (3e-2: it rounds p to bf16); K6 over the whole 2,097,150-access
   trace at 2048 x 16 (bitwise against the plain version, and one miss per
   distinct line); K7 at (32768, 4096) f32;
4. time each kernel with CUDA events at the main paths' shapes (after a
   warm-up): the MESI kernels' launches (the §IV suite, the three-policy
   sweep, sweeps A, B, C) with their rates, chain counts, blocks, the
   most SMs those can occupy and the bucket pre-pass timed alone, and K3's
   migrating sweeps again with every budget 0 (the boundaries' share); the plain
   versions on their Table-I parity batches, K4 at the
   serve loop's shapes and at a 4096-token decode beside SDPA on the
   gathered K/V (its partitions and blocks, and by the profiler the
   device time of its partition and combine passes),
   K6 with its chain count, longest chain, the device time of its bucket
   pre-pass and of its chain kernel by the profiler, and the time per
   access on a chain and on one chain alone, K5-K7 at
   slice 4's shapes beside their plain versions and
   SDPA / ``torch.add`` (K5's tensor-core kernel also beside its CUDA-core
   kernel on the same bf16 inputs; K7 in three rounds between
   ``torch.add`` calls), K5's second tensor-core form at
   MiMo-V2-Flash's full and window prefill shapes (64 query heads over 4
   and 8 KV heads, 4,096 tokens, q and k 192 wide, v 128, the window
   layer's sinks) through ``gqa_flash_attention`` beside the loop
   (``blockwise_attention``), within one bf16 rounding of it, compute
   the bounds, and profile the main paths (slice 8's (a) and (b) among
   them) once to split their wall time into device kernels and the rest;
   3d. slice 9, the training path (no kernel on it: the launch counts,
   set to 0 before and read after, must stay 0 and are reported as the
   ``train`` path): (a) ``launch.train.run`` at the full width and depth
   of h2o-danube-3-4b (3.96 B bf16 parameters from seed 0, AdamW state
   and gradients on the card, ~47.5 GB), 6 steps of batch 1 x 4096 with
   full recomputation (the config's "dots" would keep every layer's f32
   attention logits): finite losses, the first within 1 of ln(32000);
   ms per step (median of steps 2-6), tokens/s, the model-FLOP share of
   989 TFLOP/s bf16, peak memory, and one more step taken apart by CUDA
   events (forward, gradients, AdamW) and profiled (device-busy share);
   (b) at smoke size in f32, the loop on the card against the CPU from
   the same weights with accumulation 1 and 2 (losses within rtol 1e-4,
   parameters and moments within atol 1e-5 + rtol 1e-4), then a failure
   at step 3 with checkpoints every 2 steps: one restart from step 2,
   ``evict`` and ``restart`` in the log, the replayed losses equal to the
   uninterrupted run's (within 1e-6 relative; bitwise is printed);
   (c) qwen3-moe-235b-a22b at full width cut to 1 of its 94 layers
   (3.73 B parameters), 2 steps of batch 1 x 1024: finite losses, aux
   loss > 0, 80 capacity slots by the reference's formula, peak memory;
   at smoke size in f32, ``moe_ffn`` (1e-5) and one train step (loss
   rtol 1e-4, parameters 1e-4) on the card against the CPU;
   3e. slice 10, the rwkv, rec and MLA kinds (``slice10_path``): their
   full-width serves with K4 at their shapes, card against CPU at smoke
   size, and their trainings at batch 1 x 4096;
   3f. slice 11 (``slice11_path``): the CXL.mem flit codec's headers and
   decoded fields on the card bitwise against the CPU (a million
   requests); the one-card dry run (``repro_torch.launch.dryrun``) on
   fake CUDA tensors for every architecture at decode_32k and for
   h2o-danube-3-4b's four cells, each row printed with its FLOPs beside
   ``model_flops`` and its roofline; and the dry run of the five
   trainings of 3d and 3e, whose estimated peaks must lie within 15% of
   each run's measured peak (``max_memory_allocated`` less what was
   allocated before it); no cell may fail and no kernel launch;
   3g. slice 12 (``slice12_path``): ``repro_torch.analysis.main`` with
   ``--device cuda`` and the committed baseline — the lint of
   ``src/repro_torch``, the graph audit of every registered entry point
   (the ``[cuda]`` kernel entry points among them) and the contracts, the
   stats triangulated at T = 2, 3 and 4 through K1/K2 and K3 against the
   reference — must exit 0 with ``audit=ok`` (the ``analysis`` path); then
   the four port examples in-process on the card, no ``--device``, each
   with the counts reset before and read after and no plain-version call:
   quickstart and characterize launch K1 (characterize K3 too) and print
   the JAX examples' lines (``examples/expected_output/``), serve K4 once per
   decode step (12), each launch held against the plain version on a copy
   of its own inputs (K4's tolerance of 2c), train no kernel (the
   ``examples`` path);
5. print ``{"kernels": [...]}`` (all seven TPU kernels, K2 with K1, each
   with its launches on every path of the run, ``launches_by_path``, the
   training path's ``train`` and slice 12's ``analysis`` and ``examples``
   among them) and, last, ``{"ok": true, "device": ...}``.

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
F32_FLOPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
PREFIX = 16_384                    # K1's Table-I parity prefix
DYN_PREFIX = 8_192                 # K3's Table-I parity prefix
GOLDEN_GEOMETRY = dict(l1_bytes=8 * 1024, l1_ways=2, l2_bytes=16 * 1024,
                       l2_ways=8)


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(2)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def tensor_core_instructions(name: str = "flash_attention"):
    """Counts of the tensor-core instructions in library `name`'s SASS:
    ``{"HGMMA": n, "HMMA": n}`` (wgmma and mma.sync)."""
    from repro_torch.kernels import build
    cuobjdump = pathlib.Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(build._target(name))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    return {op: sass.count(op + ".") for op in ("HGMMA", "HMMA")}


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


def device_times(fn, reps: int = 20) -> dict:
    """Device time per call of each kernel that `fn()` launches, by
    torch.profiler: {kernel name: ms}, after a warm-up call (empty where
    the profiler sees no device time).  Unlike `cuda_ms` over back-to-back
    calls, it leaves out the host's time between launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile
    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # device events only: a CPU op also reports its kernels' device time
    return {e.key: e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0}


def kernel_label(key: str) -> str:
    """A profiler kernel name without its return type, anonymous namespace
    and argument list."""
    key = key.replace("(anonymous namespace)::", "")
    return key.removeprefix("void ").split("(")[0]


def max_diff(pairs) -> int:
    """Max |a - b| over pairs of integer tensors (shapes must agree)."""
    import torch
    err = 0
    for x, y in pairs:
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"shape/dtype mismatch {x.shape} {y.shape}")
        if x.numel():
            err = max(err, int((x.to(torch.int64) - y.to(torch.int64))
                               .abs().max()))
    return err


def same_run(a, b) -> int:
    """Max |a - b| over stats and every state plane of two runs (must be 0)."""
    (sa, sta), (sb, stb) = a, b
    return max_diff([(sa, sb)] + [(getattr(sta, f), getattr(stb, f))
                                  for f in sta._fields])


def crowded(p, n_sets: int, n_tags: int, n: int, gen):
    """`n` line addresses spread over `n_sets` L2 sets, `n_tags` lines each.

    With more lines per set than ways, nearly every access misses and
    evicts, in L1 (whose sets divide the L2's) and in L2 alike.
    """
    import torch
    sets = torch.randint(0, n_sets, (n,), generator=gen, dtype=torch.int32)
    tags = torch.randint(0, n_tags, (n,), generator=gen, dtype=torch.int32)
    return sets + p.l2_sets * tags


def finite_floats(row) -> bool:
    def ok(v):
        if isinstance(v, float):
            return v == v and abs(v) != float("inf")
        if isinstance(v, list):
            return all(ok(x) for x in v)
        return True
    return all(ok(v) for k, v in row.items() if not k.endswith("_ci95"))


# ---------------------------------------------------------------------------
# Phase 2: K1 against its plain version (PR 11's cases)
# ---------------------------------------------------------------------------
def k1_parity(dev, gen):
    import torch
    from repro_torch.core import cache as cache_mod
    from repro_torch.core import numa, stream
    from repro_torch.kernels import cache_sim
    max_err = 0
    small = dict(l1_bytes=1024, l1_ways=2, l2_bytes=4096, l2_ways=4)
    cases = [(dict(small, cores=c, n_targets=t), 4, 4096)
             for c in (1, 2, 4) for t in (2, 3)]
    # 31 cores (a chain holds one L1 set of each); two crowded sets, so the
    # 31 cores' copies are shared, upgraded, invalidated and back-invalidated
    cases.append((dict(cores=31), 2, 1024))
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
        print(f"[parity K1] {kw} B={b} N={n}: max|kernel - plain| = {err}")
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
    print(f"[parity K1] Table-I B=4 N={PREFIX} (8xL2 triad prefix + 3 "
          f"crowded rows): max|kernel - plain| = {err}")
    for i, row in enumerate(kern[0].cpu()):
        s = cache_mod.stats_dict(row)
        print(f"[parity K1]   row {i} stats {s}")
        if i > 0 and not (s["writebacks_l1"] and s["back_invalidations"]
                          and s["mem_write_dram"] + s["mem_write_cxl"]):
            raise AssertionError(f"crowded row {i} evicted too little: {s}")
    if err:
        raise AssertionError("kernel disagrees at the Table-I geometry")
    prefix_ms = cuda_ms(lambda: cache_sim.mesi_cache_sim(*prefix,
                                                         params=table1),
                        reps=5)
    return dict(max_err=max_err, plain_ms=plain_ms,
                plain_shape=list(prefix[0].shape), prefix_ms=prefix_ms)


# ---------------------------------------------------------------------------
# Phase 2: K3 against its plain version
# ---------------------------------------------------------------------------
def dyn_case(p, n_p: int, n: int, gen, dev, slot: int = 32):
    """A (B = 4) epoch batch: a two-tier row under DRAM pressure, a sampled
    row whose budget exceeds the page count, a row spilling to the SSD
    target (with three targets; with two, another two-tier row) and a
    static ride-along row with a sentinel tail."""
    import torch
    from repro_torch.core import tiering_dyn
    b, t = 4, p.n_targets
    unbounded = tiering_dyn.UNBOUNDED_PAGES
    addr = torch.randint(0, 64 * n_p, (b, n), generator=gen,
                         dtype=torch.int32)
    hot = torch.randint(0, 64 * min(n_p, 4), (b, n), generator=gen,
                        dtype=torch.int32)
    addr = torch.where(torch.rand((b, n), generator=gen) < 0.6, hot, addr)
    addr[3, n - n // 8:] = -1
    trace = [x.to(dev) for x in (
        addr, torch.randint(0, 2, (b, n), generator=gen, dtype=torch.int32),
        torch.randint(0, p.cores, (b, n), generator=gen, dtype=torch.int32),
        torch.randint(1, t, (b, n), generator=gen, dtype=torch.int32))]
    pmap0 = torch.randint(0, 2, (b, n_p), generator=gen, dtype=torch.int32)
    ssd = t > 2
    if ssd:
        pmap0[2, :2] = 2
    kw = dict(slot_len=slot, k_max=8, page_map0=pmap0.to(dev),
              dyn_flag=[1, 1, 1, 0], n_pages=[n_p, n_p - 1, n_p, n_p],
              budget=[2, n_p + 3, 3, 0], threshold=[1, 2, 1, 1],
              period=[1, 2, 1, 1], dram_cap=[3, 2, unbounded, unbounded],
              page_target_lines=torch.randint(
                  0, 40, (b, n_p, t), generator=gen,
                  dtype=torch.int32).to(dev),
              ssd_tid=[0, 0, t - 1 if ssd else 0, 0],
              cxl_cap=[unbounded, unbounded, 2 if ssd else unbounded,
                       unbounded],
              s_warm=[0, 1, 0, 0], s_meas=[0, 1, 0, 0], s_per=[0, 3, 0, 0])
    return trace, kw


def dyn_diff(a, b) -> int:
    return max_diff([(getattr(a, f), getattr(b, f)) for f in a._fields])


def alternate_segments(p, trace, kw, seg: int):
    """run_dynamic in segments of `seg` slots alternating kernel / plain."""
    import torch
    from repro_torch.core import tiering_dyn
    a3, w3, c3, t3, pmap0, scalars, k_max, bound = \
        tiering_dyn.prep_dynamic_inputs(*trace, **kw)
    carry = tiering_dyn.init_dyn_carry(p, pmap0)
    parts = []
    for i, s in enumerate(range(0, a3.shape[1], seg)):
        carry, *outs = tiering_dyn.run_dynamic_segment(
            p, k_max, bound, carry, *(x[:, s:s + seg] for x in
                                      (a3, w3, c3, t3)), *scalars,
            backend="cuda" if i % 2 == 0 else "reference")
        parts.append(outs)
    return tiering_dyn.DynOutputs(
        carry[2], carry[4], carry[6], carry[7],
        *(torch.cat([pt[k] for pt in parts], dim=1) for k in range(3)))


def k3_parity(sim, dev, gen):
    import torch
    from repro_torch.core import cache as cache_mod
    from repro_torch.core import engine, numa, tiering_dyn
    from repro_torch.workloads import HotCold
    max_err = 0
    for cores, t in ((1, 3), (2, 3), (4, 3), (2, 2)):
        p = cache_mod.CacheParams(**GOLDEN_GEOMETRY, cores=cores,
                                  n_targets=t)
        trace, kw = dyn_case(p, 40, 2048, gen, dev)
        kern = tiering_dyn.run_dynamic(p, *trace, **kw)
        plain = tiering_dyn.run_dynamic(p, *trace, backend="reference", **kw)
        err = dyn_diff(kern, plain)
        # the static ride-along row equals the static (K1) path
        static, _ = engine.run_traces(p, *(x[3:] for x in trace))
        err = max(err, max_diff([(kern.stats[3:], static)]))
        alternate = (cores, t) == (2, 3)
        if alternate:
            err = max(err, dyn_diff(kern, alternate_segments(p, trace, kw,
                                                             7)))
        moved = kern.slots[:3, :, 2:].sum(dim=(1, 2)).tolist()
        rows = "three-tier" if t == 3 else "two-tier"
        print(f"[parity K3] golden geometry, {cores} cores, {t} targets, "
              f"B=4 N=2048 P=40 (two-tier+cap, sampled, {rows}, static"
              f"{', alternating segments' if alternate else ''}): "
              f"max|kernel - plain| = {err}; pages moved per row {moved}")
        if err or min(moved) == 0:
            raise AssertionError(f"K3 parity failed at {cores} cores, "
                                 f"{t} targets")
        max_err = max(max_err, err)
    # a page count whose map and counts do not fit in shared memory
    p = cache_mod.CacheParams(**GOLDEN_GEOMETRY, cores=2, n_targets=3)
    trace, kw = dyn_case(p, 30_000, 2048, gen, dev)
    err = dyn_diff(tiering_dyn.run_dynamic(p, *trace, **kw),
                   tiering_dyn.run_dynamic(p, *trace, backend="reference",
                                           **kw))
    print(f"[parity K3] P=30000 (page map + counts in global memory), "
          f"B=4 N=2048: max|kernel - plain| = {err}")
    if err:
        raise AssertionError("K3 disagrees with pmap/counts in global memory")
    max_err = max(max_err, err)

    # the Table-I prefix: HotCold at 8 x L2, 512-access epochs, budget 16,
    # as a two-tier row and a three-tier row with a 1024-page CXL-DRAM cap
    table1 = cache_mod.CacheParams(n_targets=3)
    wt = HotCold(hot_page_frac=0.25).device_trace(8 * table1.l2_bytes, dev)
    n_p = wt.n_pages
    addr = wt.addr[:DYN_PREFIX].expand(2, -1).contiguous()
    wr = wt.is_write[:DYN_PREFIX].expand(2, -1).contiguous()
    ptl = torch.zeros((2, n_p, 3), dtype=torch.int32, device=dev)
    ptl[:, :, 1] = 64                 # every line of a CXL page on target 1
    kw = dict(slot_len=512, k_max=16,
              page_map0=numa.ZNuma(1.0).tiers(n_p, dev).expand(2, -1)
              .contiguous(),
              dyn_flag=[1, 1], n_pages=[n_p, n_p], budget=[16, 16],
              threshold=[1, 1], period=[1, 1],
              dram_cap=[tiering_dyn.UNBOUNDED_PAGES] * 2,
              page_target_lines=ptl, ssd_tid=[0, 2],
              cxl_cap=[tiering_dyn.UNBOUNDED_PAGES, 1024])
    trace = (addr, wr, torch.zeros_like(addr), torch.ones_like(addr))
    kern = tiering_dyn.run_dynamic(table1, *trace, **kw)
    tiering_dyn.run_dynamic(table1, *(x[:, :512] for x in trace),
                            backend="reference", **kw)           # warm-up
    box = []
    plain_ms = cuda_ms(lambda: box.append(tiering_dyn.run_dynamic(
        table1, *trace, backend="reference", **kw)), warmup=0)
    err = dyn_diff(kern, box[0])
    prefix_ms = cuda_ms(lambda: tiering_dyn.run_dynamic(table1, *trace,
                                                        **kw), reps=5)
    print(f"[parity K3] Table-I HotCold 8xL2 prefix, B=2 N={DYN_PREFIX} "
          f"P={n_p}, epoch 512, budget 16 (two-tier, three-tier): "
          f"max|kernel - plain| = {err}; pages moved per row "
          f"{kern.slots[:, :, 2:].sum(dim=(1, 2)).tolist()}")
    if err:
        raise AssertionError("K3 disagrees at the Table-I geometry")
    max_err = max(max_err, err)

    # the main path's own launches: sweeps A, B and C as the engine builds
    # them (their target count, slot, top-k width, page map and scalars),
    # cut to their first DYN_PREFIX accesses
    for name in dynamic_sweeps():
        launch = sweep_launch(sim, name, dev)
        trace = [x[:, :DYN_PREFIX].contiguous() for x in launch.trace]
        kern = tiering_dyn.run_dynamic(launch.params, *trace,
                                       **launch.kwargs)
        err = dyn_diff(kern, tiering_dyn.run_dynamic(
            launch.params, *trace, backend="reference", **launch.kwargs))
        print(f"[parity K3] sweep {name}'s launch, first {DYN_PREFIX} "
              f"accesses: B={trace[0].shape[0]}, "
              f"{launch.params.n_targets} targets, slot "
              f"{launch.kwargs['slot_len']}, k_max {launch.kwargs['k_max']}"
              f": max|kernel - plain| = {err}; pages moved per row "
              f"{kern.slots[:, :, 2:].sum(dim=(1, 2)).tolist()}, measured "
              f"slots per row {kern.meas.sum(dim=1).tolist()}")
        if err:
            raise AssertionError(f"K3 disagrees on sweep {name}'s launch")
    return dict(max_err=max_err, plain_ms=plain_ms,
                plain_shape=[2, DYN_PREFIX], prefix_ms=prefix_ms)


# ---------------------------------------------------------------------------
# Phase 2: the chain split's edge cases, K1 and K3
# ---------------------------------------------------------------------------
# L1 sets equal to L2 sets (16 each); a single L1 set (m = 1, one chain per
# row, the Table-I L2's 640 KiB in global memory); the Table-I L1 over a
# 4-set L2 (at 31 cores, 4 chains of 31 x 32 L1 sets, 381 KB a block: the
# L1 sets in global memory)
EQUAL_GEOMETRY = dict(l1_bytes=2048, l1_ways=2, l2_bytes=8192, l2_ways=8)
ONE_CHAIN_GEOMETRY = dict(l1_bytes=512, l1_ways=8)
L1_GLOBAL_GEOMETRY = dict(l2_bytes=4 * 16 * 64, l2_ways=16)


def one_chain(addr, p, chain: int = 3):
    """`addr` with every live line moved into chain `chain` of `p` (the
    worst imbalance: one warp holds every access)."""
    import torch
    from repro_torch.kernels import cache_sim
    m = 1 << cache_sim.chain_bits(p)
    return torch.where(addr == -1, addr, addr // m * m + chain)


def split_parity(dev, gen):
    """The chain split's edge cases, bitwise against the plain versions."""
    import torch
    from repro_torch.core import cache as cache_mod
    from repro_torch.core import tiering_dyn
    from repro_torch.kernels import cache_sim
    max_err = 0

    def report(label, err, plan, b, layout):
        nonlocal max_err
        print(f"[parity split] {label}: max|kernel - plain| = {err}; "
              f"{1 << plan['bits']} chains per row, {plan['blocks_per_row']}"
              f" x {b} blocks, L1 sets in shared memory "
              f"{bool(plan['l1_in_smem'])}, L2 sets "
              f"{bool(plan['l2_in_smem'])}")
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"split case disagrees: {label}")
        if (plan["l1_in_smem"], plan["l2_in_smem"]) != layout:
            raise AssertionError(f"split case {label} keeps its sets "
                                 f"elsewhere than it tests: {plan}")

    # (label, geometry, B, N, every access in one chain, where the chains
    # keep their L1 and L2 sets: 1 in shared memory)
    k1_cases = [
        ("L1 sets == L2 sets (16), 2 cores, 3 targets",
         dict(EQUAL_GEOMETRY, cores=2, n_targets=3), 4, 4096, False, (1, 1)),
        ("one L1 set (m = 1), Table-I L2, 2 cores",
         dict(ONE_CHAIN_GEOMETRY, cores=2), 2, 2048, False, (1, 0)),
        ("every access in one chain, golden geometry, 4 cores",
         dict(GOLDEN_GEOMETRY, cores=4, n_targets=3), 2, 4096, True, (1, 1)),
        ("Table-I L1 over a 4-set L2, 31 cores",
         dict(L1_GLOBAL_GEOMETRY, cores=31, n_targets=3), 2, 2048, False,
         (0, 1)),
    ]
    for label, kw, b, n, single, layout in k1_cases:
        p = cache_mod.CacheParams(**kw)
        span = 4 * p.l2_sets * p.l2_ways
        addr = torch.randint(-64, span, (b, n), generator=gen,
                             dtype=torch.int32)
        addr[0, n // 3:n // 3 + 40] = cache_mod.SENTINEL
        if single:
            addr = one_chain(addr, p)
        trace = [x.to(dev) for x in (
            addr, torch.randint(0, 2, (b, n), generator=gen,
                                dtype=torch.int32),
            torch.randint(0, p.cores, (b, n), generator=gen,
                          dtype=torch.int32),
            torch.randint(0, p.n_targets, (b, n), generator=gen,
                          dtype=torch.int32))]
        kern = cache_sim.mesi_cache_sim(*trace, params=p)
        plain = cache_sim.mesi_cache_sim(*trace, params=p,
                                         backend="reference")
        report(f"K1 {label}, B={b} N={n}", same_run(kern, plain),
               cache_sim.mesi_plan(p, dev), b, layout)

    k3_cases = [
        ("L1 sets == L2 sets", dict(EQUAL_GEOMETRY, cores=2, n_targets=3),
         False, (1, 1)),
        ("one L1 set (m = 1), Table-I L2",
         dict(ONE_CHAIN_GEOMETRY, cores=1, n_targets=3), False, (1, 0)),
        ("every access in one chain, golden geometry",
         dict(GOLDEN_GEOMETRY, cores=2, n_targets=3), True, (1, 1)),
        ("Table-I L1 over a 4-set L2, 31 cores",
         dict(L1_GLOBAL_GEOMETRY, cores=31, n_targets=3), False, (0, 1)),
    ]
    for label, kw, single, layout in k3_cases:
        p = cache_mod.CacheParams(**kw)
        trace, dkw = dyn_case(p, 40, 2048, gen, dev)
        if single:
            trace[0] = one_chain(trace[0], p)
        kern = tiering_dyn.run_dynamic(p, *trace, **dkw)
        plain = tiering_dyn.run_dynamic(p, *trace, backend="reference",
                                        **dkw)
        moved = kern.slots[:3, :, 2:].sum(dim=(1, 2)).tolist()
        report(f"K3 {label}, B=4 N=2048 (two-tier+cap, sampled with "
               f"period 2, three-tier SSD stage, static); pages moved per "
               f"row {moved}", dyn_diff(kern, plain),
               cache_sim.mesi_dyn_plan(p, 4, 40, dev, meet=True), 4, layout)
        if min(moved) == 0:
            raise AssertionError(f"K3 split case moved no page: {label}")

    # more rows than the card holds at once when their chains meet: the
    # plan splits them over several cooperative launches
    p = cache_mod.CacheParams(**GOLDEN_GEOMETRY, cores=2, n_targets=3)
    b, n_p, n = 320, 40, 256
    trace, dkw = dyn_case(p, n_p, n, gen, dev)
    pick = torch.arange(b) % 4
    trace = [x[pick.to(dev)].contiguous() for x in trace]
    dkw = {k: (v[pick.to(v.device)] if isinstance(v, torch.Tensor)
               else [v[i] for i in pick.tolist()] if isinstance(v, list)
               else v) for k, v in dkw.items()}
    plan = cache_sim.mesi_dyn_plan(p, b, n_p, dev, meet=True)
    kern = tiering_dyn.run_dynamic(p, *trace, **dkw)
    plain = tiering_dyn.run_dynamic(p, *trace, backend="reference", **dkw)
    print(f"[parity split] K3 B={b} N={n} at the golden geometry: "
          f"{plan['rows_per_launch']} rows per cooperative launch "
          f"({plan['blocks_per_row']} blocks per row, "
          f"{plan['blocks_per_sm']} blocks per SM x {plan['sms']} SMs): "
          f"max|kernel - plain| = {dyn_diff(kern, plain)}")
    if plan["rows_per_launch"] >= b or dyn_diff(kern, plain):
        raise AssertionError("K3 rows over several launches failed")
    return max_err


# ---------------------------------------------------------------------------
# Phase 3: the main paths
# ---------------------------------------------------------------------------
def static_main_path(sim):
    """PR 11's main path: the §IV STREAM sweep on the MESI kernel."""
    import torch
    from repro_torch.core import numa, stream
    from repro_torch.kernels import ops
    ops.reset_launches()
    t0 = time.perf_counter()
    suite = sim.stream_suite((2, 4, 6, 8))
    policies = sim.sweep((4,), policies=[numa.ZNuma(0.0),
                                         numa.WeightedInterleave(1, 1),
                                         numa.ZNuma(1.0)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    print(f"[main] stream_suite + sweep took {wall:.2f} s wall; "
          f"launch counts {launches}")
    if launches["mesi_segment"] < 2 or launches["mesi_segment_ref"] != 0:
        raise AssertionError(f"main path did not run on the kernel: "
                             f"{launches}")
    cols = ("footprint_x_l2", "policy", "cpu", "time_ns", "bw_total_gbps",
            "bw_dram_gbps", "bw_cxl_gbps", "l2_miss_rate", "lat_dram_ns",
            "lat_cxl_ns")
    l2 = sim.config.cache.l2_bytes
    for r in suite + policies:
        print("[row] " + json.dumps({k: r[k] for k in cols}
                                    | {"stats": r["stats"]}))
        s = r["stats"]
        n = 3 * stream.layout_for_footprint(r["footprint_x_l2"] * l2).n_elems
        checks = {
            "l1 accesses == trace length": s["l1_hit"] + s["l1_miss"] == n,
            "l2 accesses == l1 misses":
                s["l2_hit"] + s["l2_miss"] == s["l1_miss"],
            "memory reads == l2 misses":
                s["mem_read_dram"] + s["mem_read_cxl"] == s["l2_miss"],
            "finite floats": finite_floats(r),
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
    return dict(suite=suite, policies=policies, launches=launches, wall=wall)


def dynamic_sweeps():
    """Sweeps A, B and C of the dynamic path at the Table-I host: name ->
    `CXLRAMSim.sweep` keyword arguments (footprint 8 x L2)."""
    from repro_torch.core import route
    from repro_torch.core.sampling import SamplingSpec
    from repro_torch.core.tiering_dyn import DynamicTiering
    from repro_torch.core.timing import LatencyDistribution
    from repro_torch.workloads import Gups, HotCold, KVDecode
    return {
        "A": dict(workloads=(HotCold(hot_page_frac=0.25), Gups(),
                             KVDecode()),
                  tiering=(None, DynamicTiering(2048, 16, 8),
                           DynamicTiering(4096, 8, 8))),
        "B": dict(workloads=(Gups(updates_per_line=20),),
                  sampling=(None, SamplingSpec(1, 1, 8))),
        "C": dict(workloads=(HotCold(hot_page_frac=0.25),),
                  topologies=(route.direct(1, ssd_gib=16),),
                  tiering=(DynamicTiering(2048, 16, 8,
                                          cxl_capacity_pages=1024),),
                  distributions=(None, LatencyDistribution(
                      n_samples=128, seed=0))),
    }


def sweep_launch(sim, name, dev):
    """The epoch kernel's launch that `sim.sweep((8,), ...)` makes for
    sweep `name`, derived by the engine itself."""
    from repro_torch.core import engine
    spec = sim.sweep_spec((8,), **dynamic_sweeps()[name])
    return engine.dynamic_launch(
        spec, sim.config.cache, engine.sweep_routes(spec, sim.config.timing),
        device=dev)


def check_dynamic_rows(name, rows, sim):
    """Row invariants of a dynamic-path sweep."""
    from repro_torch.core.cache import MEM_READ
    lengths = {w.name: w.device_trace(8 * sim.config.cache.l2_bytes,
                                      sim.device).n_accesses
               for w in dynamic_sweeps()[name]["workloads"]}
    for r in rows:
        show = {k: r[k] for k in ("workload", "tiering", "sampling",
                                  "topology", "distribution", "time_ns",
                                  "bw_total_gbps", "bw_dram_gbps",
                                  "bw_cxl_gbps", "bw_ssd_gbps",
                                  "l2_miss_rate", "migrated_pages",
                                  "migration_gbps", "sampled_frac",
                                  "sample_windows", "l2_miss_rate_ci95")
                if k in r}
        print(f"[sweep {name}] " + json.dumps(show | {"stats": r["stats"]}))
        s = r["stats"]
        n_t = (len(s) - 8) // 2
        reads = sum(list(s.values())[MEM_READ:MEM_READ + n_t])
        checks = {"finite floats": finite_floats(r),
                  "l2 accesses == l1 misses":
                      s["l2_hit"] + s["l2_miss"] == s["l1_miss"]}
        if r.get("sampling", "exact") == "exact":
            checks["l1 accesses == trace length"] = \
                s["l1_hit"] + s["l1_miss"] == lengths[r["workload"]]
            checks["memory reads == l2 misses"] = reads == s["l2_miss"]
        else:
            checks["an eighth measured in detail"] = \
                0.12 < r["sampled_frac"] <= 0.13
            checks["finite intervals"] = all(
                v == v and abs(v) != float("inf")
                for k, v in r.items() if k.endswith("_ci95"))
        if r.get("tiering", "static") != "static" \
                and r["workload"] == "hot_cold":
            checks["hot pages migrate"] = r["migrated_pages"] > 0
        if "topology" in r:
            checks["the SSD tier carries traffic"] = r["bw_ssd_gbps"] > 0
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(f"sweep {name} row invariants failed "
                                 f"{bad}: {show}")


def run_dynamic_sweeps(sim):
    import torch
    from repro_torch.kernels import ops
    out = {}
    for name, kw in dynamic_sweeps().items():
        ops.reset_launches()
        t0 = time.perf_counter()
        rows = sim.sweep((8,), **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        print(f"[sweep {name}] {len(rows)} rows in {wall:.2f} s wall; "
              f"launch counts {launches}")
        if launches["mesi_dyn_segment"] < 1 or any(
                launches[k] for k in ("mesi_segment_ref",
                                      "mesi_dyn_segment_ref")):
            raise AssertionError(f"sweep {name} did not run on the epoch "
                                 f"kernel alone: {launches}")
        check_dynamic_rows(name, rows, sim)
        out[name] = dict(rows=rows, wall=wall, launches=launches)
    exact, sampled = out["B"]["rows"]
    ratios = {k: abs(sampled["stats"][k] - v) / sampled[f"{k}_ci95"]
              for k, v in exact["stats"].items() if sampled[f"{k}_ci95"]}
    print(f"[sweep B] |sampled - exact| / ci95 per counter: "
          f"{ {k: round(v, 3) for k, v in ratios.items()} }; "
          f"{sum(v <= 1 for v in ratios.values())} of {len(ratios)} inside")
    return out


def goldens_on_the_card(dev):
    """tests/golden/*.json reproduced exactly through the kernels."""
    from repro_torch.core import cache as cache_mod
    from repro_torch.core import distribute, engine, numa, route
    from repro_torch.core.machine import CPUModel
    from repro_torch.core.sampling import SamplingSpec
    from repro_torch.core.tiering_dyn import DynamicTiering
    from repro_torch.core.timing import LatencyDistribution, TimingConfig
    from repro_torch.kernels import ops
    from repro_torch.workloads import Gups, HotCold
    cpus = (CPUModel(kind="o3", mlp=8),)
    specs = {
        "engine": engine.SweepSpec(footprint_factors=(2,),
                                   policies=(numa.WeightedInterleave(1, 1),),
                                   cpus=cpus),
        "topology": engine.SweepSpec(footprint_factors=(2,),
                                     policies=(numa.ZNuma(1.0),), cpus=cpus,
                                     topologies=(route.direct(2),)),
        "workloads": engine.SweepSpec(footprint_factors=(2,),
                                      policies=(numa.ZNuma(1.0),), cpus=cpus,
                                      workloads=(Gups(),)),
        "sampling": engine.SweepSpec(
            footprint_factors=(8,), policies=(numa.ZNuma(1.0),), cpus=cpus,
            workloads=(Gups(),), sampling=(None, SamplingSpec(1, 1, 4))),
        "fidelity": engine.SweepSpec(
            footprint_factors=(8,), policies=(numa.ZNuma(1.0),), cpus=cpus,
            workloads=(HotCold(hot_page_frac=0.25),),
            topologies=(route.direct(1, ssd_gib=16),),
            tiering=(DynamicTiering(2048, 16, 8, cxl_capacity_pages=8),),
            distributions=(None, LatencyDistribution(n_samples=128,
                                                     seed=0))),
    }
    golden = cache_mod.CacheParams(**GOLDEN_GEOMETRY)
    runs = {name: (lambda spec=spec: engine.run_sweep(
        spec, golden, TimingConfig(), device=dev), 1)
        for name, spec in specs.items()}
    # as tests/test_golden_stats.py runs them: the engine family's grid
    # widened to two policies, sharded (2 shards) and streamed (512-access
    # segments: 8 per 4,095-access trace), and the same grid crashed at
    # shard 0, segment 2, then resumed (8 segments, 2 fast-forwarded)
    two = engine.SweepSpec(footprint_factors=(2,), policies=(
        numa.WeightedInterleave(1, 1), numa.ZNuma(1.0)), cpus=cpus)
    runs["distribute"] = (lambda: distribute.run_sweep(
        two, golden, TimingConfig(), mesh=distribute.Mesh(n_shards=2),
        stream_chunk=512, device=dev), 2 * 8)
    runs["resilience"] = (lambda: resumed_golden(two, golden, dev), 8 - 2)
    launches = {}
    for name, (run, want_launches) in runs.items():
        want = json.loads((ROOT / "tests" / "golden" / f"{name}.json")
                          .read_text())
        ops.reset_launches()
        got = json.loads(json.dumps(run()))
        kernel = "mesi_dyn_segment" if name in ("sampling", "fidelity") \
            else "mesi_segment"
        if (got != (want if isinstance(want, list) else [want])
                or ops.LAUNCHES[kernel] != want_launches
                or ops.LAUNCHES[kernel + "_ref"] != 0):
            raise AssertionError(f"golden {name} differs on the card "
                                 f"({dict(ops.LAUNCHES)}): {got}")
        launches[name] = dict(ops.LAUNCHES)
        print(f"[golden] tests/golden/{name}.json reproduced exactly on the "
              f"card through {kernel} ({want_launches} launches)")
    return launches


def resumed_golden(spec, golden, dev):
    """The resilience golden's run: crash at shard 0, segment 2 (the
    crashed run's launches are not counted), then resume."""
    import tempfile
    from repro_torch.core import distribute
    from repro_torch.core import resilience as R
    from repro_torch.core.timing import TimingConfig
    from repro_torch.kernels import ops
    with tempfile.TemporaryDirectory() as d:
        pol = R.CheckpointPolicy(d, every_segments=1, blocking=True)
        plan = R.FaultPlan((R.Fault("crash", shard=0, segment=2),))
        try:
            distribute.run_sweep(spec, golden, TimingConfig(),
                                 stream_chunk=512, resume=pol,
                                 fault_plan=plan, device=dev)
        except R.RunKilled:
            pass
        else:
            raise AssertionError("the injected crash did not fire")
        ops.reset_launches()
        return distribute.run_sweep(spec, golden, TimingConfig(),
                                    stream_chunk=512, resume=pol,
                                    device=dev)


def kv_decode_device_equals_host(sim, rows):
    """KVDecode's device trace equals its host trace bitwise on the card,
    and its static sweep-A row equals the row built from the host trace
    (the check `benchmarks/run.py` makes for the JAX package)."""
    import torch
    from repro_torch.core import cache as cache_mod
    from repro_torch.core import engine
    from repro_torch.workloads import KVDecode
    wl, dev = KVDecode(), sim.device
    fp = 8 * sim.config.cache.l2_bytes
    dt, ht = wl.device_trace(fp, dev), wl.host_trace(fp)
    same = dt.n_pages == ht.n_pages and all(
        torch.equal(getattr(dt, f), torch.from_numpy(getattr(ht, f)).to(dev))
        for f in ("addr", "is_write", "tier"))
    up = [torch.from_numpy(x).to(dev)[None] for x in (ht.addr, ht.is_write,
                                                       ht.tier)]
    stats, _ = engine.run_traces(sim.config.cache, up[0], up[1], core=None,
                                 tier=up[2])
    want = cache_mod.stats_dict(stats[0].cpu())
    got = next(r["stats"] for r in rows if r["workload"] == wl.name
               and r["tiering"] == "static")
    print(f"[sweep A] kv_decode: {dt.n_accesses} accesses over "
          f"{dt.n_pages} pages, tier intent {torch.bincount(dt.tier).tolist()}"
          f"; device trace == host trace: {same}; static row == row from "
          f"the host trace: {got == want}")
    if not (same and got == want):
        raise AssertionError("kv_decode device and host traces or rows "
                             "differ on the card")


def tree_to(tree, dev):
    """A copy of a parameter tree on `dev` (a copy even on its own device:
    training updates its parameters in place)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, dev) for v in tree]
    return tree.to(dev, copy=True)


def serve_main_path(dev, card):
    """Slice 3's main path: the serve loop at the full width of
    h2o-danube-3-4b with serve.py's defaults, on K4."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf
    cfg = get_config("h2o-danube-3-4b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ops.reset_launches()
    r = serve.run(cfg, device=dev, params=params)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_req, n_dec = 8, 16
    print(f"[serve] {cfg.arch}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv heads "
          f"of {cfg.head_dim}, window {cfg.window}, {r['n_params']:,} "
          f"parameters in {cfg.dtype} ({r['n_params'] * 2 / 1e9:.2f} GB), "
          f"random from seed 0 in {init_s:.2f} s; peak device memory "
          f"{peak / 2**30:.2f} GiB")
    print(f"[serve] {n_req} requests, prefill 48, decode {n_dec}, page 16, "
          f"24 HBM pages: prefill {r['prefill_s']:.3f} s "
          f"({n_req * 48 / r['prefill_s']:.1f} prompt tokens/s), decode "
          f"{r['decode_s']:.3f} s ({n_req * n_dec / r['decode_s']:.2f} "
          f"tokens/s, {1e3 * r['decode_s'] / (n_req * n_dec):.2f} ms per "
          f"decode_step) ({card})")
    print(f"[serve] launch counts {launches}; "
          f"kv {r['kv_stats']}; tiers {r['tier_histogram']}")
    print(f"[serve] continuation of request 0: {r['tokens'][0]}")
    checks = {
        "one K4 launch per decode step, no plain version":
            launches["paged_attention"] == n_dec
            and launches["paged_attention_ref"] == 0,
        "every prefill's attention on K5":
            launches["flash_attention"] == cfg.n_layers * n_req,
        "every layer's decode attention on K4 (a sequence's eager step "
        "and its capture), no einsum":
            launches["decode_attention"] == cfg.n_layers * n_req * 2
            and launches["decode_attention_ref"] == 0,
        "finite logits": r["logits_finite"],
        "finite K4 outputs of shape (B, H, D)": all(
            o.shape == (n_req, cfg.n_heads, cfg.head_dim)
            and bool(torch.isfinite(o).all()) for o in r["attn_out"]),
        "every page accounted": sum(r["tier_histogram"].values())
            == n_req * 6 + 8,
        "pages spilled to CXL": r["kv_stats"]["demotions"] > 0,
        "every request decoded": all(len(t) == n_dec
                                     for t in r["tokens"].values()),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"the serve path failed {bad}")

    # the same loop at smoke size in float32, on the card and on the CPU
    # from the same weights: equal KV accounting, K4 outputs within 1e-4
    small = dataclasses.replace(get_smoke("h2o-danube-3-4b"),
                                dtype="float32")
    p_cpu = tf.init_params(small, torch.Generator().manual_seed(1), "cpu")
    kw = dict(requests=3, prefill=20, decode=3, page_size=4, hbm_pages=5)
    on_card = serve.run(small, device=dev, params=tree_to(p_cpu, dev), **kw)
    on_cpu = serve.run(small, device="cpu", params=p_cpu, **kw)
    err = max(float((a.cpu() - b).abs().max())
              for a, b in zip(on_card["attn_out"], on_cpu["attn_out"]))
    same = (on_card["kv_stats"] == on_cpu["kv_stats"]
            and on_card["tier_histogram"] == on_cpu["tier_histogram"])
    print(f"[serve] smoke-size float32 loop, card against CPU: KV stats "
          f"equal {same}; max|K4 out card - CPU| = {err:.3g}")
    if not same or err > 1e-4:
        raise AssertionError("the serve loop disagrees between card and CPU")
    return dict(r=r, cfg=cfg, params=params, launches=launches, peak=peak)


def hybrid_serve_path(dev, card):
    """mimo-v2-flash-309b's smoke serve on the card (layer 0 full, layers
    1-3 window with sinks, held-share MoE FFNs; windows of 8 shorter than
    the prompts, so the rings roll), graphed, from launch counts reset just
    before: two K4 pool launches a step (the full and the window kind,
    the window one with its sinks), every layer's decode attention on K4's
    dense entry in each sequence's eager step and its capture, the window
    layers' with their sinks, none on the einsums; every layer's prefill
    attention on K5's second form (q 24, v 16), the window layers' with
    their sinks, none on the loop; the pool's counters, summed and per
    kind, as on the CPU."""
    import dataclasses
    from repro_torch.configs import get_smoke
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    cfg = get_smoke("mimo-v2-flash-309b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           held=(2, 4)))
    n_req, n_dec = 3, 4
    kw = dict(requests=n_req, prefill=20, decode=n_dec, page_size=4,
              hbm_pages=5)
    window = sum(cfg.is_window_layer(i) for i in range(cfg.n_layers))
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as attn
    loops = []
    real_loop = attn.blockwise_attention
    attn.blockwise_attention = lambda *a, **k: (loops.append(1)
                                               or real_loop(*a, **k))
    ops.reset_launches()
    fa.reset_variant_launches()
    try:
        r = serve.run(cfg, device=dev, **kw)
    finally:
        attn.blockwise_attention = real_loop
    launches = dict(ops.LAUNCHES)
    variants = dict(fa.VARIANT_LAUNCHES)
    on_cpu = serve.run(cfg, device="cpu", **kw)
    print(f"[serve] {cfg.arch} smoke: {cfg.n_layers} layers ({window} "
          f"window), {n_req} requests, prefill 20, decode {n_dec}, page 4, "
          f"5 HBM pages: launch counts {launches}; graphs "
          f"{r['decode_graph']}; kv kinds {r['kv_kinds']} ({card})")
    checks = {
        "two K4 pool launches a step, the window kind's with sinks":
            launches["paged_attention"] == 2 * n_dec
            and launches["paged_attention_ref"] == 0,
        "every layer's decode attention on K4's dense entry (eager step "
        "and capture)":
            launches["decode_attention"] == cfg.n_layers * n_req * 2,
        "sinks on the window pool launches and the window layers":
            launches["attention_sinks"] == n_dec + window * n_req * 2
            and launches["attention_sinks_ref"] == 0,
        "no decode attention on the einsums":
            launches["decode_attention_ref"] == 0,
        "every layer's prefill attention on K5's second form, the window "
        "layers' with sinks, none on the loop":
            launches["flash_attention"] == cfg.n_layers * n_req
            and variants["tensor_cores_own_v"] == cfg.n_layers * n_req
            and launches["flash_attention_sinks"] == window * n_req
            and launches["flash_attention_ref"] == 0 and not loops,
        "graphed after each sequence's first two steps":
            r["decode_graph"] == {"captured": n_req,
                                  "replayed": n_req * (n_dec - 1),
                                  "eager": n_req},
        "the pool's counters as on the CPU":
            r["kv_stats"] == on_cpu["kv_stats"]
            and r["kv_kinds"] == on_cpu["kv_kinds"],
        "finite logits": r["logits_finite"],
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"the hybrid serve path failed {bad}")
    return dict(launches=launches, decode_graph=r["decode_graph"],
                kv_kinds=r["kv_kinds"])


def kda_serve_path(dev, card, requests: int = 8, prefill: int = 96,
                   decode: int = 6):
    """kimi-linear-48b-a3b's serve at its published widths and all 27
    layers on the card, each MoE layer holding 8 of its 256 experts (the
    benchmark cell's EP32 share; weights from seed 0), graphed, from
    launch counts reset just before: one K4 pool launch a step (the latent
    kind; the state kind launches nothing), every MLA layer's prefill
    attention on K5's second form (q / k 192, v 128, no sinks) and none on
    the loop, every KDA layer's prefill chunk loop over ceil(prefill / 64)
    chunks, its decode step in each sequence's eager step and capture
    (the replays count none); the state kind's counters exact."""
    import dataclasses
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import attention as attn
    from repro_torch.models import kda
    from repro_torch.models import transformer as tf
    base = get_config("kimi-linear-48b-a3b")
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe,
                                                            held=(0, 8)))
    kda_layers, mla_layers = len(cfg.kda.layers), cfg.n_layers - len(
        cfg.kda.layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    loops = []
    real_loop = attn.blockwise_attention
    attn.blockwise_attention = lambda *a, **k: (loops.append(1)
                                               or real_loop(*a, **k))
    ops.reset_launches()
    fa.reset_variant_launches()
    try:
        r = serve.run(cfg, device=dev, params=params, requests=requests,
                      prefill=prefill, decode=decode, page_size=16,
                      hbm_pages=requests * (prefill + decode) // 64)
    finally:
        attn.blockwise_attention = real_loop
    launches = dict(ops.LAUNCHES)
    variants = dict(fa.VARIANT_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    slot = kda.state_bytes(cfg)
    print(f"[serve] {cfg.arch}: {cfg.n_layers} layers ({kda_layers} KDA, "
          f"{mla_layers} MLA), {r['n_params']:,} parameters, {requests} "
          f"requests, prefill {prefill}, decode {decode}: prefill "
          f"{r['prefill_s']:.3f} s, decode {r['decode_s']:.3f} s; launch "
          f"counts {launches}; graphs {r['decode_graph']}; kv kinds "
          f"{r['kv_kinds']}; peak {peak / 1e9:.2f} GB ({card})")
    checks = {
        "one K4 pool launch a step (the latent kind)":
            launches["paged_attention"] == decode
            and launches["paged_attention_ref"] == 0,
        "every MLA layer's prefill attention on K5's second form, none on "
        "the loop":
            launches["flash_attention"] == mla_layers * requests
            and variants["tensor_cores_own_v"] == mla_layers * requests
            and launches["flash_attention_sinks"] == 0
            and launches["flash_attention_ref"] == 0 and not loops,
        "every KDA layer's prefill chunks scanned":
            launches["kda_chunks"] == kda_layers * requests
            * math.ceil(prefill / cfg.kda.chunk),
        "every KDA layer's decode step in the eager steps and captures":
            launches["kda_steps"] == kda_layers * 2 * requests,
        "graphed after each sequence's first two steps":
            r["decode_graph"] == {"captured": requests,
                                  "replayed": requests * (decode - 1),
                                  "eager": requests},
        "the state kind's slots, reads and writes":
            r["kv_kinds"]["state"] == dict(
                slots=requests, slot_bytes=slot,
                held_bytes=requests * slot, reads=requests * decode,
                writes=requests * (1 + decode),
                read_bytes=requests * decode * slot,
                written_bytes=requests * (1 + decode) * slot)
            and slot == 2_170_880,
        "finite logits": r["logits_finite"],
    }
    del params, r
    torch.cuda.empty_cache()
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"the KDA serve path failed {bad}")
    return dict(launches=launches, variants=variants, peak_bytes=peak)


def paged_case(gen, b, h, kh, d, page, nblk, dtype, dev):
    """K4 inputs: sequence 0 empty, 1 ending one token into its second
    page, the rest random; entries past the live blocks out of range."""
    import torch
    n_pages = b * nblk
    q = torch.randn((b, h, d), generator=gen)
    kp = torch.randn((n_pages, page, kh, d), generator=gen)
    vp = torch.randn((n_pages, page, kh, d), generator=gen)
    bt = torch.randperm(n_pages, generator=gen).to(torch.int32).reshape(
        b, nblk)
    cl = torch.randint(1, nblk * page + 1, (b,), generator=gen,
                       dtype=torch.int32)
    cl[0], cl[1] = 0, page + 1
    live = (cl + page - 1) // page
    bt[torch.arange(nblk)[None, :] >= live[:, None]] = n_pages + 7
    return [x.to(dev, dtype) for x in (q, kp, vp)] + [bt.to(dev),
                                                      cl.to(dev)]


def contexts_case(gen, ctxs, h, kh, d, page, nblk, dtype, dev):
    """K4 inputs with one sequence per context in `ctxs`, nblk pages each;
    entries past the live blocks out of range."""
    import torch
    b = len(ctxs)
    n_pages = b * nblk
    q = torch.randn((b, h, d), generator=gen)
    kp = torch.randn((n_pages, page, kh, d), generator=gen)
    vp = torch.randn((n_pages, page, kh, d), generator=gen)
    bt = torch.randperm(n_pages, generator=gen).to(torch.int32).reshape(
        b, nblk)
    cl = torch.tensor(ctxs, dtype=torch.int32)
    live = (cl + page - 1) // page
    bt[torch.arange(nblk)[None, :] >= live[:, None]] = n_pages + 7
    return [x.to(dev, dtype) for x in (q, kp, vp)] + [bt.to(dev),
                                                      cl.to(dev)]


def k4_parity(dev, gen, serve_inputs, kv):
    """K4 against its plain version on the card."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    tol = {torch.float32: 3e-5, torch.bfloat16: 2e-2}
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}

    def check(label, args, dtype):
        kern = pa.paged_attention(*args)
        plain = pa.paged_attention_ref(*args)
        torch.cuda.synchronize()
        diff = (kern.float() - plain.float()).abs()
        err = float(diff.max())
        errs[dtype] = max(errs[dtype], err)
        ok = (not bool((diff > tol[dtype] * (1 + plain.float().abs())).any())
              and kern.dtype == args[0].dtype
              and bool(torch.isfinite(kern).all()))
        print(f"[parity K4] {label}: max|kernel - plain| = {err:.3g} "
              f"(tolerance {tol[dtype]:g}, rtol = atol)")
        if not ok:
            raise AssertionError(f"K4 disagrees with its plain version: "
                                 f"{label}")
        return kern

    for dtype in (torch.float32, torch.bfloat16):
        for d in (16, 64, 120, 128):
            for groups in (1, 4):
                args = paged_case(gen, 5, 2 * groups, 2, d, 16, 6, dtype,
                                  dev)
                kern = check(f"{str(dtype)[6:]} D={d} groups={groups} B=5 "
                             f"page 16 (empty, partial, padded rows)", args,
                             dtype)
                if not bool((kern[0] == 0).all()):
                    raise AssertionError("K4: an empty context is not 0")
    # split-K over the context: 6 sequences of 256 pages of 16, contexts
    # 0, 1, L - 1, L, L + 1 and 4096 (L the partition length), 1, 4 and 16
    # query heads per kv head; two calls give the same bits
    for dtype in (torch.float32, torch.bfloat16):
        for groups in (1, 4, 16):
            # the wrapper's plan for these shapes (only shapes, dtypes and
            # alignment count)
            pool = torch.empty((1, 16, 2, 120), dtype=dtype, device=dev)
            plan = pa.launch_plan(
                torch.empty((6, 2 * groups, 120), dtype=dtype, device=dev),
                pool, pool, torch.empty((6, 256), dtype=torch.int32))
            parts, part_len = plan["parts"], plan["part_len"]
            if parts < 2:
                raise AssertionError("K4's split cases did not split")
            ctxs = [0, 1, part_len - 1, part_len, part_len + 1, 4096]
            args = contexts_case(gen, ctxs, 2 * groups, 2, 120, 16, 256,
                                 dtype, dev)
            kern = check(f"{str(dtype)[6:]} D=120 groups={groups}, split "
                         f"into {parts} partitions of {part_len}, contexts "
                         f"{ctxs}", args, dtype)
            if not torch.equal(kern, pa.paged_attention(*args)):
                raise AssertionError("K4: two calls on the same inputs "
                                     "differ")
            if not bool((kern[0] == 0).all()):
                raise AssertionError("K4: an empty context is not 0")
    q, kp, vp, bt, cl = serve_inputs
    check(f"the serve loop's last step: q {tuple(q.shape)}, f32 pools "
          f"{tuple(kp.shape)}, block table {tuple(bt.shape)}, contexts "
          f"{cl.tolist()}", serve_inputs, torch.float32)
    check("the same step on the bf16 pools themselves",
          (q, kv.k_pool[0], kv.v_pool[0], bt, cl), torch.float32)
    return errs


# ---------------------------------------------------------------------------
# Phase 2c / 3: slice 4 — K5, K6, K7 through kernels.ops
# ---------------------------------------------------------------------------
TRIAD_SHAPE = (32768, 4096)        # a STREAM-sized array pair, f32
# K5 on the main path against its plain version: both accumulate in f32 and
# round to bf16 once, so they differ by at most one bf16 ulp (2**-8..2**-7
# relative) where the f32 sums straddle a rounding point.  Outputs there are
# small (RMS ~0.05 over 4096 keys), so the limit is absolute and relative
# 5e-3, and the error's RMS at most 1e-3 of the output's: ~5e-5 when right,
# 2.6e-3 for blockwise_attention's bf16 p on the same inputs (H100).
K5_PATH_TOL = 5e-3
K5_PATH_RMS = 1e-3
# against the port's prefill attention, which rounds p to bf16 before P.V
K5_BLOCKWISE_TOL = 3e-2


def table1_l2():
    """(sets, ways) of the Table-I host's L2: 2 MiB, 16 ways, 64 B lines."""
    from repro_torch.core.cache import CacheParams
    p = CacheParams()
    return p.l2_sets, p.l2_ways


def triad_trace_8x(dev):
    """The 8 x L2 STREAM triad line trace of the Table-I host (the §IV
    suite's largest row, 2,097,150 accesses)."""
    from repro_torch.core import cache as cache_mod
    from repro_torch.core import stream
    lay8 = stream.layout_for_footprint(8 * cache_mod.CacheParams().l2_bytes)
    return stream.stream_trace("triad", lay8, dev)[0]


def k6_parity(dev, gen, a8):
    """K6 against its plain version, bitwise on hits, tags and clocks: the
    JAX test's geometries, a trace that is no multiple of 32, the Table-I
    L2 on the first 16,384 accesses of the 8 x L2 triad trace and on a
    trace crowded into four sets, and the set chains' edge cases."""
    import torch
    from repro_torch.kernels import ops
    cases = [(f"{s} sets x {w} ways, N={n}",
              torch.randint(0, s * w * 4, (n,), generator=gen,
                            dtype=torch.int32), s, w)
             for s, w, n in ((16, 2, 256), (64, 4, 1024), (128, 8, 555),
                             (32, 1, 333), (64, 4, 1001))]
    sets, ways = table1_l2()
    cases.append((f"Table-I L2 ({sets} x {ways}), 8xL2 triad prefix "
                   f"N={PREFIX}", a8[:PREFIX].cpu(), sets, ways))
    cases.append((f"Table-I L2, 4 sets x 64 lines each, N={PREFIX}",
                  torch.randint(0, 4, (PREFIX,), generator=gen,
                                dtype=torch.int32)
                  + sets * torch.randint(0, 64, (PREFIX,), generator=gen,
                                         dtype=torch.int32), sets, ways))
    # the chain split's edge cases: one chain (1 set), two chains, several
    # sets per chain (8192 sets, 2 per chain in shared memory), 1 and 32
    # ways, an empty trace, every access in one set of the Table-I L2
    for s_, w_, n_ in ((1, 16, 20_000), (2, 32, 20_000), (8192, 16, 200_000),
                       (sets, 1, 50_000), (sets, 32, 50_000)):
        cases.append((f"chains: {s_} sets x {w_} ways, N={n_}",
                      torch.randint(0, s_ * w_ * 3, (n_,), generator=gen,
                                    dtype=torch.int32), s_, w_))
    cases.append(("chains: an empty trace at the Table-I L2",
                  torch.zeros(0, dtype=torch.int32), sets, ways))
    cases.append((f"chains: one set of the Table-I L2, 64 lines, N={PREFIX}",
                  sets * torch.randint(0, 64, (PREFIX,), generator=gen,
                                       dtype=torch.int32) + 7, sets, ways))
    err = 0
    for label, addr, s, w in cases:
        addr = addr.to(dev)
        kern = ops.cache_sim(addr, n_sets=s, n_ways=w)
        plain = ops.cache_sim_ref(addr, n_sets=s, n_ways=w)
        e = max_diff(zip(kern, plain))
        err = max(err, e)
        rate = float(kern[0].float().mean()) if addr.numel() else 0.0
        print(f"[parity K6] {label}: max|kernel - plain| = {e} over hits, "
              f"tags and clocks; hit rate {rate:.4f}")
        if e:
            raise AssertionError(f"K6 disagrees with its plain version: "
                                 f"{label}")
    return err


def k7_parity(dev, gen, largest=TRIAD_SHAPE):
    """K7 against its plain version, bitwise: f32 and bf16, s = 2.5 and 0.1,
    shapes from (8, 128) to the full STREAM-sized pair."""
    import torch
    from repro_torch.kernels import ops
    for shape in ((8, 128), (64, 1000), (1024, 4096), largest):
        for dtype in (torch.float32, torch.bfloat16):
            b = torch.randn(shape, generator=gen).to(dev, dtype)
            c = torch.randn(shape, generator=gen).to(dev, dtype)
            for s in (2.5, 0.1):
                kern = ops.stream_triad(b, c, s)
                same = torch.equal(kern, ops.stream_triad_ref(b, c, s))
                print(f"[parity K7] {shape} {str(dtype)[6:]} s={s}: kernel "
                      f"== plain version bitwise: {same}")
                if not same or kern.dtype != dtype:
                    raise AssertionError(f"K7 disagrees: {shape} {dtype} {s}")
            del b, c
    return 0


def k5_parity(dev, gen):
    """K5 against its plain version: the JAX test's five cases, D = 120,
    Sq < Sk and Sq > Sk, windows shorter than a tile and longer than the
    sequence, non-causal, a 24-row sequence, and bf16 at D = 12 (on the
    CUDA cores) (rtol = atol = 3e-5 in f32, 3e-2 in bf16)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    tol = {torch.float32: 3e-5, torch.bfloat16: 3e-2}
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(2, 4, 128, 128, 64, None, True, f32),
             (1, 2, 128, 256, 64, None, True, f32),
             (2, 4, 256, 256, 64, 64, True, f32),
             (1, 2, 128, 128, 128, None, True, bf16),
             (1, 8, 384, 384, 32, 128, True, f32),
             (1, 4, 512, 512, 120, None, True, f32),
             (1, 4, 512, 512, 120, None, True, bf16),
             (1, 2, 128, 512, 120, 200, True, f32),
             (1, 2, 512, 128, 120, None, True, f32),
             (1, 2, 256, 256, 64, 20, True, bf16),
             (1, 2, 256, 256, 64, 1000, True, f32),
             (1, 2, 256, 384, 64, None, False, f32),
             (1, 2, 256, 256, 64, 100, False, f32),
             (1, 1, 24, 24, 16, None, True, bf16),
             (1, 2, 512, 128, 120, None, True, bf16),
             (1, 2, 256, 384, 64, None, False, bf16),
             (1, 2, 256, 256, 128, 1000, True, bf16),
             (1, 2, 128, 128, 12, None, True, bf16)]
    for b, h, sq, sk, d, win, causal, dtype in cases:
        q, k, v = (torch.randn(s, generator=gen).to(dev, dtype)
                   for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d)))
        kern = ops.flash_attention(q, k, v, causal=causal, window=win)
        plain = ops.flash_attention_ref(q, k, v, causal=causal, window=win)
        torch.cuda.synchronize()
        diff = (kern.float() - plain.float()).abs()
        err = float(diff.max())
        errs[dtype] = max(errs[dtype], err)
        ok = (not bool((diff > tol[dtype] * (1 + plain.float().abs())).any())
              and kern.dtype == dtype and bool(torch.isfinite(kern).all()))
        if sq > sk and causal:
            ok = ok and bool((kern[:, :, :sq - sk] == 0).all())
        print(f"[parity K5] B={b} H={h} Sq={sq} Sk={sk} D={d} window={win} "
              f"causal={causal} {str(dtype)[6:]} ({fa.variant(dtype, d)}): "
              f"max|kernel - plain| = "
              f"{err:.3g} (tolerance {tol[dtype]:g}, rtol = atol)")
        if not ok:
            raise AssertionError(f"K5 disagrees with its plain version: "
                                 f"{(b, h, sq, sk, d, win, causal, dtype)}")
    return errs


def danube_layer0_qkv(cfg, params, seq: int, dev):
    """Layer 0's rotary q, k, v of `cfg` on a `seq`-token prompt of random
    ids (seed 1): q (1, Sq, H, D), k and v (1, Sq, K, D), as the prefill's
    attention computes them."""
    import torch
    from repro_torch.models import transformer as tf
    tokens = torch.randint(0, cfg.vocab_size, (1, seq), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(1))
    return tf.prefill_layer0_qkv(params, cfg, tokens)


def heads_first(q, k, v, n_heads: int):
    """(B, S, N or K, D) -> (B, H, S, D) with the kv heads repeated to the
    query heads (query head h reads kv head h // (H / K))."""
    g = n_heads // k.shape[2]
    return (q.transpose(1, 2).contiguous(),
            k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous(),
            v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous())


def plain_by_heads(q, k, v, parts: int, **kw):
    """K5's plain version over `parts` groups of heads (its f32 logits of a
    long sequence need (S x S x 4 B) per head)."""
    import torch
    from repro_torch.kernels import ops
    n = q.shape[1] // parts
    return torch.cat([ops.flash_attention_ref(
        q[:, i:i + n], k[:, i:i + n], v[:, i:i + n], **kw)
        for i in range(0, q.shape[1], n)], dim=1)


def k5_agreement(got, ref, tol: float, rms_tol):
    """K5's output against `ref`: within rtol = atol = `tol` everywhere and,
    unless `rms_tol` is None, RMS(got - ref) <= `rms_tol` * RMS(ref)."""
    diff = (got.float() - ref.float()).abs()
    ref_rms = float(ref.float().square().mean().sqrt())
    rel_rms = float(diff.square().mean().sqrt()) / ref_rms
    ok = bool((diff <= tol * (1 + ref.float().abs())).all())
    if rms_tol is not None:
        ok = ok and rel_rms <= rms_tol
    text = (f"max|err| {float(diff.max()):.3g} (rtol = atol = {tol:g}), "
            f"RMS(ref) {ref_rms:.4g}, RMS(err) / RMS(ref) {rel_rms:.3g}"
            + ("" if rms_tol is None else f" (limit {rms_tol:g})"))
    return dict(ok=ok, max=float(diff.max()), ref_rms=ref_rms,
                rel_rms=rel_rms, text=text)


def read_launches(kernel: str):
    from repro_torch.kernels import ops
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    if launches != {kernel: 1}:
        raise AssertionError(f"expected one {kernel} launch and no other "
                             f"kernel or plain-version call: {launches}")
    return launches


def reset_k5_launches():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    ops.reset_launches()
    fa.reset_variant_launches()


def read_k5_launches():
    """One K5 launch, on its tensor-core variant (the danube shapes are
    bf16 with D = 120)."""
    from repro_torch.kernels import flash_attention as fa
    launches = read_launches("flash_attention")
    if fa.VARIANT_LAUNCHES != {"tensor_cores": 1, "tensor_cores_own_v": 0,
                               "cuda_cores": 0}:
        raise AssertionError(f"K5 on the main path ran the variants "
                             f"{fa.VARIANT_LAUNCHES}, not the tensor cores")
    return dict(launches, variants=dict(fa.VARIANT_LAUNCHES))


def k5_prefill_path(dev, cfg, params, seqs=(8192, 1024, 1000)):
    """K5 as the serve's GQA prefill calls it: ``prefill_attention`` on
    `cfg`'s layer-0 q, k, v (kv heads broadcast, a ragged S padded to K5's
    tile) with no window, at each prompt length of `seqs`, the launch
    counts set to 0 just before each call and read just after, held to the
    plain version on the broadcast heads at the main path's limits.
    Returns each length's agreement, the summed launch counts and the
    first length's inputs for timing."""
    import torch
    from repro_torch.models.attention import prefill_attention
    errs, inputs = {}, None
    launches = {"flash_attention": 0, "variants": {}}
    for seq in seqs:
        q, k, v = danube_layer0_qkv(cfg, params, seq, dev)
        reset_k5_launches()
        got = prefill_attention(q, k, v, window=None, kv_chunk=cfg.kv_chunk)
        torch.cuda.synchronize()
        counts = read_k5_launches()
        launches["flash_attention"] += counts["flash_attention"]
        for n, c in counts["variants"].items():
            launches["variants"][n] = launches["variants"].get(n, 0) + c
        qh, kh, vh = heads_first(q, k, v, cfg.n_heads)
        plain = plain_by_heads(qh, kh, vh, 4, causal=True, window=None)
        agree = k5_agreement(got.transpose(1, 2), plain, K5_PATH_TOL,
                             K5_PATH_RMS)
        print(f"[slice 4] K5 through prefill_attention on {cfg.arch} layer "
              f"0, prompt {seq}, no window: q {tuple(q.shape)} "
              f"{str(q.dtype)[6:]} (kv heads {cfg.n_kv_heads}); launch "
              f"counts {counts}; against the plain version on the broadcast "
              f"heads {agree['text']}")
        if not (got.shape == q.shape and got.dtype == q.dtype
                and bool(torch.isfinite(got).all()) and agree["ok"]):
            raise AssertionError(f"K5 through prefill_attention disagrees "
                                 f"at a {seq}-token prompt")
        errs[seq] = {"plain": agree["max"], "ref_rms": agree["ref_rms"],
                     "rel_rms": agree["rel_rms"]}
        if inputs is None:
            inputs = dict(q=q, k=k, v=v)
        del plain, got, qh, kh, vh
    return dict(err=errs, launches=launches, **inputs)


def slice4_main_path(dev, cfg, params, a8, seq: int = 4096,
                     triad_shape=TRIAD_SHAPE):
    """Slice 4's path through kernels.ops at full width, the launch counts
    set to 0 just before each call and read just after: K5 on `cfg`'s
    layer-0 attention on a `seq`-token prompt, on a seeded (1, H, 2 seq,
    D) windowed case and through the serve's prefill
    (:func:`k5_prefill_path`), K6 on the trace `a8` at the Table-I L2, K7
    at `triad_shape`."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.attention import blockwise_attention
    out = {}
    # K5: the model's layer-0 attention on a `seq`-token prompt
    q, k, v = danube_layer0_qkv(cfg, params, seq, dev)
    qh, kh, vh = heads_first(q, k, v, cfg.n_heads)
    reset_k5_launches()
    got = ops.flash_attention(qh, kh, vh, causal=True, window=cfg.window)
    torch.cuda.synchronize()
    launches = read_k5_launches()
    plain = ops.flash_attention_ref(qh, kh, vh, causal=True,
                                    window=cfg.window)
    block = blockwise_attention(q, k, v, causal=True, window=cfg.window,
                                kv_chunk=cfg.kv_chunk).transpose(1, 2)
    agree = k5_agreement(got, plain, K5_PATH_TOL, K5_PATH_RMS)
    loose = k5_agreement(got, block, K5_BLOCKWISE_TOL, None)
    errs = {"plain": agree["max"], "blockwise": loose["max"],
            "ref_rms": agree["ref_rms"], "rel_rms": agree["rel_rms"]}
    ok = (got.shape == qh.shape and got.dtype == qh.dtype
          and bool(torch.isfinite(got).all()) and agree["ok"] and loose["ok"])
    print(f"[slice 4] K5 on {cfg.arch} layer 0, prompt {seq}: q "
          f"{tuple(qh.shape)} {str(qh.dtype)[6:]} (kv heads "
          f"{cfg.n_kv_heads} -> {cfg.n_heads}), window {cfg.window}; launch "
          f"counts {launches}; against the plain version {agree['text']}; "
          f"against blockwise_attention {loose['text']}")
    if not ok:
        raise AssertionError("K5 on the danube prefill disagrees")
    out["k5"] = dict(q=qh, k=kh, v=vh, err=errs)
    del plain, block
    # K5 windowed: (1, 32, 8192, 120) bf16 at danube's window, seeded inputs
    gen = torch.Generator(device=dev).manual_seed(2)
    wq, wk, wv = (torch.randn((1, cfg.n_heads, 2 * seq, cfg.head_dim),
                              generator=gen, device=dev,
                              dtype=torch.bfloat16) for _ in range(3))
    reset_k5_launches()
    got_w = ops.flash_attention(wq, wk, wv, causal=True, window=cfg.window)
    torch.cuda.synchronize()
    launches_w = read_k5_launches()
    plain_w = plain_by_heads(wq, wk, wv, 4, causal=True, window=cfg.window)
    agree_w = k5_agreement(got_w, plain_w, K5_PATH_TOL, K5_PATH_RMS)
    err_w = {"plain": agree_w["max"], "ref_rms": agree_w["ref_rms"],
             "rel_rms": agree_w["rel_rms"]}
    print(f"[slice 4] K5 windowed (1, {cfg.n_heads}, {2 * seq}, "
          f"{cfg.head_dim}) bf16, window {cfg.window}: launch counts "
          f"{launches_w}; against the plain version {agree_w['text']}")
    if not (agree_w["ok"] and bool(torch.isfinite(got_w).all())):
        raise AssertionError("K5 windowed disagrees")
    out["k5w"] = dict(q=wq, k=wk, v=wv, err=err_w)
    del plain_w, got_w
    out["k5p"] = k5_prefill_path(dev, cfg, params)
    launches_p = out["k5p"]["launches"]
    # K6 over the whole 8 x L2 triad trace at the Table-I L2
    sets, ways = table1_l2()
    ops.reset_launches()
    hits, tags, use = ops.cache_sim(a8, n_sets=sets, n_ways=ways)
    torch.cuda.synchronize()
    launches6 = read_launches("cache_sim")
    plain6 = ops.cache_sim_ref(a8, n_sets=sets, n_ways=ways)
    err6 = max_diff(zip((hits, tags, use), plain6))
    n = a8.shape[0]
    lines = int(torch.unique(a8).numel())
    # one pass, each line's accesses consecutive in its stream and at most
    # three lines live per set: every line misses once, then hits
    n_hits = int(hits.sum())
    ok6 = err6 == 0 and n_hits == n - lines and int(use.max()) == n
    print(f"[slice 4] K6 on the 8xL2 triad trace, N={n}, {sets} sets x "
          f"{ways} ways: launch counts {launches6}; hits {n_hits} = N - "
          f"{lines} distinct lines: {n_hits == n - lines}; "
          f"max|kernel - plain| = {err6} over hits, tags and clocks")
    if not ok6:
        raise AssertionError("K6 on the full trace is wrong")
    out["k6"] = dict(addr=a8, err=err6, n=n)
    # K7 at (32768, 4096) f32
    b = torch.randn(triad_shape, generator=gen, device=dev)
    c = torch.randn(triad_shape, generator=gen, device=dev)
    ops.reset_launches()
    a = ops.stream_triad(b, c, 2.5)
    torch.cuda.synchronize()
    launches7 = read_launches("stream_triad")
    same = torch.equal(a, ops.stream_triad_ref(b, c, 2.5))
    print(f"[slice 4] K7 at {triad_shape} f32, s = 2.5: launch counts "
          f"{launches7}; kernel == plain version bitwise: {same}")
    if not same or not bool(torch.isfinite(a).all()):
        raise AssertionError("K7 at full size disagrees")
    out["k7"] = dict(b=b, c=c)
    out["launches"] = {
        "flash_attention": (launches["flash_attention"]
                            + launches_w["flash_attention"]
                            + launches_p["flash_attention"]),
        "flash_attention_variants": {
            k: (launches["variants"][k] + launches_w["variants"][k]
                + launches_p["variants"][k])
            for k in launches["variants"]},
        "cache_sim": sum(launches6.values()),
        "stream_triad": sum(launches7.values())}
    return out


#: MiMo-V2-Flash's prefill attention on a 4,096-token prompt: (query heads,
#: KV heads, window, sinks) of its full and window layers (q and k 192
#: wide, v 128)
MIMO_PREFILL = {"full": (64, 4, None, False), "window": (64, 8, 128, True)}
#: K5 against the loop: one bf16 ulp of each element (over 1 + |loop|) and
#: one bf16 rounding of the output in RMS (the card tests' limits)
K5_LOOP_RTOL = 2 ** -7
K5_LOOP_RMS = 2 ** -8


def k5_mimo_times(dev, card, seq: int = 4096):
    """K5's second tensor-core form at MiMo-V2-Flash's two prefill shapes
    (the window layer's sinks drawn as the cell draws them, ln(128) + N(0,
    1)); see `k5_second_form`."""
    return {name: k5_second_form(dev, card, f"MiMo {name}", seq, n, kh,
                                 window, with_sinks)
            for name, (n, kh, window, with_sinks) in MIMO_PREFILL.items()}


def k5_kimi_times(dev, card, seq: int = 16384):
    """K5's second tensor-core form at the Kimi-Linear cell's MLA prefill
    shape: 32 query heads over 32 KV heads read in place, a 16,384-token
    prompt, q / k 192 and v 128, no sinks, the plain softmax scale; see
    `k5_second_form`."""
    return {"mla": k5_second_form(dev, card, "Kimi-Linear MLA", seq, 32, 32,
                                  None, False)}


def k5_second_form(dev, card, label, seq, n, kh, window, with_sinks):
    """K5's second form at one prefill shape (seeded bf16 q, k and v, n
    query heads over kh KV heads, q / k 192 and v 128 wide), as the
    prefill calls it (``gqa_flash_attention``: one launch, KV heads read
    in place), against the loop (``blockwise_attention``) at the same
    shape: agreement within one bf16 rounding, the launch counts, and
    CUDA-event times of the wrapper, of K5 alone on heads-first inputs and
    of the loop, beside ``flash_attention.bound_ms`` (2 x (192 + 128)
    flops a live pair)."""
    import math
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models.attention import (blockwise_attention,
                                              gqa_flash_attention)
    gen = torch.Generator(device=dev).manual_seed(kh)
    q, k, v = (torch.randn((1, seq, h, d), generator=gen, device=dev)
               .to(torch.bfloat16)
               for h, d in ((n, 192), (kh, 192), (kh, 128)))
    sinks = (math.log(128) + torch.randn(
        n, generator=gen, device=dev)) if with_sinks else None
    reset_k5_launches()
    got = gqa_flash_attention(q, k, v, window=window, sinks=sinks)
    torch.cuda.synchronize()
    launches = {k_: c for k_, c in ops.LAUNCHES.items() if c}
    variants = dict(fa.VARIANT_LAUNCHES)
    loop = blockwise_attention(q, k, v, window=window, sinks=sinks)
    diff = (got.float() - loop.float()).abs()
    rms = float(diff.square().mean().sqrt()
                / loop.float().square().mean().sqrt())
    max_err = float(diff.max())
    ok = (bool((diff <= K5_LOOP_RTOL * (1 + loop.float().abs())).all())
          and rms <= K5_LOOP_RMS and bool(torch.isfinite(got).all()))
    want = {"flash_attention": 1}
    if with_sinks:
        want["flash_attention_sinks"] = 1
    ok = ok and launches == want and variants == {
        "tensor_cores": 0, "tensor_cores_own_v": 1, "cuda_cores": 0}
    del diff, loop
    heads = [x.movedim(2, 1).contiguous() for x in (q, k, v)]
    kw = dict(causal=True, window=window, sinks=sinks)
    ms = cuda_ms(lambda: ops.flash_attention(*heads, **kw), warmup=2,
                 reps=10)
    wrapper_ms = cuda_ms(lambda: gqa_flash_attention(
        q, k, v, window=window, sinks=sinks), warmup=1, reps=10)
    loop_ms = cuda_ms(lambda: blockwise_attention(
        q, k, v, window=window, sinks=sinks), warmup=1, reps=2)
    bound, by, n_bytes, flops = fa.bound_ms(
        heads[0], heads[1], causal=True, window=window, v=heads[2])
    out = dict(ms=ms, gqa_flash_attention_ms=wrapper_ms,
               loop_ms=loop_ms, bound_ms=bound, bound_by=by,
               bound_share=bound / ms, tflops=flops / ms / 1e9,
               flops=flops, bytes=n_bytes, loop_max_err=max_err,
               loop_rel_rms=rms, launches=launches,
               shape=[1, n, kh, seq, 192, 128], window=window)
    print(f"[time K5] {label} prefill (1, {n} over {kh} KV heads, {seq}, "
          f"192 / 128) bf16 window {window} sinks {with_sinks}: K5 "
          f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
          f"{100 * bound / ms:.1f}% of the bound {bound:.4f} ms, {by}), "
          f"through gqa_flash_attention {wrapper_ms:.4f} ms, the loop "
          f"{loop_ms:.3f} ms; launches {launches}, variants {variants}; "
          f"against the loop max|err| {max_err:.3g}, RMS(err) / RMS(loop) "
          f"{rms:.3g} (limit {K5_LOOP_RMS:g}) ({card})")
    if not ok:
        raise AssertionError(f"K5 at the {label} prefill shape disagrees "
                             f"with the loop or ran {launches} / "
                             f"{variants}")
    return out


def sdpa_backend(q, k, v, **kw) -> str:
    """The backend PyTorch picks for ``scaled_dot_product_attention(q, k, v,
    **kw)`` (asked directly, not profiled: a profiler session here would
    change the wall times that phase 4 profiles later)."""
    import torch
    from torch.nn.attention import SDPBackend
    return SDPBackend(torch._fused_sdp_choice(q, k, v, **kw)).name


def cuda_core_k5(q, k, v, window):
    """K5's CUDA-core kernel (the first port's) on contiguous causal bf16
    inputs, which the wrapper sends to the tensor-core kernel: called
    through the library's own symbol, as the yardstick that the tensor-core
    kernel is timed against."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    device = (q.device.index if q.device.index is not None
              else torch.cuda.current_device())
    lib = fa._library()
    rc = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, sq,
        k.shape[2], d, 1, 1, window, d ** -0.5, 1, device,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the CUDA-core flash_attention kernel failed: "
                           f"CUDA error {rc} "
                           f"({lib.flash_attention_error_string(rc).decode()})")
    return out


def slice4_times(path, cfg, card):
    """K5, K6 and K7 at the main path's shapes: kernel, plain version and
    library call by CUDA events, and the bounds."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import cache_sim as cs
    from repro_torch.kernels import stream_triad as st
    from repro_torch.kernels.cache_sim import cache_sim_bound_bytes
    out = {}
    # K5, danube prefill (causal) and windowed
    for name, case, kw, parts in (
            ("causal", path["k5"], dict(causal=True, window=cfg.window), 1),
            ("windowed", path["k5w"], dict(causal=True, window=cfg.window),
             4)):
        q, k, v = case["q"], case["k"], case["v"]
        ms = cuda_ms(lambda: ops.flash_attention(q, k, v, **kw), warmup=1,
                     reps=5)
        # the CUDA-core kernel it replaces on bf16, on the same inputs
        qkv = [x.contiguous() for x in (q, k, v)]
        cc_ms = cuda_ms(lambda: cuda_core_k5(*qkv, kw["window"]), warmup=1,
                        reps=2)
        plain_ms = cuda_ms(lambda: plain_by_heads(q, k, v, parts, **kw),
                           warmup=1, reps=2)
        sq = q.shape[2]
        if name == "causal":
            lib_kw = dict(is_causal=True)
            lib_note = "scaled_dot_product_attention(is_causal=True)"
        else:
            i = torch.arange(sq, device=q.device)
            lib_kw = dict(attn_mask=(i[None, :] <= i[:, None])
                          & (i[None, :] > i[:, None] - kw["window"]))
            lib_note = ("scaled_dot_product_attention with an explicit "
                        "(S, S) bool band mask")

        def lib():
            return F.scaled_dot_product_attention(q, k, v, **lib_kw)
        lib_ms = cuda_ms(lib, warmup=1, reps=5)
        lib_err = float((lib().float() - ops.flash_attention(
            q, k, v, **kw).float()).abs().max())
        backend = sdpa_backend(q, k, v, **lib_kw)
        bound, by, n_bytes, flops = fa.bound_ms(q, k, **kw)
        out[name] = dict(ms=ms, cuda_cores_ms=cc_ms, plain_ms=plain_ms,
                         library_ms=lib_ms,
                         library=lib_note, library_backend=backend,
                         library_err=lib_err, bound_ms=bound, bound_by=by,
                         tflops=flops / ms / 1e9, shape=list(q.shape),
                         flops=flops, bytes=n_bytes)
        print(f"[time K5] {name} {tuple(q.shape)} bf16 window {kw['window']}"
              f": tensor-core kernel {ms:.4f} ms ({flops / ms / 1e9:.2f} "
              f"TFLOP/s), CUDA-core kernel {cc_ms:.3f} ms, bound "
              f"{bound:.4f} ms ({by}: {flops} flops at 989 TFLOP/s, "
              f"{n_bytes} B at 3.35 TB/s), plain version {plain_ms:.3f} ms, "
              f"{lib_note} {lib_ms:.3f} ms via {backend} (max|SDPA - "
              f"kernel| {lib_err:.3g}) ({card})")
    # K5 through the serve's prefill: the first prompt length, causal, no
    # window; the wrapper (heads broadcast, S padded) and K5 alone
    from repro_torch.models.attention import prefill_attention
    p = path["k5p"]
    qh, kh, vh = heads_first(p["q"], p["k"], p["v"], cfg.n_heads)
    wrapper_ms = cuda_ms(lambda: prefill_attention(
        p["q"], p["k"], p["v"], window=None, kv_chunk=cfg.kv_chunk),
        warmup=1, reps=5)
    ms = cuda_ms(lambda: ops.flash_attention(qh, kh, vh, causal=True,
                                             window=None), warmup=1, reps=5)
    bound, by, n_bytes, flops = fa.bound_ms(qh, kh, causal=True, window=None)
    out["prefill"] = dict(ms=ms, prefill_attention_ms=wrapper_ms,
                          bound_ms=bound, bound_by=by, window=None,
                          tflops=flops / ms / 1e9, shape=list(qh.shape),
                          flops=flops, bytes=n_bytes)
    print(f"[time K5] serve prefill {tuple(qh.shape)} bf16 causal, no "
          f"window: tensor-core kernel {ms:.4f} ms ({flops / ms / 1e9:.2f} "
          f"TFLOP/s), through prefill_attention (kv heads broadcast) "
          f"{wrapper_ms:.4f} ms, bound {bound:.4f} ms ({by}: {flops} flops "
          f"at 989 TFLOP/s, {n_bytes} B at 3.35 TB/s) ({card})")
    del qh, kh, vh
    # K6 on the whole trace
    a8 = path["k6"]["addr"]
    n = path["k6"]["n"]
    sets, ways = table1_l2()
    # the kernel alone, and through the wrapper (whose check for negative
    # addresses syncs with the host)
    ms = cuda_ms(lambda: cs._launch_cache_sim(a8, sets, ways), warmup=2,
                 reps=10)
    wrapper_ms = cuda_ms(lambda: ops.cache_sim(a8, n_sets=sets, n_ways=ways),
                         warmup=2, reps=10)
    plain_ms = cuda_ms(lambda: ops.cache_sim_ref(a8, n_sets=sets,
                                                 n_ways=ways),
                       warmup=1, reps=1)
    n_bytes = cache_sim_bound_bytes(n, sets, ways)
    bound = n_bytes / HBM_BYTES_PER_S * 1e3
    # the set chains: the longest, the device time of the pre-pass's kernels
    # and of the chain kernel, and one chain alone (a 65,536-access trace of
    # one set) for the latency of an access on a chain
    plan = cs.cache_sim_plan(sets, ways, a8.device)
    m = 1 << plan["bits"]
    longest = int(torch.bincount((a8 & (m - 1)).long(), minlength=m).max())
    one = a8[:65_536].remainder(48)
    one_ms = cuda_ms(lambda: cs._launch_cache_sim(one, 1, ways), warmup=1,
                     reps=3)
    one_us = 1e3 * one_ms / one.numel()
    dev6 = device_times(lambda: cs._launch_cache_sim(a8, sets, ways), 10)
    chain_dev = sum(v for k, v in dev6.items() if "chain_kernel" in k)
    total_dev = sum(dev6.values())
    measured = total_dev > 0
    out["k6"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, n=n,
                     shape=[n], geometry=[sets, ways], wrapper_ms=wrapper_ms,
                     device_ms=total_dev if measured else None,
                     chain_device_ms=chain_dev if measured else None,
                     prepass_device_ms=(total_dev - chain_dev if measured
                                        else None),
                     chains=m, longest_chain=longest,
                     us_per_access_on_chain=(1e3 * chain_dev / longest
                                             if measured else None),
                     one_chain_us_per_access=one_us,
                     chain_floor_ms=longest * one_us / 1e3)
    print(f"[time K6] N={n}, {sets} x {ways}: kernel {ms:.4f} ms "
          f"({1e6 * ms / 1e3 / n:.5f} us per access of the trace), "
          f"{wrapper_ms:.4f} ms through the wrapper; bytes bound "
          f"{bound:.4f} ms ({n_bytes} B at 3.35 TB/s); plain version "
          f"{plain_ms:.3f} ms ({card})")
    print(f"[time K6]   {m} chains ({plan['blocks']} blocks of "
          f"{plan['warps_per_block']} warps, sets in "
          f"{'registers' if plan['in_regs'] else 'memory'}), the longest "
          f"{longest} accesses; one chain alone {one_us:.4f} us per access, "
          f"so the chain floor is {longest} x {one_us:.4f} us = "
          f"{longest * one_us / 1e3:.4f} ms beside the bytes bound")
    if measured:
        print(f"[time K6]   device time per launch by the profiler: "
              f"{total_dev:.4f} ms: the chain kernel {chain_dev:.4f} ms "
              f"({1e3 * chain_dev / longest:.4f} us per access on the "
              f"longest chain), the bucket pre-pass "
              f"{total_dev - chain_dev:.4f} ms "
              f"({100 * (total_dev - chain_dev) / total_dev:.1f}%): "
              + ", ".join(f"{kernel_label(k)} {v:.4f}" for k, v in
                          sorted(dev6.items(), key=lambda kv: -kv[1])))
    else:
        print("[time K6]   the profiler saw no device time (the pre-pass's "
              "share and the time per access on a chain not measured)")
    # K7 at the STREAM-sized pair, timed in rounds between torch.add calls
    b, c = path["k7"]["b"], path["k7"]["c"]
    times, add_ms = [], []
    for _ in range(3):
        add_ms.append(cuda_ms(lambda: torch.add(b, c, alpha=2.5), warmup=3,
                              reps=20))
        times.append(cuda_ms(lambda: ops.stream_triad(b, c, 2.5), warmup=3,
                             reps=20))
        add_ms.append(cuda_ms(lambda: torch.add(b, c, alpha=2.5), warmup=3,
                              reps=20))
    ms = sum(times) / len(times)
    plain_ms = cuda_ms(lambda: ops.stream_triad_ref(b, c, 2.5), warmup=3,
                       reps=20)
    lib_ms = sum(add_ms) / len(add_ms)
    n_bytes = st.bound_bytes(b)
    bound = n_bytes / HBM_BYTES_PER_S * 1e3
    out["k7"] = dict(ms=ms, runs=times, plain_ms=plain_ms,
                     library_ms=lib_ms, library_runs=add_ms,
                     bound_ms=bound, gbps=n_bytes / ms / 1e6,
                     shape=list(b.shape))
    print(f"[time K7] {tuple(b.shape)} f32: kernel {ms:.4f} ms over three "
          f"rounds (" + ", ".join(f"{x:.4f}" for x in times) + f"; "
          f"{n_bytes / ms / 1e6:.1f} GB/s, {100 * bound / ms:.1f}% of the "
          f"bound), bound {bound:.4f} ms ({n_bytes} B at 3.35 TB/s), plain "
          f"version {plain_ms:.4f} ms, torch.add(b, c, alpha=2.5) "
          f"{lib_ms:.4f} ms (runs " + ", ".join(f"{x:.4f}" for x in add_ms)
          + f") ({card})")
    return out


# ---------------------------------------------------------------------------
# Phase 3c: slice 8 — streamed, sharded and resumed sweeps, the
# cache-pollution probe and MoEStream
# ---------------------------------------------------------------------------
# pollution_probe's dicts as the JAX package computes them (its default
# backend "reference", on the CPU): the Table-I geometry (CacheParams())
# at the default knobs and at probe_fraction=0.25, pollutor_factor=1, and
# the golden geometry at 0.125 and 1.  The defaults evict the whole probe,
# which a wrong kernel could also do; the other two discriminate.
# tests/test_torch_pollution.py holds them against the JAX package.
POLLUTION = {
    "table1": {"probe_lines": 16384, "pollutor_accesses": 524288,
               "probe_miss_rate_clean": 0.0, "probe_miss_rate_polluted": 1.0,
               "pollution_delta": 1.0},
    "table1 (0.25, 1)": {"probe_lines": 8192, "pollutor_accesses": 131072,
                         "probe_miss_rate_clean": 0.0,
                         "probe_miss_rate_polluted": 0.828125,
                         "pollution_delta": 0.828125},
    "golden (0.125, 1)": {"probe_lines": 32, "pollutor_accesses": 1024,
                          "probe_miss_rate_clean": 0.0,
                          "probe_miss_rate_polluted": 0.21875,
                          "pollution_delta": 0.21875},
}
POLLUTION_KNOBS = {"table1": {},
                   "table1 (0.25, 1)": dict(probe_fraction=0.25,
                                            pollutor_factor=1),
                   "golden (0.125, 1)": dict(probe_fraction=0.125,
                                             pollutor_factor=1)}
SUITE_CHUNK = 262_144              # (a): 8 segments of the 8 x L2 row
POLICY_CHUNK = 65_536              # (a): 16 segments of the 4 x L2 rows
SWEEP_A_CHUNK = 131_072            # (b), (c): 64 slots of 2,048 a segment


def run_path(paths, name, fn, *, kernel, launches=None, raises=None):
    """`fn()` with the launch counts set to 0 just before and read just
    after: wall (host clock) and CUDA events around the call, which ends
    in a synchronize.  Fails if a plain version ran, or if `kernel` was
    launched other than `launches` times (at least once when None).  With
    `raises`, the call must raise that exception."""
    import torch
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    ops.reset_launches()
    t0 = time.perf_counter()
    start.record()
    try:
        out = fn()
    except BaseException as exc:
        if raises is None or not isinstance(exc, raises):
            raise
        out = exc
    else:
        if raises is not None:
            raise AssertionError(f"{name}: {raises.__name__} not raised")
    stop.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    counts = dict(ops.LAUNCHES)
    paths[name] = dict(launches=counts, wall_ms=wall,
                       events_ms=start.elapsed_time(stop))
    refs = {k: v for k, v in counts.items() if k.endswith("_ref") and v}
    n = counts[kernel]
    if refs or (n < 1 if launches is None else n != launches):
        raise AssertionError(f"[slice 8] {name}: {kernel} launched {n} "
                             f"times (want {launches or '>= 1'}), plain "
                             f"versions {refs}")
    print(f"[slice 8] {name}: {n} {kernel} launches, wall {wall:.2f} ms, "
          f"events {paths[name]['events_ms']:.2f} ms")
    return out


def same_rows(name, got, want) -> None:
    """Rows equal as dicts: counters bitwise, floats to the bit."""
    if got != want:
        bad = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w) \
            if len(got) == len(want) else "count"
        raise AssertionError(f"[slice 8] {name}: rows differ from the "
                             f"resident rows (first at {bad})")


def padding_rows_on_the_card(sim, dev):
    """Shard padding rows (all sentinel from their first access) through K2
    and K3 against the plain versions, bitwise: zero stats, untouched
    state, no meeting at K3's boundaries; and a segment call leaves its
    input carry unchanged."""
    import torch
    from repro_torch.core import cache as cache_mod
    from repro_torch.core import distribute, tiering_dyn
    from repro_torch.kernels import cache_sim
    gen = torch.Generator().manual_seed(8)
    p = cache_mod.CacheParams(**GOLDEN_GEOMETRY)
    real = torch.randint(0, 2048, (1, 4096), generator=gen,
                         dtype=torch.int32)
    addr = distribute._pad_rows(real, 3, cache_mod.SENTINEL).to(dev)
    zero = torch.zeros_like(addr)
    tier = torch.randint(0, 2, addr.shape, generator=gen,
                         dtype=torch.int32).to(dev)
    carry = cache_mod.init_batch_carry(p, 3, device=dev)
    before = [x.clone() for x in carry]
    got = cache_sim.mesi_segment(carry, addr, zero, zero, tier, params=p)
    kept = all(torch.equal(a, b) for a, b in zip(before, carry))
    want = cache_sim.mesi_segment(carry, addr, zero, zero, tier, params=p,
                                  backend="reference")
    err = max_diff(zip(got, want))
    idle = (int(got[2][1:].abs().sum()) == 0
            and all(torch.equal(g[1:], b[1:]) for g, b in
                    zip(got[:2], before[:2])))
    print(f"[parity padding] K2, 1 row + 2 all-sentinel rows x 4096: max "
          f"err {err}, padding rows idle {idle}, input carry unchanged "
          f"{kept}")
    if err or not (idle and kept):
        raise AssertionError("K2 on padding rows differs from its plain "
                             "version or wrote its input carry")
    # K3: sweep A's launch padded to 12 rows as a 4-shard mesh pads it;
    # rows 8 (tpp(4096), KVDecode) to 11 (padding), the first 2 slots
    plan = sweep_launch(sim, "A", dev)
    kw = plan.kwargs
    a3, w3, c3, t3, pmap0, scalars, k_max, bound = \
        tiering_dyn.prep_dynamic_inputs(
            *distribute._static_fields(plan.batch.batch, 12),
            slot_len=kw["slot_len"], k_max=kw["k_max"],
            **distribute._dynamic_scalars(plan.batch, 12))
    sel = slice(8, 12)
    xs = [x[sel, :2].contiguous() for x in (a3, w3, c3, t3)]
    sc = [s[sel] for s in scalars]
    carry = tiering_dyn.init_dyn_carry(plan.params, pmap0[sel])
    before = [x.clone() for x in carry]
    got = tiering_dyn.run_dynamic_segment(plan.params, k_max, bound, carry,
                                          *xs, *sc)
    kept = all(torch.equal(a, b) for a, b in zip(before, carry))
    want = tiering_dyn.run_dynamic_segment(plan.params, k_max, bound, carry,
                                           *xs, *sc, backend="reference")
    err = max(max_diff(zip(got[0], want[0])), max_diff(zip(got[1:],
                                                          want[1:])))
    idle = int(got[0][2][1:].abs().sum()) == 0
    meet = cache_sim.meets(sc[2][1:], sc[4][1:], carry[8][1:], 2)
    print(f"[parity padding] K3, sweep A row 8 + 3 padding rows x 2 slots: "
          f"max err {err}, padding rows idle {idle}, padding rows meet "
          f"{meet}, input carry unchanged {kept}")
    if err or not idle or meet or not kept:
        raise AssertionError("K3 on padding rows differs from its plain "
                             "version, meets, or wrote its input carry")
    return err


def moe_rows_ok(rows, sim) -> None:
    """Row invariants of the MoEStream sweep, as phase 3 checks STREAM's."""
    from repro_torch.workloads import MoEStream
    l2 = sim.config.cache.l2_bytes
    for r in rows:
        s = r["stats"]
        n = MoEStream().device_trace(r["footprint_x_l2"] * l2,
                                     sim.device).n_accesses
        checks = {
            "l1 accesses == trace length": s["l1_hit"] + s["l1_miss"] == n,
            "l2 accesses == l1 misses":
                s["l2_hit"] + s["l2_miss"] == s["l1_miss"],
            "memory reads == l2 misses":
                s["mem_read_dram"] + s["mem_read_cxl"] == s["l2_miss"],
            "finite floats": finite_floats(r),
            "no writes": s["mem_write_dram"] == s["mem_write_cxl"] == 0,
        }
        if r["policy"] == "znuma(cxl=100%)":
            checks["no DRAM traffic"] = s["mem_read_dram"] == 0
        if r["policy"] == "znuma(cxl=0%)":
            checks["no CXL traffic"] = s["mem_read_cxl"] == 0
        bad = [k for k, ok in checks.items() if not ok]
        print("[slice 8] moe_stream " + json.dumps(
            {k: r[k] for k in ("footprint_x_l2", "policy", "time_ns",
                               "bw_total_gbps", "l2_miss_rate")}
            | {"stats": s}))
        if bad:
            raise AssertionError(f"moe_stream row invariants failed {bad}")


def slice8_path(sim, dev, card, static, sweeps):
    """Slice 8's paths at the Table-I host, each through `CXLRAMSim.sweep`
    or `pollution_probe` with no plain-version call: (a) the §IV suite
    sharded and streamed, (b) sweep A sharded and streamed, (c) sweep A
    crashed and resumed, and with a transient and an OOM fault, (d) the
    pollution probe, (e) MoEStream."""
    import tempfile
    import torch
    from repro_torch.core import cache as cache_mod
    from repro_torch.core import distribute, numa
    from repro_torch.core.resilience import (CheckpointPolicy, Fault,
                                             FaultPlan, RunKilled,
                                             RunReport)
    from repro_torch.workloads import MoEStream, pollution_probe
    paths = {}
    three = [numa.ZNuma(0.0), numa.WeightedInterleave(1, 1), numa.ZNuma(1.0)]
    k1, k3 = "mesi_segment", "mesi_dyn_segment"
    sweep_a = dynamic_sweeps()["A"]

    # (a) the §IV suite: resident (for the same call's times), 4 shards x 8
    # segments, 3 shards (the last all padding), three policies streamed
    run_path(paths, "suite resident", lambda: sim.stream_suite((2, 4, 6, 8)),
             kernel=k1, launches=1)
    rows = run_path(paths, "suite mesh=4 stream_chunk=262144",
                    lambda: sim.sweep((2, 4, 6, 8), mesh=4,
                                      stream_chunk=SUITE_CHUNK),
                    kernel=k1, launches=4 * 8)
    same_rows("suite mesh=4 stream_chunk=262144", rows, static["suite"])
    rows = run_path(paths, "suite mesh=Mesh(3)",
                    lambda: sim.sweep((2, 4, 6, 8),
                                      mesh=distribute.Mesh(n_shards=3)),
                    kernel=k1, launches=3)
    same_rows("suite mesh=Mesh(3)", rows, static["suite"])
    rows = run_path(paths, "policies stream_chunk=65536",
                    lambda: sim.sweep((4,), policies=three,
                                      stream_chunk=POLICY_CHUNK),
                    kernel=k1, launches=16)
    same_rows("policies stream_chunk=65536", rows, static["policies"])

    # (b) sweep A: resident, 3 shards x 8 segments of 64 slots, and 4
    # shards (the last all padding)
    run_path(paths, "A resident", lambda: sim.sweep((8,), **sweep_a),
             kernel=k3, launches=1)
    rows = run_path(paths, "A mesh=3 stream_chunk=131072",
                    lambda: sim.sweep((8,), mesh=3,
                                      stream_chunk=SWEEP_A_CHUNK, **sweep_a),
                    kernel=k3, launches=3 * 8)
    same_rows("A mesh=3 stream_chunk=131072", rows, sweeps["A"]["rows"])
    rows = run_path(paths, "A mesh=4", lambda: sim.sweep((8,), mesh=4,
                                                         **sweep_a),
                    kernel=k3, launches=4)
    same_rows("A mesh=4", rows, sweeps["A"]["rows"])

    # (c) crash at shard 1, segment 3, then resume; then one transient
    # and one OOM fault
    def resilient(**kw):
        return sim.sweep((8,), mesh=3, stream_chunk=SWEEP_A_CHUNK,
                         **sweep_a, **kw)

    with tempfile.TemporaryDirectory() as d:
        pol = CheckpointPolicy(d, every_segments=2)
        run_path(paths, "A crashed", lambda: resilient(
            resume=pol, fault_plan=FaultPlan((Fault("crash", shard=1,
                                                    segment=3),))),
            kernel=k3, launches=8 + 3, raises=RunKilled)
        # shard 0 restores at its end, shard 1 at segment 2 (when its
        # asynchronous save finished before the crash), shard 2 from 0
        report = RunReport()
        rows = run_path(paths, "A resumed",
                        lambda: resilient(resume=pol, report=report),
                        kernel=k3)
    same_rows("A resumed", rows, sweeps["A"]["rows"])
    ckpt = report.summary()
    print(f"[slice 8] A resumed: {ckpt} ({card})")
    if report.resumes < 1 or paths["A resumed"]["launches"][k3] >= \
            paths["A mesh=3 stream_chunk=131072"]["launches"][k3]:
        raise AssertionError(f"the resumed run did not fast-forward: {ckpt}")
    faults = RunReport()
    rows = run_path(paths, "A transient + OOM", lambda: resilient(
        fault_plan=FaultPlan((Fault("transient", shard=0, segment=1),
                              Fault("oom", shard=2, oom_above=65_536))),
        report=faults), kernel=k3, launches=8 + 8 + 16)
    same_rows("A transient + OOM", rows, sweeps["A"]["rows"])
    print(f"[slice 8] A transient + OOM: {faults.summary()}")
    if faults.retries != 1 or faults.degradations < 1:
        raise AssertionError(f"recovery not as injected: {faults.summary()}")

    # (d) the pollution probe at Table-I, one K1 launch of 4 rows each; at
    # the golden geometry the kernel and the plain version on the card
    for label in ("table1", "table1 (0.25, 1)"):
        got = run_path(paths, f"pollution {label}", lambda label=label:
                       pollution_probe(cache_mod.CacheParams(), device=dev,
                                       **POLLUTION_KNOBS[label]),
                       kernel=k1, launches=1)
        print(f"[slice 8] pollution_probe {label}: {got}")
        if got != POLLUTION[label]:
            raise AssertionError(f"pollution_probe {label} differs from the "
                                 f"JAX package's {POLLUTION[label]}")
    golden = cache_mod.CacheParams(**GOLDEN_GEOMETRY)
    label = "golden (0.125, 1)"
    got = pollution_probe(golden, device=dev, **POLLUTION_KNOBS[label])
    plain = pollution_probe(golden, device=dev, backend="reference",
                            **POLLUTION_KNOBS[label])
    print(f"[parity pollution] {label}: kernel {got}, plain version "
          f"equal {plain == got}, JAX's equal {got == POLLUTION[label]}")
    if not got == plain == POLLUTION[label]:
        raise AssertionError(f"pollution_probe {label} differs")

    # (e) MoEStream at Table-I: device trace == host trace at 8 x L2, the
    # three-policy sweep in one K1 launch, streamed in 2 segments
    wl, fp = MoEStream(), 8 * sim.config.cache.l2_bytes
    dt, ht = wl.device_trace(fp, dev), wl.host_trace(fp)
    same = dt.n_pages == ht.n_pages and all(
        torch.equal(getattr(dt, f), torch.from_numpy(getattr(ht, f)).to(dev))
        for f in ("addr", "is_write"))
    print(f"[slice 8] moe_stream at 8 x L2: {dt.n_accesses} accesses over "
          f"{dt.n_pages} pages; device trace == host trace: {same}")
    if not same:
        raise AssertionError("MoEStream's device and host traces differ")
    rows = run_path(paths, "moe resident", lambda: sim.sweep(
        (2, 4, 8), workloads=[wl], policies=three), kernel=k1, launches=1)
    moe_rows_ok(rows, sim)
    streamed = run_path(paths, "moe stream_chunk=262144", lambda: sim.sweep(
        (2, 4, 8), workloads=[wl], policies=three,
        stream_chunk=SUITE_CHUNK), kernel=k1, launches=2)
    same_rows("moe stream_chunk=262144", streamed, rows)
    return dict(paths=paths, checkpoint=ckpt, faults=faults.summary())


# ---------------------------------------------------------------------------
# Phase 4: times
# ---------------------------------------------------------------------------
def chain_line(plan, b, launch_ms, prepass_ms):
    """Phase 4's account of a MESI launch's shape: chains, blocks, the most
    SMs they can occupy (min(SMs, blocks): where the scheduler puts the
    blocks is not read) and the bucket pre-pass's share of the launch."""
    blocks = plan["blocks_per_row"] * b
    return (f"{1 << plan['bits']} chains per row ({b * (1 << plan['bits'])}"
            f" chain warps, {plan['warps_per_block']} per block), {blocks} "
            f"blocks (at most {min(plan['sms'], blocks)} of the card's "
            f"{plan['sms']} SMs); "
            f"bucket pre-pass {prepass_ms:.3f} ms alone, "
            f"{100 * prepass_ms / launch_ms:.1f}% of the launch")


def k1_launch(batch, table1, dev, card, label):
    """Time one K1 launch over a sweep batch; print its shape and rate."""
    from repro_torch.core import cache as cache_mod
    from repro_torch.kernels import cache_sim
    args = (batch.addr, batch.is_write, batch.core, batch.tier)
    ms = cuda_ms(lambda: cache_sim.mesi_cache_sim(*args, params=table1),
                 reps=3)
    bits = cache_sim.chain_bits(table1)
    prepass_ms = cuda_ms(lambda: cache_sim.bucket(*args, bits), reps=3)
    b, n_pad = batch.addr.shape
    carry = cache_mod.init_batch_carry(table1, b, device=dev)
    carry_bytes = sum(x.numel() * x.element_size() for x in carry)
    accesses = int(batch.n_valid.sum())
    bound_bytes = 16 * accesses + 2 * carry_bytes
    bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[time K1] {label} launch B={b} x N={n_pad}: kernel {ms:.3f} ms "
          f"({accesses / ms / 1e3:.3f} M accesses/s), bytes bound "
          f"{bound_ms:.4f} ms ({bound_bytes} B at 3.35 TB/s) ({card})")
    shape = chain_line(cache_sim.mesi_plan(table1, dev), b, ms, prepass_ms)
    print(f"[time K1]   {shape}")
    return dict(ms=ms, shape=[b, n_pad], bound_ms=bound_ms,
                prepass_ms=prepass_ms, accesses=accesses)


def k1_times(dev, table1, card):
    from repro_torch.core import engine, numa
    from repro_torch.kernels import cache_sim
    batch, _ = engine.build_sweep_batch(
        engine.SweepSpec(footprint_factors=(2, 4, 6, 8)), table1,
        device=dev)
    out = k1_launch(batch, table1, dev, card, "main-path suite")
    args = (batch.addr, batch.is_write, batch.core, batch.tier)
    for i, k in enumerate((2, 4, 6, 8)):
        n = int(batch.n_valid[i])
        one = [x[i:i + 1, :n].contiguous() for x in args]
        ms = cuda_ms(lambda: cache_sim.mesi_cache_sim(*one, params=table1))
        print(f"[time K1] {k}xL2 row: N={n} accesses, kernel {ms:.3f} ms, "
              f"{n / ms / 1e3:.3f} M accesses/s ({card})")
    policies, _ = engine.build_sweep_batch(
        engine.SweepSpec(footprint_factors=(4,), policies=(
            numa.ZNuma(0.0), numa.WeightedInterleave(1, 1),
            numa.ZNuma(1.0))), table1, device=dev)
    out["policy"] = k1_launch(policies, table1, dev, card,
                              "main-path three-policy")
    return out


def k3_times(sim, dev, card):
    import torch
    from repro_torch.core import tiering_dyn
    from repro_torch.kernels import cache_sim
    out = {}
    for name in dynamic_sweeps():
        plan = sweep_launch(sim, name, dev)
        a3, w3, c3, t3, pmap0, scalars, k_max, bound = \
            tiering_dyn.prep_dynamic_inputs(*plan.trace, **plan.kwargs)
        carry = tiering_dyn.init_dyn_carry(plan.params, pmap0)
        args = (a3, w3, c3, t3) + tuple(scalars)
        n_valid = plan.batch.batch.n_valid

        def launch(carry=carry, args=args, sel=slice(None)):
            return cache_sim.mesi_dyn_segment(
                tuple(x[sel] for x in carry), *(x[sel] for x in args),
                params=plan.params, k_max=k_max, count_bound=bound)

        ms = cuda_ms(launch, reps=3)
        b, e, slot = args[0].shape
        accesses = int(n_valid.sum())
        _, slots, snaps, meas = launch()

        def nbytes(*xs):
            return sum(x.numel() * x.element_size() for x in xs)

        # each real access's 4 int32 fields, the carry read and written,
        # the page table and 13 scalars per row read, the per-slot
        # outputs written
        bound_bytes = (16 * accesses + 2 * nbytes(*carry) + nbytes(args[12])
                       + 13 * 4 * b + nbytes(slots, snaps, meas))
        bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
        print(f"[time K3] sweep {name} launch B={b} x E={e} x slot={slot}: "
              f"kernel {ms:.3f} ms, {accesses} real accesses, "
              f"{accesses / ms / 1e3:.3f} M accesses/s; bytes bound "
              f"{bound_ms:.4f} ms ({bound_bytes} B at 3.35 TB/s) ({card})")
        budget = args[6]
        meet = cache_sim.meets(budget, args[8], carry[8], e)
        dplan = cache_sim.mesi_dyn_plan(plan.params, b, pmap0.shape[1], dev,
                                        meet=meet)
        flat = [x.reshape(b, e * slot) for x in args[:4]]
        prepass_ms = cuda_ms(lambda: cache_sim.bucket(*flat, dplan["bits"]),
                             reps=3)
        print(f"[time K3]   {chain_line(dplan, b, ms, prepass_ms)}; "
              f"{dplan['rows_per_launch']} rows per launch, the chains of "
              f"a row meeting at its boundaries: {meet}")
        entry = dict(ms=ms, shape=[b, e, slot], bound_ms=bound_ms,
                     accesses=accesses, prepass_ms=prepass_ms)
        if meet:
            # the same launch with every budget 0: no row meets, so the
            # difference is what the boundaries cost
            nobud = args[:6] + (torch.zeros_like(budget),) + args[7:]
            ms0 = cuda_ms(lambda: launch(args=nobud), reps=3)
            print(f"[time K3]   the same launch with every budget 0 (no "
                  f"boundary work, no meeting): {ms0:.3f} ms; the "
                  f"boundaries take {100 * (1 - ms0 / ms):.1f}% of the "
                  f"launch")
            entry["no_boundary_ms"] = ms0
        if name == "A":
            for i in range(b):
                row_ms = cuda_ms(lambda i=i: launch(sel=slice(i, i + 1)),
                                 warmup=0)
                n = int(n_valid[i])
                print(f"[time K3]   sweep A row {i}: N={n}, kernel "
                      f"{row_ms:.3f} ms, {n / row_ms / 1e3:.3f} M "
                      f"accesses/s")
        out[name] = entry
    return out


def k4_times(dev, gen, serve_inputs, card):
    """K4 at the serve loop's shapes and at a 4096-token decode (see
    `k4_time_case`)."""
    import torch
    b, h, kh, d, page, nblk = 8, 32, 8, 120, 16, 256
    long_ctx = [torch.randn((b, h, d), generator=gen),
                torch.randn((b * nblk, page, kh, d), generator=gen),
                torch.randn((b * nblk, page, kh, d), generator=gen),
                torch.randperm(b * nblk, generator=gen).to(torch.int32)
                .reshape(b, nblk),
                torch.full((b,), nblk * page, dtype=torch.int32)]
    long_ctx = [x.to(dev) for x in long_ctx]
    out = {name: k4_time_case(name, args, dev, card)
           for name, args in (("serve", serve_inputs),
                              ("ctx4096", long_ctx))}
    out["mla_cell"] = k4_mla_cell(dev, gen, card)
    out["kimi_cell"] = k4_kimi_cell(dev, gen, card)
    out.update(k4_hybrid_cell(dev, gen, card))
    return out


#: K4's dense entry at the serving cells' decode shapes: (cell, cache slots
#: S, the valid lengths of the cell's decode steps, query heads, KV heads,
#: key width, value width, a sink logit per query head): danube's two
#: cells, and MiMo-V2-Flash's full layers (the whole context) and window
#: layers (a ring of 128, always full in its cell, with the sinks)
DENSE_DECODE = (
    ("prefill-long", 8200, tuple(range(8193, 8201)), 32, 8, 120, 120, False),
    ("serve-spill", 1088, tuple(range(1025, 1089, 9)), 32, 8, 120, 120,
     False),
    ("mimo full", 4160, tuple(range(4097, 4161, 9)), 64, 4, 192, 128, False),
    ("mimo window", 128, (128,), 64, 8, 192, 128, True))
#: (rtol, atol) of K4's dense entry against the einsums, bf16 output: both
#: round an f32 result to bf16, and the other summation order can flip one
#: rounding, at most one ulp, 2 ** -7 of the value; atol covers outputs
#: near 0
DENSE_RTOL, DENSE_ATOL = 8e-3, 1e-4


def decode_attention_times(dev, card):
    """K4's dense entry as a GQA decode step calls it
    (``attention.decode_attention``) at the shapes of `DENSE_DECODE`: one
    sequence, a bf16 cache of S slots (V rows of their own width, and the
    sinks where the cell's layer has them), one call per valid length of
    the cell's decode steps (a 0-d length, as the step passes it).  The kernel by CUDA events and by the
    profiler's device time, beside its byte bound, the einsums it replaced
    and SDPA on the same cache (the library yardstick, which the port
    never calls); the kernel held against the einsums within
    ``DENSE_RTOL`` and ``DENSE_ATOL``.  Beside that limit, what it would
    have to miss: at the last length, the einsums over the cache without
    each one of the kernel's partitions in turn, the smallest over the
    partitions of the largest change and of its ratio to the limit, which
    must exceed 1."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import attention as attn
    gen = torch.Generator(device=dev).manual_seed(30)
    out = {}
    for label, s, lengths, h, kh, d, dv, with_sinks in DENSE_DECODE:
        q = torch.randn((1, h, d), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((1, s, kh, w), generator=gen,
                            device=dev).bfloat16() for w in (d, dv))
        sinks = (4.85 + torch.randn((h,), generator=gen, device=dev)
                 if with_sinks else None)
        page, table = pa.dense_layout(1, s, q.device)
        kp = k.reshape(-1, page, kh, d)
        plan = pa.launch_plan(q, kp, v.reshape(-1, page, kh, dv), table,
                              sinks=sinks)
        kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
        pos = torch.arange(s, device=dev)
        rows = []
        for n in lengths:
            lens = torch.tensor(n, device=dev)
            mask = (pos < n)[None, None, None, :]

            def kernel():
                return attn.decode_attention(q, k, v, lens, sinks)

            def einsums():
                return attn.decode_attention_ref(q, k, v, lens, sinks)

            def sdpa():
                return F.scaled_dot_product_attention(
                    q[:, :, None], kt, vt, attn_mask=mask,
                    enable_gqa=True)[:, :, 0]
            got, want = kernel(), einsums()
            err = float((got.float() - want.float()).abs().max())
            if bool(((got.float() - want.float()).abs()
                     > DENSE_ATOL + DENSE_RTOL * want.float().abs()).any()):
                raise AssertionError(f"[time K4 dense] {label}, length {n}: "
                                     f"max|kernel - einsums| {err:.3g}")
            dev_k = device_times(kernel)
            n_bytes = pa.bound_bytes(q, kp, table, lens.reshape(1),
                                     v_dim=dv, sinks=with_sinks)
            rows.append(dict(
                length=n, ms=cuda_ms(kernel, warmup=3, reps=50),
                device_ms=sum(dev_k.values()),
                k4_device_ms=sum(t for key, t in dev_k.items()
                                 if "paged_" in key),
                einsum_ms=cuda_ms(einsums, warmup=1, reps=10),
                library_ms=cuda_ms(sdpa, warmup=3, reps=50),
                bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3,
                max_abs_err=err,
                library_err=float((sdpa().float() - got.float()).abs().max())))
        n, want = lengths[-1], want.float()
        lost = []
        for lo in range(0, n, plan["part_len"]):
            hi = min(n, lo + plan["part_len"])
            kk, vv = (torch.cat([x[:, :lo], x[:, hi:]], 1) for x in (k, v))
            moved = (attn.decode_attention_ref(
                q, kk, vv, torch.tensor(n - (hi - lo), device=dev),
                sinks).float() - want).abs()
            lost.append((float(moved.max()), float(
                (moved / (DENSE_ATOL + DENSE_RTOL * want.abs())).max())))
        lost_err, lost_ratio = min(e for e, _ in lost), min(r for _, r in lost)
        if lost_ratio <= 1:
            raise AssertionError(f"[time K4 dense] {label}: a lost partition "
                                 f"stays within the limit ({lost_ratio:.3g})")
        mean = {key: sum(r[key] for r in rows) / len(rows)
                for key in ("ms", "device_ms", "k4_device_ms", "einsum_ms",
                            "library_ms", "bound_ms")}
        out[label] = dict(mean, rows=rows, parts=plan["parts"],
                          part_len=plan["part_len"], blocks=plan["blocks"],
                          shape=dict(B=1, H=h, K=kh, D=d, Dv=dv, S=s,
                                     page=page, sinks=with_sinks),
                          max_abs_err=max(r["max_abs_err"] for r in rows),
                          rtol=DENSE_RTOL, atol=DENSE_ATOL,
                          lost_partition_err=lost_err,
                          lost_partition_over_limit=lost_ratio)
        print(f"[time K4 dense] {label}: B=1 H={h} K={kh} D={d} Dv={dv}"
              f"{', sinks' if with_sinks else ''}, bf16 cache "
              f"of {s} slots (page {page}, {plan['parts']} partitions of "
              f"{plan['part_len']}, {plan['blocks']} blocks), lengths "
              f"{lengths[0]}..{lengths[-1]}, means: kernel {mean['ms']:.4f} "
              f"ms by events, device {mean['device_ms']:.4f} ms (K4's "
              f"passes {mean['k4_device_ms']:.4f}), bound "
              f"{mean['bound_ms']:.4f} ms (bytes; "
              f"{100 * mean['bound_ms'] / max(mean['k4_device_ms'], 1e-9):.1f}"
              f"% of it on K4's device time), einsums "
              f"{mean['einsum_ms']:.4f} ms, SDPA on the same cache "
              f"{mean['library_ms']:.4f} ms; max|kernel - einsums| "
              f"{out[label]['max_abs_err']:.3g} (limit {DENSE_ATOL:g} + "
              f"{DENSE_RTOL:g} |einsums|); a lost partition moves it at "
              f"least {lost_err:.3g}, {lost_ratio:.3g}x the limit ({card})")
    return out


def k4_mla_cell(dev, gen, card):
    """K4's absorbed-MLA instantiation at the DeepSeek-V3 serving cell's
    shape (8 sequences of 1,024-1,087 positions in 68 pages of 16, 128
    query heads over one latent head, DeepSeek-V3's YaRN softmax scale);
    see `k4_latent_case`."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import YarnConfig
    cfg = dataclasses.replace(get_config("deepseek-v3-671b"),
                              rope_scaling=YarnConfig())
    return k4_latent_case(dev, gen, card, "MLA cell", cfg,
                          [1024 + 9 * i for i in range(8)], 68)


def k4_kimi_cell(dev, gen, card):
    """K4's absorbed-MLA instantiation at the Kimi-Linear serving cell's
    latent pool (8 sequences of 16,385-16,416 positions in the cell's
    1,028 pages of 16 a sequence, 32 query heads over one latent head, the
    plain softmax scale); see `k4_latent_case`."""
    from repro_torch.configs import get_config
    return k4_latent_case(dev, gen, card, "Kimi-Linear cell",
                          get_config("kimi-linear-48b-a3b"),
                          [16385 + 31 * i // 7 for i in range(8)], 1028)


def k4_latent_case(dev, gen, card, name, cfg, ctxs, nblk):
    """K4 over `cfg`'s latent pool, one sequence a context of `ctxs` in
    `nblk` pages of 16 (rows of 576, values their first 512 columns, one
    f32 pool read as keys and values), where the split plan cuts each
    context into several partitions and the combine pass runs: against
    its plain version (3e-5, rtol = atol), then timed beside its bound and
    SDPA (see `k4_time_case`)."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import attention as attn
    m = cfg.mla
    d, dv = m.kv_lora_rank + m.qk_rope_head_dim, m.kv_lora_rank
    args = contexts_case(gen, ctxs, cfg.n_heads, 1, d, 16, nblk,
                         torch.float32, dev)
    args[2] = args[1]                       # the values are the rows'
    kw = dict(scale=attn.mla_softmax_scale(cfg), v_dim=dv)
    plan = pa.launch_plan(*args[:4], dv)
    plain = pa.paged_attention_ref(*args, **kw)
    diff = (pa.paged_attention(*args, **kw) - plain).abs()
    err = float(diff.max())
    if plan["parts"] < 2 or bool((diff > 3e-5 * (1 + plain.abs())).any()):
        raise AssertionError(f"[time K4] K4 at the {name}'s shape: "
                             f"{plan['parts']} partition(s), max|kernel - "
                             f"plain| {err:.3g} (tolerance 3e-5)")
    print(f"[time K4] {name}: {plan['parts']} partitions, max|kernel - "
          f"plain| {err:.3g} (tolerance 3e-5, rtol = atol)")
    del plain, diff
    return dict(k4_time_case(name, args, dev, card, **kw), max_abs_err=err)


def k4_hybrid_cell(dev, gen, card):
    """K4 at the MiMo-V2-Flash serving cell's two pool kinds (8 sequences,
    64 query heads, keys 192 wide, values 128 in their own f32 pool): the
    full kind over 4 KV heads and 4,097-4,160 positions in 262 pages of
    16, the window kind over 8 KV heads and a ring of 8 pages with a sink
    logit per query head; each against its plain version (3e-5, rtol =
    atol), then timed beside its bound and SDPA (see `k4_time_case`, whose
    SDPA leaves the sinks out)."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    out = {}
    for kind, kh, nblk, ctxs in (
            ("full", 4, 262, [4097 + 9 * i for i in range(8)]),
            ("window", 8, 8, [128] * 8)):
        args = contexts_case(gen, ctxs, 64, kh, 192, 16, nblk,
                             torch.float32, dev)
        args[2] = args[2][..., :128].contiguous()
        kw = {"sinks": (4.85 + torch.randn((64,), generator=gen)).to(dev)
              } if kind == "window" else {}
        plan = pa.launch_plan(*args[:4], **kw)
        plain = pa.paged_attention_ref(*args, **kw)
        diff = (pa.paged_attention(*args, **kw) - plain).abs()
        err = float(diff.max())
        if bool((diff > 3e-5 * (1 + plain.abs())).any()):
            raise AssertionError(f"[time K4] K4 at the MiMo cell's {kind} "
                                 f"kind: max|kernel - plain| {err:.3g} "
                                 f"(tolerance 3e-5)")
        print(f"[time K4] MiMo cell, {kind} kind: {plan['parts']} "
              f"partition(s), max|kernel - plain| {err:.3g} (tolerance "
              f"3e-5, rtol = atol)")
        out[f"hybrid_{kind}"] = dict(
            k4_time_case(f"MiMo {kind}", args, dev, card, **kw),
            max_abs_err=err)
    return out


def k4_time_case(name, args, dev, card, **kw):
    """K4 on `args` (`kw`: its ``scale`` and ``v_dim``): kernel, the
    wrapper as the serve loop calls it (its block-table check syncs with
    the host), bound, plain version and SDPA on the already gathered
    K/V."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pa
    q, kp, vp, bt, cl = args
    bb, hh, dd = q.shape
    dv = kw.get("v_dim") or vp.shape[-1]
    pg, kvh, nb = kp.shape[1], kp.shape[2], bt.shape[1]
    ms = cuda_ms(lambda: pa._launch(q, kp, vp, bt, cl, **kw), warmup=3,
                 reps=50)
    wrapper_ms = cuda_ms(lambda: pa.paged_attention(q, kp, vp, bt, cl, **kw),
                         warmup=3, reps=50)
    plain_ms = cuda_ms(lambda: pa.paged_attention_ref(q, kp, vp, bt, cl,
                                                      **kw), reps=5)
    # the yardstick: one PyTorch call on K/V gathered beforehand
    live = pa.live_mask(bt, cl, pg)
    idx = torch.where(live, bt.long(), 0)
    kd = kp[idx].reshape(bb, nb * pg, kvh, dd).transpose(1, 2).contiguous()
    vd = vp[idx][..., :dv].reshape(bb, nb * pg, kvh, dv).transpose(
        1, 2).contiguous()
    pos = torch.arange(nb * pg, device=dev)
    mask = None if bool((cl == nb * pg).all()) else \
        (pos[None, :] < cl[:, None])[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(
            q[:, :, None, :], kd, vd, attn_mask=mask, enable_gqa=True,
            scale=kw.get("scale"))
    lib_ms = cuda_ms(sdpa, warmup=3, reps=50)
    plan = pa.launch_plan(q, kp, vp, bt, kw.get("v_dim"), kw.get("sinks"))
    dev4 = device_times(lambda: pa._launch(q, kp, vp, bt, cl, **kw))
    part_dev = sum(v for k, v in dev4.items() if "paged_attention" in k)
    combine_dev = sum(v for k, v in dev4.items() if "paged_combine" in k)
    device_ms = sum(dev4.values())
    # an empty context's row is 0 in K4 and NaN in SDPA's fully masked row
    full = cl > 0
    lib_err = float((sdpa()[:, :, 0] - pa._launch(q, kp, vp, bt, cl, **kw))[
        full].abs().max()) if bool(full.any()) else 0.0
    n_bytes = pa.bound_bytes(q, kp, bt, cl, v_dim=dv,
                             shared_kv="v_dim" in kw and vp is kp,
                             sinks="sinks" in kw)
    flops = 2 * int(cl.clamp(0, nb * pg).sum()) * hh * (dd + dv)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    out = dict(ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               shape=dict(B=bb, H=hh, K=kvh, D=dd, page=pg, nblk=nb,
                          ctx=cl.tolist(), pool=str(kp.dtype)[6:]),
               parts=plan["parts"], part_len=plan["part_len"],
               blocks=plan["blocks"], device_ms=device_ms,
               partition_device_ms=part_dev, combine_device_ms=combine_dev)
    print(f"[time K4] {name}: B={bb} H={hh} K={kvh} D={dd} page {pg} "
          f"nblk {nb}, contexts {sorted(set(cl.tolist()))}, "
          f"{str(kp.dtype)[6:]} pool: kernel {ms:.4f} ms, bound "
          f"{max(bytes_ms, ops_ms):.4f} ms ({n_bytes} B at 3.35 TB/s "
          f"= {bytes_ms:.4f} ms; {flops} f32 flops at 67 TFLOP/s = "
          f"{ops_ms:.4f} ms), {n_bytes / ms / 1e6:.1f} GB/s; through "
          f"the wrapper {wrapper_ms:.4f} ms; plain "
          f"version {plain_ms:.4f} ms; SDPA on the gathered K/V "
          f"{lib_ms:.4f} ms (max|SDPA - kernel| {lib_err:.3g}) ({card})")
    split = "the profiler saw no device time (not measured)"
    if device_ms > 0:
        split = (f"device time per call by the profiler {device_ms:.4f} "
                 f"ms: the partition pass {part_dev:.4f} ms, "
                 + (f"the combine pass {combine_dev:.4f} ms "
                    f"({100 * combine_dev / device_ms:.1f}%)"
                    if plan["parts"] > 1 else "no combine pass")
                 + f", {100 * max(bytes_ms, ops_ms) / device_ms:.1f}% "
                 f"of the bound")
    print(f"[time K4]   {name}: S = {plan['parts']} partition(s) of "
          f"{plan['part_len']} positions, {plan['blocks']} blocks "
          f"({plan['resident']} resident per SM); {split}; by events "
          f"{100 * max(bytes_ms, ops_ms) / ms:.1f}% of the bound")
    return out


def profile(fn, label, kernel=None, note="a kernel counts as busy time "
            "however few SMs it fills"):
    """Wall time of `fn()` split into device kernels and the rest; with
    `kernel`, that kernel's share of the device time too."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device events only: a CPU op (aten::mm, ...) also reports the device
    # time of the kernels it launched, which would count them twice
    device_us = sorted(((e.self_device_time_total, e.key, e.count)
                        for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(us for us, _, _ in device_us) / 1e3
    if busy_ms <= 0:
        print(f"[profile] {label}: wall {wall_ms:.1f} ms; the profiler saw "
              f"no device time (device busy share not measured)")
        return
    print(f"[profile] {label}: wall {wall_ms:.1f} ms, device kernels "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}% of wall; "
          f"{note})")
    for us, key, count in device_us[:6]:
        print(f"[profile]   {us / 1e3:10.3f} ms  x{count:<5d} {key[:70]}")
    if kernel:
        k_ms = sum(us for us, key, _ in device_us if kernel in key) / 1e3
        print(f"[profile]   {kernel}: {k_ms:.3f} ms, "
              f"{100 * k_ms / busy_ms:.2f}% of device time, "
              f"{100 * k_ms / wall_ms:.3f}% of wall")


# ---------------------------------------------------------------------------
# Slice 9: the training path
# ---------------------------------------------------------------------------
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 (data sheet)
TRAIN_STEPS = 6


def train_flops(cfg, n_params: int, batch: int, seq: int) -> float:
    """Model FLOPs of one step under full recomputation: 6·N·T for the
    weights plus causal attention (3 x the forward's 2·S²·H·D per layer,
    within the window), times 4/3 for the recomputed forward."""
    band = min(seq, cfg.window) if cfg.window else seq
    causal_pairs = seq * band - band * (band - 1) / 2     # (q, k) pairs
    attn = 3 * 2 * 2 * causal_pairs * cfg.n_heads * cfg.head_dim
    return 4 / 3 * (6 * n_params * batch * seq
                    + attn * cfg.n_layers * batch)


def step_times(log):
    return [e["dt"] * 1e3 for e in log if e["event"] == "step"]


def danube_training(dev, card, ckpt_dir):
    """(a) launch.train.run at the full width and depth of h2o-danube-3-4b,
    batch 1 x 4096 tokens, then one step taken apart: forward, gradients,
    the AdamW update, and a profiled step."""
    import dataclasses
    import math
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, batch_at_step
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    # full recomputation: "dots" would keep every layer's f32 attention
    # logits, 24 x 4 chunks x 537 MB, beside 47.5 GB of state
    cfg = dataclasses.replace(get_config("h2o-danube-3-4b"),
                              remat_policy="none")
    batch, seq = 1, 4096
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    r = train.run(cfg, steps=TRAIN_STEPS, batch=batch, seq=seq,
                  accum_steps=1, ckpt_dir=ckpt_dir,
                  ckpt_every=TRAIN_STEPS + 1, log_every=0, device=dev)
    peak = torch.cuda.max_memory_allocated()
    run_peak = dict(arch=cfg.arch, overrides=dict(remat_policy="none"),
                    batch=batch, seq=seq, peak=peak, held=held)
    params, opt = r["state"]
    n = tf.n_param_elements(params)
    losses = [e["loss"] for e in r["log"] if e["event"] == "step"]
    ms = step_times(r["log"])
    step_ms = statistics.median(ms[1:])
    flops = train_flops(cfg, n, batch, seq)
    ln_v = math.log(cfg.vocab_size)
    # random logits of std ~0.9 add about sigma^2 / 2 to ln(V)
    if not (all(math.isfinite(x) for x in losses)
            and abs(losses[0] - ln_v) < 1.0 and len(losses) == TRAIN_STEPS):
        raise AssertionError(f"[slice 9] danube losses {losses} (want "
                             f"finite, the first within 1 of {ln_v:.3f})")
    print(f"[slice 9] (a) {cfg.arch}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {n:,} parameters in {cfg.dtype}, batch {batch} "
          f"x {seq} tokens, remat 'none': losses {losses}")
    share = flops / (step_ms / 1e3) / BF16_FLOPS_PER_S
    print(f"[slice 9] (a) step times {[round(x, 3) for x in ms]} ms; median "
          f"of steps 2-{TRAIN_STEPS} {step_ms:.3f} ms, "
          f"{batch * seq / step_ms * 1e3:.1f} tokens/s, {flops / 1e12:.2f} "
          f"TFLOP a step = {100 * share:.2f}% of "
          f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s bf16; peak device memory "
          f"{peak / 1e9:.2f} GB ({peak / 2**30:.2f} GiB) ({card})")

    # one more step taken apart, by CUDA events
    dc = DataConfig(batch_per_shard=batch, seq_len=seq)
    b = batch_at_step(cfg, dc, TRAIN_STEPS, device=dev)
    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=20,
                                total_steps=TRAIN_STEPS)

    def forward():
        with torch.no_grad():
            tf.forward_train(params, cfg, b["tokens"])
    fwd_ms = cuda_ms(forward, warmup=0)
    grads = {}

    def grad():
        grads["g"] = M.value_and_grad(params, cfg, b)[1]
    grad_ms = cuda_ms(grad, warmup=0)

    def update():
        adamw.update(opt_cfg, grads["g"], opt, params)
    upd_ms = cuda_ms(update, warmup=0)
    del grads["g"]
    bwd_ms = grad_ms - 2 * fwd_ms
    print(f"[slice 9] (a) one step by CUDA events: forward {fwd_ms:.3f} ms "
          f"(no autograd); forward + recomputed forward + backward "
          f"{grad_ms:.3f} ms, so backward ~{bwd_ms:.3f} ms; AdamW update "
          f"{upd_ms:.3f} ms = {100 * upd_ms / step_ms:.2f}% of the median "
          f"step ({card})")
    step = M.make_train_step(cfg, opt_cfg)
    profile(lambda: step(params, opt, b),
            f"one danube training step (batch {batch} x {seq})",
            note="device events only")
    return run_peak


def smoke_training_card_vs_cpu(dev, ckpt_root):
    """(b) the loop at smoke size in f32 on the card and on the CPU from the
    same weights (accum 1 and 2), then on the card with a failure at step
    3 and a checkpoint every 2 steps."""
    import dataclasses
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.launch import train
    from repro_torch import tree as tree_mod
    from repro_torch.models import transformer as tf
    small = dataclasses.replace(get_smoke("h2o-danube-3-4b"),
                                dtype="float32")
    p0 = tf.init_params(small, torch.Generator().manual_seed(1), "cpu")
    kw = dict(steps=TRAIN_STEPS, batch=4, seq=32, log_every=0)

    def losses(r):
        return [e["loss"] for e in r["log"] if e["event"] == "step"]

    def worst(a, b):
        """max |a - b| and the largest excess over atol 1e-5 + rtol 1e-4."""
        err = excess = 0.0
        for x, y in zip(tree_mod.leaves(a), tree_mod.leaves(b)):
            d = (x.cpu() - y.cpu()).abs()
            err = max(err, float(d.max()))
            excess = max(excess, float((d - 1e-5 - 1e-4 * y.cpu().abs())
                                       .max()))
        return err, excess
    runs = {}
    for accum in (1, 2):
        on_card = train.run(small, device=dev, params=tree_to(p0, dev),
                            accum_steps=accum, ckpt_every=1000,
                            ckpt_dir=f"{ckpt_root}/card{accum}", **kw)
        on_cpu = train.run(small, device="cpu", params=tree_to(p0, "cpu"),
                           accum_steps=accum, ckpt_every=1000,
                           ckpt_dir=f"{ckpt_root}/cpu{accum}", **kw)
        lc, lh = losses(on_card), losses(on_cpu)
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
        err, excess = worst(on_card["state"], on_cpu["state"])
        print(f"[slice 9] (b) smoke f32, accum {accum}: losses card {lc}; "
              f"max rel loss diff {loss_err:.3g}; final params and moments "
              f"max |card - CPU| {err:.3g}")
        if len(lc) != TRAIN_STEPS or loss_err > 1e-4 or excess > 0:
            raise AssertionError(f"[slice 9] (b) accum {accum}: card and "
                                 f"CPU disagree (loss {loss_err:.3g}, "
                                 f"state {err:.3g})")
        runs[accum] = on_card
    failed = train.run(small, device=dev, params=tree_to(p0, dev),
                       fail_at=3, ckpt_every=2,
                       ckpt_dir=f"{ckpt_root}/fail", **kw)
    events = [e["event"] for e in failed["log"]]
    want = losses(runs[1])
    replay = {e["step"]: e["loss"] for e in failed["log"]
              if e["event"] == "step"}
    resumed = [e for e in failed["log"] if e["event"] == "restart"]
    bitwise = all(replay[i] == want[i] for i in range(TRAIN_STEPS))
    rel = max(abs(replay[i] - want[i]) / abs(want[i])
              for i in range(TRAIN_STEPS))
    print(f"[slice 9] (b) failure at step 3, checkpoints every 2: events "
          f"{events}; restarts {failed['restarts']}, {resumed}; losses equal "
          f"to the uninterrupted run's bitwise {bitwise} (max rel "
          f"{rel:.3g})")
    if not (failed["restarts"] == 1 and "evict" in events
            and resumed and resumed[0]["resume_step"] == 2
            and events.count("step") == TRAIN_STEPS + 1 and rel <= 1e-6):
        raise AssertionError("[slice 9] (b) the restart path failed")


def moe_training(dev, card, ckpt_dir):
    """(c) qwen3-moe-235b-a22b at full width, depth cut to 1 layer: two
    steps at batch 1 x 1024; then at smoke size in f32, the MoE forward
    and one train step on the card against the CPU."""
    import dataclasses
    import math
    import torch
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.data import DataConfig, batch_at_step
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    from repro_torch import tree as tree_mod
    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b"), n_layers=1)
    batch, seq, steps = 1, 1024, 2
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    r = train.run(cfg, steps=steps, batch=batch, seq=seq, ckpt_dir=ckpt_dir,
                  ckpt_every=steps + 1, log_every=0, device=dev)
    peak = torch.cuda.max_memory_allocated()
    run_peak = dict(arch=cfg.arch, overrides=dict(n_layers=1), batch=batch,
                    seq=seq, peak=peak, held=held)
    params, _ = r["state"]
    n = tf.n_param_elements(params)
    losses = [e["loss"] for e in r["log"] if e["event"] == "step"]
    ms = step_times(r["log"])
    with torch.no_grad():
        _, parts = M.loss_fn(params, cfg, batch_at_step(
            cfg, DataConfig(batch_per_shard=batch, seq_len=seq), 0, dev))
    aux = float(parts["aux"])
    m = cfg.moe
    want_c = -(-max(int(m.capacity_factor * seq * m.top_k / m.n_experts),
                    1) // 8) * 8
    cap = moe.capacity(cfg, batch * seq)
    print(f"[slice 9] (c) {cfg.arch} at full width, 1 of 94 layers: "
          f"{n:,} parameters, {m.n_experts} experts top-{m.top_k}, capacity "
          f"{cap} slots (formula {want_c}); losses {losses}, aux {aux:.6g}; "
          f"step times {[round(x, 3) for x in ms]} ms; peak device memory "
          f"{peak / 1e9:.2f} GB ({peak / 2**30:.2f} GiB) ({card})")
    if not (all(math.isfinite(x) for x in losses) and aux > 0
            and cap == want_c == 80 and len(losses) == steps):
        raise AssertionError("[slice 9] (c) the MoE training path failed")
    del r, params, parts
    torch.cuda.empty_cache()

    # smoke size, f32: the MoE forward and one train step, card vs CPU
    small = dataclasses.replace(get_smoke("qwen3-moe-235b-a22b"),
                                dtype="float32")
    p0 = tf.init_params(small, torch.Generator().manual_seed(2), "cpu")
    x = torch.randn((2, 24, small.d_model),
                    generator=torch.Generator().manual_seed(3))
    mp = p0["segments"][0][0]["b0"]["moe"]
    y_card, aux_card = moe.moe_ffn(tree_to(mp, dev), x.to(dev), small)
    y_cpu, aux_cpu = moe.moe_ffn(mp, x, small)
    y_err = float((y_card.cpu() - y_cpu).abs().max())
    aux_err = abs(float(aux_card) - float(aux_cpu))
    b = batch_at_step(small, DataConfig(batch_per_shard=2, seq_len=24), 0,
                      "cpu")
    opt_cfg = adamw.AdamWConfig(warmup_steps=2, total_steps=10)
    outs = {}
    for name, where in (("card", dev), ("cpu", "cpu")):
        params = tree_to(p0, where)
        outs[name] = M.make_train_step(small, opt_cfg)(
            params, adamw.init(params), {k: v.to(where) for k, v in b.items()})
    lc, lh = (float(outs[k][2]["loss"]) for k in ("card", "cpu"))
    p_err = max(float((a.cpu() - c).abs().max()) for a, c in zip(
        tree_mod.leaves(outs["card"][0]), tree_mod.leaves(outs["cpu"][0])))
    print(f"[slice 9] (c) smoke f32, card against CPU: moe_ffn max |dy| "
          f"{y_err:.3g}, |d aux| {aux_err:.3g}; one train step: loss "
          f"{lc:.6f} vs {lh:.6f}, max |d param| {p_err:.3g}")
    if y_err > 1e-5 or aux_err > 1e-6 or abs(lc - lh) > 1e-4 * abs(lh) \
            or p_err > 1e-4:
        raise AssertionError("[slice 9] (c) MoE on the card disagrees with "
                             "the CPU")
    return run_peak


def slice9_path(dev, card):
    """Slice 9's phase: (a), (b) and (c), with the kernels' launch counts
    set to 0 before and read after (the training path runs no kernel);
    returns the counts and the peak memory of the (a) and (c) runs."""
    import tempfile
    from repro_torch.kernels import ops
    ops.reset_launches()
    with tempfile.TemporaryDirectory() as d:
        peaks = [danube_training(dev, card, f"{d}/a")]
        smoke_training_card_vs_cpu(dev, f"{d}/b")
        peaks.append(moe_training(dev, card, f"{d}/c"))
    launches = dict(ops.LAUNCHES)
    print(f"[slice 9] launch counts over the training path {launches}")
    return launches, peaks


# ---------------------------------------------------------------------------
# Slice 10: the rwkv, rec and MLA kinds, served and trained at full width
# ---------------------------------------------------------------------------
#: architecture -> depth override of the serve (deepseek's 61 layers do not
#: fit one card: its 3 dense MLA layers and 1 MoE layer of 256 experts)
SLICE10_SERVE = {"rwkv6-1.6b": {}, "recurrentgemma-9b": {},
                 "deepseek-v3-671b": {"n_layers": 4}}
#: architecture -> (depth override, tokens) of the training cell: rwkv at
#: full depth (4096 tokens take the chunked WKV), recurrentgemma one
#: (rec, rec, attn) period plus the (rec, rec) tail, deepseek one dense
#: MLA layer
SLICE10_TRAIN = {"rwkv6-1.6b": ({}, 4096),
                 "recurrentgemma-9b": ({"n_layers": 5}, 4096),
                 "deepseek-v3-671b": ({"n_layers": 1}, 4096)}
SLICE10_STEPS = 3


def serve_new_kind(dev, card, arch, over):
    """serve.run at `arch`'s published width (depth cut by `over`), with
    serve.py's defaults: K4 once per decode step over a pool that only the
    decode steps' zero rows fill (for MLA, the latent pool, which the
    prefill fills with layer 0's latent rows); then K4 on the loop's last
    inputs and on random pools of the same shape, against its plain
    version, and timed beside SDPA."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch import serve
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(get_config(arch), **over)
    latent = cfg.attn_kind == "mla"
    # K4's shape: (query heads, kv heads, key width), values, its keywords
    if latent:
        shape = (cfg.n_heads, 1,
                 cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim)
        dv = cfg.mla.kv_lora_rank
        kw = dict(scale=attn.mla_softmax_scale(cfg), v_dim=dv)
    else:
        shape, dv, kw = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim), \
            cfg.head_dim, {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ops.reset_launches()
    r = serve.run(cfg, device=dev, params=params)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_req, n_pre, n_dec = 8, 48, 16
    ms_step = 1e3 * r["decode_s"] / (n_req * n_dec)
    print(f"[slice 10] serve {arch}: {cfg.n_layers} layers "
          f"{[seg.pattern for seg in tf.segments(cfg)]}, d_model "
          f"{cfg.d_model}, {r['n_params']:,} parameters in {cfg.dtype} "
          f"({r['n_params'] * 2 / 1e9:.2f} GB), random from seed 0 in "
          f"{init_s:.2f} s; peak device memory {peak / 1e9:.2f} GB")
    print(f"[slice 10] serve {arch}: {n_req} requests, prefill {n_pre}, "
          f"decode {n_dec}: prefill {r['prefill_s']:.3f} s "
          f"({n_req * n_pre / r['prefill_s']:.1f} prompt tokens/s), decode "
          f"{r['decode_s']:.3f} s ({n_req * n_dec / r['decode_s']:.2f} "
          f"tokens/s, {ms_step:.2f} ms per decode_step), wall "
          f"{r['prefill_s'] + r['decode_s']:.3f} s; K4 launches "
          f"{launches['paged_attention']}; kv {r['kv_stats']} ({card})")
    print(f"[slice 10] serve {arch}: continuation of request 0 "
          f"{r['tokens'][0]}")
    q, kp, vp, bt, cl = r["last_attn_inputs"]
    checks = {
        "one K4 launch per decode step, no plain version":
            launches["paged_attention"] == n_dec
            and launches["paged_attention_ref"] == 0,
        "finite logits": r["logits_finite"],
        "finite K4 outputs of shape (B, H, Dv)": all(
            o.shape == (n_req, cfg.n_heads, dv)
            and bool(torch.isfinite(o).all()) for o in r["attn_out"]),
        "every request decoded": all(len(t) == n_dec
                                     for t in r["tokens"].values()),
    }
    if latent:
        checks["the prompts' latent rows in the pool"] = (
            bool(kp.any()) and cl.tolist() == [n_pre + n_dec - 1] * n_req)
    else:
        checks["no prefill pages (the first block keeps no K/V)"] = (
            not bool(kp.any()) and cl.tolist() == [n_dec - 1] * n_req)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"[slice 10] serve {arch} failed {bad}")
    del params
    # K4 against its plain version at this shape: the loop's own inputs and
    # random pools (an empty and a partial context among them)
    gen = torch.Generator().manual_seed(10)
    rand = paged_case(gen, n_req, *shape, 16, 6, torch.float32, dev)
    if latent:
        rand[2] = rand[1]                   # the values are the rows'
    err = 0.0
    for label, args in (("serve inputs", r["last_attn_inputs"]),
                        ("random pools", rand)):
        kern = pa.paged_attention(*args, **kw)
        plain = pa.paged_attention_ref(*args, **kw)
        diff = (kern - plain).abs()
        err = max(err, float(diff.max()))
        if bool((diff > 3e-5 * (1 + plain.abs())).any()):
            raise AssertionError(f"[slice 10] K4 disagrees with its plain "
                                 f"version at {arch}'s shape ({label})")
    print(f"[slice 10] K4 at {arch}'s shape (H={shape[0]}, "
          f"K={shape[1]}, D={shape[2]}, Dv={dv}): max|kernel - plain| "
          f"{err:.3g} (tolerance 3e-5, rtol = atol)")
    times = k4_time_case(f"serve {arch}", r["last_attn_inputs"], dev, card,
                         **kw)
    return dict(launches=launches, k4=dict(times, max_abs_err=err,
                                           launches=launches[
                                               "paged_attention"]))


def train_new_kind(dev, card, arch, over, seq, ckpt_dir):
    """launch.train.run at `arch`'s published width (depth cut by `over`),
    batch 1 x `seq`, the config's remat policy; then one step profiled."""
    import dataclasses
    import math
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, batch_at_step
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(get_config(arch), **over)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    r = train.run(cfg, steps=SLICE10_STEPS, batch=1, seq=seq,
                  ckpt_dir=ckpt_dir, ckpt_every=SLICE10_STEPS + 1,
                  log_every=0, device=dev)
    peak = torch.cuda.max_memory_allocated()
    run_peak = dict(arch=arch, overrides=dict(over), batch=1, seq=seq,
                    peak=peak, held=held)
    n = tf.n_param_elements(r["state"][0])
    losses = [e["loss"] for e in r["log"] if e["event"] == "step"]
    ms = step_times(r["log"])
    step_ms = statistics.median(ms[1:])
    ln_v = math.log(cfg.vocab_size)
    print(f"[slice 10] train {arch}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {n:,} parameters, remat {cfg.remat_policy!r}, "
          f"batch 1 x {seq}: losses {losses} (ln V = {ln_v:.3f}); step "
          f"times {[round(x, 3) for x in ms]} ms, median of steps "
          f"2-{SLICE10_STEPS} {step_ms:.3f} ms, {seq / step_ms * 1e3:.1f} "
          f"tokens/s; peak device memory {peak / 1e9:.2f} GB ({card})")
    if not (len(losses) == SLICE10_STEPS
            and all(math.isfinite(x) for x in losses)
            and abs(losses[0] - ln_v) < 2.0):
        raise AssertionError(f"[slice 10] train {arch}: losses {losses}")
    # one more step, profiled: the device's busy share
    params, opt = r["state"]
    del r
    b = batch_at_step(cfg, DataConfig(batch_per_shard=1, seq_len=seq),
                      SLICE10_STEPS, device=dev)
    step = M.make_train_step(cfg, adamw.AdamWConfig(
        lr=3e-4, warmup_steps=20, total_steps=SLICE10_STEPS))
    profile(lambda: step(params, opt, b),
            f"one {arch} training step (batch 1 x {seq})",
            note="device events only")
    del params, opt, b
    torch.cuda.empty_cache()
    return run_peak


def new_kinds_card_vs_cpu(dev, arch):
    """At smoke size in f32, the same weights on the card and on the CPU:
    prefill and three decode steps' logits and caches, and the loss and its
    gradients (rwkv at 128 tokens: the chunked WKV); within rtol 1e-4 and
    an atol of 1e-4 x max(1, max |CPU value|) per tensor."""
    import dataclasses
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch import tree as tree_mod
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    p_cpu = tf.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    p_card = tree_to(p_cpu, dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 20),
                         generator=torch.Generator().manual_seed(4),
                         dtype=torch.int32)
    seq = 128 if arch == "rwkv6-1.6b" else 24
    b = {"tokens": torch.randint(0, cfg.vocab_size, (2, seq),
                                 generator=torch.Generator().manual_seed(5),
                                 dtype=torch.int32)}
    outs = {}
    for where, p in (("card", p_card), ("cpu", p_cpu)):
        d = dev if where == "card" else torch.device("cpu")
        logits, caches = tf.forward_prefill(p, cfg, toks.to(d))
        caches = tf.pad_cache(caches, cfg, 24)
        got = [logits]
        for ctx in range(20, 23):
            logits, caches = tf.decode_step(p, cfg, toks[:, ctx - 20].to(d),
                                            caches, ctx)
            got.append(logits)
        loss, grads = M.value_and_grad(
            p, cfg, {k: v.to(d) for k, v in b.items()})
        outs[where] = (got, caches, loss, grads)
    worst = 0.0
    for i in (0, 1, 3):
        for x, y in zip(tree_mod.leaves(outs["card"][i]),
                        tree_mod.leaves(outs["cpu"][i])):
            d = (x.cpu() - y).abs()
            tol = 1e-4 * max(1.0, float(y.abs().max())) + 1e-4 * y.abs()
            worst = max(worst, float((d / tol).max()))
    loss_err = abs(float(outs["card"][2]) - float(outs["cpu"][2])) \
        / abs(float(outs["cpu"][2]))
    print(f"[slice 10] {arch} smoke f32, card against CPU: logits, caches "
          f"and gradients at {worst:.3g} of their tolerance; loss rel diff "
          f"{loss_err:.3g}")
    if worst > 1 or loss_err > 1e-5:
        raise AssertionError(f"[slice 10] {arch}: the card disagrees with "
                             f"the CPU")


def slice10_path(dev, card):
    """Slice 10's phase: the three serves (K4's launches counted per serve),
    the card-against-CPU checks, then the three trainings (no kernel: the
    counts, reset before and read after, stay 0).  Returns the launch
    counts by path, K4's measurements at each serve and the trainings'
    peak memory."""
    import tempfile
    from repro_torch.kernels import ops
    out = {"serve": {}, "launches": {}, "peaks": []}

    def took(what, t0):
        print(f"[slice 10] {what} took {time.perf_counter() - t0:.1f} s")
    for arch, over in SLICE10_SERVE.items():
        t0 = time.perf_counter()
        out["serve"][arch] = serve_new_kind(dev, card, arch, over)
        out["launches"][f"serve {arch}"] = out["serve"][arch]["launches"]
        took(f"serve {arch}, K4 checks and times", t0)
    t0 = time.perf_counter()
    for arch in SLICE10_SERVE:
        new_kinds_card_vs_cpu(dev, arch)
    took("card against CPU", t0)
    ops.reset_launches()
    with tempfile.TemporaryDirectory() as d:
        for arch, (over, seq) in SLICE10_TRAIN.items():
            t0 = time.perf_counter()
            out["peaks"].append(train_new_kind(dev, card, arch, over, seq,
                                               f"{d}/{arch}"))
            took(f"train {arch} with its profiled step", t0)
    out["launches"]["train slice 10"] = dict(ops.LAUNCHES)
    print(f"[slice 10] launch counts over the training paths "
          f"{out['launches']['train slice 10']}")
    if any(out["launches"]["train slice 10"].values()):
        raise AssertionError("[slice 10] a kernel launched on the training "
                             "paths")
    return out


# ---------------------------------------------------------------------------
# Slice 11: the flit codec on the card; the one-card dry run
# ---------------------------------------------------------------------------
CODEC_REQUESTS = 1 << 20           # a million-request batch, as the codec's
PEAK_TOLERANCE = 0.15              # |estimate / measured - 1| of a run's peak


def codec_on_the_card(dev):
    """The CXL.mem codec's M2S and S2M headers and every decoded field on
    the card, bitwise against the CPU, on a seeded batch with negative
    addresses, over-wide tags, per-request logical devices and NXM reads;
    returns the number of header words compared."""
    import torch
    from repro_torch.core import packet
    gen = torch.Generator().manual_seed(11)
    n = CODEC_REQUESTS
    addr = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                         dtype=torch.int32)
    wr = torch.rand(n, generator=gen) < 0.4
    tags = torch.randint(0, 2**17, (n,), generator=gen, dtype=torch.int32)
    ld = torch.randint(0, 16, (n,), generator=gen, dtype=torch.int32)
    nxm = torch.rand(n, generator=gen) < 0.1
    out = {}
    for name, where in (("card", dev), ("cpu", torch.device("cpu"))):
        m2s = packet.rc_packetize(addr.to(where), wr.to(where),
                                  tags=tags.to(where), ld_id=ld.to(where))
        s2m = packet.ep_respond(m2s["headers"], dev_load=2,
                                nxm=nxm.to(where))
        out[name] = [m2s["headers"], s2m["headers"], m2s["wire_bytes"],
                     s2m["wire_bytes"]]
        for fields in (packet.ep_depacketize(m2s["headers"]),
                       packet.rc_complete(s2m["headers"])):
            out[name] += [fields[k] for k in sorted(fields)]
    bad = [i for i, (c, h) in enumerate(zip(out["card"], out["cpu"]))
           if not torch.equal(c.cpu(), h)]
    words = out["cpu"][0].numel() + out["cpu"][1].numel()
    print(f"[slice 11] codec: {n} requests, {words} M2S + S2M header words "
          f"and {len(out['cpu']) - 4} decoded fields, card against CPU: "
          f"{len(bad)} differ; wire bytes {int(out['cpu'][2])} M2S, "
          f"{int(out['cpu'][3])} S2M")
    if bad:
        raise AssertionError(f"[slice 11] the codec's outputs {bad} differ "
                             f"between the card and the CPU")
    return words


def dryrun_line(res, want_flops) -> str:
    return (f"[slice 11] dry run {res.arch} {res.shape} (batch "
            f"{res.global_batch} x {res.seq_len}"
            f"{', ' + str(res.overrides) if res.overrides else ''}): "
            f"{res.status}, traced {res.flops:.4e} FLOPs against "
            f"model_flops {want_flops:.4e} (ratio "
            f"{want_flops / max(res.flops, 1):.3f}), peak "
            f"{res.peak_memory_per_device / 1e9:.2f} GB, fits "
            f"{res.fits}, bytes {res.traffic_bytes:.3e} (products "
            f"{res.dot_traffic_bytes:.3e}), arguments "
            f"{res.argument_bytes / 1e9:.2f} GB, traced in {res.trace_s} s"
            f"{' ' + res.note if res.note else ''}")


def slice11_path(dev, card, train_peaks):
    """Slice 11's phase: the codec on the card; the dry run on fake CUDA
    tensors for every architecture at decode_32k and for h2o-danube-3-4b's
    four cells, each row printed with its FLOPs beside ``model_flops``;
    then the dry run of the training runs measured above (same overrides,
    batch and sequence), each estimated peak held within PEAK_TOLERANCE of
    that run's own peak (``max_memory_allocated`` less what was allocated
    before it).  The kernel counts, reset before and read after, stay 0.
    Returns the rows and the peak ratios."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.models.model import SHAPES, ShapeCell
    from repro_torch.roofline import analysis
    t0 = time.perf_counter()
    words = codec_on_the_card(dev)
    print(f"[slice 11] codec took {time.perf_counter() - t0:.1f} s")
    ops.reset_launches()
    t0 = time.perf_counter()
    cells = [(a, "decode_32k") for a in ARCHS]
    cells += [("h2o-danube-3-4b", s) for s in SHAPES if s != "decode_32k"]
    rows, failed = [], []
    for arch, shape in cells:
        res = dryrun.run_cell(arch, shape, device=dev)
        if res.status == "ok":
            print(dryrun_line(res, analysis.model_flops(
                analysis.config_of(res.row()), SHAPES[shape])))
            r = analysis.analyze_cell(res.row())
            print(f"[slice 11]   roofline on H100 data-sheet peaks: compute "
                  f"{r.compute_s:.4g} s, memory {r.memory_s:.4g} s (all "
                  f"operations {r.memory_hi_s:.4g}), cxl {r.cxl_s:.4g} s: "
                  f"{r.dominant}-bound, MODEL/traced {r.useful_ratio:.3f}, "
                  f"MFU bound {r.mfu_bound:.1%}")
        else:
            print(dryrun.line(res))
        failed += [f"{arch} {shape}"] * (res.status == "failed")
        rows.append(res.row())
    print(f"[slice 11] dry run of {len(cells)} cells took "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ratios = {}
    for run in train_peaks:
        cell = ShapeCell("train", run["seq"], run["batch"], "train")
        res = dryrun.run_cell(run["arch"], cell, overrides=run["overrides"],
                              device=dev)
        rows.append(res.row())
        if res.status != "ok":
            print(dryrun.line(res))
            failed.append(f"{run['arch']} training run")
            continue
        measured = run["peak"] - run["held"]
        ratio = res.peak_memory_per_device / measured
        label = (f"{run['arch']} {run['overrides']} "
                 f"{run['batch']}x{run['seq']}")
        ratios[label] = ratio
        cfg = analysis.config_of(res.row())
        print(dryrun_line(res, analysis.model_flops(cfg, cell)))
        print(f"[slice 11] peak of {label}: estimated "
              f"{res.peak_memory_per_device / 1e9:.3f} GB, measured "
              f"{measured / 1e9:.3f} GB (max_memory_allocated "
              f"{run['peak'] / 1e9:.3f} GB less {run['held'] / 1e9:.3f} GB "
              f"held before the run): ratio {ratio:.4f} ({card})")
        if cfg.arch == "h2o-danube-3-4b":
            from repro_torch.models import transformer as tf
            n = tf.n_param_elements(tf.param_shapes(cfg))
            print(f"[slice 11] {cfg.arch} 1 x {run['seq']}: chip_smoke's "
                  f"train_flops {train_flops(cfg, n, 1, run['seq']):.4e}, "
                  f"model_flops {analysis.model_flops(cfg, cell):.4e}, "
                  f"traced {res.flops:.4e}")
    print(f"[slice 11] dry run of {len(train_peaks)} training runs took "
          f"{time.perf_counter() - t0:.1f} s")
    launches = dict(ops.LAUNCHES)
    print(f"[slice 11] launch counts over the dry run {launches}")
    off = {k: r for k, r in ratios.items() if abs(r - 1) > PEAK_TOLERANCE}
    # the decode cells trace the model's einsums, which count as the plain
    # path of K4's dense entry; nothing else may run
    if failed or off or len(ratios) != len(train_peaks) \
            or any(n for k, n in launches.items()
                   if k != "decode_attention_ref"):
        raise AssertionError(f"[slice 11] failed cells {failed}; peaks off "
                             f"by more than {PEAK_TOLERANCE:.0%}: {off}; "
                             f"launches {launches}")
    return dict(rows=rows, ratios=ratios, codec_words=words,
                launches=launches)


# ---------------------------------------------------------------------------
# Slice 12: the analyzer on the card; the four examples
# ---------------------------------------------------------------------------
#: the JAX examples' printed lines (tools/examples_golden.py), which the
#: port's examples must print on the card
EXAMPLES_GOLDEN = ROOT / "examples" / "expected_output"
#: example -> {kernel: launches it must make (None: at least one)}; every
#: other kernel and every plain version must stay at 0
SLICE12_EXAMPLES = {
    "quickstart": {"mesi_segment": None},
    "characterize_cxl": {"mesi_segment": None, "mesi_dyn_segment": None},
    "serve_kv_cxl": {"paged_attention": 12, "flash_attention": 2 * 6,
                     "decode_attention": 2 * 6 * 2},
    "train_e2e": {},
}


def run_example(name, argv, card):
    """``examples/<name>_torch.py`` as a script with `argv` (no
    ``--device``: the card), the launch counts set to 0 just before and
    read just after; returns the counts, the wall time, the lines it
    printed (also echoed here) and a copy of each K4 call's inputs and
    output (``k4_calls``)."""
    import contextlib
    import io
    import runpy
    import torch
    from repro_torch.kernels import ops
    path = ROOT / "examples" / f"{name}_torch.py"
    buf = io.StringIO()
    saved = sys.argv, ops.paged_attention
    k4_calls = []

    def recorded(*args):
        # the wrapper counts its launch; the copies are taken before it
        # runs, since the serve loop writes its KV pool after each step
        inputs = [a.clone() for a in args]
        out = saved[1](*args)
        k4_calls.append((inputs, out.clone()))
        return out

    sys.argv = [str(path), *argv]
    ops.paged_attention = recorded
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(str(path), run_name="__main__")
        torch.cuda.synchronize()
    finally:
        sys.argv, ops.paged_attention = saved
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    for line in buf.getvalue().splitlines():
        print(f"[slice 12] {name}: {line}")
    want = SLICE12_EXAMPLES[name]
    bad = {k: n for k, n in launches.items()
           if (k not in want and n) or (k in want and (
               n < 1 if want[k] is None else n != want[k]))}
    print(f"[slice 12] {name} took {wall:.2f} s, launches "
          f"{ {k: n for k, n in launches.items() if n} } ({card})")
    if bad:
        raise AssertionError(f"[slice 12] {name}: launches {bad}, want "
                             f"{want} and no plain version")
    lines = buf.getvalue().splitlines()
    golden = EXAMPLES_GOLDEN / f"{name}.txt"
    if golden.exists():
        ref = golden.read_text().splitlines()
        diff = [i for i in range(max(len(ref), len(lines)))
                if ref[i:i + 1] != lines[i:i + 1]]
        print(f"[slice 12] {name}: {len(lines)} lines, {len(diff)} differ "
              f"from the JAX example's ({golden.name})")
        if diff:
            raise AssertionError(f"[slice 12] {name} departs from the JAX "
                                 f"example at lines {diff[:10]}")
    return dict(launches=launches, wall_s=wall, lines=lines,
                k4_calls=k4_calls)


def example_k4_parity(calls, card):
    """The serve example's K4 launches, each against the plain version on
    the same inputs (copied when the loop made the call), with K4's
    tolerance of phase 2c (rtol = atol: 3e-5 in float32, 2e-2 in
    bfloat16); returns the largest error and the shapes."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    tol = {torch.float32: 3e-5, torch.bfloat16: 2e-2}
    err, bad = 0.0, []
    for i, (args, kern) in enumerate(calls):
        plain = pa.paged_attention_ref(*args)
        diff = (kern.float() - plain.float()).abs()
        err = max(err, float(diff.max()))
        t = tol[args[0].dtype]
        if (bool((diff > t * (1 + plain.float().abs())).any())
                or kern.dtype != args[0].dtype
                or not bool(torch.isfinite(kern).all())):
            bad.append(i)
    torch.cuda.synchronize()
    q, kp, _, bt, cl = calls[0][0]
    b, h, d = q.shape
    shape = {"B": b, "H": h, "K": kp.shape[2], "D": d, "page": kp.shape[1],
             "nblk": bt.shape[1], "pool": str(kp.dtype)[6:],
             "ctx": [int(calls[0][0][4].min()), int(calls[-1][0][4].max())]}
    plan = pa.launch_plan(q, kp, kp, bt)
    print(f"[slice 12] serve_kv_cxl: K4's {len(calls)} launches against the "
          f"plain version on their own inputs {shape}, {plan['parts']} "
          f"partition(s) of {plan['part_len']}: max|kernel - plain| = "
          f"{err:.3g} (tolerance {tol[q.dtype]:g}, rtol = atol) ({card})")
    if bad:
        raise AssertionError(f"[slice 12] the serve example's K4 launches "
                             f"{bad} disagree with the plain version")
    return dict(launches=len(calls), max_abs_err=err, shape=shape,
                parts=plan["parts"])


def slice12_path(dev, card):
    """Slice 12's phase: ``repro_torch.analysis.main`` on the card (the
    lint of ``src/repro_torch`` against its committed baseline, then the
    graph audit with the CUDA kernels: the ``[cuda]`` entry points traced
    and the stats triangulated against the reference at T = 2, 3 and 4),
    which must exit 0 with ``audit=ok`` and launch K1/K2 and K3; then the
    four port examples in-process on the card, each with the counts reset
    before and read after (SLICE12_EXAMPLES), and the serve example's K4
    launches against the plain version.  Returns the counts by path
    (``analysis``, ``examples``), the timings and K4's check (``k4``)."""
    import contextlib
    import io
    import tempfile
    import torch
    from repro_torch import analysis
    from repro_torch.kernels import ops
    out = {"launches": {}, "examples": {}}
    buf = io.StringIO()
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = analysis.main([
            str(ROOT / "src" / "repro_torch"), "--root", str(ROOT),
            "--device", str(dev), "--baseline",
            str(ROOT / "tools" / "repro_torch_lint_baseline.json")])
    torch.cuda.synchronize()
    out["analysis_s"] = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    out["launches"]["analysis"] = launches
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        print(f"[slice 12] analysis: {line}")
    print(f"[slice 12] analysis took {out['analysis_s']:.2f} s, launches "
          f"{ {k: n for k, n in launches.items() if n} } ({card})")
    out["summary"] = lines[-1] if lines else ""
    if rc != 0 or not out["summary"].endswith("audit=ok") \
            or not launches["mesi_segment"] \
            or not launches["mesi_dyn_segment"]:
        raise AssertionError(f"[slice 12] analysis exited {rc}: "
                             f"{out['summary']!r}, launches {launches}")
    with tempfile.TemporaryDirectory() as d:
        for name in SLICE12_EXAMPLES:
            argv = (["--ckpt-dir", f"{d}/ckpt"] if name == "train_e2e"
                    else [])
            out["examples"][name] = run_example(name, argv, card)
    calls = {n: e.pop("k4_calls") for n, e in out["examples"].items()}
    out["k4"] = example_k4_parity(calls["serve_kv_cxl"], card)
    out["launches"]["examples"] = {
        k: sum(e["launches"][k] for e in out["examples"].values())
        for k in ops.LAUNCHES}
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"the repro_torch sources are not beside {__file__}")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import cache as cache_mod
    from repro_torch.core import numa
    from repro_torch.core.simulator import CXLRAMSim, SimConfig
    from repro_torch.kernels import build
    from repro_torch.workloads import pollution_probe

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    reports = build.build()
    print(f"[build] {sorted(reports) or 'cached'} in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "setmaxnreg" in line:
                print(f"[build] {name}: {line.strip()}")
    sass = tensor_core_instructions("flash_attention")
    print(f"[build] flash_attention SASS: {sass['HGMMA']} HGMMA (wgmma), "
          f"{sass['HMMA']} HMMA (mma.sync) instructions")
    if not sass["HGMMA"]:
        fail("the flash-attention library has no HGMMA instruction")

    # ---- 2. kernels against plain versions, on the card ----------------
    sim = CXLRAMSim(SimConfig())               # the Table-I host, on cuda
    gen = torch.Generator().manual_seed(0)
    t0 = time.perf_counter()
    k1 = k1_parity(dev, gen)
    print(f"[parity K1] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    k3 = k3_parity(sim, dev, gen)
    print(f"[parity K3] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    split_err = split_parity(dev, gen)
    print(f"[parity split] phase took {time.perf_counter() - t0:.1f} s")

    # ---- 3. the main paths ----------------------------------------------
    print(f"[main] memdevs {sim.memdevs()}")
    print(f"[main] regions {sim.online('znuma')}")
    print(f"[main] numastat {sim.numastat()}")
    print(f"[main] CXL latency breakdown {sim.latency_breakdown()}")
    static = static_main_path(sim)
    sweeps = run_dynamic_sweeps(sim)
    kv_decode_device_equals_host(sim, sweeps["A"]["rows"])
    golden_launches = goldens_on_the_card(dev)
    t0 = time.perf_counter()
    serve = serve_main_path(dev, card)
    hybrid_serve = hybrid_serve_path(dev, card)
    kda_serve = kda_serve_path(dev, card)
    print(f"[serve] phase took {time.perf_counter() - t0:.1f} s")

    # ---- 3c. slice 8: streamed, sharded, resumed; probe; MoEStream -------
    t0 = time.perf_counter()
    pad_err = padding_rows_on_the_card(sim, dev)
    s8 = slice8_path(sim, dev, card, static, sweeps)
    print(f"[slice 8] phase took {time.perf_counter() - t0:.1f} s")

    # ---- 2b. K4 against its plain version, on the card ------------------
    t0 = time.perf_counter()
    k4_err = k4_parity(dev, gen, serve["r"]["last_attn_inputs"],
                       serve["r"]["kv"])
    print(f"[parity K4] phase took {time.perf_counter() - t0:.1f} s")

    # ---- 2c. slice 4: K5, K6, K7 against their plain versions ----------
    t0 = time.perf_counter()
    a8 = triad_trace_8x(dev)
    k6_err = k6_parity(dev, gen, a8)
    k7_err = k7_parity(dev, gen)
    k5_err = k5_parity(dev, gen)
    print(f"[parity slice 4] phase took {time.perf_counter() - t0:.1f} s")

    # ---- 3b. slice 4's path: K5 at danube's prefill width, K6, K7 -------
    t0 = time.perf_counter()
    s4 = slice4_main_path(dev, serve["cfg"], serve["params"], a8)
    print(f"[slice 4] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    s4_t = slice4_times(s4, serve["cfg"], card)
    k5_mimo = k5_mimo_times(dev, card)
    k5_kimi = k5_kimi_times(dev, card)
    s4_launches = s4["launches"]
    s4_errs = (s4["k5"]["err"], s4["k6"]["err"], s4["k5w"]["err"],
               s4["k5p"]["err"])
    del s4, a8                  # free the slice's inputs before phase 4
    torch.cuda.empty_cache()
    print(f"[time slice 4] phase took {time.perf_counter() - t0:.1f} s")

    # ---- 4. times ---------------------------------------------------------
    table1 = cache_mod.CacheParams()
    k1_t = k1_times(dev, table1, card)
    print(f"[time K1] Table-I parity batch {k1['plain_shape']}: kernel "
          f"{k1['prefix_ms']:.3f} ms, plain version {k1['plain_ms']:.1f} ms "
          f"({card})")
    k3_t = k3_times(sim, dev, card)
    print(f"[time K3] Table-I parity batch {k3['plain_shape']}: kernel "
          f"{k3['prefix_ms']:.3f} ms, plain version {k3['plain_ms']:.1f} ms "
          f"({card})")
    profile(lambda: (sim.stream_suite((2, 4, 6, 8)),
                     sim.sweep((4,), policies=[numa.ZNuma(0.0),
                                               numa.WeightedInterleave(1, 1),
                                               numa.ZNuma(1.0)])),
            "PR 11 main path (static STREAM sweep)")
    profile(lambda: sim.sweep((8,), **dynamic_sweeps()["A"]),
            "sweep A (tiering)")
    profile(lambda: sim.sweep((2, 4, 6, 8), mesh=4, stream_chunk=SUITE_CHUNK),
            "slice 8 (a): the §IV suite, mesh=4, stream_chunk=262144",
            kernel="mesi_chain_kernel")
    profile(lambda: sim.sweep((8,), mesh=3, stream_chunk=SWEEP_A_CHUNK,
                              **dynamic_sweeps()["A"]),
            "slice 8 (b): sweep A, mesh=3, stream_chunk=131072",
            kernel="mesi_dyn_kernel")
    for label in ("table1", "table1 (0.25, 1)"):
        profile(lambda label=label: pollution_probe(
            table1, device=dev, **POLLUTION_KNOBS[label]),
            f"slice 8 (d): pollution_probe {label}",
            kernel="mesi_chain_kernel")
    k4_t = k4_times(dev, gen, serve["r"]["last_attn_inputs"], card)
    dense_t = decode_attention_times(dev, card)
    from repro_torch.launch import serve as serve_mod
    profile(lambda: serve_mod.run(serve["cfg"], device=dev,
                                  params=serve["params"], decode=4),
            "serve loop at full width, 8 requests, prefill 48, decode 4",
            kernel="paged_attention", note="the rest is host time")

    # ---- 3d. slice 9: training at full width ------------------------------
    del serve["params"]         # free the served weights (8 GB) first
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_launches, train_peaks = slice9_path(dev, card)
    print(f"[slice 9] phase took {time.perf_counter() - t0:.1f} s")

    # ---- 3e. slice 10: the rwkv, rec and MLA kinds, served and trained --
    t0 = time.perf_counter()
    s10 = slice10_path(dev, card)
    print(f"[slice 10] phase took {time.perf_counter() - t0:.1f} s")

    # ---- 3f. slice 11: the codec on the card; the one-card dry run -------
    t0 = time.perf_counter()
    s11 = slice11_path(dev, card, train_peaks + s10["peaks"])
    print(f"[slice 11] phase took {time.perf_counter() - t0:.1f} s")

    # ---- 3g. slice 12: the analyzer on the card; the four examples -------
    t0 = time.perf_counter()
    s12 = slice12_path(dev, card)
    print(f"[slice 12] phase took {time.perf_counter() - t0:.1f} s")
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all")

    # ---- 5. results -------------------------------------------------------
    dyn_launches = sum(s["launches"]["mesi_dyn_segment"]
                       for s in sweeps.values())
    # each kernel's launches on every path of this run that reads them
    counted = {"§IV suite + policies": static["launches"]}
    counted |= {f"sweep {n}": s["launches"] for n, s in sweeps.items()}
    counted |= {f"golden {n}": c for n, c in golden_launches.items()}
    counted |= {p: v["launches"] for p, v in s8["paths"].items()}
    counted["serve"] = serve["launches"]
    counted["slice 4"] = s4_launches
    counted["train"] = train_launches
    counted |= s10["launches"]
    counted["dry run"] = s11["launches"]
    counted |= s12["launches"]

    def by_path(kernel):
        return {p: c.get(kernel, 0) for p, c in counted.items()}

    print(card)
    print(json.dumps({"kernels": [{
        "name": "mesi_segment", "route": "cuda",
        "launches_by_path": by_path("mesi_segment"),
        "source": "src/repro_torch/kernels/csrc/mesi.cu",
        "replaces": "src/repro/kernels/cache_sim.py:428",
        "also_replaces": "src/repro/kernels/cache_sim.py:587",
        "launches": static["launches"]["mesi_segment"],
        "max_abs_err": max(k1["max_err"], split_err, pad_err),
        "ms": k1_t["ms"], "shape": k1_t["shape"],
        "prepass_ms": k1_t["prepass_ms"],
        "policy_ms": k1_t["policy"]["ms"],
        "policy_shape": k1_t["policy"]["shape"],
        "policy_bound_ms": k1_t["policy"]["bound_ms"],
        "plain_ms": k1["plain_ms"], "plain_shape": k1["plain_shape"],
        "ms_on_plain_shape": k1["prefix_ms"],
        "bound_ms": k1_t["bound_ms"], "bound_by": "bytes",
        "library_ms": None}, {
        "name": "mesi_dyn_segment", "route": "cuda",
        "launches_by_path": by_path("mesi_dyn_segment"),
        "source": "src/repro_torch/kernels/csrc/mesi_dyn.cu",
        "replaces": "src/repro/kernels/cache_sim.py:911",
        "launches": dyn_launches,
        "launches_by_sweep": {n: s["launches"]["mesi_dyn_segment"]
                              for n, s in sweeps.items()},
        "max_abs_err": max(k3["max_err"], pad_err),
        "ms": k3_t["A"]["ms"], "shape": k3_t["A"]["shape"],
        "ms_by_sweep": {n: t["ms"] for n, t in k3_t.items()},
        "prepass_ms_by_sweep": {n: t["prepass_ms"] for n, t in k3_t.items()},
        "no_boundary_ms_by_sweep": {n: t["no_boundary_ms"]
                                    for n, t in k3_t.items()
                                    if "no_boundary_ms" in t},
        "plain_ms": k3["plain_ms"], "plain_shape": k3["plain_shape"],
        "ms_on_plain_shape": k3["prefix_ms"],
        "bound_ms": k3_t["A"]["bound_ms"], "bound_by": "bytes",
        "bound_ms_by_sweep": {n: t["bound_ms"] for n, t in k3_t.items()},
        "library_ms": None}, {
        "name": "paged_attention", "route": "cuda",
        "launches_by_path": by_path("paged_attention"),
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:93",
        "launches": serve["launches"]["paged_attention"],
        "max_abs_err": k4_err[torch.float32],
        "max_abs_err_bf16": k4_err[torch.bfloat16],
        "ms": k4_t["serve"]["ms"], "shape": k4_t["serve"]["shape"],
        "parts": k4_t["serve"]["parts"], "blocks": k4_t["serve"]["blocks"],
        "device_ms": k4_t["serve"]["device_ms"],
        "wrapper_ms": k4_t["serve"]["wrapper_ms"],
        "plain_ms": k4_t["serve"]["plain_ms"],
        "bound_ms": k4_t["serve"]["bound_ms"],
        "bound_by": k4_t["serve"]["bound_by"],
        "library_ms": k4_t["serve"]["library_ms"],
        "library": "scaled_dot_product_attention(enable_gqa=True) on the "
                   "K/V gathered beforehand (gather not timed)",
        "ctx4096": k4_t["ctx4096"],
        "mla_cell": k4_t["mla_cell"], "kimi_cell": k4_t["kimi_cell"],
        "hybrid_cell": {k: k4_t[f"hybrid_{k}"] for k in ("full", "window")},
        "hybrid_serve": hybrid_serve,
        "kda_serve": kda_serve,
        "decode_attention_launches": serve["launches"]["decode_attention"],
        "decode_attention": dense_t,
        "slice10_serves": {a: v["k4"] for a, v in s10["serve"].items()},
        "slice12_serve_example": s12["k4"]}, {
        "name": "flash_attention", "route": "cuda",
        "launches_by_path": by_path("flash_attention"),
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:109",
        "launches": s4_launches["flash_attention"],
        "max_abs_err": k5_err[torch.float32],
        "max_abs_err_bf16": k5_err[torch.bfloat16],
        "max_abs_err_danube": s4_errs[0],
        "max_abs_err_windowed": s4_errs[2],
        "max_abs_err_prefill": s4_errs[3],
        "variant_launches": s4_launches["flash_attention_variants"],
        "sass": sass,
        "ms": s4_t["causal"]["ms"], "shape": s4_t["causal"]["shape"],
        "tflops": s4_t["causal"]["tflops"],
        "cuda_cores_ms": s4_t["causal"]["cuda_cores_ms"],
        "plain_ms": s4_t["causal"]["plain_ms"],
        "bound_ms": s4_t["causal"]["bound_ms"],
        "bound_by": s4_t["causal"]["bound_by"],
        "library_ms": s4_t["causal"]["library_ms"],
        "library": s4_t["causal"]["library"],
        "library_backend": s4_t["causal"]["library_backend"],
        "windowed": s4_t["windowed"], "prefill": s4_t["prefill"],
        "mimo_prefill": k5_mimo, "kimi_prefill": k5_kimi}, {
        "name": "cache_sim", "route": "cuda",
        "launches_by_path": by_path("cache_sim"),
        "source": "src/repro_torch/kernels/csrc/cache_sim.cu",
        "replaces": "src/repro/kernels/cache_sim.py:150",
        "launches": s4_launches["cache_sim"],
        "max_abs_err": max(k6_err, s4_errs[1]),
        "ms": s4_t["k6"]["ms"], "shape": s4_t["k6"]["shape"],
        "geometry": s4_t["k6"]["geometry"],
        "wrapper_ms": s4_t["k6"]["wrapper_ms"],
        "device_ms": s4_t["k6"]["device_ms"],
        "chain_device_ms": s4_t["k6"]["chain_device_ms"],
        "prepass_device_ms": s4_t["k6"]["prepass_device_ms"],
        "chains": s4_t["k6"]["chains"],
        "longest_chain": s4_t["k6"]["longest_chain"],
        "us_per_access_on_chain": s4_t["k6"]["us_per_access_on_chain"],
        "one_chain_us_per_access": s4_t["k6"]["one_chain_us_per_access"],
        "chain_floor_ms": s4_t["k6"]["chain_floor_ms"],
        "plain_ms": s4_t["k6"]["plain_ms"],
        "bound_ms": s4_t["k6"]["bound_ms"], "bound_by": "bytes",
        "library_ms": None}, {
        "name": "stream_triad", "route": "cuda",
        "launches_by_path": by_path("stream_triad"),
        "source": "src/repro_torch/kernels/csrc/stream_triad.cu",
        "replaces": "src/repro/kernels/stream_triad.py:42",
        "launches": s4_launches["stream_triad"],
        "max_abs_err": k7_err,
        "ms": s4_t["k7"]["ms"], "shape": s4_t["k7"]["shape"],
        "runs_ms": s4_t["k7"]["runs"],
        "library_runs_ms": s4_t["k7"]["library_runs"],
        "gbps": s4_t["k7"]["gbps"],
        "plain_ms": s4_t["k7"]["plain_ms"],
        "bound_ms": s4_t["k7"]["bound_ms"], "bound_by": "bytes",
        "library_ms": s4_t["k7"]["library_ms"],
        "library": "torch.add(b, c, alpha=2.5)"}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
