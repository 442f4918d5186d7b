#!/usr/bin/env python3
"""Time design variants of K6 (single-level LRU cache) and K4 (paged decode
attention) on a CUDA card, on the same inputs in one run.

    python3 tools/k4k6_variants.py [--rounds N] [--baseline DIR]

Each variant is the committed ``csrc/cache_sim.cu`` and
``csrc/paged_attention.cu`` (with the headers they include) under named
edits: exact text replacements of a source (the script stops if a source no
longer holds the text) and values given to names of the wrappers' modules
while the variant runs.  Every variant's libraries are built with the
library's `nvcc` flags into ``build/k4k6_variants/`` (all at once) and run
through the wrappers ``cache_sim._launch_cache_sim`` and
``paged_attention._launch``.

K6 variants (the committed kernel: a bucket pre-pass with its own scan
and scatter, then one warp per set chain, the set in registers, the
victim by one min-reduction beside the tag compare):

* ``row``: one chain: one warp walks the whole trace (at 2048 x 16 the
  sets live in device memory, as in the port's first K6);
* ``chains256``: 256 chains, each holding 8 sets in shared memory;
* ``mesi_prepass``: the MESI kernels' pre-pass as it is (one block scans
  the per-tile counts; its scatter waits for each 32 addresses), at tiles
  of 16,384 entries (the MESI rule's 65,536 leaves the Table-I trace 32
  scatter warps);
* ``ahead1``: K6's scatter loading one batch of 32 addresses at a time
  instead of eight;
* ``shfl_argmin``: the victim by ``mesi::warp_argmin``'s five shuffle
  steps, after the tag compare, instead of one min-reduction beside it;
* ``victim_after``: the min-reduction after the tag compare, on a miss
  only;
* ``rolled``: a full batch of 32 accesses walked by a loop instead of
  unrolled (so access j + 1's shuffles wait for access j).

K4 variants (the committed kernel: split-K over the context, cp.async
double-buffered tiles of 16-byte vectors, a combine pass):

* ``nosplit``: one partition per context (S = 1): K x B blocks;
* ``pv1``: one accumulator element per P.V item (the committed kernel
  takes two adjacent ones, reading each p once for both);
* ``scalar``: plain loads and stores into the tile buffer, no vectors and
  no cp.async, one element per P.V item (the kernel's path for rows that
  are no whole 16-byte vectors);
* ``longest``: the longest partitions that still give two blocks per SM,
  whatever the card holds at once (the committed plan counts the waves of
  blocks that the kernel's occupancy allows and minimises the tiles the
  busiest SM walks).

``--baseline DIR`` adds a variant built from an earlier ``csrc`` directory
(for example the parent commit's, unpacked with ``git archive``), called
through that earlier C interface: K6 as ``cache_sim(addr, hits, tags, use,
n, n_sets, n_ways, device, stream)``, K4 as ``paged_attention(q, k, v,
block_table, context_lens, out, b, h, d, page, kv_heads, nblk, scale,
q_dtype, kv_dtype, device, stream)``.  It is called through ctypes
directly, without the wrappers' checks and allocations, so where the host
sets the pace (K4 at the serve shapes) its event times leave out host work
that the other variants' include; the device times compare like with like.

Launches: K6 on the 8 x L2 STREAM triad trace at the Table-I L2 (2048 x 16,
2,097,150 accesses) and on a 65,536-access trace of one set (16 ways, 48
lines: one chain); K4 at a 4096-token decode (B = 8, H = 32, K = 8,
D = 120, page 16) with f32 and with bf16 pools and queries, and at the
serve loop's shapes (6 blocks of 16, contexts 63, f32).  K6 variants must
equal the committed kernel bitwise, K4 variants lie within rtol = atol =
3e-5 (f32) or 2e-2 (bf16) of it (the script stops otherwise).  Each launch
is timed by CUDA events over a batch of calls, after a warm-up, in
``--rounds`` rounds (default 2), the variants in turn and in reverse order
on odd rounds, and once more by torch.profiler, whose device time leaves
out the host's gaps between launches (where the host is the slower, as at
the serve shapes, the events time the host).  Prints the card's name and
power limit, a line per launch and variant (mean ms, the rounds, the ratio
to the committed kernel, the device time) and last a JSON object of the
times.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "k4k6_variants"
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

LIBS = ("cache_sim", "paged_attention")
FILES = ("cache_sim.cu", "paged_attention.cu", "mesi_chain.cuh",
         "mesi_access.cuh")

_K6_ENTRY = """  if (n < 0 || !takes(n_sets, n_ways, bits)) return cudaErrorInvalidValue;
"""


def chains(bits: int):
    """K6 with at most 2**bits chains."""
    return [("cache_sim.cu", _K6_ENTRY,
             _K6_ENTRY + f"  bits = bits > {bits} ? {bits} : bits;\n")]


def _one_partition(b, kv_heads, capacity, page, sms, resident=2):
    unit = math.lcm(page, 32)
    return 1, -(-max(capacity, 1) // unit) * unit


def _longest_partitions(b, kv_heads, capacity, page, sms, resident=2):
    """The first split rule: partitions as long as they can be while the
    blocks number at least 2 * sms (occupancy not read)."""
    unit = math.lcm(page, 32)
    whole = -(-max(capacity, 1) // unit) * unit
    shortest = -(-256 // unit) * unit
    if whole <= shortest or b * kv_heads == 0:
        return 1, whole
    per_pair = -(-2 * sms // (b * kv_heads))
    part_len = max(shortest, -(-capacity // (per_pair * unit)) * unit)
    return -(-capacity // part_len), part_len


# (name, kernel, what it tests, [(file, committed text, replacement)],
#  {(module, name): value while the variant runs})
VARIANTS = [
    ("committed", None, "the kernels as committed", [], {}),
    ("row", "K6", "one chain: one warp walks the whole trace", chains(0),
     {}),
    ("chains256", "K6", "256 chains of 8 sets in shared memory", chains(8),
     {}),
    # (the trace stands in for the is_write, core and tier planes: K6 reads
    # only a record's position and address)
    ("mesi_prepass", "K6", "the MESI pre-pass as it is (one block scans the "
     "counts, the scatter waits for each 32 loads), tiles of 16,384",
     [("cache_sim.cu",
       "    err = prepass(addr, n, bits, tile, hist, start, rec, s);",
       "    err = mesi::launch_bucket(addr, addr, addr, addr, 1, n, bits,"
       " tile, hist, start, rec, s);")],
     {("cache_sim", "cache_sim_tile"): lambda bits: 16384}),
    ("shfl_argmin", "K6", "the victim by mesi::warp_argmin (5 shuffle "
     "steps), after the tag compare",
     [("cache_sim.cu",
       """  const int least = __reduce_min_sync(kFull, way_lane ? clock : INT_MAX);
  const unsigned oldest = __ballot_sync(kFull, way_lane && clock == least);
  *hit = match != 0;
  return __ffs(match ? match : oldest) - 1;""",
       """  *hit = match != 0;
  return match ? __ffs(match) - 1 : mesi::warp_argmin(clock, way_lane);""")],
     {}),
    ("victim_after", "K6", "the victim's min-reduction after the tag "
     "compare, on a miss only",
     [("cache_sim.cu",
       """  const int least = __reduce_min_sync(kFull, way_lane ? clock : INT_MAX);
  const unsigned oldest = __ballot_sync(kFull, way_lane && clock == least);
  *hit = match != 0;
  return __ffs(match ? match : oldest) - 1;""",
       """  *hit = match != 0;
  if (match) return __ffs(match) - 1;
  const int least = __reduce_min_sync(kFull, way_lane ? clock : INT_MAX);
  return __ffs(__ballot_sync(kFull, way_lane && clock == least)) - 1;""")],
     {}),
    ("ahead1", "K6", "the scatter loads one batch of 32 addresses at a "
     "time", [("cache_sim.cu", "constexpr int kAhead = 8;",
               "constexpr int kAhead = 1;")], {}),
    ("rolled", "K6", "a full batch of 32 accesses walked by a loop, not "
     "unrolled",
     [("cache_sim.cu", """#pragma unroll
      for (int j = 0; j < 32; ++j) one(j);""", """#pragma unroll 1
      for (int j = 0; j < 32; ++j) one(j);""")], {}),
    ("nosplit", "K4", "one partition per context: K x B blocks", [],
     {("paged_attention", "split_plan"): _one_partition}),
    ("pv1", "K4", "one element per P.V item instead of two",
     [("paged_attention.cu", "  constexpr int kPv = kVec ? 2 : 1;",
       "  constexpr int kPv = 1;")], {}),
    ("scalar", "K4", "plain loads into the tile buffer, no cp.async, one "
     "element per P.V item",
     [("paged_attention.cu",
       "  return aligned && (d * (kv_dtype == 0 ? 4 : 2)) % 16 == 0;",
       "  return false;")], {}),
    ("longest", "K4", "the longest partitions that give 2 blocks per SM, "
     "occupancy not read", [],
     {("paged_attention", "split_plan"): _longest_partitions}),
]


def sources():
    """{variant: {file: source text}}; stops if an edit no longer applies."""
    base = {f: (CSRC / f).read_text() for f in FILES}
    out = {}
    for name, _, _, edits, _ in VARIANTS:
        texts = dict(base)
        for f, old, new in edits:
            if texts[f].count(old) != 1:
                sys.exit(f"k4k6_variants: an edit of {name!r} no longer "
                         f"applies to {f}")
            texts[f] = texts[f].replace(old, new)
        out[name] = texts
    return out


def build(texts, baseline=None):
    """Compile every variant's libraries at once; {name: {library: CDLL}}.
    `baseline` is a directory holding an earlier csrc."""
    from repro_torch.kernels import build as kbuild
    dirs = {}
    for name, files in texts.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for f, text in files.items():
            (d / f).write_text(text)
        dirs[name] = d
    if baseline is not None:
        dirs["baseline"] = pathlib.Path(baseline).resolve()
    procs = {}
    for name, d in dirs.items():
        for lib in LIBS:
            out = OUT / name / f"lib{lib}.so"
            out.parent.mkdir(parents=True, exist_ok=True)
            procs[name, lib] = (subprocess.Popen(
                [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", str(out),
                 str(d / f"{lib}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                out)
    libs = {}
    for (name, lib), (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"k4k6_variants: nvcc failed on {name}'s {lib}.cu:\n"
                     f"{log}")
        libs.setdefault(name, {})[lib] = ctypes.CDLL(str(out))
    return libs


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def event_ms(fn, reps):
    """(mean device ms of `fn()` over `reps` calls, the last outputs)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def device_ms(fn, reps):
    """Device time per call of every kernel `fn()` launches, summed, by
    torch.profiler: the time without the host's gaps between launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # device events only: a CPU op also reports its kernels' device time
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) \
        / 1e3 / reps


def baseline_calls(libs):
    """The earlier C interface's K6 and K4, as (kernel -> fn(*inputs))."""
    import torch
    P, I = ctypes.c_void_p, ctypes.c_int
    k6, k4 = libs["cache_sim"], libs["paged_attention"]
    k6.cache_sim.argtypes = [P] * 4 + [ctypes.c_longlong, I, I, I, P]
    k6.cache_sim.restype = I
    k4.paged_attention.argtypes = ([P] * 6 + [I] * 6 + [ctypes.c_float]
                                   + [I] * 3 + [P])
    k4.paged_attention.restype = I

    def cache_sim(addr, n_sets, n_ways):
        dev = addr.device
        hits = torch.empty_like(addr)
        tags = torch.empty((n_sets, n_ways), dtype=torch.int32, device=dev)
        use = torch.empty_like(tags)
        rc = k6.cache_sim(addr.data_ptr(), hits.data_ptr(), tags.data_ptr(),
                          use.data_ptr(), addr.shape[0], n_sets, n_ways,
                          dev.index or 0,
                          torch.cuda.current_stream(dev).cuda_stream)
        assert rc == 0, f"baseline cache_sim: CUDA error {rc}"
        return [hits, tags, use]

    def paged(q, kp, vp, bt, cl):
        b, h, d = q.shape
        _, page, kh, _ = kp.shape
        out = torch.empty_like(q)
        codes = {torch.float32: 0, torch.bfloat16: 1}
        rc = k4.paged_attention(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(),
            cl.data_ptr(), out.data_ptr(), b, h, d, page, kh, bt.shape[1],
            d ** -0.5, codes[q.dtype], codes[kp.dtype], q.device.index or 0,
            torch.cuda.current_stream(q.device).cuda_stream)
        assert rc == 0, f"baseline paged_attention: CUDA error {rc}"
        return [out]
    return {"K6": cache_sim, "K4": paged}


def launches(dev):
    """name -> (kernel, inputs, reps, call(inputs) through the wrappers)."""
    import chip_smoke
    import torch
    from repro_torch.kernels import cache_sim as cs
    from repro_torch.kernels import paged_attention as pa
    gen = torch.Generator().manual_seed(0)
    a8 = chip_smoke.triad_trace_8x(dev)
    sets, ways = chip_smoke.table1_l2()
    one = torch.randint(0, 48, (65536,), generator=gen,
                        dtype=torch.int32).to(dev)

    def k6(addr, n_sets, n_ways):
        return list(cs._launch_cache_sim(addr, n_sets, n_ways))

    def k4(*args):
        return [pa._launch(*args)]

    def paged(b, nblk, ctx, n_pages, dtype):
        h, kh, d, page = 32, 8, 120, 16
        bt = torch.randperm(n_pages, generator=gen)[:b * nblk]
        return [torch.randn((b, h, d), generator=gen).to(dev, dtype),
                torch.randn((n_pages, page, kh, d), generator=gen)
                .to(dev, dtype),
                torch.randn((n_pages, page, kh, d), generator=gen)
                .to(dev, dtype),
                bt.to(torch.int32).reshape(b, nblk).to(dev),
                torch.full((b,), ctx, dtype=torch.int32, device=dev)]
    return {
        f"K6 triad {sets}x{ways}": ("K6", (a8, sets, ways), 3, k6),
        "K6 one set x16": ("K6", (one, 1, 16), 3, k6),
        "K4 ctx4096 f32": ("K4", paged(8, 256, 4096, 2048, torch.float32),
                           50, k4),
        "K4 ctx4096 bf16": ("K4", paged(8, 256, 4096, 2048, torch.bfloat16),
                            50, k4),
        "K4 serve f32": ("K4", paged(8, 6, 63, 56, torch.float32), 50, k4),
    }


def main() -> int:
    import torch
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import cache_sim as cs
    from repro_torch.kernels import paged_attention as pa
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--baseline", default=None,
                    help="a directory holding an earlier csrc to time too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k4k6_variants: no CUDA device is available")
    dev = torch.device("cuda")
    card = card_line()
    print(card)
    libs = build(sources(), args.baseline)
    modules = {"cache_sim": cs, "paged_attention": pa}
    # each variant's libraries as the wrappers configure them
    configured = {}
    real_load = kbuild.load
    for name in libs:
        if name == "baseline":
            continue
        kbuild.load = lambda lib, name=name: libs[name][lib]
        try:
            configured[name] = (cs._cache_sim_library(),
                                pa._library.__wrapped__())
        finally:
            kbuild.load = real_load
    base = baseline_calls(libs["baseline"]) if args.baseline else None
    edits = {name: py for name, _, _, _, py in VARIANTS}

    def run(variant, kernel, inputs, reps, call, timer=event_ms):
        if variant == "baseline":
            return timer(lambda: base[kernel](*inputs), reps)
        saved = {}
        cs_lib, pa_lib = configured[variant]
        patches = dict(edits[variant])
        patches["cache_sim", "_cache_sim_library"] = lambda: cs_lib
        patches["paged_attention", "_library"] = lambda: pa_lib
        for (mod, attr), value in patches.items():
            saved[mod, attr] = getattr(modules[mod], attr)
            setattr(modules[mod], attr, value)
        pa._plan.cache_clear()          # K4's plans cached by shape
        try:
            return timer(lambda: call(*inputs), reps)
        finally:
            for (mod, attr), value in saved.items():
                setattr(modules[mod], attr, value)
            pa._plan.cache_clear()

    results = {}
    for label, (kernel, inputs, reps, call) in launches(dev).items():
        names = ["committed"] + [n for n, k, _, _, _ in VARIANTS
                                 if k == kernel]
        if base is not None:
            names.append("baseline")
        want = None
        times = {v: [] for v in names}
        for v in names:                         # warm-up and check
            _, got = run(v, kernel, inputs, 1, call)
            if want is None:
                want = got
                continue
            for a, b in zip(got, want):
                if kernel == "K6":
                    ok = torch.equal(a, b)
                else:
                    tol = 3e-5 if a.dtype == torch.float32 else 2e-2
                    ok = bool(((a.float() - b.float()).abs()
                               <= tol * (1 + b.float().abs())).all())
                if not ok:
                    sys.exit(f"k4k6_variants: {label} {v} differs from the "
                             f"committed kernel")
        for r in range(args.rounds):
            for v in (names if r % 2 == 0 else names[::-1]):
                times[v].append(run(v, kernel, inputs, reps, call)[0])
        mean = {v: sum(t) / len(t) for v, t in times.items()}
        device = {v: run(v, kernel, inputs, reps, call, device_ms)
                  for v in names}
        for v in names:
            print(f"[{label}] {v:11s} {mean[v]:10.4f} ms (rounds "
                  f"{', '.join(f'{t:.4f}' for t in times[v])}); "
                  f"{mean[v] / mean['committed']:.3f}x committed; device "
                  f"time {device[v]:.4f} ms by the profiler; outputs "
                  f"{'equal to' if kernel == 'K6' else 'within tolerance of'}"
                  f" the committed kernel's ({card})")
        results[label] = dict(mean_ms=mean, rounds_ms=times,
                              device_ms=device)
    print(json.dumps({"card": card, "variants": {
        name: what for name, _, what, _, _ in VARIANTS}, "times": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
