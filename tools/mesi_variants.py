#!/usr/bin/env python3
"""Time design variants of the MESI kernels on a CUDA card, on the same
inputs in one run.

    python3 tools/mesi_variants.py [--rounds N]

Each variant is the committed ``csrc/mesi.cu`` (K1/K2), ``csrc/mesi_dyn.cu``
(K3) and their headers with named edits (exact text replacements: the
script stops if a source no longer holds the text), built with the
library's `nvcc` flags into ``build/mesi_variants/`` (every library at
once) and run through the wrappers ``cache_sim._launch`` and
``cache_sim._launch_dyn``:

* ``committed``: ``2**chain_bits(params)`` chains per row (128 at the
  Table-I geometry), their accesses from the bucket pre-pass;
* ``scan``: the same chains, each scanning its row's addresses 32 at a time
  and keeping its own by ballot, with no pre-pass (the issue's trace
  option (b));
* ``row``: ``scan`` with one chain per row: one warp walks the row's trace,
  the design of the port's first MESI kernels (its sets in shared memory
  where they fit, which those kernels did not do);
* ``warps1`` / ``warps2``: 1 or 2 chain warps per block instead of 4.

Launches: K1's §IV suite launch (the Table-I STREAM triad at 2, 4, 6 and
8 x L2, B = 4) and K3's sweeps A, B and C at the Table-I host, as
``chip_smoke.py`` builds them.  Every variant's outputs must equal the
committed kernel's bitwise (the script stops otherwise).  Each launch is
timed by CUDA events, one warm-up and then ``--rounds`` rounds (default 2),
the variants in turn and in reverse order on odd rounds.  Prints the card's
name and power limit, a line per launch and variant (mean ms, the rounds,
the speed-up over ``row``) and last a JSON object of the times.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "mesi_variants"
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

FILES = ("mesi.cu", "mesi_dyn.cu", "mesi_chain.cuh", "mesi_access.cuh")

# the scan (option (b)): a chain warp reads 32 addresses of the row at a
# time, the next 32 loading while these run, and keeps its own by ballot
SCAN_K1 = [
    ("mesi.cu", """    const int* __restrict__ t0, const Rec* __restrict__ rec,""",
     """    const int* __restrict__ addr, const int* __restrict__ is_write,
    const int* __restrict__ core, const int* __restrict__ tier,
    const int* __restrict__ t0, const Rec* __restrict__ rec,"""),
    ("mesi.cu", """  const Rec* rr = rec + row * n;
  long cur = start[row * (m + 1) + chain];
  const long hi = start[row * (m + 1) + chain + 1];
  Rec r = mesi::load_rec(rr, cur, hi, lane);
  while (cur < hi) {
    const long cnt = hi - cur < 32 ? hi - cur : 32;
    const Rec next = mesi::load_rec(rr, cur + 32, hi, lane);
    mesi::run_batch(cnt == 32 ? kFull : (1u << cnt) - 1, r, access);
    cur += 32;
    r = next;
  }
""", """  const long r0 = row * n;
  int a_next = lane < n ? addr[r0 + lane] : mesi::kSentinel;
  for (long base = 0; base < n; base += 32) {
    const int a = a_next;
    a_next = base + 32 + lane < n ? addr[r0 + base + 32 + lane]
                                  : mesi::kSentinel;
    const long i = base + lane;
    const bool mine = i < n && a != mesi::kSentinel && (a & (m - 1)) == chain;
    Rec r = make_int4(0, 0, 0, 0);
    if (mine)
      r = make_int4(static_cast<int>(i), a,
                    (is_write[r0 + i] != 0) | (core[r0 + i] << 1),
                    tier[r0 + i]);
    mesi::run_batch(__ballot_sync(kFull, mine), r, access);
  }
"""),
    ("mesi.cu", """  err = mesi::launch_bucket(addr, is_write, core, tier, b, n, bits, tile,
                            hist, start, rec, s);
  if (err != cudaSuccess) return err;
""", ""),
    ("mesi.cu", """      t0, reinterpret_cast<const Rec*>(rec), start,""",
     """      addr, is_write, core, tier, t0, reinterpret_cast<const Rec*>(rec),
      start,"""),
]
SCAN_K3 = [
    ("mesi_dyn.cu", "  const int *sc, *ptl, *start;",
     "  const int *addr, *is_write, *core, *tier, *sc, *ptl, *start;"),
    ("mesi_dyn.cu", "  DynArgs args{sc, ptl, start,",
     "  DynArgs args{addr, is_write, core, tier, sc, ptl, start,"),
    ("mesi_dyn.cu", """  err = mesi::launch_bucket(addr, is_write, core, tier, b,
                            static_cast<long>(e) * slot_len, pl.bits, tile,
                            hist, start, rec, s);
  if (err != cudaSuccess) return err;
""", ""),
    ("mesi_dyn.cu", """  if (active) {
    cur = p.start[row * (m + 1) + chain];
    hi = p.start[row * (m + 1) + chain + 1];
    r = mesi::load_rec(rr, cur, hi, lane);
  }
""", ""),
    ("mesi_dyn.cu", """      // the chain's records of this slot; the next batch (of this slot or
      // the next) loads while this one runs
      while (true) {
        const unsigned in_slot = __ballot_sync(kFull, r.x < slot_hi);
        const int cnt = __popc(in_slot);
        const Rec next = mesi::load_rec(rr, cur + cnt, hi, lane);
        mesi::run_batch(in_slot, r, access);
        cur += cnt;
        r = next;
        if (cnt < 32) break;
      }
""", """      const long slot_lo = slot_hi - p.slot_len, r0 = row * n;
      int a_next = p.addr[r0 + (slot_lo + lane < slot_hi ? slot_lo + lane
                                                         : slot_lo)];
      for (long base = slot_lo; base < slot_hi; base += 32) {
        const int a = a_next;
        if (base + 32 + lane < slot_hi) a_next = p.addr[r0 + base + 32 + lane];
        const long i = base + lane;
        const bool mine =
            i < slot_hi && a != kSentinel && (a & (m - 1)) == chain;
        Rec rs = make_int4(0, 0, 0, 0);
        if (mine)
          rs = make_int4(static_cast<int>(i), a,
                         (p.is_write[r0 + i] != 0) | (p.core[r0 + i] << 1),
                         p.tier[r0 + i]);
        mesi::run_batch(__ballot_sync(kFull, mine), rs, access);
      }
"""),
]
# one chain per row: the entries take 2**0 chains whatever they are given
ONE_CHAIN = [
    ("mesi.cu", """  if (b == 0 || n == 0) return cudaSuccess;
  const Geometry g{""", """  if (b == 0 || n == 0) return cudaSuccess;
  bits = 0;
  const Geometry g{"""),
    ("mesi_dyn.cu", """  if (b == 0 || e == 0) return cudaSuccess;
  const Geometry g{""", """  if (b == 0 || e == 0) return cudaSuccess;
  bits = 0;
  const Geometry g{"""),
]


def warps(k: int):
    return [("mesi_chain.cuh", "constexpr int kChainWarps = 4;",
             f"constexpr int kChainWarps = {k};")]


# (name, what it tests, [(file, text in the committed source, replacement)])
VARIANTS = [
    ("committed", "the chains as committed: bucket pre-pass, 4 warps per "
     "block", []),
    ("scan", "each chain scans its row's addresses by ballot, no pre-pass",
     SCAN_K1 + SCAN_K3),
    ("row", "one warp per row reading its trace (scan, one chain)",
     SCAN_K1 + SCAN_K3 + ONE_CHAIN),
    ("warps1", "1 chain warp per block", warps(1)),
    ("warps2", "2 chain warps per block", warps(2)),
]


def sources():
    """{variant: {file: source text}}; stops if an edit no longer applies."""
    base = {f: (CSRC / f).read_text() for f in FILES}
    out = {}
    for name, _, edits in VARIANTS:
        texts = dict(base)
        for f, old, new in edits:
            if texts[f].count(old) != 1:
                sys.exit(f"mesi_variants: an edit of {name!r} no longer "
                         f"applies to {f}")
            texts[f] = texts[f].replace(old, new)
        out[name] = texts
    return out


def build(texts):
    """Compile every variant's two libraries at once; {name: {library:
    loaded CDLL}}."""
    from repro_torch.kernels import build as kbuild
    procs = {}
    for name, files in texts.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for f, text in files.items():
            (d / f).write_text(text)
        for lib in ("mesi", "mesi_dyn"):
            procs[name, lib] = subprocess.Popen(
                [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o",
                 str(d / f"lib{lib}.so"), str(d / f"{lib}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (name, lib), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"mesi_variants: nvcc failed on {name}'s {lib}.cu:\n"
                     f"{log}")
        libs.setdefault(name, {})[lib] = ctypes.CDLL(
            str(OUT / name / f"lib{lib}.so"))
    return libs


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def event_ms(fn):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop), out


def launches(dev):
    """name -> (launch() -> flat list of output tensors), through the
    wrappers and whichever libraries ``build.load`` returns."""
    import chip_smoke
    import torch
    from repro_torch.core import cache as cache_mod
    from repro_torch.core import engine, tiering_dyn
    from repro_torch.core.simulator import CXLRAMSim, SimConfig
    from repro_torch.kernels import cache_sim

    table1 = cache_mod.CacheParams()
    batch, _ = engine.build_sweep_batch(
        engine.SweepSpec(footprint_factors=(2, 4, 6, 8)), table1, device=dev)
    trace = [x.contiguous() for x in (batch.addr, batch.is_write,
                                      batch.core, batch.tier)]
    carry = cache_mod.init_batch_carry(table1, trace[0].shape[0], device=dev)
    out = {"K1 suite": lambda: list(cache_sim._launch(carry, *trace,
                                                      table1))}
    sim = CXLRAMSim(SimConfig())
    for name in chip_smoke.dynamic_sweeps():
        plan = chip_smoke.sweep_launch(sim, name, dev)
        a3, w3, c3, t3, pmap0, scalars, k_max, bound = \
            tiering_dyn.prep_dynamic_inputs(*plan.trace, **plan.kwargs)
        c0 = tiering_dyn.init_dyn_carry(plan.params, pmap0)
        sc = torch.stack([x.to(torch.int32) for x in scalars[:8]
                          + scalars[9:]] + [c0[3], c0[8]], dim=1).contiguous()

        def dyn(c0=c0, args=(a3, w3, c3, t3, sc, scalars[8]),
                params=plan.params, k_max=k_max, bound=bound):
            carry, slots, snaps, meas = cache_sim._launch_dyn(
                c0, *args, params=params, k_max=k_max, count_bound=bound)
            return list(carry) + [slots, snaps, meas]
        out[f"K3 sweep {name}"] = dyn
    return out


def main() -> int:
    import torch
    from repro_torch.kernels import build as kbuild
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("mesi_variants: no CUDA device is available")
    dev = torch.device("cuda")
    card = card_line()
    print(card)
    libs = build(sources())
    names = [name for name, _, _ in VARIANTS]

    def run(variant, launch):
        real = kbuild.load
        kbuild.load = lambda lib: libs[variant][lib]
        try:
            return event_ms(launch)
        finally:
            kbuild.load = real

    results = {}
    for name, launch in launches(dev).items():
        want = None
        times = {v: [] for v in names}
        for v in names:                         # warm-up and check
            _, got = run(v, launch)
            if want is None:
                want = got
            elif not all(torch.equal(a, b) for a, b in zip(got, want)):
                sys.exit(f"mesi_variants: {name} {v} differs from the "
                         f"committed kernel")
        for r in range(args.rounds):
            for v in (names if r % 2 == 0 else names[::-1]):
                times[v].append(run(v, launch)[0])
        mean = {v: sum(t) / len(t) for v, t in times.items()}
        for v in names:
            print(f"[{name}] {v:9s} {mean[v]:10.3f} ms (rounds "
                  f"{', '.join(f'{t:.3f}' for t in times[v])}); "
                  f"{mean['row'] / mean[v]:.1f}x row; outputs equal to "
                  f"the committed kernel's ({card})")
        results[name] = dict(mean_ms=mean, rounds_ms=times)
    print(json.dumps({"card": card, "variants": {
        name: what for name, what, _ in VARIANTS}, "times": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
