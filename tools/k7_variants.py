#!/usr/bin/env python3
"""Time launch variants of K7 (the STREAM triad) on a CUDA card.

    python3 tools/k7_variants.py

Builds ``tools/k7_variants.cu`` (the variants: unrolled loads, streaming
cache hints, a grid sized to the work, each on or off; ``ld.global.nc``
loads; 128-thread blocks; TMA bulk loads) with the library's `nvcc` flags
into ``build/k7_variants/``, checks every variant bitwise against the plain
version ``stream_triad_ref`` at (32768, 4096) f32 on seeded inputs, s = 2.5,
and times each by CUDA events in three rounds, each round between two
``torch.add(b, c, alpha=2.5)`` calls, beside the library's kernel
(``stream_triad._launch``, "library").  Prints the card's name and power
limit, one line per variant and last a JSON object of the times.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "k7_variants"
sys.path.insert(0, str(ROOT / "src"))

#: the variants of k7_variants.cu, in the order of its kConfigs table
VARIANTS = ("base", "a", "b", "ab", "c", "ac", "bc", "abc", "d", "c/nc",
            "c/128")
SHAPE = (32768, 4096)
S = 2.5


def build() -> ctypes.CDLL:
    from repro_torch.kernels import build as kbuild
    OUT.mkdir(parents=True, exist_ok=True)
    lib_path = OUT / "lib.so"
    proc = subprocess.run(
        [kbuild._nvcc(), *kbuild.NVCC_FLAGS, f"-I{CSRC}", "-o",
         str(lib_path), str(ROOT / "tools" / "k7_variants.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        sys.exit(f"k7_variants: nvcc failed:\n{proc.stdout}")
    lib = ctypes.CDLL(str(lib_path))
    lib.k7_variant.argtypes = ([ctypes.c_void_p] * 3
                               + [ctypes.c_float, ctypes.c_longlong]
                               + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.k7_variant.restype = ctypes.c_int
    return lib


def cuda_ms(fn, warmup: int = 3, reps: int = 20) -> float:
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        sys.exit("k7_variants: no CUDA device is available")
    from repro_torch.kernels import stream_triad as st
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    lib = build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    b, c = (torch.randn(SHAPE, generator=gen, device=dev) for _ in range(2))
    out = torch.empty_like(b)
    stream = torch.cuda.current_stream().cuda_stream

    def variant(i):
        def run():
            rc = lib.k7_variant(b.data_ptr(), c.data_ptr(), out.data_ptr(),
                                S, b.numel(), 0, i, 0, stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
        return run

    runs = {name: variant(i) for i, name in enumerate(VARIANTS)}
    want = st.stream_triad_ref(b, c, S)
    for name, run in runs.items():
        out.zero_()
        run()
        if not torch.equal(out, want):
            sys.exit(f"k7_variants: variant {name} disagrees with the plain "
                     f"version")
    if not torch.equal(st._launch(b, c, S), want):
        sys.exit("k7_variants: the library's kernel disagrees")
    del want
    runs["library"] = lambda: st._launch(b, c, S)
    times = {name: [] for name in runs}
    add_ms = []
    for _ in range(3):
        add_ms.append(cuda_ms(lambda: torch.add(b, c, alpha=S)))
        for name, run in runs.items():
            times[name].append(cuda_ms(run))
        add_ms.append(cuda_ms(lambda: torch.add(b, c, alpha=S)))
    bound = st.bound_bytes(b) / 3.35e12 * 1e3
    add_mean = sum(add_ms) / len(add_ms)
    means = {name: sum(t) / len(t) for name, t in times.items()}
    for name, t in times.items():
        print(f"[k7] {name:8s}: " + ", ".join(f"{x:.4f}" for x in t)
              + f" ms, mean {means[name]:.4f} ({100 * bound / means[name]:.1f}"
              f"% of the bound, {100 * (means[name] / add_mean - 1):+.2f}% "
              f"against torch.add) ({card})")
    print(f"[k7] torch.add(b, c, alpha=2.5): " + ", ".join(
        f"{x:.4f}" for x in add_ms) + f" ms, mean {add_mean:.4f}; bound "
        f"{bound:.4f} ms ({st.bound_bytes(b)} B at 3.35 TB/s) ({card})")
    print(json.dumps({"card": card, "shape": list(SHAPE), "bound_ms": bound,
                      "torch_add_ms": add_ms, "variants": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
