#!/usr/bin/env python3
"""Time design variants of K5's tensor-core kernel on a CUDA card.

    python3 tools/k5_variants.py

Each variant is ``src/repro_torch/kernels/csrc/flash_attention.cu`` with one
named edit (an exact text replacement: the script stops if the source no
longer holds the text), built with the library's `nvcc` flags into
``build/k5_variants/`` (all at once), held against the plain version
``flash_attention_ref`` (rtol = atol = 5e-3 and RMS(err) <= 1e-3 RMS(ref),
chip_smoke.py's main-path limits; a variant may miss them, which is what
"single_bf16_p" shows) and timed by CUDA events at h2o-danube-3-4b's
prefill shapes on seeded bf16 inputs, (1, 32, 4096, 120) and (1, 32, 8192,
120), causal, window 4096, in two rounds.  Some variants compute a wrong
result on purpose ("no_pv"): they only say where the time goes.  Prints the
card's name and power limit, one line per variant and shape, and last a
JSON object of the times.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "k5_variants"
sys.path.insert(0, str(ROOT / "src"))

# (name, what it tests, [(text in the committed source, its replacement)])
VARIANTS = [
    ("committed", "the kernel as committed", []),
    ("exp2f", "exp2f instead of ex2.approx in the softmax",
     [("x = hopper::exp2_approx(fmaf(x, s.scale_log2, -mb));",
       "x = exp2f(fmaf(x, s.scale_log2, -mb));")]),
    ("single_bf16_p", "one bf16 P V product (no p_lo): the split's cost, "
     "and its precision",
     [("""    wgmma_m64n128k16_rs_tb(o, p_lo[4 * kk], p_lo[4 * kk + 1],
                           p_lo[4 * kk + 2], p_lo[4 * kk + 3], vd);\n""",
       "")]),
    ("no_pv", "no P V product at all (wrong output: attribution only)",
     [("""    wgmma_m64n128k16_rs_tb(o, p_hi[4 * kk], p_hi[4 * kk + 1],
                           p_hi[4 * kk + 2], p_hi[4 * kk + 3], vd);
    wgmma_m64n128k16_rs_tb(o, p_lo[4 * kk], p_lo[4 * kk + 1],
                           p_lo[4 * kk + 2], p_lo[4 * kk + 3], vd);\n""",
       "")]),
    ("stages3", "a 3-stage K / V ring (224 KB of shared memory)",
     [("constexpr int kStages = 2;", "constexpr int kStages = 3;")]),
    ("trunc_split", "p_hi = p truncated to bf16 (one PRMT), p_lo rounded",
     [("""    const __nv_bfloat162 hi = __floats2bfloat162_rn(sc[2 * n], sc[2 * n + 1]);
    const float2 hf = __bfloat1622float2(hi);
    p_hi[n] = *reinterpret_cast<const uint32_t*>(&hi);
    p_lo[n] = pack_bf16(sc[2 * n] - hf.x, sc[2 * n + 1] - hf.y);""",
       """    const uint32_t b0 = __float_as_uint(sc[2 * n]);
    const uint32_t b1 = __float_as_uint(sc[2 * n + 1]);
    p_hi[n] = __byte_perm(b0, b1, 0x7632);
    p_lo[n] = pack_bf16(sc[2 * n] - __uint_as_float(b0 & 0xffff0000u),
                        sc[2 * n + 1] - __uint_as_float(b1 & 0xffff0000u));""")]),
    ("scale_d_zero", "S not zeroed in registers: the first Q K^T step "
     "ignores the old accumulator (wgmma's scale-d off)",
     [("""#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = 0.0f;
""", ""),
      ("desc_sw128(k_s + col, 16, 1024), 1);",
       "desc_sw128(k_s + col, 16, 1024), kk > 0);")]),
    ("skip_rescale", "O rescaled only where a row's max moved (a warp "
     "vote)",
     [("    rescale(o, alpha);\n",
       """    if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f))
      rescale(o, alpha);\n""")]),
    ("tree_max", "each row's max over the thread's 32 logits as a tree, "
     "not a chain",
     [("""    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * h], sc[4 * i + 2 * h + 1]));""",
       """    float t[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      t[i] = fmaxf(sc[4 * i + 2 * h], sc[4 * i + 2 * h + 1]);
#pragma unroll
    for (int w = 8; w > 0; w >>= 1)
#pragma unroll
      for (int i = 0; i < w; ++i) t[i] = fmaxf(t[i], t[i + w]);
    float mx = t[0];""")]),
    ("tree_sum", "each row's sum of p over four partial sums, not one chain",
     [("""    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * i + 2 * h + e];
        x = hopper::exp2_approx(fmaf(x, s.scale_log2, -mb));
        sum += x;
      }""",
       """    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * i + 2 * h + e];
        x = hopper::exp2_approx(fmaf(x, s.scale_log2, -mb));
        part[i % 4] += x;
      }
    const float sum = (part[0] + part[1]) + (part[2] + part[3]);""")]),
]


def sources():
    """{variant: source text}; stops if an edit no longer applies."""
    base = (CSRC / "flash_attention.cu").read_text()
    out = {}
    for name, _, edits in VARIANTS:
        text = base
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"k5_variants: the edit of {name!r} no longer "
                         f"applies to flash_attention.cu")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(texts):
    """Compile every variant at once; {name: loaded library}."""
    from repro_torch.kernels import build as kbuild
    procs = {}
    for name, text in texts.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "flash_attention.cu").write_text(text)
        (d / "hopper.cuh").write_text((CSRC / "hopper.cuh").read_text())
        procs[name] = subprocess.Popen(
            [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "flash_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"k5_variants: nvcc failed on {name}:\n{log}")
        spill = [ln.strip() for ln in log.splitlines()
                 if "spill" in ln][0]
        print(f"[build] {name}: {spill}")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        lib.flash_attention_tc.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float]
            + [ctypes.c_int, ctypes.c_void_p])
        libs[name] = lib
    return libs


def cuda_ms(fn, warmup: int = 2, reps: int = 10) -> float:
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
        sys.exit("k5_variants: no CUDA device is available")
    from repro_torch.kernels import flash_attention as fa
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    libs = build(sources())
    dev = torch.device("cuda")
    window = 4096
    times = {}
    for seq in (4096, 8192):
        gen = torch.Generator(device=dev).manual_seed(2)
        q, k, v = (torch.randn((1, 32, seq, 120), generator=gen, device=dev,
                               dtype=torch.bfloat16) for _ in range(3))
        ref = torch.cat([fa.flash_attention_ref(
            q[:, i:i + 8], k[:, i:i + 8], v[:, i:i + 8], causal=True,
            window=window) for i in range(0, 32, 8)], dim=1).float()
        ref_rms = float(ref.square().mean().sqrt())
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream

        def run(lib):
            rc = lib.flash_attention_tc(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                32, seq, seq, 120, 1, 1, window, 120 ** -0.5, 0, stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
        for name, lib in libs.items():
            run(lib)
            torch.cuda.synchronize()
            diff = (out.float() - ref).abs()
            ok = (bool((diff <= 5e-3 * (1 + ref.abs())).all())
                  and float(diff.square().mean().sqrt()) <= 1e-3 * ref_rms)
            times.setdefault(name, {})[seq] = dict(
                max_err=float(diff.max()),
                rel_rms=float(diff.square().mean().sqrt()) / ref_rms,
                within_limits=ok, ms=[])
        del ref
        for _ in range(2):
            for name, lib in libs.items():
                times[name][seq]["ms"].append(cuda_ms(lambda: run(lib)))
        for name, _, _ in VARIANTS:
            t = times[name][seq]
            print(f"[k5] {name:14s} S={seq}: "
                  + ", ".join(f"{x:.4f}" for x in t["ms"])
                  + f" ms; max|err| {t['max_err']:.3g}, RMS(err) / RMS(ref)"
                  f" {t['rel_rms']:.3g}, within the main-path limits: "
                  f"{t['within_limits']} ({card})")
    print(json.dumps({"card": card, "variants": {
        name: {"what": what, **{str(s): t for s, t in times[name].items()}}
        for name, what, _ in VARIANTS}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
