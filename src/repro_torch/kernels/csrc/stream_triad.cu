// STREAM triad, a = b + s * c, over two equal-shape arrays.
//
// Replaces the Pallas TPU kernel `stream_triad` of
// src/repro/kernels/stream_triad.py (grid body `_triad_kernel`).  The plain
// version it is held against, bit for bit, is
// repro_torch.kernels.stream_triad.stream_triad_ref: `b + c * s` in eager
// PyTorch with `s` rounded to the arrays' type first, as the JAX op's
// `jnp.asarray([s], b.dtype)` does.
//
// Rounding: eager PyTorch rounds twice, once after the product and once
// after the sum (for bf16 each result is rounded to bf16, computed in
// f32).  This kernel does the same with __fmul_rn / __fadd_rn, which the
// compiler never contracts into one fused multiply-add, so the card's
// result equals the plain version's bitwise.  (XLA's CPU backend does
// contract the Pallas body to an FMA in f32: the JAX op's interpret mode
// and its jnp oracle differ by an ulp there; see the CPU tests.)
//
// What bounds it: bytes.  b and c are read once and a written once,
// 3 * n * sizeof(T), over 3.35 TB/s; the 2 flops per element are
// negligible.  At (32768, 4096) f32 that is 1.61 GB, 0.481 ms.
//
// What the design does about it: 16-byte vector loads and stores (four
// f32 or eight bf16 per thread), neighbouring threads on neighbouring
// addresses, and a grid sized to the work: one vector per thread and no
// grid-stride loop, as PyTorch's vectorised elementwise launch does; a
// scalar tail for the last n mod (16 / sizeof(T)) elements, and a scalar
// path for arrays that are not 16-byte aligned.  The first port's
// grid-stride loop over 8 blocks per SM took 4.8-7.8% longer than
// torch.add; the sized grid reads level with it.  More loads in flight
// per thread, streaming cache hints, 128-thread blocks and TMA bulk loads
// moved it no further, and the sized-grid variants tie, so this is the
// simplest of them (tools/k7_variants.py times them all; PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float triad(float b, float c, float s) {
  return __fadd_rn(b, __fmul_rn(c, s));
}

__device__ __forceinline__ __nv_bfloat16 triad(__nv_bfloat16 b,
                                               __nv_bfloat16 c, float s) {
  const __nv_bfloat16 p =
      __float2bfloat16_rn(__fmul_rn(__bfloat162float(c), s));
  return __float2bfloat16_rn(
      __fadd_rn(__bfloat162float(b), __bfloat162float(p)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    triad_kernel(const T* __restrict__ b, const T* __restrict__ c,
                 T* __restrict__ a, float s, long long n, int vectorised) {
  constexpr int kVec = 16 / sizeof(T);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x;
  const long long n_vec = vectorised ? n / kVec : 0;
  if (first < n_vec) {
    const uint4 bx = reinterpret_cast<const uint4*>(b)[first];
    const uint4 cx = reinterpret_cast<const uint4*>(c)[first];
    uint4 ax;
    const T* bp = reinterpret_cast<const T*>(&bx);
    const T* cp = reinterpret_cast<const T*>(&cx);
    T* ap = reinterpret_cast<T*>(&ax);
#pragma unroll
    for (int j = 0; j < kVec; ++j) ap[j] = triad(bp[j], cp[j], s);
    reinterpret_cast<uint4*>(a)[first] = ax;
  }
  for (long long i = n_vec * kVec + first; i < n; i += stride)
    a[i] = triad(b[i], c[i], s);
}

template <typename T>
int launch(const void* b, const void* c, void* a, float s, long long n,
           cudaStream_t stream) {
  const bool vectorised =
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
        reinterpret_cast<uintptr_t>(c)) & 15) == 0;
  // a thread a vector (a scalar when misaligned); the scalar loop covers
  // the tail from the first threads on
  const long long per_thread = vectorised ? 16 / sizeof(T) : 1;
  const long long work = (n + per_thread - 1) / per_thread;
  const long long blocks = (work + kThreads - 1) / kThreads;
  triad_kernel<T><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<T*>(a),
      s, n, vectorised ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  `s` is already rounded to the
// arrays' type.  Returns a cudaError_t (0 = ok).
extern "C" int stream_triad(const void* b, const void* c, void* a, float s,
                            long long n, int dtype, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n < 0 || dtype < 0 || dtype > 1) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(b, c, a, s, n, st);
  return launch<__nv_bfloat16>(b, c, a, s, n, st);
}

extern "C" const char* stream_triad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
