// Launch variants of the STREAM triad kernel (K7), a = b + s * c, for a
// study of what moves its time; not part of the library.  The library's
// kernel is src/repro_torch/kernels/csrc/stream_triad.cu, variant (c) here.
// tools/k7_variants.py builds this file and times every variant beside the
// library's kernel and torch.add.
//
// Every variant keeps the library's arithmetic (__fmul_rn, then __fadd_rn,
// never contracted; `s` rounded to the arrays' type by the caller), so each
// equals the plain version bitwise.  Three choices, each on or off
// (kConfigs):
//   (a) unroll: each thread loads 4 vectors of b and 4 of c before any
//       arithmetic, then stores 4, so 128 bytes a thread are in flight;
//   (b) streaming: __ldcs / __stcs (evict-first), so the write stream does
//       not evict lines still to be read; "c/nc" tries the other hint,
//       ld.global.nc.L1::no_allocate, with (c);
//   (c) sized grid: one chunk per thread and no grid-stride loop, a block
//       per 256 x (1 or 4) vectors, as PyTorch's vectorised elementwise
//       launch does; off, a grid-stride loop over 8 blocks per SM ("base" is
//       the first port's launch); "c/128" is (c) with 128-thread blocks.
// Variant (d) reads b and c with 1-D TMA bulk copies instead of registers:
// each block (3 per SM, persistent) keeps a 4-stage ring of 8 KB chunks of
// b and c in shared memory, loaded by cp.async.bulk with an mbarrier per
// stage, so up to 3 x 4 x 16 KB per SM are in flight without a register
// each; a goes out by 16-byte stores from registers.  Arrays that are not
// 16-byte aligned take the scalar path of "base".

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

#include "hopper.cuh"

namespace {

constexpr int kBlocksPerSm = 8;

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

// cache policies of the vector loads and stores
enum Policy { kDefault = 0, kStreaming = 1, kNoAllocate = 2 };

template <int kPolicy>
__device__ __forceinline__ uint4 load(const uint4* p) {
  if (kPolicy == kStreaming) return __ldcs(p);
  uint4 v;
  if (kPolicy == kNoAllocate) {
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(p));
    return v;
  }
  return *p;
}

template <int kPolicy>
__device__ __forceinline__ void store(uint4* p, uint4 v) {
  if (kPolicy == kStreaming)
    __stcs(p, v);
  else
    *p = v;
}

template <typename T>
__device__ __forceinline__ uint4 triad_vec(uint4 bx, uint4 cx, float s) {
  constexpr int kVec = 16 / sizeof(T);
  uint4 ax;
  const T* bp = reinterpret_cast<const T*>(&bx);
  const T* cp = reinterpret_cast<const T*>(&cx);
  T* ap = reinterpret_cast<T*>(&ax);
#pragma unroll
  for (int j = 0; j < kVec; ++j) ap[j] = triad(bp[j], cp[j], s);
  return ax;
}

template <typename T, int kBlock, int kUnroll, int kPolicy, bool kSized>
__global__ void __launch_bounds__(kBlock)
    triad_kernel(const T* __restrict__ b, const T* __restrict__ c,
                 T* __restrict__ a, float s, long long n, int vectorised) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr long long kChunk = static_cast<long long>(kBlock) * kUnroll;
  const long long n_vec = vectorised ? n / kVec : 0;
  const uint4* bv = reinterpret_cast<const uint4*>(b);
  const uint4* cv = reinterpret_cast<const uint4*>(c);
  uint4* av = reinterpret_cast<uint4*>(a);
  // a block's chunk: kUnroll vectors a thread, kBlock apart
  for (long long c0 = blockIdx.x * kChunk; c0 < n_vec;
       c0 += static_cast<long long>(gridDim.x) * kChunk) {
    uint4 bx[kUnroll], cx[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = c0 + u * kBlock + threadIdx.x;
      if (i < n_vec) {
        bx[u] = load<kPolicy>(bv + i);
        cx[u] = load<kPolicy>(cv + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = c0 + u * kBlock + threadIdx.x;
      if (i < n_vec) store<kPolicy>(av + i, triad_vec<T>(bx[u], cx[u], s));
    }
    if (kSized) break;
  }
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  for (long long i = n_vec * kVec + blockIdx.x * kBlock + threadIdx.x;
       i < n; i += stride)
    a[i] = triad(b[i], c[i], s);
}

// ---- variant 8, (d): 1-D TMA bulk copies through a shared-memory ring ----
constexpr int kBulkThreads = 128;
constexpr int kBulkStages = 4;
constexpr uint32_t kChunkBytes = 8192;          // of b, and of c, a stage
constexpr int kBulkBlocksPerSm = 3;
constexpr uint32_t kBulkSmem = kBulkStages * 2 * kChunkBytes + 8 * kBulkStages;

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

template <typename T>
__global__ void __launch_bounds__(kBulkThreads)
    triad_bulk_kernel(const T* __restrict__ b, const T* __restrict__ c,
                      T* __restrict__ a, float s, long long n) {
  using namespace hopper;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + kBulkStages * 2 * kChunkBytes;
  const long long n_chunks = n * static_cast<long long>(sizeof(T)) /
                             kChunkBytes;
  // this block's chunks: blockIdx.x + i * gridDim.x, i < mine
  const long long mine =
      blockIdx.x < n_chunks ? (n_chunks - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  auto issue = [&](int st, long long i) {
    const long long at = (blockIdx.x + i * gridDim.x) * kChunkBytes;
    const uint32_t dst = base + st * 2 * kChunkBytes;
    mbar_expect_tx(bars + 8 * st, 2 * kChunkBytes);
    bulk_load(dst, reinterpret_cast<const uint8_t*>(b) + at, kChunkBytes,
              bars + 8 * st);
    bulk_load(dst + kChunkBytes, reinterpret_cast<const uint8_t*>(c) + at,
              kChunkBytes, bars + 8 * st);
  };
  if (threadIdx.x == 0) {
    for (int st = 0; st < kBulkStages; ++st) mbar_init(bars + 8 * st, 1);
    fence_barrier_init();
    for (int st = 0; st < kBulkStages && st < mine; ++st) issue(st, st);
  }
  __syncthreads();
  for (long long i = 0; i < mine; ++i) {
    const int st = static_cast<int>(i % kBulkStages);
    mbar_wait(bars + 8 * st, static_cast<uint32_t>(i / kBulkStages) & 1);
    uint4* bs = reinterpret_cast<uint4*>(smem + st * 2 * kChunkBytes);
    const uint4* cs = bs + kChunkBytes / 16;
    uint4* av = reinterpret_cast<uint4*>(
        reinterpret_cast<uint8_t*>(a) +
        (blockIdx.x + i * gridDim.x) * kChunkBytes);
#pragma unroll
    for (int v = threadIdx.x; v < kChunkBytes / 16; v += kBulkThreads)
      av[v] = triad_vec<T>(bs[v], cs[v], s);
    __syncthreads();  // the stage is read: refill it
    if (threadIdx.x == 0 && i + kBulkStages < mine)
      issue(st, i + kBulkStages);
  }
  // the elements past the last whole chunk
  const long long stride = static_cast<long long>(gridDim.x) * kBulkThreads;
  for (long long i = n_chunks * (kChunkBytes / sizeof(T)) +
                     blockIdx.x * kBulkThreads + threadIdx.x;
       i < n; i += stride)
    a[i] = triad(b[i], c[i], s);
}

// the register-path variants: threads a block, vectors a thread, cache
// policy, sized grid (else a grid-stride loop over 8 blocks per SM)
struct Config {
  int block, unroll, policy;
  bool sized;
};
constexpr Config kConfigs[] = {
    {256, 1, kDefault, false},   {256, 4, kDefault, false},    // base, a
    {256, 1, kStreaming, false}, {256, 4, kStreaming, false},  // b, ab
    {256, 1, kDefault, true},    {256, 4, kDefault, true},     // c, ac
    {256, 1, kStreaming, true},  {256, 4, kStreaming, true},   // bc, abc
    {0, 0, 0, false},                                          // d (bulk)
    {256, 1, kNoAllocate, true},                               // c/nc
    {128, 1, kDefault, true},                                  // c/128
};
constexpr int kVariants = sizeof(kConfigs) / sizeof(kConfigs[0]);
constexpr int kBulkVariant = 8;

template <typename T, int kV>
void launch_variant(const T* b, const T* c, T* a, float s, long long n,
                    bool vectorised, int sms, cudaStream_t stream) {
  constexpr Config k = kConfigs[kV];
  if constexpr (k.block > 0) {
    const long long per_block = static_cast<long long>(k.block) * k.unroll *
                                (vectorised ? 16 / sizeof(T) : 1);
    const long long want = (n + per_block - 1) / per_block;
    const long long cap =
        k.sized ? 0x7fffffffLL : static_cast<long long>(sms) * kBlocksPerSm;
    triad_kernel<T, k.block, k.unroll, k.policy, k.sized>
        <<<static_cast<int>(want < cap ? want : cap), k.block, 0, stream>>>(
            b, c, a, s, n, vectorised ? 1 : 0);
  }
}

template <typename T, int... kV>
void launch_any(int variant, const T* b, const T* c, T* a, float s,
                long long n, bool vectorised, int sms, cudaStream_t stream,
                std::integer_sequence<int, kV...>) {
  using Launch = void (*)(const T*, const T*, T*, float, long long, bool, int,
                          cudaStream_t);
  static const Launch kLaunch[] = {launch_variant<T, kV>...};
  kLaunch[variant](b, c, a, s, n, vectorised, sms, stream);
}

template <typename T>
int launch(const void* b_, const void* c_, void* a_, float s, long long n,
           int variant, int device, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const T* b = static_cast<const T*>(b_);
  const T* c = static_cast<const T*>(c_);
  T* a = static_cast<T*>(a_);
  const bool vectorised =
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
        reinterpret_cast<uintptr_t>(c)) & 15) == 0;
  // the scalar path of a misaligned array always takes the first port's
  // grid-stride launch
  if (!vectorised) variant = 0;
  if (variant == kBulkVariant) {
    err = cudaFuncSetAttribute(triad_bulk_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kBulkSmem));
    if (err != cudaSuccess) return err;
    triad_bulk_kernel<T><<<sms * kBulkBlocksPerSm, kBulkThreads, kBulkSmem,
                           stream>>>(b, c, a, s, n);
    return cudaGetLastError();
  }
  launch_any<T>(variant, b, c, a, s, n, vectorised, sms, stream,
                std::make_integer_sequence<int, kVariants>{});
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  `s` is already rounded to the
// arrays' type.  `variant` indexes kConfigs (8: TMA bulk copies).  Returns
// a cudaError_t (0 = ok).
extern "C" int k7_variant(const void* b, const void* c, void* a, float s,
                          long long n, int dtype, int variant, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n < 0 || dtype < 0 || dtype > 1 || variant < 0 ||
      variant >= kVariants)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(b, c, a, s, n, variant, device, st);
  return launch<__nv_bfloat16>(b, c, a, s, n, variant, device, st);
}
