// Decode attention over a paged KV pool (one new query token per sequence).
//
// Replaces the Pallas TPU kernel `paged_attention` of
// src/repro/kernels/paged_attention.py (grid body `_paged_kernel`).  It
// computes what the JAX oracle `repro.kernels.ref.paged_attention`
// computes, and the plain version it is held against is
// repro_torch.kernels.paged_attention.paged_attention_ref:
//
//   out[b, h] = sum_p softmax_p(scale * <q[b, h], K[b, p, h / G]>) V[b, p, h / G]
//
// over the positions p < context_lens[b], where position p of sequence b
// lives at row (p mod page) of page block_table[b, p / page].  GQA: the
// G = H / K query heads of kv head k are h = k * G .. k * G + G - 1.  The
// logits are scaled after the dot product (as the oracle, not the Pallas
// body, does it), the softmax is online in f32, and an empty context gives
// 0.  Block-table entries past ceil(ctx / page) are never read.
//
// What bounds it: bytes.  Each live position's K and V rows of one kv head
// (2 * D elements) are read once, q once, out written once; the work is
// 4 * H * D flops per position, about 1 flop per byte in f32, far below
// the card's ~20 f32 flops per byte of memory bandwidth.  The least time is
//   bytes = B*H*D*sizeof(q) + sum_b ctx_b * K * 2 * D * sizeof(kv)
//           + (live table entries + B) * 4 + B*H*D*sizeof(out)
//   bound = bytes / 3.35 TB/s.
//
// What the design does about it (a simple first kernel, not yet a fast one):
//   * one block of 256 threads per (kv head, sequence): grid K x B.  The G
//     query heads of the kv head sit in shared memory, so each K/V row is
//     read from device memory once for all G heads;
//   * the context is walked in tiles of 32 consecutive positions, which may
//     span pages: each position's row pointer comes from the block table,
//     and the tile's K and V rows are loaded by coalesced row reads (a row
//     is D contiguous elements), all of the tile's loads issued into
//     registers before any is stored (the first version staged the row
//     offsets in shared memory, so each load waited for the store before
//     it: 10 us per tile), then into shared memory, rows padded to an odd
//     stride so the per-position dot products are free of bank conflicts;
//   * warp g computes the 32 logits of query head g (lane = position),
//     its max and sum by shuffles, and updates (m, l); every thread then
//     rescales the accumulator elements it owns, kept in registers;
//   * B x K blocks (64 at the serve shapes) fill under half of the 132 SMs,
//     and each block waits on its tile loads: split-K over the context,
//     cp.async/TMA double buffering and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;        // positions per tile (one per lane)
constexpr int kMaxDim = 256;     // head_dim limit
constexpr int kMaxGroups = 16;   // query heads per kv head limit
constexpr int kAccPerThread = kMaxGroups * kMaxDim / kThreads;
constexpr int kRowsPerWarp = kTile / kWarps;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Shape {
  int b, h, d, page, kv_heads, nblk, groups;
  float scale;
};

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
    const TKV* __restrict__ v_pages, const int* __restrict__ block_table,
    const int* __restrict__ context_lens, TQ* __restrict__ out, Shape s) {
  extern __shared__ float smem[];
  const int kh = blockIdx.x;
  const int seq = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int d = s.d;
  const int g_n = s.groups;
  const int ds = d | 1;                       // odd row stride in smem

  float* q_s = smem;                          // [G][D]
  float* k_s = q_s + g_n * d;                 // [kTile][ds]
  float* v_s = k_s + kTile * ds;              // [kTile][ds]
  float* p_s = v_s + kTile * ds;              // [G][kTile]
  float* m_s = p_s + g_n * kTile;             // [G]
  float* l_s = m_s + g_n;                     // [G]
  float* alpha_s = l_s + g_n;                 // [G]

  const int h0 = kh * g_n;
  const TQ* qb = q + (static_cast<long long>(seq) * s.h + h0) * d;
  for (int i = tid; i < g_n * d; i += kThreads) q_s[i] = to_f32(qb[i]);
  for (int g = tid; g < g_n; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.0f;
  }

  float acc[kAccPerThread];
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) acc[i] = 0.0f;

  const int capacity = s.nblk * s.page;
  const int ctx = min(max(context_lens[seq], 0), capacity);
  const int* bt = block_table + static_cast<long long>(seq) * s.nblk;
  __syncthreads();

  for (int base = 0; base < ctx; base += kTile) {
    const int n_t = min(kTile, ctx - base);
    // the tile's K and V rows: warp w loads rows w, w + 8, w + 16, w + 24,
    // lane l elements l, l + 32, ...; every load of the tile is issued
    // into registers before the first store to shared memory, so they are
    // in flight together.  Only live block-table entries are read.
    float kr[kRowsPerWarp][kMaxDim / 32], vr[kRowsPerWarp][kMaxDim / 32];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int t = warp + rr * kWarps;
      if (t < n_t) {
        const int pos = base + t;
        const long long row =
            ((static_cast<long long>(bt[pos / s.page]) * s.page +
              pos % s.page) * s.kv_heads + kh) * d;
#pragma unroll
        for (int j = 0; j < kMaxDim / 32; ++j) {
          const int e = lane + 32 * j;
          if (e < d) {
            kr[rr][j] = to_f32(k_pages[row + e]);
            vr[rr][j] = to_f32(v_pages[row + e]);
          }
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int t = warp + rr * kWarps;
      if (t < n_t) {
#pragma unroll
        for (int j = 0; j < kMaxDim / 32; ++j) {
          const int e = lane + 32 * j;
          if (e < d) {
            k_s[t * ds + e] = kr[rr][j];
            v_s[t * ds + e] = vr[rr][j];
          }
        }
      }
    }
    __syncthreads();
    // logits, online softmax: warp g owns query head g, lane t position t
    for (int g = warp; g < g_n; g += kWarps) {
      float sc = -INFINITY;
      if (lane < n_t) {
        const float* qg = q_s + g * d;
        const float* kt = k_s + lane * ds;
        float dot = 0.0f;
        for (int e = 0; e < d; ++e) dot = fmaf(qg[e], kt[e], dot);
        sc = dot * s.scale;
      }
      float mx = sc;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);   // finite: n_t >= 1
      const float p = lane < n_t ? expf(sc - m_new) : 0.0f;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      p_s[g * kTile + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);  // 0 on the first tile
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // acc[g][e] = acc[g][e] * alpha[g] + sum_t p[g][t] * v[t][e]
#pragma unroll
    for (int i = 0; i < kAccPerThread; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < g_n * d) {
        const int g = idx / d, e = idx - g * d;
        const float* pg = p_s + g * kTile;
        float upd = 0.0f;
        for (int t = 0; t < n_t; ++t) upd = fmaf(pg[t], v_s[t * ds + e], upd);
        acc[i] = acc[i] * alpha_s[g] + upd;
      }
    }
    __syncthreads();
  }

  TQ* ob = out + (static_cast<long long>(seq) * s.h + h0) * d;
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) {
    const int idx = tid + i * kThreads;
    if (idx < g_n * d) {
      const float l = l_s[idx / d];
      ob[idx] = from_f32<TQ>(acc[i] / (l == 0.0f ? 1.0f : l));
    }
  }
}

size_t smem_bytes(int groups, int d) {
  return (static_cast<size_t>(groups) * d + 2 * kTile * (d | 1) +
          groups * kTile + 3 * groups) * sizeof(float);
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* block_table, const int* context_lens, void* out,
           const Shape& s, cudaStream_t stream) {
  const size_t smem = smem_bytes(s.groups, s.d);
  auto kern = paged_attention_kernel<TQ, TKV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<dim3(s.kv_heads, s.b), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pages),
      static_cast<const TKV*>(v_pages), block_table, context_lens,
      static_cast<TQ*>(out), s);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = ok);
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int paged_attention(const void* q, const void* k_pages,
                               const void* v_pages, const int* block_table,
                               const int* context_lens, void* out, int b,
                               int h, int d, int page, int kv_heads, int nblk,
                               float scale, int q_dtype, int kv_dtype,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (kv_heads <= 0 || h % kv_heads != 0 || d <= 0 || d > kMaxDim ||
      h / kv_heads > kMaxGroups || page <= 0 || nblk < 0 ||
      q_dtype < 0 || q_dtype > 1 || kv_dtype < 0 || kv_dtype > 1)
    return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  const Shape s{b, h, d, page, kv_heads, nblk, h / kv_heads, scale};
  auto st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float>(q, k_pages, v_pages, block_table,
                                context_lens, out, s, st);
  if (q_dtype == 0)
    return launch<float, __nv_bfloat16>(q, k_pages, v_pages, block_table,
                                        context_lens, out, s, st);
  if (kv_dtype == 0)
    return launch<__nv_bfloat16, float>(q, k_pages, v_pages, block_table,
                                        context_lens, out, s, st);
  return launch<__nv_bfloat16, __nv_bfloat16>(q, k_pages, v_pages,
                                              block_table, context_lens, out,
                                              s, st);
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
