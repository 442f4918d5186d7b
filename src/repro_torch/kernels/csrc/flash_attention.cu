// Blockwise causal / windowed attention with an online softmax, in two
// variants: a tensor-core kernel for bf16 (wgmma, TMA, a shared-memory ring)
// and a CUDA-core kernel for f32 and for bf16 head widths that are no
// multiple of 8.
//
// Replaces the Pallas TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention.py (grid body `_flash_kernel`).  Both
// variants compute what the JAX oracle `repro.kernels.ref.flash_attention`
// computes, and the plain version they are held against is
// repro_torch.kernels.flash_attention.flash_attention_ref:
//
//   out[bh, r] = sum_j softmax_j(scale * <q[bh, r], k[bh, j]>) v[bh, j]
//
// over the keys j live for row r.  Positions are end-aligned: row r sits at
// qpos = r + Sk - Sq.  Causal: j <= qpos; with a window W also j > qpos - W.
// A row with no live key gives 0.  The logits are scaled after the product
// (as the oracle, not the Pallas body, does it); heads are pre-broadcast by
// the caller (GQA), so q, k and v have the same B * H heads, except in the
// tensor-core variant's second form (below).  Key tiles that
// lie wholly outside a query tile's causal / window band are skipped by the
// loop bounds, so the work is O(S * W), not O(S^2); inside a tile -inf masks
// a pair, and a row whose running max is still -inf contributes nothing, so
// no exp(-inf - -inf) arises.
//
// What bounds it: at long sequences, operations.  Each live (row, key) pair
// costs 2 * (D + Dv) flops (the logit and the value sum); each input is
// read once and the output written once.  At h2o-danube-3-4b's prefill
// width (1, 32, 4096, 120) bf16, causal, 1.29e11 flops take 0.130 ms at the
// card's 989 TFLOP/s (bf16 tensor cores), while its 126 MB take 0.038 ms
// at 3.35 TB/s; at MiMo-V2-Flash's full layer (64 heads, 4096, 192 / 128)
// 3.44e11 flops take 0.348 ms.  A window of 128 leaves 2 key tiles a query
// tile: its layer (0.0563 ms for its 189 MB) is bound by bytes.
//
// The tensor-core variant (bf16, D % 8 == 0, D <= 128), in the shape of
// FlashAttention-3:
//   * one block per (head, 128-row query tile), the heaviest tiles launched
//     first (blockIdx.y counts query tiles from the last), 384 threads: two
//     consumer warpgroups own 64 query rows each, and one thread of the
//     third (producer) warpgroup issues the TMA loads; setmaxnreg moves
//     registers from the producer (40) to the consumers (232);
//   * TMA reads q, k and v through 3-D tensor maps over (D, S, B * H), so a
//     tile never reads the next head's rows and rows past S arrive as 0, in
//     boxes of 64 columns with the 128-byte swizzle that wgmma reads; D is
//     padded to 128 by the boxes' zero fill (D = 120: columns 120-127);
//   * K and V tiles of 128 keys sit in a 2-stage ring with full and empty
//     mbarriers, K and V released apart, so the next tiles load while this
//     one is computed (Q 32 KB + 2 x (K 32 KB + V 32 KB) = 160 KB of shared
//     memory);
//   * S = Q K^T by wgmma m64n128k16, A = Q and B = K both K-major in shared
//     memory, f32 accumulators in registers; ceil(D / 16) steps;
//   * the online softmax in registers: each row's 128 logits lie on the 4
//     lanes of a quad, so its max is two shuffles and its sum is reduced
//     once at the end; ex2.approx with log2(e) folded into the scale, which
//     is applied to the f32 logits after the product; only tiles that
//     straddle the band edge (or the end of the keys) are masked;
//   * O += P V by wgmma with A = P from registers (the S accumulator's
//     layout is the A fragment's) and B = V read MN-major through the
//     transpose bit.  P is kept to about 16 bits as two bf16 parts, p_hi =
//     bf16(p) and p_lo = bf16(p - p_hi), two products into one f32
//     accumulator: the plain version keeps p in f32, and a single bf16 p
//     misses its limits (1.5x the flops of P V, still on the tensor cores);
//   * tile j's Q K^T is issued together with tile j - 1's P V, so the
//     softmax of tile j runs while the tensor cores work on P V.
// What still bounds it (PERF.md): the CUDA-core work between the products
// (softmax, the split of p, the rescale), with two consumer warps on each
// SM quarter to hide its latency.  Later work: the output through a TMA
// store, a persistent scheduler.
//
// The tensor-core variant's second form (template kOwnV = true, entry
// flash_attention_tc_own_v), for MiMo-V2-Flash's prefill: q and k rows up
// to 192 wide (three boxes of Q and K, up to 12 steps of Q K^T), v rows up
// to 128 in a map of their own (the output is Dv wide), query head h of a
// sequence reading KV plane h / group through the maps (no broadcast copy),
// and an optional f32 sink logit per query head, which takes softmax mass
// in the final normalisation and adds no value:
//   out[bh, r] = sum_j e^(x_j) v_j / (sum_j e^(x_j) + e^(sink)).
// The sink is kept in the running sum's units (log2, relative to the
// running max times scale * log2(e)).  Q 48 KB + 2 x (K 48 KB + V 32 KB) =
// 208 KB of shared memory; the same accumulators, pipeline and window
// bounds as the first form, which compiles as before (kOwnV = false).

// The CUDA-core variant (f32; bf16 with D % 8 != 0; D <= 128), the first
// port, unchanged:
//   * one block of 256 threads per (query tile of 64 rows, head);
//   * each K and V tile (64 keys) staged in shared memory in f32 (rows
//     padded to an odd stride, so the 16 rows read together hit distinct
//     banks);
//   * thread (ty, tx) of a 16 x 16 layout owns rows ty + 16 i (i < 4): the
//     logits of keys tx + 16 j (j < 4) and the output columns tx + 16 c
//     (c < 8, a masked tail for D = 120); a row's max and sum are 4-step
//     shuffles within its 16 lanes; the probabilities go through shared
//     memory to the P * V product, accumulated in f32 registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;               // query rows per block
constexpr int kBK = 64;               // keys per tile
constexpr int kMaxDim = 128;          // head_dim limit
constexpr int kRows = kBQ / 16;       // rows per thread
constexpr int kCols = kBK / 16;       // logits per row per thread
constexpr int kDims = kMaxDim / 16;   // output columns per thread
constexpr int kPStride = kBK + 16;    // two rows of a warp on other banks
constexpr unsigned kFull = 0xffffffffu;

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
  int sq, sk, d, causal, has_window, window;
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, Shape s) {
  extern __shared__ float smem[];
  const int d = s.d;
  const int ds = d | 1;                   // odd row stride
  float* q_s = smem;                      // [kBQ][ds]
  float* k_s = q_s + kBQ * ds;            // [kBK][ds]
  float* v_s = k_s + kBK * ds;            // [kBK][ds]
  float* p_s = v_s + kBK * ds;            // [kBQ][kPStride]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const long long head = blockIdx.y;
  const int off = s.sk - s.sq;
  const int nq = min(kBQ, s.sq - q0);
  const T* qh = q + head * s.sq * d;
  const T* kh = k + head * s.sk * d;
  const T* vh = v + head * s.sk * d;

  for (int i = tid; i < kBQ * d; i += kThreads) {
    const int r = i / d, e = i - r * d;
    q_s[r * ds + e] =
        r < nq ? to_f32(qh[static_cast<long long>(q0 + r) * d + e]) : 0.0f;
  }

  // the keys any row of this tile may see: [k_lo, k_hi]
  const int qpos_lo = q0 + off;
  const int qpos_hi = q0 + nq - 1 + off;
  int k_lo = 0, k_hi = s.sk - 1;
  if (s.causal) k_hi = min(k_hi, qpos_hi);
  if (s.has_window) k_lo = max(k_lo, qpos_lo - s.window + 1);

  float m[kRows], l[kRows], acc[kRows][kDims];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kDims; ++c) acc[i][c] = 0.0f;
  }

  const int t_first = k_lo <= k_hi ? (k_lo / kBK) * kBK : s.sk;
  for (int kt = t_first; kt <= k_hi; kt += kBK) {
    const int nk = min(kBK, s.sk - kt);
    __syncthreads();  // q_s stored; the previous tile's readers are done
    for (int i = tid; i < kBK * d; i += kThreads) {
      const int r = i / d, e = i - r * d;
      const long long g = static_cast<long long>(kt + r) * d + e;
      k_s[r * ds + e] = r < nk ? to_f32(kh[g]) : 0.0f;
      v_s[r * ds + e] = r < nk ? to_f32(vh[g]) : 0.0f;
    }
    __syncthreads();

    float sc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int e = 0; e < d; ++e) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = q_s[(ty + 16 * i) * ds + e];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = k_s[(tx + 16 * j) * ds + e];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

    // online softmax: mask, row max and sum over the row's 16 lanes
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r + off;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kc = tx + 16 * j;
        const int kpos = kt + kc;
        bool live = r < nq && kc < nk;
        if (s.causal) live = live && kpos <= qpos;
        if (s.has_window) live = live && kpos > qpos - s.window;
        sc[i][j] = live ? sc[i][j] * s.scale : -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m[i], mx);
      // with m[i] = -inf the row has seen no live key: acc and l are 0
      const float alpha = m[i] == -INFINITY ? 0.0f : expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p =
            sc[i][j] == -INFINITY ? 0.0f : expf(sc[i][j] - m_new);
        p_s[r * kPStride + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(kFull, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDims; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc[i][c] += sum_t p[r_i][t] * v[t][tx + 16 c]
    for (int t = 0; t < nk; ++t) {
      float vv[kDims];
#pragma unroll
      for (int c = 0; c < kDims; ++c) {
        const int e = tx + 16 * c;
        vv[c] = e < d ? v_s[t * ds + e] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = p_s[(ty + 16 * i) * kPStride + t];
#pragma unroll
        for (int c = 0; c < kDims; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

  T* oh = out + head * s.sq * d;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
    const float inv = 1.0f / (l[i] == 0.0f ? 1.0f : l[i]);
#pragma unroll
    for (int c = 0; c < kDims; ++c) {
      const int e = tx + 16 * c;
      if (e < d)
        oh[static_cast<long long>(q0 + r) * d + e] =
            from_f32<T>(acc[i][c] * inv);
    }
  }
}

size_t smem_bytes(int d) {
  return (static_cast<size_t>(kBQ + 2 * kBK) * (d | 1) + kBQ * kPStride) *
         sizeof(float);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           const Shape& s, cudaStream_t stream) {
  const size_t smem = smem_bytes(s.d);
  auto kern = flash_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((s.sq + kBQ - 1) / kBQ, bh);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// The tensor-core variant (bf16, D % 8 == 0)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBQ = 128;                  // query rows per block
constexpr int kBK = 128;                  // keys per tile
constexpr int kBox = 64;                  // columns per TMA box (128 bytes)
constexpr int kStages = 2;                // K / V ring depth
constexpr int kConsumerWarps = 8;         // two warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 128;  // + the producer's
// registers per thread after setmaxnreg: the producer warpgroup gives its
// share to the consumers (launched at 65536 / 384 = 168 each)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr uint32_t kHalf = kBK * kBox * 2;          // one box: 16 KB
constexpr float kLog2e = 1.4426950408889634f;
// barriers: q_full, then k_full, v_full, k_empty, v_empty for each stage
constexpr int kBarriers = 1 + 4 * kStages;
static_assert(kBQ == kBK, "Q and K / V tiles share one box shape");

// The two compiled forms.  kOwnV = false: D <= 128, V as wide as Q and K,
// heads pre-broadcast, no sinks (Q 32 KB + 2 x (K 32 KB + V 32 KB) = 160
// KB).  kOwnV = true: Q and K rows up to 192 wide (three boxes, 12 steps
// of Q K^T), V rows up to 128 in a map of their own, query head h reading
// KV head h / group through the maps, an optional f32 sink per query head
// (Q 48 KB + 2 x (K 48 KB + V 32 KB) = 208 KB).  The S and O accumulators
// are m64n128 in both, so the registers are the same.
template <bool kOwnV>
struct Form {
  static constexpr int kQKBoxes = kOwnV ? 3 : 2;
  static constexpr int kVBoxes = 2;
  static constexpr uint32_t kQKTile = kQKBoxes * kHalf;
  static constexpr uint32_t kVTile = kVBoxes * kHalf;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + kQKTile;
  static constexpr uint32_t kV = kK + kStages * kQKTile;
  static constexpr uint32_t kBars = kV + kStages * kVTile;
  // + 1 KB to align the tiles
  static constexpr uint32_t kSmemBytes = kBars + 8 * kBarriers + 1024;
  static_assert(kSmemBytes <= 232448, "more than a block's shared memory");
};

struct Shape {
  int sq, sk, d, causal, has_window, window, n_qtiles;
  float scale_log2;  // scale * log2(e)
};

// read by the kOwnV form alone (a parameter of its own, so that the first
// form's Shape and code carry none of it): V's width, query heads per KV
// head, query heads per sequence, the sinks ((heads,) f32, or null)
struct OwnV {
  int dv, group, heads;
  const float* sinks;
};

// the ring (shared addresses): tile j of K and V sits in stage j % kStages;
// k_full / v_full complete when its bytes have landed, k_empty / v_empty
// when all 8 consumer warps are done with its K (after Q K^T) or its V
// (after P V)
template <bool kOwnV>
struct Ring {
  using F = Form<kOwnV>;
  uint32_t base;
  __device__ uint32_t q_full() const { return bar(0); }
  __device__ uint32_t k_full(int st) const { return bar(1 + st); }
  __device__ uint32_t v_full(int st) const { return bar(1 + kStages + st); }
  __device__ uint32_t k_empty(int st) const {
    return bar(1 + 2 * kStages + st);
  }
  __device__ uint32_t v_empty(int st) const {
    return bar(1 + 3 * kStages + st);
  }
  __device__ uint32_t k_tile(int st) const {
    return base + F::kK + st * F::kQKTile;
  }
  __device__ uint32_t v_tile(int st) const {
    return base + F::kV + st * F::kVTile;
  }
  __device__ uint32_t bar(int i) const { return base + F::kBars + 8u * i; }
};

// one arrival of this warp on `bar` (after its lanes are done)
__device__ __forceinline__ void warp_arrive(uint32_t bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) hopper::mbar_arrive(bar);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S = Q K^T over ceil(D / 16) steps of 16 columns, issued (not awaited)
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t q_s,
                                         uint32_t k_s, int ksteps) {
  using namespace hopper;
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = 0.0f;
  fence_regs(sc);
  wgmma_fence();
#pragma unroll 1
  for (int kk = 0; kk < ksteps; ++kk) {
    const uint32_t col = (kk / 4) * kHalf + (kk % 4) * 32;
    wgmma_m64n128k16_ss(sc, desc_sw128(q_s + col, 16, 1024),
                        desc_sw128(k_s + col, 16, 1024), 1);
  }
  wgmma_commit();
}

// O += P_hi V + P_lo V, 16 keys a step, issued (not awaited); V is
// MN-major: its two boxes of 64 columns lie kHalf apart, its 8-key row
// groups 1 KB apart
__device__ __forceinline__ void issue_pv(float (&o)[64],
                                         const uint32_t (&p_hi)[32],
                                         const uint32_t (&p_lo)[32],
                                         uint32_t v_s) {
  using namespace hopper;
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t vd = desc_sw128(v_s + kk * 16 * 128, kHalf, 1024);
    wgmma_m64n128k16_rs_tb(o, p_hi[4 * kk], p_hi[4 * kk + 1],
                           p_hi[4 * kk + 2], p_hi[4 * kk + 3], vd);
    wgmma_m64n128k16_rs_tb(o, p_lo[4 * kk], p_lo[4 * kk + 1],
                           p_lo[4 * kk + 2], p_lo[4 * kk + 3], vd);
  }
  wgmma_commit();
}

// The rows of this thread and where they sit: accumulator chunk i (columns
// 8 i .. 8 i + 7) holds (row0, c), (row0, c + 1), (row0 + 8, c),
// (row0 + 8, c + 1) at d[4 i .. 4 i + 3], with c = 8 i + cq.
struct Rows {
  int qpos0;          // row0's position (row0 + 8 sits at qpos0 + 8)
  int cq;             // the thread's first column in each chunk
  int wg_lo, wg_hi;   // the positions of the warpgroup's 64 rows
};

// Tile kt's online-softmax step on the raw products sc: masks the pairs
// outside the band (only on tiles that straddle its edge or the last key),
// turns sc into p = exp2(sc * scale_log2 - m * scale_log2) in place,
// updates the running max m and this thread's sums l, and gives the factor
// alpha that the rows' old output must be scaled by.
__device__ __forceinline__ void softmax_step(float (&sc)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             const Shape& s, const Rows& r,
                                             int kt) {
  const bool edge = kt + kBK > s.sk ||
                    (s.causal && kt + kBK - 1 > r.wg_lo) ||
                    (s.has_window && kt <= r.wg_hi - s.window);
  if (edge) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = kt + 8 * i + r.cq + (e & 1);
        const int qpos = r.qpos0 + 8 * (e >> 1);
        bool live = kpos < s.sk;
        if (s.causal) live = live && kpos <= qpos;
        if (s.has_window) live = live && kpos > qpos - s.window;
        if (!live) sc[4 * i + e] = -INFINITY;
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * h], sc[4 * i + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx);
    // a row that has seen no live key keeps m = -inf: its p and alpha are
    // exp2(-inf) = 0, with no (-inf) - (-inf)
    const float mb = m_new == -INFINITY ? 0.0f : m_new * s.scale_log2;
    alpha[h] = hopper::exp2_approx(m[h] * s.scale_log2 - mb);
    m[h] = m_new;
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * i + 2 * h + e];
        x = hopper::exp2_approx(fmaf(x, s.scale_log2, -mb));
        sum += x;
      }
    l[h] = l[h] * alpha[h] + sum;
  }
}

// p in two bf16 parts, packed as the A fragments of P V: step kk's fragment
// is pk[4 kk .. 4 kk + 3], and pk[n] holds the pair sc[2 n], sc[2 n + 1]
__device__ __forceinline__ void split_p(const float (&sc)[64],
                                        uint32_t (&p_hi)[32],
                                        uint32_t (&p_lo)[32]) {
#pragma unroll
  for (int n = 0; n < 32; ++n) {
    const __nv_bfloat162 hi = __floats2bfloat162_rn(sc[2 * n], sc[2 * n + 1]);
    const float2 hf = __bfloat1622float2(hi);
    p_hi[n] = *reinterpret_cast<const uint32_t*>(&hi);
    p_lo[n] = pack_bf16(sc[2 * n] - hf.x, sc[2 * n + 1] - hf.y);
  }
}

__device__ __forceinline__ void rescale(float (&o)[64],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// ---- consumers: warpgroup wg owns query rows 64 wg .. 64 wg + 63 --------
// Tile j's Q K^T is issued together with tile j - 1's P V, so the softmax
// of tile j runs while the tensor cores work on P V.  `sink_l2` (kOwnV
// only) is the head's sink logit times log2(e), or -inf for none.
template <bool kOwnV>
__device__ __forceinline__ void consume(uint32_t base, const Shape& s, int q0,
                                        int nq, int t_first, int n_tiles,
                                        int dv, float sink_l2,
                                        __nv_bfloat16* __restrict__ oh) {
  using namespace hopper;
  const Ring<kOwnV> ring{base};
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int row0 = 64 * wg + 16 * (warp % 4) + lane / 4;
  Rows rows;
  rows.qpos0 = q0 + row0 + s.sk - s.sq;
  rows.cq = 2 * (lane % 4);
  rows.wg_lo = q0 + 64 * wg + s.sk - s.sq;
  rows.wg_hi = rows.wg_lo + 63;
  const int ksteps = (s.d + 15) / 16;
  const uint32_t q_s = base + Form<kOwnV>::kQ + 64u * wg * 128u;

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};   // running max of the raw products
  float l[2] = {0.0f, 0.0f};             // this thread's share of the sums
  float alpha[2];
  float sc[64];
  uint32_t p_hi[32], p_lo[32];

  mbar_wait(ring.q_full(), 0);
  if (n_tiles > 0) {
    mbar_wait(ring.k_full(0), 0);
    issue_qk(sc, q_s, ring.k_tile(0), ksteps);
    wgmma_wait<0>();
    fence_regs(sc);
    warp_arrive(ring.k_empty(0));
    softmax_step(sc, m, l, alpha, s, rows, t_first * kBK);
    split_p(sc, p_hi, p_lo);
  }
  for (int j = 1; j < n_tiles; ++j) {
    const int st = j % kStages, sp = (j - 1) % kStages;
    mbar_wait(ring.k_full(st), (j / kStages) & 1);
    mbar_wait(ring.v_full(sp), ((j - 1) / kStages) & 1);
    issue_qk(sc, q_s, ring.k_tile(st), ksteps);
    issue_pv(o, p_hi, p_lo, ring.v_tile(sp));
    wgmma_wait<1>();  // Q K^T of tile j is done, P V of j - 1 runs on
    fence_regs(sc);
    warp_arrive(ring.k_empty(st));
    softmax_step(sc, m, l, alpha, s, rows, (t_first + j) * kBK);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p_hi);  // the product read them until here
    fence_regs(p_lo);
    warp_arrive(ring.v_empty(sp));
    rescale(o, alpha);
    split_p(sc, p_hi, p_lo);
  }
  if (n_tiles > 0) {
    const int sl = (n_tiles - 1) % kStages;
    mbar_wait(ring.v_full(sl), ((n_tiles - 1) / kStages) & 1);
    issue_pv(o, p_hi, p_lo, ring.v_tile(sl));
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p_hi);
    fence_regs(p_lo);
    warp_arrive(ring.v_empty(sl));
  }

  // out = O / l; rows past the sequence and columns past D (Dv) are not
  // stored
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    if (r >= nq) continue;
    float inv = l[h] == 0.0f ? 0.0f : 1.0f / l[h];
    if (kOwnV && sink_l2 != -INFINITY) {
      // the sink takes softmax mass and adds no value: l += e^(sink - m),
      // in l's units (log2, m * scale_log2), both terms first taken down
      // to the larger exponent; a row with no live key (m = -inf) gives 0
      const float mb = m[h] * s.scale_log2;
      const float top = fmaxf(mb, sink_l2);
      const float a = exp2_approx(mb - top);
      inv = a / fmaf(l[h], a, exp2_approx(sink_l2 - top));
    }
    __nv_bfloat16* orow = oh + static_cast<long long>(q0 + r) * dv;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = 8 * i + rows.cq;
      if (col < dv)
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(o[4 * i + 2 * h] * inv, o[4 * i + 2 * h + 1] * inv);
    }
  }
}

template <bool kOwnV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    __nv_bfloat16* __restrict__ out, Shape s,
                    OwnV ov) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1 KB: tiles start on 1 KB bounds
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const Ring<kOwnV> ring{base};

  const int head = blockIdx.x;
  // the KV plane this head reads: (b, h) -> b * K + h / group = head / group
  const int kv_head = kOwnV ? head / ov.group : head;
  const int q0 = (s.n_qtiles - 1 - static_cast<int>(blockIdx.y)) * kBQ;
  const int off = s.sk - s.sq;
  const int nq = min(kBQ, s.sq - q0);
  // the key tiles any row of this query tile may see
  int k_lo = 0, k_hi = s.sk - 1;
  if (s.causal) k_hi = min(k_hi, q0 + nq - 1 + off);
  if (s.has_window) k_lo = max(k_lo, q0 + off - s.window + 1);
  const int t_first = k_lo <= k_hi ? k_lo / kBK : 0;
  const int n_tiles = k_lo <= k_hi ? k_hi / kBK - t_first + 1 : 0;

  if (threadIdx.x == 0) {
    mbar_init(ring.q_full(), 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(ring.k_full(st), 1);
      mbar_init(ring.v_full(st), 1);
      mbar_init(ring.k_empty(st), kConsumerWarps);
      mbar_init(ring.v_empty(st), kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // one if / else over the whole kernel, so that setmaxnreg holds
  if (threadIdx.x >= 32 * kConsumerWarps) {
    // ---- producer: Q once, then K and V tiles through the ring ----------
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 32 * kConsumerWarps) {
      // D <= 64 fits one box; the second is then never loaded nor read by
      // Q K^T, and the output columns it feeds in P V are never stored
      // (kOwnV: ceil(D / 64) boxes of Q and K, ceil(Dv / 64) of V)
      const int n_box = kOwnV ? (s.d + kBox - 1) / kBox : s.d > kBox ? 2 : 1;
      const int n_vbox = kOwnV ? (ov.dv + kBox - 1) / kBox : n_box;
      const uint32_t bytes = n_box * kHalf;
      const uint32_t v_bytes = n_vbox * kHalf;
      mbar_expect_tx(ring.q_full(), bytes);
      for (int b = 0; b < n_box; ++b)
        tma_load_3d(base + Form<kOwnV>::kQ + b * kHalf, &q_map, ring.q_full(),
                    b * kBox, q0, head);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        const uint32_t free = ((j / kStages) & 1) ^ 1;  // round 0: at once
        const int kt = (t_first + j) * kBK;
        mbar_wait(ring.k_empty(st), free);
        mbar_expect_tx(ring.k_full(st), bytes);
        for (int b = 0; b < n_box; ++b)
          tma_load_3d(ring.k_tile(st) + b * kHalf, &k_map, ring.k_full(st),
                      b * kBox, kt, kv_head);
        mbar_wait(ring.v_empty(st), free);
        mbar_expect_tx(ring.v_full(st), v_bytes);
        for (int b = 0; b < n_vbox; ++b)
          tma_load_3d(ring.v_tile(st) + b * kHalf, &v_map, ring.v_full(st),
                      b * kBox, kt, kv_head);
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int dv = kOwnV ? ov.dv : s.d;
    const float sink_l2 = kOwnV && ov.sinks != nullptr
                              ? ov.sinks[head % ov.heads] * kLog2e
                              : -INFINITY;
    consume<kOwnV>(base, s, q0, nq, t_first, n_tiles, dv, sink_l2,
                   out + static_cast<long long>(head) * s.sq * dv);
  }
}

// q (bh, sq, d); k (bh / group, sk, d); v (bh / group, sk, dv)
template <bool kOwnV>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int sq, int sk, int d, int causal, int has_window, int window,
           float scale, int dv, int group, int heads, const float* sinks,
           cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  const int planes[3] = {bh, bh / group, bh / group};
  const int rows[3] = {sq, sk, sk};
  const int cols[3] = {d, d, dv};
  for (int i = 0; i < 3; ++i) {
    cudaError_t err = hopper::bf16_map_3d(&maps[i], ptrs[i], planes[i],
                                          rows[i], cols[i], kBQ);
    if (err != cudaSuccess) return err;
  }
  constexpr uint32_t smem = Form<kOwnV>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<kOwnV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const Shape s{sq, sk, d, causal, has_window, window, (sq + kBQ - 1) / kBQ,
                scale * kLog2e};
  const OwnV ov{dv, group, heads, sinks};
  const dim3 grid(bh, s.n_qtiles);
  flash_tc_kernel<kOwnV><<<grid, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(out), s, ov);
  return cudaGetLastError();
}

}  // namespace tc

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// `window` is read only when has_window is 1.  Returns a cudaError_t
// (0 = ok); cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int bh, int sq, int sk, int d,
                               int causal, int has_window, int window,
                               float scale, int dtype, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bh < 0 || sq < 0 || sk < 0 || d <= 0 || d > kMaxDim || dtype < 0 ||
      dtype > 1 || bh > 65535)
    return cudaErrorInvalidValue;
  if (bh == 0 || sq == 0) return cudaSuccess;
  const Shape s{sq, sk, d, causal ? 1 : 0, has_window ? 1 : 0, window, scale};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, out, bh, s, st);
  return launch<__nv_bfloat16>(q, k, v, out, bh, s, st);
}

// The tensor-core variant: bf16 q, k, v and out, 8 <= d <= 128 with
// d % 8 == 0, each pointer 16-byte aligned.  Same arguments and return
// value as flash_attention (less the dtype).
extern "C" int flash_attention_tc(const void* q, const void* k,
                                  const void* v, void* out, int bh, int sq,
                                  int sk, int d, int causal, int has_window,
                                  int window, float scale, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bh < 0 || sq < 0 || sk <= 0 || d <= 0 || d > kMaxDim || d % 8 != 0 ||
      bh > 65535)
    return cudaErrorInvalidValue;
  if (bh == 0 || sq == 0) return cudaSuccess;
  return tc::launch<false>(q, k, v, out, bh, sq, sk, d, causal ? 1 : 0,
                           has_window ? 1 : 0, window, scale, d, 1, bh,
                           nullptr, static_cast<cudaStream_t>(stream));
}

// The tensor-core variant's second form: bf16 q (bh, sq, d), k (bh / group,
// sk, d), v (bh / group, sk, dv) and out (bh, sq, dv), 8 <= d <= 192 and
// 8 <= dv <= 128, both multiples of 8, each pointer 16-byte aligned; row
// `head` of q, for head = b * heads + h, reads the KV plane head / group
// (heads a multiple of group, bh of heads); `sinks` (heads,) f32 on the
// device, or null.  Same return value as flash_attention.
extern "C" int flash_attention_tc_own_v(const void* q, const void* k,
                                        const void* v, void* out, int bh,
                                        int sq, int sk, int d, int dv,
                                        int group, int heads, int causal,
                                        int has_window, int window,
                                        float scale, const float* sinks,
                                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bh < 0 || sq < 0 || sk <= 0 || d < 8 || d > 192 || d % 8 != 0 ||
      dv < 8 || dv > 128 || dv % 8 != 0 || bh > 65535 || group < 1 ||
      heads < 1 || heads % group != 0 || bh % heads != 0)
    return cudaErrorInvalidValue;
  if (bh == 0 || sq == 0) return cudaSuccess;
  return tc::launch<true>(q, k, v, out, bh, sq, sk, d, causal ? 1 : 0,
                          has_window ? 1 : 0, window, scale, dv, group,
                          heads, sinks, static_cast<cudaStream_t>(stream));
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
