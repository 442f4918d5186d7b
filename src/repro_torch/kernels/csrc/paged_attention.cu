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
// values are the first Dv <= W columns of the V rows, which lie in their
// own pool, W <= D wide (Dv = W = D for GQA; MiMo-V2-Flash's D = 192, W =
// Dv = 128); with `shared` the V rows are the K rows, read once (MLA's
// absorbed decode over its latent pool: K = 1, H = 128, D = 576, Dv = 512).
// The logits are scaled after the dot product (as the oracle, not the
// Pallas body, does it), the softmax is online in f32, and an empty context
// gives 0.  Block-table entries past ceil(ctx / page) are never read.
// Optional sinks, an f32 logit per query head, take softmax mass and add no
// value: out = sum_p e^(s_p) V_p / (sum_p e^(s_p) + e^(sink)), added once,
// in f32, where the block or the combine normalises.
//
// What bounds it: bytes.  Each live position's K and V rows of one kv head
// (2 * D elements) are read once, q once, out written once; the work is
// 4 * H * D flops per position, about 1 flop per byte in f32, far below
// the card's ~20 f32 flops per byte of memory bandwidth.  The least time is
//   bytes = B*H*D*sizeof(q) + sum_b ctx_b * K * 2 * D * sizeof(kv)
//           + (live table entries + B) * 4 + B*H*D*sizeof(out)
//   bound = bytes / 3.35 TB/s.
//
// What the design does about it (flash-decoding):
//   * split-K over the context: each (kv head, sequence) context is cut
//     into `parts` partitions of `part_len` positions (a whole number of
//     tiles and pages), one block of 256 threads each per block of at most
//     16 query heads of the kv head: grid (K x head blocks) x B x parts.
//     The wrapper's split_plan picks them from the shapes and from how
//     many blocks an SM holds at once (paged_attention_resident): at least
//     two blocks per SM where the contexts allow, and as few tiles on the
//     busiest SM as the waves of blocks give.  A block wholly past its
//     sequence's context exits at once.  The G query heads of the kv head
//     sit in shared memory, so each K/V row is read from device memory
//     once for all G heads;
//   * with one partition the block normalises and writes the output; with
//     more, each block writes its (m, l, acc[G][D]) in f32 to a workspace
//     (B, H, parts, D + 2) and a second kernel combines the non-empty
//     partitions of each (sequence, head) in partition order, rescaled by
//     their largest m: no float atomics, so two runs give the same bits,
//     and an empty partition is never read;
//   * the partition is walked in tiles of 32 positions (which may span
//     pages: each row pointer comes from the block table), double-buffered
//     in shared memory: the next tile's K and V rows are in flight by
//     cp.async (16-byte vectors, one per lane and row chunk) while this
//     tile's logits and P.V run.  Where a row is no multiple of 16 bytes
//     or a pool is not 16-byte aligned, plain loads fill the buffer
//     instead.  Rows sit at a stride of an odd number of 16-byte units (an
//     odd number of elements on the plain path), so the per-position reads
//     below are free of bank conflicts;
//   * logits: every warp works.  A query head's D is cut into 8 / G pieces
//     (G <= 8, else 1); warp w takes (head, piece) pairs, lane = position,
//     and the pieces' partial dot products meet in shared memory; warp g
//     then forms head g's 32 logits, scales them after the product, takes
//     their max and sum by shuffles and updates (m, l) online in f32;
//   * P.V: each thread rescales and updates the accumulator elements it
//     owns, kept in registers: pairs of adjacent elements of a head where
//     rows are whole vectors (each p read once for both; a full tile's p
//     read four at a time), single elements on the plain path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;        // positions per tile (one per lane)
constexpr int kMaxDim = 576;     // key width limit
constexpr int kHeadBlock = 16;   // query heads per block, at most
// accumulator slots per thread: kAccNarrow for the GQA launch (values the
// whole V rows, at most 16 query heads per kv head, 16 x 256 values a
// block), kAccWide (16 x 512) for the general one, which alone reads the
// Shape's head blocks, value width and shared rows
constexpr int kAccNarrow = 16;
constexpr int kAccWide = 32;
constexpr int kCombineThreads = 128;
constexpr size_t kMaxSmem = 232448;   // a block's dynamic shared memory

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

__device__ __forceinline__ float lo_bf16(unsigned word) {
  return __uint_as_float(word << 16);
}
__device__ __forceinline__ float hi_bf16(unsigned word) {
  return __uint_as_float(word & 0xffff0000u);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

struct Shape {
  int b, h, d, page, kv_heads, nblk, groups;
  int part_len, parts;  // positions per partition; partitions per context
  int row_bytes;        // stride of K and V rows in shared memory
  int pieces;           // pieces of D per query head in the logits
  float scale;
  int dv;               // value width: the leading dv columns of a V row
  int shared;           // the V rows are the K rows (read once)
  int gblock;           // query heads per block (the last may hold fewer)
  int hblocks;          // blocks of query heads per kv head
  int v_row;            // width of the V pool's rows (d where shared)
  int sinks;            // a sink logit per query head is given
};

__host__ __device__ inline int align16(int bytes) {
  return (bytes + 15) & ~15;
}

// Shared memory, for the block's G = gblock heads: q (G, D) f32 | K, V of
// two stages (2, 2 or 1 with `shared`, kTile rows) | partial logits
// (G * pieces, kTile) | p (G, kTile) | m, l, alpha (G).
__host__ __device__ inline int stage_rows(const Shape& s) {
  return (s.shared ? 1 : 2) * kTile;
}
__host__ __device__ inline int kv_offset(const Shape& s) {
  return align16(s.gblock * s.d * 4);
}
__host__ __device__ inline int part_offset(const Shape& s) {
  return kv_offset(s) + 2 * stage_rows(s) * s.row_bytes;
}
size_t smem_bytes(const Shape& s) {
  return part_offset(s) +
         (static_cast<size_t>(s.gblock) * (s.pieces + 1) * kTile +
          3 * s.gblock) * sizeof(float);
}

// Elements of one chunk of a row: a 16-byte vector, or one element on the
// plain path.
template <typename T, bool kVec>
__host__ __device__ constexpr int chunk_elems() {
  return kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
}

// Positions [base, base + n_t) of kv head `kh` into the stage's K rows
// (d wide) and V rows (their leading dv columns; none with `shared`; with
// kOwnV, the leading dv columns of the V pool's v_row-wide rows):
// cp.async 16-byte vectors, or plain loads and stores.  Warp w takes rows
// w, w + 8, ...; its lanes look up those rows' pages together first, so
// the block-table reads of a tile are in flight at once.
template <typename TKV, bool kVec, bool kWide, bool kOwnV>
__device__ __forceinline__ void load_tile(const TKV* __restrict__ k_pages,
                                          const TKV* __restrict__ v_pages,
                                          const int* __restrict__ bt,
                                          int base, int n_t, int kh,
                                          char* ks, char* vs, const Shape& s,
                                          int warp, int lane) {
  const int rows = warp < n_t ? (n_t - warp + kWarps - 1) / kWarps : 0;
  // each lane's row: its K row's offset, or with kOwnV its row index
  long long mine = 0;
  if (lane < rows) {
    const int pos = base + warp + lane * kWarps;
    mine = (static_cast<long long>(bt[pos / s.page]) * s.page +
            pos % s.page) * s.kv_heads + kh;
    if constexpr (!kOwnV) mine *= s.d;
  }
  for (int r = 0; r < rows; ++r) {
    const int t = warp + r * kWarps;
    const long long at = __shfl_sync(0xffffffffu, mine, r);
    const long long row = kOwnV ? at * s.d : at;
    const long long v_at = kOwnV ? at * s.v_row : at;
    char* kd = ks + t * s.row_bytes;
    char* vd = vs + t * s.row_bytes;
    if constexpr (kVec) {
      const char* kg = reinterpret_cast<const char*>(k_pages + row);
      const char* vg = reinterpret_cast<const char*>(v_pages + v_at);
      const int chunks = s.d * static_cast<int>(sizeof(TKV)) / 16;
      if constexpr (kWide) {
        const int v_chunks = !kOwnV && s.shared
                                 ? 0
                                 : s.dv * static_cast<int>(sizeof(TKV)) / 16;
        for (int c = lane; c < chunks; c += 32) {
          cp_async16(kd + 16 * c, kg + 16 * c);
          if (c < v_chunks) cp_async16(vd + 16 * c, vg + 16 * c);
        }
      } else {
        for (int c = lane; c < chunks; c += 32) {
          cp_async16(kd + 16 * c, kg + 16 * c);
          cp_async16(vd + 16 * c, vg + 16 * c);
        }
      }
    } else if constexpr (kWide) {
      const int v_elems = !kOwnV && s.shared ? 0 : s.dv;
      for (int e = lane; e < s.d; e += 32) {
        reinterpret_cast<TKV*>(kd)[e] = k_pages[row + e];
        if (e < v_elems) reinterpret_cast<TKV*>(vd)[e] = v_pages[v_at + e];
      }
    } else {
      for (int e = lane; e < s.d; e += 32) {
        reinterpret_cast<TKV*>(kd)[e] = k_pages[row + e];
        reinterpret_cast<TKV*>(vd)[e] = v_pages[row + e];
      }
    }
  }
}

// kPv adjacent elements of a V row in shared memory, as floats.
template <int kPv>
struct Floats {
  float v[kPv];
};
template <typename TKV, int kPv>
__device__ __forceinline__ Floats<kPv> load_pv(const char* at) {
  Floats<kPv> f;
  if constexpr (kPv == 1) {
    f.v[0] = to_f32(*reinterpret_cast<const TKV*>(at));
  } else if constexpr (sizeof(TKV) == 4) {
    const float2 x = *reinterpret_cast<const float2*>(at);
    f.v[0] = x.x;
    f.v[1] = x.y;
  } else {
    const unsigned x = *reinterpret_cast<const unsigned*>(at);
    f.v[0] = lo_bf16(x);
    f.v[1] = hi_bf16(x);
  }
  return f;
}

// <q chunk c, K row chunk c>: q_g is the head's f32 row in shared memory.
template <typename TKV, bool kVec>
__device__ __forceinline__ float chunk_dot(const float* q_g, const char* kr,
                                           int c) {
  if constexpr (kVec && sizeof(TKV) == 4) {
    const float4 k = reinterpret_cast<const float4*>(kr)[c];
    const float4 q = reinterpret_cast<const float4*>(q_g)[c];
    return fmaf(q.w, k.w, fmaf(q.z, k.z, fmaf(q.y, k.y, q.x * k.x)));
  } else if constexpr (kVec) {
    // eight bf16, two to a word, low half first; a bf16 is the high half
    // of its f32
    const uint4 raw = reinterpret_cast<const uint4*>(kr)[c];
    const float4 q0 = reinterpret_cast<const float4*>(q_g)[2 * c];
    const float4 q1 = reinterpret_cast<const float4*>(q_g)[2 * c + 1];
    float dot = q0.x * lo_bf16(raw.x);
    dot = fmaf(q0.y, hi_bf16(raw.x), dot);
    dot = fmaf(q0.z, lo_bf16(raw.y), dot);
    dot = fmaf(q0.w, hi_bf16(raw.y), dot);
    dot = fmaf(q1.x, lo_bf16(raw.z), dot);
    dot = fmaf(q1.y, hi_bf16(raw.z), dot);
    dot = fmaf(q1.z, lo_bf16(raw.w), dot);
    return fmaf(q1.w, hi_bf16(raw.w), dot);
  } else {
    return q_g[c] * to_f32(reinterpret_cast<const TKV*>(kr)[c]);
  }
}

// One partition of one (kv head, block of its query heads, sequence): grid
// (K x hblocks) x B x parts.  With one partition `out` gets the normalised
// result (with kOwnV, the sinks where given); with more, `ws` gets (m, l,
// acc) per query head.  kAcc accumulator slots per thread hold the block's
// heads x dv values.  kOwnV (general launches whose V rows are not the K
// rows): V rows of their own width and sinks; MLA's shared rows and the
// GQA launch compile without either.
template <typename TQ, typename TKV, bool kVec, int kAcc, bool kOwnV>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
    const TKV* __restrict__ v_pages, const int* __restrict__ block_table,
    const int* __restrict__ context_lens, TQ* __restrict__ out,
    float* __restrict__ ws, const float* __restrict__ sinks, Shape s) {
  extern __shared__ __align__(16) char smem[];
  constexpr bool kWide = kAcc == kAccWide;
  const int kh = kWide ? blockIdx.x / s.hblocks : blockIdx.x;
  const int hb = kWide ? blockIdx.x - kh * s.hblocks : 0;
  const int seq = blockIdx.y;
  const int part = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int d = s.d;
  const int dv = kWide ? s.dv : s.d;
  const int g_n = kWide ? min(s.gblock, s.groups - hb * s.gblock) : s.groups;

  const int capacity = s.nblk * s.page;
  const int ctx = min(max(context_lens[seq], 0), capacity);
  const int lo = part * s.part_len;
  if (s.parts > 1 && lo >= ctx) return;  // whole block: no barrier passed
  const int hi = min(lo + s.part_len, ctx);
  const int n_tiles = hi > lo ? (hi - lo + kTile - 1) / kTile : 0;

  float* q_s = reinterpret_cast<float*>(smem);            // [G][D]
  char* kv = smem + kv_offset(s);                         // [2][K|V][kTile]
  const int stage_bytes = (kWide ? stage_rows(s) : 2 * kTile) * s.row_bytes;
  // the V rows of a stage: after its K rows, or the K rows themselves
  const int v_rows_at =
      kWide && !kOwnV && s.shared ? 0 : kTile * s.row_bytes;
  float* part_s = reinterpret_cast<float*>(smem + part_offset(s));
  float* p_s = part_s + g_n * s.pieces * kTile;           // [G][kTile]
  float* m_s = p_s + g_n * kTile;                         // [G]
  float* l_s = m_s + g_n;                                 // [G]
  float* alpha_s = l_s + g_n;                             // [G]

  const int h0 = kWide ? kh * s.groups + hb * s.gblock : kh * g_n;
  const TQ* qb = q + (static_cast<long long>(seq) * s.h + h0) * d;
  for (int i = tid; i < g_n * d; i += kThreads) q_s[i] = to_f32(qb[i]);
  for (int g = tid; g < g_n; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.0f;
  }

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;

  const int* bt = block_table + static_cast<long long>(seq) * s.nblk;
  if (n_tiles > 0)
    load_tile<TKV, kVec, kWide, kOwnV>(k_pages, v_pages, bt, lo,
                                       min(kTile, hi - lo), kh, kv,
                                       kv + v_rows_at, s, warp, lane);
  cp_async_commit();
  __syncthreads();  // q, m and l, also where the partition is empty

  constexpr int E = chunk_elems<TKV, kVec>();
  const int chunks = d / E;
  // P.V items: kPv adjacent elements of a head's Dv (two where rows are
  // whole 16-byte vectors, so Dv is even), kItems items per thread
  constexpr int kPv = kVec ? 2 : 1;
  constexpr int kItems = kAcc / kPv;
  const int items = g_n * s.pieces;
  for (int it = 0; it < n_tiles; ++it) {
    const int base = lo + it * kTile;
    const int n_t = min(kTile, hi - base);
    char* ks = kv + (it & 1) * stage_bytes;
    const char* vs = ks + v_rows_at;
    if (it + 1 < n_tiles) {
      char* nk = kv + ((it + 1) & 1) * stage_bytes;
      load_tile<TKV, kVec, kWide, kOwnV>(k_pages, v_pages, bt, base + kTile,
                                         min(kTile, hi - base - kTile), kh,
                                         nk, nk + v_rows_at, s, warp, lane);
    }
    cp_async_commit();
    cp_async_wait_one();  // this tile's copies, by this thread
    __syncthreads();      // ... and by every thread
    // partial logits: item = piece * G + g, lane = position
    for (int item = warp; item < items; item += kWarps) {
      const int g = item % g_n, piece = item / g_n;
      float dot = 0.0f;
      if (lane < n_t) {
        const float* qg = q_s + g * d;
        const char* kr = ks + lane * s.row_bytes;
        const int c1 = (piece + 1) * chunks / s.pieces;
#pragma unroll 4
        for (int c = piece * chunks / s.pieces; c < c1; ++c)
          dot += chunk_dot<TKV, kVec>(qg, kr, c);
      }
      part_s[item * kTile + lane] = dot;
    }
    __syncthreads();
    // logits, online softmax: warp g owns query head g, lane t position t
    for (int g = warp; g < g_n; g += kWarps) {
      float sc = -INFINITY;
      if (lane < n_t) {
        float dot = 0.0f;
        for (int piece = 0; piece < s.pieces; ++piece)
          dot += part_s[(piece * g_n + g) * kTile + lane];
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
    // acc[g][e] = acc[g][e] * alpha[g] + sum_t p[g][t] * v[t][e], for the
    // kPv adjacent elements of each item the thread owns; a full tile reads
    // p four positions at a time
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int el = (tid + i * kThreads) * kPv;
      if (el < g_n * dv) {
        const int g = el / dv;
        const float* pg = p_s + g * kTile;
        const char* ve = vs + (el - g * dv) * static_cast<int>(sizeof(TKV));
        float u[kPv] = {};
        auto step = [&](float p, int t) {
          const Floats<kPv> v = load_pv<TKV, kPv>(ve + t * s.row_bytes);
#pragma unroll
          for (int j = 0; j < kPv; ++j) u[j] = fmaf(p, v.v[j], u[j]);
        };
        if (n_t == kTile) {
#pragma unroll
          for (int t = 0; t < kTile; t += 4) {
            const float4 p4 = *reinterpret_cast<const float4*>(pg + t);
            step(p4.x, t);
            step(p4.y, t + 1);
            step(p4.z, t + 2);
            step(p4.w, t + 3);
          }
        } else {
          for (int t = 0; t < n_t; ++t) step(pg[t], t);
        }
        const float alpha = alpha_s[g];
#pragma unroll
        for (int j = 0; j < kPv; ++j)
          acc[i * kPv + j] = acc[i * kPv + j] * alpha + u[j];
      }
    }
    __syncthreads();  // the stage and p are free for the next tiles
  }

  // slot i * kPv + j of acc is element (tid + i * kThreads) * kPv + j of
  // the (G, Dv) block of heads
  if (kOwnV && s.parts == 1 && s.sinks) {
    // o = acc e^(m - m') / (l e^(m - m') + e^(sink - m')), m' = max(m, sink)
    for (int g = tid; g < g_n; g += kThreads) {
      const float sink = sinks[h0 + g];
      const float m_all = fmaxf(m_s[g], sink);
      const float keep = expf(m_s[g] - m_all);  // 0 on an empty context
      alpha_s[g] = keep / (l_s[g] * keep + expf(sink - m_all));
    }
    __syncthreads();
    TQ* ob = out + (static_cast<long long>(seq) * s.h + h0) * dv;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int el = (tid + i * kThreads) * kPv;
      if (el < g_n * dv) {
        const float f = alpha_s[el / dv];
#pragma unroll
        for (int j = 0; j < kPv; ++j)
          ob[el + j] = from_f32<TQ>(acc[i * kPv + j] * f);
      }
    }
    return;
  }
  if (s.parts == 1) {
    TQ* ob = out + (static_cast<long long>(seq) * s.h + h0) * dv;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int el = (tid + i * kThreads) * kPv;
      if (el < g_n * dv) {
        const float l = l_s[el / dv];
#pragma unroll
        for (int j = 0; j < kPv; ++j)
          ob[el + j] = from_f32<TQ>(acc[i * kPv + j] /
                                    (l == 0.0f ? 1.0f : l));
      }
    }
    return;
  }
  // (m, l, acc) of each query head of this partition
  const int w = dv + 2;
  float* wb = ws + (static_cast<long long>(seq) * s.h + h0) * s.parts * w +
              static_cast<long long>(part) * w;
  const long long head_stride = static_cast<long long>(s.parts) * w;
  for (int g = tid; g < g_n; g += kThreads) {
    wb[g * head_stride] = m_s[g];
    wb[g * head_stride + 1] = l_s[g];
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int el = (tid + i * kThreads) * kPv;
    if (el < g_n * dv) {
      const int g = el / dv, e = el - g * dv;
#pragma unroll
      for (int j = 0; j < kPv; ++j)
        wb[g * head_stride + 2 + e + j] = acc[i * kPv + j];
    }
  }
}

// Combine the non-empty partitions of each (head, sequence) in partition
// order, with the head's sink where given: grid H x B.
template <typename TQ>
__global__ void __launch_bounds__(kCombineThreads) paged_combine_kernel(
    const float* __restrict__ ws, const int* __restrict__ context_lens,
    TQ* __restrict__ out, const float* __restrict__ sinks, Shape s) {
  const int hh = blockIdx.x, seq = blockIdx.y;
  const int d = s.dv, w = d + 2;
  const int ctx = min(max(context_lens[seq], 0), s.nblk * s.page);
  const int live = (ctx + s.part_len - 1) / s.part_len;
  const float* wb = ws + (static_cast<long long>(seq) * s.h + hh) * s.parts * w;
  float mx = s.sinks ? sinks[hh] : -INFINITY;
  for (int p = 0; p < live; ++p) mx = fmaxf(mx, wb[p * w]);
  float l = s.sinks ? expf(sinks[hh] - mx) : 0.0f;
  for (int p = 0; p < live; ++p) l += wb[p * w + 1] * expf(wb[p * w] - mx);
  TQ* ob = out + (static_cast<long long>(seq) * s.h + hh) * d;
  for (int e = threadIdx.x; e < d; e += kCombineThreads) {
    float o = 0.0f;
    for (int p = 0; p < live; ++p)
      o = fmaf(wb[p * w + 2 + e], expf(wb[p * w] - mx), o);
    ob[e] = from_f32<TQ>(live > 0 ? o / l : 0.0f);
  }
}

template <typename T>
struct Type {
  using type = T;
};

// f(Type<TQ>, Type<TKV>, std::bool_constant<kVec>, integral_constant<kAcc>,
// std::bool_constant<kOwnV>) for the dtype codes (0 = float32, 1 =
// bfloat16), the load path, the accumulator slots and (general launches
// only) V rows of their own.
template <class F>
int dispatch(int q_dtype, int kv_dtype, bool vec, bool wide, bool own_v,
             F&& f) {
  auto by_kv = [&](auto tq) {
    auto by_acc = [&](auto tkv, auto vv) {
      using Wide = std::integral_constant<int, kAccWide>;
      if (!wide)
        return f(tq, tkv, vv, std::integral_constant<int, kAccNarrow>{},
                 std::false_type{});
      return own_v ? f(tq, tkv, vv, Wide{}, std::true_type{})
                   : f(tq, tkv, vv, Wide{}, std::false_type{});
    };
    auto by_vec = [&](auto tkv) {
      return vec ? by_acc(tkv, std::true_type{})
                 : by_acc(tkv, std::false_type{});
    };
    return kv_dtype == 0 ? by_vec(Type<float>{})
                         : by_vec(Type<__nv_bfloat16>{});
  };
  return q_dtype == 0 ? by_kv(Type<float>{}) : by_kv(Type<__nv_bfloat16>{});
}

// The 16-byte path takes rows that are whole vectors in pools that are
// 16-byte aligned.
bool vector_rows(int d, int kv_dtype, bool aligned) {
  return aligned && (d * (kv_dtype == 0 ? 4 : 2)) % 16 == 0;
}

// The partition kernel's layout for `s` (row stride, pieces of D) and its
// shared memory, which the kernel is allowed to take.
template <typename TQ, typename TKV, bool kVec, int kAcc, bool kOwnV>
cudaError_t prepare(Shape* s, size_t* smem) {
  const int elem = static_cast<int>(sizeof(TKV));
  s->row_bytes = kVec ? 16 * (((s->d * elem + 15) / 16) | 1)
                      : (s->d | 1) * elem;
  s->pieces = s->gblock <= kWarps ? kWarps / s->gblock : 1;
  *smem = smem_bytes(*s);
  if (*smem > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(paged_attention_kernel<TQ, TKV, kVec, kAcc,
                                                     kOwnV>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

template <typename TQ, typename TKV, bool kVec, int kAcc, bool kOwnV>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* block_table, const int* context_lens, void* out,
           float* ws, const float* sinks, Shape s, cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t err = prepare<TQ, TKV, kVec, kAcc, kOwnV>(&s, &smem);
  if (err != cudaSuccess) return err;
  paged_attention_kernel<TQ, TKV, kVec, kAcc, kOwnV>
      <<<dim3(s.kv_heads * s.hblocks, s.b, s.parts), kThreads, smem,
         stream>>>(
          static_cast<const TQ*>(q), static_cast<const TKV*>(k_pages),
          static_cast<const TKV*>(v_pages), block_table, context_lens,
          static_cast<TQ*>(out), ws, sinks, s);
  err = cudaGetLastError();
  if (err != cudaSuccess || s.parts == 1) return err;
  paged_combine_kernel<TQ><<<dim3(s.h, s.b), kCombineThreads, 0, stream>>>(
      ws, context_lens, static_cast<TQ*>(out), sinks, s);
  return cudaGetLastError();
}

bool takes(int h, int d, int kv_heads, int dv, int q_dtype, int kv_dtype) {
  return kv_heads > 0 && h % kv_heads == 0 && h > 0 && d > 0 &&
         d <= kMaxDim && dv > 0 && dv <= d &&
         std::min(h / kv_heads, kHeadBlock) * dv <= kAccWide * kThreads &&
         q_dtype >= 0 && q_dtype <= 1 && kv_dtype >= 0 && kv_dtype <= 1;
}

// The shape's head blocks, value width, V rows and sinks; whether it takes
// the general launch (the wide accumulator), which alone reads V rows
// narrower than the K rows and sinks.
Shape shaped(Shape s, int dv, int shared, int v_row, int sinks) {
  s.dv = dv;
  s.shared = shared;
  s.gblock = std::min(s.groups, kHeadBlock);
  s.hblocks = (s.groups + s.gblock - 1) / s.gblock;
  s.v_row = shared ? s.d : v_row;
  s.sinks = sinks;
  return s;
}
bool wide(const Shape& s) {
  return s.shared || s.dv != s.d || s.v_row != s.d || s.sinks ||
         s.hblocks > 1 || s.gblock * s.dv > kAccNarrow * kThreads;
}
// A general launch whose V rows are not its K rows.
bool own_v(const Shape& s) { return wide(s) && !s.shared; }

// The 16-byte path for the K rows, the V rows and the V columns read.
bool vector_path(const Shape& s, int kv_dtype, bool aligned) {
  return vector_rows(s.d, kv_dtype, aligned) &&
         vector_rows(s.v_row, kv_dtype, aligned) &&
         vector_rows(s.dv, kv_dtype, aligned);
}

}  // namespace

// How many partition blocks an SM holds at once for these shapes and
// dtypes (`aligned`: both pools 16-byte aligned), into *blocks: what the
// wrapper's split plan sizes its waves by.
extern "C" int paged_attention_resident(int* blocks, int h, int d,
                                        int kv_heads, int aligned,
                                        int q_dtype, int kv_dtype, int dv,
                                        int shared, int v_row, int sinks,
                                        int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!takes(h, d, kv_heads, dv, q_dtype, kv_dtype) || v_row < dv ||
      v_row > d)
    return cudaErrorInvalidValue;
  Shape s = shaped(Shape{1, h, d, 1, kv_heads, 1, h / kv_heads, kTile, 1, 0,
                         0, 1.0f},
                   dv, shared, v_row, sinks);
  return dispatch(q_dtype, kv_dtype, vector_path(s, kv_dtype, aligned != 0),
                  wide(s), own_v(s),
                  [&](auto tq, auto tkv, auto vec, auto acc, auto ov) -> int {
                    using TQ = typename decltype(tq)::type;
                    using TKV = typename decltype(tkv)::type;
                    constexpr bool kV = decltype(vec)::value;
                    constexpr int kA = decltype(acc)::value;
                    constexpr bool kO = decltype(ov)::value;
                    size_t smem = 0;
                    cudaError_t e = prepare<TQ, TKV, kV, kA, kO>(&s, &smem);
                    if (e != cudaSuccess) return e;
                    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        blocks, paged_attention_kernel<TQ, TKV, kV, kA, kO>,
                        kThreads, smem);
                  });
}

// dtype codes: 0 = float32, 1 = bfloat16.  `parts` partitions of
// `part_len` positions per context (parts * part_len >= nblk * page,
// part_len a multiple of 32); with parts > 1, `ws` is (b, h, parts, dv + 2)
// f32 scratch; `out` is (b, h, dv), the values being the leading dv columns
// of the V pool's v_row-wide rows, and with `shared` the V rows are the K
// rows (v_pages is k_pages); `sinks` is (h,) f32 or null.  Returns a
// cudaError_t (0 = ok); cudaErrorInvalidValue for a shape the kernel does
// not take.
extern "C" int paged_attention(const void* q, const void* k_pages,
                               const void* v_pages, const int* block_table,
                               const int* context_lens, void* out, void* ws,
                               const float* sinks, int b, int h, int d,
                               int page, int kv_heads, int nblk, int part_len,
                               int parts, float scale, int q_dtype,
                               int kv_dtype, int dv, int v_row, int shared,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!takes(h, d, kv_heads, dv, q_dtype, kv_dtype) || page <= 0 ||
      nblk < 0 || parts < 1 || parts > 65535 || part_len <= 0 ||
      part_len % kTile != 0 ||
      static_cast<long long>(part_len) * parts <
          static_cast<long long>(nblk) * page ||
      (parts > 1 && ws == nullptr) ||
      (shared && (v_pages != k_pages || sinks != nullptr)) ||
      (!shared && (v_row < dv || v_row > d)))
    return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  const Shape s = shaped(Shape{b, h, d, page, kv_heads, nblk, h / kv_heads,
                               part_len, parts, 0, 0, scale},
                         dv, shared, v_row, sinks != nullptr);
  const bool aligned = reinterpret_cast<uintptr_t>(k_pages) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(v_pages) % 16 == 0;
  return dispatch(q_dtype, kv_dtype, vector_path(s, kv_dtype, aligned),
                  wide(s), own_v(s),
                  [&](auto tq, auto tkv, auto vec, auto acc, auto ov) -> int {
                    using TQ = typename decltype(tq)::type;
                    using TKV = typename decltype(tkv)::type;
                    return launch<TQ, TKV, decltype(vec)::value,
                                  decltype(acc)::value, decltype(ov)::value>(
                        q, k_pages, v_pages, block_table, context_lens, out,
                        static_cast<float*>(ws), sinks, s,
                        static_cast<cudaStream_t>(stream));
                  });
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
