// Blockwise causal / windowed attention with an online softmax.
//
// Replaces the Pallas TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention.py (grid body `_flash_kernel`).  It
// computes what the JAX oracle `repro.kernels.ref.flash_attention`
// computes, and the plain version it is held against is
// repro_torch.kernels.flash_attention.flash_attention_ref:
//
//   out[bh, r] = sum_j softmax_j(scale * <q[bh, r], k[bh, j]>) v[bh, j]
//
// over the keys j live for row r.  Positions are end-aligned: row r sits at
// qpos = r + Sk - Sq.  Causal: j <= qpos; with a window W also j > qpos - W.
// A row with no live key gives 0.  The logits are scaled after the product
// (as the oracle, not the Pallas body, does it); heads are pre-broadcast by
// the caller (GQA), so q, k and v have the same B * H heads.
//
// What bounds it: at long sequences, operations.  Each live (row, key) pair
// costs 4 * D flops (the logit and the value sum), each input is read once
// and the output written once; at h2o-danube-3-4b's prefill width (1, 32,
// 4096, 120) bf16, causal, 1.29e11 flops take 0.130 ms at the card's 989
// TFLOP/s (bf16 tensor cores), while its 126 MB take 0.038 ms at 3.35 TB/s.
//
// What the design does about it (a simple first kernel, right before fast:
// it runs on the CUDA cores in f32, several times the bound):
//   * one block of 256 threads per (query tile of 64 rows, head): grid
//     (ceil(Sq / 64), B * H), 2048 blocks at the danube prefill shape;
//   * the key tiles (64 keys) that lie wholly outside the causal / window
//     band of the query tile are skipped, not masked: the loop runs from the
//     tile of the band's first key to that of its last, so the work is
//     O(S * W), not O(S^2); inside a tile the band is masked per pair;
//   * each K and V tile is staged in shared memory in f32 (rows padded to an
//     odd stride, so the 16 rows read together hit distinct banks);
//   * thread (ty, tx) of a 16 x 16 layout owns rows ty + 16 i (i < 4):
//     the logits of keys tx + 16 j (j < 4) and the output columns
//     tx + 16 c (c < 8, D <= 128, a masked tail for D = 120); a row's max
//     and sum are 4-step shuffles within its 16 lanes, so m and l stay in
//     registers; the probabilities go through shared memory to the P * V
//     product, accumulated in f32 registers;
//   * -inf marks masked logits, and a row whose running max is still -inf
//     contributes nothing, so no exp(-inf - -inf) arises.
// Tensor cores (mma.sync / wgmma), TMA and double buffering are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

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

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
