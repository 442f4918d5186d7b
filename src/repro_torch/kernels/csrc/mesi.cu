// Two-level MESI + tier cache state machine over a (B, N) trace batch.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/cache_sim.py:
// `mesi_cache_sim` (grid body `_mesi_kernel`) and `mesi_segment` (grid body
// `_mesi_segment_kernel`), which share the per-access body `_mesi_access`.
// One kernel serves both: it advances the engine's packed carry
// (l1p, l2p, stats, t) over one trace segment, and a fresh carry gives the
// whole-trace simulation.  The reference it must equal bit for bit is
// repro_torch.core.cache._packed_step (and repro.core.cache._packed_step).
//
// What bounds it: the serial dependency chain, not bytes.  Every access
// reads the cache state the previous access wrote, so a row is one long
// chain of dependent loads, compares and stores; the trace itself is
// 16 bytes per access and the state is read and written once.
//
// What the design does about it:
//   * one warp (32 lanes) per batch row, one block per row; lanes span
//     the ways (the per-access body, shared with mesi_dyn.cu, is in
//     mesi_access.cuh);
//   * the L1 planes (3 * cores * l1_sets * l1_ways ints, 12 KiB per core at
//     the Table-I geometry) live in shared memory when they fit, else in
//     global memory; the L2 planes (640 KiB at Table-I) stay in global
//     memory, where the card's 50 MB L2 cache holds them for B <= ~70 rows;
//   * the trace is fetched 32 accesses at a time by coalesced loads and
//     broadcast from registers by shuffles, so no trace load sits on the
//     chain; an L1 hit and a sentinel touch no L2 state at all;
//   * only B SMs are busy: the card is mostly idle at B <= 12.  Spreading a
//     row over several SMs is later work.
//
// Sentinel entries (addr == -1) change nothing, but the clock advances
// across them.

#include "mesi_access.cuh"

namespace {

using mesi::Geometry;
using mesi::kFull;
using mesi::kSentinel;

__global__ void __launch_bounds__(32) mesi_segment_kernel(
    const int* __restrict__ addr, const int* __restrict__ is_write,
    const int* __restrict__ core, const int* __restrict__ tier,
    const int* __restrict__ t0, int n, int* __restrict__ l1p,
    int* __restrict__ l2p, int* __restrict__ stats, Geometry g,
    int l1_in_smem) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x;
  const long row = blockIdx.x;
  const int ns = 8 + 2 * g.n_targets;
  const long l1_len = static_cast<long>(g.cores) * g.s1 * g.w1 * 3;
  const long l2_len = static_cast<long>(g.s2) * g.w2 * 5;

  int* st = smem;  // the row's counters
  int* l1 = l1p + row * l1_len;
  int* const l2 = l2p + row * l2_len;
  for (int k = lane; k < ns; k += 32) st[k] = stats[row * ns + k];
  if (l1_in_smem) {
    int* l1s = smem + ((ns + 3) & ~3);
    for (long k = lane; k < l1_len; k += 32) l1s[k] = l1[k];
    l1 = l1s;
  }
  __syncwarp();

  const int* ra = addr + row * n;
  const int* rw = is_write + row * n;
  const int* rc = core + row * n;
  const int* rt = tier + row * n;
  int t = t0[row];

  for (int base = 0; base < n; base += 32) {
    int ca = kSentinel, cw = 0, cc = 0, ct = 0;
    if (base + lane < n) {
      ca = ra[base + lane];
      cw = rw[base + lane];
      cc = rc[base + lane];
      ct = rt[base + lane];
    }
    const int m = min(32, n - base);
    for (int j = 0; j < m; ++j, ++t) {
      const int a = __shfl_sync(kFull, ca, j);
      const bool w = __shfl_sync(kFull, cw, j) != 0;
      const int c = __shfl_sync(kFull, cc, j);
      const int tr = __shfl_sync(kFull, ct, j);
      if (a == kSentinel) continue;  // warp-uniform: padding touches nothing
      mesi::mesi_access(a, w, c, tr, t, 1, l1, l2, st, g, lane);
    }
  }

  for (int k = lane; k < ns; k += 32) stats[row * ns + k] = st[k];
  if (l1_in_smem) {
    int* out = l1p + row * l1_len;
    for (long k = lane; k < l1_len; k += 32) out[k] = l1[k];
  }
}

}  // namespace

// Advance the carry (l1p, l2p, stats) of `b` rows in place over an
// (b, n) int32 trace; `t0` holds each row's clock before the segment.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int mesi_segment(const int* addr, const int* is_write,
                            const int* core, const int* tier, const int* t0,
                            int* l1p, int* l2p, int* stats, int b, int n,
                            int cores, int l1_sets, int l1_ways, int l2_sets,
                            int l2_ways, int n_targets, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (b == 0 || n == 0) return cudaSuccess;
  int smem_max = 0;
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const Geometry g{cores, l1_sets, l1_ways, l2_sets, l2_ways, n_targets};
  const size_t stats_bytes = static_cast<size_t>((8 + 2 * n_targets + 3) & ~3)
                             * sizeof(int);
  const size_t l1_bytes =
      static_cast<size_t>(cores) * l1_sets * l1_ways * 3 * sizeof(int);
  const int l1_in_smem =
      stats_bytes + l1_bytes <= static_cast<size_t>(smem_max) ? 1 : 0;
  const size_t smem = stats_bytes + (l1_in_smem ? l1_bytes : 0);
  err = cudaFuncSetAttribute(mesi_segment_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  mesi_segment_kernel<<<b, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      addr, is_write, core, tier, t0, n, l1p, l2p, stats, g, l1_in_smem);
  return cudaGetLastError();
}

extern "C" const char* mesi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
