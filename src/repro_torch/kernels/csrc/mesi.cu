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
// reads the cache state an earlier access of the same sets wrote; the trace
// is 16 bytes per access and the state is read and written once.
//
// What the design does about it: it splits each row into independent set
// chains (mesi_chain.cuh) and walks them in parallel.
//   * m = 2**bits chains per row (the wrapper picks min(l1_sets, l2_sets),
//     128 at the Table-I geometry); one warp per chain, lanes spanning the
//     ways (the per-access body, shared with mesi_dyn.cu, is in
//     mesi_access.cuh); four chain warps per block, the grid over (chain
//     group, row): the Table-I STREAM suite's B = 4 rows give 512 warps
//     where one warp per row gave 4;
//   * a chain's sets (at Table-I one L1 set per core and 16 L2 sets, about
//     5 KiB) live in shared memory for the whole launch, so no L1 miss
//     walks global memory; where they do not fit, the row's planes stay in
//     global memory, where chains touch disjoint cells;
//   * each chain's accesses come from the bucket pre-pass
//     (mesi_chain.cuh), which this entry runs before the chains: in row
//     order, 16-byte records read 32 at a time, the next batch loaded
//     while this one runs;
//   * the clock of the access at row position i is t0 + i, as in the
//     whole-row walk; counters are kept per chain in shared memory and
//     added into the row's with integer atomics at the end.
//
// Sentinel entries (addr == -1) change nothing; the clock counts them.

#include "mesi_chain.cuh"

namespace {

using mesi::Geometry;
using mesi::kFull;
using mesi::Rec;

__global__ void __launch_bounds__(mesi::kChainWarps * 32) mesi_chain_kernel(
    const int* __restrict__ t0, const Rec* __restrict__ rec,
    const int* __restrict__ start, int n, int* __restrict__ l1p,
    int* __restrict__ l2p, int* __restrict__ stats, Geometry g, int bits,
    int l1_smem, int l2_smem) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long row = blockIdx.y;
  const int m = 1 << bits;
  const int chain = blockIdx.x * blockDim.x / 32 + warp;
  if (chain >= m) return;  // no block-wide barrier below
  const int ns = 8 + 2 * g.n_targets;
  const long l1_len = static_cast<long>(g.cores) * g.s1 * g.w1 * 3;
  const long l2_len = static_cast<long>(g.s2) * g.w2 * 5;
  const int words = mesi::stats_words(g)
                    + l1_smem * mesi::l1_chain_words(g, bits)
                    + l2_smem * mesi::l2_chain_words(g, bits);

  int* st = smem + warp * words;  // the chain's counter deltas
  for (int k = lane; k < ns; k += 32) st[k] = 0;
  int* g_l1 = l1p + row * l1_len;
  int* g_l2 = l2p + row * l2_len;
  const mesi::Planes pl =
      mesi::load_chain(st + mesi::stats_words(g), g_l1, g_l2, g, bits, chain,
                       l1_smem, l2_smem, lane);
  const unsigned t_row = static_cast<unsigned>(t0[row]);
  auto access = [&](int pos, int a, bool w, int c, int tr) {
    mesi::mesi_access(a, w, c, tr, static_cast<int>(t_row + pos), 1, pl, st,
                      g, lane);
  };

  const Rec* rr = rec + row * n;
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

  mesi::store_chain(pl, g_l1, g_l2, g, bits, chain, lane);
  for (int k = lane; k < ns; k += 32)
    if (st[k] != 0) atomicAdd(stats + row * ns + k, st[k]);
}

mesi::Layout plan(const Geometry& g, int bits, int device, int* sms,
                  cudaError_t* err) {
  int smem_max = 0;
  *err = cudaDeviceGetAttribute(&smem_max,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                device);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                  device);
  const mesi::Layout lay =
      mesi::choose_layout(g, bits, static_cast<size_t>(smem_max));
  if (*err == cudaSuccess && !lay.fits) *err = cudaErrorLaunchOutOfResources;
  return lay;
}

}  // namespace

// The launch's shape for rows split into 2**bits chains: out[0..6] =
// bits, chain warps per block, blocks per row, L1 sets in shared memory
// (0/1), L2 sets in shared memory, shared-memory bytes per block, the
// card's SM count.  Returns a CUDA error code (0 on success).
extern "C" int mesi_plan(int* out, int cores, int l1_sets,
                         int l1_ways, int l2_sets, int l2_ways, int n_targets,
                         int bits, int device) {
  const Geometry g{cores, l1_sets, l1_ways, l2_sets, l2_ways, n_targets};
  cudaError_t err;
  int sms = 0;
  const mesi::Layout lay = plan(g, bits, device, &sms, &err);
  const int groups = ((1 << bits) + lay.warps - 1) / lay.warps;
  const int vals[7] = {bits, lay.warps, groups, lay.l1_smem, lay.l2_smem,
                       static_cast<int>(lay.smem), sms};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return err;
}

// The bucket pre-pass alone (mesi_segment and mesi_dyn_segment run it
// first), for timing it: fills rec (b, n, 4) and start (b, 2**bits + 1)
// of a (b, n) int32 trace split into 2**bits chains, with hist
// (b, ceil(n / tile), 2**bits) as scratch.  Launches on `stream`.
extern "C" int mesi_bucket(const int* addr, const int* is_write,
                           const int* core, const int* tier, int b,
                           long long n, int bits, int tile, int* hist,
                           int* start, int* rec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (b == 0 || n == 0) return cudaSuccess;
  return mesi::launch_bucket(addr, is_write, core, tier, b, n, bits, tile,
                             hist, start, rec,
                             static_cast<cudaStream_t>(stream));
}

// Advance the carry (l1p, l2p, stats) of `b` rows in place over an
// (b, n) int32 trace; `t0` holds each row's clock before the segment.  Each
// row splits into 2**bits chains, whose accesses the bucket pre-pass
// gathers first into rec (b, n, 4) and start (b, 2**bits + 1), with hist
// (b, ceil(n / tile), 2**bits) as scratch.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int mesi_segment(const int* addr, const int* is_write,
                            const int* core, const int* tier, const int* t0,
                            int* hist, int* start, int* rec, int* l1p,
                            int* l2p, int* stats, int b, int n, int cores,
                            int l1_sets, int l1_ways, int l2_sets,
                            int l2_ways, int n_targets, int bits, int tile,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (b == 0 || n == 0) return cudaSuccess;
  const Geometry g{cores, l1_sets, l1_ways, l2_sets, l2_ways, n_targets};
  int sms = 0;
  const mesi::Layout lay = plan(g, bits, device, &sms, &err);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mesi_chain_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(lay.smem));
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = mesi::launch_bucket(addr, is_write, core, tier, b, n, bits, tile,
                            hist, start, rec, s);
  if (err != cudaSuccess) return err;
  const dim3 grid(((1 << bits) + lay.warps - 1) / lay.warps, b);
  mesi_chain_kernel<<<grid, lay.warps * 32, lay.smem, s>>>(
      t0, reinterpret_cast<const Rec*>(rec), start, n, l1p, l2p, stats, g,
      bits, lay.l1_smem, lay.l2_smem);
  return cudaGetLastError();
}

extern "C" const char* mesi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
