// The fused segment loop for Hopper (sm_90a): one launch a segment.
//
// Replaces src/repro/core/schedule.py:SegmentRunner._fn (not a Pallas
// kernel: a jitted lax.scan over the segment's padded int32 (n, 3) table).
// Per row r, in row order, as the scan orders the legs:
//   * row[r][0] iterations of the burn, y <- (y @ x) * 0.5 + 0.25 (float32
//     with FMA, no TF32), y starting at x and carried across rows, so after
//     the segment y == burn_tile(x, iters = sum of row[.][0]);
//   * row[r][1] in-place passes over the memory atom's ring, continuing the
//     ring's pass counter (`start`) across rows and launches;
//   * row[r][2] steps of the collective atom's loop body (coll.cuh) on the
//     carried (n, COLL_BLOCK_ELEMS) float32 operand of a mesh-bound
//     segment, in place: the n shards of a mesh whose shards all live on
//     this card.
// Row r + 1 starts only when every CTA has finished row r: the emulator's
// sample barrier (core/emulator.py), here a grid barrier between non-empty
// rows.  Within a row the CTAs that own no burn panel start streaming while
// the others burn, so the two legs may overlap.  Rows with no work (zero
// rows, and the table's pow2 padding) are skipped without a barrier.
//
// Bound.  The burn's float32 FMA rate (2 T^3 flops an iteration at 67
// TFLOP/s), the ring's device-memory rate (2 * block bytes a pass at
// 3.35 TB/s) and the wire leg's latency: a step reads what the thread's
// last step wrote, so steps x one round trip to the carry's medium
// (coll.cuh; the byte bound, reading and writing n x 128 KiB once a step
// at L2's read rate, is 4x below it).  That trip, through the peer CTA's
// shared memory, is the leg's latency floor: 0.27 us a 2-shard
// all-reduce step on an H100 SXM at 700 W (0.39 us through L2), against
// 0.295 us a step in this kernel.  In sequence within a row as in the
// scan.
//
// Design.
//   * The compute leg is the burn's cluster design (burn.cuh, shared with
//     csrc/compute_atom.cu): 2-CTA clusters, each owning a 4-row panel of
//     y, x's column slice in registers, each row of the panel published
//     on its own mbarrier in each CTA, so the exchange of one row runs
//     under the FMAs of the others.  Panels never depend on each other,
//     so a burn needs no grid barrier.  The panel and its barriers stay
//     in shared memory across rows (a row's barrier phases follow the
//     iteration count, which runs on across rows); the CTAs write the
//     panel to `out` once, after the last row.  Tiles 64, 128 and 256
//     only: T / 2 CTAs burn (128 at tile 256, one an SM).
//   * The memory leg is the ring pass (ring.cuh): every CTA of the grid
//     owns a fixed slice of every slot, so pass p + 1 never waits on
//     another CTA's pass p and a row needs no barrier inside it.
//   * The wire leg is the collective loop body (coll.cuh): each thread of
//     the grid owns whole columns of the carry, all n shards of them, so a
//     step needs no barrier either.  For the length of the launch the
//     columns a thread owns live in the shared memory of the OTHER CTA of
//     its cluster (the carry's share, n x 1 KB a CTA at grid 132, past the
//     burn's), so every load and store of a step crosses the SM-to-SM
//     network instead of going to L2 and back: the round trip that bounds
//     a step is the shorter one (csrc/l2_probe.cu measures both).  After
//     the kernel's first cluster barrier, which every CTA then runs, each
//     thread copies its columns in from the global carry; after the last
//     row it copies them back out, and a last cluster barrier keeps every
//     CTA's shared memory alive until its peer is done with it.  Only a
//     launch with a carry takes the share (and above 48 KB the opt-in);
//     the main path's launches keep the burn's shared memory and grid.
//   * The grid is one CTA an SM, at most 2 * the active clusters that
//     cudaOccupancyMaxActiveClusters reports for the launch's shared
//     memory, and at least the burn's CTAs.
//   * The row barrier is cg::this_grid().sync(), so the kernel REQUIRES a
//     cooperative launch: cudaLaunchKernelEx with
//     cudaLaunchAttributeCooperative beside the cluster dimension, which
//     the driver takes only for a grid it can hold resident at once.  A
//     launch that is refused returns its error; there is no launch
//     without the attribute.  Segment launches of one process go to the
//     current stream (a thread fleet shares it), so they serialize;
//     kernels of other processes time-slice the card whole.
//   * Device counters: each CTA adds the burn iterations it ran, the ring
//     passes it streamed and the collective steps it took to counts[0],
//     counts[1] and counts[2] once, at its end; the host checks counts[0]
//     == sum(row[0]) * burn CTAs, counts[1] == sum(row[1]) * grid and
//     counts[2] == sum(row[2]) * grid after its sync.
//   * Row times: segment_kernel<T, true>, launched only while the host
//     traces, stamps the rows on %globaltimer (the device's nanosecond
//     clock): thread 0 of CTA 0 takes a stamp before the first row
//     (stamps[n_rows]) and one after each row's grid barrier, the end of
//     the row before it; after the loop each CTA's thread 0 takes the
//     largest of its CTA's end into the last row's stamp (atomicMax).
//     Skipped rows keep 0.  Each burning CTA's thread 0 (lane 0 of warp
//     0) also sums the ns it waited for a row of y (burn.cuh's Timed
//     wait) and the ns of its burns, row by row, and adds both to
//     stamps[n_rows + 1] and stamps[n_rows + 2] at its end.  The stamps
//     sit behind `if constexpr`, so segment_kernel<T, false> compiles to
//     the code it had before them.
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "burn.cuh"
#include "coll.cuh"
#include "ring.cuh"

namespace cg = cooperative_groups;

namespace {

using synapse::Burn;
using synapse::global_ns;
using synapse::kCluster;
using synapse::kCw;
using synapse::kRows;
using synapse::kThreads;

static_assert(synapse::kCollThreads == kThreads,
              "coll.cuh lays the carry's share out for the burn's CTAs");

// Timed: stamps (n_rows + 3) takes each row's end, the first row's start,
// and the burning CTAs' summed wait and burn ns; untimed, stamps is null
// and never read.
template <int T, bool Timed>
__global__ void __launch_bounds__(kThreads, 1)
    segment_kernel(const int* __restrict__ table, int n_rows,
                   const float* __restrict__ x, float* __restrict__ out,
                   float4* __restrict__ ring, int64_t nvec, int64_t slots,
                   int64_t start, int64_t total_ci, float* __restrict__ coll,
                   int64_t coll_n, int64_t coll_inner, int coll_kind,
                   unsigned long long* counts, unsigned long long* stamps) {
  using B = Burn<T>;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  // uniform within a cluster: B::kCtas is a multiple of kCluster
  const bool burns = total_ci > 0 && blockIdx.x < B::kCtas;
  const int64_t row0 = int64_t(blockIdx.x / kCluster) * kRows;
  extern __shared__ float4 smem4[];
  float* panel = reinterpret_cast<float*>(smem4);
  // the carry's share: the peer's threads' columns, past the burn's
  float* share = panel + B::kSmem / sizeof(float);
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int threads = gridDim.x * kThreads;
  float xr[B::KG][kCw];
  if (burns) {
    synapse::burn_load_x<T>(x, rank, xr);
    synapse::burn_load_panel<T>(x, row0, panel);
  }
  // no CTA stores into the other's shared memory, or signals its
  // barriers, before it has made them
  if (burns || coll != nullptr) cluster.sync();
  if (coll != nullptr) {
    synapse::coll_load_in(
        coll,
        synapse::peer_columns(share, rank ^ 1, int(coll_n), int(coll_inner),
                              t, threads),
        int(coll_inner), t, threads);
  }
  cg::grid_group grid = cg::this_grid();
  int64_t it = 0, pass = start, steps = 0;
  bool started = false;
  // the last row that ran; the ns thread 0 waited for y and burned
  // (Timed only)
  [[maybe_unused]] int last = -1;
  [[maybe_unused]] unsigned long long waited = 0, burned = 0;
  if constexpr (Timed) {
    if (blockIdx.x == 0 && threadIdx.x == 0) stamps[n_rows] = global_ns();
  }
  for (int r = 0; r < n_rows; ++r) {
    const int ci = table[3 * r];
    const int mi = table[3 * r + 1];
    const int wi = coll != nullptr ? table[3 * r + 2] : 0;
    if (ci <= 0 && mi <= 0 && wi <= 0) continue;
    if (started) grid.sync();
    if constexpr (Timed) {
      if (started && blockIdx.x == 0 && threadIdx.x == 0) {
        stamps[last] = global_ns();
      }
      last = r;
    }
    started = true;
    if (burns && ci > 0) {
      if constexpr (Timed) {
        const unsigned long long t0 = global_ns();
        synapse::burn_iterations<T, true>(xr, panel, rank, row0, it, ci,
                                          nullptr, &waited);
        burned += global_ns() - t0;
      } else {
        synapse::burn_iterations<T>(xr, panel, rank, row0, it, ci, nullptr);
      }
      it += ci;
    }
    if (mi > 0) {
      synapse::ring_passes(ring, nvec, slots, pass, mi, blockIdx.x,
                           gridDim.x);
      pass += mi;
    }
    if (wi > 0) {
      using synapse::opaque;
      synapse::coll_steps_peer(
          synapse::peer_columns(share, opaque(rank ^ 1), opaque(int(coll_n)),
                                opaque(int(coll_inner)), opaque(t),
                                opaque(threads)),
          opaque(coll_kind), wi);
      steps += wi;
    }
  }
  if constexpr (Timed) {
    // the CTA's end of the last row: every thread of it done
    __syncthreads();
    if (threadIdx.x == 0 && last >= 0) atomicMax(stamps + last, global_ns());
    if (threadIdx.x == 0 && burns) {
      atomicAdd(stamps + n_rows + 1, waited);
      atomicAdd(stamps + n_rows + 2, burned);
    }
  }
  if (burns) synapse::burn_store_panel<T>(panel, rank, row0, it, out);
  if (coll != nullptr) {
    synapse::coll_write_out(
        coll,
        synapse::peer_columns(share, rank ^ 1, int(coll_n), int(coll_inner),
                              t, threads),
        int(coll_inner), t, threads);
    // the peer reads this CTA's shared memory until here
    cluster.sync();
  }
  if (threadIdx.x == 0) {
    atomicAdd(counts, static_cast<unsigned long long>(burns ? it : 0));
    atomicAdd(counts + 1, static_cast<unsigned long long>(pass - start));
    atomicAdd(counts + 2, static_cast<unsigned long long>(steps));
  }
}

template <int T>
cudaLaunchConfig_t segment_config(int grid, size_t smem, cudaStream_t s,
                                  cudaLaunchAttribute (&attr)[2]) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cfg;
}

constexpr size_t kNoOptIn = 48 * 1024;

// info: grid CTAs, burn CTAs, active clusters the occupancy query allows
// for `smem` bytes of dynamic shared memory a CTA, smem.  Above 48 KB the
// kernel opts in to the device's whole per-CTA limit, always the same
// value, so a launch of another size on another thread never finds the
// attribute below its own size.
template <int T>
cudaError_t segment_grid(int device, size_t smem, int64_t* info) {
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (smem > kNoOptIn) {
    int optin = 0;
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    if (smem > size_t(optin)) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(segment_kernel<T, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err != cudaSuccess) return err;
    // the timed kernel launches on the grid this query gives
    err = cudaFuncSetAttribute(segment_kernel<T, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = segment_config<T>(kCluster, smem, nullptr, attr);
  cfg.numAttrs = 1;  // the query takes the cluster dimension alone
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, segment_kernel<T, false>,
                                       &cfg);
  if (err != cudaSuccess) return err;
  int grid_clusters = (sms + kCluster - 1) / kCluster;
  if (clusters < grid_clusters) grid_clusters = clusters;
  const int grid = kCluster * grid_clusters;
  if (grid < Burn<T>::kCtas) return cudaErrorCooperativeLaunchTooLarge;
  info[0] = grid;
  info[1] = Burn<T>::kCtas;
  info[2] = clusters;
  info[3] = static_cast<int64_t>(smem);
  return cudaSuccess;
}

size_t burn_smem(int64_t tile) {
  return tile == 64    ? Burn<64>::kSmem
         : tile == 128 ? Burn<128>::kSmem
                       : Burn<256>::kSmem;
}

// the occupancy query's answer per (tile, device, shared memory): a
// launch of one size asks once, and a wire launch, whose carry's share
// grows the shared memory, never takes the grid of a launch without one
std::mutex g_grid_lock;
std::map<std::tuple<int64_t, int, size_t>, std::tuple<int64_t, int64_t,
                                                      int64_t>>
    g_grid;

cudaError_t grid_for(int64_t tile, int device, size_t smem, int64_t* info) {
  if ((tile != 64 && tile != 128 && tile != 256) || device < 0) {
    return cudaErrorInvalidValue;
  }
  const auto key = std::make_tuple(tile, device, smem);
  {
    std::lock_guard<std::mutex> hold(g_grid_lock);
    const auto it = g_grid.find(key);
    if (it != g_grid.end()) {
      std::tie(info[0], info[1], info[2]) = it->second;
      info[3] = static_cast<int64_t>(smem);
      return cudaSuccess;
    }
  }
  const cudaError_t err = tile == 64    ? segment_grid<64>(device, smem, info)
                          : tile == 128 ? segment_grid<128>(device, smem, info)
                                        : segment_grid<256>(device, smem, info);
  if (err == cudaSuccess) {
    std::lock_guard<std::mutex> hold(g_grid_lock);
    g_grid[key] = std::make_tuple(info[0], info[1], info[2]);
  }
  return err;
}

// info[5]: a launch's grid, burn CTAs, active clusters, dynamic shared
// memory a CTA (the burn's, plus the carry's share when coll_n > 0) and
// the device's per-CTA limit.  The share depends on the grid (the columns
// a thread owns) and the grid on the share (occupancy), so a grid the
// share shrinks is sized again; an n whose share does not fit is refused.
cudaError_t plan_launch(int64_t tile, int device, int64_t coll_n,
                        int64_t coll_inner, int64_t* info) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  info[4] = optin;
  const size_t base = burn_smem(tile);
  err = grid_for(tile, device, base, info);
  if (err != cudaSuccess || coll_n == 0) return err;
  for (int tries = 0; tries < 4; ++tries) {
    const int64_t smem =
        int64_t(base) +
        synapse::coll_share_bytes(coll_n, coll_inner, info[0] * kThreads);
    if (smem > optin) return cudaErrorInvalidValue;
    const int64_t grid = info[0];
    err = grid_for(tile, device, size_t(smem), info);
    if (err != cudaSuccess || info[0] == grid) return err;
  }
  return cudaErrorInvalidConfiguration;
}

// the wire leg's carry: n shards of `inner` floats, stepped by `kind`
struct Coll {
  float* carry;
  int64_t n, inner;
  int kind;
};

template <int T>
cudaError_t launch(const int* table, int n_rows, const float* x, float* out,
                   float4* ring, int64_t nvec, int64_t slots, int64_t start,
                   int64_t total_ci, const Coll& coll,
                   unsigned long long* counts, unsigned long long* stamps,
                   int grid, size_t smem, cudaStream_t s) {
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg = segment_config<T>(grid, smem, s, attr);
  const auto kernel = stamps != nullptr ? &segment_kernel<T, true>
                                         : &segment_kernel<T, false>;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, table, n_rows, x, out, ring, nvec, slots, start, total_ci,
      coll.carry, coll.n, coll.inner, coll.kind, counts, stamps);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// info (int64[5]): the grid (CTAs) a segment at `tile` launches with a
// wire carry of coll_n shards of coll_inner float32 (coll_n 0: none), the
// CTAs that burn, the active clusters cudaOccupancyMaxActiveClusters
// allows, the dynamic shared memory a CTA takes, and the device's per-CTA
// limit.  Returns cudaErrorInvalidValue for a carry whose share does not
// fit beside the burn's.
extern "C" int synapse_segment_grid(int64_t tile, int64_t coll_n,
                                    int64_t coll_inner, int64_t device,
                                    void* info) {
  if (coll_n < 0 || (coll_n > 0 && coll_inner < 1)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  return plan_launch(tile, static_cast<int>(device), coll_n, coll_inner,
                     static_cast<int64_t*>(info));
}

// table: n_rows x 3 int32 on `device` (rows >= 0); x and out: tile x tile
// float32 (tile 64, 128 or 256), or null when no row burns (total_ci ==
// 0); ring: `slots` float32 blocks of n elements (n % 4 == 0), or null
// when no row streams; coll: the wire leg's carry, coll_n shards of
// coll_inner float32 each, stepped by the loop body of coll_kind (0
// all-reduce, 1 all-gather, 2 collective-permute), or null when no row
// takes collective steps (coll_n shards whose share fits beside the
// burn's: synapse_segment_grid); counts: 3 zeroed int64 on `device`;
// stamps: n_rows + 3 zeroed int64 on `device`, or null: with stamps the
// timed kernel runs and writes each row's end and the first row's start
// on the device's nanosecond clock, then the ns the burning CTAs waited
// for a row of y and the ns they burned, each summed over those CTAs.
// All but stamps 16-byte aligned.  One cooperative launch on `stream`;
// returns its error (a refused cooperative launch included), or
// cudaSuccess.
extern "C" int synapse_segment(const void* table, int64_t n_rows,
                               const void* x, void* out, void* ring,
                               int64_t n, int64_t slots, int64_t start,
                               int64_t tile, int64_t total_ci, void* coll,
                               int64_t coll_n, int64_t coll_inner,
                               int64_t coll_kind, void* counts, void* stamps,
                               int64_t device, void* stream) {
  if (n_rows < 1 || n_rows > (int64_t(1) << 30) || total_ci < 0 ||
      start < 0 || (ring != nullptr && (n <= 0 || n % 4 || slots < 1)) ||
      (total_ci > 0 && (x == nullptr || out == nullptr)) ||
      (coll != nullptr && (coll_n < 1 || coll_inner < 1 || coll_kind < 0 ||
                           coll_kind > 2))) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  int64_t info[5];
  err = plan_launch(tile, static_cast<int>(device), coll ? coll_n : 0,
                    coll_inner, info);
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>(info[0]);
  const size_t smem = static_cast<size_t>(info[3]);
  const int* t = static_cast<const int*>(table);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  float4* rf = static_cast<float4*>(ring);
  const Coll w = {static_cast<float*>(coll), coll_n, coll_inner,
                  static_cast<int>(coll_kind)};
  unsigned long long* c = static_cast<unsigned long long*>(counts);
  unsigned long long* st = static_cast<unsigned long long*>(stamps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = static_cast<int>(n_rows);
  switch (tile) {
    case 64:
      return launch<64>(t, rows, xf, of, rf, n / 4, slots, start, total_ci,
                        w, c, st, grid, smem, s);
    case 128:
      return launch<128>(t, rows, xf, of, rf, n / 4, slots, start, total_ci,
                         w, c, st, grid, smem, s);
    default:
      return launch<256>(t, rows, xf, of, rf, n / 4, slots, start, total_ci,
                         w, c, st, grid, smem, s);
  }
}
