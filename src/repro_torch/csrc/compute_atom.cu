// Compute-atom burn for Hopper (sm_90a), float32.
//
// Replaces src/repro/kernels/compute_atom/kernel.py:burn_tile (the Pallas
// _burn_kernel): y <- (y @ x) * 0.5 + 0.25, `iters` times, with y0 = x and
// x fixed; 2 * tile^3 flops an iteration.
//
// Bound.  The float32 FMA rate: 33.5 MFLOP an iteration at tile 256, about
// 0.5 us at the H100's 67 TFLOP/s outside the tensor cores.  Exact float32
// with FMA: no TF32 and no tensor cores, so the result matches the plain
// float32 matmul chain to 1e-5.
//
// Design: one launch a burn (tiles 64, 128 and 256).  The chain has no
// dependency between rows: y_{t+1}[R, :] = (y_t[R, :] @ x) * 0.5 + 0.25, so
// a group of blocks that owns a row panel R never needs another group's
// rows and a whole burn runs in one launch with no grid-wide barrier.  A
// thread-block cluster of 2 CTAs owns a panel of 4 rows (64 clusters, 128
// CTAs at tile 256); CTA j computes the columns C_j = [j tile/2,
// (j+1) tile/2) of the panel.  The TPU kernel keeps x resident in VMEM;
// here x's column slice x[:, C_j] stays in the CTA's registers for the
// whole burn (128 floats a thread at tile 256): warp w owns tile/16 of
// the columns, each lane 4 of them and a k range of x's rows (tile/8 rows
// at tile 256, the 8 lanes of a column group covering all tile), so a
// row's dot products are summed over the warp's own lanes by shuffles.
// The dependency that orders the work is per row: y_{t+1}[r, :] needs
// only y_t[r, :].  So each row of the panel is published on its own
// mbarrier in each CTA (the peer's columns arrive by st.async, counted in
// bytes on the barrier), and a warp waits only for the row it is about to
// read: while one row's sums cross the lanes and the cluster, the warps
// run the FMAs of the panel's three other rows.  An exchange is a
// latency, not work: on an H100, a design that summed the warps' partials
// through shared memory behind __syncthreads and one cluster barrier an
// iteration spent ~1,450 SM cycles in it at every tile, about three
// rows' FMAs at tile 256, with no FMA running.  (The cluster's device code
// is in burn.cuh, shared with csrc/segment.cu.)
// The panel is double-buffered, so a row's barrier also keeps a CTA from
// overwriting a copy that a warp still reads.  Each 4 floats of y a lane
// loads from shared memory feed 16 FMAs, one for each of its 4 columns
// (the shared-memory loads bound an FMA step that feeds fewer).  Why 2
// CTAs: half of x is what a CTA's registers hold (32768 floats over 256
// threads at tile 256), so 2 is the fewest that keep x in registers, and
// a row's exchange crosses to one peer only.
//
// Other tiles (a multiple of 8, up to 2^15) take the per-iteration kernel:
// one launch an iteration over 16x16 output blocks, ping-ponging between
// `out` and `scratch` with x in L2.  The choice is by shape, here.
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "burn.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 16;

__global__ void burn_step(const float* __restrict__ y,
                          const float* __restrict__ x,
                          float* __restrict__ out, int tile) {
  __shared__ float ys[kBlock][kBlock];
  __shared__ float xs[kBlock][kBlock];
  const int row = blockIdx.y * kBlock + threadIdx.y;
  const int col = blockIdx.x * kBlock + threadIdx.x;
  float acc = 0.0f;
  for (int k0 = 0; k0 < tile; k0 += kBlock) {
    const int ky = k0 + threadIdx.x;  // column of y this thread stages
    const int kx = k0 + threadIdx.y;  // row of x this thread stages
    ys[threadIdx.y][threadIdx.x] =
        (row < tile && ky < tile) ? y[int64_t(row) * tile + ky] : 0.0f;
    xs[threadIdx.y][threadIdx.x] =
        (kx < tile && col < tile) ? x[int64_t(kx) * tile + col] : 0.0f;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBlock; ++k) {
      acc = fmaf(ys[threadIdx.y][k], xs[k][threadIdx.x], acc);
    }
    __syncthreads();
  }
  if (row < tile && col < tile) {
    // acc * 0.5 is exact, so the fused form rounds like the two-step one
    out[int64_t(row) * tile + col] = fmaf(acc, 0.5f, 0.25f);
  }
}

cudaError_t burn_per_iteration(const float* x, float* out, float* scratch,
                               int tile, int64_t iters, cudaStream_t s) {
  float* bufs[2] = {out, scratch};
  const dim3 block(kBlock, kBlock);
  const int g = (tile + kBlock - 1) / kBlock;
  const float* src = x;
  for (int64_t k = 0; k < iters; ++k) {
    float* dst = bufs[(iters - 1 - k) % 2];  // the last one lands in out
    burn_step<<<dim3(g, g), block, 0, s>>>(src, x, dst, tile);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaSuccess;
}

using synapse::Burn;
using synapse::kCluster;
using synapse::kCw;
using synapse::kRows;
using synapse::kThreads;

template <int T>
__global__ void __launch_bounds__(kThreads)
    burn_cluster(const float* __restrict__ x, float* __restrict__ out,
                 int64_t iters) {
  using B = Burn<T>;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());  // slice C_rank
  const int64_t row0 = int64_t(blockIdx.x / kCluster) * kRows;
  extern __shared__ float4 smem4[];
  float* panel = reinterpret_cast<float*>(smem4);  // [2][kRows][P], barriers
  float xr[B::KG][kCw];
  synapse::burn_load_x<T>(x, rank, xr);
  synapse::burn_load_panel<T>(x, row0, panel);
  // also: no CTA stores into the other's shared memory, or signals its
  // barriers, before it has made them
  cluster.sync();
  synapse::burn_iterations<T>(xr, panel, rank, row0, 0, iters, out);
}

template <int T>
cudaError_t burn_one_launch(const float* x, float* out, int64_t iters,
                            cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * (T / kRows), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = Burn<T>::kSmem;  // 9.1 KB at most: no opt-in
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, burn_cluster<T>, x, out, iters);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// The kernels synapse_burn_tile launches for a burn: one for the tiles that
// take the cluster kernel, `iters` for any other tile.
extern "C" int64_t synapse_burn_tile_launches(int64_t tile, int64_t iters) {
  return tile == 64 || tile == 128 || tile == 256 ? 1 : iters;
}

// x, out and scratch are tile*tile float32 arrays on `device`, 16-byte
// aligned; out and scratch must not alias x.  tile is a multiple of 8.
// Tiles 64, 128 and 256 run all `iters` >= 1 iterations in one launch and
// leave scratch untouched; other tiles launch one kernel an iteration.
// Returns the first launch error, or cudaSuccess.
extern "C" int synapse_burn_tile(const void* x, void* out, void* scratch,
                                 int64_t tile, int64_t iters, int64_t device,
                                 void* stream) {
  if (tile <= 0 || tile > (1 << 15) || tile % 8 || iters < 1) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 64:
      return burn_one_launch<64>(xf, of, iters, s);
    case 128:
      return burn_one_launch<128>(xf, of, iters, s);
    case 256:
      return burn_one_launch<256>(xf, of, iters, s);
    default:
      return burn_per_iteration(xf, of, static_cast<float*>(scratch),
                                static_cast<int>(tile), iters, s);
  }
}
