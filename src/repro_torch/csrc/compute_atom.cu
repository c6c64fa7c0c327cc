// Compute-atom burn for Hopper (sm_90a), float32.
//
// Replaces src/repro/kernels/compute_atom/kernel.py:burn_tile (the Pallas
// _burn_kernel): y <- (y @ x) * 0.5 + 0.25, `iters` times, with y0 = x and
// x fixed; 2 * tile^3 flops an iteration.
//
// Bound.  In principle the float32 FMA rate: 33.5 MFLOP an iteration at
// tile 256, about 0.5 us at the H100's 67 TFLOP/s outside the tensor cores.
// In practice launch latency: one iteration is one launch of a few
// microseconds.
//
// Design.  The TPU kernel keeps the whole tile resident in VMEM.  A 256x256
// float32 tile is 256 KiB per operand, more than the 227 KB of shared memory
// one block can use, so that does not carry over.  Here one launch computes
// one iteration over a 2-D grid of 16x16 output blocks: each thread produces
// one element of y @ x, staging 16x16 slices of y and x through shared
// memory, and applies the epilogue.  The host function ping-pongs between
// two buffers the caller allocates, so the last iteration lands in `out`;
// x and both buffers (768 KiB at tile 256) stay resident in L2 between
// launches.  Exact float32 with FMA: no TF32 and no tensor cores, so the
// result matches the plain float32 matmul chain to 1e-5.  `iters` is a
// run-time argument.  A cluster or persistent design is later work.
#include <cstdint>

#include <cuda_runtime.h>

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

}  // namespace

// x, out and scratch are tile*tile float32 arrays on `device`; out and
// scratch must not alias x.  Launches `iters` >= 1 kernels on `stream` and
// returns the first launch error, or cudaSuccess.
extern "C" int synapse_burn_tile(const void* x, void* out, void* scratch,
                                 int64_t tile, int64_t iters, int64_t device,
                                 void* stream) {
  if (tile <= 0 || tile > (1 << 15) || iters < 1) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const float* xf = static_cast<const float*>(x);
  float* bufs[2] = {static_cast<float*>(out), static_cast<float*>(scratch)};
  const dim3 block(kBlock, kBlock);
  const int g = static_cast<int>((tile + kBlock - 1) / kBlock);
  const dim3 grid(g, g);
  const float* src = xf;
  for (int64_t k = 0; k < iters; ++k) {
    float* dst = bufs[(iters - 1 - k) % 2];  // the last one lands in out
    burn_step<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        src, xf, dst, static_cast<int>(tile));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaSuccess;
}
