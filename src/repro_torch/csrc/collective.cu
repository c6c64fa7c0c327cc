// The collective atom for Hopper (sm_90a): a mesh's collectives with every
// shard on one card.
//
// Replaces no Pallas kernel: the JAX package moves wire bytes with
// lax.psum / all_gather / ppermute under shard_map
// (src/repro/core/atoms.py:462-507, CollectiveAtom.loop_body and _coll_fn),
// which XLA lowers to the TPU's ICI.  Here the mesh's shards are one
// float32 tensor on the card, viewed as (outer, n, inner) with the mesh
// axis of n shards in the middle.  synapse_collective is the per-sample
// collective, out of place, as _coll_fn computes it: all-reduce (kind 0)
// writes the sum over the axis (no 1/n) to every shard; all-gather (kind
// 1) gives every shard all n blocks, out (outer, n, post, n, blk) from x
// (outer, n, post * blk) with out[o, i, p, k, j] = x[o, k, p * blk + j];
// collective-permute (kind 2) gives shard (i + 1) % n shard i's block.
// The fused loop body is not here: it runs inside the segment kernel
// (device code in coll.cuh, csrc/segment.cu).
//
// Bound.  Bytes: a call reads x once and writes its output once.  A
// per-sample plan's operand is n x the shard's bytes (gigabytes), so HBM's
// rate bounds a call, not NVLink's: on one card the emulated wire time is
// a device-memory time.
//
// Design.  One thread a column: the thread that owns column (o, q) reads
// its n elements and writes its outputs, so no step needs a barrier
// between threads or CTAs, and all three kinds share one index scheme.  A
// grid-stride loop over columns, two CTAs of 256 threads an SM.  Simple by
// intent: the per-sample call streams large operands at whatever rate one
// float a thread gives.
#include <cstdint>

#include <cuda_runtime.h>

#include "coll.cuh"  // the kind codes

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    collective_kernel(const float* __restrict__ x, float* __restrict__ out,
                      int64_t outer, int64_t n, int64_t post, int64_t blk,
                      int kind) {
  const int64_t inner = post * blk;
  const int64_t cols = outer * inner;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t c = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; c < cols;
       c += stride) {
    const int64_t o = c / inner;
    const int64_t q = c - o * inner;
    const float* xc = x + o * n * inner + q;
    if (kind == synapse::kAllReduce) {
      float s = 0.0f;
      for (int64_t i = 0; i < n; ++i) s += xc[i * inner];
      float* oc = out + o * n * inner + q;
      for (int64_t i = 0; i < n; ++i) oc[i * inner] = s;
    } else if (kind == synapse::kAllGather) {
      const int64_t p = q / blk;
      const int64_t j = q - p * blk;
      for (int64_t k = 0; k < n; ++k) {
        const float v = xc[k * inner];
        for (int64_t i = 0; i < n; ++i) {
          out[(((o * n + i) * post + p) * n + k) * blk + j] = v;
        }
      }
    } else {
      float* oc = out + o * n * inner + q;
      for (int64_t i = 0; i < n; ++i) {
        oc[((i + 1) % n) * inner] = xc[i * inner];
      }
    }
  }
}

cudaError_t grid_for(int64_t cols, int64_t device, int* grid) {
  int sms = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, static_cast<int>(device));
  if (err != cudaSuccess) return err;
  int64_t blocks = (cols + kThreads - 1) / kThreads;
  if (blocks > 2 * int64_t(sms)) blocks = 2 * int64_t(sms);
  *grid = static_cast<int>(blocks < 1 ? 1 : blocks);
  return cudaSuccess;
}

}  // namespace

// x: outer x n x (post * blk) float32 on `device`; out: outer x n x post x
// n x blk for all-gather (kind 1), else the shape of x; out must not alias
// x.  One launch on `stream`; returns its error, or cudaSuccess.
extern "C" int synapse_collective(const void* x, void* out, int64_t outer,
                                  int64_t n, int64_t post, int64_t blk,
                                  int64_t kind, int64_t device,
                                  void* stream) {
  if (outer < 1 || n < 1 || post < 1 || blk < 1 || kind < 0 || kind > 2) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  int grid = 1;
  err = grid_for(outer * post * blk, device, &grid);
  if (err != cudaSuccess) return err;
  collective_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), outer, n, post,
      blk, static_cast<int>(kind));
  return cudaGetLastError();
}
