// Memory-atom stream pass for Hopper (sm_90a), float32 and bfloat16.
//
// Replaces src/repro/kernels/memory_atom/kernel.py:stream_pass (the Pallas
// _stream_kernel): one out-of-place read, scale by 1.0000001, write pass
// over a 1-D array; the host function runs `passes` of them.
//
// Bound.  Bytes: a pass reads n * itemsize bytes and writes as many, so
// 2 * n * itemsize over device-memory bandwidth (3.35 TB/s on an H100
// SXM) -- or over L2's rate when both ping-pong buffers fit in the 50 MB L2,
// as the memory atom's default 16 MiB block does.
//
// Design.  16-byte vector loads and stores (4 float32 or 8 bfloat16 a
// thread) in a grid-stride loop, with a scalar loop for a tail that is not a
// whole vector.  The grid is sized to fill every SM, whatever `block` the
// caller validated: on the TPU `block` sets the VMEM tile, and the atom's
// default makes it the whole array, a grid of one step.  bfloat16 is scaled
// in float32 and rounded to nearest even, as PyTorch rounds it.  `passes`
// ping-pong between two buffers the caller allocates, so every pass really
// reads and writes device memory and the last one lands in `out`.
//
// That chain is the function the JAX package's `stream` computes, and the
// parity tests hold it; but a pass that reads the block the previous pass
// wrote reads L2, whichever buffer holds it.  The memory atom therefore
// streams through the ring entry below (synapse_stream_ring, device code
// in ring.cuh): in-place passes over a ring of blocks several times the
// L2's size, all of a call's passes in one launch, so each pass reads and
// writes device memory.  Its bound is 2 * block bytes a pass over HBM's
// 3.35 TB/s: 10.02 us at the atom's 16 MiB block.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ring.cuh"

namespace {

constexpr float kScale = 1.0000001f;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__global__ void stream_f32(const float* __restrict__ in,
                           float* __restrict__ out, int64_t n) {
  const int64_t nvec = n / 4;
  const float4* in4 = reinterpret_cast<const float4*>(in);
  float4* out4 = reinterpret_cast<float4*>(out);
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t first = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int64_t i = first; i < nvec; i += stride) {
    float4 v = in4[i];
    v.x *= kScale;
    v.y *= kScale;
    v.z *= kScale;
    v.w *= kScale;
    out4[i] = v;
  }
  for (int64_t i = nvec * 4 + first; i < n; i += stride) {
    out[i] = in[i] * kScale;
  }
}

__global__ void stream_bf16(const __nv_bfloat16* __restrict__ in,
                            __nv_bfloat16* __restrict__ out, int64_t n) {
  const int64_t nvec = n / 8;
  const uint4* in4 = reinterpret_cast<const uint4*>(in);
  uint4* out4 = reinterpret_cast<uint4*>(out);
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t first = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int64_t i = first; i < nvec; i += stride) {
    uint4 v = in4[i];
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      h[j] = __floats2bfloat162_rn(f.x * kScale, f.y * kScale);
    }
    out4[i] = v;
  }
  for (int64_t i = nvec * 8 + first; i < n; i += stride) {
    out[i] = __float2bfloat16_rn(__bfloat162float(in[i]) * kScale);
  }
}

__global__ void __launch_bounds__(kThreads)
    stream_ring(float4* __restrict__ ring, int64_t nvec, int64_t slots,
                int64_t start, int64_t passes) {
  synapse::ring_passes(ring, nvec, slots, start, passes, blockIdx.x,
                       gridDim.x);
}

}  // namespace

// The L2 cache's size in bytes (cudaDevAttrL2CacheSize), or minus the CUDA
// error code.
extern "C" int64_t synapse_l2_cache_bytes(int64_t device) {
  int bytes = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrL2CacheSize, static_cast<int>(device));
  return err == cudaSuccess ? int64_t(bytes) : -int64_t(err);
}

// ring is `slots` float32 blocks of n elements each, back to back, on
// `device`, 16-byte aligned, n % 4 == 0.  Runs `passes` >= 1 in-place ring
// passes, numbered start .. start + passes - 1 (pass p scales slot
// p % slots), in one launch on `stream`.  Returns the launch error, or
// cudaSuccess.
extern "C" int synapse_stream_ring(void* ring, int64_t n, int64_t slots,
                                   int64_t start, int64_t passes,
                                   int64_t device, void* stream) {
  if (n <= 0 || n % 4 || slots < 1 || start < 0 || passes < 1) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               static_cast<int>(device));
  if (err != cudaSuccess) return err;
  // two CTAs an SM: each owns a slice of every slot, so the grid needs no
  // co-residency and no barrier
  stream_ring<<<2 * sms, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float4*>(ring), n / 4, slots, start, passes);
  return cudaGetLastError();
}

// x, out and scratch are n-element arrays on `device`, 16-byte aligned, of
// float32 (dtype 0) or bfloat16 (dtype 1); out and scratch must not alias x.
// Launches `passes` >= 1 kernels on `stream` and returns the first launch
// error, or cudaSuccess.
extern "C" int synapse_stream_pass(const void* x, void* out, void* scratch,
                                   int64_t n, int64_t dtype, int64_t passes,
                                   int64_t device, void* stream) {
  if (n <= 0 || passes < 1 || (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const int64_t per_thread = dtype == 0 ? 4 : 8;
  const int64_t work = (n + per_thread - 1) / per_thread;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = int64_t(sms) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* src = x;
  void* bufs[2] = {out, scratch};
  for (int64_t p = 0; p < passes; ++p) {
    void* dst = bufs[(passes - 1 - p) % 2];  // the last one lands in out
    if (dtype == 0) {
      stream_f32<<<static_cast<int>(blocks), kThreads, 0, s>>>(
          static_cast<const float*>(src), static_cast<float*>(dst), n);
    } else {
      stream_bf16<<<static_cast<int>(blocks), kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(src),
          static_cast<__nv_bfloat16*>(dst), n);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaSuccess;
}
