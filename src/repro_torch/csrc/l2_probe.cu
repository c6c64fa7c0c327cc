// L2 read-rate probe for Hopper (sm_90a).  A measuring tool, not a port of a
// TPU kernel: chip_smoke.py uses the rate it reads as the bound of a memory
// pass whose buffers fit in the 50 MB L2, where the device-memory rate would
// not bound it.
//
// Reads an n-element float32 array `reps` times with 16-byte loads that
// bypass L1 (ld.global.cg), so after the first rep a buffer that fits in L2
// is served from L2 on every load.  Four loads a thread are in flight at a
// time; the sums land in `sink` only when they are NaN, which the loads must
// still be made to decide.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 4;

__device__ __forceinline__ void add(float4& acc, const float4 v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

__global__ void l2_read(const float4* __restrict__ x, int64_t nvec, int reps,
                        float* __restrict__ sink) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t first = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int r = 0; r < reps; ++r) {
    int64_t i = first;
    for (; i + 3 * stride < nvec; i += 4 * stride) {
      const float4 a = __ldcg(x + i);
      const float4 b = __ldcg(x + i + stride);
      const float4 c = __ldcg(x + i + 2 * stride);
      const float4 d = __ldcg(x + i + 3 * stride);
      add(acc, a);
      add(acc, b);
      add(acc, c);
      add(acc, d);
    }
    for (; i < nvec; i += stride) add(acc, __ldcg(x + i));
  }
  const float s = acc.x + acc.y + acc.z + acc.w;
  if (s != s) sink[0] = s;
}

}  // namespace

// x is an n-element float32 array on `device`, 16-byte aligned, n % 4 == 0;
// sink is one float32 on `device`.  Launches one kernel on `stream` that
// reads x `reps` times and returns its launch error, or cudaSuccess.
extern "C" int synapse_l2_read(const void* x, void* sink, int64_t n,
                               int64_t reps, int64_t device, void* stream) {
  if (n <= 0 || n % 4 || reps < 1 || reps > (1 << 30)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               static_cast<int>(device));
  if (err != cudaSuccess) return err;
  l2_read<<<sms * kBlocksPerSm, kThreads, 0,
            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), n / 4, static_cast<int>(reps),
      static_cast<float*>(sink));
  return cudaGetLastError();
}
