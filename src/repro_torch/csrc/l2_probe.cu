// Probes for Hopper (sm_90a).  Measuring tools, not ports of a TPU kernel.
//
// synapse_l2_read: L2's read rate.  chip_smoke.py uses it as the bound of
// a memory pass whose buffers fit in the 50 MB L2, where the device-memory
// rate would not bound it.  Reads an n-element float32 array `reps` times
// with 16-byte loads that bypass L1 (ld.global.cg), so after the first rep
// a buffer that fits in L2 is served from L2 on every load.  Four loads a
// thread are in flight at a time; the sums land in `sink` only when they
// are NaN, which the loads must still be made to decide.
//
// synapse_wire_probe: the round trip that bounds a step of the segment
// kernel's wire leg (coll.cuh).  One thread a column of an (n, inner)
// carry, inner = CTAs x 256, and `steps` steps of the loop body, each
// reading what the thread's last step wrote: the chain of dependent round
// trips, on either medium of coll.cuh: the carry in device memory (L2,
// medium 0) or the column in the shared memory of the other CTA of the
// thread's 2-CTA cluster (medium 1, as csrc/segment.cu keeps it); and,
// to show what of a step is not the trip, in the thread's own CTA's
// shared memory through the same cluster addressing (medium 2).  The
// same step code as the segment's; thread 0 counts the SM clock's cycles
// over its steps.
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "coll.cuh"

namespace cg = cooperative_groups;

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

__global__ void __launch_bounds__(synapse::kCollThreads)
    wire_probe(float* __restrict__ carry, int n, int inner, int kind,
               int steps, int medium, long long* __restrict__ cycles) {
  extern __shared__ float4 smem4[];
  float* share = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const bool smem = medium != 0;
  const unsigned peer = cluster.block_rank() ^ (medium == 1 ? 1 : 0);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int threads = gridDim.x * blockDim.x;
  synapse::PeerColumns cols{};
  if (smem) {
    cluster.sync();  // the peer runs before its shared memory is touched
    cols = synapse::peer_columns(share, peer, n, inner, t, threads);
    synapse::coll_load_in(carry, cols, inner, t, threads);
  }
  const long long c0 = clock64();
  if (smem) {
    synapse::coll_steps_peer(cols, kind, steps);
  } else {
    synapse::coll_steps_l2(carry, n, inner, kind, steps, t, threads);
  }
  const long long c1 = clock64();
  if (smem) {
    synapse::coll_write_out(carry, cols, inner, t, threads);
    cluster.sync();  // the peer reads this CTA's shared memory until here
  }
  if (t == 0) cycles[0] = c1 - c0;
}

}  // namespace

// The wire leg's round trip.  carry: n x (ctas * 256) float32 on `device`,
// stepped in place; ctas: even (2-CTA clusters); medium 0 device memory,
// 1 the peer CTA's shared memory, 2 the CTA's own; cycles: one int64 on `device`, thread
// 0's SM cycles over its steps.  One launch on `stream`; returns its
// error, or cudaSuccess.
extern "C" int synapse_wire_probe(void* carry, int64_t n, int64_t ctas,
                                  int64_t kind, int64_t steps,
                                  int64_t medium, void* cycles,
                                  int64_t device, void* stream) {
  const int64_t inner = ctas * synapse::kCollThreads;
  const int64_t share =
      medium != 0 ? synapse::coll_share_bytes(n, inner, inner) : 0;
  if (n < 1 || ctas < 2 || ctas % 2 || ctas > 4096 || kind < 0 ||
      kind > 2 || steps < 1 || steps > (int64_t(1) << 30) || medium < 0 ||
      medium > 2 || share > 48 * 1024) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ctas), 1, 1);
  cfg.blockDim = dim3(synapse::kCollThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(share);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, wire_probe, static_cast<float*>(carry),
                           static_cast<int>(n), static_cast<int>(inner),
                           static_cast<int>(kind), static_cast<int>(steps),
                           static_cast<int>(medium),
                           static_cast<long long*>(cycles));
  return err != cudaSuccess ? err : cudaGetLastError();
}

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
