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
// writes the sum over the axis (no 1/n, in ascending shard order from
// 0.0f, as the plain version and the wire leg take it) to every shard;
// all-gather (kind 1) gives every shard all n blocks, out (outer, n, post,
// n, blk) from x (outer, n, post * blk) with out[o, i, p, k, j] =
// x[o, k, p * blk + j]; collective-permute (kind 2) gives shard (i + 1) %
// n shard i's block.  The fused loop body is not here: it runs inside the
// segment kernel (device code in coll.cuh, csrc/segment.cu).
//
// Bound.  Bytes: a call reads x once and writes its output once.  A
// per-sample plan's operand is n x the shard's bytes (gigabytes: 2 x 7.6e8
// floats for Qwen2-7B's 2-way data-parallel step at a tenth of its wire),
// so HBM's rate bounds a call, not NVLink's: on one card the emulated wire
// time is a device-memory time.  Keeping 3.35 TB/s busy takes roughly 16
// KB in flight an SM (its latency times its rate over 132 SMs).
//
// Design.  A thread owns columns (o, q) of the view: it reads the n
// elements of each and writes its outputs, so no CTA waits for another and
// all three kinds share one index scheme.
//   * Wide accesses: along the contiguous last dimension a thread moves a
//     float4 at a time (neighbouring threads on neighbouring addresses),
//     kUnroll columns of vectors a pass, all of their loads of a shard in
//     flight before the first add or store.  At 8 CTAs of 256 threads an
//     SM that is up to 128 KB in flight an SM.  Where the shape or the
//     bases allow no 16-byte access (inner % 4 for all-reduce and
//     permute, blk % 4 for all-gather, or an unaligned base) the same
//     kernel runs one float a column: the element type is the shape's
//     case, not a second kernel.
//   * The grid fills the card: cudaOccupancyMaxActiveBlocksPerMultiprocessor
//     CTAs an SM, spread over the rows of `outer` (grid.y, with a loop
//     for more than 65,535 rows) and, within a row, a grid-stride loop.
//   * No 64-bit division: a row's base pointers are 64-bit, offsets within
//     a row (and, for all-gather, within an output row of n x inner) are
//     32-bit when they fit, so all-gather's block index is one 32-bit
//     division a vector and the other kinds divide nothing.
//   * Streaming hints: the operand is read once (ld.global.cs) and the
//     output written once and never read back (st.global.cs).
// On an H100 SXM at 700 W the all-reduce of 2 x 7.6e8 floats (12.16 GB
// in and out) took 4.645 ms against the 3.63 ms bound (one float a
// thread, two CTAs an SM and a 64-bit division a column took 12.93).
#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

#include "coll.cuh"  // the kind codes

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // columns of vectors a thread keeps in flight
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float4 ld_once(const float4* p) {
  return __ldcs(p);
}
__device__ __forceinline__ float ld_once(const float* p) { return __ldcs(p); }
__device__ __forceinline__ void st_once(float4* p, float4 v) { __stcs(p, v); }
__device__ __forceinline__ void st_once(float* p, float v) { __stcs(p, v); }

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float add(float a, float b) { return a + b; }

template <class V>
__device__ __forceinline__ V zero();
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.0f;
}

// U columns of vectors of one row, starting at column v, `stride` apart.
// V: float4 or float; I: the index type within a row; inner and blk (the
// all-gather's block) are in units of V.
template <int kKind, int U, class V, class I>
__device__ __forceinline__ void columns(const V* __restrict__ xr,
                                        V* __restrict__ orow, int n, I inner,
                                        I blk, I v, I stride) {
  if constexpr (kKind == synapse::kAllReduce) {
    V s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) s[u] = zero<V>();
    const V* xs = xr;
    for (int i = 0; i < n; ++i, xs += inner) {
      V a[U];
#pragma unroll
      for (int u = 0; u < U; ++u) a[u] = ld_once(xs + v + u * stride);
#pragma unroll
      for (int u = 0; u < U; ++u) s[u] = add(s[u], a[u]);
    }
    V* os = orow;
    for (int i = 0; i < n; ++i, os += inner) {
#pragma unroll
      for (int u = 0; u < U; ++u) st_once(os + v + u * stride, s[u]);
    }
  } else if constexpr (kKind == synapse::kAllGather) {
    // out row (o, i) is (post, n, blk): x[o, k, p * blk + j] lands at
    // (p * n + k) * blk + j of every i
    I at[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const I q = v + u * stride;
      const I p = q / blk;
      at[u] = p * I(n) * blk + (q - p * blk);
    }
    const V* xs = xr;
    const I out_row = I(n) * inner;
    for (int k = 0; k < n; ++k, xs += inner) {
      V a[U];
#pragma unroll
      for (int u = 0; u < U; ++u) a[u] = ld_once(xs + v + u * stride);
      V* os = orow + k * blk;
      for (int i = 0; i < n; ++i, os += out_row) {
#pragma unroll
        for (int u = 0; u < U; ++u) st_once(os + at[u], a[u]);
      }
    }
  } else {
    const V* xs = xr;
    for (int i = 0; i < n; ++i, xs += inner) {
      V a[U];
#pragma unroll
      for (int u = 0; u < U; ++u) a[u] = ld_once(xs + v + u * stride);
      V* os = orow + int64_t(i + 1 < n ? i + 1 : 0) * inner;
#pragma unroll
      for (int u = 0; u < U; ++u) st_once(os + v + u * stride, a[u]);
    }
  }
}

template <int kKind, class V, class I>
__global__ void __launch_bounds__(kThreads)
    collective_kernel(const V* __restrict__ x, V* __restrict__ out,
                      int64_t outer, int n, I post, I blk) {
  const I inner = post * blk;
  const I stride = I(gridDim.x) * kThreads;
  const I first = I(blockIdx.x) * kThreads + I(threadIdx.x);
  // a row: n x inner in, n x inner out (n x n x inner for all-gather)
  const int64_t out_row =
      int64_t(n) * inner * (kKind == synapse::kAllGather ? n : 1);
  for (int64_t o = blockIdx.y; o < outer; o += gridDim.y) {
    const V* xr = x + o * n * int64_t(inner);
    V* orow = out + o * out_row;
    I v = first;
    for (; v + (kUnroll - 1) * stride < inner; v += kUnroll * stride) {
      columns<kKind, kUnroll>(xr, orow, n, inner, blk, v, stride);
    }
    for (; v < inner; v += stride) {
      columns<kKind, 1>(xr, orow, n, inner, blk, v, stride);
    }
  }
}

// CTAs an SM the instantiation holds at kThreads, per device: asked once
template <int kKind, class V, class I>
cudaError_t blocks_per_sm(int device, int* out) {
  static std::once_flag once[kMaxDevices];
  static int cached[kMaxDevices];
  static cudaError_t error[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(once[device], [device] {
    error[device] = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &cached[device], collective_kernel<kKind, V, I>, kThreads, 0);
  });
  *out = cached[device];
  return error[device];
}

template <int kKind, class V, class I>
cudaError_t launch(const float* x, float* out, int64_t outer, int64_t n,
                   int64_t post, int64_t blk, int device, cudaStream_t s) {
  constexpr int64_t w = sizeof(V) / sizeof(float);
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = blocks_per_sm<kKind, V, I>(device, &per_sm);
  if (err != cudaSuccess) return err;
  // in units of V; all-reduce and permute see a row as one block
  const int64_t inner = post * blk / w;
  const int64_t post_v = kKind == synapse::kAllGather ? post : 1;
  const int64_t blk_v = kKind == synapse::kAllGather ? blk / w : inner;
  const int64_t rows = outer < 65535 ? outer : 65535;
  const int64_t fill = int64_t(sms) * (per_sm < 1 ? 1 : per_sm);
  int64_t per_row = (fill + rows - 1) / rows;
  const int64_t need = (inner + kThreads - 1) / kThreads;
  if (per_row > need) per_row = need;
  const dim3 grid(static_cast<unsigned>(per_row < 1 ? 1 : per_row),
                  static_cast<unsigned>(rows));
  collective_kernel<kKind, V, I><<<grid, kThreads, 0, s>>>(
      reinterpret_cast<const V*>(x), reinterpret_cast<V*>(out), outer,
      static_cast<int>(n), static_cast<I>(post_v), static_cast<I>(blk_v));
  return cudaGetLastError();
}

// The shape's case: float4 where every shard's (and block's) start is
// 16-byte aligned, 32-bit offsets where a row's (an output row's, for
// all-gather) offsets and the grid-stride loop's last index fit.
template <int kKind>
cudaError_t dispatch(const float* x, float* out, int64_t outer, int64_t n,
                     int64_t post, int64_t blk, int device, cudaStream_t s) {
  const int64_t inner = post * blk;
  const bool vec = (kKind == synapse::kAllGather ? blk : inner) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t span = (kKind == synapse::kAllGather ? n : 1) * inner;
  // room for the loop's v + kUnroll * stride beyond the row
  const bool narrow = span + (int64_t(1) << 28) < (int64_t(1) << 31);
  if (vec) {
    return narrow ? launch<kKind, float4, int32_t>(x, out, outer, n, post,
                                                   blk, device, s)
                  : launch<kKind, float4, int64_t>(x, out, outer, n, post,
                                                   blk, device, s);
  }
  return narrow ? launch<kKind, float, int32_t>(x, out, outer, n, post, blk,
                                                device, s)
                : launch<kKind, float, int64_t>(x, out, outer, n, post, blk,
                                                device, s);
}

}  // namespace

// x: outer x n x (post * blk) float32 on `device`; out: outer x n x post x
// n x blk for all-gather (kind 1), else the shape of x; out must not alias
// x.  One launch on `stream`; returns its error, or cudaSuccess.
extern "C" int synapse_collective(const void* x, void* out, int64_t outer,
                                  int64_t n, int64_t post, int64_t blk,
                                  int64_t kind, int64_t device,
                                  void* stream) {
  if (outer < 1 || n < 1 || n > (int64_t(1) << 30) || post < 1 || blk < 1 ||
      kind < 0 || kind > 2) {
    return cudaErrorInvalidValue;
  }
  const int dev = static_cast<int>(device);
  cudaError_t err = cudaSetDevice(dev);
  if (err != cudaSuccess) return err;
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case synapse::kAllReduce:
      return dispatch<synapse::kAllReduce>(xf, of, outer, n, post, blk, dev,
                                           s);
    case synapse::kAllGather:
      return dispatch<synapse::kAllGather>(xf, of, outer, n, post, blk, dev,
                                           s);
    default:
      return dispatch<synapse::kPermute>(xf, of, outer, n, post, blk, dev,
                                         s);
  }
}
