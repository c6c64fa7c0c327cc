// The collective atom's kind codes, shared with csrc/collective.cu, and
// its loop body, the wire leg of csrc/segment.cu's rows.
//
// The wire carry is a mesh axis's n shards on one card, one float32 tensor
// (n, inner): column q is the n elements x[0..n-1, q].  One step, in
// place, shape-invariant (the JAX package's CollectiveAtom.loop_body,
// src/repro/core/atoms.py:462-482):
//   * all-reduce (kind 0): every shard takes the sum over the axis times
//     1/n (psum rescaled, so thousands of steps stay bounded);
//   * all-gather (kind 1): every shard takes shard 0's block
//     (all_gather(x, axis)[0]);
//   * collective-permute (kind 2): shard (i + 1) % n takes shard i.
// A step of any kind reads and writes only within a column, so the thread
// that owns a column owns all n of its elements: a step needs no barrier
// between threads or CTAs, the ownership idea of ring.cuh.  The loads and
// stores are ld.global.cg / st.global.cg, through L2 and never L1, and
// volatile, so a step that reads what the thread's last step wrote really
// reads it back from L2 instead of from a register: every step moves its
// bytes.  On one card the shards sit in L2 (two 128 KiB shards of a fused
// segment's carry); the time a step takes is an L2 time, not a link's.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace synapse {

constexpr int kAllReduce = 0;
constexpr int kAllGather = 1;
constexpr int kPermute = 2;

__device__ __forceinline__ float coll_load(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void coll_store(float* p, float v) {
  asm volatile("st.global.cg.f32 [%0], %1;" ::"l"(p), "f"(v) : "memory");
}

// One step on the column whose shard-0 element is `col` (shards `inner`
// floats apart).
__device__ __forceinline__ void coll_column_step(float* col, int64_t n,
                                                 int64_t inner, int kind,
                                                 float inv_n) {
  if (kind == kAllReduce) {
    float s = 0.0f;
    for (int64_t i = 0; i < n; ++i) s += coll_load(col + i * inner);
    const float v = s * inv_n;
    for (int64_t i = 0; i < n; ++i) coll_store(col + i * inner, v);
  } else if (kind == kAllGather) {
    const float v = coll_load(col);
    for (int64_t i = 1; i < n; ++i) coll_store(col + i * inner, v);
  } else {
    float prev = coll_load(col + (n - 1) * inner);
    for (int64_t i = 0; i < n; ++i) {
      const float cur = coll_load(col + i * inner);
      coll_store(col + i * inner, prev);
      prev = cur;
    }
  }
}

// `steps` steps over the columns thread `t` of `threads` owns (a grid
// stride over the inner columns).
__device__ __forceinline__ void coll_steps(float* __restrict__ x, int64_t n,
                                           int64_t inner, int kind,
                                           int64_t steps, int64_t t,
                                           int64_t threads) {
  const float inv_n = 1.0f / static_cast<float>(n);
  for (int64_t s = 0; s < steps; ++s) {
    for (int64_t c = t; c < inner; c += threads) {
      coll_column_step(x + c, n, inner, kind, inv_n);
    }
  }
}

}  // namespace synapse
