// The collective atom's kind codes, shared with csrc/collective.cu, and
// its loop body, the wire leg of csrc/segment.cu's rows.
//
// The wire carry is a mesh axis's n shards on one card, one float32 tensor
// (n, inner): column q is the n elements x[0..n-1, q].  One step, in
// place, shape-invariant (the JAX package's CollectiveAtom.loop_body,
// src/repro/core/atoms.py:462-482):
//   * all-reduce (kind 0): every shard takes the sum over the axis times
//     1/n (psum rescaled, so thousands of steps stay bounded), summed in
//     ascending shard order from 0.0f;
//   * all-gather (kind 1): every shard takes shard 0's block
//     (all_gather(x, axis)[0]);
//   * collective-permute (kind 2): shard (i + 1) % n takes shard i.
// A step of any kind reads and writes only within a column, so the thread
// that owns a column owns all n of its elements: a step needs no barrier
// between threads or CTAs, the ownership idea of ring.cuh.
//
// Bound.  A step of thread t reads what t's last step wrote, so a step is
// a dependent round trip to wherever the column lives, not a byte rate:
// the leg's time is steps x that round trip.  Two media hold a column:
//   * L2Column: the carry in device memory, loads and stores
//     ld.global.cg / st.global.cg (through L2, never L1);
//   * PeerColumn: the n elements in the shared memory of the OTHER CTA of
//     the thread's 2-CTA cluster, reached through Hopper's SM-to-SM
//     network (mapa + ld/st.shared::cluster).  csrc/segment.cu keeps the
//     carry there for the length of its launch: loaded in after the
//     kernel's first cluster barrier, written back after the last row.
// Both are volatile asm, so a step that reads what the thread's last step
// wrote really reads it back instead of from a register: every step moves
// its bytes.  csrc/l2_probe.cu times the same step chain on both media
// (chip_smoke.py prints both round trips); PERF.md keeps them as the wire
// leg's latency floor.  A step issues its loads kBatch at a time before
// it adds or stores, so n <= kBatch shards cost one round trip a step.
// On an H100 SXM at 700 W an all-reduce step of 2 shards took 738 SM
// cycles (0.39 us) through L2 and 515 (0.27 us) through the peer's shared
// memory, at 132 CTAs; 348 (0.18 us) through the CTA's own shared memory,
// the part of a step that is not the trip.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace synapse {

constexpr int kAllReduce = 0;
constexpr int kAllGather = 1;
constexpr int kPermute = 2;

// loads a step keeps in flight before its first add or store
constexpr int kBatch = 4;
// threads a CTA of the kernels that step a carry (csrc/burn.cuh's
// kThreads, csrc/l2_probe.cu's probe)
constexpr int kCollThreads = 256;
// bytes between a column's shards in a PeerColumn: element (k, i) of the
// peer thread l sits at float ((k * n + i) * kCollThreads + l) of the
// share, so a warp's 32 threads touch 32 consecutive words
constexpr uint32_t kPeerPitch = kCollThreads * sizeof(float);

// x, as a value the compiler cannot see through: whatever a caller
// derives from it inside a loop is derived there, never hoisted out and
// kept in a register across the loop's other work (csrc/segment.cu's
// rows, whose burn holds 128 registers of x at tile 256)
__device__ __forceinline__ int opaque(int x) {
  asm volatile("mov.b32 %0, %0;" : "+r"(x));
  return x;
}

__device__ __forceinline__ float coll_load(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void coll_store(float* p, float v) {
  asm volatile("st.global.cg.f32 [%0], %1;" ::"l"(p), "f"(v) : "memory");
}

// The shared::cluster address of `local` (this CTA's shared memory) in the
// shared memory of cluster rank `rank`.
__device__ __forceinline__ uint32_t peer_address(const void* local,
                                                 unsigned rank) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(local));
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ float peer_load(uint32_t a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];"
               : "=f"(v)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void peer_store(uint32_t a, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(a), "f"(v)
               : "memory");
}

// A column in device memory: shard i at col + i * inner.
struct L2Column {
  float* col;
  int64_t inner;
  __device__ __forceinline__ float load(int i) const {
    return coll_load(col + i * inner);
  }
  __device__ __forceinline__ void store(int i, float v) const {
    coll_store(col + i * inner, v);
  }
};

// A column in a peer CTA's shared memory: shard i at addr + i * kPeerPitch.
struct PeerColumn {
  uint32_t addr;
  __device__ __forceinline__ float load(int i) const {
    return peer_load(addr + i * kPeerPitch);
  }
  __device__ __forceinline__ void store(int i, float v) const {
    peer_store(addr + i * kPeerPitch, v);
  }
};

// One step of kind kKind on a column of n shards.  Loads and stores go
// kBatch at a time (predicated, unrolled), so a step of n <= kBatch
// shards is one batch of loads, the arithmetic and one batch of stores.
template <int kKind, class Col>
__device__ __forceinline__ void coll_column_step(const Col& c, int n,
                                                 float inv_n) {
  float v[kBatch];
  if constexpr (kKind == kAllReduce) {
    float s = 0.0f;
    for (int i0 = 0; i0 < n; i0 += kBatch) {
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (i0 + j < n) v[j] = c.load(i0 + j);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (i0 + j < n) s += v[j];
      }
    }
    const float r = s * inv_n;
    for (int i0 = 0; i0 < n; i0 += kBatch) {
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (i0 + j < n) c.store(i0 + j, r);
      }
    }
  } else if constexpr (kKind == kAllGather) {
    const float r = c.load(0);
    for (int i0 = 1; i0 < n; i0 += kBatch) {
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (i0 + j < n) c.store(i0 + j, r);
      }
    }
  } else {
    // shard i takes shard i - 1 (shard 0 takes shard n - 1); a batch's
    // loads all precede its stores, and shard n - 1 is stored last
    float prev = c.load(n - 1);
    for (int i0 = 0; i0 < n; i0 += kBatch) {
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (i0 + j < n) v[j] = c.load(i0 + j);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (i0 + j < n) {
          c.store(i0 + j, prev);
          prev = v[j];
        }
      }
    }
  }
}

// `steps` steps of kind kKind over columns 0 .. cols - 1 of a thread,
// column k at `col(k)`.  One column (the fused carry on a full grid) keeps
// its address out of the step loop.
template <int kKind, class ColOf>
__device__ __forceinline__ void coll_steps_of(const ColOf& col, int cols,
                                              int n, int steps) {
  const float inv_n = 1.0f / static_cast<float>(n);
  if (cols == 1) {
    const auto c = col(0);
    for (int s = 0; s < steps; ++s) coll_column_step<kKind>(c, n, inv_n);
    return;
  }
  for (int s = 0; s < steps; ++s) {
    for (int k = 0; k < cols; ++k) {
      coll_column_step<kKind>(col(k), n, inv_n);
    }
  }
}

// The same for a kind known only at run time.
template <class ColOf>
__device__ __forceinline__ void coll_steps_kind(const ColOf& col, int cols,
                                                int n, int kind,
                                                int steps) {
  if (kind == kAllReduce) {
    coll_steps_of<kAllReduce>(col, cols, n, steps);
  } else if (kind == kAllGather) {
    coll_steps_of<kAllGather>(col, cols, n, steps);
  } else {
    coll_steps_of<kPermute>(col, cols, n, steps);
  }
}

// The columns a thread owns at most: thread t of `threads` owns columns
// t, t + threads, ... below `inner`.
__host__ __device__ __forceinline__ int64_t coll_per_thread(int64_t inner,
                                                            int64_t threads) {
  return (inner + threads - 1) / threads;
}

// The shared memory a CTA gives the carry: n elements of every column
// that each of its peer's kCollThreads threads owns.
__host__ __device__ __forceinline__ int64_t coll_share_bytes(int64_t n,
                                                             int64_t inner,
                                                             int64_t threads) {
  return n * coll_per_thread(inner, threads) * kCollThreads * 4;
}

// How thread `t` of `threads` sees its columns in the peer's share.
struct PeerColumns {
  uint32_t base;  // element (0, 0) of this thread, in the peer's share
  int owned;      // columns it owns
  int n;
};

__device__ __forceinline__ PeerColumns peer_columns(float* share,
                                                    unsigned peer, int n,
                                                    int inner, int t,
                                                    int threads) {
  PeerColumns p;
  p.base = peer_address(share, peer) + threadIdx.x * 4;
  p.owned = t < inner ? (inner - t + threads - 1) / threads : 0;
  p.n = n;
  return p;
}

// Column k of the thread (k < owned).
__device__ __forceinline__ PeerColumn peer_column(const PeerColumns& p,
                                                  int k) {
  return PeerColumn{p.base + static_cast<uint32_t>(k * p.n) * kPeerPitch};
}

// The thread's columns from the global carry x (n, inner) into the peer's
// share.  The caller has made sure the peer runs (a cluster barrier).
__device__ __forceinline__ void coll_load_in(const float* __restrict__ x,
                                             const PeerColumns& p, int inner,
                                             int t, int threads) {
  for (int k = 0; k < p.owned; ++k) {
    const PeerColumn c = peer_column(p, k);
    const float* col = x + t + int64_t(k) * threads;
    for (int i = 0; i < p.n; ++i) c.store(i, col[int64_t(i) * inner]);
  }
}

// The thread's columns from the peer's share back into x.  The caller
// keeps the peer running until these loads are done (a cluster barrier).
__device__ __forceinline__ void coll_write_out(float* __restrict__ x,
                                               const PeerColumns& p,
                                               int inner, int t,
                                               int threads) {
  for (int k = 0; k < p.owned; ++k) {
    const PeerColumn c = peer_column(p, k);
    float* col = x + t + int64_t(k) * threads;
    for (int i = 0; i < p.n; ++i) col[int64_t(i) * inner] = c.load(i);
  }
}

// `steps` steps of `kind` over the thread's columns in the peer's share.
__device__ __forceinline__ void coll_steps_peer(const PeerColumns& p,
                                                int kind, int steps) {
  coll_steps_kind([&p](int k) { return peer_column(p, k); }, p.owned, p.n,
                  kind, steps);
}

// `steps` steps of `kind` over the thread's columns of x (n, inner) in
// device memory, the medium the wire leg used before the peer's share.
__device__ __forceinline__ void coll_steps_l2(float* __restrict__ x, int n,
                                              int inner, int kind, int steps,
                                              int t, int threads) {
  const int cols = t < inner ? (inner - t + threads - 1) / threads : 0;
  coll_steps_kind(
      [=](int k) { return L2Column{x + t + int64_t(k) * threads, inner}; },
      cols, n, kind, steps);
}

}  // namespace synapse
