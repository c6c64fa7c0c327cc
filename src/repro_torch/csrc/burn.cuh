// The burn's cluster design, shared by csrc/compute_atom.cu (one burn a
// launch) and csrc/segment.cu (the burns of a segment's rows, one launch a
// segment).  See compute_atom.cu for why it is shaped this way.
//
// A thread-block cluster of 2 CTAs owns a panel of kRows rows of y; CTA j
// computes the columns C_j = [j T/2, (j+1) T/2) of the panel, with x's
// column slice x[:, C_j] in the CTA's registers (warp w holds the rows
// K_w = [w T/8, (w+1) T/8) of it, each lane T/64 neighbouring columns).
// The panel is double-buffered in shared memory: after iteration `it`,
// y_it sits in copy `it & 1` of both CTAs.
#pragma once

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace synapse {

namespace cg = cooperative_groups;

constexpr int kCluster = 2;    // CTAs a cluster
constexpr int kRows = 4;       // rows of a panel
constexpr int kThreads = 256;  // threads a CTA
constexpr int kWarps = kThreads / 32;

template <int T>
struct Burn {
  static constexpr int W = T / kCluster;  // columns a CTA
  static constexpr int CW = W / 32;       // columns a lane
  static constexpr int KG = T / kWarps;   // k a warp
  static_assert(CW >= 1 && CW <= 4 && KG % 4 == 0, "shape");
  // CTAs that own a panel: T / kRows clusters
  static constexpr int kCtas = kCluster * (T / kRows);
  // two copies of the panel [kRows][T], then the partials [kRows][8][W]
  static constexpr size_t kSmem =
      (2 * size_t(kRows) * T + size_t(kRows) * kWarps * W) * sizeof(float);
};

template <int N>
__device__ __forceinline__ void store(float* p, const float (&v)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// x's column slice C_rank, this warp's rows K_w, into registers.
template <int T>
__device__ __forceinline__ void burn_load_x(
    const float* __restrict__ x, int rank,
    float (&xr)[Burn<T>::KG][Burn<T>::CW]) {
  using B = Burn<T>;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int kk = 0; kk < B::KG; ++kk) {
#pragma unroll
    for (int j = 0; j < B::CW; ++j) {
      xr[kk][j] =
          x[int64_t(warp * B::KG + kk) * T + rank * B::W + lane * B::CW + j];
    }
  }
}

// y0 = x: the panel's rows [row0, row0 + kRows) into copy 0.  Each CTA of
// the cluster loads them itself; the caller's cluster barrier follows.
template <int T>
__device__ __forceinline__ void burn_load_panel(const float* __restrict__ x,
                                                int64_t row0, float* panel) {
  for (int i = threadIdx.x; i < kRows * T / 4; i += kThreads) {
    reinterpret_cast<float4*>(panel)[i] =
        reinterpret_cast<const float4*>(x + row0 * T)[i];
  }
}

// Iterations it0 .. it0 + iters - 1 of y <- (y @ x) * 0.5 + 0.25 on the
// cluster's panel, y_it0 read from copy it0 & 1.  An iteration:
//   1. each thread sums y[r, K_w] . x[K_w, c] for the panel's 4 rows and
//      its columns, reading y from the CTA's own copy of the panel (one
//      address a warp: a broadcast);
//   2. the 8 warps' partial sums meet in shared memory; 4 columns at a
//      time are reduced, finished with (* 0.5 + 0.25) and stored into the
//      next copy of the panel of both CTAs of the cluster (distributed
//      shared memory), or into `out` on the last iteration when `out` is
//      given;
//   3. one cluster barrier publishes y to both CTAs; the double buffer
//      lets the one barrier also keep a CTA from overwriting a copy the
//      other still reads.
// With `out`, the last iteration stores there and skips the barrier (no
// CTA touches the other's shared memory after it).  Without, every
// iteration ends in the barrier, y_{it0+iters} is in both CTAs' copies,
// and the caller may go on burning later.
template <int T>
__device__ __forceinline__ void burn_iterations(
    const float (&xr)[Burn<T>::KG][Burn<T>::CW], float* panel, int rank,
    int64_t row0, int64_t it0, int64_t iters, float* __restrict__ out,
    cg::cluster_group& cluster) {
  using B = Burn<T>;
  constexpr int W = B::W, CW = B::CW, KG = B::KG;
  float* part = panel + 2 * kRows * T;  // [kRows][kWarps][W]
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int c0 = lane * CW;  // this lane's columns of C_rank

  for (int64_t k = 0; k < iters; ++k) {
    const int64_t it = it0 + k;
    const float* y = panel + (it & 1) * kRows * T;
    float* ynext = panel + ((it + 1) & 1) * kRows * T;
    // kRows x CW independent sums a thread; every y value a warp loads
    // (one address: a broadcast) feeds 32 CW FMAs
    float acc[kRows][CW];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int j = 0; j < CW; ++j) acc[r][j] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < KG; kk += 4) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 yv =
            *reinterpret_cast<const float4*>(y + r * T + warp * KG + kk);
#pragma unroll
        for (int j = 0; j < CW; ++j) {
          acc[r][j] = fmaf(yv.x, xr[kk][j], acc[r][j]);
          acc[r][j] = fmaf(yv.y, xr[kk + 1][j], acc[r][j]);
          acc[r][j] = fmaf(yv.z, xr[kk + 2][j], acc[r][j]);
          acc[r][j] = fmaf(yv.w, xr[kk + 3][j], acc[r][j]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      store(part + (r * kWarps + warp) * W + c0, acc[r]);
    }
    __syncthreads();
    const bool last = out != nullptr && k + 1 == iters;
    if (threadIdx.x < kRows * W / 4) {  // 4 columns a reducing thread
      const int r = threadIdx.x / (W / 4);
      const int cc = (threadIdx.x % (W / 4)) * 4;
      float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float4 p =
            *reinterpret_cast<const float4*>(part + (r * kWarps + w) * W + cc);
        s.x += p.x;
        s.y += p.y;
        s.z += p.z;
        s.w += p.w;
      }
      // s * 0.5 is exact, so the fused form rounds like the two-step one
      const float4 v = make_float4(fmaf(s.x, 0.5f, 0.25f),
                                   fmaf(s.y, 0.5f, 0.25f),
                                   fmaf(s.z, 0.5f, 0.25f),
                                   fmaf(s.w, 0.5f, 0.25f));
      const int col = rank * W + cc;
      if (last) {
        *reinterpret_cast<float4*>(out + (row0 + r) * T + col) = v;
      } else {
#pragma unroll
        for (int q = 0; q < kCluster; ++q) {
          float* dst = cluster.map_shared_rank(ynext, q);
          *reinterpret_cast<float4*>(dst + r * T + col) = v;
        }
      }
    }
    if (!last) cluster.sync();
  }
}

// The panel's columns C_rank of y_it (copy it & 1) into `out`.
template <int T>
__device__ __forceinline__ void burn_store_panel(const float* panel,
                                                 int rank, int64_t row0,
                                                 int64_t it,
                                                 float* __restrict__ out) {
  constexpr int W = Burn<T>::W;
  const float* y = panel + (it & 1) * kRows * T;
  for (int i = threadIdx.x; i < kRows * W / 4; i += kThreads) {
    const int r = i / (W / 4);
    const int col = rank * W + (i % (W / 4)) * 4;
    *reinterpret_cast<float4*>(out + (row0 + r) * T + col) =
        *reinterpret_cast<const float4*>(y + r * T + col);
  }
}

}  // namespace synapse
