// The burn's cluster design, shared by csrc/compute_atom.cu (one burn a
// launch) and csrc/segment.cu (the burns of a segment's rows, one launch a
// segment).  See compute_atom.cu for why it is shaped this way.
//
// A thread-block cluster of 2 CTAs owns a panel of kRows rows of y; CTA j
// computes the columns C_j = [j T/2, (j+1) T/2) of the panel, with x's
// column slice x[:, C_j] in the CTA's registers.  Warp w owns the columns
// [w T/16, (w+1) T/16) of C_j; its lanes split them into groups of 4
// (kCw) neighbouring columns and split k (the rows of x, all T of them)
// among the lanes that share a column group: lane l holds the columns
// (l % CG) * 4 .. + 3 of its warp's and the KG = T / KL rows of x from
// (l / CG) * KG, KL = 32 / CG lanes across k.  So a warp's 32 lanes hold
// every k of its columns, and a row's dot products are summed over the
// warp's own lanes (shuffles), never across warps.
//
// The panel is double-buffered in shared memory: after iteration `it`,
// y_it sits in copy `it & 1` of both CTAs, each row padded by 4 floats
// after every 32 (`pos`), so the 8 or 16 k ranges a warp loads at once
// fall on distinct banks.  Every row of a copy has its own mbarrier in
// each CTA: a row is published when all its T floats have landed in the
// CTA's copy, W stored by the CTA's own warps and W by the peer's, every
// one by st.async and so counted in bytes on the barrier (one arrive a
// phase sets the bytes to expect).  A warp waits only for the row it is
// about to read, so while one row is in its exchange the warps run the
// FMAs of the panel's other rows.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace synapse {

constexpr int kCluster = 2;    // CTAs a cluster
constexpr int kRows = 4;       // rows of a panel
constexpr int kThreads = 256;  // threads a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kCw = 4;         // columns a lane

__host__ __device__ constexpr int log2i(int n) {
  return n <= 1 ? 0 : 1 + log2i(n / 2);
}

template <int T>
struct Burn {
  static constexpr int W = T / kCluster;   // columns a CTA
  static constexpr int WC = W / kWarps;    // columns a warp
  static constexpr int CG = WC / kCw;      // lanes across a warp's columns
  static constexpr int KL = 32 / CG;       // lanes across k
  static constexpr int KG = T / KL;        // k a lane
  static constexpr int VW = KG < 4 ? KG : 4;  // floats a y load
  static constexpr int P = T + T / 8;      // floats a padded panel row
  static_assert(WC % kCw == 0 && CG >= 1 && CG <= 32 && KG % VW == 0 &&
                    (KG % 32 == 0 || 32 % KG == 0),
                "shape");
  // CTAs that own a panel: T / kRows clusters
  static constexpr int kCtas = kCluster * (T / kRows);
  // bytes a row of a copy receives: all T columns, W from each CTA
  static constexpr uint32_t kRowTx = T * sizeof(float);
  // two copies of the padded panel [kRows][P], then an mbarrier a row a
  // copy [2][kRows]
  static constexpr size_t kPanelBytes = 2 * size_t(kRows) * P * sizeof(float);
  static constexpr size_t kSmem = kPanelBytes + 2 * kRows * sizeof(uint64_t);
};

// float k of a row, in a padded row
__host__ __device__ constexpr int pos(int k) { return k + 4 * (k >> 5); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the shared::cluster address of shared address `a` in CTA `rank`
__device__ __forceinline__ uint32_t cluster_u32(uint32_t a, unsigned rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 _, [%0], %1;" ::
          "r"(bar),
      "r"(bytes));
}

// Whether the phase of this parity has completed.  The acquire is at CTA
// scope, as for a TMA load's completion: the barrier and every byte its
// phase counts (st.async, from this CTA or the peer) sit in this CTA's
// shared memory.  Cluster scope adds an L1 invalidation to each test that
// the burn, which reads no global memory in its loop, does not need.
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.test_wait.parity.acquire.cta.shared::cta.b64 P1, [%1], "
      "%2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cta.shared::cta.b64 P1, [%0], "
      "%1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// A float into shared::cluster address `a` (this CTA's shared memory or
// the peer's), counted as 4 bytes on the mbarrier `bar` of the same CTA.
// No "memory" clobber, here and on the arrive: the burn's own loads and
// stores never depend on their order (a row's readers wait for the
// barrier's phase, which counts these bytes), so the compiler may move
// the burn's shared-memory loads across them.
__device__ __forceinline__ void st_async(uint32_t a, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];" ::"r"(a),
      "f"(v), "r"(bar));
}

// the device's nanosecond clock
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}

// Sums v over the lanes that differ in the lane bits M, M / 2, .., Lo, high
// to low.  While N > 1 values remain and M > Lo, a step halves them (the
// lane whose bit M is set keeps the upper half, its partner the lower);
// the other steps add all of them.  Afterwards v[0 .. N') holds the sums
// of the values at base + i, base adding N / 2 for each halving step whose
// bit the lane has.  Lanes that differ only in the adding steps' bits hold
// the same sums, bit for bit (each step's two sums add the same two
// floats).
template <int N, int M, int Lo>
__device__ __forceinline__ void lane_sum(float* v, int lane) {
  if constexpr (M >= Lo) {
    if constexpr (N > 1 && M > Lo) {
      const bool hi = lane & M;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = hi ? v[i] : v[i + N / 2];
        const float keep = hi ? v[i + N / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
      }
      lane_sum<N / 2, M / 2, Lo>(v, lane);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        v[i] += __shfl_xor_sync(0xffffffffu, v[i], M);
      }
      lane_sum<N, M / 2, Lo>(v, lane);
    }
  }
}

// x's column slice C_rank: this lane's KG rows of x and its 4 columns.
template <int T>
__device__ __forceinline__ void burn_load_x(
    const float* __restrict__ x, int rank, float (&xr)[Burn<T>::KG][kCw]) {
  using B = Burn<T>;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int col = rank * B::W + warp * B::WC + (lane % B::CG) * kCw;
  const int k0 = (lane / B::CG) * B::KG;
#pragma unroll
  for (int kk = 0; kk < B::KG; ++kk) {
    const float4 v =
        *reinterpret_cast<const float4*>(x + int64_t(k0 + kk) * T + col);
    xr[kk][0] = v.x;
    xr[kk][1] = v.y;
    xr[kk][2] = v.z;
    xr[kk][3] = v.w;
  }
}

// y0 = x: the panel's rows [row0, row0 + kRows) into copy 0, and the rows'
// mbarriers initialised.  Each CTA of the cluster does it itself; the
// caller's cluster barrier follows (no st.async reaches a barrier before
// its CTA has made it).
template <int T>
__device__ __forceinline__ void burn_load_panel(const float* __restrict__ x,
                                                int64_t row0, float* panel) {
  using B = Burn<T>;
  for (int i = threadIdx.x; i < kRows * T / 4; i += kThreads) {
    const int r = i / (T / 4);
    const int c = (i % (T / 4)) * 4;
    *reinterpret_cast<float4*>(panel + r * B::P + pos(c)) =
        *reinterpret_cast<const float4*>(x + (row0 + r) * T + c);
  }
  if (threadIdx.x == 0) {
    const uint32_t bars = smem_u32(panel) + B::kPanelBytes;
    for (int i = 0; i < 2 * kRows; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
}

// The parity of the phase of row barrier `it & 1` that publishes y_it
// (it >= 1): copy 1 completes phases for it = 1, 3, 5, ..; copy 0 for
// it = 2, 4, ..
__device__ __forceinline__ uint32_t burn_parity(int64_t it) {
  return static_cast<uint32_t>((it - 1) >> 1) & 1u;
}

// One lane's part of a row: where its k range starts, where its sums land
// after lane_sum, and whether and where it stores them: of the two lanes
// that hold a value, the one without bit CG stores into this CTA's copy,
// the other into the peer's.
template <int T>
struct BurnLane {
  using B = Burn<T>;
  // lane_sum's halving steps, and the values a lane keeps
  static constexpr int kHalve = log2i(kCw) < log2i(B::KL) - 1
                                    ? log2i(kCw)
                                    : log2i(B::KL) - 1;
  static constexpr int kLeft = kCw >> kHalve;
  // the adding steps' lane bits: the lowest (CG) picks the copy a lane
  // stores, the others must be 0 for a lane to store at all
  static constexpr int kAdd =
      (B::CG << (log2i(B::KL) - kHalve)) - B::CG;
  static_assert(kLeft == 1, "a lane stores one value");

  int lane, warp, k0, col;
  bool stores;
  // the panel and the row barriers of the CTA this lane stores into: its
  // own or the peer's, as shared::cluster addresses
  uint32_t bars, dst_panel, dst_bars;

  __device__ __forceinline__ BurnLane(float* panel, int rank) {
    lane = threadIdx.x % 32;
    warp = threadIdx.x / 32;
    k0 = (lane / B::CG) * B::KG;
    int base = 0;
#pragma unroll
    for (int s = 0; s < kHalve; ++s) {
      if (lane & (16 >> s)) base += kCw >> (s + 1);
    }
    col = rank * B::W + warp * B::WC + (lane % B::CG) * kCw + base;
    stores = (lane & (kAdd & ~B::CG)) == 0;
    const uint32_t dst = static_cast<uint32_t>(lane & B::CG ? rank ^ 1 : rank);
    const uint32_t a = smem_u32(panel);
    bars = a + B::kPanelBytes;
    dst_panel = cluster_u32(a, dst);
    dst_bars = cluster_u32(bars, dst);
  }

  // the mbarrier of copy b's row r
  __device__ __forceinline__ uint32_t bar(int b, int r) const {
    return bars + 8 * (b * kRows + r);
  }
};

// Whether row r of y_it is published, without blocking (y_0's rows always
// are: the caller's cluster barrier published them).
__device__ __forceinline__ bool burn_ready(uint32_t bar, int64_t it) {
  return it == 0 || mbar_test(bar, burn_parity(it));
}

// Waits until row r of y_it is published, unless `ready` says it is.  With
// Timed, lane 0 of warp 0 adds the ns it waits to *waited.
template <bool Timed>
__device__ __forceinline__ void burn_wait(bool ready, uint32_t bar,
                                          int64_t it,
                                          unsigned long long* waited) {
  if (ready) return;
  [[maybe_unused]] unsigned long long t0 = 0;
  if constexpr (Timed) {
    if (threadIdx.x == 0) t0 = global_ns();
  }
  mbar_wait(bar, burn_parity(it));
  if constexpr (Timed) {
    if (threadIdx.x == 0) *waited += global_ns() - t0;
  }
}

// y[r, K_l] . x[K_l, c] for the lane's k range K_l of padded row y and its
// 4 columns, in two independent sums a column (the even and the odd k),
// added at the end.  Each 4 floats of y the lane loads feed 16 FMAs.
template <int T>
__device__ __forceinline__ void burn_row_fma(
    const float (&xr)[Burn<T>::KG][kCw], const float* y, float (&v)[kCw]) {
  constexpr int KG = Burn<T>::KG, VW = Burn<T>::VW;
  float acc[2][kCw];
#pragma unroll
  for (int j = 0; j < kCw; ++j) acc[0][j] = acc[1][j] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < KG; kk += VW) {
    float yv[VW];
    if constexpr (VW == 4) {
      const float4 w = *reinterpret_cast<const float4*>(y + pos(kk));
      yv[0] = w.x;
      yv[1] = w.y;
      yv[2] = w.z;
      yv[3] = w.w;
    } else {
      const float2 w = *reinterpret_cast<const float2*>(y + pos(kk));
      yv[0] = w.x;
      yv[1] = w.y;
    }
#pragma unroll
    for (int u = 0; u < VW; ++u) {
#pragma unroll
      for (int j = 0; j < kCw; ++j) {
        acc[u & 1][j] = fmaf(yv[u], xr[kk + u][j], acc[u & 1][j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kCw; ++j) v[j] = acc[0][j] + acc[1][j];
}

// Row r of y_{it+1} from the lane's sums v of row r of y_it (it in copy
// b): summed over the warp's lanes, finished with (* 0.5 + 0.25), and
// stored into copy b ^ 1 of both CTAs, by one of each pair of lanes that
// hold a value into each (st.async, this CTA's copy included, so every
// store is counted in bytes on the row's barrier and no warp has to
// arrive); lane 0 of warp 0 arrives on this CTA's barrier of the row,
// setting the T floats it expects.  With `out` (the burn's last
// iteration), one lane of each pair stores into `out` instead, and
// nothing is published.
template <int T>
__device__ __forceinline__ void burn_row_publish(const BurnLane<T>& L,
                                                 float (&v)[kCw], int b,
                                                 int r, int64_t row0,
                                                 float* __restrict__ out) {
  using B = Burn<T>;
  lane_sum<kCw, 16, B::CG>(v, L.lane);
  // s * 0.5 is exact, so the fused form rounds like the two-step one
  const float f = fmaf(v[0], 0.5f, 0.25f);
  const int nb = b ^ 1;
  if (out != nullptr) {
    if (L.stores && (L.lane & B::CG) == 0) out[(row0 + r) * T + L.col] = f;
  } else if (L.stores) {
    st_async(L.dst_panel + static_cast<uint32_t>(
                               ((nb * kRows + r) * B::P + pos(L.col)) * 4),
             f, L.dst_bars + 8 * (nb * kRows + r));
  }
  if (out == nullptr && threadIdx.x == 0) {
    mbar_arrive_tx(L.bar(nb, r), B::kRowTx);
  }
}

// Iterations it0 .. it0 + iters - 1 of y <- (y @ x) * 0.5 + 0.25 on the
// cluster's panel, y_it0 in copy it0 & 1.  A warp walks each iteration's
// rows in order, one row ahead of itself: for row r it
//   1. waits for row r of y_it unless a test of its barrier, made during
//      the row before, found it published (burn_ready, burn_wait);
//   2. runs the row's FMAs over its lanes' k ranges (burn_row_fma), then
//      tests the next row's barrier;
//   3. sums, finishes and publishes the row before (row r - 1, or the last
//      iteration's last row; burn_row_publish), whose shuffles the
//      compiler interleaves with step 2's FMAs.
// After the last row the last one in flight is published.  A row's
// barrier completes when all its T floats have landed in the CTA's copy;
// a warp comes back to row r one iteration later, three rows on, so the
// row's exchange (the lane sums, the stores into both CTAs, the barrier)
// runs under the FMAs of the rows between, and the test mostly finds the
// row published.  Each warp reads copy it & 1 of a row before it stores
// into copy (it + 1) & 1 of it, and stores y_{it+1}'s row only once y_it's
// row is complete, which every warp's stores of it made; so nothing
// overwrites a copy that a warp still reads, and no row's bytes reach a
// barrier phase before the one they count in.  With `out`, the last
// iteration's rows go to `out`.  With `Timed`, lane 0 of warp 0 adds the
// ns it spends waiting for a row to *waited.
template <int T, bool Timed = false>
__device__ __forceinline__ void burn_iterations(
    const float (&xr)[Burn<T>::KG][kCw], float* panel, int rank,
    int64_t row0, int64_t it0, int64_t iters, float* __restrict__ out,
    unsigned long long* waited = nullptr) {
  using B = Burn<T>;
  const BurnLane<T> L(panel, rank);
  float v[kCw];  // the row in flight: the lane's sums, not yet published
  bool ready = iters > 0 && burn_ready(L.bar(it0 & 1, 0), it0);
  for (int64_t k = 0; k < iters; ++k) {
    const int64_t it = it0 + k;
    const int b = static_cast<int>(it & 1);
    float* last = out != nullptr && k + 1 == iters ? out : nullptr;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      burn_wait<Timed>(ready, L.bar(b, r), it, waited);
      float next[kCw];
      burn_row_fma<T>(xr, panel + (b * kRows + r) * B::P + pos(L.k0), next);
      if (r + 1 < kRows) {
        ready = burn_ready(L.bar(b, r + 1), it);
      } else if (k + 1 < iters) {
        ready = burn_ready(L.bar(b ^ 1, 0), it + 1);
      }
      if (r > 0) {
        burn_row_publish<T>(L, v, b, r - 1, row0, last);
      } else if (k > 0) {
        burn_row_publish<T>(L, v, b ^ 1, kRows - 1, row0, nullptr);
      }
#pragma unroll
      for (int j = 0; j < kCw; ++j) v[j] = next[j];
    }
  }
  if (iters > 0) {
    burn_row_publish<T>(L, v, static_cast<int>((it0 + iters - 1) & 1),
                        kRows - 1, row0, out);
  }
}

// The panel's columns C_rank of y_it (copy it & 1) into `out`, once every
// row of y_it is published.
template <int T>
__device__ __forceinline__ void burn_store_panel(float* panel, int rank,
                                                 int64_t row0, int64_t it,
                                                 float* __restrict__ out) {
  using B = Burn<T>;
  constexpr int W = B::W;
  const int b = static_cast<int>(it & 1);
  if (it > 0) {
    const uint32_t bars = smem_u32(panel) + B::kPanelBytes;
    for (int r = 0; r < kRows; ++r) {
      mbar_wait(bars + 8 * (b * kRows + r), burn_parity(it));
    }
  }
  const float* y = panel + b * kRows * B::P;
  for (int i = threadIdx.x; i < kRows * W / 4; i += kThreads) {
    const int r = i / (W / 4);
    const int col = rank * W + (i % (W / 4)) * 4;
    *reinterpret_cast<float4*>(out + (row0 + r) * T + col) =
        *reinterpret_cast<const float4*>(y + r * B::P + pos(col));
  }
}

}  // namespace synapse
