// Flash attention forward for Hopper (sm_90a), bfloat16 on the tensor cores.
//
// Replaces src/repro/kernels/flash_attention/kernel.py:flash_attention (the
// Pallas _fa_kernel) for bfloat16 inputs; flash_attention.cu holds the
// float32 kernel and the C entry point that picks one of the two by dtype.
// It computes what flash_attention.cu's header lists: the finite NEG_INF
// mask on absolute positions, the hd^-0.5 scale then the tanh softcap, the
// row max and sum in float32, l summing the unrounded p while the PV
// product takes p rounded to bfloat16, and acc / max(l, 1e-30) in bfloat16.
//
// Bound.  Operations: 1.2e11 flops at the serving shape (B 4, S 2048, 28
// query heads, hd 128, causal), 0.12 ms at the H100's 989 TFLOP/s bf16
// dense; its bytes take 0.04 ms at 3.35 TB/s.
//
// Design.  A block of 256 threads owns 128 query rows of one flat head as
// two warpgroups of 64 rows (wgmma's M) and walks the kv tiles in a loop.
//   * Loads: Q, K and V come in through TMA (cp.async.bulk.tensor, 3-D
//     tensor maps [heads, S, hd] built on the host, passed as
//     __grid_constant__ parameters) with the 128-byte swizzle; one thread
//     issues them.  A 128-byte swizzle row is 64 bf16 values, so a tile of
//     hd columns is hd/64 boxes of 64 columns ("chunks").  TMA zero-fills
//     past the sequence and past the head dim, so ragged lengths and head
//     dims below 64 need no padding.  K and V go into rings of two and
//     three stages guarded by mbarriers (full: the bytes arrived; empty:
//     all 8 warps are done with the stage); the loads of tile t+1 are
//     issued while tile t is computed.
//   * S = Q K^T: wgmma.mma_async m64nBKVk16, bf16 in, float32 accumulate,
//     both operands K-major in shared memory (K as stored); one
//     instruction a k-step of 16 head dims.
//   * The softmax runs in the accumulator layout: a thread holds two rows
//     (r and r+8 of its warp's 16), each row spread over a quad of lanes,
//     so row max and row sum are shfl_xor 1 and 2.
//   * O += P V: the register-A variant, m64n64k16.  The float32 S fragment
//     rounded to bf16 pairs is already wgmma's A layout for 16-bit types;
//     V is read as an MN-major B operand (transpose bit set).  hd/64
//     instructions a k-step of 16 keys.
//   * Within a warpgroup, S_t = Q K_t^T and O += P_{t-1} V_{t-1} are in
//     flight together: the softmax of tile t runs while the tensor cores
//     do the PV product of tile t-1 (p of tile t-1 waits in registers as
//     bf16 pairs, so V's ring needs the third stage).
//   * kv tile 128 at hd <= 128 and 64 at hd 256: 193 and 225 KB of shared
//     memory (Q, two stages of K, three of V).
// It keeps flash_attention.cu's tile skip (tiles wholly masked for every
// row of the block are not visited, unless some row sees no key at all)
// and issues the longest causal rows first: blocks run the last query tile
// of every head, then the one before.
//
// Left for later: a producer warpgroup with setmaxnreg, ping-pong between
// the two warpgroups so that one's softmax overlaps the other's products,
// and wider instructions for O += P V.
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kBQ = 128;       // query rows a block
constexpr int kChunk = 64;     // bf16 columns of one 128-byte swizzle row
// the reference's -0.7 * float32 max, rounded once to float32
constexpr float kNegInf = static_cast<float>(-0.7 * 3.4028234663852886e38);
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait until the phase with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// -- TMA ---------------------------------------------------------------------

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// -- wgmma -------------------------------------------------------------------

// A shared-memory matrix descriptor for the 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (B128).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous wgmma that writes it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define SYN_D32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}"
#define SYN_D64                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
  "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
  "%57, %58, %59, %60, %61, %62, %63}"
#define SYN_ACC32(d, b)                                                   \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),         \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7]),     \
      "+f"(d[b + 8]), "+f"(d[b + 9]), "+f"(d[b + 10]), "+f"(d[b + 11]),   \
      "+f"(d[b + 12]), "+f"(d[b + 13]), "+f"(d[b + 14]), "+f"(d[b + 15]), \
      "+f"(d[b + 16]), "+f"(d[b + 17]), "+f"(d[b + 18]), "+f"(d[b + 19]), \
      "+f"(d[b + 20]), "+f"(d[b + 21]), "+f"(d[b + 22]), "+f"(d[b + 23]), \
      "+f"(d[b + 24]), "+f"(d[b + 25]), "+f"(d[b + 26]), "+f"(d[b + 27]), \
      "+f"(d[b + 28]), "+f"(d[b + 29]), "+f"(d[b + 30]), "+f"(d[b + 31])

// d[64 x N] (+)= A[64 x 16] B[16 x N] for N 64 or 128 (32 or 64 floats a
// thread); A and B K-major in shared memory.  scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SYN_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : SYN_ACC32(d, 0)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SYN_D64
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : SYN_ACC32(d, 0), SYN_ACC32(d, 32)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 64] += A[64 x 16] B[16 x 64]; A in registers (four bf16 pairs a
// thread), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SYN_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : SYN_ACC32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef SYN_D32
#undef SYN_D64
#undef SYN_ACC32

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int HDP, int BKV>
struct Tiles {
  static constexpr int NC = HDP / kChunk;        // 64-column chunks of hd
  static constexpr uint32_t kQBytes = NC * kBQ * 128;
  static constexpr uint32_t kKVChunk = BKV * 128;  // one chunk of K or V
  static constexpr uint32_t kStage = NC * kKVChunk;  // K or V, one stage
  static constexpr int kKStages = 2, kVStages = 3;
  // 1024 bytes to align the base for the swizzle, Q, the K and V rings,
  // eleven mbarriers
  static constexpr size_t kSmem =
      1024 + kQBytes + size_t(kKStages + kVStages) * kStage + 128;
};

// One ring of K or V tiles in shared memory: tile t sits in stage t % N,
// `full` completes when its bytes arrived, `empty` when all 8 warps are
// done with it.  Waits pass the parity of the tile's use of its stage.
template <int N>
struct Ring {
  unsigned char* smem;
  uint64_t* full;   // [N]
  uint64_t* empty;  // [N]
  uint32_t stage_bytes;
  __device__ __forceinline__ unsigned char* tile(int t) const {
    return smem + (t % N) * stage_bytes;
  }
  __device__ __forceinline__ void wait_full(int t) const {
    mbar_wait(&full[t % N], (t / N) & 1);
  }
  __device__ __forceinline__ void wait_empty(int t) const {
    mbar_wait(&empty[t % N], (t / N) & 1);
  }
  // one elected lane of each warp, once the warp is done with tile t
  __device__ __forceinline__ void release(int t) const {
    mbar_arrive(&empty[t % N]);
  }
  // one thread: tile t (keys k0 ..) of a [heads, S, hd] map, all chunks
  template <int NC>
  __device__ __forceinline__ void load(const CUtensorMap* map, int t, int k0,
                                       int head) const {
    mbar_expect_tx(&full[t % N], stage_bytes);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      tma_load(tile(t) + c * (stage_bytes / NC), map, &full[t % N],
               c * kChunk, k0, head);
    }
  }
};

// S = Q K^T for this warpgroup's 64 rows: one m64nBKVk16 a k-step of 16
// head dims; Q and K K-major with the 128-byte swizzle
template <int NC, int BKV>
__device__ __forceinline__ void qk_product(float (&sacc)[BKV / 2],
                                           uint32_t aQ, uint32_t aK) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t da = gmma_desc(aQ + c * kBQ * 128 + ks * 32, 16, 1024);
      const uint64_t db = gmma_desc(aK + c * BKV * 128 + ks * 32, 16, 1024);
      wgmma_ss(sacc, da, db, (c | ks) != 0);
    }
  }
}

// O += P V: P in registers (bf16 pairs), V MN-major with the 128-byte
// swizzle, one m64n64k16 a chunk of 64 head dims and 16 keys
template <int NC, int BKV>
__device__ __forceinline__ void pv_product(float (&o)[NC][32],
                                           const uint32_t (&pa)[BKV / 16][4],
                                           uint32_t aV) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const uint64_t db =
          gmma_desc(aV + c * BKV * 128 + kk * 16 * 128, BKV * 128, 1024);
      wgmma_rs(o[c], pa[kk], db);
    }
  }
}

// The softmax of one kv tile in the accumulator layout: scale, softcap and
// mask the logits (keys past Sk drop out as -inf, so p = 0; masked keys
// take the finite NEG_INF as in the reference), update the running max m
// and this thread's share of the sum l of its two rows, and leave the
// unrounded p in sacc.  Returns the factors alpha by which the rows' old
// sums and outputs shrink.
template <int BKV>
__device__ __forceinline__ float2 softmax_tile(
    float (&sacc)[BKV / 2], int k0, int q0, int qp0, int kq, int Sk,
    int causal, long long window, float softcap, float scale, float2& m,
    float2& l) {
  const bool need_mask =
      (causal && k0 + BKV - 1 > q0) || window >= 0 || k0 + BKV > Sk;
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) {
    float x = sacc[i] * scale;
    if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
    if (need_mask) {
      const int kp = k0 + 8 * (i / 4) + kq + (i % 2);
      const int qp = (i % 4) < 2 ? qp0 : qp0 + 8;
      const bool ok =
          (!causal || kp <= qp) && (window < 0 || qp - kp < window);
      x = kp >= Sk ? __uint_as_float(0xff800000u) : (ok ? x : kNegInf);
    }
    sacc[i] = x;
    if ((i % 4) < 2) {
      mx0 = fmaxf(mx0, x);
    } else {
      mx1 = fmaxf(mx1, x);
    }
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m.x, mx0), mn1 = fmaxf(m.y, mx1);
  const float2 alpha = make_float2(exp2f((m.x - mn0) * kLog2e),
                                   exp2f((m.y - mn1) * kLog2e));
  m = make_float2(mn0, mn1);
  float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) {
    const bool row0 = (i % 4) < 2;
    const float p = exp2f((sacc[i] - (row0 ? mn0 : mn1)) * kLog2e);
    sacc[i] = p;
    if (row0) {
      rs0 += p;
    } else {
      rs1 += p;
    }
  }
  l = make_float2(l.x * alpha.x + rs0, l.y * alpha.y + rs1);
  return alpha;
}

// p rounded to bf16 pairs in wgmma's A layout for 16-bit types, 16 keys a
// k-step: the accumulator's n8 blocks 2 kk and 2 kk + 1
template <int BKV>
__device__ __forceinline__ void pack_p(const float (&sacc)[BKV / 2],
                                       uint32_t (&pa)[BKV / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    const float* p = sacc + 8 * kk;
    pa[kk][0] = pack_bf16(p[0], p[1]);  // row r, keys kq, kq + 1
    pa[kk][1] = pack_bf16(p[2], p[3]);  // row r + 8
    pa[kk][2] = pack_bf16(p[4], p[5]);  // row r, keys kq + 8, kq + 9
    pa[kk][3] = pack_bf16(p[6], p[7]);  // row r + 8
  }
}

template <int HDP, int BKV>
__global__ void __launch_bounds__(kThreads, 1)
    fa_sm90(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            __nv_bfloat16* __restrict__ out, int Sq, int Sk, int hd, int BH,
            int group, int nqt, int causal, long long window, float softcap,
            float scale) {
  using L = Tiles<HDP, BKV>;
  constexpr int NC = L::NC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = base;
  unsigned char* sK = sQ + L::kQBytes;
  unsigned char* sV = sK + L::kKStages * L::kStage;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(sV + L::kVStages * L::kStage);
  uint64_t* qbar = bars;
  const Ring<L::kKStages> K{sK, bars + 1, bars + 3, L::kStage};
  const Ring<L::kVStages> V{sV, bars + 5, bars + 8, L::kStage};

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  // the last query tile of every head first: the longest causal rows
  const int bh = blockIdx.x % BH;
  const int q0 = (nqt - 1 - int(blockIdx.x / BH)) * kBQ;
  const int kvh = bh / group;

  // the kv range this query tile visits (as flash_attention.cu)
  const int qlast = (q0 + kBQ < Sq ? q0 + kBQ : Sq) - 1;
  int kbeg = 0, kend = Sk;
  const bool every_row_sees_a_key =
      window < 0 || (window >= 1 && qlast - window + 1 <= Sk - 1);
  if (every_row_sees_a_key) {
    if (causal && qlast + 1 < Sk) kend = qlast + 1;
    if (window >= 0 && q0 - window + 1 > 0) kbeg = int(q0 - window + 1);
  }
  kbeg -= kbeg % BKV;
  const int ntiles = (kend - kbeg + BKV - 1) / BKV;

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < L::kKStages; ++s) {
      mbar_init(&K.full[s], 1);
      mbar_init(&K.empty[s], kThreads / 32);
    }
    for (int s = 0; s < L::kVStages; ++s) {
      mbar_init(&V.full[s], 1);
      mbar_init(&V.empty[s], kThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid == 0) {
    mbar_expect_tx(qbar, L::kQBytes);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      tma_load(sQ + c * kBQ * 128, &tq, qbar, c * kChunk, q0, bh);
    }
    for (int t = 0; t < 2 && t < ntiles; ++t) {
      K.template load<NC>(&tk, t, kbeg + t * BKV, kvh);
      V.template load<NC>(&tv, t, kbeg + t * BKV, kvh);
    }
  }

  // this thread's two rows: r and r + 8 of its warp's 16
  const int qp0 = q0 + 64 * wg + 16 * warp + lane / 4;
  const int kq = 2 * (lane % 4);  // its first column in each group of 8
  float2 m = make_float2(kNegInf, kNegInf);
  float2 l = make_float2(0.0f, 0.0f);  // this thread's share of the sums
  float o[NC][32];
  float sacc[BKV / 2];          // S, then p, of the newest tile
  uint32_t pa[BKV / 16][4];     // p of the tile before it, in bf16
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) sacc[i] = 0.0f;

  const uint32_t aQ = smem_u32(sQ) + wg * 64 * 128;  // this warpgroup's rows
  mbar_wait(qbar, 0);

  // tile 0: S, softmax, p
  K.wait_full(0);
  fence_regs(sacc);
  wgmma_fence();
  qk_product<NC, BKV>(sacc, aQ, smem_u32(K.tile(0)));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sacc);
  if (lane == 0) K.release(0);
  softmax_tile<BKV>(sacc, kbeg, q0, qp0, kq, Sk, causal, window, softcap,
                    scale, m, l);
  pack_p<BKV>(sacc, pa);

  // tile t: S_t = Q K_t^T and O += P_{t-1} V_{t-1} in flight together, so
  // that the softmax of tile t overlaps the tensor cores' PV product
  for (int t = 1; t < ntiles; ++t) {
    const int k0 = kbeg + t * BKV;
    K.wait_full(t);
    fence_regs(sacc);
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(o[c]);
    wgmma_fence();
    qk_product<NC, BKV>(sacc, aQ, smem_u32(K.tile(t)));
    wgmma_commit();
    V.wait_full(t - 1);
    pv_product<NC, BKV>(o, pa, smem_u32(V.tile(t - 1)));
    wgmma_commit();
    // meanwhile one thread loads tile t + 1, into the stages of tiles
    // t - 1 (K) and t - 2 (V), once every warp is done with them
    if (tid == 0 && t + 1 < ntiles) {
      K.wait_empty(t - 1);
      K.template load<NC>(&tk, t + 1, k0 + BKV, kvh);
      if (t >= 2) V.wait_empty(t - 2);
      V.template load<NC>(&tv, t + 1, k0 + BKV, kvh);
    }
    __syncwarp();
    wgmma_wait<1>();  // S_t is in
    fence_regs(sacc);
    if (lane == 0) K.release(t);
    const float2 alpha = softmax_tile<BKV>(sacc, k0, q0, qp0, kq, Sk, causal,
                                           window, softcap, scale, m, l);
    wgmma_wait<0>();  // and P_{t-1} V_{t-1}
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(o[c]);
    if (lane == 0) V.release(t - 1);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] *= (i % 4) < 2 ? alpha.x : alpha.y;
    }
    pack_p<BKV>(sacc, pa);
  }

  // the last tile's PV product
  V.wait_full(ntiles - 1);
#pragma unroll
  for (int c = 0; c < NC; ++c) fence_regs(o[c]);
  wgmma_fence();
  pv_product<NC, BKV>(o, pa, smem_u32(V.tile(ntiles - 1)));
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < NC; ++c) fence_regs(o[c]);

  // a row's sum over its quad, then acc / max(l, 1e-30) in bf16
  float l0 = l.x, l1 = l.y;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.0f / fmaxf(l1, 1e-30f);
  const int qp1 = qp0 + 8;
  __nv_bfloat16* row0 = out + (int64_t(bh) * Sq + qp0) * hd;
  __nv_bfloat16* row1 = row0 + int64_t(8) * hd;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = c * kChunk + 8 * j + kq;
      if (d < hd) {
        if (qp0 < Sq) {
          *reinterpret_cast<uint32_t*>(row0 + d) =
              pack_bf16(o[c][4 * j] * inv0, o[c][4 * j + 1] * inv0);
        }
        if (qp1 < Sq) {
          *reinterpret_cast<uint32_t*>(row1 + d) =
              pack_bf16(o[c][4 * j + 2] * inv1, o[c][4 * j + 3] * inv1);
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled of libcuda, looked up at run time through the
// runtime's entry-point query so that the library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A map of a [heads, S, hd] bf16 array in boxes of rows x 64 columns, with
// the 128-byte swizzle and zeros past the edges.
bool tensor_map(CUtensorMap* map, const void* ptr, int64_t heads, int64_t S,
                int hd, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {cuuint64_t(hd), cuuint64_t(S),
                              cuuint64_t(heads)};
  const cuuint64_t strides[2] = {cuuint64_t(hd) * 2,
                                 cuuint64_t(S) * hd * 2};
  const cuuint32_t box[3] = {cuuint32_t(kChunk), cuuint32_t(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kMaxDevices = 64;

template <int HDP, int BKV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int64_t BH, int64_t BKVh, int64_t Sq, int64_t Sk, int hd,
                   int64_t group, int causal, int64_t window, float softcap,
                   float scale, int device, cudaStream_t stream) {
  constexpr size_t kSmem = Tiles<HDP, BKV>::kSmem;
  auto kernel = fa_sm90<HDP, BKV>;
  // above 48 KB of dynamic shared memory a kernel must opt in, once per
  // device (before any stream capture: it is not a stream operation)
  static bool opted_in[kMaxDevices] = {};
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmem));
    if (err != cudaSuccess) return err;
    opted_in[device] = true;
  }
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, BH, Sq, hd, kBQ) ||
      !tensor_map(&tk, k, BKVh, Sk, hd, BKV) ||
      !tensor_map(&tv, v, BKVh, Sk, hd, BKV)) {
    return cudaErrorInvalidValue;
  }
  const int64_t nqt = (Sq + kBQ - 1) / kBQ;
  const int64_t blocks = BH * nqt;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), int(Sq), int(Sk), hd,
      int(BH), int(group), int(nqt), causal, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace

namespace synapse {

// The bfloat16 path of synapse_flash_attention (flash_attention.cu), with
// its arguments checked there; Sq and Sk below 2^31.
cudaError_t flash_attention_bf16_sm90(const void* q, const void* k,
                                      const void* v, void* out, int64_t BH,
                                      int64_t BKV, int64_t Sq, int64_t Sk,
                                      int hd, int causal, int64_t window,
                                      float softcap, float scale, int device,
                                      cudaStream_t s) {
  const int64_t group = BH / BKV;
  if (hd <= 64) {
    return launch<64, 128>(q, k, v, out, BH, BKV, Sq, Sk, hd, group, causal,
                           window, softcap, scale, device, s);
  }
  if (hd <= 128) {
    return launch<128, 128>(q, k, v, out, BH, BKV, Sq, Sk, hd, group,
                            causal, window, softcap, scale, device, s);
  }
  return launch<256, 64>(q, k, v, out, BH, BKV, Sq, Sk, hd, group, causal,
                         window, softcap, scale, device, s);
}

}  // namespace synapse
