// Flash attention forward for Hopper (sm_90a), float32 and bfloat16.
//
// Replaces src/repro/kernels/flash_attention/kernel.py:flash_attention (the
// Pallas _fa_kernel): FlashAttention-2 forward with float32 online softmax,
// causal mask, sliding window and tanh softcap, over q [BH, Sq, hd] and
// k, v [BKV, Sk, hd], where query head h reads KV head h / group
// (BH = BKV * group).  The output has q's dtype.  This file holds the C
// entry point, which picks the kernel by dtype: float32 runs the SIMT
// kernel below, bfloat16 the tensor-core kernel of flash_attention_sm90.cu.
//
// What both keep of the reference, where a textbook kernel would differ:
//   * the mask is the finite NEG_INF = -0.7 * FLT_MAX on absolute positions
//     from 0 on both axes (also when Sq != Sk), so a row that sees no key
//     at all averages every value, as the dense softmax does;
//   * logits are the float32-accumulated q.k, scaled by hd^-0.5, then
//     softcapped (cap * tanh(s / cap));
//   * p is rounded to v's dtype before the PV product; l sums the unrounded
//     p; the output is acc / max(l, 1e-30) rounded to q's dtype;
//   * float32 inputs use exact float32 FMA, never TF32: the tensor cores
//     have no exact float32 product, and the reference's float32 tolerance
//     (2e-5) rules TF32 out.
//
// Bound of the float32 kernel.  Operations at the serving shape (B 4,
// S 2048, 28 query and 4 KV heads, hd 128, causal): the mask leaves
// S(S+1)/2 (query, key) pairs a head, each 4 * hd flops (QK^T and PV),
// 1.2032e11 flops, 1.80 ms at the H100's 67 TFLOP/s of float32 FMA outside
// the tensor cores.  Its bytes (q, k, v read once, out written once,
// 268 MB) take 0.08 ms at 3.35 TB/s.  So it is bound by the FMA pipes, and
// an SM reaches their rate only if nearly every instruction its four
// schedulers issue is an FFMA and some warp is always ready to issue one.
//
// Design of the float32 kernel (warp-specialised, one block an SM):
//   * A block owns BQ query rows of one flat head and walks its kv tiles
//     of BKV keys in a loop (the TPU's grid walks them in order; Hopper's
//     blocks run in no order).  Three warpgroups: two of consumers (two
//     warps a scheduler) and the producer's.  setmaxnreg moves registers
//     from the producer's warpgroup (24 a thread) to the consumers (240):
//     at launch a scheduler holds three warps, which caps every thread at
//     168, too few for the tiles below.
//   * The producer's one thread keeps TMA loads (cp.async.bulk.tensor,
//     3-D float32 tensor maps [heads, S, hd] built on the host through
//     cudaGetDriverEntryPointByVersion, so no -lcuda) in flight into a
//     ring of 3 stages guarded by mbarriers (full: the bytes arrived;
//     empty: all 8 consumer warps are done).  A stage holds half a kv
//     tile of K or V; the ring streams K's halves, then V's, tile after
//     tile, so V and the next K arrive while the scores are computed.
//     Q arrives once.  TMA's zero fill past the sequence and past the head
//     dim takes the place of a staging loop's.
//   * Bank conflicts: a TMA box is CW + 4 columns wide (CW = min(hd, 128)
//     padded up), so a row's pitch is 4 words past a multiple of 32
//     banks and the rows a warp reads together fall on distinct banks;
//     the 4 extra columns are the next columns' data or zero fill, never
//     read.
//   * Register tiles: a warp owns a block of 2 TR query rows, a half-warp
//     the rows row0 + 2i of it.  For the scores a lane owns TR x KPT of
//     them, keys c + 16j; for the output TR rows x hd/16 columns, the
//     float4 column groups 4c + 64jj.  Every shared load is 128 bits:
//     per 4 head dims a lane loads TR float4 of Q and KPT of K for
//     4 * TR * KPT FMAs (16 FMAs a load at 8 x 8), and per 4 keys TR
//     float4 of P and 4 * hd/64 of V (16 at 8 x 8 and hd 128).  Q's and
//     P's next float4s load while the current ones are multiplied.
//   * The softmax runs in registers, with the reference's roundings up to
//     x - m (p = ex2.approx.ftz((x - m) log2(e)); scaling the logit by
//     log2(e) first moved a saturated full-width model's outputs by 2e-4):
//     a row's max is four shuffles across its half-warp, l stays a
//     per-lane partial sum until the end.
//     p goes through shared memory from the score layout to the output
//     layout, half a tile at a time, in a region of the warp's own (only
//     its own lanes write and read it: __syncwarp, no block barrier).
//   * kv tiles that are wholly masked for every row of the query tile
//     (above the diagonal, or before the window) are skipped: the
//     reference multiplies their contribution by alpha = exp(NEG_INF - m)
//     = 0 exactly.  On the causal diagonal a warp also leaves out the key
//     columns past its last row, in pairs (nj of KPT), and the PV steps
//     of their keys; warps w and w + 4 share a scheduler and own row
//     blocks w and 7 - w, so each scheduler keeps 9/16 of a full tile's
//     work there.  Neither skip is taken when some row of the query tile
//     sees no key at all.  Query tiles are issued longest causal rows
//     first: every head's last tile, then the one before.
//   * Tiles for each head-dim template (hd 8-256, a multiple of 8):
//       hd <= 64:  HDP 64,  TR 8, KPT 8: BQ 128, BKV 128, 125 KB smem;
//       hd <= 128: HDP 128, TR 8, KPT 8: BQ 128, BKV 128, 205 KB smem
//                  (Q 66 KB, ring 3 x 33 KB, P 8 x 5 KB);
//       hd <= 256: HDP 256, TR 4, KPT 4: BQ 64,  BKV 64,  177 KB smem.
#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

namespace synapse {
cudaError_t flash_attention_bf16_sm90(const void* q, const void* k,
                                      const void* v, void* out, int64_t BH,
                                      int64_t BKV, int64_t Sq, int64_t Sk,
                                      int hd, int causal, int64_t window,
                                      float softcap, float scale, int device,
                                      cudaStream_t s);
}  // namespace synapse

namespace {

constexpr int kConsumerWarps = 8;                      // two warpgroups
constexpr int kThreads = 32 * (kConsumerWarps + 4);    // + the producer's
// registers a thread after setmaxnreg: the producer's warpgroup gives up
// what the consumers take (each scheduler: 24 + 2 x 240 of 512 a lane)
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kStages = 3;                             // ring of half tiles
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

// 2^x, flushing results below 2^-126 to 0 (p of such a key adds nothing
// to a row whose largest p is 1); 2^-inf = 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lane_of(const float4& x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

// Shapes of one template instance.  Q, a stage and P are row-major tiles
// with the TMA box's pitch; a tile of hd > 128 is NCH boxes of CW columns
// one after the other.
template <int HDP, int TR, int KPT>
struct Tiles {
  static constexpr int BQ = 16 * TR;         // query rows: 8 warps x 2 TR
  static constexpr int BKV = 16 * KPT;       // keys: 16 column groups
  static constexpr int HALF = BKV / 2;       // keys a stage
  static constexpr int CW = HDP < 128 ? HDP : 128;  // columns a box
  static constexpr int NCH = HDP / CW;       // boxes across the head dim
  static constexpr int LD = CW + 4;          // a box row's pitch, floats
  static constexpr int PLD = HALF + 16;      // P's pitch: 16 mod 32 banks
  static constexpr int NQ = HDP / 64;        // output float4s a row a lane
  static constexpr uint32_t kQBytes = NCH * BQ * LD * 4;
  static constexpr uint32_t kStageBytes = NCH * HALF * LD * 4;
  static constexpr uint32_t kPWarp = 2 * TR * PLD * 4;
  // 128 bytes to align the base for TMA, Q, the ring, P, 2 x 3 + 1 mbarriers
  static constexpr size_t kSmem = 128 + kQBytes + kStages * kStageBytes +
                                  kConsumerWarps * kPWarp +
                                  (2 * kStages + 1) * 8;
  static_assert(KPT % 2 == 0 && HDP % 64 == 0 && HDP % CW == 0, "tiles");
  static_assert(kQBytes % 128 == 0 && kStageBytes % 128 == 0 &&
                    (HALF * LD * 4) % 128 == 0 && kPWarp % 16 == 0,
                "TMA destinations must stay 128-byte aligned");
};

// S += Q K^T for the lane's keys j < NJ (keys c + 16j: K's first half from
// Ka, its second from Kb) and rows row0 + 2i, 4 head dims a step
template <int HDP, int TR, int KPT, int NJ>
__device__ __forceinline__ void qk(float (&s)[TR][KPT], const float* sQ,
                                   const float* Ka, const float* Kb,
                                   int row0, int c) {
  using L = Tiles<HDP, TR, KPT>;
#pragma unroll
  for (int ch = 0; ch < L::NCH; ++ch) {
    const float* qc = sQ + ch * L::BQ * L::LD + row0 * L::LD;
    const float* ka = Ka + ch * L::HALF * L::LD + c * L::LD;
    const float* kb = Kb + ch * L::HALF * L::LD + c * L::LD;
    // Q's next 4 head dims load while these are multiplied (at d + 4 == CW
    // they are the box's padding, loaded and never used)
    float4 qv[TR], qn[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      qv[i] = *reinterpret_cast<const float4*>(qc + 2 * i * L::LD);
    }
#pragma unroll 2
    for (int d = 0; d < L::CW; d += 4) {
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        qn[i] = *reinterpret_cast<const float4*>(qc + 2 * i * L::LD + d + 4);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float* kr =
            (j < KPT / 2 ? ka : kb) + 16 * (j % (KPT / 2)) * L::LD;
        const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < TR; ++i) qv[i] = qn[i];
    }
  }
}

template <int HDP, int TR, int KPT>
__global__ void __launch_bounds__(kThreads, 1)
    fa_simt_f32(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                float* __restrict__ out, int Sq, int Sk, int hd, int BH,
                int group, int nqt, int causal, long long window,
                float softcap, float scale) {
  using L = Tiles<HDP, TR, KPT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  float* sQ = reinterpret_cast<float*>(base);
  float* ring = reinterpret_cast<float*>(base + L::kQBytes);
  float* sP = reinterpret_cast<float*>(base + L::kQBytes +
                                       kStages * L::kStageBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      base + L::kQBytes + kStages * L::kStageBytes +
      kConsumerWarps * L::kPWarp);
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;              // [kStages]
  uint64_t* empty = bars + 1 + kStages;   // [kStages]
  constexpr int kStageFloats = L::kStageBytes / 4;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // the last query tile of every head first: the longest causal rows
  const int bh = blockIdx.x % BH;
  const int q0 = (nqt - 1 - int(blockIdx.x / BH)) * L::BQ;
  const int kvh = bh / group;

  // the kv range this query tile visits
  const int qlast = (q0 + L::BQ < Sq ? q0 + L::BQ : Sq) - 1;
  int kbeg = 0, kend = Sk;
  const bool every_row_sees_a_key =
      window < 0 || (window >= 1 && qlast - window + 1 <= Sk - 1);
  if (every_row_sees_a_key) {
    if (causal && qlast + 1 < Sk) kend = qlast + 1;
    if (window >= 0 && q0 - window + 1 > 0) kbeg = int(q0 - window + 1);
  }
  kbeg -= kbeg % L::BKV;
  const int ntiles = (kend - kbeg + L::BKV - 1) / L::BKV;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // the producer's warpgroup, one thread of it: Q once, then half tiles
    // n = 4t + h (h: K's first and second half, V's first and second) into
    // stage n % kStages
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumerWarps && lane == 0) {
      mbar_expect_tx(qbar, L::kQBytes);
#pragma unroll
      for (int ch = 0; ch < L::NCH; ++ch) {
        tma_load(sQ + ch * L::BQ * L::LD, &tq, qbar, ch * L::CW, q0, bh);
      }
      for (int n = 0; n < 4 * ntiles; ++n) {
        const int s = n % kStages;
        if (n >= kStages) mbar_wait(&empty[s], (n / kStages - 1) & 1);
        const CUtensorMap* map = (n & 2) ? &tv : &tk;
        const int row = kbeg + (n >> 2) * L::BKV + (n & 1) * L::HALF;
        float* dst = ring + s * kStageFloats;
        mbar_expect_tx(&full[s], L::kStageBytes);
#pragma unroll
        for (int ch = 0; ch < L::NCH; ++ch) {
          tma_load(dst + ch * L::HALF * L::LD, map, &full[s], ch * L::CW,
                   row, kvh);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  // a consumer lane: a block of RB = 2 TR rows a warp, rows row0 + 2i of
  // it a half-warp, column group c (keys c + 16j of a tile; output columns
  // 4c + 64jj).  Warps w and w + 4 share a scheduler and take blocks w and
  // 7 - w, so that on the causal diagonal each scheduler has the same work
  constexpr int RB = 2 * TR;
  const int gl = lane / 16;
  const int c = lane % 16;
  const int rb = warp < 4 ? warp : 11 - warp;
  const int row0 = RB * rb + gl;
  // the warp's P region: row i of this half-warp at 2i + gl
  float* Pw = sP + warp * (L::kPWarp / 4) + gl * L::PLD;

  float m[TR], l[TR], acc[TR][4 * L::NQ];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < 4 * L::NQ; ++e) acc[i][e] = 0.0f;
  }
  // with every row seeing some key, keys that no row of this warp sees
  // add exactly 0 (as the skipped tiles above): on the causal diagonal the
  // warp leaves the key columns c + 16j past its last row out
  const bool may_skip = causal && every_row_sees_a_key;
  const int warp_last = q0 + RB * rb + RB - 1;
  mbar_wait(qbar, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = kbeg + t * L::BKV;
    const int n = 4 * t;
    const float* Ka = ring + (n % kStages) * kStageFloats;
    const float* Kb = ring + ((n + 1) % kStages) * kStageFloats;

    // S = Q K^T: TR x KPT a lane, of the first nj key columns (an even
    // count, at least what some row of the warp sees); the scores left
    // out stay 0, which the mask below turns into NEG_INF
    int nj = KPT;
    if (may_skip && warp_last - k0 + 1 < 16 * KPT) {
      nj = ((warp_last - k0 + 16) / 16 + 1) & ~1;
    }
    float s[TR][KPT];
#pragma unroll
    for (int i = 0; i < TR; ++i) {
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.0f;
    }
    // every stage is waited for, used or not: an arrival on its empty
    // barrier must follow its load
    mbar_wait(&full[n % kStages], (n / kStages) & 1);
    mbar_wait(&full[(n + 1) % kStages], ((n + 1) / kStages) & 1);
    if (nj >= KPT) {
      qk<HDP, TR, KPT, KPT>(s, sQ, Ka, Kb, row0, c);
    } else if (nj <= 2) {
      qk<HDP, TR, KPT, 2>(s, sQ, Ka, Kb, row0, c);
    } else if (nj <= 4) {
      qk<HDP, TR, KPT, (4 < KPT ? 4 : KPT)>(s, sQ, Ka, Kb, row0, c);
    } else {
      qk<HDP, TR, KPT, (6 < KPT ? 6 : KPT)>(s, sQ, Ka, Kb, row0, c);
    }
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(&empty[n % kStages]);
      mbar_arrive(&empty[(n + 1) % kStages]);
    }

    // the softmax, in the reference's order of roundings: the logit
    // x = s * scale, or cap * tanh(x / cap); masked keys take the finite
    // NEG_INF, keys past Sk -inf (so p = 0); the rows' running max over
    // the half-warp; p = 2^((x - m) log2(e)); l and acc's rescale
    if (softcap > 0.0f) {
#pragma unroll
      for (int i = 0; i < TR; ++i) {
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          s[i][j] = softcap * tanhf(s[i][j] * scale / softcap);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < TR; ++i) {
#pragma unroll
        for (int j = 0; j < KPT; ++j) s[i][j] *= scale;
      }
    }
    if ((causal && k0 + L::BKV - 1 > q0) || window >= 0 ||
        k0 + L::BKV > Sk) {
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int qp = q0 + row0 + 2 * i;
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          const int kp = k0 + c + 16 * j;
          const bool ok =
              (!causal || kp <= qp) && (window < 0 || qp - kp < window);
          s[i][j] = kp >= Sk ? __uint_as_float(0xff800000u)
                             : (ok ? s[i][j] : kNegInf);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < KPT; ++j) mx = fmaxf(mx, s[i][j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      const float alpha = exp2_ftz((m[i] - mx) * kLog2e);
      m[i] = mx;
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float p = exp2_ftz((s[i][j] - mx) * kLog2e);
        s[i][j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int e = 0; e < 4 * L::NQ; ++e) acc[i][e] *= alpha;
    }

    // O += P V, half a tile at a time: the warp's p of the half into its
    // P region, then 4 keys a step
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int nv = n + 2 + h;
      // this half's keys up to the nj columns (p of the rest are 0)
      const int kn = 16 * nj - h * L::HALF < L::HALF ? 16 * nj - h * L::HALF
                                                     : L::HALF;
      __syncwarp();  // the last half's readers are done
#pragma unroll
      for (int i = 0; i < TR; ++i) {
#pragma unroll
        for (int j = 0; j < KPT / 2; ++j) {
          Pw[2 * i * L::PLD + c + 16 * j] = s[i][h * (KPT / 2) + j];
        }
      }
      __syncwarp();
      mbar_wait(&full[nv % kStages], (nv / kStages) & 1);
      const float* vh = ring + (nv % kStages) * kStageFloats + 4 * c;
      // p of the next 4 keys loads while these are multiplied (at kk + 4
      // == HALF it is P's padding, never used; kn <= 0 loads nothing used)
      float4 pv[TR], pn[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        pv[i] = *reinterpret_cast<const float4*>(Pw + 2 * i * L::PLD);
      }
#pragma unroll 4
      for (int kk = 0; kk < kn; kk += 4) {
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          pn[i] = *reinterpret_cast<const float4*>(Pw + 2 * i * L::PLD + kk +
                                                   4);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int jj = 0; jj < L::NQ; ++jj) {
            // column 4c + 64jj: box (64jj) / CW, column in it (64jj) % CW
            const float4 vv = *reinterpret_cast<const float4*>(
                vh + (64 * jj / L::CW) * L::HALF * L::LD +
                (kk + u) * L::LD + (64 * jj) % L::CW);
#pragma unroll
            for (int i = 0; i < TR; ++i) {
              const float p = lane_of(pv[i], u);
              acc[i][4 * jj + 0] = fmaf(p, vv.x, acc[i][4 * jj + 0]);
              acc[i][4 * jj + 1] = fmaf(p, vv.y, acc[i][4 * jj + 1]);
              acc[i][4 * jj + 2] = fmaf(p, vv.z, acc[i][4 * jj + 2]);
              acc[i][4 * jj + 3] = fmaf(p, vv.w, acc[i][4 * jj + 3]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < TR; ++i) pv[i] = pn[i];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[nv % kStages]);
    }
  }

  // a row's sum over its half-warp, then acc / max(l, 1e-30)
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li += __shfl_xor_sync(0xffffffffu, li, 4);
    li += __shfl_xor_sync(0xffffffffu, li, 8);
    const int qp = q0 + row0 + 2 * i;
    if (qp >= Sq) continue;
    const float denom = fmaxf(li, 1e-30f);
    float* row = out + (int64_t(bh) * Sq + qp) * hd;
#pragma unroll
    for (int jj = 0; jj < L::NQ; ++jj) {
      const int d = 4 * c + 64 * jj;
      if (d < hd) {
        *reinterpret_cast<float4*>(row + d) = make_float4(
            acc[i][4 * jj + 0] / denom, acc[i][4 * jj + 1] / denom,
            acc[i][4 * jj + 2] / denom, acc[i][4 * jj + 3] / denom);
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

// A map of a [heads, S, hd] float32 array in boxes of rows x cols, no
// swizzle, zeros past the edges.
bool tensor_map(CUtensorMap* map, const void* ptr, int64_t heads, int64_t S,
                int hd, int cols, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {cuuint64_t(hd), cuuint64_t(S),
                              cuuint64_t(heads)};
  const cuuint64_t strides[2] = {cuuint64_t(hd) * 4,
                                 cuuint64_t(S) * hd * 4};
  const cuuint32_t box[3] = {cuuint32_t(cols), cuuint32_t(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kMaxDevices = 64;

template <int HDP, int TR, int KPT>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int64_t BH, int64_t BKVh, int64_t Sq, int64_t Sk, int hd,
                   int causal, int64_t window, float softcap, float scale,
                   int device, cudaStream_t stream) {
  using L = Tiles<HDP, TR, KPT>;
  auto kernel = fa_simt_f32<HDP, TR, KPT>;
  // above 48 KB of dynamic shared memory a kernel must opt in, once per
  // device (before any stream capture: it is not a stream operation)
  static bool opted_in[kMaxDevices] = {};
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L::kSmem));
    if (err != cudaSuccess) return err;
    opted_in[device] = true;
  }
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, BH, Sq, hd, L::LD, L::BQ) ||
      !tensor_map(&tk, k, BKVh, Sk, hd, L::LD, L::HALF) ||
      !tensor_map(&tv, v, BKVh, Sk, hd, L::LD, L::HALF)) {
    return cudaErrorInvalidValue;
  }
  const int64_t nqt = (Sq + L::BQ - 1) / L::BQ;
  const int64_t blocks = BH * nqt;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, L::kSmem, stream>>>(
      tq, tk, tv, static_cast<float*>(out), int(Sq), int(Sk), hd, int(BH),
      int(BH / BKVh), int(nqt), causal, window, softcap, scale);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int64_t BH, int64_t BKV, int64_t Sq, int64_t Sk, int hd,
                     int causal, int64_t window, float softcap, float scale,
                     int device, cudaStream_t s) {
  // head dims padded to HDP, TR rows x KPT keys of scores a lane
  if (hd <= 64) {
    return launch<64, 8, 8>(q, k, v, out, BH, BKV, Sq, Sk, hd, causal,
                            window, softcap, scale, device, s);
  }
  if (hd <= 128) {
    return launch<128, 8, 8>(q, k, v, out, BH, BKV, Sq, Sk, hd, causal,
                             window, softcap, scale, device, s);
  }
  return launch<256, 4, 4>(q, k, v, out, BH, BKV, Sq, Sk, hd, causal,
                           window, softcap, scale, device, s);
}

}  // namespace

// q [BH, Sq, hd], k and v [BKV, Sk, hd], out [BH, Sq, hd]: contiguous,
// 16-byte aligned arrays on `device` of float32 (dtype 0) or bfloat16
// (dtype 1); BH a multiple of BKV; Sq and Sk below 2^31; hd a multiple of
// 8 up to 256.  `causal`
// 0 or 1; `window` the sliding window in tokens, or -1 for none; `softcap`
// the logit cap, or 0 for none; `scale` the logit scale (hd^-0.5).
// Float32 runs the SIMT kernel here, bfloat16 the tensor-core kernel of
// flash_attention_sm90.cu.  Launches one kernel on `stream`, allocates
// nothing, and returns the launch error, or cudaSuccess.
extern "C" int synapse_flash_attention(
    const void* q, const void* k, const void* v, void* out, int64_t BH,
    int64_t BKV, int64_t Sq, int64_t Sk, int64_t hd, int64_t dtype,
    int64_t causal, int64_t window, double softcap, double scale,
    int64_t device, void* stream) {
  if (BH <= 0 || BKV <= 0 || BH % BKV || Sq <= 0 || Sk <= 0 || hd <= 0 ||
      hd > 256 || hd % 8 || Sq > INT32_MAX || Sk > INT32_MAX ||
      (dtype != 0 && dtype != 1) ||
      (causal != 0 && causal != 1) || window < -1 || softcap < 0.0) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch(q, k, v, out, BH, BKV, Sq, Sk, int(hd), int(causal),
                    window, float(softcap), float(scale), int(device), s);
  }
  return synapse::flash_attention_bf16_sm90(
      q, k, v, out, BH, BKV, Sq, Sk, int(hd), int(causal), window,
      float(softcap), float(scale), int(device), s);
}
