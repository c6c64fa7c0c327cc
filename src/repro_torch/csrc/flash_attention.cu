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
// Bound.  Operations at the serving shape: the causal mask leaves
// S(S+1)/2 (query, key) pairs a head, and each costs 4 * hd flops (QK^float and
// PV), 1.2e11 flops at B 4, S 2048, 28 query heads, hd 128: 0.12 ms at the
// H100's 989 TFLOP/s bf16 dense.  Its bytes (q, k, v read once, out written
// once, 134 MB) take 0.04 ms at 3.35 TB/s.  In float32 the SIMT pipes bound
// it (67 TFLOP/s).
//
// Design of the float32 kernel.  One block of 128 threads per (flat head,
// tile of query rows): the TPU's grid walks the kv axis in order with m, l,
// acc in VMEM; Hopper's blocks run in no order, so the kv walk is a loop
// inside the block.  The query tile and each K and V tile are staged in
// shared memory (zero-filled past the sequence and the head dim), the
// running m, l and acc stay in float32 registers, and the probabilities of
// a tile pass through shared memory from the score layout to the PV
// layout.  A thread owns RPT query rows: for the scores, every 8th key of
// the tile; for acc, every 8th pair of head dims.  The 8 threads sharing
// rows are neighbouring lanes of one warp, so row max and row sum are
// three shuffles.  kv tiles that are wholly masked for every row of the
// query tile (above the diagonal, or before the window) are skipped: the
// reference multiplies their contribution by alpha = exp(NEG_INF - m) = 0
// exactly.  A tile is never skipped when some row of the query tile sees
// no key at all.  Query tiles are issued longest causal rows first.  The
// head dim is a template argument rounded up to 32, 64, 128 or 256.
#include <cstdint>

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

constexpr int kThreads = 128;
// the reference's -0.7 * float32 max, rounded once to float32
constexpr float kNegInf = static_cast<float>(-0.7 * 3.4028234663852886e38);

// Copy rows [row0, row0 + ROWS) of a row-major [S, hd] matrix into shared
// memory with row stride LD, zero-filling rows at or past S and columns at
// or past hd (up to HDP).  16-byte global loads: hd is a multiple of 8.
template <int ROWS, int HDP, int LD>
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const float* __restrict__ src,
                                      int64_t row0, int64_t S, int hd) {
  constexpr int kChunk = 16 / sizeof(float);
  constexpr int kPerRow = HDP / kChunk;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int d = (i % kPerRow) * kChunk;
    uint4 chunk = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S && d < hd) {
      chunk = *reinterpret_cast<const uint4*>(src + (row0 + r) * hd + d);
    }
    const float* e = reinterpret_cast<const float*>(&chunk);
    float* row = dst + r * LD + d;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) row[j] = e[j];
  }
}

template <int HDP, int RPT, int BKV>
constexpr size_t smem_bytes() {
  return (size_t(16 * RPT + BKV) * (HDP + 2)   // Qs, Ks
          + size_t(BKV) * HDP                    // Vs
          + size_t(16 * RPT) * (BKV + 1))        // Ps
         * sizeof(float);
}

template <int HDP, int RPT, int BKV>
__global__ void __launch_bounds__(kThreads)
    fa_forward(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ out,
               int64_t Sq, int64_t Sk, int hd, int64_t group, int64_t nqt,
               int causal, int64_t window, float softcap, float scale) {
  constexpr int BQ = 16 * RPT;    // query rows a block
  constexpr int LDQ = HDP + 2;    // row stride of Qs and Ks (even: pairs)
  constexpr int LDP = BKV + 1;    // row stride of Ps
  constexpr int CPT = BKV / 8;    // score columns a thread
  constexpr int DPT = HDP / 16;   // acc column pairs a thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + BQ * LDQ;
  float* Vs = Ks + BKV * LDQ;
  float* Ps = reinterpret_cast<float*>(Vs + BKV * HDP);

  const int tx = threadIdx.x & 7;   // key / head-dim lane of a row group
  const int ty = threadIdx.x >> 3;  // row group: rows ty * RPT + i
  const int64_t bh = blockIdx.x / nqt;
  const int64_t q0 = (nqt - 1 - int64_t(blockIdx.x) % nqt) * BQ;
  const float* qh = q + bh * Sq * hd;
  const float* kh = k + (bh / group) * Sk * hd;
  const float* vh = v + (bh / group) * Sk * hd;

  stage<BQ, HDP, LDQ>(Qs, qh, q0, Sq, hd);

  // the kv range this query tile visits
  const int64_t qlast = (q0 + BQ < Sq ? q0 + BQ : Sq) - 1;
  int64_t kbeg = 0, kend = Sk;
  const bool every_row_sees_a_key =
      window < 0 || (window >= 1 && qlast - window + 1 <= Sk - 1);
  if (every_row_sees_a_key) {
    if (causal && qlast + 1 < Sk) kend = qlast + 1;
    if (window >= 0 && q0 - window + 1 > 0) kbeg = q0 - window + 1;
  }
  kbeg -= kbeg % BKV;

  float m[RPT], l[RPT], acc[RPT][2 * DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < 2 * DPT; ++e) acc[i][e] = 0.0f;
  }

  for (int64_t k0 = kbeg; k0 < kend; k0 += BKV) {
    __syncthreads();  // Qs is staged; the last tile's readers are done
    stage<BKV, HDP, LDQ>(Ks, kh, k0, Sk, hd);
    stage<BKV, HDP, HDP>(Vs, vh, k0, Sk, hd);
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.0f;
    }
#pragma unroll 4
    for (int d = 0; d < hd; d += 2) {
      float2 qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qv[i] = *reinterpret_cast<const float2*>(Qs + (ty * RPT + i) * LDQ +
                                                 d);
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        kv[j] =
            *reinterpret_cast<const float2*>(Ks + (tx + 8 * j) * LDQ + d);
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
        }
      }
    }

    const int64_t kn = Sk - k0 < BKV ? Sk - k0 : BKV;  // keys in this tile
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int64_t qp = q0 + ty * RPT + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tx + 8 * j;
        const int64_t kp = k0 + c;
        float x = s[i][j] * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        const bool ok =
            (!causal || kp <= qp) && (window < 0 || qp - kp < window);
        s[i][j] = ok ? x : kNegInf;
        if (c < kn) mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tx + 8 * j;
        const float p = c < kn ? expf(s[i][j] - m_new) : 0.0f;
        rs += p;
        Ps[(ty * RPT + i) * LDP + c] = p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < 2 * DPT; ++e) acc[i][e] *= alpha;
    }
    // a row's probabilities are written and read by the same 8 lanes
    __syncwarp();

#pragma unroll 4
    for (int c = 0; c < kn; ++c) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(ty * RPT + i) * LDP + c];
#pragma unroll
      for (int jj = 0; jj < DPT; ++jj) {
        const float2 vv = *reinterpret_cast<const float2*>(
            Vs + c * HDP + 2 * tx + 16 * jj);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          acc[i][2 * jj] = fmaf(pv[i], vv.x, acc[i][2 * jj]);
          acc[i][2 * jj + 1] = fmaf(pv[i], vv.y, acc[i][2 * jj + 1]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int64_t qp = q0 + ty * RPT + i;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* row = out + (bh * Sq + qp) * hd;
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) {
      const int d = 2 * tx + 16 * jj;
      if (d < hd) {
        *reinterpret_cast<float2*>(row + d) =
            make_float2(acc[i][2 * jj] / denom, acc[i][2 * jj + 1] / denom);
      }
    }
  }
}

constexpr int kMaxDevices = 64;

template <int HDP, int RPT, int BKV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int64_t BH, int64_t Sq, int64_t Sk, int hd, int64_t group,
                   int causal, int64_t window, float softcap, float scale,
                   int device, cudaStream_t stream) {
  constexpr int BQ = 16 * RPT;
  constexpr size_t kSmem = smem_bytes<HDP, RPT, BKV>();
  auto kernel = fa_forward<HDP, RPT, BKV>;
  // above 48 KB of dynamic shared memory a kernel must opt in, once per
  // device (before any stream capture: it is not a stream operation)
  static bool opted_in[kMaxDevices] = {};
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmem));
    if (err != cudaSuccess) return err;
    opted_in[device] = true;
  }
  const int64_t nqt = (Sq + BQ - 1) / BQ;
  const int64_t blocks = BH * nqt;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, hd,
      group, nqt, causal, window, softcap, scale);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int64_t BH, int64_t Sq, int64_t Sk, int hd,
                     int64_t group, int causal, int64_t window, float softcap,
                     float scale, int device, cudaStream_t s) {
  // rows a thread (RPT, so 16 * RPT query rows a block) and keys a tile
  if (hd <= 32) {
    return launch<32, 4, 64>(q, k, v, out, BH, Sq, Sk, hd, group, causal,
                             window, softcap, scale, device, s);
  }
  if (hd <= 64) {
    return launch<64, 4, 64>(q, k, v, out, BH, Sq, Sk, hd, group, causal,
                             window, softcap, scale, device, s);
  }
  if (hd <= 128) {
    return launch<128, 4, 64>(q, k, v, out, BH, Sq, Sk, hd, group, causal,
                              window, softcap, scale, device, s);
  }
  return launch<256, 2, 32>(q, k, v, out, BH, Sq, Sk, hd, group, causal,
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
    return dispatch(q, k, v, out, BH, Sq, Sk, int(hd), BH / BKV,
                           int(causal), window, float(softcap), float(scale),
                           int(device), s);
  }
  return synapse::flash_attention_bf16_sm90(
      q, k, v, out, BH, BKV, Sq, Sk, int(hd), int(causal), window,
      float(softcap), float(scale), int(device), s);
}
