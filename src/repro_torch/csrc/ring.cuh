// The memory atom's ring pass, shared by csrc/memory_atom.cu (the ring
// entry: all of a call's passes in one launch) and csrc/segment.cu (the
// memory leg of a segment's rows).
//
// A ring is `slots` blocks of `nvec` float4 each, back to back.  Pass p
// reads slot p % slots and writes it back scaled by 1.0000001, in place,
// so a pass reads a block that no pass has touched for slots - 1 passes:
// with a ring several times the L2's size, every pass reads device memory
// and not L2 (a chain of passes over one block, as the chained entry
// runs, stays in a 50 MB L2 at the atom's 16 MiB block).
//
// Each CTA owns the same fixed slice of every slot, so its pass p + 1
// never waits on another CTA's pass p: a launch needs no grid barrier for
// the passes to be right.  Device memory wants several MB in flight at
// 3.35 TB/s; one 16-byte load a thread over a CTA of 256 threads an SM is
// about 0.5 MB, so each thread keeps kRingUnroll independent 16-byte loads
// in flight (predicated at the slice's end, so the tail keeps them too).
//
// Two launches that stream one ring at once (two threads of a fleet on two
// streams) may both read a slot before either writes it back, and one of
// the two scalings of that slot is then lost: the ring's values depend on
// the interleaving, the bytes moved never do.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace synapse {

constexpr float kRingScale = 1.0000001f;
constexpr int kRingUnroll = 8;
// a CTA's slice is a multiple of this many float4 (512 bytes)
constexpr int64_t kRingAlign = 32;

// Passes p0 .. p0 + passes - 1 over this CTA's slice of every slot;
// `cta` of `ctas` CTAs, blockDim.x threads each.
__device__ __forceinline__ void ring_passes(float4* __restrict__ ring,
                                            int64_t nvec, int64_t slots,
                                            int64_t p0, int64_t passes,
                                            int64_t cta, int64_t ctas) {
  int64_t chunk = (nvec + ctas - 1) / ctas;
  chunk = (chunk + kRingAlign - 1) / kRingAlign * kRingAlign;
  const int64_t lo = cta * chunk < nvec ? cta * chunk : nvec;
  const int64_t hi = lo + chunk < nvec ? lo + chunk : nvec;
  const int64_t step = int64_t(blockDim.x);
  for (int64_t p = p0; p < p0 + passes; ++p) {
    float4* slot = ring + (p % slots) * nvec;
    for (int64_t base = lo + threadIdx.x; base < hi;
         base += kRingUnroll * step) {
      float4 v[kRingUnroll];
#pragma unroll
      for (int u = 0; u < kRingUnroll; ++u) {
        const int64_t i = base + u * step;
        if (i < hi) v[u] = slot[i];
      }
#pragma unroll
      for (int u = 0; u < kRingUnroll; ++u) {
        const int64_t i = base + u * step;
        if (i < hi) {
          v[u].x *= kRingScale;
          v[u].y *= kRingScale;
          v[u].z *= kRingScale;
          v[u].w *= kRingScale;
          slot[i] = v[u];
        }
      }
    }
  }
}

}  // namespace synapse
