// Shared pieces of the selective-scan forward (selective_scan.cu) and its
// backward (selective_scan_bwd.cu): the block's channel width, the step of
// the recurrence, and the shared-memory word helpers both use to read the
// (B, C) pairs of a step.
//
// The step is here, and only here, so that the backward's recomputed states
// equal the forward's bitwise: the same ex2.approx of the same product, the
// same FMA over the same operands.
#pragma once

#include "attn_common.cuh"

namespace repro_scan {

constexpr int CH = 32;  // channels per block, one per lane
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// exp(dt * A) for a2 = A * log2(e) (folded in once, when A is loaded): one
// FMUL and one MUFU.EX2
__device__ __forceinline__ float scan_decay(float dt, float a2) { return ex2_approx(dt * a2); }

// h_t = decay * h_{t-1} + u * B_t, with u = dt_t * x_t computed once a step
__device__ __forceinline__ float scan_update(float decay, float h, float u, float b) {
  return fmaf(decay, h, u * b);
}

// W consecutive 32-bit words from shared memory, in 16-, 8- or 4-byte loads
template <int W>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int j = 0; j < W / 4; ++j) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[j];
      w[4 * j] = v.x;
      w[4 * j + 1] = v.y;
      w[4 * j + 2] = v.z;
      w[4 * j + 3] = v.w;
    }
  } else if constexpr (W == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// element k of words holding elements of Tp, widened to f32
template <typename Tp>
__device__ __forceinline__ float word_elem(const uint32_t* w, int k) {
  if constexpr (sizeof(Tp) == 2)
    return __uint_as_float(k % 2 ? w[k / 2] & 0xffff0000u : w[k / 2] << 16);
  else
    return __uint_as_float(w[k]);
}

}  // namespace repro_scan
