// Shared helpers for the attention kernels: dtype conversion, vector loads,
// the masking constant, and the dtype codes of the plain C interface.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace repro_attn {

// same constant as kernels/ref.py and the Pallas kernels
constexpr float NEG_INF = -1e30f;

// dtype codes shared with kernels/cuda.py
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Load N consecutive elements starting at p and widen them to f32. When the
// span is 4, 8 or 16 bytes it is one vector load (the wrappers check that
// every base pointer is 16-byte aligned and row strides keep that).
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, float (&o)[N]) {
  constexpr int BYTES = int(sizeof(T)) * N;
  if constexpr (BYTES == 16 || BYTES == 8 || BYTES == 4) {
    using V = typename std::conditional<
        BYTES == 16, uint4,
        typename std::conditional<BYTES == 8, uint2, uint32_t>::type>::type;
    V raw = *reinterpret_cast<const V*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = to_f32(p[i]);
  }
}

}  // namespace repro_attn
