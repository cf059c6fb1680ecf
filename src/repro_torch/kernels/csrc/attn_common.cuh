// Shared helpers for the attention kernels: dtype conversion, vector loads,
// the masking constant and the mask itself (one copy for the forward and
// backward kernels), the dtype codes of the plain C interface, and the
// PTX wrappers for cp.async, ldmatrix and the bf16 tensor-core mma.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
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

// ---- asynchronous copies (sm_80+) ---------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes global -> shared without staging in registers. With
// src_bytes 0 nothing is read and the 16 shared bytes are zero-filled (the
// ragged edge of a tile); `src` must still be a valid address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- tensor-core fragments (mma.sync m16n8k16, bf16 in, f32 accumulate) --

// Four 8x8 b16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8 and receives, of matrix j, in r[j], row i / 4,
// columns 2 (i % 4) and 2 (i % 4) + 1 (transposed with TRANS).
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// d (16x8 f32) += a (16x16 bf16, row-major) * b (16x8 bf16, column-major)
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- the mask, shared by the forward and backward kernels ----------------
//
// Macros, not functions: written as __forceinline__ functions the same
// two expressions cost the 8-warp tensor-core forward 11-13% at 512-row
// causal prefills (parent and change in one call, NVIDIA H100 80GB HBM3,
// 700 W), which the expressions written out in place do not.

// Whether the key at position kp is visible from the query at absolute
// position qp: before the row's length, not after the query when causal,
// inside the sliding window when there is one (window < 0: none).
#define REPRO_ATTN_VISIBLE(CAUSAL, kp, qp, len, window) \
  ((kp) < (len) && (!(CAUSAL) || (kp) <= (qp)) && ((window) < 0 || (kp) > (qp) - (window)))

// The keys [kstart, kend) that queries at absolute positions [qlo, qhi)
// can see, kstart rounded down to a multiple of the key tile bk: the
// forward's and dQ's skip of fully masked key tiles.
#define REPRO_ATTN_KEY_RANGE(CAUSAL, qlo, qhi, len, window, bk, kstart, kend) \
  do {                                                                         \
    kend = (len);                                                              \
    if (CAUSAL) kend = min(kend, (qhi));                                       \
    kstart = 0;                                                                \
    if ((window) >= 0) kstart = max(0, (qlo) - (window) + 1);                  \
    kstart = (kstart / (bk)) * (bk);                                           \
  } while (0)

// Its converse for dK/dV: the queries [qstart, qend) (positions = indices,
// no offset) that can see a key in [k0, k1), qstart rounded down to a
// multiple of the query tile bq.
template <bool CAUSAL>
__device__ __forceinline__ void attn_query_range(int k0, int k1, int sq, int window, int bq,
                                                 int& qstart, int& qend) {
  qstart = CAUSAL ? min(k0, sq) : 0;
  qstart = (qstart / bq) * bq;
  qend = sq;
  if (window >= 0) qend = min(qend, k1 - 1 + window);
}

// two f32 -> one register of two bf16 (x in the low half), round to nearest
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&h);
}

}  // namespace repro_attn
