// Prefill attention: causal (or bidirectional) GQA with per-row lengths,
// an optional query offset and an optional sliding window.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py:flash_attention (_flash_kernel)
// and extends it with what the serving path needs and the TPU kernel
// lacks: per-row `lengths` (right-padded prompt buckets; keys at or past
// lengths[b] are masked) and `q_offset` (query i of row b sits at absolute
// position q_offset[b] + i). Rows with nothing to attend (length 0, the
// row-bucket padding rows of a grouped prefill) write zeros, the Pallas
// convention (`l == 0 -> 1` in _flash_kernel).
//
// What bounds it on an H100: operations. A 512-token causal prefill does
// ~2 * 512 / 2 FLOPs per byte of K/V read per head, well past the ridge,
// so the least time is the causal FLOPs over the bf16 tensor-core peak.
// This first kernel runs the products on CUDA cores (f32 FMA), so it sits
// far from that bound: tensor cores (mma.sync / wgmma) are later work.
//
// Design: one block per (64-query tile, query head, batch row), 256
// threads. Q, K and V tiles are staged in shared memory as f32 with rows
// padded by one word (no bank conflicts on the column walks); each thread
// owns a 4 x 4 block of the 64 x 64 score tile and a 4 x (hd / 16) block
// of the output. Online softmax in f32 with row max / sum reduced across
// the 16 threads that share rows (shuffles inside a half warp). The key
// loop runs only over tiles that can hold an unmasked key: from the
// window's left edge to min(length, last causal position), which is the
// TPU kernel's skip of fully masked tiles. GQA maps query head h to kv
// head h / (H / KV) in the address computation, as the TPU kernel's index
// map does.

#include "attn_common.cuh"

using namespace repro_attn;

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;

template <int HD>
constexpr int smem_floats() {
  return BQ * (HD + 1) + 2 * BK * (HD + 1) + BQ * (BK + 1);
}

template <typename T, int HD, bool CAUSAL>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ q,         // (B, Sq, H, hd)
             const T* __restrict__ k,         // (B, Sk, KV, hd)
             const T* __restrict__ v,
             const int* __restrict__ lengths,   // (B,) or null
             const int* __restrict__ q_offset,  // (B,) or null
             T* __restrict__ out,             // (B, Sq, H, hd)
             int Sq, int Sk, int H, int KV, int window, float sm_scale) {
  constexpr int LD = HD + 1;
  constexpr int LDP = BK + 1;
  constexpr int DPT = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int tr = tid >> 4;  // rows tr*4 .. tr*4+3
  const int tc = tid & 15;  // cols tc + 16*j
  const int qoff = q_offset ? q_offset[b] : 0;
  const int len = lengths ? min(lengths[b], Sk) : Sk;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD, qi = q0 + r;
    Qs[r * LD + d] = qi < Sq ? to_f32(q[(((size_t)b * Sq + qi) * H + h) * HD + d]) : 0.f;
  }

  int kend = len;
  if (CAUSAL) kend = min(kend, qoff + min(q0 + BQ, Sq));
  int kstart = 0;
  if (window >= 0) kstart = max(0, qoff + q0 - window + 1);
  kstart = (kstart / BK) * BK;

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = kstart; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * HD; i += NT) {
      const int r = i / HD, d = i % HD, kp = k0 + r;
      const bool ok = kp < Sk;
      const size_t off = (((size_t)b * Sk + kp) * KV + kvh) * HD + d;
      Ks[r * LD + d] = ok ? to_f32(k[off]) : 0.f;
      Vs[r * LD + d] = ok ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(tr * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tc + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = qoff + q0 + tr * 4 + i;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tc + 16 * j;
        ok[j] = kp < len && (!CAUSAL || kp <= qpos) && (window < 0 || kp > qpos - window);
        s[i][j] *= sm_scale;
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        Ps[(tr * 4 + i) * LDP + tc + 16 * j] = p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < BK; ++n) {
      float pv[4], vv[DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(tr * 4 + i) * LDP + n];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = Vs[n * LD + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] += pv[i] * vv[j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr * 4 + i;
    if (qi >= Sq) continue;
    const float inv = l[i] == 0.f ? 0.f : 1.f / l[i];
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      out[(((size_t)b * Sq + qi) * H + h) * HD + tc + 16 * j] = from_f32<T>(acc[i][j] * inv);
  }
}

template <typename T, int HD, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           const void* q_offset, void* out, int B, int Sq, int Sk, int H, int KV,
           int window, float sm_scale, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * int(sizeof(float));
  auto kern = flash_kernel<T, HD, CAUSAL>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), static_cast<const int*>(q_offset),
      static_cast<T*>(out), Sq, Sk, H, KV, window, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T, bool CAUSAL>
int dispatch(int hd, const void* q, const void* k, const void* v, const void* lengths,
             const void* q_offset, void* out, int B, int Sq, int Sk, int H, int KV,
             int window, float sm_scale, cudaStream_t st) {
  switch (hd) {
    case 32:
      return launch<T, 32, CAUSAL>(q, k, v, lengths, q_offset, out, B, Sq, Sk, H, KV,
                                   window, sm_scale, st);
    case 64:
      return launch<T, 64, CAUSAL>(q, k, v, lengths, q_offset, out, B, Sq, Sk, H, KV,
                                   window, sm_scale, st);
    case 128:
      return launch<T, 128, CAUSAL>(q, k, v, lengths, q_offset, out, B, Sq, Sk, H, KV,
                                    window, sm_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Sq, H, hd); k, v (B, Sk, KV, hd); lengths, q_offset (B,) int32 or
// null; out (B, Sq, H, hd). window < 0 means no window. Returns
// cudaGetLastError() after the launch (or the attribute call's error).
int flash_attention(int dtype, const void* q, const void* k, const void* v,
                    const void* lengths, const void* q_offset, void* out, int B, int Sq,
                    int Sk, int H, int KV, int hd, int causal, int window, float sm_scale,
                    void* stream) {
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return causal ? dispatch<float, true>(hd, q, k, v, lengths, q_offset, out, B, Sq, Sk, H,
                                          KV, window, sm_scale, st)
                  : dispatch<float, false>(hd, q, k, v, lengths, q_offset, out, B, Sq, Sk,
                                           H, KV, window, sm_scale, st);
  if (dtype == DTYPE_BF16)
    return causal ? dispatch<__nv_bfloat16, true>(hd, q, k, v, lengths, q_offset, out, B, Sq,
                                                  Sk, H, KV, window, sm_scale, st)
                  : dispatch<__nv_bfloat16, false>(hd, q, k, v, lengths, q_offset, out, B,
                                                   Sq, Sk, H, KV, window, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
