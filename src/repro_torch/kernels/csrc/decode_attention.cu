// One-token GQA decode attention over a contiguous or a paged KV cache.
//
// Replaces two Pallas TPU kernels of the reference package:
//   src/repro/kernels/decode_attention.py:decode_attention (_decode_kernel)
//   src/repro/kernels/paged_attention.py:paged_decode_attention
// Same semantics: q (B, H, hd) attends over the first `lengths[b]` cache
// positions (optionally only the last `window` of them), softmax in f32,
// and the output is 0 where nothing is attended (length 0) — the Pallas
// convention (`l == 0 -> 1` in _decode_kernel), not the plain version's
// uniform average.
//
// What bounds it on an H100: bytes. Every attended position costs one K
// row and one V row (2 * KV * hd * dtype bytes over all heads) against
// 4 * G * hd FLOPs, far below the card's ~295 FLOP/byte ridge, so the
// least time is the cache bytes over 3.35 TB/s.
//
// Design: one block per (kv head, batch row), 8 warps. The G = H / KV
// query heads that share a kv head stay in registers (each lane holds
// hd / 32 dims of each), so every K/V row is read from device memory once
// for the whole group — the TPU kernel's "group as the MXU M dimension",
// done here on CUDA cores. Warp w walks positions base + w*U .. +U-1 with
// U rows of K and V loaded together as vector loads (coalesced 32-lane
// row reads), dot products reduce by warp shuffles, and each warp keeps
// its own online-softmax state; the 8 partial states merge through shared
// memory at the end. The position loop starts at the window's first
// position and stops at `length`, which is the TPU kernel's dead-tile skip.
//
// Paged layout: position p of row b lives in pool row
//   min(block_tables[b, min(p / page, max_pages - 1)], P - 1) * page + p % page
// so the walk does not depend on the page size — page 1 and pages as deep
// as the whole context run the same code (the engine's degenerate oracles).
// The contiguous and paged instantiations share the body and the order of
// every sum, so they agree bitwise on the same data.
//
// Split-KV (more blocks than B * KV for short batches) is later work.

#include "attn_common.cuh"

using namespace repro_attn;

namespace {

constexpr int NWARPS = 8;
constexpr int U = 4;  // positions per warp per step

template <typename T, int EPT, int G, bool PAGED>
__global__ void __launch_bounds__(NWARPS * 32)
decode_kernel(const T* __restrict__ q,            // (B, H, hd)
              const T* __restrict__ k,            // (B, S, KV, hd) | (P, page, KV, hd)
              const T* __restrict__ v,
              const int* __restrict__ lengths,    // (B,)
              const int* __restrict__ block_tables,  // (B, max_pages), paged only
              T* __restrict__ out,                // (B, H, hd)
              int S,                              // cache depth | page size
              int KV, int max_pages, int P, int window, float sm_scale) {
  constexpr int HD = EPT * 32;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int H = KV * G;

  const int len = lengths[b];
  // positions the cache can hold: S for a contiguous row, the table's span
  // for a paged one (the plain versions mask over exactly that range)
  const int cap = PAGED ? max_pages * S : S;
  const int end = min(len, cap);
  const int start = window >= 0 ? max(0, len - window) : 0;

  float qr[G][EPT];
#pragma unroll
  for (int g = 0; g < G; ++g)
    load_f32<T, EPT>(q + ((size_t)b * H + kvh * G + g) * HD + lane * EPT, qr[g]);

  float m[G], l[G], acc[G][EPT];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPT; ++e) acc[g][e] = 0.f;
  }

  for (int base = start + warp * U; base < end; base += NWARPS * U) {
    float kr[U][EPT], vr[U][EPT];
    bool valid[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pos = base + u;
      valid[u] = pos < end;
      if (valid[u]) {
        size_t row;
        if (PAGED) {
          const int pg = min(pos / S, max_pages - 1);
          const int pid = min(block_tables[(size_t)b * max_pages + pg], P - 1);
          row = (size_t)pid * S + pos % S;
        } else {
          row = (size_t)b * S + pos;
        }
        const size_t off = (row * KV + kvh) * HD + lane * EPT;
        load_f32<T, EPT>(k + off, kr[u]);
        load_f32<T, EPT>(v + off, vr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < EPT; ++e) kr[u][e] = vr[u][e] = 0.f;
      }
    }
    float s[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPT; ++e) d += qr[g][e] * kr[u][e];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        s[u][g] = d * sm_scale;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (valid[u]) mx = fmaxf(mx, s[u][g]);
      const float alpha = expf(m[g] - mx);
      m[g] = mx;
      float psum = 0.f;
      float p[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = valid[u] ? expf(s[u][g] - mx) : 0.f;
        psum += p[u];
      }
      l[g] = l[g] * alpha + psum;
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        float a = acc[g][e] * alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) a += p[u] * vr[u][e];
        acc[g][e] = a;
      }
    }
  }

  // merge the warps' partial softmax states
  __shared__ float sm_m[NWARPS][G];
  __shared__ float sm_l[NWARPS][G];
  __shared__ float sm_acc[NWARPS][G][HD];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPT; ++e) sm_acc[warp][g][lane * EPT + e] = acc[g][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * HD; idx += NWARPS * 32) {
    const int g = idx / HD;
    const int d = idx % HD;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float c = expf(sm_m[w][g] - M);
      L += sm_l[w][g] * c;
      A += sm_acc[w][g][d] * c;
    }
    out[((size_t)b * H + kvh * G + g) * HD + d] = from_f32<T>(L == 0.f ? 0.f : A / L);
  }
}

template <typename T, int EPT, int G, bool PAGED>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           const void* block_tables, void* out, int B, int S, int KV,
           int max_pages, int P, int window, float sm_scale, cudaStream_t stream) {
  dim3 grid(KV, B);
  decode_kernel<T, EPT, G, PAGED><<<grid, NWARPS * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), static_cast<const int*>(block_tables),
      static_cast<T*>(out), S, KV, max_pages, P, window, sm_scale);
  return (int)cudaGetLastError();
}

// (G, hd) pairs the wrappers accept: G in {1,2,4,8,16}, hd in {32,64,128,256},
// G * hd <= 1024 (registers per lane and the merge buffer stay bounded)
template <typename T, int EPT, bool PAGED>
int dispatch_g(int G, const void* q, const void* k, const void* v, const void* lengths,
               const void* bt, void* out, int B, int S, int KV, int max_pages, int P,
               int window, float sm_scale, cudaStream_t st) {
#define REPRO_G_CASE(GG)                                                              \
  case GG:                                                                            \
    if constexpr (GG * EPT <= 32)                                                     \
      return launch<T, EPT, GG, PAGED>(q, k, v, lengths, bt, out, B, S, KV, max_pages, \
                                       P, window, sm_scale, st);                      \
    else                                                                              \
      return (int)cudaErrorInvalidValue;
  switch (G) {
    REPRO_G_CASE(1)
    REPRO_G_CASE(2)
    REPRO_G_CASE(4)
    REPRO_G_CASE(8)
    REPRO_G_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_G_CASE
}

template <typename T, bool PAGED>
int dispatch(int hd, int G, const void* q, const void* k, const void* v,
             const void* lengths, const void* bt, void* out, int B, int S, int KV,
             int max_pages, int P, int window, float sm_scale, cudaStream_t st) {
  switch (hd) {
    case 32:
      return dispatch_g<T, 1, PAGED>(G, q, k, v, lengths, bt, out, B, S, KV, max_pages, P,
                                     window, sm_scale, st);
    case 64:
      return dispatch_g<T, 2, PAGED>(G, q, k, v, lengths, bt, out, B, S, KV, max_pages, P,
                                     window, sm_scale, st);
    case 128:
      return dispatch_g<T, 4, PAGED>(G, q, k, v, lengths, bt, out, B, S, KV, max_pages, P,
                                     window, sm_scale, st);
    case 256:
      return dispatch_g<T, 8, PAGED>(G, q, k, v, lengths, bt, out, B, S, KV, max_pages, P,
                                     window, sm_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <bool PAGED>
int entry(int dtype, const void* q, const void* k, const void* v, const void* lengths,
          const void* bt, void* out, int B, int S, int H, int KV, int hd, int max_pages,
          int P, int window, float sm_scale, void* stream) {
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return dispatch<float, PAGED>(hd, G, q, k, v, lengths, bt, out, B, S, KV, max_pages, P,
                                  window, sm_scale, st);
  if (dtype == DTYPE_BF16)
    return dispatch<__nv_bfloat16, PAGED>(hd, G, q, k, v, lengths, bt, out, B, S, KV,
                                          max_pages, P, window, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q (B, H, hd); k, v (B, S, KV, hd); lengths (B,) int32; out (B, H, hd).
// window < 0 means no window. Returns cudaGetLastError() after the launch.
int decode_attention(int dtype, const void* q, const void* k, const void* v,
                     const void* lengths, void* out, int B, int S, int H, int KV, int hd,
                     int window, float sm_scale, void* stream) {
  return entry<false>(dtype, q, k, v, lengths, nullptr, out, B, S, H, KV, hd, 1, 1, window,
                      sm_scale, stream);
}

// q (B, H, hd); k_pool, v_pool (P, page, KV, hd); block_tables (B, max_pages)
// int32 (ids >= P are sentinels); lengths (B,) int32; out (B, H, hd).
int paged_decode_attention(int dtype, const void* q, const void* k_pool, const void* v_pool,
                           const void* block_tables, const void* lengths, void* out, int B,
                           int P, int page, int max_pages, int H, int KV, int hd,
                           int window, float sm_scale, void* stream) {
  return entry<true>(dtype, q, k_pool, v_pool, lengths, block_tables, out, B, page, H, KV,
                     hd, max_pages, P, window, sm_scale, stream);
}

}  // extern "C"
