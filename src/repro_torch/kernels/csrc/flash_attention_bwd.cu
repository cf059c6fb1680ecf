// Backward of prefill/train attention: dQ, dK, dV of causal (or
// bidirectional) GQA attention with per-row lengths and an optional sliding
// window, from the forward's output O and per-row log-sum-exp (lse, written
// by flash_attention.cu when asked for).
//
// The TPU side has no kernel to replace here: the reference trains through
// XLA's autodiff of src/repro/kernels/ref.py:attention_ref, and none of its
// Pallas kernels has a custom_vjp. On the card the plain version
// (kernels/ref.py:attention_bwd_ref) stays off the training path; these two
// kernels take its place, with the forward's mask (attn_common.cuh:
// REPRO_ATTN_VISIBLE, REPRO_ATTN_KEY_RANGE, attn_query_range), so the two
// cannot drift apart.
//
// With P = exp(scale Q K^T - lse) (zero where masked, and on a row with
// lse = -inf, which attends nothing), dP = dO V^T, Delta_i = sum_d dO_i O_i
// and dS = P o (dP - Delta):
//   dV = P^T dO,  dK = scale dS^T Q,  dQ = scale dS K.
// Two kernels and no atomics, so every result is deterministic:
//
// flash_attention_bwd_dkdv — one block per (key tile, kv head, batch row).
// It holds its K and V tile in shared memory and loops over the G = H / KV
// query heads of its group and, for each, over the query tiles that can see
// the key tile (attn_query_range: from the tile's first key on when causal,
// up to the window's reach). GQA's sum over the group happens in the
// block's registers. A key tile at or past the row's length writes zeros.
//
// flash_attention_bwd_dq — one block per (query tile, query head, batch
// row), over the key tiles the forward visited (REPRO_ATTN_KEY_RANGE).
//
// Both recompute Delta for their query rows from the O and dO tiles (one
// warp a row), so no torch op runs between the launches.
//
// What bounds it on an H100: operations. Five products of 2 hd FLOPs per
// attended (query, key, head) pair: S and dP in both kernels, dV and dK in
// one, dQ in the other. This is the plain CUDA-core body: tiles staged as
// f32 in shared memory (rows padded by one word), each of 256 threads owns
// a (rows / 16) x (cols / 16) block of every product, strided by 16 along
// the columns so a warp's shared loads are conflict-free. f32 and bf16
// inputs (widened on load), f32 accumulation, gradients written in the
// inputs' dtype. Key tiles are 64 rows, 32 at hd 128, to keep the f32
// tiles within 120 KB of shared memory and the accumulators in registers.
// Tensor cores (mma.sync / wgmma) are later work.

#include "attn_common.cuh"

using namespace repro_attn;

namespace {

constexpr int NT = 256;  // 16 x 16 threads
constexpr int BQ = 64;

template <int HD>
__host__ __device__ constexpr int key_tile() {
  return HD >= 128 ? 32 : 64;
}

template <int HD>
constexpr int dkdv_smem_floats() {
  constexpr int BK = key_tile<HD>();
  return 2 * BK * (HD + 1) + 2 * BQ * (HD + 1) + 2 * BQ * (BK + 1) + 2 * BQ;
}

template <int HD>
constexpr int dq_smem_floats() {
  constexpr int BK = key_tile<HD>();
  return 2 * BQ * (HD + 1) + 2 * BK * (HD + 1) + BQ * (BK + 1) + 2 * BQ;
}

// acc[i][j] += sum_t A(tr TM + i, t) B(tc + 16 j, t) over t < KD, with
// A(r, t) = a[r * AR + t * AT] and B(c, t) = b[c * BC + t * BT] in shared
// memory.
template <int TM, int TN, int KD, int AR, int AT, int BC, int BT>
__device__ __forceinline__ void mm_acc(float (&acc)[TM][TN], const float* __restrict__ a,
                                       const float* __restrict__ b, int tr, int tc) {
#pragma unroll 4
  for (int t = 0; t < KD; ++t) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = a[(tr * TM + i) * AR + t * AT];
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = b[(tc + 16 * j) * BC + t * BT];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] += av[i] * bv[j];
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// rows [r0, r0 + R) of a (B, S, N, hd) tensor at head n -> f32 rows of
// stride HD + 1; rows at or past S are zeros
template <typename T, int HD, int R>
__device__ __forceinline__ void load_rows(float* __restrict__ dst, const T* __restrict__ src,
                                          int b, int r0, int S, int N, int n) {
  for (int i = threadIdx.x; i < R * HD; i += NT) {
    const int r = i / HD, d = i % HD, s = r0 + r;
    dst[r * (HD + 1) + d] = s < S ? to_f32(src[(((size_t)b * S + s) * N + n) * HD + d]) : 0.f;
  }
}

// lse and Delta = sum_d dO O of the query rows [q0, q0 + BQ) of head h, one
// warp a row; rows at or past Sq get lse = -inf (so P = 0) and Delta = 0
template <typename T, int HD>
__device__ __forceinline__ void row_stats(float* __restrict__ Ls, float* __restrict__ Ds,
                                          const T* __restrict__ o, const T* __restrict__ dout,
                                          const float* __restrict__ lse, int b, int h, int q0,
                                          int Sq, int H) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BQ; r += NT / 32) {
    const int qi = q0 + r;
    float d = 0.f;
    if (qi < Sq) {
      const size_t off = (((size_t)b * Sq + qi) * H + h) * HD;
      for (int c = lane; c < HD; c += 32) d += to_f32(o[off + c]) * to_f32(dout[off + c]);
    }
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) d += __shfl_xor_sync(0xffffffffu, d, w);
    if (lane == 0) {
      Ds[r] = d;
      Ls[r] = qi < Sq ? lse[((size_t)b * H + h) * Sq + qi] : -INFINITY;
    }
  }
}

// P and dS of the (BQ x BK) tile at queries q0.., keys k0.. from the score
// and dP accumulators: P = exp(scale s - lse) where visible, else 0
template <bool CAUSAL, int TN>
__device__ __forceinline__ void probs(float (&s)[4][TN], float (&dp)[4][TN],
                                      const float* __restrict__ Ls,
                                      const float* __restrict__ Ds, int q0, int k0, int len,
                                      int window, float sm_scale, int tr, int tc) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    const float l = Ls[r];
    const float dl = Ds[r];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const bool ok =
          l != -INFINITY && REPRO_ATTN_VISIBLE(CAUSAL, k0 + tc + 16 * j, q0 + r, len, window);
      const float p = ok ? expf(s[i][j] * sm_scale - l) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - dl);
    }
  }
}

template <typename T, int HD, bool CAUSAL>
__global__ void __launch_bounds__(NT)
bwd_dkdv_kernel(const T* __restrict__ q,           // (B, Sq, H, hd)
                const T* __restrict__ k,           // (B, Sk, KV, hd)
                const T* __restrict__ v,
                const T* __restrict__ o,           // (B, Sq, H, hd)
                const float* __restrict__ lse,     // (B, H, Sq)
                const T* __restrict__ dout,        // (B, Sq, H, hd)
                const int* __restrict__ lengths,   // (B,) or null
                T* __restrict__ dk,                // (B, Sk, KV, hd)
                T* __restrict__ dv,
                int Sq, int Sk, int H, int KV, int window, float sm_scale) {
  constexpr int BK = key_tile<HD>();
  constexpr int LD = HD + 1;
  constexpr int LDP = BK + 1;
  constexpr int TK = BK / 16;  // key rows per thread
  constexpr int TD = HD / 16;  // head-dim columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + BQ * LDP;
  float* Ls = dSs + BQ * LDP;
  float* Ds = Ls + BQ;

  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int tr = threadIdx.x >> 4;
  const int tc = threadIdx.x & 15;
  const int len = lengths ? min(lengths[b], Sk) : Sk;

  float dk_acc[TK][TD], dv_acc[TK][TD];
  zero(dk_acc);
  zero(dv_acc);
  if (k0 < len) {  // else every key of the tile is masked: zero gradients
    load_rows<T, HD, BK>(Ks, k, b, k0, Sk, KV, kvh);
    load_rows<T, HD, BK>(Vs, v, b, k0, Sk, KV, kvh);
    int qstart, qend;
    attn_query_range<CAUSAL>(k0, min(k0 + BK, len), Sq, window, BQ, qstart, qend);
    for (int g = 0; g < G; ++g) {
      const int h = kvh * G + g;
      for (int q0 = qstart; q0 < qend; q0 += BQ) {
        __syncthreads();  // the previous tile's readers are done
        load_rows<T, HD, BQ>(Qs, q, b, q0, Sq, H, h);
        load_rows<T, HD, BQ>(dOs, dout, b, q0, Sq, H, h);
        row_stats<T, HD>(Ls, Ds, o, dout, lse, b, h, q0, Sq, H);
        __syncthreads();
        float s[4][TK], dp[4][TK];
        zero(s);
        zero(dp);
        mm_acc<4, TK, HD, LD, 1, LD, 1>(s, Qs, Ks, tr, tc);     // Q K^T
        mm_acc<4, TK, HD, LD, 1, LD, 1>(dp, dOs, Vs, tr, tc);   // dO V^T
        probs<CAUSAL, TK>(s, dp, Ls, Ds, q0, k0, len, window, sm_scale, tr, tc);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < TK; ++j) {
            Ps[(tr * 4 + i) * LDP + tc + 16 * j] = s[i][j];
            dSs[(tr * 4 + i) * LDP + tc + 16 * j] = dp[i][j];
          }
        __syncthreads();
        mm_acc<TK, TD, BQ, 1, LDP, 1, LD>(dv_acc, Ps, dOs, tr, tc);   // P^T dO
        mm_acc<TK, TD, BQ, 1, LDP, 1, LD>(dk_acc, dSs, Qs, tr, tc);   // dS^T Q
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TK; ++i) {
    const int kp = k0 + tr * TK + i;
    if (kp >= Sk) continue;
    const size_t off = (((size_t)b * Sk + kp) * KV + kvh) * HD;
#pragma unroll
    for (int j = 0; j < TD; ++j) {
      dk[off + tc + 16 * j] = from_f32<T>(dk_acc[i][j] * sm_scale);
      dv[off + tc + 16 * j] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

template <typename T, int HD, bool CAUSAL>
__global__ void __launch_bounds__(NT)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ o, const float* __restrict__ lse,
              const T* __restrict__ dout, const int* __restrict__ lengths,
              T* __restrict__ dq,                  // (B, Sq, H, hd)
              int Sq, int Sk, int H, int KV, int window, float sm_scale) {
  constexpr int BK = key_tile<HD>();
  constexpr int LD = HD + 1;
  constexpr int LDP = BK + 1;
  constexpr int TK = BK / 16;
  constexpr int TD = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* dSs = Vs + BK * LD;
  float* Ls = dSs + BQ * LDP;
  float* Ds = Ls + BQ;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tr = threadIdx.x >> 4;
  const int tc = threadIdx.x & 15;
  const int len = lengths ? min(lengths[b], Sk) : Sk;

  load_rows<T, HD, BQ>(Qs, q, b, q0, Sq, H, h);
  load_rows<T, HD, BQ>(dOs, dout, b, q0, Sq, H, h);
  row_stats<T, HD>(Ls, Ds, o, dout, lse, b, h, q0, Sq, H);
  int kstart, kend;
  REPRO_ATTN_KEY_RANGE(CAUSAL, q0, min(q0 + BQ, Sq), len, window, BK, kstart, kend);

  float dq_acc[4][TD];
  zero(dq_acc);
  for (int k0 = kstart; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, HD, BK>(Ks, k, b, k0, Sk, KV, kvh);
    load_rows<T, HD, BK>(Vs, v, b, k0, Sk, KV, kvh);
    __syncthreads();
    float s[4][TK], dp[4][TK];
    zero(s);
    zero(dp);
    mm_acc<4, TK, HD, LD, 1, LD, 1>(s, Qs, Ks, tr, tc);
    mm_acc<4, TK, HD, LD, 1, LD, 1>(dp, dOs, Vs, tr, tc);
    probs<CAUSAL, TK>(s, dp, Ls, Ds, q0, k0, len, window, sm_scale, tr, tc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < TK; ++j) dSs[(tr * 4 + i) * LDP + tc + 16 * j] = dp[i][j];
    __syncthreads();
    mm_acc<4, TD, BK, LDP, 1, 1, LD>(dq_acc, dSs, Ks, tr, tc);   // dS K
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr * 4 + i;
    if (qi >= Sq) continue;
    const size_t off = (((size_t)b * Sq + qi) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < TD; ++j) dq[off + tc + 16 * j] = from_f32<T>(dq_acc[i][j] * sm_scale);
  }
}

// ---- launches ------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *o, *lse, *dout, *lengths;
  void *dq, *dk, *dv;
  int B, Sq, Sk, H, KV, window;
  float sm_scale;
  cudaStream_t stream;
};

template <typename T, int HD, bool CAUSAL>
int launch_dkdv(const Args& a) {
  constexpr int bytes = dkdv_smem_floats<HD>() * int(sizeof(float));
  auto kern = bwd_dkdv_kernel<T, HD, CAUSAL>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sk + key_tile<HD>() - 1) / key_tile<HD>(), a.KV, a.B);
  kern<<<grid, NT, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.o), static_cast<const float*>(a.lse),
      static_cast<const T*>(a.dout), static_cast<const int*>(a.lengths),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.Sq, a.Sk, a.H, a.KV, a.window,
      a.sm_scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD, bool CAUSAL>
int launch_dq(const Args& a) {
  constexpr int bytes = dq_smem_floats<HD>() * int(sizeof(float));
  auto kern = bwd_dq_kernel<T, HD, CAUSAL>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  kern<<<grid, NT, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.o), static_cast<const float*>(a.lse),
      static_cast<const T*>(a.dout), static_cast<const int*>(a.lengths),
      static_cast<T*>(a.dq), a.Sq, a.Sk, a.H, a.KV, a.window, a.sm_scale);
  return (int)cudaGetLastError();
}

template <bool DQ, typename T, int HD>
int launch_one(const Args& a, int causal) {
  if constexpr (DQ) return causal ? launch_dq<T, HD, true>(a) : launch_dq<T, HD, false>(a);
  else return causal ? launch_dkdv<T, HD, true>(a) : launch_dkdv<T, HD, false>(a);
}

template <bool DQ>
int dispatch(int dtype, int hd, int causal, const Args& a) {
#define REPRO_HD_CASE(HD)                                                   \
  case HD:                                                                 \
    if (dtype == DTYPE_F32) return launch_one<DQ, float, HD>(a, causal);   \
    if (dtype == DTYPE_BF16) return launch_one<DQ, __nv_bfloat16, HD>(a, causal); \
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    REPRO_HD_CASE(32)
    REPRO_HD_CASE(64)
    REPRO_HD_CASE(80)
    REPRO_HD_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_HD_CASE
}

}  // namespace

extern "C" {

// q, out, dout, dq (B, Sq, H, hd); k, v, dk, dv (B, Sk, KV, hd); lse
// (B, H, Sq) f32 from the forward; lengths (B,) int32 or null. window < 0
// means no window; positions are the indices (no query offset). dtype f32
// or bf16, hd in {32, 64, 80, 128}. Each returns cudaGetLastError() after
// its launch (or the attribute call's error); an empty grid launches
// nothing.
int flash_attention_bwd_dkdv(int dtype, const void* q, const void* k, const void* v,
                             const void* out, const void* lse, const void* dout,
                             const void* lengths, void* dk, void* dv, int B, int Sq, int Sk,
                             int H, int KV, int hd, int causal, int window, float sm_scale,
                             void* stream) {
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sk == 0) return (int)cudaSuccess;
  Args a{q,  k,  v,  out, lse, dout, lengths, nullptr, dk, dv, B, Sq, Sk, H, KV, window,
         sm_scale, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(dtype, hd, causal, a);
}

int flash_attention_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                           const void* out, const void* lse, const void* dout,
                           const void* lengths, void* dq, int B, int Sq, int Sk, int H, int KV,
                           int hd, int causal, int window, float sm_scale, void* stream) {
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || H == 0) return (int)cudaSuccess;
  Args a{q,  k,  v,  out, lse, dout, lengths, dq, nullptr, nullptr, B, Sq, Sk, H, KV, window,
         sm_scale, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(dtype, hd, causal, a);
}

}  // extern "C"
