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
// Two kernels and no atomics, so every result is deterministic (each
// output element is summed by one thread in a fixed order):
//
// flash_attention_bwd_dq runs first — one block per (64-query tile, query
// head, batch row), over the key tiles the forward visited
// (REPRO_ATTN_KEY_RANGE). It also computes Delta for its 64 rows, once
// (O is read nowhere else), and writes it to an f32 (B, H, Sq) buffer that
// the wrapper allocates.
//
// flash_attention_bwd_dkdv runs second — one block per (64-key tile, kv
// head, batch row). It keeps its K and V tile in shared memory and loops
// over the G = H / KV query heads of its group and, for each, over the
// query tiles that can see the key tile (attn_query_range), reading lse
// and Delta of each tile from the buffers. GQA's sum over the group
// happens in the block's registers. A key tile at or past the row's length
// writes zeros.
//
// Both kernels issue the heaviest causal tiles first, on the grid's
// slowest axis (dQ: the last query tile; dK/dV: the first key tile), and
// bring the streamed tiles (K and V in dQ, Q, dO, lse and Delta in dK/dV)
// through a 2-stage cp.async ring, so the next tile's copy overlaps this
// tile's math; rows past the sequence are zero-filled by the copy. Five
// products of 2 hd FLOPs per attended (query, key, head) are needed; the
// two kernels do seven (each recomputes S and dP). Two bodies, chosen by
// dtype (not a fallback):
//
// bf16 — tensor cores (mma.sync.m16n8k16, bf16 in, f32 accumulate), the
// forward's idiom (flash_attention.cu:flash_mma_kernel). Blocks of 4 warps,
// each warp owning 16 rows (queries in dQ, keys in dK/dV); tiles stay bf16
// in shared memory with rows padded by 16 bytes. dQ: S = Q K^T and
// dP = dO V^T, then dS is packed to bf16 straight from the accumulator
// registers into the A operand of dQ += dS K (K by ldmatrix.trans). dK/dV
// works on the transposed products S^T = K Q^T and dP^T = V dO^T, so a
// thread holds two query columns of each 8-wide n-tile and reads lse and
// Delta per column; P^T and dS^T go from the accumulators into the A
// operands of dV += P^T dO and dK += dS^T Q (dO and Q by ldmatrix.trans).
// P and dS never touch shared memory. At hd <= 64 the A fragments of the
// resident tile (Q and dO in dQ, K and V in dK/dV) stay in registers; at
// hd 80 and 128 the accumulators need those registers (dK and dV of
// 16 x 128 a warp are 128 a thread), so the fragments are reloaded by
// ldmatrix, one load per 4 of the B operand's. Query and key tiles are 64
// rows at every hd. Rounding P and dS to bf16 is the main error beside
// the forward's. What bounds it: the tensor cores' issue, the exps and the
// block-wide barriers once a tile; the card's floor is the bytes.
//
// f32 — CUDA cores in IEEE f32 (no TF32 in any form: it keeps ~3 decimal
// digits and breaks the f32 agreement the tests hold the card to). 256
// threads; tiles as f32 in shared memory, rows padded by 4 words. The
// products with hd as the inner index (S, dP) run as row dot products, the
// others (dQ, dV, dK) as outer products over a k-major tile (dS, P are
// stored transposed for them), and every operand is read as a 16-byte
// float4 (float2 or scalars for hd 32 and 80's 5 columns): a warp covers
// 16 x 32 outputs of a 4 x 4 per-thread tile, so it reads one shared
// wavefront per 8 FMAs (hd 80: per 3.3) where the first body read one per
// 2. What bounds it: FMA issue (67 TFLOP/s at most), behind which one
// block of 8 warps per SM hides little of the barriers and the shared
// loads' latency. Key tiles are 64 rows at every hd; at 4 bytes an
// element that takes 122 (hd 64) to 215 KB (hd 128) of shared memory in
// dQ, so one block per SM, and 137, 161 and 150 KB in dK/dV at hd 64, 80
// and 128: there query tiles are 64 rows, 32 at hd 128 (64 would need
// 237 KB, over the 227 KB a block may take).

#include "attn_common.cuh"

using namespace repro_attn;

namespace {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;

// 4-byte cp.async for the lse and Delta rows, which start at any float
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// rows [r0, r0 + R) of a (B, S, N, hd) tensor at head n -> shared rows of LDS
// elements, by 16-byte cp.async (not committed); rows at or past S are zeros
template <typename T, int HD, int R, int LDS, int NT>
__device__ __forceinline__ void copy_rows(T* __restrict__ dst, const T* __restrict__ src, int b,
                                          int r0, int S, int N, int n) {
  constexpr int EPV = 16 / int(sizeof(T));
  constexpr int VPR = HD / EPV;
  const T* base = src + ((size_t)b * S * N + n) * HD;
  const size_t stride = (size_t)N * HD;
  for (int i = threadIdx.x; i < R * VPR; i += NT) {
    const int r = i / VPR, c = i % VPR, s = r0 + r;
    cp_async16(dst + r * LDS + c * EPV, base + (size_t)min(s, S - 1) * stride + c * EPV,
               s < S ? 16 : 0);
  }
}

// lse and Delta of the query rows [q0, q0 + R) of head h -> shared (not
// committed); rows at or past Sq read as 0 and are masked by the caller
template <int R, int NT>
__device__ __forceinline__ void copy_stats(float* __restrict__ Ls, float* __restrict__ Ds,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta, int b, int h, int q0,
                                           int Sq, int H) {
  const size_t row = ((size_t)b * H + h) * Sq;
  for (int i = threadIdx.x; i < R; i += NT) {
    const int qi = q0 + i;
    const size_t off = row + min(qi, Sq - 1);
    cp_async4(Ls + i, lse + off, qi < Sq ? 4 : 0);
    cp_async4(Ds + i, delta + off, qi < Sq ? 4 : 0);
  }
}

// Delta = sum_d dO O of the query rows [q0, q0 + R) of head h, NT / R
// lanes a row: dO from the shared tile (rows of LDS elements), O from
// global memory. Written to Ds (shared) and to delta (global, rows < Sq);
// rows at or past Sq get 0.
template <typename T, int HD, int R, int LDS, int NT>
__device__ __forceinline__ void row_delta(float* __restrict__ Ds, float* __restrict__ delta,
                                          const T* __restrict__ dOs, const T* __restrict__ o,
                                          int b, int h, int q0, int Sq, int H) {
  constexpr int LPR = NT / R;
  constexpr int EPV = 16 / int(sizeof(T));
  constexpr int PER = HD / LPR;
  static_assert(LPR * R == NT && PER % EPV == 0, "lanes a row must split hd in vectors");
  const int r = threadIdx.x / LPR, part = threadIdx.x % LPR, qi = q0 + r;
  float d = 0.f;
  if (qi < Sq) {
    const T* orow = o + (((size_t)b * Sq + qi) * H + h) * HD + part * PER;
    const T* drow = dOs + r * LDS + part * PER;
#pragma unroll
    for (int c = 0; c < PER; c += EPV) {
      float ov[EPV], dv[EPV];
      load_f32<T, EPV>(orow + c, ov);
      load_f32<T, EPV>(drow + c, dv);
#pragma unroll
      for (int e = 0; e < EPV; ++e) d = fmaf(ov[e], dv[e], d);
    }
  }
#pragma unroll
  for (int w = LPR / 2; w > 0; w >>= 1) d += __shfl_xor_sync(0xffffffffu, d, w);
  if (part == 0) {
    Ds[r] = d;
    if (qi < Sq) delta[((size_t)b * H + h) * Sq + qi] = d;
  }
}

// a row's lse for exp(x - lse): -inf (the row attends nothing) -> +inf, so
// that every P of the row is 0
__device__ __forceinline__ float lse_or_inf(float l) { return l == -INFINITY ? INFINITY : l; }

// ---- f32: CUDA cores -------------------------------------------------------

constexpr int NT = 256;  // a 16 x 16 grid of thread tiles; a warp covers 4 x 8 of them
constexpr int BQ = 64;   // query tile of dQ
constexpr int BK = 64;   // key tile of both kernels
constexpr int LDP = 64 + 4;  // row stride of the transposed P and dS tiles

// query tile of dK/dV
template <int HD>
__host__ __device__ constexpr int f32_dkdv_query_tile() {
  return HD >= 128 ? 32 : 64;
}

template <int HD>
constexpr int f32_dq_smem_bytes() {
  return ((2 * BQ + 4 * BK) * (HD + 4) + BK * LDP + BQ) * 4;
}

template <int HD>
constexpr int f32_dkdv_smem_bytes() {
  constexpr int FQ = f32_dkdv_query_tile<HD>();
  return (2 * BK * (HD + 4) + 4 * FQ * (HD + 4) + 2 * FQ * LDP + 4 * FQ) * 4;
}

// columns of an (rows x hd) product a thread owns: CN runs of CW adjacent
// columns, run c at column (tc + 16 c) CW, so a warp's 8 column threads
// read 8 adjacent runs
template <int HD>
struct Cols {
  static constexpr int PER = HD / 16;
  static constexpr int CW = PER % 4 == 0 ? 4 : (PER % 2 == 0 ? 2 : 1);
  static constexpr int CN = PER / CW;
};

template <int W>
__device__ __forceinline__ void ld_vec(const float* __restrict__ p, float* o) {
  if constexpr (W == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x, o[1] = x.y, o[2] = x.z, o[3] = x.w;
  } else if constexpr (W == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x, o[1] = x.y;
  } else {
    o[0] = *p;
  }
}

// acc[i][j] += sum_d A(tr + 16 i, d) B(tc + 16 j, d) over d < HD, rows of LD
// floats, one float4 of each row a step
template <int TI, int TJ, int HD, int LD>
__device__ __forceinline__ void dot_rows(float (&acc)[TI][TJ], const float* __restrict__ a,
                                         const float* __restrict__ b, int tr, int tc) {
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 av[TI], bv[TJ];
#pragma unroll
    for (int i = 0; i < TI; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (tr + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < TJ; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tc + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < TI; ++i)
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        float s = acc[i][j];
        s = fmaf(av[i].x, bv[j].x, s);
        s = fmaf(av[i].y, bv[j].y, s);
        s = fmaf(av[i].z, bv[j].z, s);
        s = fmaf(av[i].w, bv[j].w, s);
        acc[i][j] = s;
      }
  }
}

// acc[i][c] += sum_t A(t, 4 tr + i) B(t, col c) over t < KT, both k-major
// (rows of LA and LB floats), col c as in Cols<HD>
template <int HD, int KT, int LA, int LB>
__device__ __forceinline__ void mm_kmajor(float (&acc)[4][HD / 16], const float* __restrict__ a,
                                          const float* __restrict__ b, int tr, int tc) {
  using C = Cols<HD>;
#pragma unroll 4
  for (int t = 0; t < KT; ++t) {
    const float4 av = *reinterpret_cast<const float4*>(a + t * LA + 4 * tr);
    float bv[HD / 16];
#pragma unroll
    for (int c = 0; c < C::CN; ++c)
      ld_vec<C::CW>(b + t * LB + (tc + 16 * c) * C::CW, bv + c * C::CW);
    const float ai[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < HD / 16; ++c) acc[i][c] = fmaf(ai[i], bv[c], acc[i][c]);
  }
}

template <int HD>
__device__ __forceinline__ void zero(float (&acc)[4][HD / 16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) acc[i][c] = 0.f;
}

// rows [r0 + 4 tr, r0 + 4 tr + 4) of a (B, S, N, hd) f32 tensor at head n
// from the accumulator, times `scale`; rows at or past S are skipped
template <int HD>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, const float (&acc)[4][HD / 16],
                                           float scale, int b, int r0, int S, int N, int n,
                                           int tr, int tc) {
  using C = Cols<HD>;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = r0 + 4 * tr + i;
    if (s >= S) continue;
    float* row = dst + (((size_t)b * S + s) * N + n) * HD;
#pragma unroll
    for (int c = 0; c < C::CN; ++c) {
      float* p = row + (tc + 16 * c) * C::CW;
      const float* x = acc[i] + c * C::CW;
      if constexpr (C::CW == 4)
        *reinterpret_cast<float4*>(p) = make_float4(x[0] * scale, x[1] * scale, x[2] * scale,
                                                    x[3] * scale);
      else if constexpr (C::CW == 2)
        *reinterpret_cast<float2*>(p) = make_float2(x[0] * scale, x[1] * scale);
      else
        *p = x[0] * scale;
    }
  }
}

__device__ __forceinline__ void thread_tile(int& tr, int& tc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  tr = (warp >> 1) * 4 + (lane >> 3);
  tc = (warp & 1) * 8 + (lane & 7);
}

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(NT)
bwd_dq_f32_kernel(const float* __restrict__ q,      // (B, Sq, H, hd)
                  const float* __restrict__ k,      // (B, Sk, KV, hd)
                  const float* __restrict__ v,
                  const float* __restrict__ o,      // (B, Sq, H, hd)
                  const float* __restrict__ lse,    // (B, H, Sq)
                  const float* __restrict__ dout,   // (B, Sq, H, hd)
                  const int* __restrict__ lengths,  // (B,) or null
                  float* __restrict__ delta,        // (B, H, Sq), written
                  float* __restrict__ dq,           // (B, Sq, H, hd)
                  int Sq, int Sk, int H, int KV, int window, float sm_scale) {
  constexpr int LD = HD + 4;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;      // two stages
  float* Vs = Ks + 2 * BK * LD;   // two stages
  float* dSs = Vs + 2 * BK * LD;  // dS^T: (key, query), rows of LDP
  float* Ds = dSs + BK * LDP;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest tile first
  const int kvh = h / (H / KV);
  int tr, tc;
  thread_tile(tr, tc);
  const int len = lengths ? min(lengths[b], Sk) : Sk;

  copy_rows<float, HD, BQ, LD, NT>(Qs, q, b, q0, Sq, H, h);
  copy_rows<float, HD, BQ, LD, NT>(dOs, dout, b, q0, Sq, H, h);
  cp_async_commit();
  int kstart, kend;
  REPRO_ATTN_KEY_RANGE(CAUSAL, q0, min(q0 + BQ, Sq), len, window, BK, kstart, kend);
  const int ntiles = kend > kstart ? (kend - kstart + BK - 1) / BK : 0;
  auto load_kv = [&](int k0, int st) {
    copy_rows<float, HD, BK, LD, NT>(Ks + st * BK * LD, k, b, k0, Sk, KV, kvh);
    copy_rows<float, HD, BK, LD, NT>(Vs + st * BK * LD, v, b, k0, Sk, KV, kvh);
  };
  if (ntiles > 0) load_kv(kstart, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q and dO have landed
  __syncthreads();
  row_delta<float, HD, BQ, LD, NT>(Ds, delta, dOs, o, b, h, q0, Sq, H);
  __syncthreads();

  // the thread's query rows tr + 16 i: lse (+inf past Sq: P = 0) and Delta
  float L[4], Dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr + 16 * i;
    L[i] = qi < Sq ? lse_or_inf(lse[((size_t)b * H + h) * Sq + qi]) : INFINITY;
    Dl[i] = Ds[tr + 16 * i];
  }
  float acc[4][HD / 16];
  zero<HD>(acc);

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = kstart + it * BK;
    const int st = it & 1;
    if (it + 1 < ntiles) load_kv(k0 + BK, st ^ 1);  // overlaps this tile's math
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* kt = Ks + st * BK * LD;
    const float* vt = Vs + st * BK * LD;
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    dot_rows<4, 4, HD, LD>(s, Qs, kt, tr, tc);    // S = Q K^T
    dot_rows<4, 4, HD, LD>(dp, dOs, vt, tr, tc);  // dP = dO V^T
    const bool full = k0 + BK <= len && (!CAUSAL || k0 + BK - 1 <= q0) &&
                      (window < 0 || k0 > q0 + BQ - 1 - window);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qp = q0 + tr + 16 * i, kp = k0 + tc + 16 * j;
        float p = expf(fmaf(s[i][j], sm_scale, -L[i]));
        if (!full && !REPRO_ATTN_VISIBLE(CAUSAL, kp, qp, len, window)) p = 0.f;
        dSs[(tc + 16 * j) * LDP + tr + 16 * i] = p * (dp[i][j] - Dl[i]);
      }
    __syncthreads();
    mm_kmajor<HD, BK, LDP, LD>(acc, dSs, kt, tr, tc);  // dQ += dS K
    __syncthreads();  // this stage's and dS's readers are done before refills
  }
  cp_async_wait<0>();
  store_rows<HD>(dq, acc, sm_scale, b, q0, Sq, H, h, tr, tc);
}

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(NT)
bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ lse,
                    const float* __restrict__ delta,  // (B, H, Sq), from the dQ launch
                    const float* __restrict__ dout, const int* __restrict__ lengths,
                    float* __restrict__ dk,           // (B, Sk, KV, hd)
                    float* __restrict__ dv, int Sq, int Sk, int H, int KV, int window,
                    float sm_scale) {
  constexpr int LD = HD + 4;
  constexpr int FQ = f32_dkdv_query_tile<HD>();
  constexpr int TJ = FQ / 16;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;       // two stages
  float* dOs = Qs + 2 * FQ * LD;  // two stages
  float* Ps = dOs + 2 * FQ * LD;  // P: (query, key), rows of LDP
  float* dSs = Ps + FQ * LDP;     // dS: (query, key)
  float* Ls = dSs + FQ * LDP;     // two stages
  float* Ds = Ls + 2 * FQ;        // two stages

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * BK;  // causal: the first key tile is the heaviest
  const int G = H / KV;
  int tr, tc;
  thread_tile(tr, tc);
  const int len = lengths ? min(lengths[b], Sk) : Sk;

  float dka[4][HD / 16], dva[4][HD / 16];
  zero<HD>(dka);
  zero<HD>(dva);
  if (k0 < len) {  // else every key of the tile is masked: zero gradients
    copy_rows<float, HD, BK, LD, NT>(Ks, k, b, k0, Sk, KV, kvh);
    copy_rows<float, HD, BK, LD, NT>(Vs, v, b, k0, Sk, KV, kvh);
    cp_async_commit();
    int qstart, qend;
    attn_query_range<CAUSAL>(k0, min(k0 + BK, len), Sq, window, FQ, qstart, qend);
    const int nq = qend > qstart ? (qend - qstart + FQ - 1) / FQ : 0;
    const int total = G * nq;  // (query head of the group, query tile) pairs
    auto load_q = [&](int t, int st) {
      const int h = kvh * G + t / nq, q0 = qstart + (t % nq) * FQ;
      copy_rows<float, HD, FQ, LD, NT>(Qs + st * FQ * LD, q, b, q0, Sq, H, h);
      copy_rows<float, HD, FQ, LD, NT>(dOs + st * FQ * LD, dout, b, q0, Sq, H, h);
      copy_stats<FQ, NT>(Ls + st * FQ, Ds + st * FQ, lse, delta, b, h, q0, Sq, H);
    };
    if (total > 0) load_q(0, 0);
    cp_async_commit();
    for (int t = 0; t < total; ++t) {
      const int st = t & 1;
      const int q0 = qstart + (t % nq) * FQ;
      if (t + 1 < total) load_q(t + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const float* qt = Qs + st * FQ * LD;
      const float* dot = dOs + st * FQ * LD;
      float s[4][TJ], dp[4][TJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TJ; ++j) s[i][j] = dp[i][j] = 0.f;
      dot_rows<4, TJ, HD, LD>(s, Ks, qt, tr, tc);    // S^T = K Q^T
      dot_rows<4, TJ, HD, LD>(dp, Vs, dot, tr, tc);  // dP^T = V dO^T
      const bool full = k0 + BK <= len && (!CAUSAL || k0 + BK - 1 <= q0) &&
                        (window < 0 || k0 > q0 + FQ - 1 - window) && q0 + FQ <= Sq;
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        const int qp = q0 + tc + 16 * j;
        const float l = lse_or_inf(Ls[st * FQ + tc + 16 * j]);
        const float dl = Ds[st * FQ + tc + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kp = k0 + tr + 16 * i;
          float p = expf(fmaf(s[i][j], sm_scale, -l));
          if (!full && !(qp < Sq && REPRO_ATTN_VISIBLE(CAUSAL, kp, qp, len, window))) p = 0.f;
          Ps[(tc + 16 * j) * LDP + tr + 16 * i] = p;
          dSs[(tc + 16 * j) * LDP + tr + 16 * i] = p * (dp[i][j] - dl);
        }
      }
      __syncthreads();
      mm_kmajor<HD, FQ, LDP, LD>(dva, Ps, dot, tr, tc);  // dV += P^T dO
      mm_kmajor<HD, FQ, LDP, LD>(dka, dSs, qt, tr, tc);  // dK += dS^T Q
      __syncthreads();  // this stage's, P's and dS's readers are done
    }
    cp_async_wait<0>();
  }
  store_rows<HD>(dk, dka, sm_scale, b, k0, Sk, KV, kvh, tr, tc);
  store_rows<HD>(dv, dva, 1.f, b, k0, Sk, KV, kvh, tr, tc);
}

// ---- bf16: tensor cores ----------------------------------------------------

constexpr int MMA_WARPS = 4;
constexpr int MMA_NT = 32 * MMA_WARPS;
constexpr int MR = 16 * MMA_WARPS;  // rows a block owns: queries in dQ, keys in dK/dV
constexpr int MK = 64;              // key tile of dQ
constexpr int MQ = 64;              // query tile of dK/dV

// the resident tile's A fragments stay in registers
template <int HD>
__host__ __device__ constexpr bool mma_fragments_in_registers() {
  return HD <= 64;
}

template <int HD>
constexpr int mma_dq_smem_bytes() {
  return (2 * MR + 4 * MK) * (HD + 8) * 2 + MR * 4;
}

template <int HD>
constexpr int mma_dkdv_smem_bytes() {
  return (2 * MR + 4 * MQ) * (HD + 8) * 2 + 4 * MQ * 4;
}

// A fragment (16 rows x 16 columns at column 16 kk) of the warp's rows of
// a row-major tile of LDS elements a row
template <int LDS>
__device__ __forceinline__ void a_frag(uint32_t (&r)[4], const bf16* tile, int kk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  ldmatrix_x4<false>(r, tile + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS + kk * 16 +
                            (lane >> 4) * 8);
}

// acc (16 x 8 NN n-tiles) += A (the warp's 16 rows, KS k-steps: `a(kk, r)`
// gives k-step kk's fragment) times B^T, B's rows the n index at a
// row-major tile of LDS elements a row (ldmatrix, not transposed)
template <int KS, int NN, int LDS, typename AF>
__device__ __forceinline__ void mma_abt(float (&acc)[NN][4], AF a, const bf16* bt) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t af[4];
    a(kk, af);
#pragma unroll
    for (int np = 0; np < NN / 2; ++np) {
      uint32_t f[4];
      ldmatrix_x4<false>(f, bt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LDS + kk * 16 +
                                ((lane >> 3) & 1) * 8);
      mma_bf16_16816(acc[2 * np], af, f[0], f[1]);
      mma_bf16_16816(acc[2 * np + 1], af, f[2], f[3]);
    }
  }
}

// acc (16 x hd, NO n-tiles) += X B, X (16 x 16 KP) from the accumulator
// fragments x (KP * 2 n-tiles, packed to bf16), B's rows the k index at a
// row-major tile of LDS elements a row (ldmatrix.trans)
template <int KP, int NO, int LDS>
__device__ __forceinline__ void mma_xb(float (&acc)[NO][4], const float (&x)[2 * KP][4],
                                       const bf16* bt) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < KP; ++kk) {
    const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < NO / 2; ++np) {
      uint32_t f[4];
      ldmatrix_x4<true>(f, bt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS + np * 16 +
                               (lane >> 4) * 8);
      mma_bf16_16816(acc[2 * np], a, f[0], f[1]);
      mma_bf16_16816(acc[2 * np + 1], a, f[2], f[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero_frags(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// the warp's rows r0 + 16 warp + gr (+ 8) of a (B, S, N, hd) bf16 tensor at
// head n from the accumulator fragments, times `scale`; rows at or past S
// are skipped
template <int NO>
__device__ __forceinline__ void store_frags(bf16* __restrict__ dst, const float (&acc)[NO][4],
                                            float scale, int b, int r0, int S, int N, int n) {
  constexpr int HD = NO * 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tc = lane & 3;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int s = r0 + warp * 16 + gr + hi * 8;
    if (s >= S) continue;
    bf16* row = dst + (((size_t)b * S + s) * N + n) * HD + tc * 2;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<uint32_t*>(row + j * 8) =
          pack_bf16(acc[j][2 * hi] * scale, acc[j][2 * hi + 1] * scale);
  }
}

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(MMA_NT)
bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ o,
                  const float* __restrict__ lse, const bf16* __restrict__ dout,
                  const int* __restrict__ lengths, float* __restrict__ delta,
                  bf16* __restrict__ dq, int Sq, int Sk, int H, int KV, int window,
                  float sm_scale) {
  static_assert(HD % 16 == 0, "hd must be a multiple of the mma depth");
  constexpr int LDS = HD + 8;  // bf16 per shared row: 16 bytes of padding
  constexpr int KS = HD / 16;  // k-steps of S and dP
  constexpr int NO = HD / 8;   // n8 tiles of dQ
  constexpr int NS = MK / 8;   // n8 tiles of S and dP
  constexpr bool FREGS = mma_fragments_in_registers<HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + MR * LDS;
  bf16* Ks = dOs + MR * LDS;  // two stages
  bf16* Vs = Ks + 2 * MK * LDS;
  float* Ds = reinterpret_cast<float*>(Vs + 2 * MK * LDS);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * MR;  // heaviest tile first
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;  // accumulator rows gr and gr + 8
  const int tc = lane & 3;   // accumulator columns 2 tc, 2 tc + 1
  const int len = lengths ? min(lengths[b], Sk) : Sk;
  const float scale_log2 = sm_scale * LOG2E;

  copy_rows<bf16, HD, MR, LDS, MMA_NT>(Qs, q, b, q0, Sq, H, h);
  copy_rows<bf16, HD, MR, LDS, MMA_NT>(dOs, dout, b, q0, Sq, H, h);
  cp_async_commit();
  int kstart, kend;
  REPRO_ATTN_KEY_RANGE(CAUSAL, q0, min(q0 + MR, Sq), len, window, MK, kstart, kend);
  const int ntiles = kend > kstart ? (kend - kstart + MK - 1) / MK : 0;
  auto load_kv = [&](int k0, int st) {
    copy_rows<bf16, HD, MK, LDS, MMA_NT>(Ks + st * MK * LDS, k, b, k0, Sk, KV, kvh);
    copy_rows<bf16, HD, MK, LDS, MMA_NT>(Vs + st * MK * LDS, v, b, k0, Sk, KV, kvh);
  };
  if (ntiles > 0) load_kv(kstart, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q and dO have landed
  __syncthreads();
  row_delta<bf16, HD, MR, LDS, MMA_NT>(Ds, delta, dOs, o, b, h, q0, Sq, H);
  uint32_t qf[FREGS ? KS : 1][4], df[FREGS ? KS : 1][4];
  if constexpr (FREGS) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      a_frag<LDS>(qf[kk], Qs, kk);
      a_frag<LDS>(df[kk], dOs, kk);
    }
  }
  __syncthreads();

  // rows gr and gr + 8 of the warp: lse in the log2 domain (+inf past Sq
  // and where nothing is attended: P = 0) and Delta
  const int qw0 = q0 + warp * 16;
  float l2[2], dl[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int qi = qw0 + gr + hi * 8;
    l2[hi] = qi < Sq ? lse_or_inf(lse[((size_t)b * H + h) * Sq + qi]) * LOG2E : INFINITY;
    dl[hi] = Ds[warp * 16 + gr + hi * 8];
  }
  float acc[NO][4];
  zero_frags(acc);

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = kstart + it * MK;
    const int st = it & 1;
    if (it + 1 < ntiles) load_kv(k0 + MK, st ^ 1);  // overlaps this tile's math
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = Ks + st * MK * LDS;
    const bf16* vt = Vs + st * MK * LDS;
    // whether the warp's 16 queries can see a key of the tile (warp-uniform)
    const bool any = qw0 < Sq && k0 < len && (!CAUSAL || k0 <= qw0 + 15) &&
                     (window < 0 || k0 + MK - 1 > qw0 - window);
    if (any) {
      float s[NS][4], dp[NS][4];
      zero_frags(s);
      zero_frags(dp);
      mma_abt<KS, NS, LDS>(s, [&](int kk, uint32_t(&r)[4]) {  // S = Q K^T
        if constexpr (FREGS) {
#pragma unroll
          for (int e = 0; e < 4; ++e) r[e] = qf[kk][e];
        } else {
          a_frag<LDS>(r, Qs, kk);
        }
      }, kt);
      mma_abt<KS, NS, LDS>(dp, [&](int kk, uint32_t(&r)[4]) {  // dP = dO V^T
        if constexpr (FREGS) {
#pragma unroll
          for (int e = 0; e < 4; ++e) r[e] = df[kk][e];
        } else {
          a_frag<LDS>(r, dOs, kk);
        }
      }, vt);
      // element e of n-tile j: query qw0 + gr + 8 (e >> 1), key
      // k0 + 8 j + 2 tc + (e & 1); mask only tiles that cross an edge
      const bool full = k0 + MK <= len && (!CAUSAL || k0 + MK - 1 <= qw0) &&
                        (window < 0 || k0 > qw0 + 15 - window);
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(s[j][e], scale_log2, -l2[e >> 1]));
          if (!full) {
            const int kp = k0 + j * 8 + tc * 2 + (e & 1);
            const int qp = qw0 + gr + (e >> 1) * 8;
            if (!REPRO_ATTN_VISIBLE(CAUSAL, kp, qp, len, window)) p = 0.f;
          }
          s[j][e] = p * (dp[j][e] - dl[e >> 1]);  // dS
        }
      mma_xb<MK / 16, NO, LDS>(acc, s, kt);  // dQ += dS K
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }
  cp_async_wait<0>();
  store_frags<NO>(dq, acc, sm_scale, b, q0, Sq, H, h);
}

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(MMA_NT)
bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ lse,
                    const float* __restrict__ delta, const bf16* __restrict__ dout,
                    const int* __restrict__ lengths, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int Sq, int Sk, int H, int KV, int window,
                    float sm_scale) {
  static_assert(HD % 16 == 0, "hd must be a multiple of the mma depth");
  constexpr int LDS = HD + 8;
  constexpr int KS = HD / 16;  // k-steps of S^T and dP^T
  constexpr int NO = HD / 8;   // n8 tiles of dK and dV
  constexpr int NS = MQ / 8;   // n8 tiles of S^T and dP^T
  constexpr bool FREGS = mma_fragments_in_registers<HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + MR * LDS;
  bf16* Qs = Vs + MR * LDS;       // two stages
  bf16* dOs = Qs + 2 * MQ * LDS;  // two stages
  float* Ls = reinterpret_cast<float*>(dOs + 2 * MQ * LDS);  // two stages
  float* Ds = Ls + 2 * MQ;                                   // two stages

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * MR;  // causal: the first key tile is the heaviest
  const int G = H / KV;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;  // accumulator rows (keys) gr and gr + 8
  const int tc = lane & 3;   // accumulator columns (queries) 2 tc, 2 tc + 1
  const int len = lengths ? min(lengths[b], Sk) : Sk;
  const float scale_log2 = sm_scale * LOG2E;
  const int kw0 = k0 + warp * 16;  // the warp's first key

  float dka[NO][4], dva[NO][4];
  zero_frags(dka);
  zero_frags(dva);
  if (k0 < len) {  // else every key of the tile is masked: zero gradients
    copy_rows<bf16, HD, MR, LDS, MMA_NT>(Ks, k, b, k0, Sk, KV, kvh);
    copy_rows<bf16, HD, MR, LDS, MMA_NT>(Vs, v, b, k0, Sk, KV, kvh);
    cp_async_commit();
    int qstart, qend;
    attn_query_range<CAUSAL>(k0, min(k0 + MR, len), Sq, window, MQ, qstart, qend);
    const int nq = qend > qstart ? (qend - qstart + MQ - 1) / MQ : 0;
    const int total = G * nq;  // (query head of the group, query tile) pairs
    auto load_q = [&](int t, int st) {
      const int h = kvh * G + t / nq, q0 = qstart + (t % nq) * MQ;
      copy_rows<bf16, HD, MQ, LDS, MMA_NT>(Qs + st * MQ * LDS, q, b, q0, Sq, H, h);
      copy_rows<bf16, HD, MQ, LDS, MMA_NT>(dOs + st * MQ * LDS, dout, b, q0, Sq, H, h);
      copy_stats<MQ, MMA_NT>(Ls + st * MQ, Ds + st * MQ, lse, delta, b, h, q0, Sq, H);
    };
    if (total > 0) load_q(0, 0);
    cp_async_commit();
    uint32_t kf[FREGS ? KS : 1][4], vf[FREGS ? KS : 1][4];
    for (int t = 0; t < total; ++t) {
      const int st = t & 1;
      const int q0 = qstart + (t % nq) * MQ;
      if (t + 1 < total) load_q(t + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      if constexpr (FREGS) {
        if (t == 0) {
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) {
            a_frag<LDS>(kf[kk], Ks, kk);
            a_frag<LDS>(vf[kk], Vs, kk);
          }
        }
      }
      const bf16* qt = Qs + st * MQ * LDS;
      const bf16* dot = dOs + st * MQ * LDS;
      const float* lt = Ls + st * MQ;
      const float* dt = Ds + st * MQ;
      // whether the warp's 16 keys are seen by a query of the tile
      const bool any = kw0 < len && (!CAUSAL || kw0 <= q0 + MQ - 1) &&
                       (window < 0 || kw0 + 15 > q0 - window);
      if (any) {
        float s[NS][4], dp[NS][4];
        zero_frags(s);
        zero_frags(dp);
        mma_abt<KS, NS, LDS>(s, [&](int kk, uint32_t(&r)[4]) {  // S^T = K Q^T
          if constexpr (FREGS) {
#pragma unroll
            for (int e = 0; e < 4; ++e) r[e] = kf[kk][e];
          } else {
            a_frag<LDS>(r, Ks, kk);
          }
        }, qt);
        mma_abt<KS, NS, LDS>(dp, [&](int kk, uint32_t(&r)[4]) {  // dP^T = V dO^T
          if constexpr (FREGS) {
#pragma unroll
            for (int e = 0; e < 4; ++e) r[e] = vf[kk][e];
          } else {
            a_frag<LDS>(r, Vs, kk);
          }
        }, dot);
        // element e of n-tile j: key kw0 + gr + 8 (e >> 1), query
        // q0 + 8 j + 2 tc + (e & 1): lse and Delta per column
        const bool full = kw0 + 16 <= len && (!CAUSAL || kw0 + 15 <= q0) &&
                          (window < 0 || kw0 > q0 + MQ - 1 - window) && q0 + MQ <= Sq;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float2 lv = *reinterpret_cast<const float2*>(lt + j * 8 + tc * 2);
          const float2 dv2 = *reinterpret_cast<const float2*>(dt + j * 8 + tc * 2);
          const float l2[2] = {lse_or_inf(lv.x) * LOG2E, lse_or_inf(lv.y) * LOG2E};
          const float dl[2] = {dv2.x, dv2.y};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2f(fmaf(s[j][e], scale_log2, -l2[e & 1]));
            if (!full) {
              const int kp = kw0 + gr + (e >> 1) * 8;
              const int qp = q0 + j * 8 + tc * 2 + (e & 1);
              if (!(qp < Sq && REPRO_ATTN_VISIBLE(CAUSAL, kp, qp, len, window))) p = 0.f;
            }
            s[j][e] = p;                           // P^T
            dp[j][e] = p * (dp[j][e] - dl[e & 1]);  // dS^T
          }
        }
        mma_xb<MQ / 16, NO, LDS>(dva, s, dot);  // dV += P^T dO
        mma_xb<MQ / 16, NO, LDS>(dka, dp, qt);  // dK += dS^T Q
      }
      __syncthreads();  // this stage's readers are done before it is refilled
    }
    cp_async_wait<0>();
  }
  store_frags<NO>(dk, dka, sm_scale, b, k0, Sk, KV, kvh);
  store_frags<NO>(dv, dva, 1.f, b, k0, Sk, KV, kvh);
}

// ---- launches ------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *o, *lse, *dout, *lengths;
  float* delta;
  void *dq, *dk, *dv;
  int B, Sq, Sk, H, KV, window;
  float sm_scale;
  cudaStream_t stream;
};

template <typename T>
const T* cp(const void* p) {
  return static_cast<const T*>(p);
}

template <int HD, bool CAUSAL>
int launch_dq(int dtype, const Args& a) {
  dim3 grid(a.H, a.B, (a.Sq + 63) / 64);
  cudaError_t err;
  if (dtype == DTYPE_F32) {
    constexpr int bytes = f32_dq_smem_bytes<HD>();
    auto kern = bwd_dq_f32_kernel<HD, CAUSAL>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, NT, bytes, a.stream>>>(
        cp<float>(a.q), cp<float>(a.k), cp<float>(a.v), cp<float>(a.o), cp<float>(a.lse),
        cp<float>(a.dout), cp<int>(a.lengths), a.delta, static_cast<float*>(a.dq), a.Sq, a.Sk,
        a.H, a.KV, a.window, a.sm_scale);
  } else {
    constexpr int bytes = mma_dq_smem_bytes<HD>();
    auto kern = bwd_dq_mma_kernel<HD, CAUSAL>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, MMA_NT, bytes, a.stream>>>(
        cp<bf16>(a.q), cp<bf16>(a.k), cp<bf16>(a.v), cp<bf16>(a.o), cp<float>(a.lse),
        cp<bf16>(a.dout), cp<int>(a.lengths), a.delta, static_cast<bf16*>(a.dq), a.Sq, a.Sk,
        a.H, a.KV, a.window, a.sm_scale);
  }
  return (int)cudaGetLastError();
}

template <int HD, bool CAUSAL>
int launch_dkdv(int dtype, const Args& a) {
  dim3 grid(a.KV, a.B, (a.Sk + 63) / 64);
  cudaError_t err;
  if (dtype == DTYPE_F32) {
    constexpr int bytes = f32_dkdv_smem_bytes<HD>();
    auto kern = bwd_dkdv_f32_kernel<HD, CAUSAL>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, NT, bytes, a.stream>>>(
        cp<float>(a.q), cp<float>(a.k), cp<float>(a.v), cp<float>(a.lse), a.delta,
        cp<float>(a.dout), cp<int>(a.lengths), static_cast<float*>(a.dk),
        static_cast<float*>(a.dv), a.Sq, a.Sk, a.H, a.KV, a.window, a.sm_scale);
  } else {
    constexpr int bytes = mma_dkdv_smem_bytes<HD>();
    auto kern = bwd_dkdv_mma_kernel<HD, CAUSAL>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, MMA_NT, bytes, a.stream>>>(
        cp<bf16>(a.q), cp<bf16>(a.k), cp<bf16>(a.v), cp<float>(a.lse), a.delta,
        cp<bf16>(a.dout), cp<int>(a.lengths), static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), a.Sq, a.Sk, a.H, a.KV, a.window, a.sm_scale);
  }
  return (int)cudaGetLastError();
}

template <bool DQ>
int dispatch(int dtype, int hd, int causal, const Args& a) {
  if (dtype != DTYPE_F32 && dtype != DTYPE_BF16) return (int)cudaErrorInvalidValue;
#define REPRO_HD_CASE(HD)                                                      \
  case HD:                                                                     \
    if constexpr (DQ)                                                          \
      return causal ? launch_dq<HD, true>(dtype, a) : launch_dq<HD, false>(dtype, a); \
    else                                                                       \
      return causal ? launch_dkdv<HD, true>(dtype, a) : launch_dkdv<HD, false>(dtype, a);
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

// q, out, dout, dq (B, Sq, H, hd); k, v, dk, dv (B, Sk, KV, hd); lse and
// delta (B, H, Sq) f32: lse from the forward, delta written by the dQ
// launch and read by the dK/dV launch, which must follow it on the same
// stream; lengths (B,) int32 or null. window < 0 means no window; positions
// are the indices (no query offset). dtype f32 (CUDA cores) or bf16 (tensor
// cores), hd in {32, 64, 80, 128}. Each returns cudaGetLastError() after
// its launch (or the attribute call's error); an empty grid launches
// nothing.
int flash_attention_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                           const void* out, const void* lse, const void* dout,
                           const void* lengths, void* delta, void* dq, int B, int Sq, int Sk,
                           int H, int KV, int hd, int causal, int window, float sm_scale,
                           void* stream) {
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || H == 0) return (int)cudaSuccess;
  Args a{q,  k,  v,  out, lse, dout, lengths, static_cast<float*>(delta), dq, nullptr, nullptr,
         B,  Sq, Sk, H,   KV,  window, sm_scale, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(dtype, hd, causal, a);
}

int flash_attention_bwd_dkdv(int dtype, const void* q, const void* k, const void* v,
                             const void* lse, const void* delta, const void* dout,
                             const void* lengths, void* dk, void* dv, int B, int Sq, int Sk,
                             int H, int KV, int hd, int causal, int window, float sm_scale,
                             void* stream) {
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sk == 0) return (int)cudaSuccess;
  Args a{q,       k,  v,  nullptr, lse, dout, lengths,
         const_cast<float*>(static_cast<const float*>(delta)),
         nullptr, dk, dv, B,       Sq,  Sk,   H,       KV, window, sm_scale,
         static_cast<cudaStream_t>(stream)};
  return dispatch<false>(dtype, hd, causal, a);
}

}  // extern "C"
