// Backward of the Mamba-1 selective scan (selective_scan.cu): from dy and
// the forward's inputs and chunk states, the gradients of x, dt, A, B, C
// and D.
//
// The TPU side has no kernel to replace here: the reference trains through
// XLA's autodiff of src/repro/kernels/ref.py:selective_scan_ref (and
// ssd_ref, which the port maps onto this scan: kernels/ops.py:
// ssd_scan_args), and its Pallas scan has no custom_vjp. On the card the
// plain version (kernels/ref.py:selective_scan_bwd_ref) stays off the
// training path; this kernel takes its place behind
// kernels/ops.py:SelectiveScan.
//
// Per batch row b, channel d and state n, with a_t = exp(dt_t A) and
// u_t = dt_t x_t, the adjoint of h_t runs in reverse time,
//   g_t = C_t dy_t + a_{t+1} g_{t+1},
// and gives
//   dx_t  = dt_t sum_n g_t B_t + D dy_t
//   ddt_t = sum_n g_t (A a_t h_{t-1} + x_t B_t)
//   dB_t  = sum_d g_t u_t,      dC_t = sum_d dy_t h_t
//   dA    = sum_{b,t} g_t dt_t a_t h_{t-1},   dD = sum_{b,t} dy_t x_t,
// all accumulated in f32; dx, ddt, dB and dC are written in the inputs'
// type, dA and dD in f32.
//
// The block layout is the forward's: one block per 32 channels and batch
// row, lane l owning channel d0 + l, warp g owning states [g NPL, (g+1)
// NPL), and the forward's launch plan (NPL, T). The block walks the
// forward's T-step chunks in reverse. For each it stages x, dt, dy and the
// (B, C) pairs in shared memory, starts from the state the forward wrote
// after the chunk before (zero for the first), and recomputes h with the
// forward's own step (scan_common.cuh), so the states are the forward's
// bitwise. A whole chunk of h per thread would take T NPL registers (up to
// 512), so the chunk is cut into sub-chunks of U = 8 steps (4 at 8 states
// per thread): one forward sweep writes h at each sub-chunk's start to
// shared memory (each thread reads back only its own), then the sub-chunks
// run in reverse, each replaying its U steps of h and of a into registers
// (64 of them at every plan) and walking them backwards. That costs two
// exponentials per (b, t, d, n), the sweep's and the replay's, where the
// forward took one.
//
// The sums, all in a fixed order and without atomics, so two launches give
// bitwise-equal gradients:
// - over n (dx, ddt): each warp's partial over its NPL states goes to
//   shared memory, and after each sub-chunk the block adds the N / NPL
//   partials in warp order, as the forward sums y;
// - over d (dB, dC): per step, a warp's 2 NPL values (g u and dy h of each
//   of its states) are summed over its 32 lanes by a transposing butterfly
//   (warp_transpose_sum: about one shuffle per value, where a plain
//   butterfly of each value takes five), then each channel block writes
//   its partial to an f32 (B, S, ceil(D / 32), N) buffer;
// - over b and t (dA, dD): registers through the block's walk over t, then
//   an f32 partial per batch row;
// and a second, small kernel (scan_bwd_finish) adds the partials in order
// over channel blocks and batch rows and writes dB, dC, dA and dD.
//
// What bounds it on an H100: at the model's shapes the f32 operations
// (about 19 per (b, t, d, n) against the 6 of the forward) or the
// exponentials (at least one per (b, t, d, n), two here); the bytes are x,
// dt and dy in, dx and ddt out. A first kernel, right and simple: rows are
// staged by plain loads without overlap, and every shared read is scalar
// but the (B, C) pairs'.
//
// Inputs as the forward takes them: x, dt and dy contiguous (B, S, D); B
// and C strided with a unit last stride (their gradients are written
// contiguous); any D (the last block masks channels past it) and any S
// (the last chunk runs over zero-filled steps: dt = 0 keeps the state,
// dy = 0 adds no adjoint).

#include "scan_common.cuh"

using namespace repro_attn;
using namespace repro_scan;

namespace {

// steps of a sub-chunk replayed into registers: U NPL states and decays
// take 64 registers a thread at every plan the forward has
__host__ __device__ constexpr int sub_steps(int npl) { return npl >= 8 ? 4 : 8; }

// bytes of dynamic shared memory for one block
__host__ __device__ constexpr size_t bwd_smem_bytes(int T, int N, int P, int U, int itemsize) {
  return size_t(T / U) * N * CH * 4         // h at each sub-chunk's start
         + size_t(2) * P * U * CH * 4       // each warp's partial sums for dx, ddt
         + size_t(3) * T * CH * itemsize    // x, dt and dy rows
         + size_t(T) * N * 2 * itemsize;    // (B, C) pairs
}

// Sum each of the K values v[0..K) of a lane over the warp's 32 lanes.
// Transposing rounds first, at offsets 16, 8, ...: in each, a lane keeps
// half its values, receives its partner's share of the same half and
// sends the other, so the values halve as the partial sums double; once
// one value is left, plain butterfly rounds finish it. Afterwards lane l
// holds, in v[0], the sum of value l / (32 / K) (K a power of two <= 32).
template <int K, int OFF>
__device__ __forceinline__ void warp_transpose_sum(float* v, int lane) {
  if constexpr (OFF >= 1) {
    if constexpr (K > 1) {
      constexpr int H = K / 2;
      const bool up = lane & OFF;
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const float send = up ? v[j] : v[j + H];
        const float keep = up ? v[j + H] : v[j];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      warp_transpose_sum<H, OFF / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
      warp_transpose_sum<1, OFF / 2>(v, lane);
    }
  }
}

template <typename Tp, int N, int NPL, int T>
__global__ void __launch_bounds__(CH * N / NPL)
scan_bwd_kernel(const Tp* __restrict__ x,          // (B, S, D) contiguous
                const Tp* __restrict__ dt,         // (B, S, D) contiguous
                const float* __restrict__ A,       // (D, N)
                const Tp* __restrict__ Bm,         // (B, S, N), strides (sb_b, sb_t, 1)
                const Tp* __restrict__ Cm,         // (B, S, N), strides (sc_b, sc_t, 1)
                const float* __restrict__ Dv,      // (D,)
                const float* __restrict__ states,  // (B, ceil(S / T), D, N): h after each chunk
                const Tp* __restrict__ dy,         // (B, S, D) contiguous
                Tp* __restrict__ dx,               // (B, S, D)
                Tp* __restrict__ ddt,              // (B, S, D)
                float* __restrict__ dBp,           // (B, S, ceil(D / CH), N) partials
                float* __restrict__ dCp,           // (B, S, ceil(D / CH), N) partials
                float* __restrict__ dAp,           // (B, D, N) partials
                float* __restrict__ dDp,           // (B, D) partials
                int S, int D, long long sb_b, long long sb_t, long long sc_b, long long sc_t) {
  constexpr int P = N / NPL;          // warps per block
  constexpr int NT = CH * P;          // threads per block
  constexpr int U = sub_steps(NPL);   // steps per sub-chunk
  constexpr int K = T / U;            // sub-chunks per chunk
  constexpr int BW = NPL * 2 * int(sizeof(Tp)) / 4;  // words of (B, C) pairs a step
  constexpr int SPREAD = 32 / (2 * NPL);             // lanes holding one dB / dC sum
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_h = reinterpret_cast<float*>(smem);           // [K][N][CH]
  float* s_p = s_h + K * N * CH;                          // [2][P][U][CH]
  Tp* s_x = reinterpret_cast<Tp*>(s_p + 2 * P * U * CH);  // [T][CH]
  Tp* s_dt = s_x + T * CH;                                // [T][CH]
  Tp* s_dy = s_dt + T * CH;                               // [T][CH]
  Tp* s_bc = s_dy + T * CH;                               // [T][N][2]: (B, C) of each state

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = tid >> 5;
  const int b = blockIdx.y;
  const int cb = blockIdx.x;
  const int ncb = gridDim.x;
  const int d = cb * CH + lane;
  const bool live = d < D;
  const int nch = (S + T - 1) / T;
  const long long row0 = (long long)b * S;  // row (b, t = 0) of x, dt, dy
  const long long Dl = D;
  const Tp zero = from_f32<Tp>(0.f);

  // A as the forward loads it (a2 = A log2(e)), A itself for ddt, the
  // adjoint carried to the step before (a_{t+1} g_{t+1}), dA's and dD's sums
  float a2[NPL], av[NPL], carry[NPL], dA[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    av[i] = live ? A[(long long)d * N + g * NPL + i] : 0.f;
    a2[i] = live ? A[(long long)d * N + g * NPL + i] * LOG2E : 0.f;
    carry[i] = 0.f;
    dA[i] = 0.f;
  }
  const float dk = live ? Dv[d] : 0.f;
  float dD = 0.f;

  for (int c = nch - 1; c >= 0; --c) {
    const int t0 = c * T;
    __syncthreads();  // the previous chunk's readers are done with the rows
    for (int i = tid; i < T * CH; i += NT) {
      const int tt = i / CH, dd = cb * CH + i % CH;
      const bool ok = t0 + tt < S && dd < D;
      const long long off = (row0 + t0 + tt) * Dl + dd;
      s_x[i] = ok ? x[off] : zero;
      s_dt[i] = ok ? dt[off] : zero;
      s_dy[i] = ok ? dy[off] : zero;
    }
    for (int i = tid; i < T * N; i += NT) {
      const int tt = i / N, n = i % N;
      const bool ok = t0 + tt < S;
      s_bc[2 * i] = ok ? Bm[b * sb_b + (t0 + tt) * sb_t + n] : zero;
      s_bc[2 * i + 1] = ok ? Cm[b * sc_b + (t0 + tt) * sc_t + n] : zero;
    }
    // the state the chunk starts from: the forward's after chunk c - 1
    float h[NPL];
#pragma unroll
    for (int i = 0; i < NPL; ++i)
      h[i] = (c > 0 && live)
                 ? states[(((long long)b * nch + c - 1) * D + d) * N + g * NPL + i]
                 : 0.f;
    __syncthreads();

    // the forward's states at each sub-chunk's start
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int i = 0; i < NPL; ++i) s_h[(k * N + g * NPL + i) * CH + lane] = h[i];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = k * U + u;
        const float dv = to_f32(s_dt[t * CH + lane]);
        const float uu = dv * to_f32(s_x[t * CH + lane]);
        uint32_t w[BW];
        load_words(s_bc + (t * N + g * NPL) * 2, w);
#pragma unroll
        for (int i = 0; i < NPL; ++i)
          h[i] = scan_update(scan_decay(dv, a2[i]), h[i], uu, word_elem<Tp>(w, 2 * i));
      }
    }

    for (int k = K - 1; k >= 0; --k) {
      // replay the sub-chunk's states and decays into registers
      float hs[NPL], hh[U][NPL], aa[U][NPL];
#pragma unroll
      for (int i = 0; i < NPL; ++i) hs[i] = s_h[(k * N + g * NPL + i) * CH + lane];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = k * U + u;
        const float dv = to_f32(s_dt[t * CH + lane]);
        const float uu = dv * to_f32(s_x[t * CH + lane]);
        uint32_t w[BW];
        load_words(s_bc + (t * N + g * NPL) * 2, w);
#pragma unroll
        for (int i = 0; i < NPL; ++i) {
          aa[u][i] = scan_decay(dv, a2[i]);
          const float hp = u == 0 ? hs[i] : hh[u > 0 ? u - 1 : 0][i];
          hh[u][i] = scan_update(aa[u][i], hp, uu, word_elem<Tp>(w, 2 * i));
        }
      }
      // and walk them backwards
#pragma unroll
      for (int u = U - 1; u >= 0; --u) {
        const int t = k * U + u;
        const int tg = t0 + t;
        const float dv = to_f32(s_dt[t * CH + lane]);
        const float xv = to_f32(s_x[t * CH + lane]);
        const float dyv = to_f32(s_dy[t * CH + lane]);
        const float uu = dv * xv;
        uint32_t w[BW];
        load_words(s_bc + (t * N + g * NPL) * 2, w);
        float s1 = 0.f, s2 = 0.f;  // sum_n g B and sum_n g A a h_{t-1}, this warp's states
        float v[2 * NPL];          // g u (dB) and dy h (dC) of each state
#pragma unroll
        for (int i = 0; i < NPL; ++i) {
          const float gi = fmaf(word_elem<Tp>(w, 2 * i + 1), dyv, carry[i]);
          const float hp = u == 0 ? hs[i] : hh[u > 0 ? u - 1 : 0][i];  // h_{t-1}
          const float q = gi * aa[u][i] * hp;
          s1 = fmaf(gi, word_elem<Tp>(w, 2 * i), s1);
          s2 = fmaf(q, av[i], s2);
          dA[i] = fmaf(q, dv, dA[i]);
          v[i] = gi * uu;
          v[NPL + i] = dyv * hh[u][i];
          carry[i] = aa[u][i] * gi;
        }
        if (g == 0) dD = fmaf(dyv, xv, dD);
        warp_transpose_sum<2 * NPL, 16>(v, lane);
        if (lane % SPREAD == 0 && tg < S) {
          const int j = lane / SPREAD;
          float* part = j < NPL ? dBp : dCp;
          part[((row0 + tg) * ncb + cb) * N + g * NPL + j % NPL] = v[0];
        }
        s_p[(g * U + u) * CH + lane] = s1;
        s_p[((P + g) * U + u) * CH + lane] = s2;
      }
      __syncthreads();  // every warp's partials of the sub-chunk
      for (int u = g; u < U; u += P) {
        const int t = k * U + u;
        const int tg = t0 + t;
        if (live && tg < S) {
          float s1 = 0.f, s2 = 0.f;
          for (int gg = 0; gg < P; ++gg) {
            s1 += s_p[(gg * U + u) * CH + lane];
            s2 += s_p[((P + gg) * U + u) * CH + lane];
          }
          const float dv = to_f32(s_dt[t * CH + lane]);
          const float xv = to_f32(s_x[t * CH + lane]);
          const float dyv = to_f32(s_dy[t * CH + lane]);
          const long long off = (row0 + tg) * Dl + d;
          dx[off] = from_f32<Tp>(fmaf(dv, s1, dk * dyv));
          ddt[off] = from_f32<Tp>(fmaf(xv, s1, s2));
        }
      }
      __syncthreads();  // the partials are read before the next sub-chunk's
    }
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < NPL; ++i) dAp[((long long)b * D + d) * N + g * NPL + i] = dA[i];
    if (g == 0) dDp[(long long)b * D + d] = dD;
  }
}

// The partials summed in a fixed order: dB and dC over channel blocks, dA
// and dD over batch rows. One thread per output element, grid-strided.
template <typename Tp>
__global__ void __launch_bounds__(256)
scan_bwd_finish(const float* __restrict__ dBp, const float* __restrict__ dCp,
                const float* __restrict__ dAp, const float* __restrict__ dDp,
                Tp* __restrict__ dB, Tp* __restrict__ dC, float* __restrict__ dA,
                float* __restrict__ dD, int Bsz, int S, int D, int N, int ncb) {
  const long long nbc = (long long)Bsz * S * N;
  const long long na = (long long)D * N;
  const long long total = 2 * nbc + na + D;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    if (i < 2 * nbc) {
      const bool is_c = i >= nbc;
      const long long j = is_c ? i - nbc : i;
      const float* p = (is_c ? dCp : dBp) + (j / N) * ncb * N + j % N;
      for (int q = 0; q < ncb; ++q) s += p[(long long)q * N];
      (is_c ? dC : dB)[j] = from_f32<Tp>(s);
    } else if (i < 2 * nbc + na) {
      const long long j = i - 2 * nbc;
      for (int q = 0; q < Bsz; ++q) s += dAp[q * na + j];
      dA[j] = s;
    } else {
      const long long j = i - 2 * nbc - na;
      for (int q = 0; q < Bsz; ++q) s += dDp[(long long)q * D + j];
      dD[j] = s;
    }
  }
}

struct Args {
  const void *x, *dt, *A, *Bm, *Cm, *Dv, *states, *dy;
  void *dx, *ddt, *dB, *dC, *dA, *dD, *dBp, *dCp, *dAp, *dDp;
  int B, S, D;
  long long sb_b, sb_t, sc_b, sc_t;
};

template <typename Tp, int N, int NPL, int T>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int P = N / NPL;
  constexpr size_t smem = bwd_smem_bytes(T, N, P, sub_steps(NPL), int(sizeof(Tp)));
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        scan_bwd_kernel<Tp, N, NPL, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int ncb = (a.D + CH - 1) / CH;
  scan_bwd_kernel<Tp, N, NPL, T><<<dim3(ncb, a.B), CH * P, smem, stream>>>(
      static_cast<const Tp*>(a.x), static_cast<const Tp*>(a.dt), static_cast<const float*>(a.A),
      static_cast<const Tp*>(a.Bm), static_cast<const Tp*>(a.Cm),
      static_cast<const float*>(a.Dv), static_cast<const float*>(a.states),
      static_cast<const Tp*>(a.dy), static_cast<Tp*>(a.dx), static_cast<Tp*>(a.ddt),
      static_cast<float*>(a.dBp), static_cast<float*>(a.dCp), static_cast<float*>(a.dAp),
      static_cast<float*>(a.dDp), a.S, a.D, a.sb_b, a.sb_t, a.sc_b, a.sc_t);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total = 2LL * a.B * a.S * N + (long long)a.D * N + a.D;
  const long long want = (total + 255) / 256;
  const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);
  scan_bwd_finish<Tp><<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(a.dBp), static_cast<const float*>(a.dCp),
      static_cast<const float*>(a.dAp), static_cast<const float*>(a.dDp),
      static_cast<Tp*>(a.dB), static_cast<Tp*>(a.dC), static_cast<float*>(a.dA),
      static_cast<float*>(a.dD), a.B, a.S, a.D, N, ncb);
  return (int)cudaGetLastError();
}

// the forward's plans (selective_scan.cu:dispatch): (N, states per thread)
// with 1 to 16 warps per block, 32 or 64 steps per chunk
template <typename Tp>
int dispatch(int N, int npl, int T, const Args& a, cudaStream_t stream) {
#define SCAN_CASE(NN, PP) \
  if (N == NN && npl == PP) \
    return T == 64 ? launch<Tp, NN, PP, 64>(a, stream) : launch<Tp, NN, PP, 32>(a, stream);
  SCAN_CASE(4, 1) SCAN_CASE(4, 2) SCAN_CASE(4, 4)
  SCAN_CASE(8, 1) SCAN_CASE(8, 2) SCAN_CASE(8, 4) SCAN_CASE(8, 8)
  SCAN_CASE(16, 1) SCAN_CASE(16, 2) SCAN_CASE(16, 4) SCAN_CASE(16, 8)
  SCAN_CASE(32, 2) SCAN_CASE(32, 4) SCAN_CASE(32, 8)
  SCAN_CASE(64, 4) SCAN_CASE(64, 8)
#undef SCAN_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: DTYPE_F32 or DTYPE_BF16 for x, dt, B, C, dy and dx, ddt, dB, dC;
// A, D, states, dA, dD and the four partial buffers are f32. states: the
// forward's chunk states with the same `steps`; npl and steps: the
// forward's launch plan (kernels/cuda.py:scan_plan). dB and dC are written
// contiguous (B, S, N). Two launches on `stream`, the scan and the sums of
// its partials; returns cudaGetLastError() after them.
int selective_scan_bwd(int dtype, const void* x, const void* dt, const void* A, const void* Bm,
                       const void* Cm, const void* Dv, const void* states, const void* dy,
                       void* dx, void* ddt, void* dB, void* dC, void* dA, void* dD, void* dBp,
                       void* dCp, void* dAp, void* dDp, int B, int S, int D, int N, int npl,
                       int steps, long long sb_b, long long sb_t, long long sc_b,
                       long long sc_t, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (steps != 32 && steps != 64) return (int)cudaErrorInvalidValue;
  const Args a{x,   dt,  A,  Bm, Cm, Dv,  states, dy,   dx,   ddt,  dB,   dC, dA,
               dD,  dBp, dCp, dAp, dDp, B, S,      D,    sb_b, sb_t, sc_b, sc_t};
  if (dtype == DTYPE_F32) return dispatch<float>(N, npl, steps, a, st);
  if (dtype == DTYPE_BF16) return dispatch<__nv_bfloat16>(N, npl, steps, a, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
