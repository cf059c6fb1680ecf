// Mamba-1 selective scan, optionally with the final state.
//
// Replaces the Pallas TPU kernel of the reference package:
//   src/repro/kernels/selective_scan.py:selective_scan (_scan_kernel)
// Same semantics: per batch row b and channel d, from a zero state,
//   h_t = exp(dt_t * A[d]) * h_{t-1} + (dt_t * x_t) * B_t      (N states, f32)
//   y_t = C_t . h_t + D[d] * x_t                                (x's dtype)
// Beyond the TPU kernel it writes h after the last step, (B, D, N) f32, when
// the caller passes a pointer — so the serving prefill, which needs the
// decode state (the reference reruns a sequential lax.scan for it,
// models/ssm.py:_scan_with_state), runs on this kernel as well. Padding past
// a row's length costs nothing extra: the caller zeroes dt there, so
// exp(0) = 1 and the state carries through unchanged.
//
// What bounds it on an H100: the exponentials. Every (b, t, d, n) needs one
// expf — B*S*D*N of them, 268 M at B=4, S=512, D=8192, N=16 — and the SFU
// issues 16 per SM per clock; against that the kernel moves only x, dt and
// y (plus h_last) once, and does ~3 f32 FMAs per exp. The math stays in
// accurate f32 expf (no --use_fast_math, no __expf) so f32 inputs agree
// with the plain version to ~1e-6; accurate expf costs a few extra FMAs per
// exp around the SFU's ex2.
//
// Layout: one block of 4 warps covers 32 consecutive channels of one batch
// row; lane l owns channel d0 + l and warp g owns states [g*N/4, (g+1)*N/4)
// of it, in registers. Splitting N over warps (rather than one thread per
// channel holding all N states) gives 4x the threads: at B=1, D=8192 that is
// 256 blocks, enough to cover the 132 SMs, where one thread per channel
// would leave half of them idle. Each warp reads 32 neighbouring d of x and
// dt per step (coalesced; the other three warps hit L1). The sequential
// grid axis of the TPU kernel becomes a loop over time inside the block:
// B_t and C_t, shared by every channel of the row, are staged through
// shared memory T steps at a time; each warp's partial C.h goes to shared
// memory, and at the end of the chunk the block sums the 4 partials, adds
// D*x and writes y as coalesced rows. Any S and any D: the last chunk and
// the last block mask their ragged edge.
//
// Inputs as the model hands them over: x, dt and y are contiguous
// (B, S, D); B and C may be strided views (column slices of the x_proj
// output), so their batch and time strides are arguments and only their
// last stride must be 1.

#include "attn_common.cuh"

using namespace repro_attn;

namespace {

constexpr int CH = 32;  // channels per block, one per lane
constexpr int NG = 4;   // warps per block; warp g owns N / NG states
constexpr int T = 32;   // time steps staged per chunk

template <typename Tp, int NPL>
__global__ void __launch_bounds__(NG * 32)
scan_kernel(const Tp* __restrict__ x,       // (B, S, D) contiguous
            const Tp* __restrict__ dt,      // (B, S, D) contiguous
            const float* __restrict__ A,    // (D, N)
            const Tp* __restrict__ Bm,      // (B, S, N), strides (sb_b, sb_t, 1)
            const Tp* __restrict__ Cm,      // (B, S, N), strides (sc_b, sc_t, 1)
            const float* __restrict__ Dv,   // (D,)
            Tp* __restrict__ y,             // (B, S, D)
            float* __restrict__ h_last,     // (B, D, N) or nullptr
            int S, int D, long long sb_b, long long sb_t, long long sc_b,
            long long sc_t) {
  constexpr int N = NPL * NG;
  __shared__ float s_b[T][N];
  __shared__ float s_c[T][N];
  __shared__ float s_y[NG][T][CH];  // each warp's partial C.h per step

  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int d = d0 + lane;
  const bool live = d < D;
  const int n0 = g * NPL;

  float a[NPL], h[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    a[i] = live ? A[(long long)d * N + n0 + i] : 0.f;
    h[i] = 0.f;
  }

  const long long row0 = (long long)b * S;  // row (b, t = 0) of x, dt, y
  for (int t0 = 0; t0 < S; t0 += T) {
    const int steps = min(T, S - t0);
    for (int i = threadIdx.x; i < T * N; i += NG * 32) {
      const int tt = i / N, n = i % N;
      float bv = 0.f, cv = 0.f;
      if (tt < steps) {
        bv = to_f32(Bm[b * sb_b + (t0 + tt) * sb_t + n]);
        cv = to_f32(Cm[b * sc_b + (t0 + tt) * sc_t + n]);
      }
      s_b[tt][n] = bv;
      s_c[tt][n] = cv;
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int tt = 0; tt < steps; ++tt) {
        const long long off = (row0 + t0 + tt) * D + d;
        const float dv = to_f32(dt[off]);
        const float dx = dv * to_f32(x[off]);
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < NPL; ++i) {
          const float da = expf(dv * a[i]);
          h[i] = da * h[i] + dx * s_b[tt][n0 + i];
          acc += h[i] * s_c[tt][n0 + i];
        }
        s_y[g][tt][lane] = acc;
      }
    }
    __syncthreads();
    // the next chunk's staging writes only s_b / s_c, which nobody reads
    // after the barrier above; its own barrier orders these s_y reads
    // before s_y is written again
    for (int i = threadIdx.x; i < steps * CH; i += NG * 32) {
      const int tt = i / CH, c = i % CH;
      const int dd = d0 + c;
      if (dd < D) {
        const long long off = (row0 + t0 + tt) * D + dd;
        float acc = 0.f;
#pragma unroll
        for (int gg = 0; gg < NG; ++gg) acc += s_y[gg][tt][c];
        y[off] = from_f32<Tp>(acc + Dv[dd] * to_f32(x[off]));
      }
    }
  }

  if (h_last != nullptr && live) {
    float* hp = h_last + ((long long)b * D + d) * N + n0;
#pragma unroll
    for (int i = 0; i < NPL; ++i) hp[i] = h[i];
  }
}

template <typename Tp, int NPL>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* Dv, void* y, void* h_last, int B, int S, int D, long long sb_b,
           long long sb_t, long long sc_b, long long sc_t, cudaStream_t stream) {
  dim3 grid((D + CH - 1) / CH, B);
  scan_kernel<Tp, NPL><<<grid, NG * 32, 0, stream>>>(
      static_cast<const Tp*>(x), static_cast<const Tp*>(dt), static_cast<const float*>(A),
      static_cast<const Tp*>(Bm), static_cast<const Tp*>(Cm), static_cast<const float*>(Dv),
      static_cast<Tp*>(y), static_cast<float*>(h_last), S, D, sb_b, sb_t, sc_b, sc_t);
  return (int)cudaGetLastError();
}

template <typename Tp>
int dispatch(int N, const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, const void* Dv, void* y, void* h_last, int B, int S, int D,
             long long sb_b, long long sb_t, long long sc_b, long long sc_t,
             cudaStream_t stream) {
#define SCAN_CASE(NN)                                                                  \
  case NN:                                                                             \
    return launch<Tp, NN / NG>(x, dt, A, Bm, Cm, Dv, y, h_last, B, S, D, sb_b, sb_t, \
                               sc_b, sc_t, stream);
  switch (N) {
    SCAN_CASE(4)
    SCAN_CASE(8)
    SCAN_CASE(16)
    SCAN_CASE(32)
    SCAN_CASE(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SCAN_CASE
}

}  // namespace

extern "C" {

// dtype: DTYPE_F32 or DTYPE_BF16 for x, dt, B, C and y; A and D are f32.
// h_last may be null. Returns cudaGetLastError() after the launch.
int selective_scan(int dtype, const void* x, const void* dt, const void* A, const void* Bm,
                   const void* Cm, const void* Dv, void* y, void* h_last, int B, int S,
                   int D, int N, long long sb_b, long long sb_t, long long sc_b,
                   long long sc_t, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return dispatch<float>(N, x, dt, A, Bm, Cm, Dv, y, h_last, B, S, D, sb_b, sb_t, sc_b,
                           sc_t, st);
  if (dtype == DTYPE_BF16)
    return dispatch<__nv_bfloat16>(N, x, dt, A, Bm, Cm, Dv, y, h_last, B, S, D, sb_b, sb_t,
                                   sc_b, sc_t, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
