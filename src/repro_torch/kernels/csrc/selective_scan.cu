// Mamba-1 selective scan, optionally with the final state or the chunk
// states the backward (selective_scan_bwd.cu) recomputes from.
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
// exp(0) = 1 and the state carries through unchanged. For training, the
// instantiation with SAVE also writes h after each of its T-step chunks,
// (B, ceil(S / T), D, N) f32 — the h_last write generalised, from the same
// registers; serving launches the one without, and y is the same in both.
// The step itself (scan_common.cuh: scan_decay, scan_update) is shared with
// the backward, so its recomputed states equal these bitwise.
//
// What bounds it on an H100: the exponentials. Every (b, t, d, n) needs one
// exp — B*S*D*N of them, 67 M at the engine's 1 x 512 prefill (D=8192,
// N=16) — and the SFU issues 16 per SM per clock; against that the kernel
// moves only x, dt and y (plus h_last) once, and does 4 f32 operations per
// exp. The design keeps everything else off that path:
//
// - Exponentials on the SFU alone: log2(e) is folded into A once, when A is
//   loaded into registers, and each step's decay is ex2.approx.ftz of
//   dt * a' — one FMUL and one MUFU.EX2. ex2.approx is within 2 ulp; f32
//   inputs still agree with the plain version to ~2e-7 of max |y|
//   (tolerance 1e-5), so both instantiations use it.
// - Nothing from global memory inside the dependent time loop. x and dt are
//   copied T steps at a time into shared memory with cp.async (16-byte
//   pieces when D * itemsize is a multiple of 16, else 4-byte, else single
//   elements for odd D in bf16), the next chunk's copy in flight during
//   this chunk's math. B and C (strided, unaligned column slices of the
//   x_proj output: scalar loads) are loaded into registers a chunk ahead.
//   Between the chunks' math the block regroups both: dt and x into records
//   of four steps of a channel (one 8-byte load per four steps in bf16),
//   and B, C into (B, C) pairs of each state in the inputs' own type, so a
//   thread reads its states' pairs of a step with one 8- or 16-byte load.
//   The time loop loads the next group of steps before the math of this
//   one, so those loads' latency hides behind it.
// - Threads per channel from the grid's size: one block covers 32 channels
//   (lane l owns channel d0 + l, so records are read conflict-free) and
//   N / NPL warps, warp g owning states [g*NPL, (g+1)*NPL) in registers.
//   The host (kernels/cuda.py:scan_plan) picks NPL, the states per thread,
//   and T, the steps per chunk, from the shapes: fewer states per thread
//   means more warps in flight but more shared loads, stores and epilogue
//   sums per exp. scripts/scan_plan_sweep.py measures the trade: at the
//   engine's 1 x 512, 4 states per thread (8 warps per SM) beat 2 (16).
//
// Each warp's partial C.h of four steps goes to shared memory as one
// 16-byte store; after the chunk the block sums the N / NPL partials in a
// fixed order, adds D*x and writes y a channel per lane (coalesced rows), so
// y does not depend on whether h_last is asked for. T (32 or 64) is a
// template parameter, so every staging index is a shift: with a runtime T
// the index divisions alone took more issue slots than the math, and took
// the SFU for their reciprocals. The last chunk runs its full T steps over
// zero-filled inputs (dt = 0 keeps the state, x = 0 adds nothing) and writes
// only the steps that exist; the last block masks channels past D.
//
// Inputs as the model hands them over: x, dt and y are contiguous
// (B, S, D); B and C may be strided views, so their batch and time strides
// are arguments and only their last stride must be 1.

#include "scan_common.cuh"

using namespace repro_attn;
using namespace repro_scan;

namespace {

enum { STAGE_16 = 0, STAGE_4 = 1, STAGE_ELEM = 2 };

// 4 bytes global -> shared; with src_bytes 0 the destination is zero-filled
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// bytes of dynamic shared memory for one block
__host__ __device__ constexpr size_t smem_bytes(int T, int N, int P, int itemsize) {
  return size_t(2) * T * CH * itemsize   // x, dt rows as copied
         + size_t(3) * T * CH * itemsize  // dt and x by records (x: two buffers)
         + size_t(T) * N * 2 * itemsize   // (B, C) pairs
         + size_t(P) * T * CH * 4;        // partial C.h per warp and step
}

// x and dt of the T steps from t0 into s_x and s_dt ([T][CH] each), in
// pieces of PB bytes (cp.async for 16 and 4, plain loads for single
// elements); pieces past S or D are zero-filled. Every index is a shift:
// T, PB and the block size are compile-time.
template <typename Tp, int T, int NT, int PB>
__device__ __forceinline__ void stage_xdt(const Tp* __restrict__ x, const Tp* __restrict__ dt,
                                          Tp* s_x, Tp* s_dt, long long row0, int t0, int S,
                                          int D, int d0, int tid) {
  constexpr int PER_ROW = CH * int(sizeof(Tp)) / PB;
  constexpr int PER_ARR = T * PER_ROW;
  constexpr int ITERS = (2 * PER_ARR + NT - 1) / NT;
#pragma unroll 8
  for (int k = 0; k < ITERS; ++k) {
    const int i = k * NT + tid;
    if ((2 * PER_ARR) % NT == 0 || i < 2 * PER_ARR) {
      const int arr = i / PER_ARR, r = i % PER_ARR;
      const int tt = r / PER_ROW, q = r % PER_ROW;
      const int dd = d0 + q * (PB / int(sizeof(Tp)));  // first channel of the piece
      const bool ok = t0 + tt < S && dd < D;
      const Tp* src = arr ? dt : x;
      const Tp* from = ok ? src + (row0 + t0 + tt) * D + dd : src;
      Tp* to = (arr ? s_dt : s_x) + tt * CH + q * (PB / int(sizeof(Tp)));
      if constexpr (PB == 16)
        cp_async16(to, from, ok ? 16 : 0);
      else if constexpr (PB == 4)
        cp_async4(to, from, ok ? 4 : 0);
      else
        *to = ok ? *from : from_f32<Tp>(0.f);
    }
  }
}

// The copied rows ([T][CH] each) into records of four steps of a channel:
// record (t4, c) of r_dt and of r_x holds steps 4 t4 .. 4 t4 + 3 of channel
// c, so the time loop reads four steps of dt and of x with one load each.
template <typename Tp, int T, int NT>
__device__ __forceinline__ void to_records(const Tp* s_x, const Tp* s_dt, Tp* r_dt, Tp* r_x,
                                           int tid) {
  if constexpr (sizeof(Tp) == 2) {
    // a channel pair a thread: one bf16 word per row and array, its lower
    // and upper halves regrouped by channel
    constexpr int ITEMS = T / 4 * CH / 2;
#pragma unroll
    for (int k = 0; k < (ITEMS + NT - 1) / NT; ++k) {
      const int i = k * NT + tid;
      if (ITEMS % NT == 0 || i < ITEMS) {
        const int t4 = i / (CH / 2), c = (i % (CH / 2)) * 2;
#pragma unroll
        for (int arr = 0; arr < 2; ++arr) {
          const Tp* src = (arr ? s_x : s_dt) + 4 * t4 * CH + c;
          uint32_t w[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) w[j] = *reinterpret_cast<const uint32_t*>(src + j * CH);
          uint4* out = reinterpret_cast<uint4*>((arr ? r_x : r_dt) + (t4 * CH + c) * 4);
          *out = make_uint4(__byte_perm(w[0], w[1], 0x5410), __byte_perm(w[2], w[3], 0x5410),
                            __byte_perm(w[0], w[1], 0x7632), __byte_perm(w[2], w[3], 0x7632));
        }
      }
    }
  } else {
    constexpr int ITEMS = T / 4 * CH;
#pragma unroll
    for (int k = 0; k < (ITEMS + NT - 1) / NT; ++k) {
      const int i = k * NT + tid;
      if (ITEMS % NT == 0 || i < ITEMS) {
        const int t4 = i / CH, c = i % CH;
#pragma unroll
        for (int arr = 0; arr < 2; ++arr) {
          const Tp* src = (arr ? s_x : s_dt) + 4 * t4 * CH + c;
          *reinterpret_cast<float4*>((arr ? r_x : r_dt) + (t4 * CH + c) * 4) =
              make_float4(src[0], src[CH], src[2 * CH], src[3 * CH]);
        }
      }
    }
  }
}

template <typename Tp, int N, int NPL, int T, bool SAVE>
__global__ void __launch_bounds__(CH * N / NPL)
scan_kernel(const Tp* __restrict__ x,       // (B, S, D) contiguous
            const Tp* __restrict__ dt,      // (B, S, D) contiguous
            const float* __restrict__ A,    // (D, N)
            const Tp* __restrict__ Bm,      // (B, S, N), strides (sb_b, sb_t, 1)
            const Tp* __restrict__ Cm,      // (B, S, N), strides (sc_b, sc_t, 1)
            const float* __restrict__ Dv,   // (D,)
            Tp* __restrict__ y,             // (B, S, D)
            float* __restrict__ h_last,     // (B, D, N) or nullptr
            float* __restrict__ states,     // (B, ceil(S / T), D, N) with SAVE
            int S, int D, int mode, long long sb_b, long long sb_t, long long sc_b,
            long long sc_t) {
  constexpr int P = N / NPL;          // warps per block
  constexpr int NT = CH * P;          // threads per block
  constexpr int T4 = T / 4;           // records per channel and chunk
  constexpr int BCW = T * N / NT;     // (B, C) pairs a thread stages per chunk
  // time steps whose shared loads are issued together
  constexpr int U = NPL <= 2 ? 8 : 4;
  extern __shared__ __align__(16) unsigned char smem[];
  Tp* s_x = reinterpret_cast<Tp*>(smem);  // [T][CH]
  Tp* s_dt = s_x + T * CH;                 // [T][CH]
  Tp* r_dt = s_dt + T * CH;                // [T4][CH][4]
  Tp* r_x = r_dt + T * CH;                 // [2][T4][CH][4]
  Tp* s_bc = r_x + 2 * T * CH;             // [T][P][NPL][2]: (B, C) of each state
  float* s_y = reinterpret_cast<float*>(s_bc + T * N * 2);  // [P][T4][CH][4]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = tid >> 5;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int d = d0 + lane;
  const bool live = d < D;
  const int nch = (S + T - 1) / T;
  const long long row0 = (long long)b * S;  // row (b, t = 0) of x, dt, y

  auto stage = [&](int c) {
    if (mode == STAGE_16)
      stage_xdt<Tp, T, NT, 16>(x, dt, s_x, s_dt, row0, c * T, S, D, d0, tid);
    else if (mode == STAGE_4)
      stage_xdt<Tp, T, NT, 4>(x, dt, s_x, s_dt, row0, c * T, S, D, d0, tid);
    else
      stage_xdt<Tp, T, NT, int(sizeof(Tp))>(x, dt, s_x, s_dt, row0, c * T, S, D, d0, tid);
  };
  // B and C of chunk c into registers (zero past S). Thread tid stages
  // column tid % N of rows tid / N + j * RS of the chunk, j < BCW, of both:
  // a pointer and a constant row stride each, no index math
  constexpr int RS = NT / N;
  const int bn = tid % N, bt = tid / N;
  const long long rs_b = RS * sb_t, rs_c = RS * sc_t;
  Tp pre[2 * BCW];
  auto load_bc = [&](int c) {
    const int t0 = c * T + bt;
    const Tp* pb = Bm + b * sb_b + t0 * sb_t + bn;
    const Tp* pc = Cm + b * sc_b + t0 * sc_t + bn;
#pragma unroll
    for (int j = 0; j < BCW; ++j) {
      const bool ok = t0 + j * RS < S;
      pre[2 * j] = ok ? pb[j * rs_b] : from_f32<Tp>(0.f);
      pre[2 * j + 1] = ok ? pc[j * rs_c] : from_f32<Tp>(0.f);
    }
  };
  // as stored: state n of step t at ((t * P + n / NPL) * NPL + n % NPL) * 2,
  // which is (t * N + n) * 2
  auto store_bc = [&]() {
    Tp* q = s_bc + (bt * N + bn) * 2;
#pragma unroll
    for (int j = 0; j < BCW; ++j) {
      if constexpr (sizeof(Tp) == 2) {
        __nv_bfloat162 v;
        v.x = pre[2 * j];
        v.y = pre[2 * j + 1];
        *reinterpret_cast<__nv_bfloat162*>(q + j * RS * N * 2) = v;
      } else {
        *reinterpret_cast<float2*>(q + j * RS * N * 2) = make_float2(pre[2 * j], pre[2 * j + 1]);
      }
    }
  };

  float a[NPL], h[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    a[i] = live ? A[(long long)d * N + g * NPL + i] * LOG2E : 0.f;
    h[i] = 0.f;
  }
  const float dk = live ? Dv[d] : 0.f;
  const long long Dl = D;

  if (nch > 0) {
    stage(0);
    cp_async_commit();
    load_bc(0);
    cp_async_wait<0>();
    __syncthreads();
    to_records<Tp, T, NT>(s_x, s_dt, r_dt, r_x, tid);
    store_bc();
  }
  for (int c = 0; c < nch; ++c) {
    const int cur = c & 1;
    const bool next = c + 1 < nch;
    // chunk c's records and B|C are in; everyone is done with chunk c-1's
    // epilogue and with the copied rows
    __syncthreads();
    if (next) {  // chunk c+1 lands during this chunk's math
      stage(c + 1);
      cp_async_commit();
      load_bc(c + 1);
    }

    const Tp* pdt = r_dt + lane * 4;
    const Tp* px = r_x + (cur * T4 * CH + lane) * 4;
    const Tp* pbc = s_bc + g * NPL * 2;
    float* py = s_y + (g * T4 * CH + lane) * 4;
    // the raw words of a group of U steps: dt and x by records, and the
    // thread's (B, C) pairs of each step. The next group's are loaded
    // before this group's math, so the loads' latency hides behind it
    constexpr int RW = int(sizeof(Tp));          // words per record of 4
    constexpr int BW = NPL * 2 * int(sizeof(Tp)) / 4;  // words of (B, C) a step
    struct Group {
      uint32_t dt[U / 4][RW], x[U / 4][RW], bc[U][BW];
    };
    auto load_group = [&](int t0u, Group& G) {
#pragma unroll
      for (int r = 0; r < U / 4; ++r) {
        load_words(pdt + (t0u / 4 + r) * CH * 4, G.dt[r]);
        load_words(px + (t0u / 4 + r) * CH * 4, G.x[r]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) load_words(pbc + (t0u + u) * N * 2, G.bc[u]);
    };
    Group cur_g;
    load_group(0, cur_g);
#pragma unroll 2
    for (int t0u = 0; t0u < T; t0u += U) {
      Group nxt;
      load_group((t0u + U) % T, nxt);  // the last group's is not used
#pragma unroll
      for (int r = 0; r < U / 4; ++r) {
        float acc[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int u = 4 * r + j;
          const float dv = word_elem<Tp>(cur_g.dt[r], j);
          const float dx = dv * word_elem<Tp>(cur_g.x[r], j);
          acc[j] = 0.f;
#pragma unroll
          for (int i = 0; i < NPL; ++i) {
            h[i] = scan_update(scan_decay(dv, a[i]), h[i], dx, word_elem<Tp>(cur_g.bc[u], 2 * i));
            acc[j] = fmaf(h[i], word_elem<Tp>(cur_g.bc[u], 2 * i + 1), acc[j]);
          }
        }
        *reinterpret_cast<float4*>(py + (t0u / 4 + r) * CH * 4) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
      }
      cur_g = nxt;
    }
    if constexpr (SAVE) {  // h after chunk c, for the backward's recompute
      if (live) {
        float* sp = states + (((long long)b * nch + c) * D + d) * N + g * NPL;
#pragma unroll
        for (int i = 0; i < NPL; ++i) sp[i] = h[i];
      }
    }
    cp_async_wait<0>();  // this thread's copies of chunk c+1 have landed
    __syncthreads();     // every partial of chunk c, every copy of chunk c+1

    // y = the warps' partials in a fixed order + D * x: a thread sums the
    // four steps of record (t4, lane) for t4 = g, g + P, ...
    const int t0 = c * T;
    // a warp's records are independent: unrolled, their loads overlap
#pragma unroll
    for (int k = 0; k < (T4 + P - 1) / P; ++k) {
      const int t4 = g + k * P;
      const int tb = t0 + 4 * t4;
      if (t4 >= T4 || tb >= S) continue;
      float4 acc = *reinterpret_cast<const float4*>(s_y + (t4 * CH + lane) * 4);
#pragma unroll
      for (int gg = 1; gg < P; ++gg) {
        const float4 v =
            *reinterpret_cast<const float4*>(s_y + ((gg * T4 + t4) * CH + lane) * 4);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      float xs[4];
      load_f32<Tp, 4>(r_x + ((cur * T4 + t4) * CH + lane) * 4, xs);
      const Tp o[4] = {from_f32<Tp>(fmaf(dk, xs[0], acc.x)), from_f32<Tp>(fmaf(dk, xs[1], acc.y)),
                       from_f32<Tp>(fmaf(dk, xs[2], acc.z)), from_f32<Tp>(fmaf(dk, xs[3], acc.w))};
      if (live) {
        Tp* yp = y + (row0 + tb) * Dl + d;
        if (tb + 3 < S) {
          yp[0] = o[0];
          yp[Dl] = o[1];
          yp[2 * Dl] = o[2];
          yp[3 * Dl] = o[3];
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (tb + j < S) yp[j * Dl] = o[j];
        }
      }
    }
    if (next) {
      // chunk c+1's records and B|C, whose buffers chunk c's math (done:
      // second barrier) was the last to read, and x by records into the
      // buffer the epilogue is not reading; the next iteration's first
      // barrier orders these writes before their readers
      to_records<Tp, T, NT>(s_x, s_dt, r_dt, r_x + (cur ^ 1) * T * CH, tid);
      store_bc();
    }
  }

  if (h_last != nullptr && live) {
    float* hp = h_last + ((long long)b * D + d) * N + g * NPL;
#pragma unroll
    for (int i = 0; i < NPL; ++i) hp[i] = h[i];
  }
}

template <typename Tp, int N, int NPL, int T, bool SAVE>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* Dv, void* y, void* h_last, void* states, int B, int S, int D,
           long long sb_b, long long sb_t, long long sc_b, long long sc_t,
           cudaStream_t stream) {
  constexpr int P = N / NPL;
  constexpr int is = int(sizeof(Tp));
  const uintptr_t xdt = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dt);
  const int mode = (xdt % 16 == 0 && (long long)D * is % 16 == 0)  ? STAGE_16
                   : (xdt % 4 == 0 && (long long)D * is % 4 == 0) ? STAGE_4
                                                                    : STAGE_ELEM;
  constexpr size_t smem = smem_bytes(T, N, P, is);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        scan_kernel<Tp, N, NPL, T, SAVE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((D + CH - 1) / CH, B);
  scan_kernel<Tp, N, NPL, T, SAVE><<<grid, CH * P, smem, stream>>>(
      static_cast<const Tp*>(x), static_cast<const Tp*>(dt), static_cast<const float*>(A),
      static_cast<const Tp*>(Bm), static_cast<const Tp*>(Cm), static_cast<const float*>(Dv),
      static_cast<Tp*>(y), static_cast<float*>(h_last), static_cast<float*>(states), S, D,
      mode, sb_b, sb_t, sc_b, sc_t);
  return (int)cudaGetLastError();
}

template <typename Tp, int N, int NPL, int T>
int launch_save(bool save, const void* x, const void* dt, const void* A, const void* Bm,
                const void* Cm, const void* Dv, void* y, void* h_last, void* states, int B,
                int S, int D, long long sb_b, long long sb_t, long long sc_b, long long sc_t,
                cudaStream_t stream) {
  return save ? launch<Tp, N, NPL, T, true>(x, dt, A, Bm, Cm, Dv, y, h_last, states, B, S,
                                            D, sb_b, sb_t, sc_b, sc_t, stream)
              : launch<Tp, N, NPL, T, false>(x, dt, A, Bm, Cm, Dv, y, h_last, states, B, S,
                                             D, sb_b, sb_t, sc_b, sc_t, stream);
}

// (N, states per thread) pairs with 1 to 16 warps per block, each with 32
// or 64 steps per chunk, with and without the chunk states; kernels/cuda.py
// SCAN_STATES, SCAN_NPL and SCAN_STEPS name the same sets
template <typename Tp>
int dispatch(int N, int npl, int T, const void* x, const void* dt, const void* A,
             const void* Bm, const void* Cm, const void* Dv, void* y, void* h_last,
             void* states, int B, int S, int D, long long sb_b, long long sb_t, long long sc_b,
             long long sc_t, cudaStream_t stream) {
  const bool save = states != nullptr;
#define SCAN_CASE(NN, PP)                                                                   \
  if (N == NN && npl == PP)                                                                 \
    return T == 64 ? launch_save<Tp, NN, PP, 64>(save, x, dt, A, Bm, Cm, Dv, y, h_last,    \
                                                 states, B, S, D, sb_b, sb_t, sc_b, sc_t,  \
                                                 stream)                                   \
                   : launch_save<Tp, NN, PP, 32>(save, x, dt, A, Bm, Cm, Dv, y, h_last,    \
                                                 states, B, S, D, sb_b, sb_t, sc_b, sc_t,  \
                                                 stream);
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

// dtype: DTYPE_F32 or DTYPE_BF16 for x, dt, B, C and y; A and D are f32.
// h_last and states may be null; states, when given, is (B, ceil(S /
// steps), D, N) f32 and receives h after each chunk (the instantiation
// with SAVE, for training; serving launches the one without). npl: states
// per thread; steps: time steps staged per chunk, 32 or 64 (both from
// kernels/cuda.py:scan_plan). Returns cudaGetLastError() after the launch.
int selective_scan(int dtype, const void* x, const void* dt, const void* A, const void* Bm,
                   const void* Cm, const void* Dv, void* y, void* h_last, void* states, int B,
                   int S, int D, int N, int npl, int steps, long long sb_b, long long sb_t,
                   long long sc_b, long long sc_t, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (steps != 32 && steps != 64) return (int)cudaErrorInvalidValue;
  if (dtype == DTYPE_F32)
    return dispatch<float>(N, npl, steps, x, dt, A, Bm, Cm, Dv, y, h_last, states, B, S, D,
                           sb_b, sb_t, sc_b, sc_t, st);
  if (dtype == DTYPE_BF16)
    return dispatch<__nv_bfloat16>(N, npl, steps, x, dt, A, Bm, Cm, Dv, y, h_last, states, B,
                                   S, D, sb_b, sb_t, sc_b, sc_t, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
