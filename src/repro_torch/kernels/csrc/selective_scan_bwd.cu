// Backward of the selective scan (selective_scan.cu): from dy and the
// forward's inputs and chunk states, the gradients of x, dt, A, B, C and D.
//
// The TPU side has no kernel to replace here: the reference trains through
// XLA's autodiff of src/repro/kernels/ref.py:selective_scan_ref (and
// ssd_ref, which the port maps onto this scan: kernels/ops.py), and its
// Pallas scan has no custom_vjp. On the card the plain version
// (kernels/ref.py:selective_scan_bwd_ref) stays off the training path; this
// kernel takes its place behind kernels/ops.py:SelectiveScan.
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
// Two bodies behind one entry point, chosen by the form of A:
// - Mamba-1 (A per (d, n), (D, N)): the decay is one value per (b, t, d,
//   n), as in the forward.
// - Mamba-2 (A per channel, (D,): each head's scalar A over its channels,
//   kernels/ops.py:ssd_channel_args). The decay is one value per (b, t, d):
//   computed once per chunk, step and channel into shared memory and read
//   there by the sweep, the replay and the epilogue. It is bitwise the
//   forward's per-(d, n) decay, since the forward reads the same A
//   materialised as (D, N) and takes the same ex2.approx of the same
//   product (scan_common.cuh:scan_decay). A folds out of the sums over n:
//   a warp sums r = sum_n g_t h_{t-1} over its states, and the epilogue
//   takes ddt_t = A a_t r + x_t s1 and dA += dt_t a_t r, one dA per
//   channel, (D,) f32.
//
// The block: 32 channels, one per lane, and N / NPL warps, warp g owning
// states [g NPL, (g + 1) NPL). The backward takes its own states per thread
// (Plan below: 4 for Mamba-1, whose replay holds a decay per state, 8 for
// Mamba-2) but the forward's T, since it reads the forward's chunk states.
// It walks the forward's T-step chunks in reverse; for each it starts from
// the state the forward wrote after the chunk before (zero for the first),
// recomputes h with the forward's own step (scan_common.cuh), so the states
// are the forward's bitwise, and stores h at the start of each U = 8 step
// sub-chunk in shared memory (each thread reads back only its own). The
// sub-chunks then run in reverse: each replays its U steps of h (and, for
// Mamba-1, of the decay) into registers and walks them backwards.
//
// Staging: x, dt, dy and the B and C rows of a chunk go to shared memory
// by cp.async in 16-byte pieces where the pointers and strides allow
// (single elements otherwise), into one buffer. The copy is issued at the
// chunk's start, behind the cluster's sums of the chunk before, and the
// other resident blocks cover the wait. A second buffer, filled with
// chunk c - 1 during chunk c's work, was tried while this kernel was
// designed and was never faster: at falcon-mamba's and zamba2's f32 shapes
// it cost a resident block (and was slower by more than it overlapped);
// at falcon-mamba's bf16 shape, where it fit, it was no faster than one.
//
// The sums, all in a fixed order and without atomics, so two launches give
// bitwise-equal gradients:
// - over n (dx, ddt): each warp's partials over its states go to shared
//   memory, two buffers by sub-chunk parity, so one block barrier per
//   sub-chunk serves (the next sub-chunk writes the other buffer); the
//   warps then add the partials in warp order, warp g taking steps g,
//   g + P, ... of the sub-chunk (U >= P on the main path: no warp idles);
// - over d (dB, dC): per step, a warp's 2 NPL values are summed over its
//   32 lanes by a transposing butterfly (about one shuffle per value) into
//   the block's [T][2][N] f32 sums of the chunk in shared memory; the
//   blocks of a thread-block cluster (up to 8 channel blocks of one batch
//   row) then add their sums through distributed shared memory, block r
//   of the cluster taking the r-th slice in rank order, and write one f32
//   (B, S, ceil(D / 32) / cluster, N) partial each for dB and dC;
// - over b and t (dA, dD): registers through the block's walk over t (the
//   epilogue's, summed over warps in order at the end), then an f32
//   partial per batch row;
// and a second, small kernel (scan_bwd_finish) adds the partials in order
// over clusters and batch rows and writes dB, dC, dA and dD.
//
// Per chunk: two cluster barriers (one before the sums over the cluster,
// one after them) and one block barrier per sub-chunk.
//
// What bounds it on an H100, and what this design changed against the
// backward's first kernel ("before"), per (b, t, d, n) at the main path's
// plans:
// - Mamba-2 (zamba2-2.7b: N 64, T 32, f32): the f32 work, about 10 FP32
//   instructions per element, and the issue slots around them; the
//   exponentials, 2 per element before, are 1 per (b, t, d) now (1/64 per
//   element). Barriers: 2 per 4 steps before, 1 per 8
//   steps plus 2 per chunk now. Resident warps: 8 before (one block of 8
//   warps by ~100 KB of shared memory and 185 registers); now a single
//   staging buffer keeps a block at 112 KB and __launch_bounds__ caps the
//   registers at 128, so two blocks (16 warps) fit.
// - Mamba-1 (falcon-mamba-7b: N 16, T 32, f32): the f32 work, about 17
//   FP32 instructions per element, and the exponentials, two per element
//   (the sweep's and the replay's). One pass of them is 0.13 ms at the
//   SFU's rate, an eighth of the kernel's 1.07 ms: the SFU does not bind,
//   so the second pass stays. 4 states per thread in
//   place of the forward's 8 give 4-warp blocks of 44 KB, 4 of them (16
//   warps) an SM (8-10 warps before).
// - Both: the dB / dC butterfly (about one shuffle, one add and two
//   selects per value, two values per element) is what the lanes-as-
//   channels layout costs: a build without it ran 0.52 ms faster at
//   zamba2's shape and 0.26 ms at falcon-mamba's, f32
//   (scripts/scan_bwd_sweep.py).
// - The dB / dC partials: 16.8 MB at falcon-mamba's 8 x 512 (134 MB
//   before) and 41.9 MB at zamba2's (335 MB), each written once and read
//   once by scan_bwd_finish.
// The bytes (x, dt and dy in, dx and ddt out) come after both.
//
// Inputs as the forward takes them: x, dt and dy contiguous (B, S, D); B
// and C strided with a unit last stride (their gradients are written
// contiguous); any D (the last block masks channels past it) and any S
// (the last chunk runs over zero-filled steps: dt = 0 keeps the state,
// dy = 0 adds no adjoint).

#include <cooperative_groups.h>

#include "scan_common.cuh"

using namespace repro_attn;
using namespace repro_scan;
namespace cg = cooperative_groups;

namespace {

enum { STAGE_16 = 0, STAGE_ELEM = 1 };

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

// The backward's own launch plan for N states and a body (PC: A per
// channel, Mamba-2): states per thread (Mamba-1 replays a decay per state
// beside each state, so it takes half as many), warps and threads per
// block, and U, the steps of a sub-chunk replayed into registers (at most
// 64 replayed values a thread).
template <int N, bool PC>
struct Plan {
  static constexpr int NPL = PC ? cmin(N, 8) : cmin(N, 4);
  static constexpr int P = N / NPL;
  static constexpr int NT = CH * P;
  static constexpr int U = 8;
};

// the block's cap of 128 registers a thread: 65536 / (128 NT) blocks
template <int N, bool PC>
__host__ __device__ constexpr int min_blocks() {
  return 512 / Plan<N, PC>::NT > 0 ? 512 / Plan<N, PC>::NT : 1;
}

// bytes of dynamic shared memory for one block
template <typename Tp, int N, int T, bool PC>
__host__ __device__ constexpr size_t smem_bytes() {
  using PL = Plan<N, PC>;
  return size_t(T / PL::U) * N * CH * 4                        // h at each sub-chunk's start
         + size_t(2) * 2 * PL::P * PL::U * CH * 4              // each warp's n-sums, two buffers
         + size_t(T) * 2 * N * 4                               // the block's dB, dC sums of a chunk
         + (PC ? size_t(T) * CH * 4 + CH * 4 : 0)              // decays of a chunk, A log2(e)
         + size_t(3 * T * CH + 2 * T * N) * sizeof(Tp);        // x, dt, dy and B, C rows
}

// Rows [t0, t0 + T) of a row-strided array, W elements each from `src`
// (row t at src + t * rs), into dst[T][W], in pieces of PB bytes (cp.async
// for 16, plain loads for single elements); pieces past S or past
// `cols` columns are zero-filled. A thread takes pieces tid, tid + NT, ...
template <typename Tp, int T, int W, int NT, int PB>
__device__ __forceinline__ void stage_rows(Tp* dst, const Tp* __restrict__ src, long long rs,
                                           int t0, int S, int cols, int tid) {
  constexpr int E = PB / int(sizeof(Tp));  // elements a piece
  constexpr int PER_ROW = W / E;
  constexpr int ITEMS = T * PER_ROW;
  // PER_ROW is 0 only in instantiations whose mode the host never picks
  // (16-byte pieces of rows narrower than 16 bytes)
  if constexpr (PER_ROW > 0) {
#pragma unroll 4
    for (int i = tid; i < ITEMS; i += NT) {
      const int t = i / PER_ROW, q = (i % PER_ROW) * E;
      const bool ok = t0 + t < S && q < cols;
      const Tp* from = ok ? src + (long long)(t0 + t) * rs + q : src;
      Tp* to = dst + t * W + q;
      if constexpr (PB == 16)
        cp_async16(to, from, ok ? 16 : 0);
      else
        *to = ok ? *from : from_f32<Tp>(0.f);
    }
  }
}

// Mamba-2's decays of a chunk, [T][CH], from its staged dt rows: a thread
// takes the dt pieces it copied itself (stage_rows' order), so it needs
// only its own copies to have landed
template <typename Tp, int T, int NT, int PB>
__device__ __forceinline__ void own_decays(const Tp* r_dt, const float* s_a2, float* s_a,
                                           int tid) {
  constexpr int E = PB / int(sizeof(Tp));
  constexpr int PER_ROW = CH / E;
  constexpr int ITEMS = T * PER_ROW;
#pragma unroll 4
  for (int i = tid; i < ITEMS; i += NT) {
    const int t = i / PER_ROW, q = (i % PER_ROW) * E;
#pragma unroll
    for (int e = 0; e < E; ++e)
      s_a[t * CH + q + e] = scan_decay(to_f32(r_dt[t * CH + q + e]), s_a2[q + e]);
  }
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

template <typename Tp, int N, int T, bool PC>
__global__ void __launch_bounds__(Plan<N, PC>::NT, min_blocks<N, PC>())
scan_bwd_kernel(const Tp* __restrict__ x,          // (B, S, D) contiguous
                const Tp* __restrict__ dt,         // (B, S, D) contiguous
                const float* __restrict__ A,       // (D, N), or (D,) with PC
                const Tp* __restrict__ Bm,         // (B, S, N), strides (sb_b, sb_t, 1)
                const Tp* __restrict__ Cm,         // (B, S, N), strides (sc_b, sc_t, 1)
                const float* __restrict__ Dv,      // (D,)
                const float* __restrict__ states,  // (B, ceil(S / T), D, N): h after each chunk
                const Tp* __restrict__ dy,         // (B, S, D) contiguous
                Tp* __restrict__ dx,               // (B, S, D)
                Tp* __restrict__ ddt,              // (B, S, D)
                float* __restrict__ dBp,           // (B, S, ncl, N) partials
                float* __restrict__ dCp,           // (B, S, ncl, N) partials
                float* __restrict__ dAp,           // (B, D, N) partials, (B, D) with PC
                float* __restrict__ dDp,           // (B, D) partials
                int S, int D, int cl, int xmode, int bcmode, long long sb_b, long long sb_t,
                long long sc_b, long long sc_t) {
  using PL = Plan<N, PC>;
  constexpr int NPL = PL::NPL;
  constexpr int P = PL::P;                       // warps per block
  constexpr int NT = PL::NT;                     // threads per block
  constexpr int U = PL::U;                       // steps per sub-chunk
  constexpr int K = T / U;                       // sub-chunks per chunk
  constexpr int BW = NPL * int(sizeof(Tp)) / 4;  // words of a thread's B (or C) of a step
  constexpr int SPREAD = 32 / (2 * NPL);         // lanes holding one dB / dC sum
  constexpr int SUMS = T * 2 * N;                // the block's dB, dC sums of a chunk
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_h = reinterpret_cast<float*>(smem);                  // [K][N][CH]
  float* s_p = s_h + K * N * CH;                                 // [2][2][P][U][CH]
  float* s_dbc = s_p + 2 * 2 * P * U * CH;                       // [T][2][N]
  float* s_a = s_dbc + SUMS;                                     // [T][CH] (PC)
  float* s_a2 = s_a + (PC ? T * CH : 0);                         // [CH] (PC)
  Tp* s_rows = reinterpret_cast<Tp*>(s_a2 + (PC ? CH : 0));      // x, dt, dy, B, C rows

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = tid >> 5;
  const int b = blockIdx.y;
  const int cb = blockIdx.x;
  const int crank = (int)cluster.block_rank();
  const int ncl = gridDim.x / cl;  // clusters per batch row
  const int ci = cb / cl;          // this block's cluster
  const int d0 = cb * CH;
  const int d = d0 + lane;
  const bool live = d < D;
  const int nch = (S + T - 1) / T;
  const long long row0 = (long long)b * S;  // row (b, t = 0) of x, dt, dy
  const long long Dl = D;

  // Mamba-1: A as the forward loads it (a2 = A log2(e)), A itself for ddt,
  // dA's sums per state. Mamba-2: A of the lane's channel, and A log2(e)
  // of the block's channels for the decays. Both: the adjoint carried to
  // the step before (a_{t+1} g_{t+1})
  float a2[NPL], av[NPL], dA[NPL], carry[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    if constexpr (!PC) {
      av[i] = live ? A[(long long)d * N + g * NPL + i] : 0.f;
      a2[i] = av[i] * LOG2E;
      dA[i] = 0.f;
    }
    carry[i] = 0.f;
  }
  const float ac = (PC && live) ? A[d] : 0.f;
  if constexpr (PC) {
    if (tid < CH) s_a2[tid] = d0 + tid < D ? A[d0 + tid] * LOG2E : 0.f;
  }
  const float dk = live ? Dv[d] : 0.f;
  float eA = 0.f, eD = 0.f;  // the epilogue's dA (Mamba-2) and dD sums

  auto stage = [&](int c) {
    Tp* r = s_rows;
    const int t0 = c * T;
    const Tp* xs = x + row0 * Dl + d0;
    const Tp* ts = dt + row0 * Dl + d0;
    const Tp* ys = dy + row0 * Dl + d0;
    const Tp* bs = Bm + b * sb_b;
    const Tp* cs = Cm + b * sc_b;
    if (xmode == STAGE_16) {
      stage_rows<Tp, T, CH, NT, 16>(r, xs, Dl, t0, S, D - d0, tid);
      stage_rows<Tp, T, CH, NT, 16>(r + T * CH, ts, Dl, t0, S, D - d0, tid);
      stage_rows<Tp, T, CH, NT, 16>(r + 2 * T * CH, ys, Dl, t0, S, D - d0, tid);
    } else {
      constexpr int PE = int(sizeof(Tp));
      stage_rows<Tp, T, CH, NT, PE>(r, xs, Dl, t0, S, D - d0, tid);
      stage_rows<Tp, T, CH, NT, PE>(r + T * CH, ts, Dl, t0, S, D - d0, tid);
      stage_rows<Tp, T, CH, NT, PE>(r + 2 * T * CH, ys, Dl, t0, S, D - d0, tid);
    }
    Tp* rb = r + 3 * T * CH;
    if (bcmode == STAGE_16) {
      stage_rows<Tp, T, N, NT, 16>(rb, bs, sb_t, t0, S, N, tid);
      stage_rows<Tp, T, N, NT, 16>(rb + T * N, cs, sc_t, t0, S, N, tid);
    } else {
      constexpr int PE = int(sizeof(Tp));
      stage_rows<Tp, T, N, NT, PE>(rb, bs, sb_t, t0, S, N, tid);
      stage_rows<Tp, T, N, NT, PE>(rb + T * N, cs, sc_t, t0, S, N, tid);
    }
  };

  auto decays = [&]() {
    const Tp* r_dt = s_rows + T * CH;
    if (xmode == STAGE_16)
      own_decays<Tp, T, NT, 16>(r_dt, s_a2, s_a, tid);
    else
      own_decays<Tp, T, NT, int(sizeof(Tp))>(r_dt, s_a2, s_a, tid);
  };

  // chunk cc's dB and dC: block r of the cluster adds slice r of every
  // block's sums in rank order and writes them to the cluster's partial
  auto reduce = [&](int cc) {
    const int per = SUMS / cl;
    const int lo = crank * per;
    for (int i = lo + tid; i < lo + per; i += NT) {
      const int t = i / (2 * N);
      const int tg = cc * T + t;
      if (tg >= S) continue;
      float s = 0.f;
      for (int q = 0; q < cl; ++q) s += cluster.map_shared_rank(s_dbc, q)[i];
      float* part = (i / N) & 1 ? dCp : dBp;
      part[((row0 + tg) * ncl + ci) * N + i % N] = s;
    }
  };

  for (int c = nch - 1; c >= 0; --c) {
    const int t0 = c * T;
    // chunk c + 1 is done cluster-wide: its walks wrote the dB / dC sums,
    // its epilogues are done with the staging buffer and the decays
    cluster.sync();
    stage(c);
    cp_async_commit();
    if (c + 1 < nch) reduce(c + 1);
    // the state the chunk starts from: the forward's after chunk c - 1
    float h[NPL];
#pragma unroll
    for (int i = 0; i < NPL; ++i)
      h[i] = (c > 0 && live)
                 ? states[(((long long)b * nch + c - 1) * D + d) * N + g * NPL + i]
                 : 0.f;
    cp_async_wait<0>();  // chunk c's copies (this thread's) have landed
    if constexpr (PC) decays();
    // chunk c's rows and decays are visible block-wide, and every block of
    // the cluster has read this block's sums of chunk c + 1
    cluster.sync();

    const Tp* r_x = s_rows;               // [T][CH]
    const Tp* r_dt = r_x + T * CH;        // [T][CH]
    const Tp* r_dy = r_dt + T * CH;       // [T][CH]
    const Tp* r_B = r_dy + T * CH;        // [T][N]
    const Tp* r_C = r_B + T * N;          // [T][N]

    // the forward's states at each sub-chunk's start (the last sub-chunk's
    // steps are only replayed: nothing needs the chunk's end state)
    for (int k = 0;; ++k) {
#pragma unroll
      for (int i = 0; i < NPL; ++i) s_h[(k * N + g * NPL + i) * CH + lane] = h[i];
      if (k == K - 1) break;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = k * U + u;
        const float dv = to_f32(r_dt[t * CH + lane]);
        const float uu = dv * to_f32(r_x[t * CH + lane]);
        uint32_t wb[BW];
        load_words(r_B + t * N + g * NPL, wb);
        if constexpr (PC) {
          const float a = s_a[t * CH + lane];
#pragma unroll
          for (int i = 0; i < NPL; ++i) h[i] = scan_update(a, h[i], uu, word_elem<Tp>(wb, i));
        } else {
#pragma unroll
          for (int i = 0; i < NPL; ++i)
            h[i] = scan_update(scan_decay(dv, a2[i]), h[i], uu, word_elem<Tp>(wb, i));
        }
      }
    }

    for (int k = K - 1; k >= 0; --k) {
      float* sp = s_p + (k & 1) * 2 * P * U * CH;  // [2][P][U][CH]: s1, then s2
      // replay the sub-chunk's states (and Mamba-1's decays) into registers
      float hh[U][NPL], aa[U][PC ? 1 : NPL];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = k * U + u;
        const float dv = to_f32(r_dt[t * CH + lane]);
        const float uu = dv * to_f32(r_x[t * CH + lane]);
        uint32_t wb[BW];
        load_words(r_B + t * N + g * NPL, wb);
        const float a = PC ? s_a[t * CH + lane] : 0.f;
#pragma unroll
        for (int i = 0; i < NPL; ++i) {
          const float hp = u == 0 ? s_h[(k * N + g * NPL + i) * CH + lane]
                                  : hh[u > 0 ? u - 1 : 0][i];
          if constexpr (PC) {
            hh[u][i] = scan_update(a, hp, uu, word_elem<Tp>(wb, i));
          } else {
            aa[u][i] = scan_decay(dv, a2[i]);
            hh[u][i] = scan_update(aa[u][i], hp, uu, word_elem<Tp>(wb, i));
          }
        }
      }
      // and walk them backwards
#pragma unroll
      for (int u = U - 1; u >= 0; --u) {
        const int t = k * U + u;
        const float dv = to_f32(r_dt[t * CH + lane]);
        const float dyv = to_f32(r_dy[t * CH + lane]);
        const float uu = dv * to_f32(r_x[t * CH + lane]);
        const float a = PC ? s_a[t * CH + lane] : 0.f;
        uint32_t wb[BW], wc[BW];
        load_words(r_B + t * N + g * NPL, wb);
        load_words(r_C + t * N + g * NPL, wc);
        // sum_n g B, and sum_n g A a h_{t-1} (Mamba-1) or sum_n g h_{t-1}
        // (Mamba-2), over this warp's states
        float s1 = 0.f, s2 = 0.f;
        float v[2 * NPL];  // g u (dB) and dy h (dC) of each state
#pragma unroll
        for (int i = 0; i < NPL; ++i) {
          const float gi = fmaf(word_elem<Tp>(wc, i), dyv, carry[i]);
          const float hp = u == 0 ? s_h[(k * N + g * NPL + i) * CH + lane]
                                  : hh[u > 0 ? u - 1 : 0][i];  // h_{t-1}
          s1 = fmaf(gi, word_elem<Tp>(wb, i), s1);
          if constexpr (PC) {
            s2 = fmaf(gi, hp, s2);
            carry[i] = a * gi;
          } else {
            const float q = gi * aa[u][PC ? 0 : i] * hp;
            s2 = fmaf(q, av[i], s2);
            dA[i] = fmaf(q, dv, dA[i]);
            carry[i] = aa[u][PC ? 0 : i] * gi;
          }
          v[i] = gi * uu;
          v[NPL + i] = dyv * hh[u][i];
        }
        warp_transpose_sum<2 * NPL, 16>(v, lane);
        if (lane % SPREAD == 0) {
          const int j = lane / SPREAD;
          s_dbc[(t * 2 + (j < NPL ? 0 : 1)) * N + g * NPL + j % NPL] = v[0];
        }
        sp[(g * U + u) * CH + lane] = s1;
        sp[((P + g) * U + u) * CH + lane] = s2;
      }
      // every warp's partials of the sub-chunk; the next sub-chunk writes
      // the other buffer, and the one after it comes after the next barrier
      __syncthreads();
      for (int u = g; u < U; u += P) {
        const int t = k * U + u;
        const int tg = t0 + t;
        if (live && tg < S) {
          float s1 = 0.f, s2 = 0.f;
#pragma unroll
          for (int gg = 0; gg < P; ++gg) {
            s1 += sp[(gg * U + u) * CH + lane];
            s2 += sp[((P + gg) * U + u) * CH + lane];
          }
          const float dv = to_f32(r_dt[t * CH + lane]);
          const float xv = to_f32(r_x[t * CH + lane]);
          const float dyv = to_f32(r_dy[t * CH + lane]);
          const long long off = (row0 + tg) * Dl + d;
          dx[off] = from_f32<Tp>(fmaf(dv, s1, dk * dyv));
          if constexpr (PC) {
            const float qa = s_a[t * CH + lane] * s2;  // a_t sum_n g h_{t-1}
            ddt[off] = from_f32<Tp>(fmaf(xv, s1, ac * qa));
            eA = fmaf(qa, dv, eA);
          } else {
            ddt[off] = from_f32<Tp>(fmaf(xv, s1, s2));
          }
          eD = fmaf(dyv, xv, eD);
        }
      }
    }
  }

  // the last chunk's dB, dC sums; every epilogue is done
  cluster.sync();
  if (nch > 0) reduce(0);
  float* s_e = s_p;  // [2][P][CH]: each warp's epilogue sums of dD, dA
  s_e[g * CH + lane] = eD;
  s_e[(P + g) * CH + lane] = eA;
  __syncthreads();
  if (g == 0 && live) {
    float sD = 0.f, sA = 0.f;
    for (int gg = 0; gg < P; ++gg) {
      sD += s_e[gg * CH + lane];
      sA += s_e[(P + gg) * CH + lane];
    }
    dDp[(long long)b * D + d] = sD;
    if constexpr (PC) dAp[(long long)b * D + d] = sA;
  }
  if constexpr (!PC) {
    if (live) {
#pragma unroll
      for (int i = 0; i < NPL; ++i) dAp[((long long)b * D + d) * N + g * NPL + i] = dA[i];
    }
  }
  // no block leaves while another block of its cluster reads its sums
  cluster.sync();
}

// The partials summed in a fixed order: dB and dC over clusters, dA and dD
// over batch rows. One thread per output element, grid-strided. na: D N
// (Mamba-1) or D (Mamba-2).
template <typename Tp>
__global__ void __launch_bounds__(256)
scan_bwd_finish(const float* __restrict__ dBp, const float* __restrict__ dCp,
                const float* __restrict__ dAp, const float* __restrict__ dDp,
                Tp* __restrict__ dB, Tp* __restrict__ dC, float* __restrict__ dA,
                float* __restrict__ dD, int Bsz, int S, int D, int N, int ncl, int na) {
  const long long nbc = (long long)Bsz * S * N;
  const long long total = 2 * nbc + na + D;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    if (i < 2 * nbc) {
      const bool is_c = i >= nbc;
      const long long j = is_c ? i - nbc : i;
      const float* p = (is_c ? dCp : dBp) + (j / N) * ncl * N + j % N;
      for (int q = 0; q < ncl; ++q) s += p[(long long)q * N];
      (is_c ? dC : dB)[j] = from_f32<Tp>(s);
    } else if (i < 2 * nbc + na) {
      const long long j = i - 2 * nbc;
      for (int q = 0; q < Bsz; ++q) s += dAp[(long long)q * na + j];
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
  int B, S, D, cl;
  long long sb_b, sb_t, sc_b, sc_t;
};

template <typename Tp, int N, int T, bool PC>
int launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<Tp, N, T, PC>();
  static_assert(smem <= 232448, "the backward's shared memory exceeds a block's 227 KB");
  const auto kern = scan_bwd_kernel<Tp, N, T, PC>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  constexpr long long is = sizeof(Tp);
  const uintptr_t xp = reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.dt) |
                       reinterpret_cast<uintptr_t>(a.dy);
  const int xmode = xp % 16 == 0 && a.D * is % 16 == 0 ? STAGE_16 : STAGE_ELEM;
  // every stride a multiple of 16 bytes iff their OR is (is: a power of 2)
  const uintptr_t bp = reinterpret_cast<uintptr_t>(a.Bm) | reinterpret_cast<uintptr_t>(a.Cm);
  const long long bs = (a.sb_b | a.sb_t | a.sc_b | a.sc_t) * is;
  const int bcmode = bp % 16 == 0 && bs % 16 == 0 && N * is % 16 == 0 ? STAGE_16 : STAGE_ELEM;
  const int ncb = (a.D + CH - 1) / CH;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ncb, a.B);
  cfg.blockDim = dim3(Plan<N, PC>::NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const Tp*>(a.x), static_cast<const Tp*>(a.dt),
      static_cast<const float*>(a.A), static_cast<const Tp*>(a.Bm), static_cast<const Tp*>(a.Cm),
      static_cast<const float*>(a.Dv), static_cast<const float*>(a.states),
      static_cast<const Tp*>(a.dy), static_cast<Tp*>(a.dx), static_cast<Tp*>(a.ddt),
      static_cast<float*>(a.dBp), static_cast<float*>(a.dCp), static_cast<float*>(a.dAp),
      static_cast<float*>(a.dDp), a.S, a.D, a.cl, xmode, bcmode, a.sb_b, a.sb_t, a.sc_b, a.sc_t);
  if (e != cudaSuccess) return (int)e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int na = PC ? a.D : a.D * N;
  const long long total = 2LL * a.B * a.S * N + na + a.D;
  const long long want = (total + 255) / 256;
  const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);
  scan_bwd_finish<Tp><<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(a.dBp), static_cast<const float*>(a.dCp),
      static_cast<const float*>(a.dAp), static_cast<const float*>(a.dDp),
      static_cast<Tp*>(a.dB), static_cast<Tp*>(a.dC), static_cast<float*>(a.dA),
      static_cast<float*>(a.dD), a.B, a.S, a.D, N, ncb / a.cl, na);
  return (int)cudaGetLastError();
}

// every N the forward takes (selective_scan.cu:dispatch), with 32 or 64
// steps per chunk; the states per thread are the backward's own (Plan)
template <typename Tp, bool PC>
int dispatch(int N, int T, const Args& a, cudaStream_t stream) {
#define SCAN_CASE(NN) \
  if (N == NN) return T == 64 ? launch<Tp, NN, 64, PC>(a, stream) : launch<Tp, NN, 32, PC>(a, stream);
  SCAN_CASE(4) SCAN_CASE(8) SCAN_CASE(16) SCAN_CASE(32) SCAN_CASE(64)
#undef SCAN_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: DTYPE_F32 or DTYPE_BF16 for x, dt, B, C, dy and dx, ddt, dB, dC;
// A, D, states, dA, dD and the four partial buffers are f32. per_channel:
// 0 for A (D, N) and dA (D, N), the Mamba-1 body; 1 for A (D,) and dA (D,),
// the Mamba-2 body. states: the forward's chunk states with the same
// `steps` (kernels/cuda.py:scan_plan). cluster: channel blocks per thread
// block cluster (1, 2, 4 or 8, dividing ceil(D / 32)); dBp and dCp are
// (B, S, ceil(D / 32) / cluster, N), dAp (B, D, N) or (B, D), dDp (B, D).
// dB and dC are written contiguous (B, S, N). Two launches on `stream`,
// the scan and the sums of its partials; returns the first CUDA error.
int selective_scan_bwd(int dtype, const void* x, const void* dt, const void* A, const void* Bm,
                       const void* Cm, const void* Dv, const void* states, const void* dy,
                       void* dx, void* ddt, void* dB, void* dC, void* dA, void* dD, void* dBp,
                       void* dCp, void* dAp, void* dDp, int B, int S, int D, int N, int steps,
                       int per_channel, int cluster, long long sb_b, long long sb_t,
                       long long sc_b, long long sc_t, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ncb = (D + CH - 1) / CH;
  if (steps != 32 && steps != 64) return (int)cudaErrorInvalidValue;
  if ((cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) || ncb % cluster)
    return (int)cudaErrorInvalidValue;
  const Args a{x,   dt,  A,   Bm,  Cm, Dv, states, dy, dx,      ddt,  dB,   dC,   dA,
               dD,  dBp, dCp, dAp, dDp, B, S,      D,  cluster, sb_b, sb_t, sc_b, sc_t};
  if (dtype == DTYPE_F32)
    return per_channel ? dispatch<float, true>(N, steps, a, st)
                       : dispatch<float, false>(N, steps, a, st);
  if (dtype == DTYPE_BF16)
    return per_channel ? dispatch<__nv_bfloat16, true>(N, steps, a, st)
                       : dispatch<__nv_bfloat16, false>(N, steps, a, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
