// One-token GQA decode attention over a contiguous or a paged KV cache.
//
// Replaces two Pallas TPU kernels of the reference package:
//   src/repro/kernels/decode_attention.py:decode_attention (_decode_kernel)
//   src/repro/kernels/paged_attention.py:paged_decode_attention
// Same semantics: q (B, H, hd) attends over the first `lengths[b]` cache
// positions (optionally only the last `window` of them), softmax in f32,
// and the output is 0 where nothing is attended (length 0, or a window
// that excludes every key) — the Pallas convention (`l == 0 -> 1` in
// _decode_kernel), not the plain version's uniform average.
//
// What bounds it on an H100: bytes. Every attended position costs one K
// row and one V row (2 * KV * hd * dtype bytes over all heads) against
// 4 * G * hd FLOPs, far below the card's ~295 FLOP/byte ridge, so the
// least time is the cache bytes over 3.35 TB/s. Reaching it takes many
// bytes in flight on every SM, which one block per (kv head, row) cannot
// give at the engine's B = 8, KV = 8 (64 blocks for 132 SMs).
//
// Design: split-KV. The grid is (KV, B, splits): each block takes one
// chunk of `chunk` cache positions of one (row, kv head). The wrapper
// derives chunk and splits on the host from the cache's capacity (S, or
// max_pages * page) and the grid's other axes, never from `lengths`, so
// planning never syncs with the device. A block copies its chunk's K rows
// and then its V rows into shared memory with cp.async (16 bytes a lane,
// the whole chunk in flight at once, rows padded by 16 bytes so that the
// per-position row reads are free of bank conflicts), and computes the
// scores while the V rows are still arriving. Each thread owns whole
// positions and accumulates the G query heads' dot products in registers
// (q broadcast from shared memory): no per-position warp reduction. The
// per-head max and sum take one warp reduction per chunk; for P V each
// thread owns two output columns of all G heads over a subset of the
// positions, and those subsets sum in a fixed order.
//
// Merge in the same launch: every block writes its partial (m, l and the
// unnormalised acc, f32) to a scratch buffer the wrapper keeps, then adds
// one to the (row, kv head)'s counter; the block that brings it to
// `splits` merges all partials in split order into the output and resets
// the counter to 0 for the next launch. An empty chunk (past the length
// or before the window) writes m = NEG_INF, l = 0, which the merge skips;
// when every chunk is empty the output is zeros. One split takes the same
// path (its weight is exp(0) = 1).
//
// Paged layout: position p of row b lives in pool row
//   min(block_tables[b, min(p / page, max_pages - 1)], P - 1) * page + p % page.
// A block stages the table entries of its chunk's pages in shared memory
// once (one read per page, not per position), and the walk does not
// depend on the page size: page 1 and pages as deep as the whole context
// run the same code. The contiguous and paged instantiations share the
// body, the split boundaries and the order of every sum, so they agree
// bitwise on the same data whenever S == max_pages * page.

#include "attn_common.cuh"

using namespace repro_attn;

namespace {

constexpr int NT = 128;
constexpr int MERGE_SPLITS = 32;  // splits whose merge weights stage together

// shared-memory layout of one block, in bytes; the plan's chunk keeps the
// K and V rows within the budget the wrapper states (kernels/cuda.py)
template <typename T, int HD, int G>
struct Smem {
  static constexpr int EV = 16 / int(sizeof(T));  // elements per 16-byte vector
  static constexpr int LDS = HD + EV;             // elements per shared row
  static constexpr int QUADS = HD / 4;            // output column quads
  static constexpr int NG = NT / QUADS < 8 ? NT / QUADS : 8;  // position groups in P V
  static __host__ __device__ int kv(int chunk) { return chunk * LDS * int(sizeof(T)); }
  static __host__ __device__ int bytes(int chunk) {
    return 2 * kv(chunk) + G * HD * 4 + chunk * G * 4 + NG * G * HD * 4 + (chunk + 1) * 4;
  }
};

template <typename T, int HD, int G, bool PAGED>
__global__ void __launch_bounds__(NT)
decode_kernel(const T* __restrict__ q,               // (B, H, hd)
              const T* __restrict__ k,               // (B, S, KV, hd) | (P, page, KV, hd)
              const T* __restrict__ v,
              const int* __restrict__ lengths,       // (B,)
              const int* __restrict__ block_tables,  // (B, max_pages), paged only
              T* __restrict__ out,                   // (B, H, hd)
              float* __restrict__ part_ml,           // (B, KV, splits, G, 2)
              float* __restrict__ part_acc,          // (B, KV, splits, G, hd)
              int* __restrict__ counters,            // (B, KV), zero between launches
              int S,                                 // cache depth | page size
              int KV, int max_pages, int P, int chunk, int window, float sm_scale) {
  using L = Smem<T, HD, G>;
  constexpr int EV = L::EV;
  constexpr int LDS = L::LDS;
  constexpr int VPR = HD / EV;
  constexpr int QUADS = L::QUADS;
  constexpr int NG = L::NG;
  static_assert(NG >= 1 && HD % EV == 0, "unsupported head dim");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = reinterpret_cast<T*>(smem_raw + L::kv(chunk));
  float* qs = reinterpret_cast<float*>(smem_raw + 2 * L::kv(chunk));  // (G, hd)
  float* ps = qs + G * HD;                                            // (chunk, G)
  float* red = ps + chunk * G;                                        // (NG, G, hd)
  int* tab = reinterpret_cast<int*>(red + NG * G * HD);               // chunk + 1
  __shared__ float sm_m[G], sm_l[G];
  __shared__ float sm_w[MERGE_SPLITS][G];
  __shared__ int is_last;

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int H = KV * G;

  const int len = lengths[b];
  // positions the cache can hold: S for a contiguous row, the table's span
  // for a paged one (the plain versions mask over exactly that range)
  const int cap = PAGED ? max_pages * S : S;
  const int end = min(len, cap);
  const int start = window >= 0 ? max(0, len - window) : 0;
  const int lo = max(split * chunk, start);
  const int hi = min(split * chunk + chunk, end);
  const int n = hi - lo;  // positions this block attends (uniform across the block)
  const size_t part = ((size_t)b * KV + kvh) * splits + split;
  T* orow = out + ((size_t)b * H + kvh * G) * HD;

  if (n > 0) {
    if (PAGED) {
      const int p0 = lo / S;
      for (int i = tid; i <= (hi - 1) / S - p0; i += NT)
        tab[i] = min(block_tables[(size_t)b * max_pages + min(p0 + i, max_pages - 1)], P - 1);
      __syncthreads();
    }
    // K rows, then V rows: two copy groups, all in flight together
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const T* src = pass ? v : k;
      T* dst = pass ? Vs : Ks;
      for (int i = tid; i < n * VPR; i += NT) {
        const int r = i / VPR, c = i % VPR, pos = lo + r;
        size_t row;
        if (PAGED)
          row = (size_t)tab[pos / S - lo / S] * S + pos % S;
        else
          row = (size_t)b * S + pos;
        cp_async16(dst + r * LDS + c * EV, src + (row * KV + kvh) * HD + c * EV);
      }
      cp_async_commit();
    }
    for (int i = tid; i < G * HD; i += NT)
      qs[i] = to_f32(q[((size_t)b * H + kvh * G) * HD + i]);
    cp_async_wait<1>();  // the K rows are in; the V rows may still be arriving
    __syncthreads();

    // scores: one position per thread, all G heads in registers
    for (int i = tid; i < n; i += NT) {
      float s[G];
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = 0.f;
#pragma unroll 4
      for (int c = 0; c < VPR; ++c) {
        float x[EV];
        load_f32<T, EV>(Ks + i * LDS + c * EV, x);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4* qv = reinterpret_cast<const float4*>(qs + g * HD + c * EV);
#pragma unroll
          for (int e4 = 0; e4 < EV / 4; ++e4) {
            const float4 w = qv[e4];
            s[g] += w.x * x[4 * e4] + w.y * x[4 * e4 + 1] + w.z * x[4 * e4 + 2] +
                    w.w * x[4 * e4 + 3];
          }
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) ps[i * G + g] = s[g] * sm_scale;
    }
    __syncthreads();

    // per-head max and sum over the chunk: warp w takes heads w, w + 4, ...
    for (int g = warp; g < G; g += NT / 32) {
      float mx = NEG_INF;
      for (int i = lane; i < n; i += 32) mx = fmaxf(mx, ps[i * G + g]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.f;
      for (int i = lane; i < n; i += 32) {
        const float p = expf(ps[i * G + g] - mx);
        ps[i * G + g] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        sm_m[g] = mx;
        sm_l[g] = sum;
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // P V: thread (group pg, quad dq) sums positions pg, pg + NG, ... into
    // columns 4 dq .. 4 dq + 3 of every head
    if (tid < NG * QUADS) {
      const int pg = tid / QUADS, dq = tid % QUADS;
      float acc[G][4];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
#pragma unroll 4
      for (int i = pg; i < n; i += NG) {
        float x[4];
        load_f32<T, 4>(Vs + i * LDS + 4 * dq, x);
        float p[G];
        if constexpr (G % 4 == 0) {
#pragma unroll
          for (int g4 = 0; g4 < G; g4 += 4) {
            const float4 w = *reinterpret_cast<const float4*>(ps + i * G + g4);
            p[g4] = w.x;
            p[g4 + 1] = w.y;
            p[g4 + 2] = w.z;
            p[g4 + 3] = w.w;
          }
        } else {
#pragma unroll
          for (int g = 0; g < G; ++g) p[g] = ps[i * G + g];
        }
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[g][e] += p[g] * x[e];
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
        *reinterpret_cast<float4*>(red + (pg * G + g) * HD + 4 * dq) =
            make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
    }
    __syncthreads();
    for (int i = tid; i < G * HD; i += NT) {
      float a = 0.f;
#pragma unroll
      for (int pg = 0; pg < NG; ++pg) a += red[pg * G * HD + i];
      part_acc[part * G * HD + i] = a;
    }
    if (tid < G) {
      part_ml[(part * G + tid) * 2] = sm_m[tid];
      part_ml[(part * G + tid) * 2 + 1] = sm_l[tid];
    }
  } else if (tid < G) {
    part_ml[(part * G + tid) * 2] = NEG_INF;
    part_ml[(part * G + tid) * 2 + 1] = 0.f;
  }

  // the last block of this (row, kv head) to finish merges the partials
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int done = atomicAdd(&counters[b * KV + kvh], 1);
    is_last = done == splits - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // every split's (m, l) is read once per head by a warp: the global max,
  // then the total weight, each over the splits in a fixed lane order
  const size_t part0 = ((size_t)b * KV + kvh) * splits;
  const float* ml = part_ml + part0 * G * 2;
  for (int g = warp; g < G; g += NT / 32) {
    float M = NEG_INF;
    for (int s = lane; s < splits; s += 32) M = fmaxf(M, __ldcg(ml + (s * G + g) * 2));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    float Lsum = 0.f;
    for (int s = lane; s < splits; s += 32) {
      const float ls = __ldcg(ml + (s * G + g) * 2 + 1);
      if (ls != 0.f) Lsum += ls * expf(__ldcg(ml + (s * G + g) * 2) - M);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) Lsum += __shfl_xor_sync(0xffffffffu, Lsum, o);
    if (lane == 0) {
      sm_m[g] = M;
      sm_l[g] = Lsum;
    }
  }
  // acc: weights of MERGE_SPLITS splits at a time in shared memory, then
  // independent loads of every split's acc, summed in split order. An
  // empty split has weight 0 and its acc (never written) is not read.
  float A[(G * HD + NT - 1) / NT];
#pragma unroll
  for (int j = 0; j < (G * HD + NT - 1) / NT; ++j) A[j] = 0.f;
  const float* pacc = part_acc + part0 * G * HD;
  for (int s0 = 0; s0 < splits; s0 += MERGE_SPLITS) {
    __syncthreads();
    for (int j = tid; j < MERGE_SPLITS * G; j += NT) {
      const int s = s0 + j / G, g = j % G;
      float w = 0.f;
      if (s < splits) {
        const float ls = __ldcg(ml + (s * G + g) * 2 + 1);
        if (ls != 0.f) w = expf(__ldcg(ml + (s * G + g) * 2) - sm_m[g]);
      }
      sm_w[j / G][g] = w;
    }
    __syncthreads();
    const int s1 = min(s0 + MERGE_SPLITS, splits);
#pragma unroll
    for (int j = 0; j < (G * HD + NT - 1) / NT; ++j) {
      const int i = tid + j * NT;
      if (i >= G * HD) break;
      const int g = i / HD;
      float a = A[j];
#pragma unroll 8
      for (int s = s0; s < s1; ++s) {
        const float w = sm_w[s - s0][g];
        if (w != 0.f) a += __ldcg(pacc + (size_t)s * G * HD + i) * w;
      }
      A[j] = a;
    }
  }
#pragma unroll
  for (int j = 0; j < (G * HD + NT - 1) / NT; ++j) {
    const int i = tid + j * NT;
    if (i >= G * HD) break;
    const float Lsum = sm_l[i / HD];
    orow[i] = from_f32<T>(Lsum == 0.f ? 0.f : A[j] / Lsum);
  }
  if (tid == 0) counters[b * KV + kvh] = 0;
}

template <typename T, int HD, int G, bool PAGED>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           const void* block_tables, void* out, void* part_ml, void* part_acc,
           void* counters, int B, int S, int KV, int max_pages, int P, int chunk,
           int splits, int window, float sm_scale, cudaStream_t stream) {
  const int bytes = Smem<T, HD, G>::bytes(chunk);
  auto kern = decode_kernel<T, HD, G, PAGED>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(KV, B, splits);
  kern<<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), static_cast<const int*>(block_tables),
      static_cast<T*>(out), static_cast<float*>(part_ml), static_cast<float*>(part_acc),
      static_cast<int*>(counters), S, KV, max_pages, P, chunk, window, sm_scale);
  return (int)cudaGetLastError();
}

struct Args {
  const void *q, *k, *v, *lengths, *bt;
  void *out, *part_ml, *part_acc, *counters;
  int B, S, KV, max_pages, P, chunk, splits, window;
  float sm_scale;
  cudaStream_t st;
};

template <typename T, int HD, int G, bool PAGED>
int run(const Args& a) {
  return launch<T, HD, G, PAGED>(a.q, a.k, a.v, a.lengths, a.bt, a.out, a.part_ml, a.part_acc,
                                 a.counters, a.B, a.S, a.KV, a.max_pages, a.P, a.chunk,
                                 a.splits, a.window, a.sm_scale, a.st);
}

// (G, hd) pairs the wrappers accept: G in {1,2,4,8,16}, hd in
// {32,64,80,128,256}, G * hd <= 1024 (the G scores in registers and the
// per-head shared buffers stay bounded)
template <typename T, int HD, bool PAGED>
int dispatch_g(int G, const Args& a) {
#define REPRO_G_CASE(GG)                       \
  case GG:                                     \
    if constexpr (GG * HD <= 1024)             \
      return run<T, HD, GG, PAGED>(a);         \
    else                                       \
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
int dispatch(int hd, int G, const Args& a) {
  switch (hd) {
    case 32:
      return dispatch_g<T, 32, PAGED>(G, a);
    case 64:
      return dispatch_g<T, 64, PAGED>(G, a);
    case 80:
      return dispatch_g<T, 80, PAGED>(G, a);
    case 128:
      return dispatch_g<T, 128, PAGED>(G, a);
    case 256:
      return dispatch_g<T, 256, PAGED>(G, a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <bool PAGED>
int entry(int dtype, int H, int hd, const Args& a) {
  if (a.KV <= 0 || H % a.KV != 0 || a.chunk <= 0 || a.splits <= 0)
    return (int)cudaErrorInvalidValue;
  if (a.B == 0) return (int)cudaSuccess;
  const int G = H / a.KV;
  if (dtype == DTYPE_F32) return dispatch<float, PAGED>(hd, G, a);
  if (dtype == DTYPE_BF16) return dispatch<__nv_bfloat16, PAGED>(hd, G, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q (B, H, hd); k, v (B, S, KV, hd); lengths (B,) int32; out (B, H, hd).
// chunk, splits: the launch plan (splits * chunk >= S); part_ml
// (B*KV*splits*G*2) and part_acc (B*KV*splits*G*hd) f32 scratch and
// counters (B*KV) int32, zero on entry and on return. window < 0 means
// no window. Returns cudaGetLastError()
// after the launch.
int decode_attention(int dtype, const void* q, const void* k, const void* v,
                     const void* lengths, void* out, void* part_ml, void* part_acc,
                     void* counters, int B, int S, int H, int KV, int hd, int chunk,
                     int splits, int window, float sm_scale, void* stream) {
  Args a{q, k, v, lengths, nullptr, out, part_ml, part_acc, counters, B, S, KV, 1, 1, chunk,
         splits, window, sm_scale, static_cast<cudaStream_t>(stream)};
  return entry<false>(dtype, H, hd, a);
}

// q (B, H, hd); k_pool, v_pool (P, page, KV, hd); block_tables (B, max_pages)
// int32 (ids >= P are sentinels); lengths (B,) int32; out (B, H, hd); plan
// and scratch as above with max_pages * page in place of S.
int paged_decode_attention(int dtype, const void* q, const void* k_pool, const void* v_pool,
                           const void* block_tables, const void* lengths, void* out,
                           void* part_ml, void* part_acc, void* counters, int B, int P,
                           int page, int max_pages, int H, int KV, int hd, int chunk,
                           int splits, int window, float sm_scale, void* stream) {
  Args a{q, k_pool, v_pool, lengths, block_tables, out, part_ml, part_acc, counters, B, page,
         KV, max_pages, P, chunk, splits, window, sm_scale,
         static_cast<cudaStream_t>(stream)};
  return entry<true>(dtype, H, hd, a);
}

}  // extern "C"
