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
// convention (`l == 0 -> 1` in _flash_kernel). With a non-null `lse` the
// kernel also writes each row's log-sum-exp of its scaled scores,
// m + log(l), as f32 (B, H, Sq), and -inf for a row with nothing to
// attend: what the backward kernels (flash_attention_bwd.cu) recompute
// the probabilities from. The store is a template flag (LSE), so
// serving, which passes null, runs bodies compiled without it.
//
// What bounds it on an H100: operations. A 512-token causal prefill does
// ~2 * 512 / 2 FLOPs per byte of K/V read per head, well past the ridge,
// so the least time is the causal FLOPs over the bf16 tensor-core peak.
//
// Two bodies, chosen by dtype (not a fallback: a bf16 tensor always runs
// the tensor-core body, an f32 tensor the CUDA-core one):
//
// bf16 — flash_mma_kernel, tensor cores. One block of 4 or 8 warps per
// (query head, batch row, 64- or 128-query tile); each warp owns 16 query
// rows. The wrapper takes the taller tile when the grid still has about
// a block per SM (kernels/cuda.py:flash_plan); the two measured within a
// few percent of each other, so K/V re-reads from L2 are not what bounds
// this body.
// Q, K and V tiles stay bf16 in shared memory, rows padded by 16 bytes so
// that every ldmatrix phase hits 8 distinct bank groups (row strides of
// 80, 144, 176 and 272 bytes for hd 32, 64, 80 and 128). S = Q K^T and
// O += P V run as mma.sync.m16n8k16 (bf16 in, f32 accumulate); P goes
// from the S accumulator registers straight into the A operand, rounded to
// bf16, and never touches shared memory. The online softmax works on the
// accumulator fragments: a thread holds two rows, and the row max and sum
// reduce over the 4 threads of a quad by shuffles. K/V tiles arrive by
// cp.async into a 2-stage ring, so the next tile's copy overlaps this
// tile's math; tiles past Sk are zero-filled by the copy. mma.sync was
// chosen over wgmma/TMA as the simpler step that still runs at
// tensor-core rates: its fragment layout is fixed by the PTX ISA, so the
// masks below are written against one documented layout, and there are
// no TMA descriptors or smem swizzle modes to get wrong. Query tiles are
// issued heaviest (last) first, on the grid's slowest axis, so the causal
// tail does not run alone at the end. hd is any multiple of 16 (32, 64,
// 80 = 5 x 16, 128).
//
// f32 — flash_kernel, CUDA cores. Tensor cores would need TF32, which
// keeps ~3 decimal digits and breaks the f32 agreement the tests hold the
// card to. One block per (64-query tile, query head, batch row), 256
// threads; Q, K and V staged in shared memory as f32 with rows padded by
// one word; each thread owns a 4 x 4 block of the score tile and a
// 4 x (hd / 16) block of the output; the score tile goes through shared
// memory for the P V product.
//
// Both bodies loop only over key tiles that can hold an unmasked key: from
// the window's left edge to min(length, last causal position), which is
// the TPU kernel's skip of fully masked tiles. The mask and that key range
// are attn_common.cuh's REPRO_ATTN_VISIBLE / REPRO_ATTN_KEY_RANGE, which
// the backward kernels use too. GQA maps query head h to kv head
// h / (H / KV) in the address computation, as the TPU kernel's index map
// does.

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

template <typename T, int HD, bool CAUSAL, bool LSE>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ q,         // (B, Sq, H, hd)
             const T* __restrict__ k,         // (B, Sk, KV, hd)
             const T* __restrict__ v,
             const int* __restrict__ lengths,   // (B,) or null
             const int* __restrict__ q_offset,  // (B,) or null
             T* __restrict__ out,             // (B, Sq, H, hd)
             float* __restrict__ lse,         // (B, H, Sq) or null
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

  int kstart, kend;
  REPRO_ATTN_KEY_RANGE(CAUSAL, qoff + q0, qoff + min(q0 + BQ, Sq), len, window, BK, kstart,
                       kend);

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
        ok[j] = REPRO_ATTN_VISIBLE(CAUSAL, kp, qpos, len, window);
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
    if constexpr (LSE)
      if (tc == 0)  // m and l are the same on the row's 16 threads
        lse[((size_t)b * H + h) * Sq + qi] = l[i] == 0.f ? -INFINITY : m[i] + logf(l[i]);
  }
}

// ---- bf16: tensor cores ------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// WARPS warps of 16 query rows each: a query tile of 16 * WARPS rows
template <int HD, int WARPS>
constexpr int mma_smem_bytes() {
  return (16 * WARPS + 4 * BK) * (HD + 8) * 2;  // Q, two K stages, two V stages
}

template <int HD, bool CAUSAL, int WARPS, bool LSE>
__global__ void __launch_bounds__(WARPS * 32)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,  // (B, Sq, H, hd)
                 const __nv_bfloat16* __restrict__ k,  // (B, Sk, KV, hd)
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ lengths,    // (B,) or null
                 const int* __restrict__ q_offset,   // (B,) or null
                 __nv_bfloat16* __restrict__ out,    // (B, Sq, H, hd)
                 float* __restrict__ lse,            // (B, H, Sq) or null
                 int Sq, int Sk, int H, int KV, int window, float scale_log2) {
  static_assert(HD % 16 == 0, "hd must be a multiple of the mma depth");
  constexpr int BQ = 16 * WARPS;
  constexpr int MMA_NT = 32 * WARPS;
  constexpr int LDS = HD + 8;  // bf16 per shared row: 16 bytes of padding
  constexpr int VPR = HD / 8;  // 16-byte vectors per row
  constexpr int KS = HD / 16;  // k-steps of Q K^T
  constexpr int NO = HD / 8;   // n8 tiles of the output
  constexpr int NS = BK / 8;   // n8 tiles of the score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LDS;
  __nv_bfloat16* Vs = Ks + 2 * BK * LDS;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest tile first
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gr = lane >> 2;  // accumulator rows gr and gr + 8
  const int tc = lane & 3;   // accumulator columns 2 tc, 2 tc + 1
  const int qoff = q_offset ? q_offset[b] : 0;
  const int len = lengths ? min(lengths[b], Sk) : Sk;

  int kstart, kend;
  REPRO_ATTN_KEY_RANGE(CAUSAL, qoff + q0, qoff + min(q0 + BQ, Sq), len, window, BK, kstart,
                       kend);
  const int ntiles = kend > kstart ? (kend - kstart + BK - 1) / BK : 0;

  const size_t qstride = (size_t)H * HD;
  const size_t kstride = (size_t)KV * HD;
  const __nv_bfloat16* qb = q + ((size_t)b * Sq * H + h) * HD;
  const __nv_bfloat16* kb = k + ((size_t)b * Sk * KV + kvh) * HD;
  const __nv_bfloat16* vb = v + ((size_t)b * Sk * KV + kvh) * HD;

  for (int i = tid; i < BQ * VPR; i += MMA_NT) {
    const int r = i / VPR, c = i % VPR, qi = q0 + r;
    cp_async16(Qs + r * LDS + c * 8, qb + (size_t)min(qi, Sq - 1) * qstride + c * 8,
               qi < Sq ? 16 : 0);
  }
  auto load_kv = [&](int k0, int stage) {
    __nv_bfloat16* kd = Ks + stage * BK * LDS;
    __nv_bfloat16* vd = Vs + stage * BK * LDS;
    for (int i = tid; i < BK * VPR; i += MMA_NT) {
      const int r = i / VPR, c = i % VPR, kp = k0 + r;
      const size_t off = (size_t)min(kp, Sk - 1) * kstride + c * 8;
      const int n = kp < Sk ? 16 : 0;  // past Sk: zero-filled
      cp_async16(kd + r * LDS + c * 8, kb + off, n);
      cp_async16(vd + r * LDS + c * 8, vb + off, n);
    }
  };
  if (ntiles > 0) load_kv(kstart, 0);
  cp_async_commit();

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
  uint32_t qf[KS][4];
  const int qpos0 = qoff + q0 + warp * 16 + gr;  // absolute position of row gr

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = kstart + it * BK;
    const int st = it & 1;
    if (it + 1 < ntiles) load_kv(k0 + BK, st ^ 1);  // overlaps this tile's math
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldmatrix_x4<false>(qf[kk], Qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                                       kk * 16 + (lane >> 4) * 8);
    }
    const __nv_bfloat16* kt = Ks + st * BK * LDS;
    const __nv_bfloat16* vt = Vs + st * BK * LDS;

    // S = Q K^T: K rows are the n index, stored k-contiguous (col-major B)
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t f[4];
        ldmatrix_x4<false>(f, kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LDS + kk * 16 +
                                  ((lane >> 3) & 1) * 8);
        mma_bf16_16816(s[2 * np], qf[kk], f[0], f[1]);
        mma_bf16_16816(s[2 * np + 1], qf[kk], f[2], f[3]);
      }

    // scale into the log2 domain; mask only tiles that cross an edge.
    // Accumulator element e of n-tile j: row gr + 8 (e >> 1), key
    // k0 + 8 j + 2 tc + (e & 1).
    const bool full = k0 + BK <= len && (!CAUSAL || k0 + BK - 1 <= qoff + q0) &&
                      (window < 0 || k0 > qoff + q0 + BQ - 1 - window);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (!full) {
          const int kp = k0 + j * 8 + tc * 2 + (e & 1);
          const int qp = qpos0 + (e >> 1) * 8;
          x = REPRO_ATTN_VISIBLE(CAUSAL, kp, qp, len, window) ? x : NEG_INF;
        }
        s[j][e] = x;
      }

    // online softmax on the fragments: a row's 4 threads form a quad
    float alpha[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float mx = m[hi];
#pragma unroll
      for (int j = 0; j < NS; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hi], s[j][2 * hi + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // a row with no unmasked key yet keeps max NEG_INF: subtract 0 so
      // that its masked scores give exp2(NEG_INF) = 0, not exp2(0) = 1
      const float ms = mx == NEG_INF ? 0.f : mx;
      alpha[hi] = exp2f(m[hi] - ms);
      m[hi] = mx;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[j][2 * hi] = exp2f(s[j][2 * hi] - ms);
        s[j][2 * hi + 1] = exp2f(s[j][2 * hi + 1] - ms);
        rs += s[j][2 * hi] + s[j][2 * hi + 1];
      }
      l[hi] = l[hi] * alpha[hi] + rs;  // this thread's columns; quad-reduced at the end
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V: P's A fragment is the S accumulators of n-tiles 2 kk and
    // 2 kk + 1, rounded to bf16; V rows are the k index (ldmatrix.trans)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t f[4];
        ldmatrix_x4<true>(f, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                                 np * 16 + (lane >> 4) * 8);
        mma_bf16_16816(o[2 * np], a, f[0], f[1]);
        mma_bf16_16816(o[2 * np + 1], a, f[2], f[3]);
      }
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 1);
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 2);
  }
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int qi = q0 + warp * 16 + gr + hi * 8;
    if (qi >= Sq) continue;
    const float inv = l[hi] == 0.f ? 0.f : 1.f / l[hi];
    // m is in the log2 domain: the natural log-sum-exp is m ln 2 + log l
    if constexpr (LSE)
      if (tc == 0)
        lse[((size_t)b * H + h) * Sq + qi] =
            l[hi] == 0.f ? -INFINITY : m[hi] * LN2 + logf(l[hi]);
    __nv_bfloat16* orow = out + (((size_t)b * Sq + qi) * H + h) * HD + tc * 2;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack_bf16(o[j][2 * hi] * inv, o[j][2 * hi + 1] * inv);
  }
}

// ---- launches ------------------------------------------------------------

template <int HD, bool CAUSAL>
int launch_f32(const void* q, const void* k, const void* v, const void* lengths,
               const void* q_offset, void* out, void* lse, int B, int Sq, int Sk, int H, int KV,
               int window, float sm_scale, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * int(sizeof(float));
  auto kern = lse ? flash_kernel<float, HD, CAUSAL, true> : flash_kernel<float, HD, CAUSAL, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(lengths),
      static_cast<const int*>(q_offset), static_cast<float*>(out), static_cast<float*>(lse), Sq,
      Sk, H, KV, window, sm_scale);
  return (int)cudaGetLastError();
}

template <int HD, bool CAUSAL, int WARPS>
int launch_bf16(const void* q, const void* k, const void* v, const void* lengths,
                const void* q_offset, void* out, void* lse, int B, int Sq, int Sk, int H, int KV,
                int window, float sm_scale, cudaStream_t stream) {
  constexpr int bytes = mma_smem_bytes<HD, WARPS>();
  auto kern = lse ? flash_mma_kernel<HD, CAUSAL, WARPS, true>
                  : flash_mma_kernel<HD, CAUSAL, WARPS, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B, (Sq + 16 * WARPS - 1) / (16 * WARPS));
  kern<<<grid, 32 * WARPS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lengths),
      static_cast<const int*>(q_offset), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), Sq, Sk, H, KV, window, sm_scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int HD, bool CAUSAL>
int launch(int dtype, int warps, const void* q, const void* k, const void* v,
           const void* lengths, const void* q_offset, void* out, void* lse, int B, int Sq, int Sk,
           int H, int KV, int window, float sm_scale, cudaStream_t st) {
  if (dtype == DTYPE_F32)
    return launch_f32<HD, CAUSAL>(q, k, v, lengths, q_offset, out, lse, B, Sq, Sk, H, KV, window,
                                  sm_scale, st);
  if (dtype == DTYPE_BF16 && warps == 4)
    return launch_bf16<HD, CAUSAL, 4>(q, k, v, lengths, q_offset, out, lse, B, Sq, Sk, H,
                                      KV, window, sm_scale, st);
  if (dtype == DTYPE_BF16 && warps == 8)
    return launch_bf16<HD, CAUSAL, 8>(q, k, v, lengths, q_offset, out, lse, B, Sq, Sk, H,
                                      KV, window, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

template <bool CAUSAL>
int dispatch(int dtype, int warps, int hd, const void* q, const void* k, const void* v,
             const void* lengths, const void* q_offset, void* out, void* lse, int B, int Sq, int Sk,
             int H, int KV, int window, float sm_scale, cudaStream_t st) {
#define REPRO_HD_CASE(HD)                                                                \
  case HD:                                                                              \
    return launch<HD, CAUSAL>(dtype, warps, q, k, v, lengths, q_offset, out, lse, B, Sq, Sk, H, \
                              KV, window, sm_scale, st);
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

// q (B, Sq, H, hd); k, v (B, Sk, KV, hd); lengths, q_offset (B,) int32 or
// null; out (B, Sq, H, hd); lse (B, H, Sq) f32 or null (written when
// given: each row's log-sum-exp, -inf where nothing is attended). window
// < 0 means no window. bf16 runs the
// tensor-core body with query tiles of 16 * warps rows (warps 4 or 8), f32
// the CUDA-core one (warps unused); hd in {32, 64, 80, 128}.
// Returns cudaGetLastError() after the launch (or the attribute call's
// error); an empty output launches nothing.
int flash_attention(int dtype, const void* q, const void* k, const void* v,
                    const void* lengths, const void* q_offset, void* out, void* lse, int B,
                    int Sq, int Sk, int H, int KV, int hd, int causal, int window,
                    float sm_scale, int warps, void* stream) {
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || H == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return causal ? dispatch<true>(dtype, warps, hd, q, k, v, lengths, q_offset, out, lse, B, Sq,
                                 Sk, H, KV, window, sm_scale, st)
                : dispatch<false>(dtype, warps, hd, q, k, v, lengths, q_offset, out, lse, B, Sq,
                                  Sk, H, KV, window, sm_scale, st);
}

}  // extern "C"
