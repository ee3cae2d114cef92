// Exact softmax attention, softmax(Q K^T / sqrt(d)) V, over [B, S, H, D]
// row-strided views (q, k and v may be slices of one qkv projection).
//
// Replaces three Pallas kernels that compute the same function with float32
// logits: `_kernel_whole_row` of diffusion_uncertainty_tpu/ops/flash_attention.py
// (:87-113; ADM-128's 32x32 sites, S=1024, D=128), `_kernel` of the same file
// (:134-168, the online-softmax loop over key blocks that JAX takes for
// S_kv > 2048: SD 1.5's 64x64 self-attention, S=4096, D=40, and the SD VAE's
// mid attention, S=4096, D=512) and `_kernel` of
// diffusion_uncertainty_tpu/ops/packed_attention.py (:95-124; ADM-128's 16x16
// sites, S=256, D=192, and 8x8 sites, S=64, D=256; SD 1.5's D=80/160 levels
// and its 77-key cross-attention; U-ViT-huge's 16 heads of D=72 over its
// S=258 tokens, q, k and v strided views of one qkv projection).
//
// The TPU kernels hold one whole [bq, S_kv] float32 logits row tile in VMEM.
// That does not carry over: a 64 x 1024 float32 tile is 256 KB, over the
// 227 KB a Hopper block can have. Here each block walks K/V in key tiles
// with an online softmax (running max m, running sum l, rescale of the
// accumulator by exp(m_old - m_new)). Numerics follow the TPU kernels:
// float32 logits scaled by 1/sqrt(d), exp, P rounded to the value type before
// P V, float32 accumulation, one division by l at the end, keys at or past
// kv_len at zero weight. exp(x * scale - m) is taken as exp2f(x * c - m * c)
// with c = log2(e) / sqrt(d) folded into one constant.
//
// Bound: the work is 4*S*S_kv*D operations per (b, h) against 2*(S + S_kv)*D
// elements moved, far above the card's memory line at every shape the port
// runs, so the limit is the arithmetic. Three kernels, one route each (the
// wrapper picks the route and counts it):
//   * tensor core (bf16, D in {40, 64, 72, 80, 128, 160, 192, 256}, rows on
//     16 bytes): `attention_tc_kernel`, both products on mma.sync;
//   * wide (256 < D <= 512, bf16 and float32): `attention_wide_kernel`, logits
//     once per key tile for all value columns, keys split over blocks, float32
//     by 3xTF32 on the tensor cores; `attention_combine_kernel` merges splits;
//   * CUDA core (float32 at D <= 256, and bf16 at other head dims or unaligned
//     rows): `attention_kernel`, FMAs out of shared memory.
// S_kv has no bound: the key loop is the same for 77 keys and for 4096.
#include "common.cuh"

#include <math.h>

using namespace du;

namespace {

// ---------------------------------------------------------------------------
// CUDA-core route: float32 at D <= 256 (no main path runs it), and bf16 at
// head dims without a tensor-core instance or rows off 16 bytes. Replaces
// the three Pallas kernels above for those inputs. Each block
// owns one (b, h, 64-query tile) and walks K/V in 64-key tiles staged in
// shared memory: FMAs out of shared memory (padded rows, no bank conflicts,
// 4x4 register tiles for Q K^T and 4 x D/16 for P V), D padded up to a
// register-tile bucket. Bound by the float32 FMA rate (67 TFLOP/s) at best;
// it reaches a fraction of it, so no main path is left on it.
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kSLd = kBK + 1;  // padded row of the logits tile

// Row pitch of the Q/K/V tiles in elements: an odd number of 32-bit words,
// so the 16 rows a half-warp reads at one column fall in 16 distinct banks.
template <typename T>
__host__ __device__ inline int tile_ld(int D) {
  return sizeof(T) == 4 ? D + 1 : D + 2;
}

template <typename T>
size_t smem_bytes(int D) {
  const int ld = tile_ld<T>(D);
  return (size_t)(kBQ + 2 * kBK) * ld * sizeof(T) + (size_t)kBQ * kSLd * sizeof(float) +
         3 * kBQ * sizeof(float);
}

// The steps of the CUDA-core kernel. Thread (tx, ty) of a 256-thread
// block owns logits rows ty + 16i and key columns tx + 16j of a 64 x 64
// tile, and output rows ty + 16i and value columns tx + 16j.

// s[i][j] += sum_{d < n} Q[ty + 16i][d] K[tx + 16j][d], Q and K tiles in
// shared memory with row pitches ldq and ldk
template <typename T>
__device__ __forceinline__ void qk_accumulate(float (&s)[4][4], const T* Qt, int ldq, const T* Kt, int ldk,
                                              int n, int tx, int ty) {
#pragma unroll 4
  for (int d = 0; d < n; ++d) {
    float qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = to_f(Qt[(ty + 16 * i) * ldq + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j) kv[j] = to_f(Kt[(tx + 16 * j) * ldk + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
  }
}

// the scaled logits of the key tile at k0 into Ss; keys at or past n_keys
// get -inf
__device__ __forceinline__ void store_logits(float* Ss, const float (&s)[4][4], int k0, int n_keys,
                                             float scale, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      Ss[(ty + 16 * i) * kSLd + c] = (k0 + c < n_keys) ? s[i][j] * scale : -INFINITY;
    }
}

// online softmax over one logits tile, four threads per row, 16 columns
// each: Ss becomes P = exp(s - m_new) rounded to the value type, and each
// row's running max, sum and rescale factor alpha = exp(m_old - m_new) are
// updated
template <typename T>
__device__ __forceinline__ void online_softmax(float* Ss, float* row_m, float* row_l, float* row_a, int tid) {
  const int r = tid >> 2;
  const int part = tid & 3;
  float* srow = Ss + r * kSLd + part * 16;
  float mx = -INFINITY;
#pragma unroll
  for (int c = 0; c < 16; ++c) mx = fmaxf(mx, srow[c]);
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  const float m_old = row_m[r];
  const float m_new = fmaxf(m_old, mx);  // finite: key 0 of tile 0 is never masked
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const float sv = srow[c];
    const float p = sv == -INFINITY ? 0.f : expf(sv - m_new);
    sum += p;
    srow[c] = to_f(from_f<T>(p));  // P in the value type for P V
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  __syncwarp();
  if (part == 0) {
    const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
    row_a[r] = alpha;
    row_l[r] = row_l[r] * alpha + sum;
    row_m[r] = m_new;
  }
}

// acc = acc * alpha + P V over the first n_cols columns of the V tile
template <typename T, int NJ>
__device__ __forceinline__ void pv_accumulate(float (&acc)[4][NJ], const float* Ss, const float* row_a,
                                              const T* Vt, int ldv, int n_cols, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float al = row_a[ty + 16 * i];
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] *= al;
  }
  for (int c = 0; c < kBK; ++c) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty + 16 * i) * kSLd + c];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      const float vv = d < n_cols ? to_f(Vt[c * ldv + d]) : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
    }
  }
}

// out[b, q0 + r, h, d0 + d] = acc / l into the contiguous [B, S, H, D] output
template <typename T, int NJ>
__device__ __forceinline__ void store_out(T* o, const float (&acc)[4][NJ], const float* row_l, int b, int q0,
                                          int h, int d0, int S, int H, int D, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qr = q0 + r;
    if (qr >= S) continue;
    const float l = row_l[r];
    T* orow = o + (((long long)b * S + qr) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = d0 + tx + 16 * j;
      if (d < D) orow[d] = from_f<T>(acc[i][j] / l);
    }
  }
}

// NJ: value columns per thread in P V, ceil(D / 16) rounded up to a bucket.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int S, int Skv, int H, int D, int n_keys, long long q_sb,
                 long long q_ss, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = tile_ld<T>(D);
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + kBQ * ld;
  T* Vs = Ks + kBK * ld;
  float* Ss = reinterpret_cast<float*>(Vs + kBK * ld);
  float* row_m = Ss + kBQ * kSLd;
  float* row_l = row_m + kBQ;
  float* row_a = row_l + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const int qr = q0 + r;
    Qs[r * ld + d] = qr < S ? qb[qr * q_ss + d] : from_f<T>(0.f);
  }
  if (tid < kBQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < n_keys; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, d = idx - r * D;
      const int kr = k0 + r;
      const bool ok = kr < n_keys;
      Ks[r * ld + d] = ok ? kb[kr * k_ss + d] : from_f<T>(0.f);
      Vs[r * ld + d] = ok ? vb[kr * v_ss + d] : from_f<T>(0.f);
    }
    __syncthreads();

    float s[4][4] = {};
    qk_accumulate(s, Qs, ld, Ks, ld, D, tx, ty);
    store_logits(Ss, s, k0, n_keys, scale, tx, ty);
    __syncthreads();
    online_softmax<T>(Ss, row_m, row_l, row_a, tid);
    __syncthreads();
    pv_accumulate<T, NJ>(acc, Ss, row_a, Vs, ld, D, tx, ty);
  }
  store_out<T, NJ>(o, acc, row_l, b, q0, h, 0, S, H, D, tx, ty);
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int Skv, int H,
           int D, int n_keys, const long long* st, float scale, cudaStream_t s) {
  auto kern = attention_kernel<T, NJ>;
  const size_t smem = smem_bytes<T>(D);
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, Skv, H, D, n_keys, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int S, int Skv, int H,
             int D, int n_keys, const long long* st, float scale, cudaStream_t s) {
  if (D <= 64) return launch<T, 4>(q, k, v, o, B, S, Skv, H, D, n_keys, st, scale, s);
  if (D <= 128) return launch<T, 8>(q, k, v, o, B, S, Skv, H, D, n_keys, st, scale, s);
  if (D <= 192) return launch<T, 12>(q, k, v, o, B, S, Skv, H, D, n_keys, st, scale, s);
  if (D <= 256) return launch<T, 16>(q, k, v, o, B, S, Skv, H, D, n_keys, st, scale, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Tensor-core route: bf16, one instance per head dim the port serves.
// Replaces, in bf16, `_kernel_whole_row` (flash_attention.py:87; ADM's
// 32x32 sites), `_kernel` (flash_attention.py:134; SD's 64x64 self-attention
// at D=40) and the packed-head `_kernel` (packed_attention.py:95; ADM's
// 16x16 and 8x8 sites, SD's D=80/160 levels and 77-key cross-attention;
// U-ViT's D=72 heads).
//
// Bound: the products (989 TFLOP/s dense bf16 with wgmma; mma.sync reaches a
// part of it) and, at D=40, the exponentials: one per logit for 80
// multiply-adds, so the SD call at batch 2 needs 268M of them, about 0.07 ms
// on the SFUs (16 a clock an SM), against 0.043 ms of products at the peak.
// The design, against what held the earlier kernels back:
//   * 16 query rows per warp and NW warps per block (128 rows, 8 warps, where
//     the grid still fills the card; 64 rows, 4 warps otherwise, and always at
//     D=256, whose 16 x 256 float32 accumulator is 128 registers a thread), so
//     each staged K/V tile serves NW warps;
//   * K and V tiles of 64 keys staged through a ring of two shared-memory
//     stages by 16-byte cp.async (zero-filled past the last key), so the next
//     tile loads while this one computes;
//   * fragments by ldmatrix (ldmatrix.trans for V as stored, [key][d]), rows
//     padded to an odd number of 16-byte chunks so the eight row addresses of
//     every 8x8 matrix fall in distinct banks at every pitch;
//   * D=40 and D=72: the k-depth of Q K^T zero-padded to 48 and 80 in shared
//     memory (the pad is written once; cp.async never touches it), P V over 5
//     and 9 n-tiles of 8; at D=72 (row pitch 88 elements, 11 16-byte chunks)
//     the rows of a qkv view sit 6912 bytes apart and its heads 144, both
//     16-byte multiples. Query rows past S (U-ViT's 258 = 2 x 128 + 2) are
//     staged as zeros and never stored;
//   * the softmax on the accumulators in registers: one exp2f per logit, P
//     rounded to bf16 and reused in registers as the A operand of P V; Q's
//     fragments are held in registers across key tiles where DP <= 128.
// Left for a later PR: wgmma (64-row warpgroup tiles, K straight from
// shared memory, no per-warp fragment loads of K and V), TMA with mbarriers
// and a producer warp, and a persistent grid.
// ---------------------------------------------------------------------------

template <int D>
struct Tc {
  static constexpr int DP = (D + 15) / 16 * 16;  // k-depth of Q K^T
  static constexpr int LD = DP + 8;              // row pitch (elements): an odd number of 16-byte chunks
  static constexpr int BK = 64;                  // keys per tile
  static constexpr int NT = BK / 8;              // key n-tiles of S
  static constexpr int NO = D / 8;               // value n-tiles of O
  static constexpr int KQ = DP / 16;             // k-steps of Q K^T
  static constexpr bool kQRegs = DP <= 128;      // Q fragments held in registers
  static constexpr size_t smem(int nw) { return (size_t)(16 * nw + 2 * 2 * BK) * LD * sizeof(__nv_bfloat16); }
};

// rows r0.. of a [rows, ld] shared tile from a row-strided source: ROWS rows
// of `cols` elements (a multiple of 16 bytes) by 16-byte cp.async; rows at or
// past n_valid are zero-filled
template <typename T, int ROWS, int NTH>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src, long long stride, int r0, int n_valid,
                                           int cols, int tid) {
  constexpr int V = 16 / sizeof(T);
  const int nc = cols / V;
  for (int idx = tid; idx < ROWS * nc; idx += NTH) {
    const int r = idx / nc, c = (idx - r * nc) * V;
    const int gr = r0 + r;
    const bool ok = gr < n_valid;
    cp_async16_zfill(dst + r * ld + c, src + (ok ? gr : 0) * stride + c, ok);
  }
}

// zero columns [c0, c1) of `rows` rows of pitch ld (16-byte steps)
template <typename T>
__device__ __forceinline__ void zero_cols(T* base, int rows, int ld, int c0, int c1, int tid, int nth) {
  constexpr int V = 16 / sizeof(T);
  const int nc = (c1 - c0) / V;
  for (int idx = tid; idx < rows * nc; idx += nth) {
    const int r = idx / nc, c = c0 + (idx - r * nc) * V;
    *reinterpret_cast<uint4*>(base + r * ld + c) = make_uint4(0, 0, 0, 0);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// at D <= 80, at least 16 warps an SM (two 8-warp blocks), so one block's
// softmax overlaps another's products
template <int D, int NW>
__global__ void __launch_bounds__(NW * 32, D <= 80 ? 16 / NW : 1)
attention_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int S, int H, int n_keys,
                    long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                    long long v_sb, long long v_ss, long long v_sh, float c) {
  using C = Tc<D>;
  constexpr int BQ = 16 * NW, NTH = 32 * NW, LD = C::LD, BK = C::BK, NT = C::NT, NO = C::NO, KQ = C::KQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LD;  // [2][BK][LD]
  __nv_bfloat16* Vs = Ks + 2 * BK * LD;  // [2][BK][LD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;

  if constexpr (C::DP != D) zero_cols(Qs, BQ + 2 * BK, LD, D, C::DP, tid, NTH);  // Q and both K stages
  const int n_tiles = (n_keys + BK - 1) / BK;
  stage_rows<__nv_bfloat16, BQ, NTH>(Qs, LD, qb, q_ss, q0, S, D, tid);
  stage_rows<__nv_bfloat16, BK, NTH>(Ks, LD, kb, k_ss, 0, n_keys, D, tid);
  stage_rows<__nv_bfloat16, BK, NTH>(Vs, LD, vb, v_ss, 0, n_keys, D, tid);
  cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};  // raw-logit running max of rows g and g + 8 of this warp
  float l_r[2] = {0.f, 0.f};              // this thread's share of the row sums
  uint32_t qf[C::kQRegs ? KQ : 1][4];
  // ldmatrix lane roles: A (Q) row lane % 16 at k-offset 8 (lane / 16); B (K)
  // key 8 (lane / 16) + lane % 8 at k-offset 8 ((lane / 8) % 2)
  const __nv_bfloat16* qa = Qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  const int kb_off = ((lane >> 4) * 8 + (lane & 7)) * LD + ((lane >> 3) & 1) * 8;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles) {  // the next tile into the other stage, freed at the end of the last iteration
      const int nx = (it + 1) * BK;
      stage_rows<__nv_bfloat16, BK, NTH>(Ks + (st ^ 1) * BK * LD, LD, kb, k_ss, nx, n_keys, D, tid);
      stage_rows<__nv_bfloat16, BK, NTH>(Vs + (st ^ 1) * BK * LD, LD, vb, v_ss, nx, n_keys, D, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + st * BK * LD;
    const __nv_bfloat16* Vt = Vs + st * BK * LD;
    if constexpr (C::kQRegs) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KQ; ++kk) ldmatrix_x4(qf[kk], qa + kk * 16);
      }
    }

    // S = Q K^T for this warp's 16 rows x 64 keys (raw logits)
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      uint32_t a[4];
      if constexpr (C::kQRegs) {
        a[0] = qf[kk][0], a[1] = qf[kk][1], a[2] = qf[kk][2], a[3] = qf[kk][3];
      } else {
        ldmatrix_x4(a, qa + kk * 16);
      }
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t bb[4];
        ldmatrix_x4(bb, Kt + jp * 16 * LD + kb_off + kk * 16);
        mma_bf16(s[2 * jp], a[0], a[1], a[2], a[3], bb[0], bb[1]);
        mma_bf16(s[2 * jp + 1], a[0], a[1], a[2], a[3], bb[2], bb[3]);
      }
    }

    // online softmax on the accumulators: s[j][0..1] row g, s[j][2..3] row
    // g+8, keys 8j + 2t + {0, 1}
    const int k0 = it * BK;
    if (k0 + BK > n_keys) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + j * 8 + 2 * t + (e & 1) >= n_keys) s[j][e] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    float alpha[2], mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);  // finite: key 0 of tile 0 is never masked
      alpha[r] = exp2f((m_r[r] - m_new) * c);    // 0 on the first tile (m_r = -inf)
      m_r[r] = m_new;
      mc[r] = m_new * c;
      l_r[r] *= alpha[r];
    }
    uint32_t pa[NT][2];  // P in bf16, packed pairs: [j][0] row g, [j][1] row g+8
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(fmaf(s[j][e], c, -mc[e >> 1]));  // masked: exp2(-inf) = 0
        l_r[e >> 1] += p[e];
      }
      pa[j][0] = pack_bf16(p[0], p[1]);
      pa[j][1] = pack_bf16(p[2], p[3]);
    }

    // O = O * alpha + P V; V fragments by ldmatrix.trans, two k-steps (32
    // keys, one per lane) of one value n-tile per load
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
#pragma unroll
    for (int kp = 0; kp < BK / 32; ++kp) {
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vt + (kp * 32 + lane) * LD + j * 8);
        const int k2 = 4 * kp;  // n-tile index of S for key 32 kp
        mma_bf16(acc[j], pa[k2][0], pa[k2][1], pa[k2 + 1][0], pa[k2 + 1][1], vf[0], vf[1]);
        mma_bf16(acc[j], pa[k2 + 2][0], pa[k2 + 2][1], pa[k2 + 3][0], pa[k2 + 3][1], vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage's readers are done before the next iteration refills it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qr = q0 + warp * 16 + g + 8 * r;
    if (qr >= S) continue;
    __nv_bfloat16* orow = o + (((long long)b * S + qr) * H + h) * D;
    const float l = l_r[r];
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) = pack_bf16(acc[j][2 * r] / l, acc[j][2 * r + 1] / l);
  }
}

template <int D, int NW>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int n_keys,
              const long long* st, float c, cudaStream_t s) {
  auto kern = attention_tc_kernel<D, NW>;
  const size_t smem = Tc<D>::smem(NW);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + 16 * NW - 1) / (16 * NW), H, B);
  kern<<<grid, NW * 32, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, H, n_keys, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], c);
  return (int)cudaGetLastError();
}

// 128-row blocks where they still give the 132 SMs a block each, 64 otherwise
template <int D>
int launch_tc_rows(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int n_keys,
                   const long long* st, float c, cudaStream_t s) {
  if constexpr (D <= 192) {
    if ((long long)((S + 127) / 128) * H * B >= 132) return launch_tc<D, 8>(q, k, v, o, B, S, H, n_keys, st, c, s);
  }
  return launch_tc<D, 4>(q, k, v, o, B, S, H, n_keys, st, c, s);
}

// ---------------------------------------------------------------------------
// Wide route: 256 < D <= 512 (the SD VAE's single-head mid attention, D=512,
// float32 as the VAE decodes; bf16 too). Replaces `_kernel`
// (flash_attention.py:134), the online-softmax loop JAX takes for the VAE's
// 4096 keys.
//
// Bound: the products, 4 S S_kv D operations (34.4 G at the VAE shape); in
// float32 each product is three TF32 products (495 / 3 TFLOP/s dense). With
// one head and one image, 64-row query tiles give 64 blocks for 132 SMs.
// The design:
//   * a block owns 64 query rows and ALL value columns (D zero-padded to
//     512 in shared memory): the logits of each 16-key tile are computed once
//     and shared by every column. Warp (rg, hf) of 8 computes rows 16 rg of
//     Q K^T over half hf of the head dim; the two halves meet in shared
//     memory, where 256 threads take the online softmax (4 a row) and write P;
//     then the same warp owns rows 16 rg x value columns 256 hf.. of P V
//     (a 16 x 256 float32 accumulator, 128 registers a thread);
//   * the keys are split over gridDim.y / H blocks (flash-decoding): each
//     split writes its partial (m, l, unnormalised O) to a float32 workspace,
//     and `attention_combine_kernel` merges them; the wrapper picks the split
//     count so the grid fills the card in whole waves;
//   * float32 by 3xTF32: x = big + small, both TF32 (cvt.rna), a product
//     taken as big*big + big*small + small*big on mma.m16n8k8.tf32 with
//     float32 accumulation: float32 accuracy (plain TF32 keeps 10 mantissa
//     bits and is not the same function). bf16 takes one m16n8k16 per step;
//   * Q staged once per block, K and V tiles by cp.async, the next K tile
//     loading during the softmax and P V, the next V tile during Q K^T.
// Left for a later PR: float32 needs 219 KB of shared memory (Q alone is
// 132 KB), so one block of 8 warps runs per SM with little latency hiding and
// four barriers per 16-key tile; V is split into TF32 halves at every use.
// ---------------------------------------------------------------------------

constexpr int kWQ = 64;        // query rows per block
constexpr int kWK = 16;        // keys per tile
constexpr int kWD = 512;       // head columns staged
constexpr int kWThreads = 256;
constexpr int kLDS = kWK + 4;  // pitch of the float32 logits halves

template <typename T>
struct Wide;
template <>
struct Wide<float> {
  static constexpr int LDQ = kWD + 4;  // Q, K: 2064 bytes, an odd number of 16-byte chunks (ldmatrix)
  static constexpr int LDV = kWD + 8;  // V: 520 = 8 mod 32 words, so the scalar B-fragment loads miss no bank
  static constexpr int LDP = kWK + 4;  // P halves: 80 bytes
  static constexpr int NP = 2;         // P as TF32 big and small halves
};
template <>
struct Wide<__nv_bfloat16> {
  static constexpr int LDQ = kWD + 8;  // 1040 bytes
  static constexpr int LDV = kWD + 8;
  static constexpr int LDP = kWK + 8;  // 48 bytes
  static constexpr int NP = 1;
};

template <typename T>
constexpr size_t wide_smem_bytes() {
  using W = Wide<T>;
  return (size_t)(kWQ + kWK) * W::LDQ * sizeof(T) + (size_t)kWK * W::LDV * sizeof(T) +
         (size_t)2 * kWQ * kLDS * sizeof(float) + (size_t)W::NP * kWQ * W::LDP * sizeof(T) +
         3 * kWQ * sizeof(float);
}

// s[n] += Q[16 rows][d0, d0 + 256) K[keys 8n..8n+7][same]^T, n = 0, 1;
// qa / ka: this lane's ldmatrix row address at column d0
__device__ __forceinline__ void wide_qk(float (&s)[2][4], const float* qa, const float* ka) {
#pragma unroll 4
  for (int kk = 0; kk < 32; ++kk) {
    uint32_t a[4], bq[4], ab[4], as[4], bb[4], bs[4];
    ldmatrix_x4(a, qa + kk * 8);
    ldmatrix_x4(bq, ka + kk * 8);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      split_tf32(a[i], ab[i], as[i]);
      split_tf32(bq[i], bb[i], bs[i]);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      mma_tf32(s[n], as[0], as[1], as[2], as[3], bb[2 * n], bb[2 * n + 1]);
      mma_tf32(s[n], ab[0], ab[1], ab[2], ab[3], bs[2 * n], bs[2 * n + 1]);
      mma_tf32(s[n], ab[0], ab[1], ab[2], ab[3], bb[2 * n], bb[2 * n + 1]);
    }
  }
}

__device__ __forceinline__ void wide_qk(float (&s)[2][4], const __nv_bfloat16* qa, const __nv_bfloat16* ka) {
#pragma unroll 4
  for (int kk = 0; kk < 16; ++kk) {
    uint32_t a[4], bq[4];
    ldmatrix_x4(a, qa + kk * 16);
    ldmatrix_x4(bq, ka + kk * 16);
    mma_bf16(s[0], a[0], a[1], a[2], a[3], bq[0], bq[1]);
    mma_bf16(s[1], a[0], a[1], a[2], a[3], bq[2], bq[3]);
  }
}

// the ldmatrix row addresses of wide_qk: A row lane % 16 at 16-byte chunk
// lane / 16; B key 8 (lane / 16) + lane % 8 at chunk (lane / 8) % 2
template <typename T>
__device__ __forceinline__ int wide_a_off(int lane, int ld) {
  return (lane & 15) * ld + (lane >> 4) * (16 / (int)sizeof(T));
}
template <typename T>
__device__ __forceinline__ int wide_b_off(int lane, int ld) {
  return ((lane >> 4) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * (16 / (int)sizeof(T));
}

// P of one row, 4 keys from c0, in shared memory: TF32 halves (float32) or bf16
__device__ __forceinline__ void wide_store_p(float* P, int r, int c0, const float (&p)[4]) {
  using W = Wide<float>;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t big, small;
    split_tf32(__float_as_uint(p[e]), big, small);
    P[r * W::LDP + c0 + e] = __uint_as_float(big);
    P[kWQ * W::LDP + r * W::LDP + c0 + e] = __uint_as_float(small);
  }
}
__device__ __forceinline__ void wide_store_p(__nv_bfloat16* P, int r, int c0, const float (&p)[4]) {
  using W = Wide<__nv_bfloat16>;
  *reinterpret_cast<uint2*>(P + r * W::LDP + c0) = make_uint2(pack_bf16(p[0], p[1]), pack_bf16(p[2], p[3]));
}

// acc[j] += P[16 rows][16 keys] V[16 keys][8j + 0..7], j < 32; P rows at Pw,
// V columns from Vw
__device__ __forceinline__ void wide_pv(float (&acc)[32][4], const float* Pw, const float* Vw, int lane) {
  using W = Wide<float>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < kWK / 8; ++ks) {
    uint32_t pb[4], ps[4];
    ldmatrix_x4(pb, Pw + (lane & 15) * W::LDP + ks * 8 + (lane >> 4) * 4);
    ldmatrix_x4(ps, Pw + kWQ * W::LDP + (lane & 15) * W::LDP + ks * 8 + (lane >> 4) * 4);
    const float* v0 = Vw + (ks * 8 + t) * W::LDV + g;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      uint32_t vb[2], vs[2];
      split_tf32(__float_as_uint(v0[j * 8]), vb[0], vs[0]);
      split_tf32(__float_as_uint(v0[4 * W::LDV + j * 8]), vb[1], vs[1]);
      mma_tf32(acc[j], ps[0], ps[1], ps[2], ps[3], vb[0], vb[1]);
      mma_tf32(acc[j], pb[0], pb[1], pb[2], pb[3], vs[0], vs[1]);
      mma_tf32(acc[j], pb[0], pb[1], pb[2], pb[3], vb[0], vb[1]);
    }
  }
}

__device__ __forceinline__ void wide_pv(float (&acc)[32][4], const __nv_bfloat16* Pw, const __nv_bfloat16* Vw,
                                        int lane) {
  using W = Wide<__nv_bfloat16>;
  uint32_t pa[4];
  ldmatrix_x4(pa, Pw + (lane & 15) * W::LDP + (lane >> 4) * 8);
  const __nv_bfloat16* v0 = Vw + (lane & 15) * W::LDV + (lane >> 4) * 8;
#pragma unroll
  for (int jp = 0; jp < 16; ++jp) {
    uint32_t vf[4];
    ldmatrix_x4_trans(vf, v0 + jp * 16);
    mma_bf16(acc[2 * jp], pa[0], pa[1], pa[2], pa[3], vf[0], vf[1]);
    mma_bf16(acc[2 * jp + 1], pa[0], pa[1], pa[2], pa[3], vf[2], vf[3]);
  }
}

// grid (ceil(S / 64), H * n_splits, B); split = blockIdx.y % n_splits takes
// keys [split * chunk, min(n_keys, (split + 1) * chunk)), chunk % 16 == 0.
// n_splits == 1: writes the output; otherwise the partials, ws_o [n_splits,
// B, H, S, D] (unnormalised O) and ws_ml [n_splits, B, H, S, 2] (raw-logit
// max, sum)
template <typename T>
__global__ void __launch_bounds__(kWThreads, 1)
attention_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ ws_o, float* __restrict__ ws_ml, int B, int S, int H, int D, int n_keys,
                      int chunk, int n_splits, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                      long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh, float c) {
  using W = Wide<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + kWQ * W::LDQ;
  T* Vs = Ks + kWK * W::LDQ;
  float* Sp = reinterpret_cast<float*>(Vs + kWK * W::LDV);  // [2][kWQ][kLDS]: the two head-dim halves
  T* Ps = reinterpret_cast<T*>(Sp + 2 * kWQ * kLDS);         // [NP][kWQ][LDP]
  float* row_m = reinterpret_cast<float*>(Ps + W::NP * kWQ * W::LDP);
  float* row_l = row_m + kWQ;
  float* row_a = row_l + kWQ;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 3, hf = warp >> 2;
  const int q0 = blockIdx.x * kWQ;
  const int split = blockIdx.y % n_splits, h = blockIdx.y / n_splits;
  const int b = blockIdx.z;
  const int k_begin = split * chunk;
  const int k_end = min(n_keys, k_begin + chunk);
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  if (D < kWD) {  // the head-dim padding of Q, K, V stays zero
    zero_cols(Qs, kWQ + kWK, W::LDQ, D, kWD, tid, kWThreads);
    zero_cols(Vs, kWK, W::LDV, D, kWD, tid, kWThreads);
  }
  if (tid < kWQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }
  stage_rows<T, kWQ, kWThreads>(Qs, W::LDQ, qb, q_ss, q0, S, D, tid);
  stage_rows<T, kWK, kWThreads>(Ks, W::LDQ, kb, k_ss, k_begin, k_end, D, tid);
  cp_async_commit();
  stage_rows<T, kWK, kWThreads>(Vs, W::LDV, vb, v_ss, k_begin, k_end, D, tid);
  cp_async_commit();

  float acc[32][4];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const T* qa = Qs + rg * 16 * W::LDQ + wide_a_off<T>(lane, W::LDQ) + hf * (kWD / 2);
  const T* ka = Ks + wide_b_off<T>(lane, W::LDQ) + hf * (kWD / 2);
  float* Sw = Sp + hf * kWQ * kLDS + (rg * 16 + g) * kLDS + 2 * t;
  const int sr = tid >> 2, sc = (tid & 3) * 4;  // softmax: row, first of 4 keys
  const int n_tiles = (k_end - k_begin + kWK - 1) / kWK;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * kWK;
    const bool more = it + 1 < n_tiles;
    cp_async_wait<1>();  // this K tile (and Q) landed; this V tile may be in flight
    __syncthreads();
    float s[2][4] = {};
    wide_qk(s, qa, ka);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      *reinterpret_cast<float2*>(Sw + n * 8) = make_float2(s[n][0], s[n][1]);
      *reinterpret_cast<float2*>(Sw + 8 * kLDS + n * 8) = make_float2(s[n][2], s[n][3]);
    }
    __syncthreads();  // K read, both logits halves written
    if (more) {
      stage_rows<T, kWK, kWThreads>(Ks, W::LDQ, kb, k_ss, k0 + kWK, k_end, D, tid);
      cp_async_commit();
    }

    // online softmax, four threads a row: P into shared memory, alpha and the
    // running max and sum per row
    float p[4], mx = -INFINITY;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = Sp[sr * kLDS + sc + e] + Sp[kWQ * kLDS + sr * kLDS + sc + e];
      p[e] = k0 + sc + e < k_end ? x : -INFINITY;
      mx = fmaxf(mx, p[e]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_old = row_m[sr];
    const float m_new = fmaxf(m_old, mx);  // finite: the first key of a split is never masked
    const float mc = m_new * c;
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = exp2f(fmaf(p[e], c, -mc));
      sum += p[e];
    }
    wide_store_p(Ps, sr, sc, p);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    __syncwarp();
    if ((tid & 3) == 0) {
      const float alpha = exp2f((m_old - m_new) * c);
      row_a[sr] = alpha;
      row_l[sr] = row_l[sr] * alpha + sum;
      row_m[sr] = m_new;
    }
    if (more) cp_async_wait<1>();  // this V tile landed; the next K tile may be in flight
    else cp_async_wait<0>();
    __syncthreads();

    const float al0 = row_a[rg * 16 + g], al1 = row_a[rg * 16 + g + 8];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      acc[j][0] *= al0;
      acc[j][1] *= al0;
      acc[j][2] *= al1;
      acc[j][3] *= al1;
    }
    wide_pv(acc, Ps + rg * 16 * W::LDP, Vs + hf * (kWD / 2), lane);
    __syncthreads();  // V, P and alpha read
    if (more) {
      stage_rows<T, kWK, kWThreads>(Vs, W::LDV, vb, v_ss, k0 + kWK, k_end, D, tid);
      cp_async_commit();
    }
  }

  const long long rows = (long long)B * H * S;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = rg * 16 + g + 8 * r;
    const int qr = q0 + lr;
    if (qr >= S) continue;
    const long long row = ((long long)b * H + h) * S + qr;  // (b, h, q) order of the workspace
    if (n_splits == 1) {
      T* orow = o + (((long long)b * S + qr) * H + h) * D;
      const float l = row_l[lr];
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int d = hf * (kWD / 2) + j * 8 + 2 * t;
        if (d < D) {
          orow[d] = from_f<T>(acc[j][2 * r] / l);
          orow[d + 1] = from_f<T>(acc[j][2 * r + 1] / l);
        }
      }
    } else {
      float* wrow = ws_o + (split * rows + row) * D;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int d = hf * (kWD / 2) + j * 8 + 2 * t;
        if (d < D) *reinterpret_cast<float2*>(wrow + d) = make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
      }
      if (hf == 0 && t == 0)
        *reinterpret_cast<float2*>(ws_ml + (split * rows + row) * 2) = make_float2(row_m[lr], row_l[lr]);
    }
  }
}

constexpr int kMaxSplits = 16;
constexpr int kCombineThreads = 128;

// one block per (b, h, q) row: out = sum_j w_j O_j / sum_j w_j l_j with
// w_j = exp((m_j - max_j m_j) / sqrt(d))
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
attention_combine_kernel(const float* __restrict__ ws_o, const float* __restrict__ ws_ml, T* __restrict__ o, int B,
                         int S, int H, int D, int n_splits, float c) {
  const long long rows = (long long)B * H * S;
  const long long row = blockIdx.x;
  const int qr = (int)(row % S);
  const int h = (int)((row / S) % H);
  const int b = (int)(row / ((long long)S * H));
  float w[kMaxSplits];
  float m = -INFINITY;
  for (int j = 0; j < n_splits; ++j) m = fmaxf(m, ws_ml[(j * rows + row) * 2]);
  float l = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxSplits; ++j) {
    if (j < n_splits) {
      w[j] = exp2f((ws_ml[(j * rows + row) * 2] - m) * c);
      l += w[j] * ws_ml[(j * rows + row) * 2 + 1];
    }
  }
  T* orow = o + (((long long)b * S + qr) * H + h) * D;
  for (int d = threadIdx.x; d < D; d += kCombineThreads) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j)
      if (j < n_splits) acc = fmaf(w[j], ws_o[(j * rows + row) * D + d], acc);
    orow[d] = from_f<T>(acc / l);
  }
}

template <typename T>
int launch_wide(const void* q, const void* k, const void* v, void* o, float* ws_o, float* ws_ml, int B, int S,
                int H, int D, int n_keys, int chunk, int n_splits, const long long* st, float c, cudaStream_t s) {
  if (D <= 256 || D > kWD || chunk % kWK != 0 || n_splits < 1 || n_splits > kMaxSplits ||
      (long long)(n_splits - 1) * chunk >= n_keys || (n_splits > 1 && (ws_o == nullptr || ws_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  auto kern = attention_wide_kernel<T>;
  constexpr size_t smem = wide_smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + kWQ - 1) / kWQ, H * n_splits, B);
  kern<<<grid, kWThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), ws_o,
      ws_ml, B, S, H, D, n_keys, chunk, n_splits, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      c);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_splits == 1) return (int)e;
  attention_combine_kernel<T><<<(unsigned int)((long long)B * H * S), kCombineThreads, 0, s>>>(
      ws_o, ws_ml, static_cast<T*>(o), B, S, H, D, n_splits, c);
  return (int)cudaGetLastError();
}

constexpr float kLog2e = 1.4426950408889634f;

}  // namespace

// Entry points, one a route. Strides in elements, (batch, seq, head) for q,
// k, v; the last axis is contiguous. n_keys = min(kv_len, Skv) >= 1. scale =
// 1/sqrt(D). Each launches its kernel or returns an error code; none falls
// back to another route.
#define DU_STRIDE_ARGS                                                                                     \
  long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb, \
      long long v_ss, long long v_sh

// bf16, D in {40, 64, 72, 80, 128, 160, 192, 256}, every row on 16 bytes
extern "C" int du_attention_tc(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int D,
                               int n_keys, DU_STRIDE_ARGS, float scale, void* stream) {
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  auto s = static_cast<cudaStream_t>(stream);
  const float c = scale * kLog2e;
  if (n_keys < 1) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 40: return launch_tc_rows<40>(q, k, v, o, B, S, H, n_keys, st, c, s);
    case 64: return launch_tc_rows<64>(q, k, v, o, B, S, H, n_keys, st, c, s);
    case 72: return launch_tc_rows<72>(q, k, v, o, B, S, H, n_keys, st, c, s);
    case 80: return launch_tc_rows<80>(q, k, v, o, B, S, H, n_keys, st, c, s);
    case 128: return launch_tc_rows<128>(q, k, v, o, B, S, H, n_keys, st, c, s);
    case 160: return launch_tc_rows<160>(q, k, v, o, B, S, H, n_keys, st, c, s);
    case 192: return launch_tc_rows<192>(q, k, v, o, B, S, H, n_keys, st, c, s);
    case 256: return launch_tc_rows<256>(q, k, v, o, B, S, H, n_keys, st, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// float32 or bf16, 256 < D <= 512, every row on 16 bytes; keys split into
// n_splits chunks of `chunk` keys (a multiple of 16; the last split holds at
// least one key); ws_o [n_splits, B, H, S, D] and ws_ml [n_splits, B, H, S, 2]
// float32 when n_splits > 1
extern "C" int du_attention_wide(const void* q, const void* k, const void* v, void* o, void* ws_o, void* ws_ml,
                                 int B, int S, int H, int D, int n_keys, int chunk, int n_splits, DU_STRIDE_ARGS,
                                 float scale, int dtype, void* stream) {
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  auto s = static_cast<cudaStream_t>(stream);
  const float c = scale * kLog2e;
  if (n_keys < 1 || D % 8 != 0) return (int)cudaErrorInvalidValue;
  float* wo = static_cast<float*>(ws_o);
  float* wml = static_cast<float*>(ws_ml);
  if (dtype == kF32) return launch_wide<float>(q, k, v, o, wo, wml, B, S, H, D, n_keys, chunk, n_splits, st, c, s);
  if (dtype == kBF16)
    return launch_wide<__nv_bfloat16>(q, k, v, o, wo, wml, B, S, H, D, n_keys, chunk, n_splits, st, c, s);
  return (int)cudaErrorInvalidValue;
}

// float32 or bf16, D <= 256, any row alignment
extern "C" int du_attention_cuda_core(const void* q, const void* k, const void* v, void* o, int B, int S, int Skv,
                                      int H, int D, int n_keys, DU_STRIDE_ARGS, float scale, int dtype,
                                      void* stream) {
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  auto s = static_cast<cudaStream_t>(stream);
  if (n_keys < 1 || D % 8 != 0) return (int)cudaErrorInvalidValue;
  if (dtype == kF32) return dispatch<float>(q, k, v, o, B, S, Skv, H, D, n_keys, st, scale, s);
  if (dtype == kBF16) return dispatch<__nv_bfloat16>(q, k, v, o, B, S, Skv, H, D, n_keys, st, scale, s);
  return (int)cudaErrorInvalidValue;
}
