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
// and its 77-key cross-attention).
//
// The TPU kernels hold one whole [bq, S_kv] float32 logits row tile in VMEM.
// That does not carry over: a 64 x 1024 float32 tile is 256 KB, over the
// 227 KB a Hopper block can have. Here each block owns one (b, h, 64-query
// tile) and walks K/V in 64-key tiles staged in shared memory with an online
// softmax (running max m, running sum l, rescale of the accumulator by
// exp(m_old - m_new)). Numerics follow the TPU kernels: float32 logits scaled
// by 1/sqrt(d), exact exp, P rounded to the value type before P V, float32
// accumulation, one division by l at the end, keys at or past kv_len masked
// to zero weight.
//
// Bound: at these shapes the work is 4*S^2*D operations per (b, h) against
// 2*S*D*3 bytes, far above the card's memory line, so the limit is compute.
// Three kernels. bfloat16 at D in {64, 128, 192, 256} (every ADM-128 site)
// runs both products on the tensor cores with mma.sync (below). float32, and
// other head dims up to 256 (SD's D=40/80/160, padded up to a register-tile
// bucket), run a CUDA-core kernel: FMAs out of shared memory (padded rows, no
// bank conflicts, 4x4 register tiles for Q K^T and 4 x D/16 for P V). Head
// dims in (256, 512] run a CUDA-core variant that splits the value columns
// over blocks (below). None uses wgmma or TMA yet. S_kv has no bound: the key
// loop is the same for 77 keys and for 4096.
#include "common.cuh"

#include <math.h>

using namespace du;

namespace {

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

// The steps both CUDA-core kernels share. Thread (tx, ty) of a 256-thread
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

// ---------------------------------------------------------------------------
// Wide heads, 256 < D <= 512 (the SD VAE's single-head mid attention, D=512).
// A 64-row tile of Q, K and V at D=512 no longer fits a block's shared memory
// in float32 (and the per-thread accumulator would be 4 x 32 floats), so:
//   * each block owns kDV = 256 value columns of one (b, h, 64-query tile);
//     blockIdx.y = h * n_vc + value chunk;
//   * Q K^T streams Q and K through shared memory in 64-column chunks, so no
//     tile holds a whole row; the logits are recomputed once per value chunk
//     (2x the Q K^T work at D=512; ROADMAP queue 2 lists its removal).
// The softmax, the masking and P V are the shared steps above.
// ---------------------------------------------------------------------------

constexpr int kDC = 64;   // columns of a Q / K chunk in Q K^T
constexpr int kDV = 256;  // value columns per block

template <typename T>
size_t wide_smem_bytes() {
  return (size_t)(kBQ + kBK) * tile_ld<T>(kDC) * sizeof(T) + (size_t)kBK * tile_ld<T>(kDV) * sizeof(T) +
         (size_t)kBQ * kSLd * sizeof(float) + 3 * kBQ * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ o, int S, int H, int D, int n_keys, int n_vc, long long q_sb,
                      long long q_ss, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                      long long v_sb, long long v_ss, long long v_sh, float scale) {
  constexpr int NJ = kDV / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldc = tile_ld<T>(kDC);
  const int ldv = tile_ld<T>(kDV);
  T* Qc = reinterpret_cast<T*>(smem_raw);
  T* Kc = Qc + kBQ * ldc;
  T* Vs = Kc + kBK * ldc;
  float* Ss = reinterpret_cast<float*>(Vs + kBK * ldv);
  float* row_m = Ss + kBQ * kSLd;
  float* row_l = row_m + kBQ;
  float* row_a = row_l + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y / n_vc;
  const int d0 = (blockIdx.y - h * n_vc) * kDV;
  const int b = blockIdx.z;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

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
    float s[4][4] = {};
    for (int c0 = 0; c0 < D; c0 += kDC) {
      __syncthreads();  // readers of the previous chunk (and of Ss, Vs) are done
      for (int idx = tid; idx < kBQ * kDC; idx += kThreads) {
        const int r = idx / kDC, c = idx - r * kDC;
        const int qr = q0 + r, kr = k0 + r, d = c0 + c;
        Qc[r * ldc + c] = (qr < S && d < D) ? qb[qr * q_ss + d] : from_f<T>(0.f);
        Kc[r * ldc + c] = (kr < n_keys && d < D) ? kb[kr * k_ss + d] : from_f<T>(0.f);
      }
      __syncthreads();
      qk_accumulate(s, Qc, ldc, Kc, ldc, kDC, tx, ty);
    }
    store_logits(Ss, s, k0, n_keys, scale, tx, ty);
    for (int idx = tid; idx < kBK * kDV; idx += kThreads) {
      const int r = idx / kDV, c = idx - r * kDV;
      const int kr = k0 + r, d = d0 + c;
      Vs[r * ldv + c] = (kr < n_keys && d < D) ? vb[kr * v_ss + d] : from_f<T>(0.f);
    }
    __syncthreads();
    online_softmax<T>(Ss, row_m, row_l, row_a, tid);
    __syncthreads();
    pv_accumulate<T, NJ>(acc, Ss, row_a, Vs, ldv, kDV, tx, ty);
  }
  store_out<T, NJ>(o, acc, row_l, b, q0, h, d0, S, H, D, tx, ty);
}

template <typename T>
int launch_wide(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int D,
                int n_keys, const long long* st, float scale, cudaStream_t s) {
  auto kern = attention_wide_kernel<T>;
  const size_t smem = wide_smem_bytes<T>();
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_vc = (D + kDV - 1) / kDV;
  dim3 grid((S + kBQ - 1) / kBQ, H * n_vc, B);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, D, n_keys, n_vc, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
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
  if (D <= 512) return launch_wide<T>(q, k, v, o, B, S, H, D, n_keys, st, scale, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bfloat16 tensor-core path: mma.sync m16n8k16 (bf16 in, float32 accumulate).
// Four warps per block; warp w owns query rows 16w..16w+15 of the 64-row
// tile. S = Q K^T stays in registers as mma accumulators; the online softmax
// works on them (each row's values are spread over the 4 threads of a quad);
// P is rounded to bf16 and re-used in registers as the A operand of P V. Q
// and K are staged row-major and V transposed, all with padded pitches so the
// 32-bit fragment loads hit 32 distinct banks. Needs D % 16 == 0 and 16-byte
// aligned rows.
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
constexpr size_t mma_smem_bytes() {
  return ((size_t)(kBQ + kBK) * (D + 8) + (size_t)D * (kBK + 8)) * sizeof(__nv_bfloat16);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
attention_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int S,
                     int H, int n_keys, long long q_sb, long long q_ss, long long q_sh,
                     long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                     long long v_sh, float scale) {
  constexpr int LD = D + 8;     // Q, K pitch (elements)
  constexpr int LDV = kBK + 8;  // V^T pitch
  constexpr int NC = D / 8;     // 16-byte chunks per row
  constexpr int NT = kBK / 8;   // key n-tiles of S
  constexpr int NO = D / 8;     // value n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBQ * LD;
  __nv_bfloat16* Vt = Ks + kBK * LD;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int idx = tid; idx < kBQ * NC; idx += kMmaThreads) {
    const int r = idx / NC, c = (idx - r * NC) * 8;
    const int qr = q0 + r;
    *reinterpret_cast<uint4*>(Qs + r * LD + c) =
        qr < S ? *reinterpret_cast<const uint4*>(qb + qr * q_ss + c) : zero;
  }

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};  // rows g and g + 8 of this warp
  float l_r[2] = {0.f, 0.f};              // this thread's share of the row sums
  const int row0 = warp * 16 + g;

  for (int k0 = 0; k0 < n_keys; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBK * NC; idx += kMmaThreads) {
      const int r = idx / NC, c = (idx - r * NC) * 8;
      const int kr = k0 + r;
      *reinterpret_cast<uint4*>(Ks + r * LD + c) =
          kr < n_keys ? *reinterpret_cast<const uint4*>(kb + kr * k_ss + c) : zero;
    }
    // V^T: neighbouring threads take neighbouring keys of one 8-column chunk,
    // so the transposed 2-byte stores land in distinct banks
    for (int idx = tid; idx < kBK * NC; idx += kMmaThreads) {
      const int c = (idx / kBK) * 8, r = idx % kBK;
      const int kr = k0 + r;
      uint4 raw = kr < n_keys ? *reinterpret_cast<const uint4*>(vb + kr * v_ss + c) : zero;
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(c + i) * LDV + r] = e[i];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* qa = Qs + row0 * LD + kk * 16 + 2 * t;
      const uint32_t a0 = ld32(qa), a1 = ld32(qa + 8 * LD), a2 = ld32(qa + 8), a3 = ld32(qa + 8 * LD + 8);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* kp = Ks + (j * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(s[j], a0, a1, a2, a3, ld32(kp), ld32(kp + 8));
      }
    }

    // online softmax on the accumulators: s[j][0..1] row g, s[j][2..3] row g+8,
    // columns 8j + 2t + {0, 1}
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        s[j][e] = col < n_keys ? s[j][e] * scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);  // finite: key 0 of tile 0 is never masked
      alpha[r] = m_r[r] == -INFINITY ? 0.f : expf(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= alpha[r];
    }
    uint32_t pa[NT][2];  // P in bf16, packed pairs: [j][0] row g, [j][1] row g+8
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = s[j][e] == -INFINITY ? 0.f : expf(s[j][e] - m_r[e >> 1]);
        l_r[e >> 1] += p[e];
      }
      pa[j][0] = pack_bf16(p[0], p[1]);
      pa[j][1] = pack_bf16(p[2], p[3]);
    }

    // O = O * alpha + P V
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a0 = pa[2 * kk][0], a1 = pa[2 * kk][1], a2 = pa[2 * kk + 1][0], a3 = pa[2 * kk + 1][1];
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const __nv_bfloat16* vp = Vt + (j * 8 + g) * LDV + kk * 16 + 2 * t;
        mma_bf16(acc[j], a0, a1, a2, a3, ld32(vp), ld32(vp + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qr = q0 + row0 + 8 * r;
    if (qr >= S) continue;
    __nv_bfloat16* orow = o + (((long long)b * S + qr) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) =
          pack_bf16(acc[j][2 * r] / l_r[r], acc[j][2 * r + 1] / l_r[r]);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
               int n_keys, const long long* st, float scale, cudaStream_t s) {
  auto kern = attention_mma_kernel<D>;
  constexpr size_t smem = mma_smem_bytes<D>();
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kMmaThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, H, n_keys, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale);
  return (int)cudaGetLastError();
}

// -1: no tensor-core instance for this head dim
int dispatch_mma(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int D,
                 int n_keys, const long long* st, float scale, cudaStream_t s) {
  switch (D) {
    case 64: return launch_mma<64>(q, k, v, o, B, S, H, n_keys, st, scale, s);
    case 128: return launch_mma<128>(q, k, v, o, B, S, H, n_keys, st, scale, s);
    case 192: return launch_mma<192>(q, k, v, o, B, S, H, n_keys, st, scale, s);
    case 256: return launch_mma<256>(q, k, v, o, B, S, H, n_keys, st, scale, s);
    default: return -1;
  }
}

}  // namespace

// strides: 9 element strides, (batch, seq, head) for q, k, v; the last axis is
// contiguous. n_keys = min(kv_len, Skv) >= 1. aligned: every row of q, k, v
// starts on 16 bytes (pointers and strides), which the tensor-core path needs.
// bfloat16 takes the tensor-core kernel where an instance exists for D and the
// rows are aligned, the CUDA-core kernel otherwise; float32 always the latter.
extern "C" int du_attention(const void* q, const void* k, const void* v, void* o, int B, int S,
                            int Skv, int H, int D, int n_keys, const long long* strides,
                            float scale, int dtype, int aligned, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (n_keys < 1 || D % 8 != 0) return (int)cudaErrorInvalidValue;
  if (dtype == kF32) return dispatch<float>(q, k, v, o, B, S, Skv, H, D, n_keys, strides, scale, s);
  if (dtype == kBF16) {
    if (aligned) {
      const int r = dispatch_mma(q, k, v, o, B, S, H, D, n_keys, strides, scale, s);
      if (r != -1) return r;
    }
    return dispatch<__nv_bfloat16>(q, k, v, o, B, S, Skv, H, D, n_keys, strides, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
