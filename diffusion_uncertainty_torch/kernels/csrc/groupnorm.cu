// GroupNorm(+scale-shift)(+SiLU): one kernel on thread-block clusters, and a
// statistics + apply pair for groups too large for a cluster.
//
// Replaces the Pallas GroupNorm family of diffusion_uncertainty_tpu/ops/groupnorm.py:
// `_kernel` (:65-105), `_hwnc_kernel` (:304-381), `_stats_kernel` (:454-506)
// and `_tiled_kernel` (:578-620). Those are one op in four TPU tilings.
//
// Bound: device memory. GroupNorm reads x once and writes y once; the
// arithmetic is a few operations per element, far below the card's compute
// line.
//
// gn_fused (one launch, `_kernel`'s counterpart: the group held on chip).
//   A cluster of k <= 8 blocks serves one (n, group); block j holds rows
//   [j R, (j + 1) R) of the group's HW x gs slab in shared memory (at most
//   64 KB), copied with cp.async in 16-, 8- or 4-byte pieces as the group's
//   row width and alignment allow (a thread keeps one piece column of the
//   rows, so no index is divided in the loops). Each block sums x and x^2 in
//   float32; the cluster exchanges the partials through distributed shared
//   memory and every block adds them in rank order (deterministic, no
//   atomics), forms mean and 1/sqrt(E[x^2] - E[x]^2 + eps) as gn_stats does,
//   folds gamma, beta and the optional (1+s), t into per-channel A, B (read
//   in the type they come in: float32 or bfloat16), applies y = x A + B
//   (+SiLU) from shared memory and stores the pieces. x crosses device
//   memory once each way. The wrapper picks k (kernels/groupnorm.py
//   `route`): the fewest blocks that hold the group in 64 KB each, raised
//   until the grid of N G k blocks fills the 132 SMs.
//
// gn_stats + gn_apply (the pair, for groups beyond 8 blocks' 512 KB: the
//   VAE's float32 maps of 128^2 and more). `_stats_kernel` (:454-506) and
//   `_tiled_kernel` (:578-620) stream whole [tile, C] rows and keep
//   per-channel sums, folding channels into groups only at the end; the
//   pair does the same, spread over every SM.
//   Both launch by kernels/groupnorm.py `plan`. A row of x is read as
//   16-byte words (V elements), or as single elements where C's bytes or a
//   pointer are not a multiple of 16 (the scalar route). A thread keeps one
//   fixed word column of a row (`tile_w` threads a row, all of it where the
//   row has at most a block's words) and a row phase (`phases` rows a block
//   step); block (chunk, n) of `chunks` blocks an image takes rows chunk
//   * phases + phase + k * chunks * phases, so the whole grid sweeps each
//   image's rows in order, neighbouring threads on neighbouring addresses,
//   with no index divided in a loop and 32-bit offsets wherever the image
//   allows (`idx32`).
//   gn_stats  one block an SM at batch 1, 4 rows in flight a thread: sums x
//             and x^2 per channel in float32 registers, folds the row
//             phases in shared memory and each group's channels in order,
//             and writes the block's group partials to a float32 workspace
//             [N, chunks, G, 2]. The last block of an image to finish
//             (counted in a zeroed word that it resets) adds the image's
//             partials in a fixed order by chunk index, never by arrival,
//             so two calls give bit-identical A, B; then mean and
//             1/sqrt(E[x^2] - E[x]^2 + eps) as the JAX statistics path
//             (groupnorm.py:168-181, :490-494), and gamma, beta and the
//             optional (1+s), t folded into per-(n, c) A, B (float32 [N, C]).
//   gn_apply  32 blocks of 256 threads an SM, 2 rows in flight a thread:
//             y = x * A[n,c] + B[n,c] (+SiLU in float32) stored in x's type,
//             A and B of the thread's column in registers. It walks the
//             rows in the reverse of gn_stats's sweep, so the rows read
//             last, still in the 50 MB L2, are read first.
//   Divisions in the pair are __fdividef (2 ulp): the IEEE division's slow
//   path is a call, and its saved registers spilled.
//   Bound: device memory (gn_stats reads x once; gn_apply reads x and writes
//   y once).
#include "common.cuh"

using namespace du;

namespace {

constexpr int kStatsThreads = 512;  // threads of a gn_stats block (kernels/groupnorm.py STATS_THREADS)
constexpr int kApplyThreads = 256;  // threads of a gn_apply block (kernels/groupnorm.py APPLY_THREADS)
constexpr int kStatsRows = 4;  // rows a gn_stats thread has in flight
constexpr int kApplyRows = 2;  // rows a gn_apply thread has in flight
constexpr int kMaxPairC = 16384;  // channels the per-channel shared sums hold (kernels/groupnorm.py PAIR_MAX_C)
// the pair's largest dynamic shared memory: gn_stats's per-channel sums
constexpr int kPairMaxSmem = 2 * kMaxPairC * (int)sizeof(float);

// what turns an image's group sums into its per-channel A, B
struct Fold {
  const float* gamma;
  const float* beta;
  const float* scale;  // [N, C] or null
  const float* shift;
  float* A;
  float* B;
  float eps;
};

// The rows first, first + step, ... below end: how many.
__device__ __forceinline__ int row_count(int first, int end, int step) {
  return first < end ? (end - 1 - first) / step + 1 : 0;
}

// Block-wide: image n's group sums from its partials `part` ([chunks][G][2]),
// added in a fixed order by chunk index, then A, B of its C channels. red:
// kThreads floats, tot: 2 G floats of shared memory.
template <int kThreads>
__device__ void fold_image(const float* part, int chunks, int HW, int C, int G, int n, const Fold& f, float* red,
                           float* tot) {
  const int tid = threadIdx.x;
  const int E = 2 * G;
  if (E <= kThreads) {
    // thread (p, e) adds chunks p, p + P, ... of element e; then the P
    // phases are added in order
    const int P = kThreads / E;
    const int e = tid % E, p = tid / E;
    float s = 0.f;
    if (p < P) {
#pragma unroll 4
      for (int k = p; k < chunks; k += P) s += __ldcg(part + (size_t)k * E + e);
    }
    red[tid] = s;
    __syncthreads();
    if (tid < E) {
      float t = 0.f;
      for (int q = 0; q < P; ++q) t += red[q * E + tid];
      tot[tid] = t;
    }
  } else {
    for (int e = tid; e < E; e += kThreads) {
      float t = 0.f;
      for (int k = 0; k < chunks; ++k) t += __ldcg(part + (size_t)k * E + e);
      tot[e] = t;
    }
  }
  __syncthreads();
  const int gs = C / G;
  const float cnt = (float)HW * (float)gs;
  for (int c = tid; c < C; c += kThreads) {
    const int g = c / gs;
    const float mean = __fdividef(tot[2 * g], cnt);
    const float var = __fdividef(tot[2 * g + 1], cnt) - mean * mean;
    const float inv = rsqrtf(var + f.eps);
    const size_t nc = (size_t)n * C + c;
    float a = inv * f.gamma[c];
    float b = f.beta[c] - mean * a;
    if (f.scale != nullptr) {
      const float one_s = 1.f + f.scale[nc];
      a *= one_s;
      b = b * one_s + f.shift[nc];
    }
    f.A[nc] = a;
    f.B[nc] = b;
  }
}

// Block (chunk, n) sums its rows per channel and writes its group partials;
// the last block of image n to finish (counted in counters[n], which it
// resets for the next launch) folds the image's partials into A, B.
template <typename T, int V, typename I>
__global__ void __launch_bounds__(kStatsThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ ws, unsigned int* __restrict__ counters, Fold f, int HW,
                int C, int G, int tile_w, int phases) {
  extern __shared__ float chan[];  // [2][C]: the block's per-channel sums of x and x^2
  __shared__ float red[2][kStatsThreads * V];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int chunk = blockIdx.x, chunks = gridDim.x, n = blockIdx.y;
  const int cpr = C / V;  // words of a row
  const int col0 = tid % tile_w, phase = tid / tile_w;
  const int first = chunk * phases + phase;
  const int rstep = chunks * phases;
  const int cnt = phase < phases ? row_count(first, HW, rstep) : 0;
  const T* img = x + (size_t)n * HW * C;
  const I step = (I)rstep * C;
  for (int cb = 0; cb < cpr; cb += tile_w) {
    const int col = cb + col0;
    float s1[V], s2[V];
#pragma unroll
    for (int k = 0; k < V; ++k) s1[k] = s2[k] = 0.f;
    if (col < cpr) {
      I off = (I)first * C + (I)col * V;
      int i = 0;
      for (; i + kStatsRows <= cnt; i += kStatsRows) {
        float v[kStatsRows][V];
#pragma unroll
        for (int u = 0; u < kStatsRows; ++u) load_vec<T, V>(img + off + u * step, v[u]);
        off += kStatsRows * step;
#pragma unroll
        for (int u = 0; u < kStatsRows; ++u)
#pragma unroll
          for (int k = 0; k < V; ++k) {
            s1[k] += v[u][k];
            s2[k] = fmaf(v[u][k], v[u][k], s2[k]);
          }
      }
      for (; i < cnt; ++i) {
        float v[V];
        load_vec<T, V>(img + off, v);
        off += step;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          s1[k] += v[k];
          s2[k] = fmaf(v[k], v[k], s2[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      red[0][tid * V + k] = s1[k];
      red[1][tid * V + k] = s2[k];
    }
    __syncthreads();
    // thread (phase, col0) wrote channel col0 * V + k of the tile at
    // (phase * tile_w + col0) * V + k: add the phases in order
    const int tile_ch = min(tile_w, cpr - cb) * V;
    for (int j = tid; j < tile_ch; j += kStatsThreads) {
      float a = 0.f, b = 0.f;
      for (int p = 0; p < phases; ++p) {
        a += red[0][p * tile_w * V + j];
        b += red[1][p * tile_w * V + j];
      }
      chan[cb * V + j] = a;
      chan[C + cb * V + j] = b;
    }
    __syncthreads();
  }
  const int gs = C / G;
  float* part = ws + (size_t)n * chunks * 2 * G;  // image n's [chunks][G][2]
  for (int g = tid; g < G; g += kStatsThreads) {
    float a = 0.f, b = 0.f;
    for (int j = g * gs; j < (g + 1) * gs; ++j) {
      a += chan[j];
      b += chan[C + j];
    }
    part[((size_t)chunk * G + g) * 2] = a;
    part[((size_t)chunk * G + g) * 2 + 1] = b;
  }
  __threadfence();  // the partials are visible to every block before the count
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + n, 1u) == (unsigned int)(chunks - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  fold_image<kStatsThreads>(part, chunks, HW, C, G, n, f, &red[0][0], chan);
  if (tid == 0) counters[n] = 0;  // ready for the next launch on the stream
}

// y = x A + B (+SiLU) over the rows of block (chunk, n), both walked in the
// reverse of gn_stats's sweep
template <typename T, int V, typename I, bool kSilu>
__global__ void __launch_bounds__(kApplyThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ A, const float* __restrict__ B, T* __restrict__ y,
                int HW, int C, int tile_w, int phases) {
  const int tid = threadIdx.x;
  const int chunks = gridDim.x;
  const int blk = chunks * gridDim.y - 1 - (blockIdx.y * chunks + blockIdx.x);
  const int n = blk / chunks, chunk = blk - n * chunks;
  const int col0 = tid % tile_w, phase = tid / tile_w;
  if (phase >= phases) return;
  const int first = chunk * phases + phase;
  const int rstep = chunks * phases;
  const int cnt = row_count(first, HW, rstep);
  const int cpr = C / V;
  const size_t img = (size_t)n * HW * C;
  const T* xi = x + img;
  T* yi = y + img;
  const I st = -(I)rstep * C;
  for (int col = col0; col < cpr; col += tile_w) {
    float a[V], b[V];
    load_vec<float, V>(A + (size_t)n * C + col * V, a);
    load_vec<float, V>(B + (size_t)n * C + col * V, b);
    I off = (I)(first + (cnt - 1) * rstep) * C + (I)col * V;  // this thread's last row
    int i = 0;
    for (; i + kApplyRows <= cnt; i += kApplyRows) {
      float v[kApplyRows][V];
#pragma unroll
      for (int u = 0; u < kApplyRows; ++u) load_vec<T, V>(xi + off + u * st, v[u]);
#pragma unroll
      for (int u = 0; u < kApplyRows; ++u) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          float t = fmaf(v[u][k], a[k], b[k]);
          if (kSilu) t = __fdividef(t, 1.f + expf(-t));
          v[u][k] = t;
        }
        store_vec<T, V>(yi + off + u * st, v[u]);
      }
      off += kApplyRows * st;
    }
    for (; i < cnt; ++i) {
      float v[V];
      load_vec<T, V>(xi + off, v);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float t = fmaf(v[k], a[k], b[k]);
        if (kSilu) t = __fdividef(t, 1.f + expf(-t));
        v[k] = t;
      }
      store_vec<T, V>(yi + off, v);
      off += st;
    }
  }
}

constexpr int kFusedThreads = 256;
constexpr int kFusedMaxSmem = 64 * 1024 + 16;  // the slab (kernels/groupnorm.py GN_BLOCK_BYTES) + alignment

__device__ __forceinline__ float load_par(const void* p, size_t i, int code) {
  return code == kBF16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]) : static_cast<const float*>(p)[i];
}

// P bytes global -> shared, not waiting for the data
template <int P>
__device__ __forceinline__ void cp_async_piece(void* dst, const void* src) {
  if constexpr (P == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src), "n"(P));
}

template <int P>
struct Piece;
template <>
struct Piece<4> {
  using U = uint32_t;
};
template <>
struct Piece<8> {
  using U = uint2;
};
template <>
struct Piece<16> {
  using U = uint4;
};

template <typename T, int P>
__global__ void __launch_bounds__(kFusedThreads)
gn_fused_kernel(const T* __restrict__ x, const void* __restrict__ gamma, const void* __restrict__ beta,
                const void* __restrict__ scale, const void* __restrict__ shift, T* __restrict__ y, int HW, int C,
                int G, int rows_per_block, long long sc_stride, long long sh_stride, float eps, int g_code,
                int b_code, int ss_code, int silu) {
  constexpr int E = P / (int)sizeof(T);  // elements of a piece
  using U = typename Piece<P>::U;
  extern __shared__ __align__(16) unsigned char slab[];
  __shared__ float red1[kFusedThreads / 32], red2[kFusedThreads / 32];
  __shared__ float part[2];  // this block's sums, read by the whole cluster
  __shared__ float stat[2];  // mean, 1/sqrt(var + eps)
  __shared__ float coef[2][512];  // A, B of the group's channels (gs <= 512: the wrapper's rule)

  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank();
  const uint32_t k = gridDim.x;  // the cluster spans x
  const int g = blockIdx.y, n = blockIdx.z;
  const int gs = C / G;
  const int row_bytes = gs * (int)sizeof(T);
  const int ppr = row_bytes / P;  // pieces of a row
  const int row0 = (int)rank * rows_per_block;
  int rows = HW - row0;
  rows = rows < 0 ? 0 : (rows > rows_per_block ? rows_per_block : rows);
  const size_t pitch = (size_t)C * sizeof(T);
  const size_t gofs = ((size_t)n * HW + row0) * pitch + (size_t)g * row_bytes;
  const unsigned char* src = reinterpret_cast<const unsigned char*>(x) + gofs;

  // this thread's piece column and first row; rstep rows a step
  const int col = tid % ppr, r0 = tid / ppr, rstep = kFusedThreads / ppr;
  const bool active = r0 < rstep;
  if (active)
    for (int r = r0; r < rows; r += rstep) cp_async_piece<P>(slab + r * row_bytes + col * P, src + r * pitch + col * P);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // sums over the packed slab: 16-byte reads, then the pieces of the tail
  float s1 = 0.f, s2 = 0.f;
  const int bytes = rows * row_bytes;
  const int n16 = bytes / 16;
  for (int i = tid; i < n16; i += kFusedThreads) {
    float v[16 / sizeof(T)];
    load_vec<T, 16 / sizeof(T)>(reinterpret_cast<const T*>(slab + 16 * i), v);
#pragma unroll
    for (int e = 0; e < (int)(16 / sizeof(T)); ++e) {
      s1 += v[e];
      s2 += v[e] * v[e];
    }
  }
  for (int i = 16 * n16 / P + tid; i < bytes / P; i += kFusedThreads) {
    const T* p = reinterpret_cast<const T*>(slab + P * i);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float v = to_f(p[e]);
      s1 += v;
      s2 += v * v;
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const int lane = tid & 31, wid = tid >> 5;
  if (lane == 0) {
    red1[wid] = s1;
    red2[wid] = s2;
  }
  __syncthreads();
  if (tid == 0) {
    float a = 0.f, b = 0.f;
    for (int w = 0; w < kFusedThreads / 32; ++w) {
      a += red1[w];
      b += red2[w];
    }
    part[0] = a;
    part[1] = b;
  }
  cluster_arrive();
  cluster_wait();  // every block's partials are in place
  if (tid == 0) {
    float a = 0.f, b = 0.f;
    for (uint32_t r = 0; r < k; ++r) {  // rank order: the same sum in every block
      a += ld_cluster(map_rank(&part[0], r));
      b += ld_cluster(map_rank(&part[1], r));
    }
    const float cnt = (float)HW * (float)gs;
    const float mean = a / cnt;
    const float var = b / cnt - mean * mean;
    stat[0] = mean;
    stat[1] = rsqrtf(var + eps);
  }
  __syncthreads();
  cluster_arrive();  // this block is done reading its peers; the matching wait is before the exit
  const float mean = stat[0], inv = stat[1];
  for (int j = tid; j < gs; j += kFusedThreads) {
    const int c = g * gs + j;
    float a = inv * load_par(gamma, c, g_code);
    float b = load_par(beta, c, b_code) - mean * a;
    if (scale != nullptr) {
      const float one_s = 1.f + load_par(scale, (size_t)n * sc_stride + c, ss_code);
      a *= one_s;
      b = b * one_s + load_par(shift, (size_t)n * sh_stride + c, ss_code);
    }
    coef[0][j] = a;
    coef[1][j] = b;
  }
  __syncthreads();

  if (active) {
    float ca[E], cb[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      ca[e] = coef[0][col * E + e];
      cb[e] = coef[1][col * E + e];
    }
    unsigned char* dst = reinterpret_cast<unsigned char*>(y) + gofs;
    for (int r = r0; r < rows; r += rstep) {
      U raw = *reinterpret_cast<const U*>(slab + r * row_bytes + col * P);
      T* e_ = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float t = fmaf(to_f(e_[e]), ca[e], cb[e]);
        if (silu) t = t / (1.f + expf(-t));
        e_[e] = from_f<T>(t);
      }
      *reinterpret_cast<U*>(dst + r * pitch + col * P) = raw;
    }
  }
  cluster_wait();
}

template <typename T, int P>
int launch_fused_p(const void* x, const void* gamma, const void* beta, const void* scale, const void* shift, void* y,
                   int N, int HW, int C, int G, int k, int rows_per_block, long long sc_stride, long long sh_stride,
                   float eps, int g_code, int b_code, int ss_code, int silu, cudaStream_t stream) {
  auto kern = gn_fused_kernel<T, P>;
  static bool attr_set = false;  // one attribute call per instance
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kFusedMaxSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int smem = (rows_per_block * (C / G) * (int)sizeof(T) + 15) / 16 * 16;
  if (smem > kFusedMaxSmem) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned int)k, (unsigned int)G, (unsigned int)N);
  cfg.blockDim = dim3(kFusedThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned int)k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(x), gamma, beta, scale, shift,
                                     static_cast<T*>(y), HW, C, G, rows_per_block, sc_stride, sh_stride, eps, g_code,
                                     b_code, ss_code, silu);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fused(const void* x, const void* gamma, const void* beta, const void* scale, const void* shift, void* y,
                 int N, int HW, int C, int G, int k, int rows_per_block, int piece, long long sc_stride,
                 long long sh_stride, float eps, int g_code, int b_code, int ss_code, int silu, cudaStream_t stream) {
  if (piece == 16)
    return launch_fused_p<T, 16>(x, gamma, beta, scale, shift, y, N, HW, C, G, k, rows_per_block, sc_stride,
                                 sh_stride, eps, g_code, b_code, ss_code, silu, stream);
  if (piece == 8)
    return launch_fused_p<T, 8>(x, gamma, beta, scale, shift, y, N, HW, C, G, k, rows_per_block, sc_stride,
                                sh_stride, eps, g_code, b_code, ss_code, silu, stream);
  if (piece == 4)
    return launch_fused_p<T, 4>(x, gamma, beta, scale, shift, y, N, HW, C, G, k, rows_per_block, sc_stride,
                                sh_stride, eps, g_code, b_code, ss_code, silu, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int V, typename I>
int launch_stats_v(const void* x, float* ws, unsigned int* counters, const Fold& f, int N, int HW, int C, int G,
                   int chunks, int tile_w, int phases, cudaStream_t s) {
  auto kern = gn_stats_kernel<T, V, I>;
  static bool attr_set = false;  // one attribute call per instance: per-channel sums beyond 48 KB
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kPairMaxSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const size_t smem = 2 * (size_t)C * sizeof(float);
  kern<<<dim3((unsigned int)chunks, (unsigned int)N), kStatsThreads, smem, s>>>(static_cast<const T*>(x), ws, counters,
                                                                                f, HW, C, G, tile_w, phases);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_stats(const void* x, float* ws, unsigned int* counters, const Fold& f, int N, int HW, int C, int G,
                 int chunks, int tile_w, int phases, int vec, int idx32, cudaStream_t s) {
  constexpr int W = 16 / sizeof(T);
  if (vec && idx32) return launch_stats_v<T, W, int>(x, ws, counters, f, N, HW, C, G, chunks, tile_w, phases, s);
  if (vec) return launch_stats_v<T, W, long long>(x, ws, counters, f, N, HW, C, G, chunks, tile_w, phases, s);
  if (idx32) return launch_stats_v<T, 1, int>(x, ws, counters, f, N, HW, C, G, chunks, tile_w, phases, s);
  return launch_stats_v<T, 1, long long>(x, ws, counters, f, N, HW, C, G, chunks, tile_w, phases, s);
}

template <typename T, int V, typename I>
int launch_apply_v(const void* x, const float* A, const float* B, void* y, int N, int HW, int C, int chunks,
                   int tile_w, int phases, int silu, cudaStream_t s) {
  const dim3 grid((unsigned int)chunks, (unsigned int)N);
  auto xt = static_cast<const T*>(x);
  auto yt = static_cast<T*>(y);
  if (silu)
    gn_apply_kernel<T, V, I, true><<<grid, kApplyThreads, 0, s>>>(xt, A, B, yt, HW, C, tile_w, phases);
  else
    gn_apply_kernel<T, V, I, false><<<grid, kApplyThreads, 0, s>>>(xt, A, B, yt, HW, C, tile_w, phases);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_apply(const void* x, const float* A, const float* B, void* y, int N, int HW, int C, int chunks,
                 int tile_w, int phases, int silu, int vec, int idx32, cudaStream_t s) {
  constexpr int W = 16 / sizeof(T);
  if (vec && idx32) return launch_apply_v<T, W, int>(x, A, B, y, N, HW, C, chunks, tile_w, phases, silu, s);
  if (vec) return launch_apply_v<T, W, long long>(x, A, B, y, N, HW, C, chunks, tile_w, phases, silu, s);
  if (idx32) return launch_apply_v<T, 1, int>(x, A, B, y, N, HW, C, chunks, tile_w, phases, silu, s);
  return launch_apply_v<T, 1, long long>(x, A, B, y, N, HW, C, chunks, tile_w, phases, silu, s);
}

// the launch geometry of a pair kernel of `threads` threads, as
// kernels/groupnorm.py `plan` gives it
bool pair_geometry_ok(int N, int HW, int C, int chunks, int tile_w, int phases, int threads, int vec, int dtype) {
  const int V = vec ? (dtype == kF32 ? 4 : 8) : 1;
  return N >= 1 && N <= 65535 && HW >= 1 && C >= 1 && C <= kMaxPairC && C % V == 0 && chunks >= 1 && tile_w >= 1 &&
         phases >= 1 && tile_w * phases <= threads && (tile_w == C / V || phases == 1);
}

}  // namespace

// y = GN(x) (+scale-shift) (+SiLU) in one launch: k blocks (a cluster) per
// (n, group), rows_per_block rows of the group's slab each, copied in
// `piece`-byte pieces (16, 8 or 4: a divisor of the group's row bytes and of
// x's alignment). scale / shift rows n start at n * stride elements.
extern "C" int du_group_norm(const void* x, const void* gamma, const void* beta, const void* scale,
                             const void* shift, void* y, int N, int HW, int C, int G, int k, int rows_per_block,
                             int piece, long long sc_stride, long long sh_stride, float eps, int dtype, int g_code,
                             int b_code, int ss_code, int silu, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int esz = dtype == kF32 ? 4 : 2;
  if (G < 1 || C % G || C / G > 512 || k < 1 || k > 8 || (long long)k * rows_per_block < HW || piece < 1 ||
      (C / G * esz) % piece || (C / G * esz) / piece > kFusedThreads)
    return (int)cudaErrorInvalidValue;
  if (dtype == kF32)
    return launch_fused<float>(x, gamma, beta, scale, shift, y, N, HW, C, G, k, rows_per_block, piece, sc_stride,
                               sh_stride, eps, g_code, b_code, ss_code, silu, s);
  if (dtype == kBF16)
    return launch_fused<__nv_bfloat16>(x, gamma, beta, scale, shift, y, N, HW, C, G, k, rows_per_block, piece,
                                       sc_stride, sh_stride, eps, g_code, b_code, ss_code, silu, s);
  return (int)cudaErrorInvalidValue;
}

// A, B (float32 [N, C]) of GN over x [N, HW, C] in G groups: `chunks` blocks
// an image write their group partials to ws [N, chunks, G, 2], and the last
// of them folds the image's partials (counters: N words, zero before the
// launch and zero after it). vec: 16-byte words; idx32: offsets within an
// image fit in 32 bits.
extern "C" int du_gn_stats(const void* x, const void* gamma, const void* beta, const void* scale, const void* shift,
                           void* A, void* B, void* ws, void* counters, int N, int HW, int C, int G, int chunks,
                           int tile_w, int phases, float eps, int dtype, int vec, int idx32, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (G < 1 || C % G || counters == nullptr ||
      !pair_geometry_ok(N, HW, C, chunks, tile_w, phases, kStatsThreads, vec, dtype))
    return (int)cudaErrorInvalidValue;
  const Fold f{static_cast<const float*>(gamma), static_cast<const float*>(beta), static_cast<const float*>(scale),
               static_cast<const float*>(shift),  static_cast<float*>(A),           static_cast<float*>(B),
               eps};
  auto w = static_cast<float*>(ws);
  auto cnt = static_cast<unsigned int*>(counters);
  if (dtype == kF32) return launch_stats<float>(x, w, cnt, f, N, HW, C, G, chunks, tile_w, phases, vec, idx32, s);
  if (dtype == kBF16)
    return launch_stats<__nv_bfloat16>(x, w, cnt, f, N, HW, C, G, chunks, tile_w, phases, vec, idx32, s);
  return (int)cudaErrorInvalidValue;
}

// y = x A + B (+SiLU), `chunks` blocks an image walking its rows in reverse
extern "C" int du_gn_apply(const void* x, const void* A, const void* B, void* y, int N, int HW, int C, int chunks,
                           int tile_w, int phases, int silu, int dtype, int vec, int idx32, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (!pair_geometry_ok(N, HW, C, chunks, tile_w, phases, kApplyThreads, vec, dtype))
    return (int)cudaErrorInvalidValue;
  auto a = static_cast<const float*>(A);
  auto b = static_cast<const float*>(B);
  if (dtype == kF32) return launch_apply<float>(x, a, b, y, N, HW, C, chunks, tile_w, phases, silu, vec, idx32, s);
  if (dtype == kBF16)
    return launch_apply<__nv_bfloat16>(x, a, b, y, N, HW, C, chunks, tile_w, phases, silu, vec, idx32, s);
  return (int)cudaErrorInvalidValue;
}
