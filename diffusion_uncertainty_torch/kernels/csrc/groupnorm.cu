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
//   VAE's float32 maps of 128^2 and more):
//   gn_stats  reads NHWC x once and reduces sum and sum^2 in float32 per
//             (n, group), then folds gamma, beta and the optional (1+s), t
//             into per-(n, c) coefficients A, B (float32 [N, C]), with the
//             E[x^2] - E[x]^2 variance the JAX statistics path uses
//             (groupnorm.py:168-181).
//   gn_apply  one streaming pass: y = x * A[n,c] + B[n,c], optional SiLU,
//             float32 FMA in registers, store in the input type.
//   gn_stats runs one block per (n, group), so no reduction crosses blocks
//   and the result does not depend on scheduling; 16-byte loads along C when
//   the group's width allows them, warp-shuffle reductions. gn_apply is a
//   grid-stride loop of 16-byte loads and stores along C; A and B are tiny
//   and stay in L1/L2. Any C with C % G == 0 is taken: narrow or odd group
//   widths take the scalar path.
#include "common.cuh"

using namespace du;

namespace {

constexpr int kStatsThreads = 512;
constexpr int kApplyThreads = 256;

template <typename T, int V>
__global__ void __launch_bounds__(kStatsThreads)
gn_stats_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, const float* __restrict__ scale,
                const float* __restrict__ shift, float* __restrict__ A,
                float* __restrict__ B, int HW, int C, int G, float eps) {
  const int g = blockIdx.x;
  const int n = blockIdx.y;
  const int gs = C / G;
  const T* base = x + (size_t)n * HW * C + (size_t)g * gs;

  float s1 = 0.f, s2 = 0.f;
  const int vpr = gs / V;  // accesses per row of the group
  const long long total = (long long)HW * vpr;
#pragma unroll 4
  for (long long i = threadIdx.x; i < total; i += kStatsThreads) {
    const long long row = i / vpr;
    const int col = (int)(i - row * vpr) * V;
    float v[V];
    load_vec<T, V>(base + row * C + col, v);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      s1 += v[k];
      s2 += v[k] * v[k];
    }
  }

  __shared__ float r1[kStatsThreads / 32];
  __shared__ float r2[kStatsThreads / 32];
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  if (lane == 0) {
    r1[wid] = s1;
    r2[wid] = s2;
  }
  __syncthreads();
  if (wid == 0) {
    s1 = lane < kStatsThreads / 32 ? r1[lane] : 0.f;
    s2 = lane < kStatsThreads / 32 ? r2[lane] : 0.f;
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      r1[0] = s1;
      r2[0] = s2;
    }
  }
  __syncthreads();

  const float cnt = (float)HW * (float)gs;
  const float mean = r1[0] / cnt;
  const float var = r2[0] / cnt - mean * mean;
  const float inv = rsqrtf(var + eps);
  for (int j = threadIdx.x; j < gs; j += kStatsThreads) {
    const int c = g * gs + j;
    const size_t nc = (size_t)n * C + c;
    float a = inv * gamma[c];
    float b = beta[c] - mean * a;
    if (scale != nullptr) {
      const float one_s = 1.f + scale[nc];
      a *= one_s;
      b = b * one_s + shift[nc];
    }
    A[nc] = a;
    B[nc] = b;
  }
}

template <typename T, int V, bool kSilu>
__global__ void __launch_bounds__(kApplyThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ A,
                const float* __restrict__ B, T* __restrict__ y, long long n_access,
                int C, long long HWC) {
  const long long stride = (long long)gridDim.x * kApplyThreads;
  for (long long i = (long long)blockIdx.x * kApplyThreads + threadIdx.x; i < n_access;
       i += stride) {
    const long long e = i * V;
    const long long n = e / HWC;
    const int c = (int)(e % C);
    const float* a = A + n * C + c;
    const float* b = B + n * C + c;
    float v[V];
    load_vec<T, V>(x + e, v);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float t = fmaf(v[k], a[k], b[k]);
      if (kSilu) t = t / (1.f + expf(-t));
      v[k] = t;
    }
    store_vec<T, V>(y + e, v);
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

template <typename T>
int launch_stats(const void* x, const float* gamma, const float* beta, const float* scale,
                 const float* shift, float* A, float* B, int N, int HW, int C, int G,
                 float eps, int vec, cudaStream_t stream) {
  dim3 grid(G, N);
  constexpr int V = 16 / sizeof(T);
  if (vec)
    gn_stats_kernel<T, V><<<grid, kStatsThreads, 0, stream>>>(
        static_cast<const T*>(x), gamma, beta, scale, shift, A, B, HW, C, G, eps);
  else
    gn_stats_kernel<T, 1><<<grid, kStatsThreads, 0, stream>>>(
        static_cast<const T*>(x), gamma, beta, scale, shift, A, B, HW, C, G, eps);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_apply_v(const void* x, const float* A, const float* B, void* y, long long total,
                   int C, long long HWC, int silu, cudaStream_t stream) {
  const long long n_access = total / V;
  const unsigned int blocks = stream_blocks(n_access, kApplyThreads);
  if (silu)
    gn_apply_kernel<T, V, true><<<blocks, kApplyThreads, 0, stream>>>(
        static_cast<const T*>(x), A, B, static_cast<T*>(y), n_access, C, HWC);
  else
    gn_apply_kernel<T, V, false><<<blocks, kApplyThreads, 0, stream>>>(
        static_cast<const T*>(x), A, B, static_cast<T*>(y), n_access, C, HWC);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_apply(const void* x, const float* A, const float* B, void* y, long long total,
                 int C, long long HWC, int silu, int vec, cudaStream_t stream) {
  if (vec) return launch_apply_v<T, 16 / sizeof(T)>(x, A, B, y, total, C, HWC, silu, stream);
  return launch_apply_v<T, 1>(x, A, B, y, total, C, HWC, silu, stream);
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

extern "C" int du_gn_stats(const void* x, const void* gamma, const void* beta,
                           const void* scale, const void* shift, void* A, void* B, int N,
                           int HW, int C, int G, float eps, int dtype, int vec,
                           void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto g = static_cast<const float*>(gamma);
  auto bt = static_cast<const float*>(beta);
  auto sc = static_cast<const float*>(scale);
  auto sh = static_cast<const float*>(shift);
  auto a = static_cast<float*>(A);
  auto b = static_cast<float*>(B);
  if (dtype == kF32) return launch_stats<float>(x, g, bt, sc, sh, a, b, N, HW, C, G, eps, vec, s);
  if (dtype == kBF16)
    return launch_stats<__nv_bfloat16>(x, g, bt, sc, sh, a, b, N, HW, C, G, eps, vec, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int du_gn_apply(const void* x, const void* A, const void* B, void* y, long long total,
                           int C, long long HWC, int silu, int dtype, int vec, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const float*>(A);
  auto b = static_cast<const float*>(B);
  if (dtype == kF32) return launch_apply<float>(x, a, b, y, total, C, HWC, silu, vec, s);
  if (dtype == kBF16) return launch_apply<__nv_bfloat16>(x, a, b, y, total, C, HWC, silu, vec, s);
  return (int)cudaErrorInvalidValue;
}
