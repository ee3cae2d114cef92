// 2x2 stride-2 average pool, NHWC to NHWC.
//
// Replaces the Pallas kernel `_kernel` of diffusion_uncertainty_tpu/ops/avgpool.py
// (:30-41), which pools the [H, W, N, C] view of ADM's down ResBlocks.
//
// Bound: device memory, 1 read + 1/4 write of the input; four adds and a
// multiply per output element. Design: each thread owns one 16-byte run of C
// of one output pixel, issues the four 16-byte loads of its 2x2 window
// (neighbouring threads read neighbouring addresses along C), sums in float32
// in the order ((x00 + x01) + (x10 + x11)) * 0.25 of the plain version, and
// stores in the input type. Channel counts that are not a multiple of the
// 16-byte width take the scalar path.
#include "common.cuh"

using namespace du;

namespace {

constexpr int kThreads = 256;

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
avgpool_kernel(const T* __restrict__ x, T* __restrict__ y, int N, int H, int W, int C) {
  const int Ho = H / 2, Wo = W / 2, CV = C / V;
  const long long total = (long long)N * Ho * Wo * CV;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < total; i += stride) {
    const int cv = (int)(i % CV);
    long long p = i / CV;
    const int wo = (int)(p % Wo);
    p /= Wo;
    const int ho = (int)(p % Ho);
    const long long n = p / Ho;
    const T* src = x + ((n * H + 2 * ho) * W + 2 * wo) * C + (long long)cv * V;
    float a[V], b[V], c[V], d[V], o[V];
    load_vec<T, V>(src, a);
    load_vec<T, V>(src + C, b);
    load_vec<T, V>(src + (long long)W * C, c);
    load_vec<T, V>(src + (long long)W * C + C, d);
#pragma unroll
    for (int k = 0; k < V; ++k) o[k] = ((a[k] + b[k]) + (c[k] + d[k])) * 0.25f;
    store_vec<T, V>(y + ((n * Ho + ho) * Wo + wo) * C + (long long)cv * V, o);
  }
}

template <typename T>
int launch(const void* x, void* y, int N, int H, int W, int C, int vec, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const long long outputs = (long long)N * (H / 2) * (W / 2) * C;
  if (vec) {
    avgpool_kernel<T, V><<<stream_blocks(outputs / V, kThreads), kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(y), N, H, W, C);
  } else {
    avgpool_kernel<T, 1><<<stream_blocks(outputs, kThreads), kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(y), N, H, W, C);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int du_avgpool(const void* x, void* y, int N, int H, int W, int C, int dtype, int vec,
                          void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch<float>(x, y, N, H, W, C, vec, s);
  if (dtype == kBF16) return launch<__nv_bfloat16>(x, y, N, H, W, C, vec, s);
  return (int)cudaErrorInvalidValue;
}
