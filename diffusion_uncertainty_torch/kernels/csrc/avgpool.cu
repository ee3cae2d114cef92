// 2x2 stride-2 average pool, NHWC to NHWC, of one tensor or of two of one
// shape in one launch.
//
// Replaces the Pallas kernel `_kernel` of diffusion_uncertainty_tpu/ops/avgpool.py
// (:30-41), which pools the [H, W, N, C] view of ADM's down ResBlocks. ADM's
// down ResBlock pools its h and its skip x, of one shape, as the two jobs of
// one launch (blockIdx.y is the tensor).
//
// Bound: device memory, 1 read + 1/4 write of the input; four adds and a
// multiply per output element. Sums in float32 in the plain version's order,
// ((x00 + x01) + (x10 + x11)) * 0.25, and stores in the input type.
//
// A grid-stride loop over the output: each thread owns one 16-byte run of C
// of one output pixel (route "wide"), or one element where C's bytes or a
// pointer are not a multiple of 16 (route "narrow"). The output index is
// split into (row, pixel, run) with 32-bit divisions wherever the outputs and
// the grid fit in 31 bits (every model's shapes), 64-bit ones beyond. A
// staged design (bulk copies of input row pairs into shared memory, sums
// from there, bulk stores) was measured slower on an H100 in both forms.
#include <climits>

#include "common.cuh"

using namespace du;

namespace {

constexpr int kThreads = 256;

struct Pool {
  const void* src[2];
  void* dst[2];
  int rows;  // output rows, N * H / 2
  int Wo;    // output pixels a row
  int C;     // channels
};

template <typename T, int V, typename Idx>
__global__ void __launch_bounds__(kThreads) avgpool_kernel(const __grid_constant__ Pool J) {
  const T* x = static_cast<const T*>(J.src[blockIdx.y]);
  T* y = static_cast<T*>(J.dst[blockIdx.y]);
  const int Wo = J.Wo, C = J.C, CV = C / V, W = 2 * Wo;
  const Idx total = (Idx)J.rows * Wo * CV;
  const Idx stride = (Idx)gridDim.x * kThreads;
  for (Idx i = (Idx)blockIdx.x * kThreads + threadIdx.x; i < total; i += stride) {
    const Idx p = i / CV;
    const int cv = (int)(i - p * CV);
    const Idx r = p / Wo;  // output row over (n, ho)
    const int wo = (int)(p - r * Wo);
    const T* src = x + ((2 * (long long)r * W + 2 * wo) * C + cv * V);
    float a[V], b[V], c[V], d[V], o[V];
    load_vec<T, V>(src, a);
    load_vec<T, V>(src + C, b);
    load_vec<T, V>(src + (long long)W * C, c);
    load_vec<T, V>(src + (long long)W * C + C, d);
#pragma unroll
    for (int k = 0; k < V; ++k) o[k] = ((a[k] + b[k]) + (c[k] + d[k])) * 0.25f;
    store_vec<T, V>(y + (long long)p * C + cv * V, o);
  }
}

template <typename T, int V>
int launch(const Pool& J, int njobs, cudaStream_t s) {
  const long long runs = (long long)J.rows * J.Wo * (J.C / V);
  const dim3 grid(stream_blocks(runs, kThreads), njobs);
  if (runs + (long long)grid.x * kThreads <= INT_MAX) {
    avgpool_kernel<T, V, int><<<grid, kThreads, 0, s>>>(J);
  } else {
    avgpool_kernel<T, V, long long><<<grid, kThreads, 0, s>>>(J);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_type(bool wide, const Pool& J, int njobs, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  return wide ? launch<T, V>(J, njobs, s) : launch<T, 1>(J, njobs, s);
}

}  // namespace

// wide 1: 16-byte runs (the caller checks that C's bytes and every pointer
// are multiples of 16); 0: one element a thread. geom: {N, H, W, C, dtype}.
// Tensor k pools x_k into y_k.
extern "C" int du_avgpool(int wide, int njobs, const int* geom, const void* x0, void* y0, const void* x1, void* y1,
                          void* stream) {
  if (njobs < 1 || njobs > 2) return (int)cudaErrorInvalidValue;
  Pool J = {};
  J.src[0] = x0;
  J.src[1] = x1;
  J.dst[0] = y0;
  J.dst[1] = y1;
  const int N = geom[0], H = geom[1], W = geom[2], C = geom[3], dtype = geom[4];
  J.rows = N * (H / 2);
  J.Wo = W / 2;
  J.C = C;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    if (wide && C % 4) return (int)cudaErrorInvalidValue;
    return launch_type<float>(wide, J, njobs, s);
  }
  if (dtype == kBF16) {
    if (wide && C % 8) return (int)cudaErrorInvalidValue;
    return launch_type<__nv_bfloat16>(wide, J, njobs, s);
  }
  return (int)cudaErrorInvalidValue;
}
