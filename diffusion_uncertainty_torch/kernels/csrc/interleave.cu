// Phase interleave: four NHWC inputs y_ab [N, H, W, C] to one output
// [N, 2H, 2W, C] with out[n, 2i+a, 2j+b] = y_ab[n, i, j]. Nearest-2x upsample
// is the same call with one input passed four times.
//
// Replaces the Pallas kernel `_ilv_kernel` of
// diffusion_uncertainty_tpu/ops/fused_upsample.py (:110-115), which writes the
// phase convs of the fused upsample+conv, and the nearest-upsampled skip path,
// of ADM's up ResBlocks.
//
// Bound: device memory, 1 read + 1 write of the output's size; no arithmetic.
// Design: a pure copy of raw bytes (bit-exact for any element type). Each
// thread owns one 16-byte run of C at one input pixel and writes it to the
// four output pixels of its phase positions; neighbouring threads move
// neighbouring bytes. Rows whose byte width is not a multiple of 16 use
// 2-byte or 4-byte words instead.
#include "common.cuh"

using namespace du;

namespace {

constexpr int kThreads = 256;

template <typename W_t>
__global__ void __launch_bounds__(kThreads)
interleave_kernel(const W_t* __restrict__ y00, const W_t* __restrict__ y01,
                  const W_t* __restrict__ y10, const W_t* __restrict__ y11,
                  W_t* __restrict__ out, int N, int H, int W, int CW) {
  // CW: words of type W_t per pixel
  const long long total = (long long)N * H * W * CW;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long row_out = 2LL * W * CW;  // words per output row
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < total; i += stride) {
    const int cw = (int)(i % CW);
    long long p = i / CW;
    const int j = (int)(p % W);
    p /= W;
    const int r = (int)(p % H);
    const long long n = p / H;
    W_t* o = out + (n * 2 * H + 2 * r) * row_out + (2LL * j) * CW + cw;
    o[0] = y00[i];
    o[CW] = y01[i];
    o[row_out] = y10[i];
    o[row_out + CW] = y11[i];
  }
}

template <typename W_t>
int launch(const void* a, const void* b, const void* c, const void* d, void* out, int N, int H,
           int W, int row_bytes, cudaStream_t s) {
  const int CW = row_bytes / (int)sizeof(W_t);
  const long long total = (long long)N * H * W * CW;
  interleave_kernel<W_t><<<stream_blocks(total, kThreads), kThreads, 0, s>>>(
      static_cast<const W_t*>(a), static_cast<const W_t*>(b), static_cast<const W_t*>(c),
      static_cast<const W_t*>(d), static_cast<W_t*>(out), N, H, W, CW);
  return (int)cudaGetLastError();
}

}  // namespace

// word: 16, 4 or 2 bytes per access; the caller checks that the pixel's byte
// width and every pointer are multiples of it.
extern "C" int du_interleave(const void* y00, const void* y01, const void* y10, const void* y11,
                             void* out, int N, int H, int W, int pixel_bytes, int word,
                             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (word == 16) return launch<uint4>(y00, y01, y10, y11, out, N, H, W, pixel_bytes, s);
  if (word == 4) return launch<uint32_t>(y00, y01, y10, y11, out, N, H, W, pixel_bytes, s);
  if (word == 2) return launch<uint16_t>(y00, y01, y10, y11, out, N, H, W, pixel_bytes, s);
  return (int)cudaErrorInvalidValue;
}
