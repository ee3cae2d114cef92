// Phase interleave and nearest-2x upsample, NHWC, one or two jobs a launch.
//
// Replaces the Pallas kernel `_ilv_kernel` of
// diffusion_uncertainty_tpu/ops/fused_upsample.py (:110-115), which writes the
// phase convs of the fused upsample+conv, and the nearest-upsampled skip path,
// of ADM's up ResBlocks.
//
// A job is a phase interleave, four inputs y_ab [N, H, W, C] to one output
// [N, 2H, 2W, C] with out[n, 2i+a, 2j+b] = y_ab[n, i, j], or a nearest
// upsample, one input x with out[n, 2i+a, 2j+b] = x[n, i, j]. Raw bytes are
// copied: bit-exact for any element type. ADM's up ResBlock runs its phase
// interleave and the upsample of its skip path as the two jobs of one launch
// (blockIdx.y is the job).
//
// Bound: device memory, each input byte read once and each output byte
// written once (2x the output's bytes for a phase job, 1.25x for a nearest
// job); no arithmetic.
//
// A grid-stride loop over the job's input words: each thread moves one 2-, 4-
// or 16-byte word (the widest dividing every pixel and pointer) to its four
// output positions, four loads for a phase job and one for a nearest job. The
// word index is split into (row, pixel, word) with 32-bit divisions wherever
// the job's words and the grid fit in 31 bits (every model's shapes), 64-bit
// ones beyond.
//
// A staged design (1-D bulk copies of whole input rows into shared memory
// behind an mbarrier, double-buffered, and bulk stores of whole output rows)
// was built and measured against this loop on an H100: it was slower in every
// form at the models' shapes, pairs included. Each byte is moved once, so
// staging adds a round trip through shared memory and gains no reuse.
#include <climits>

#include "common.cuh"

using namespace du;

namespace {

constexpr int kThreads = 256;

struct Job {
  const void* src[4];  // a nearest job reads src[0] only
  void* dst;
  int nsrc;  // 4: phase interleave; 1: nearest upsample
  int rows;  // input rows, N * H
  int W;     // input pixels a row
  int P;     // bytes a pixel
};

struct Jobs {
  Job job[2];
};

template <typename W_t, typename Idx>
__global__ void __launch_bounds__(kThreads) interleave_kernel(const __grid_constant__ Jobs J) {
  const Job& job = J.job[blockIdx.y];
  const W_t* y00 = static_cast<const W_t*>(job.src[0]);
  const W_t* y01 = static_cast<const W_t*>(job.src[1]);
  const W_t* y10 = static_cast<const W_t*>(job.src[2]);
  const W_t* y11 = static_cast<const W_t*>(job.src[3]);
  W_t* out = static_cast<W_t*>(job.dst);
  const int CW = job.P / (int)sizeof(W_t), W = job.W;
  const Idx total = (Idx)job.rows * W * CW;
  const Idx stride = (Idx)gridDim.x * kThreads;
  const long long row_out = 2LL * W * CW;  // words of an output row
  const bool nearest = job.nsrc == 1;
  for (Idx i = (Idx)blockIdx.x * kThreads + threadIdx.x; i < total; i += stride) {
    const Idx p = i / CW;
    const int cw = (int)(i - p * CW);
    const Idx r = p / W;
    const int j = (int)(p - r * W);
    W_t* o = out + 2 * (long long)r * row_out + 2LL * j * CW + cw;
    if (nearest) {
      const W_t v = y00[i];
      o[0] = v;
      o[CW] = v;
      o[row_out] = v;
      o[row_out + CW] = v;
    } else {
      o[0] = y00[i];
      o[CW] = y01[i];
      o[row_out] = y10[i];
      o[row_out + CW] = y11[i];
    }
  }
}

template <typename W_t>
int launch(const Jobs& J, int njobs, cudaStream_t s) {
  long long most = 0;
  for (int k = 0; k < njobs; ++k) {
    const long long words = (long long)J.job[k].rows * J.job[k].W * (J.job[k].P / (int)sizeof(W_t));
    most = words > most ? words : most;
  }
  const dim3 grid(stream_blocks(most, kThreads), njobs);
  if (most + (long long)grid.x * kThreads <= INT_MAX) {
    interleave_kernel<W_t, int><<<grid, kThreads, 0, s>>>(J);
  } else {
    interleave_kernel<W_t, long long><<<grid, kThreads, 0, s>>>(J);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// geom: four ints a job, {nsrc, rows (N*H), W, pixel bytes}; word: 16, 4 or 2
// bytes, dividing every pixel's byte width and every pointer. Job k reads a_k
// (nsrc 4: a_k, b_k, c_k, d_k) and writes out_k.
extern "C" int du_interleave(int word, int njobs, const int* geom, const void* a0, const void* b0, const void* c0,
                             const void* d0, void* out0, const void* a1, const void* b1, const void* c1,
                             const void* d1, void* out1, void* stream) {
  if (njobs < 1 || njobs > 2 || (word != 16 && word != 4 && word != 2)) return (int)cudaErrorInvalidValue;
  Jobs J = {};
  const void* src[2][4] = {{a0, b0, c0, d0}, {a1, b1, c1, d1}};
  void* dst[2] = {out0, out1};
  for (int k = 0; k < njobs; ++k) {
    Job& job = J.job[k];
    const int* g = geom + 4 * k;
    job.nsrc = g[0];
    if (job.nsrc != 4 && job.nsrc != 1) return (int)cudaErrorInvalidValue;
    for (int q = 0; q < 4; ++q) job.src[q] = src[k][q];
    job.dst = dst[k];
    job.rows = g[1];
    job.W = g[2];
    job.P = g[3];
    if (job.P % word) return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (word == 16) return launch<uint4>(J, njobs, s);
  if (word == 4) return launch<uint32_t>(J, njobs, s);
  return launch<uint16_t>(J, njobs, s);
}
