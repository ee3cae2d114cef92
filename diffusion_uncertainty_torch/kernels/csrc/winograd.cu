// 3x3 stride-1 SAME convolution by Winograd F(2x2, 3x3), with the bias and
// an optional residual add fused into the epilogue, on NHWC activations.
//
// Replaces `_kernel` and `_compute_tile` of
// diffusion_uncertainty_tpu/ops/winograd_conv.py (:154-296; the pallas_call at
// :340). Same function: for every 2x2 output tile, the 4x4 input patch d (zeros
// outside the image) is transformed as V = B^T d B in float32, with the same
// +-sums in the same order as :253-263, and rounded to bfloat16; for each of
// the 16 positions M = V . U with float32 accumulation, where U = G g G^T are
// the pre-transformed weights in bfloat16 (the TPU kernel's default MXU
// operand type, also for float32 activations); Y = A^T M A in float32
// (:273-278); then + bias, + residual, cast to the activation's type.
//
// Bound on this card: the work is 2 * 16 * tiles * C * K operations (tiles =
// N * H/2 * W/2) against the bytes of x, U, out and res once each, about
// 4 C K / (C + K) operations per byte of bf16 activations. At the CIFAR-10
// UNet's sites (C in {128, 256, 384, 512}, K in {128, 256}) that is 170-680,
// around and above the H100's 295 operations per byte of bf16 tensor-core
// work: the tensor cores (989 TFLOP/s) bound most shapes, the memory (3.35
// TB/s) the ones with C = 128. The design is a simple, correct one; it is far
// from that floor:
//
// * One block of 128 threads (4 warps) owns 32 output tiles x 32 output
//   channels and walks C in chunks of 32. Per chunk it starts the copy of
//   U[16][32 c][32 k] into shared memory with cp.async (16-byte pieces, no
//   registers), and meanwhile gathers the 4x4 patches of its tiles (thread =
//   two channels of four tiles: 16 paired loads each, a half-warp reads 32
//   consecutive channels of a pixel), transforms them in registers and stores
//   V[16][32 tiles][32 c] as bf16. Both tiles have a pitch of 40 elements
//   (80 bytes), so the ldmatrix row reads of a warp hit distinct banks.
// * The 16 products run on the tensor cores with mma.sync m16n8k16 (bf16 in,
//   float32 accumulate), A fragments by ldmatrix.x4 from V, B fragments by
//   ldmatrix.x4.trans from U as stored ([c][k]). Warp (wm, wn) owns tiles
//   16wm..16wm+15 and channels 16wn..16wn+15 of the block; a thread holds the
//   same (tile, channel) element of all 16 products (16 x 2 n-tiles x 4 =
//   128 float32 accumulators), so the output transform, bias and residual are
//   local to the thread.
// * What it pays: every input pixel is read by up to four overlapping
//   patches and once per 32-channel output block (K/32 times), from L2, and
//   each output-channel block transforms the same patches again; the
//   transform is scalar float32 work; the products wait for the patches (no
//   double buffering); mma.sync, not wgmma; 255 registers a thread, two
//   blocks (8 warps) an SM. Those, not the tensor cores, set its time.
//
// Requirements (checked by the wrapper, and again here): H, W even; C % 32
// == 0; K % 8 == 0; U padded with zeros to Kp = K rounded up to 32 columns.
#include "common.cuh"

using namespace du;

namespace {

constexpr int kTiles = 32;    // output tiles of a block
constexpr int kOut = 32;      // output channels of a block
constexpr int kCK = 32;       // input channels of one chunk
constexpr int kThreads = 128;
constexpr int kLd = 40;       // shared-memory pitch (elements) of V rows [c] and U rows [k]
constexpr int kItems = kTiles * (kCK / 2) / kThreads;  // (tile, channel pair) items of a thread
constexpr size_t kSmem = (size_t)16 * (kTiles + kCK) * kLd * sizeof(__nv_bfloat16);

// two consecutive elements <-> two floats (4- or 8-byte aligned)
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// V = B^T d B in place of d: rows first, then columns (the TPU kernel's order)
__device__ __forceinline__ void input_transform(float (&d)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float a0 = d[0][j] - d[2][j];
    const float a1 = d[1][j] + d[2][j];
    const float a2 = d[2][j] - d[1][j];
    const float a3 = d[1][j] - d[3][j];
    d[0][j] = a0;
    d[1][j] = a1;
    d[2][j] = a2;
    d[3][j] = a3;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float v0 = d[i][0] - d[i][2];
    const float v1 = d[i][1] + d[i][2];
    const float v2 = d[i][2] - d[i][1];
    const float v3 = d[i][1] - d[i][3];
    d[i][0] = v0;
    d[i][1] = v1;
    d[i][2] = v2;
    d[i][3] = v3;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
winograd_kernel(const T* __restrict__ x, const __nv_bfloat16* __restrict__ u, const float* __restrict__ bias,
                const T* __restrict__ res, T* __restrict__ out, int N, int H, int W, int C, int K, int Kp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [16][kTiles][kLd]: [p][tile][c]
  __nv_bfloat16* Us = Vs + 16 * kTiles * kLd;                       // [16][kCK][kLd]: [p][c][k]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const int tw = W >> 1;
  const long long tiles_img = (long long)(H >> 1) * tw;
  const long long n_tiles = (long long)N * tiles_img;
  const long long tile0 = (long long)blockIdx.x * kTiles;
  const int k0 = blockIdx.y * kOut;
  const long long row_pitch = (long long)W * C;

  // the loader's items: channels lc, lc + 1 of tiles (tid / 16) + 8i.
  // Each patch as the offset of its top-left pixel (row 2ty - 1, col 2tx - 1)
  // and a mask of the 16 pixels inside the image (0 for a tile past the end)
  const int lc = 2 * (tid & 15);
  long long patch_off[kItems];
  uint32_t patch_in[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long tile = tile0 + (tid >> 4) + 8 * i;
    patch_off[i] = 0;
    patch_in[i] = 0;
    if (tile < n_tiles) {
      const long long n = tile / tiles_img;
      const int r = (int)(tile - n * tiles_img);
      const int ty = r / tw, tx = r - (r / tw) * tw;
      patch_off[i] = ((n * H + 2 * ty - 1) * W + 2 * tx - 1) * (long long)C + lc;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int row = 2 * ty - 1 + a, col = 2 * tx - 1 + b;
          if (row >= 0 && row < H && col >= 0 && col < W) patch_in[i] |= 1u << (4 * a + b);
        }
    }
  }

  float acc[16][2][4];
#pragma unroll
  for (int p = 0; p < 16; ++p)
#pragma unroll
    for (int j = 0; j < 2; ++j) acc[p][j][0] = acc[p][j][1] = acc[p][j][2] = acc[p][j][3] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kCK) {
    __syncthreads();  // the previous chunk's readers are done
    // U[p][c0 + c][k0 .. k0 + 32) -> Us[p][c][0 .. 32), 16-byte pieces in flight
    for (int idx = tid; idx < 16 * kCK * (kOut / 8); idx += kThreads) {
      const int q = idx & 3, pc = idx >> 2;
      cp_async16(Us + pc * kLd + 8 * q, u + ((long long)(pc / kCK) * C + c0 + (pc % kCK)) * Kp + k0 + 8 * q);
    }
    // V of this thread's items
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int lt = (tid >> 4) + 8 * i;
      const T* xp = x + patch_off[i] + c0;
      float d0[4][4], d1[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          float2 v = make_float2(0.f, 0.f);
          if (patch_in[i] >> (4 * a + b) & 1u) v = load2(xp + a * row_pitch + (long long)b * C);
          d0[a][b] = v.x;
          d1[a][b] = v.y;
        }
      input_transform(d0);
      input_transform(d1);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          *reinterpret_cast<__nv_bfloat162*>(Vs + ((4 * a + b) * kTiles + lt) * kLd + lc) =
              __floats2bfloat162_rn(d0[a][b], d1[a][b]);
    }
    cp_async_wait_all();
    __syncthreads();

    // ldmatrix lanes: matrix lane / 8, its row lane % 8
    const int mrow = (lane & 7) + ((lane >> 3) & 1) * 8, mcol = (lane >> 4) * 8;
#pragma unroll
    for (int p = 0; p < 16; ++p) {
#pragma unroll
      for (int kk = 0; kk < kCK / 16; ++kk) {
        uint32_t a[4], b[4];
        // A: rows = tiles, cols = c; matrices (rows 0-7 | 8-15) x (cols 0-7 | 8-15)
        ldmatrix_x4(a, Vs + (p * kTiles + 16 * wm + mrow) * kLd + 16 * kk + mcol);
        // B from U stored [c][k]: matrices (c 0-7 | 8-15) x (k 0-7 | 8-15), transposed
        ldmatrix_x4_trans(b, Us + (p * kCK + 16 * kk + mrow) * kLd + 16 * wn + mcol);
        mma_bf16(acc[p][0], a[0], a[1], a[2], a[3], b[0], b[1]);
        mma_bf16(acc[p][1], a[0], a[1], a[2], a[3], b[2], b[3]);
      }
    }
  }

  // Y = A^T M A + bias (+ res): accumulators [p][j][2r + e] hold tile row
  // 16wm + g + 8r, output channel 16wn + 8j + 2t + e
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long tile = tile0 + 16 * wm + g + 8 * r;
    if (tile >= n_tiles) continue;
    const long long n = tile / tiles_img;
    const int rr = (int)(tile - n * tiles_img);
    const int ty = rr / tw, tx = rr - (rr / tw) * tw;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = k0 + 16 * wn + 8 * j + 2 * t;
      if (k >= K) continue;  // K % 8 == 0: both channels of the pair are in or out
      float y[2][2][2];      // [row a][col b][channel e]
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float m[16];
#pragma unroll
        for (int p = 0; p < 16; ++p) m[p] = acc[p][j][2 * r + e];
        float s0[4], s1[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          s0[b] = m[b] + m[4 + b] + m[8 + b];
          s1[b] = m[4 + b] - m[8 + b] - m[12 + b];
        }
        const float bk = bias[k + e];
        y[0][0][e] = (s0[0] + s0[1] + s0[2]) + bk;
        y[0][1][e] = (s0[1] - s0[2] - s0[3]) + bk;
        y[1][0][e] = (s1[0] + s1[1] + s1[2]) + bk;
        y[1][1][e] = (s1[1] - s1[2] - s1[3]) + bk;
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const long long off = (((n * H) + 2 * ty + a) * (long long)W + 2 * tx + b) * K + k;
          float o0 = y[a][b][0], o1 = y[a][b][1];
          if (res != nullptr) {
            const float2 rv = load2(res + off);
            o0 += rv.x;
            o1 += rv.y;
          }
          store2(out + off, o0, o1);
        }
    }
  }
}

template <typename T>
int launch(const void* x, const void* u, const void* bias, const void* res, void* out, int N, int H, int W,
           int C, int K, int Kp, cudaStream_t s) {
  auto kern = winograd_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  const long long n_tiles = (long long)N * (H / 2) * (W / 2);
  dim3 grid((unsigned int)((n_tiles + kTiles - 1) / kTiles), Kp / kOut);
  kern<<<grid, kThreads, kSmem, s>>>(static_cast<const T*>(x), static_cast<const __nv_bfloat16*>(u),
                                      static_cast<const float*>(bias), static_cast<const T*>(res),
                                      static_cast<T*>(out), N, H, W, C, K, Kp);
  return (int)cudaGetLastError();
}

}  // namespace

// x [N, H, W, C] and res [N, H, W, K] (or null) in the activation type, u
// [16, C, Kp] bfloat16, bias [K] float32, out [N, H, W, K]; all contiguous.
extern "C" int du_winograd(const void* x, const void* u, const void* bias, const void* res, void* out, int N,
                           int H, int W, int C, int K, int Kp, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (N < 1 || H % 2 || W % 2 || H < 2 || W < 2 || C % kCK || K % 8 || Kp % kOut || Kp < K)
    return (int)cudaErrorInvalidValue;
  if (dtype == kF32) return launch<float>(x, u, bias, res, out, N, H, W, C, K, Kp, s);
  if (dtype == kBF16) return launch<__nv_bfloat16>(x, u, bias, res, out, N, H, W, C, K, Kp, s);
  return (int)cudaErrorInvalidValue;
}
