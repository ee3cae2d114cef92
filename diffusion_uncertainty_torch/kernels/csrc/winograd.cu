// 3x3 stride-1 SAME convolution by Winograd F(2x2, 3x3), with the bias and
// an optional residual add fused into the epilogue, on NHWC activations.
//
// Replaces `_kernel` and `_compute_tile` of
// diffusion_uncertainty_tpu/ops/winograd_conv.py (:154-296; the pallas_call at
// :340). Same function and rounding points: for every 2x2 output tile, the
// 4x4 input patch d (zeros outside the image) is transformed as V = B^T d B in
// float32, rows first and then columns with the +-sums of :253-263, and
// rounded to bfloat16; for each of the 16 positions M = V . U with float32
// accumulation, where U = G g G^T are the pre-transformed weights in bfloat16
// (the TPU kernel's default MXU operand type, also for float32 activations);
// Y = A^T M A in float32 (:273-278), then + bias, + residual, cast to the
// activation's type.
//
// Bound on this card: the work is 2 * 16 * tiles * C * K operations (tiles =
// N * H/2 * W/2) against the bytes of x, U, out and res once each. At the
// CIFAR-10 UNet's sites (C in {128, 256, 384, 512}, K in {128, 256}) that is
// 170-680 operations per byte: the tensor cores (989 TFLOP/s) bound most
// shapes, the memory (3.35 TB/s) the ones with C = 128.
//
// Design (sm_90a):
//
// * Work split. A cluster of 4 blocks owns 64 output tiles x 128 output
//   channels and walks C in chunks of 32. Block r of the cluster computes the
//   4 positions of column r of the 4x4 grid (positions 4a + r, a = 0..3) for
//   all 128 channels, so the accumulators of a (tile, channel) pair's 16
//   positions are spread over the 4 blocks: 4 x 64 x 128 float32 per block,
//   128 registers a thread in its two consumer warpgroups. Column r of V
//   needs two columns of the row-transformed patch, so a block computes 12
//   of the 32 +-sums of a patch's transform (the row sums of columns 1 and 2
//   are computed by two blocks each): each (patch, input channel) is
//   gathered and transformed 1.5 times per cluster, once per 128 output
//   channels, where the previous kernel did it once per 32 output channels.
//   Per output element (tile, k): 1.5 / 128 transforms of each of its C
//   input-channel patches, against 1 / 32 before.
// * Staging. Each input pixel crosses from device memory once per block and
//   chunk: the block's window of (2 tr + 2) x (2 tc + 2) pixels of nb images
//   (tr x tc tiles of nb images, tr tc nb = 64) and 32 channels is one TMA
//   load through a 4-D tensor map over NHWC x, whose zero fill outside the
//   tensor is the SAME padding (and the ragged edge of the tile grid). The
//   map swizzles the 64- (bf16) or 128-byte (float32) pixel rows, so the
//   transform's reads of 8 tiles' pixels meet at most 2 to a bank. U's chunk
//   for the block (4 positions x 32 c x 128 k, 32 KB, pre-tiled by
//   `weight_transform` in the wgmma core-matrix order) is one bulk copy.
// * Pipeline, by warp specialisation on mbarriers, persistent: the grid is
//   as many clusters as the card holds at once, each walking work items
//   (64 tiles x 128 output channels) cid, cid + clusters, ... with one
//   running chunk count, so the pipeline does not drain between items.
//   Warp 8 (producer) issues the TMA loads of the window (2 stages in bf16,
//   1 in float32) and the U copies into 2 V/U stages (1 for float32 windows
//   of 4x4 maps). Warpgroups 0 and 1 (consumers) issue 8 wgmma m64n64k16 a
//   chunk each (4 positions x 2 k-steps; A = V, B = their 64 channels of U,
//   both from shared memory) and, while those run, transform chunk i+1's
//   window into the other V stage (V[4][64 tiles][32 c], bf16, core-matrix
//   order; warp w: channels 8 (w % 4).., 4 tiles; the window offsets are
//   recomputed each chunk, as holding them would spill). Where a block's
//   tiles are 4 rows of 16 or 8 rows of 8 of one image (32x32 and 16x16
//   maps), a thread's 4 tiles are one column of vertically adjacent tiles
//   and each reuses the last two patch rows of the one above: 20 loads of
//   the window instead of 32. So the TMA of chunk i+1 and its transform
//   overlap the products of chunk i.
// * Epilogue, by warps 9-11 while the consumers go on with the next item.
//   Each consumer thread folds its 4 positions into the two row sums of the
//   output transform (s0 = m0 + m1 + m2, s1 = m1 - m2 - m3 of column r, the
//   reference's order) and stores them into the block that owns the
//   channel (block q: channels 32q..32q+31): with st.async to a peer,
//   counted as transaction bytes on its barrier, with plain stores to its
//   own block (the two-stage instances), then arrives; the owner's 3
//   epilogue warps read the sums into registers, release the buffer to the
//   writers (remote mbarrier arrivals), then finish Y = (s[0] + s[1] + s[2],
//   s[1] - s[2] - s[3]) per row, add bias and residual and store 8 channels
//   (16 bytes in bf16) a thread and pixel.
//
// Where the time goes (scripts/bench_winograd.py times the kernel without
// its transform and without its products): not in the tensor cores. Per
// 32-channel chunk a block takes 54 KB into shared memory (a 22 KB window at
// 32x32 maps, 32 KB of U) and its wgmma read 64 KB of operands from it (A
// and B both from shared memory); the transform is CUDA-core work in warps
// that keep 128 of their 168 registers for accumulators; each item sends
// 48 KB of output-transform sums to the 3 peer blocks.
// Not done yet: one TMA multicast of the window to the 4 blocks (each block
// loads it), a split over C for grids that do not fill the card (a 4x4 map
// at batch 128 gives 16 items).
//
// Requirements (checked by the wrapper, and again here): H, W even; C % 32
// == 0; K % 8 == 0; U from `weight_transform`, K padded to Kp = K rounded up
// to 128 with zero columns.
#include <cuda.h>

#include <type_traits>

#include "common.cuh"

using namespace du;

namespace {

constexpr int kBM = 64;       // output tiles of a cluster (the wgmma M)
constexpr int kBN = 128;      // output channels of a cluster
constexpr int kCK = 32;       // input channels of a chunk
constexpr int kPos = 4;       // positions of a block: column `rank` of the 4x4 grid
constexpr int kCluster = 4;
constexpr int kConsumers = 256;  // warpgroups 0 and 1: transform and wgmma
constexpr int kEpilogue = 96;    // warps 9-11: the output transform of the block's channels
constexpr int kThreads = kConsumers + 32 + kEpilogue;  // + the producer warp 8
constexpr int kEpiTiles = (kBM * 4 + kEpilogue - 1) / kEpilogue;  // (tile, 8 channels) items of an epilogue thread
constexpr int kVStage = kPos * kBM * kCK * 2;   // 16 KB: V[a][tile][c], bf16
constexpr int kUStage = kPos * kBN * kCK * 2;   // 32 KB: U[a][k][c], bf16
constexpr int kPartials = kCluster * 2 * kBM * 32 * 4;  // 64 KB: the 4 columns' s0, s1 of 64 tiles x 32 k, float32
// core-matrix strides of V and U stages (bytes): along K (c) 128, along M / N 512
constexpr uint32_t kLbo = 128, kSbo = 512;

template <typename T>
struct Cfg {
  static constexpr int kPix = kCK * (int)sizeof(T);   // bytes of one window pixel: 64 or 128
  static constexpr uint32_t kSwz = sizeof(T) == 2 ? 0x30u : 0x70u;  // 64- or 128-byte swizzle bits
};

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// window pixel p, channel c: byte offset in the TMA-swizzled stage (the
// 16-byte chunk index XORed with bits 7.. of the offset)
template <typename T>
__device__ __forceinline__ uint32_t win_off(uint32_t p, uint32_t c) {
  const uint32_t b = p * Cfg<T>::kPix + c * (uint32_t)sizeof(T);
  return b ^ ((b >> 3) & Cfg<T>::kSwz);
}

__device__ __forceinline__ float2 ld2(const unsigned char* p, float) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 ld2(const unsigned char* p, __nv_bfloat16) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, "
      "%6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

struct Geom {
  int N, H, W, C, K;
  int tc, tr, nb;        // a cluster's tiles: tr rows x tc columns of nb images
  int bx, by, bn;        // tile blocks along the tile columns, rows and images
  int n_kb;              // 128-channel output blocks
  int win_bytes;         // one window stage as TMA writes it
};

// wait for a phase completed by arrivals from other blocks of the cluster
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, "
        "p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

// one arrival on the barrier at `addr` (a shared::cluster address, maybe another block's)
__device__ __forceinline__ void mbar_arrive_remote(uint32_t addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(addr) : "memory");
}

// 16 bytes to shared memory of a block of the cluster, completing as transaction bytes on its barrier `bar`
__device__ __forceinline__ void st_async4(uint32_t addr, float a, float b, float c, float d, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(
                   addr),
               "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void bar_sync_epilogue() { asm volatile("bar.sync 1, 96;\n" ::: "memory"); }

// (output tile block, 128-channel block) of a work item, and its first tile
struct Item {
  int tx0, ty0, n0, kb;
};
__device__ __forceinline__ Item item_of(const Geom& g, int it) {
  Item r;
  r.kb = it % g.n_kb;
  const int mb = it / g.n_kb;
  r.tx0 = (mb % g.bx) * g.tc;
  r.ty0 = ((mb / g.bx) % g.by) * g.tr;
  r.n0 = (mb / (g.bx * g.by)) * g.nb;
  return r;
}

// XS window stages, VS V/U stages (1 or 2)
template <typename T, int XS, int VS>
__global__ void __launch_bounds__(kThreads, 1)
winograd_kernel(const __grid_constant__ CUtensorMap xmap, const __nv_bfloat16* __restrict__ u,
                const float* __restrict__ bias, const T* __restrict__ res, T* __restrict__ out, const Geom g) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes of shared address: align the base
  unsigned char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const int win_stage = round_up(g.win_bytes, 1024);
  unsigned char* win = smem;                                  // [XS][win_stage]
  unsigned char* vs = win + XS * win_stage;                   // [VS][kVStage]
  unsigned char* us = vs + VS * kVStage;                      // [VS][kUStage]
  float* partials = reinterpret_cast<float*>(us + VS * kUStage);  // [rank][tile][16 channel pairs][s0 s0 s1 s1]
  uint64_t* bars = reinterpret_cast<uint64_t*>(partials + kPartials / 4);
  uint64_t* xfull = bars;            // [XS]: the window's TMA bytes
  uint64_t* xempty = xfull + XS;     // [XS]: the window is transformed
  uint64_t* vfull = xempty + XS;     // [VS]: V written and U's bytes in
  uint64_t* vempty = vfull + VS;     // [VS]: both warpgroups' products done
  uint64_t* pfull = vempty + VS;     // the 4 blocks' partials of this block's channels are in (64 KB of tx)
  uint64_t* pempty = pfull + 1;      // the 4 owners have read this block's partials

  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank();
  const int cid = blockIdx.x / kCluster, n_clusters = gridDim.x / kCluster;
  const int n_items = g.bx * g.by * g.bn * g.n_kb;
  const int my_items = cid < n_items ? (n_items - 1 - cid) / n_clusters + 1 : 0;
  const int nchunks = g.C / kCK;
  const int total = my_items * nchunks;  // chunks this cluster walks, over all its items
  const int wwin = 2 * g.tc + 2, hwin = 2 * g.tr + 2;

  if (tid == 0) {
    for (int s = 0; s < XS; ++s) {
      mbar_init(&xfull[s], 1);            // the producer's expect_tx arrival
      mbar_init(&xempty[s], kConsumers);  // every transform thread has read the window
    }
    for (int s = 0; s < VS; ++s) {
      mbar_init(&vfull[s], kConsumers + 1);  // V written by every thread, U's bytes (expect_tx arrival)
      mbar_init(&vempty[s], kConsumers);     // both warpgroups' products of the stage are done
    }
    // the epilogue's expect_tx arrival, every consumer thread's (after its stores of this block's own
    // channels), then the 3 peers' st.async bytes
    mbar_init(pfull, 1 + kConsumers);
    mbar_init(pempty, kCluster);  // each owner has read this block's partials
    fence_mbar_init();
  }
  __syncthreads();
  cluster_arrive();
  cluster_wait();  // every block's barriers are initialised before any remote arrival

  if (tid >= kConsumers + 32) {
    // ---- epilogue warps: Y for this block's 32 channels of each item, from the 4 columns' row sums ----
    const int et = tid - kConsumers - 32;
    uint32_t pempty_of[kCluster];
#pragma unroll
    for (int q = 0; q < kCluster; ++q) pempty_of[q] = map_rank(pempty, q);
    const int th = g.H >> 1, tw = g.W >> 1;
    for (int t = 0; t < my_items; ++t) {
      const Item itm = item_of(g, cid + t * n_clusters);
      if (et == 0) mbar_arrive_expect_tx(pfull, kPartials / kCluster * (VS == 2 ? kCluster - 1 : kCluster));
      mbar_wait_cluster(pfull, t & 1);
      // thread et: channels 8 (et % 4) .. +7 of the block's 32, tiles et / 4 + 24 m: 16-byte stores (bf16)
      const int oct = et & 3, tile0 = et >> 2;
      const int k = itm.kb * kBN + 32 * rank + 8 * oct;  // K % 8 == 0: the 8 channels are in or out
      float bk[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) bk[e] = k < g.K ? bias[k + e] : 0.f;
      float y[kEpiTiles][2][2][8];  // [m][row a][col b][channel]
#pragma unroll
      for (int m = 0; m < kEpiTiles; ++m) {
        const int tile = tile0 + 24 * m;
        if (tile >= kBM) continue;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          float4 sm[4];  // [column b]: s0 of channels 2p, 2p+1, s1 of 2p, 2p+1
#pragma unroll
          for (int b = 0; b < 4; ++b)
            sm[b] = *reinterpret_cast<const float4*>(partials + b * (kBM * 64) + (tile * 16 + 4 * oct + p) * 4);
          const int e0 = 2 * p, e1 = 2 * p + 1;
          y[m][0][0][e0] = (sm[0].x + sm[1].x + sm[2].x) + bk[e0];
          y[m][0][0][e1] = (sm[0].y + sm[1].y + sm[2].y) + bk[e1];
          y[m][0][1][e0] = (sm[1].x - sm[2].x - sm[3].x) + bk[e0];
          y[m][0][1][e1] = (sm[1].y - sm[2].y - sm[3].y) + bk[e1];
          y[m][1][0][e0] = (sm[0].z + sm[1].z + sm[2].z) + bk[e0];
          y[m][1][0][e1] = (sm[0].w + sm[1].w + sm[2].w) + bk[e1];
          y[m][1][1][e0] = (sm[1].z - sm[2].z - sm[3].z) + bk[e0];
          y[m][1][1][e1] = (sm[1].w - sm[2].w - sm[3].w) + bk[e1];
        }
      }
      bar_sync_epilogue();  // every read of this block's partials is done: the writers may go on
      if (et == 0)
        for (int q = 0; q < kCluster; ++q) mbar_arrive_remote(pempty_of[q]);
      if (k < g.K) {
#pragma unroll
        for (int m = 0; m < kEpiTiles; ++m) {
          const int tile = tile0 + 24 * m;
          const int tx = itm.tx0 + tile % g.tc, ty = itm.ty0 + (tile / g.tc) % g.tr, n = itm.n0 + tile / (g.tc * g.tr);
          if (tile >= kBM || tx >= tw || ty >= th || n >= g.N) continue;
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              const long long o = (((long long)n * g.H + 2 * ty + a) * g.W + 2 * tx + b) * g.K + k;
              float v[8];
#pragma unroll
              for (int e = 0; e < 8; ++e) v[e] = y[m][a][b][e];
              if (res != nullptr) {
                float r[8];
                load_vec<T, 8>(res + o, r);
#pragma unroll
                for (int e = 0; e < 8; ++e) v[e] += r[e];
              }
              store_vec<T, 8>(out + o, v);
            }
        }
      }
    }
  } else if (tid >= kConsumers) {
    // ---- producer warp: window TMA loads and U bulk copies, running ahead over the items ----
    if (tid == kConsumers) {
      const uint64_t* ub = reinterpret_cast<const uint64_t*>(u);
      for (int gc = 0; gc < total; ++gc) {
        const int i = gc % nchunks;
        const Item itm = item_of(g, cid + (gc / nchunks) * n_clusters);
        const int xs = gc % XS, st = gc % VS;
        mbar_wait(&xempty[xs], ((gc / XS) & 1) ^ 1);
        mbar_arrive_expect_tx(&xfull[xs], (uint32_t)g.win_bytes);
        tma_load_4d(win + xs * win_stage, &xmap, &xfull[xs], i * kCK, 2 * itm.tx0 - 1, 2 * itm.ty0 - 1, itm.n0);
        mbar_wait(&vempty[st], ((gc / VS) & 1) ^ 1);
        mbar_arrive_expect_tx(&vfull[st], kUStage);
        const size_t blk = ((size_t)itm.kb * nchunks + i) * kCluster + rank;  // U tile [kb][chunk][column]
        bulk_load(us + st * kUStage, ub + blk * (kUStage / 8), kUStage, &vfull[st]);
      }
    }
    __syncwarp();
  } else {
    // ---- two warpgroups: the transform of chunk i+1 runs while the products of chunk i are in flight ----
    // transform: warp w, lane = 4 tl + pr: channels 8 (w % 4) + 2 pr, +1 of tiles 8 (w / 4 + 2 q) + tl, q =
    // 0..3, so a warp's V stores fill one 128-byte core matrix. The window offsets of its 4 x 8 loads are the
    // same for every chunk and item.
    const int w = tid >> 5, lane = tid & 31, tl = lane >> 2, pr = lane & 3;
    const int c = 8 * (w & 3) + 2 * pr;
    int p0s[4];  // window pixel of each item's patch corner
    // items q are tile groups tg0 + q tstep. Where a block's 64 tiles are 4 rows of 16 or 8 rows of 8 of
    // one image, item q + 1 is the tile right below item q: its patch's first two rows are item q's last two
    const bool vert = VS == 2 && g.tc >= 8 && g.nb == 1;
    const bool tall = VS == 2 && g.tc == 8;  // 8 tiles a row: the items are consecutive groups
    const int tstep = tall ? 1 : 2, tg0 = tall ? 4 * (w >> 2) : (w >> 2);
    // core-matrix offset of (tile, c) in a V position; item q adds 512 tstep q
    const uint32_t voff = 512 * tg0 + 128 * (w & 3) + 16 * tl + 4 * pr, vstep = 512 * tstep;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int tg = tg0 + tstep * q, m = 8 * tg + tl;
      const int tx = m % g.tc, ty = (m / g.tc) % g.tr, img = m / (g.tc * g.tr);
      const int p0 = (img * hwin + 2 * ty) * wwin + 2 * tx;
      p0s[q] = p0;
    }
    // the transform of chunk gc: window stage gc % XS -> V stage gc % VS; `col` is the block's column
    // (std::integral_constant), so each block runs the +-sum of its own column and no other
    auto transform_col = [&](int gc, auto col) {
      constexpr int B = decltype(col)::value;
      mbar_wait(&vempty[gc % VS], ((gc / VS) & 1) ^ 1);  // both warpgroups' products of chunk gc - VS are done
      mbar_wait(&xfull[gc % XS], (gc / XS) & 1);
      const unsigned char* wb = win + (gc % XS) * win_stage;
      int ww;  // wwin, opaque to the compiler: the 32 load offsets are computed here, not held across the loop
      asm volatile("mov.u32 %0, %1;\n" : "=r"(ww) : "r"(wwin));
      unsigned char* vb = vs + (gc % VS) * kVStage;
      // bf16 with two V stages: the 4 items unrolled; else one at a time, within the registers
      float2 prev[2][2];  // rows 2, 3 of the previous item's columns
#pragma unroll(sizeof(T) == 2 && VS == 2 ? 4 : 1)
      for (int q = 0; q < 4; ++q) {
        const int p0 = q == 0 ? p0s[0] : q == 1 ? p0s[1] : q == 2 ? p0s[2] : p0s[3];
        float2 t[2][4];  // row-transformed columns j1, j2: [a] for the channel pair
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          // column B of V = B^T d B uses columns j1, j2 of the row-transformed patch
          const int j = jj ? (B == 3 ? 3 : 2) : (B == 0 ? 0 : 1);
          float2 d[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (r >= 2 || !(vert && q > 0)) d[r] = ld2(wb + win_off<T>(p0 + r * ww + j, c), T());
            else d[r] = prev[jj][r];
          prev[jj][0] = d[2];
          prev[jj][1] = d[3];
          t[jj][0] = make_float2(d[0].x - d[2].x, d[0].y - d[2].y);
          t[jj][1] = make_float2(d[1].x + d[2].x, d[1].y + d[2].y);
          t[jj][2] = make_float2(d[2].x - d[1].x, d[2].y - d[1].y);
          t[jj][3] = make_float2(d[1].x - d[3].x, d[1].y - d[3].y);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float2 p = t[0][a], q2 = t[1][a];
          float2 v;
          if constexpr (B == 1)
            v = make_float2(p.x + q2.x, p.y + q2.y);  // t1 + t2
          else if constexpr (B == 2)
            v = make_float2(q2.x - p.x, q2.y - p.y);  // t2 - t1
          else
            v = make_float2(p.x - q2.x, p.y - q2.y);  // t0 - t2, t1 - t3
          *reinterpret_cast<__nv_bfloat162*>(vb + a * (kVStage / kPos) + vstep * q + voff) =
              __floats2bfloat162_rn(v.x, v.y);
        }
      }
      fence_proxy_async();  // V is read by wgmma (the async proxy)
      mbar_arrive(&xempty[gc % XS]);
      mbar_arrive(&vfull[gc % VS]);
    };
    auto transform = [&](int gc) {
      switch (rank) {
        case 0: transform_col(gc, std::integral_constant<int, 0>()); break;
        case 1: transform_col(gc, std::integral_constant<int, 1>()); break;
        case 2: transform_col(gc, std::integral_constant<int, 2>()); break;
        default: transform_col(gc, std::integral_constant<int, 3>()); break;
      }
    };

    const int cw = tid >> 7, wi = w & 3, gq = lane >> 2, t4 = lane & 3;
    if (VS == 2 && total > 0) transform(0);
    float acc[kPos][32];
    for (int t = 0; t < my_items; ++t) {
#pragma unroll
      for (int a = 0; a < kPos; ++a)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[a][e] = 0.f;
      for (int i = 0; i < nchunks; ++i) {
        const int gc = t * nchunks + i, st = gc % VS;
        if (VS == 1) transform(gc);  // one V stage: after both warpgroups' products of chunk gc - 1
        mbar_wait(&vfull[st], (gc / VS) & 1);
        const unsigned char* vb = vs + st * kVStage;
        const unsigned char* ubs = us + st * kUStage + cw * (kUStage / kPos / 2);
        const bool next = gc + 1 < total;
        wgmma_fence();
#pragma unroll
        for (int a = 0; a < kPos; ++a) {
#pragma unroll
          for (int kk = 0; kk < kCK / 16; ++kk)
            wgmma_m64n64k16(acc[a], gmma_desc(vb + a * (kVStage / kPos) + 256 * kk, kLbo, kSbo),
                            gmma_desc(ubs + a * (kUStage / kPos) + 256 * kk, kLbo, kSbo));
        }
        wgmma_commit();
        if (VS == 2 && next) transform(gc + 1);  // while the products are in flight
        wgmma_wait<0>();
#pragma unroll
        for (int a = 0; a < kPos; ++a)
#pragma unroll
          for (int e = 0; e < 32; ++e) reg_fence(acc[a][e]);
        mbar_arrive(&vempty[st]);
      }

      // this column's row sums of the output transform (s0 = m0 + m1 + m2, s1 = m1 - m2 - m3) to the
      // block owning the channels (block q: channels 32q..32q+31), once it has read the previous item's
      mbar_wait_cluster(pempty, (t & 1) ^ 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int owner = 2 * cw + (j >> 2);
        const int pair = 4 * (j & 3) + t4;  // channel pair of the owner's 32 channels
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int tile = 16 * wi + gq + 8 * h;
          float s0[2], s1[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int q = 4 * j + 2 * h + e;
            s0[e] = acc[0][q] + acc[1][q] + acc[2][q];
            s1[e] = acc[1][q] - acc[2][q] - acc[3][q];
          }
          // into block `owner`'s buffer at this rank's slot, a peer's counted on its pfull (the one-stage
          // instances, float32 on 4x4 maps, send their own through st.async too: a local store spills there)
          float* dst = partials + rank * (kBM * 64) + (tile * 16 + pair) * 4;
          if (VS == 2 && owner == rank)
            *reinterpret_cast<float4*>(dst) = make_float4(s0[0], s0[1], s1[0], s1[1]);
          else
            st_async4(map_rank(dst, owner), s0[0], s0[1], s1[0], s1[1], map_rank(pfull, owner));
        }
      }
      mbar_arrive(pfull);
    }
  }
  cluster_arrive();
  cluster_wait();  // no block leaves while a peer may still write to it or arrive on its barriers
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query (no link to libcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

int p2(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

size_t smem_bytes(int win_bytes, int xs, int vs) {
  return 1024 + (size_t)xs * round_up(win_bytes, 1024) + (size_t)vs * (kVStage + kUStage) + kPartials +
         (2 * xs + 2 * vs + 2) * 8;
}

template <typename T, int XS, int VS>
int launch_cfg(const CUtensorMap& map, const void* u, const void* bias, const void* res, void* out, const Geom& g,
               cudaStream_t s) {
  auto kern = winograd_kernel<T, XS, VS>;
  const size_t smem = smem_bytes(g.win_bytes, XS, VS);
  static int max_clusters = 0;  // clusters of this instance the card holds at once
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (max_clusters == 0) {
    cfg.gridDim = dim3(kCluster * 256);
    e = cudaOccupancyMaxActiveClusters(&max_clusters, kern, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (max_clusters < 1) return (int)cudaErrorInvalidConfiguration;
  }
  // a persistent grid: each cluster walks items cid, cid + clusters, ...
  const long long items = (long long)g.bx * g.by * g.bn * g.n_kb;
  const long long clusters = items < max_clusters ? items : max_clusters;
  cfg.gridDim = dim3((unsigned int)(clusters * kCluster));
  e = cudaLaunchKernelEx(&cfg, kern, map, static_cast<const __nv_bfloat16*>(u), static_cast<const float*>(bias),
                         static_cast<const T*>(res), static_cast<T*>(out), g);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* u, const void* bias, const void* res, void* out, int N, int H, int W, int C,
           int K, int Kp, cudaStream_t s) {
  Geom g;
  g.N = N, g.H = H, g.W = W, g.C = C, g.K = K;
  const int th = H / 2, tw = W / 2;
  g.tc = p2(tw) < 16 ? p2(tw) : 16;
  g.tr = p2(th) < kBM / g.tc ? p2(th) : kBM / g.tc;
  g.nb = kBM / (g.tc * g.tr);
  g.bx = (tw + g.tc - 1) / g.tc;
  g.by = (th + g.tr - 1) / g.tr;
  g.bn = (N + g.nb - 1) / g.nb;
  g.n_kb = Kp / kBN;
  const int wwin = 2 * g.tc + 2, hwin = 2 * g.tr + 2;
  g.win_bytes = Cfg<T>::kPix * wwin * hwin * g.nb;
  if ((long long)g.bx * g.by * g.bn * g.n_kb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;

  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)C * sizeof(T), (cuuint64_t)W * C * sizeof(T),
                                 (cuuint64_t)H * W * C * sizeof(T)};
  const cuuint32_t box[4] = {(cuuint32_t)kCK, (cuuint32_t)wwin, (cuuint32_t)hwin, (cuuint32_t)g.nb};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  CUresult r = enc(&map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                   const_cast<void*>(x), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   sizeof(T) == 2 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;

  // the deepest pipeline that fits 227 KB: bf16 two window and two V/U stages, or one window stage (4x4
  // maps); float32 one window stage, and one V/U stage for its largest windows (4x4 maps)
  constexpr size_t kMax = 232448;
  if constexpr (sizeof(T) == 2) {
    if (smem_bytes(g.win_bytes, 2, 2) <= kMax) return launch_cfg<T, 2, 2>(map, u, bias, res, out, g, s);
    if (smem_bytes(g.win_bytes, 1, 2) <= kMax) return launch_cfg<T, 1, 2>(map, u, bias, res, out, g, s);
  } else {
    if (smem_bytes(g.win_bytes, 1, 2) <= kMax) return launch_cfg<T, 1, 2>(map, u, bias, res, out, g, s);
    if (smem_bytes(g.win_bytes, 1, 1) <= kMax) return launch_cfg<T, 1, 1>(map, u, bias, res, out, g, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x [N, H, W, C] and res [N, H, W, K] (or null) in the activation type, u
// from `weight_transform` ([Kp/128][C/32][4 columns][4 rows][128 k x 32 c in
// core-matrix order], bfloat16), bias [K] float32, out [N, H, W, K]; all
// contiguous, x, u and res on 16 bytes.
extern "C" int du_winograd(const void* x, const void* u, const void* bias, const void* res, void* out, int N,
                           int H, int W, int C, int K, int Kp, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (N < 1 || H % 2 || W % 2 || H < 2 || W < 2 || C % kCK || C < kCK || K % 8 || Kp % kBN || Kp < K ||
      Kp / kBN > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == kF32) return launch<float>(x, u, bias, res, out, N, H, W, C, K, Kp, s);
  if (dtype == kBF16) return launch<__nv_bfloat16>(x, u, bias, res, out, N, H, W, C, K, Kp, s);
  return (int)cudaErrorInvalidValue;
}
