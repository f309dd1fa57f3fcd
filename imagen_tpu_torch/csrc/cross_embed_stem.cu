// The CrossEmbed stem, every scale in one call, NHWC, bf16, for sm_90a:
// implicit GEMM on mma.sync.
//
// Replaces `cross_embed_stem` -> `_forward` -> `_kernel` of
// imagen_tpu/ops/stem_conv.py. That kernel fed the MXU from a 4x4
// space-to-depth copy of the input (K = 96 per tap) and un-tiled the phases
// in registers; the H100 needs neither, so neither is carried over.
//
// out[b, y, x, coff_s + o] = bias[coff_s + o]
//     + sum_{dy, dx < k_s, c} in[b, y + dy - p_s, x + dx - p_s, c] * w_s[dy, dx, c, o]
// for each scale s (kernel k_s = 2 p_s + 1, d_s output channels at offset
// coff_s), zeros outside the image.
//
// What bounds it on the H100: at the SR-1024 stem, (2, 1024, 1024, 6) with
// kernels (3, 7, 15) and (64, 32, 32) channels, the convs do 2.35e11 flops
// against 0.56 GB of bytes, so the tensor cores bound it (0.24 ms at the
// dense bf16 peak); the 15 x 15 scale does 77% of the work.
// Design: one launch of one kernel per scale, all from this entry point.
// A block computes an 8-row x 64-pixel output tile for 32 output channels
// of its scale (the grid's y splits a scale's channels into such chunks, so
// each block's weight chunk fits in shared memory: 154 KB at k 15). It
// stages the tile's input with its p-pixel halo, c padded to 8 channels (16
// bytes a pixel), zero outside the image (SAME padding costs no pass), and
// the chunk's weights, once. The product's K runs over (dy, tap pair, 8
// channels): two horizontally neighbouring taps are two neighbouring pixels
// of the staged rows, so one ldmatrix row of 16 values is 32 contiguous
// bytes, and a k16 mma step covers taps 2q and 2q + 1 (the odd row's extra
// tap has a zero weight). Each of the 8 warps owns one output row of 64
// pixels x 32 channels, accumulated in fp32 from the bias. Simple first: no
// wgmma, no TMA, no pipelining of the staging; those are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

constexpr int TH = 8;          // output rows per block (one per warp)
constexpr int TW = 64;         // output pixels per row
constexpr int NB = 32;         // output channels per block
constexpr int NBP = NB + 8;    // padded weight row (80 B): conflict-free ldmatrix.trans
constexpr int CP = 8;          // channels per staged pixel (c <= 8, zero-padded)
constexpr int THREADS = TH * 32;
constexpr int MAX_SCALES = 4;

__host__ __device__ inline int tile_cols(int p) { return TW + 2 * p + 1; }

__host__ inline size_t smem_bytes(int k) {
  const int p = k / 2, pairs = (k + 1) / 2;
  const size_t tile = size_t(TH + 2 * p) * tile_cols(p) * CP * 2;
  const size_t wts = size_t(k) * pairs * 16 * NBP * 2;
  return tile + wts;
}

__global__ void __launch_bounds__(THREADS, 1)
cross_embed_scale_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w,     // (chunks, k, P, 16, NB)
                         const __nv_bfloat16* __restrict__ bias,  // this scale's d values
                         __nv_bfloat16* __restrict__ out,
                         int H, int W, int c, int D, int coff, int k, int d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int p = k / 2, pairs = (k + 1) / 2;
  const int cols = tile_cols(p), rows = TH + 2 * p;
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wsm = tile + size_t(rows) * cols * CP;  // 16-byte aligned: CP * 2 = 16

  const int ntx = (W + TW - 1) / TW;
  const int nty = (H + TH - 1) / TH;
  const int x0 = (blockIdx.x % ntx) * TW;
  const int y0 = ((blockIdx.x / ntx) % nty) * TH;
  const int bb = blockIdx.x / (ntx * nty);
  const int chunk = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // the chunk's weights: k * P * 16 rows of NB values, 4 vectors of 8 a row
  const int wrows = k * pairs * 16;
  const __nv_bfloat16* wsrc = w + size_t(chunk) * wrows * NB;
  for (int i = threadIdx.x; i < wrows * (NB / 8); i += THREADS) {
    const int r = i / (NB / 8), v = i % (NB / 8);
    *reinterpret_cast<uint4*>(wsm + r * NBP + v * 8) =
        __ldg(reinterpret_cast<const uint4*>(wsrc + size_t(r) * NB + v * 8));
  }
  // the input tile with its halo; consecutive threads read consecutive
  // channels of consecutive pixels, so the c-channel rows load coalesced
  for (int i = threadIdx.x; i < rows * cols * CP; i += THREADS) {
    const int ci = i % CP;
    const int col = (i / CP) % cols;
    const int r = i / (CP * cols);
    const int yi = y0 + r - p, xi = x0 + col - p;
    __nv_bfloat16 v = __float2bfloat16(0.f);
    if (ci < c && yi >= 0 && yi < H && xi >= 0 && xi < W)
      v = x[(((size_t)bb * H + yi) * W + xi) * c + ci];
    tile[i] = v;
  }

  // accumulators start at the bias: c0, c1 are (pixel g, channels 2t, 2t+1), c2, c3 pixel g + 8
  float acc[4][4][4];
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) {
    const int n = chunk * NB + nb * 8 + (lane % 4) * 2;
    const float b0 = n < d ? __bfloat162float(bias[n]) : 0.f;
    const float b1 = n + 1 < d ? __bfloat162float(bias[n + 1]) : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i][nb][0] = b0;
      acc[i][nb][1] = b1;
      acc[i][nb][2] = b0;
      acc[i][nb][3] = b1;
    }
  }
  __syncthreads();

  for (int dy = 0; dy < k; ++dy) {
    const __nv_bfloat16* trow = tile + size_t(warp + dy) * cols * CP;
    for (int q = 0; q < pairs; ++q) {
      const __nv_bfloat16* wstep = wsm + size_t((dy * pairs + q) * 16) * NBP;
      uint32_t b[2][4];
#pragma unroll
      for (int nb2 = 0; nb2 < 2; ++nb2)
        ldmatrix_x4_trans(b[nb2], wstep + (lane % 8 + ((lane / 8) % 2) * 8) * NBP + nb2 * 16 +
                                      (lane / 16) * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // rows: pixels i * 16 + lane % 16; k 0-7 the tap 2q, k 8-15 the tap 2q + 1
        uint32_t a[4];
        ldmatrix_x4(a, trow + (i * 16 + lane % 16 + 2 * q + lane / 16) * CP);
#pragma unroll
        for (int nb2 = 0; nb2 < 2; ++nb2) {
          mma_bf16(acc[i][2 * nb2], a, b[nb2][0], b[nb2][1]);
          mma_bf16(acc[i][2 * nb2 + 1], a, b[nb2][2], b[nb2][3]);
        }
      }
    }
  }

  const int y = y0 + warp;
  if (y >= H) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int px = x0 + i * 16 + lane / 4 + h * 8;
      if (px >= W) continue;
      __nv_bfloat16* orow = out + (((size_t)bb * H + y) * W + px) * D + coff;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const int n = chunk * NB + nb * 8 + (lane % 4) * 2;
        const float v0 = acc[i][nb][2 * h], v1 = acc[i][nb][2 * h + 1];
        if (n + 1 < d && ((orow - out) + n) % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(orow + n) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (n < d) orow[n] = __float2bfloat16(v0);
          if (n + 1 < d) orow[n + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

}  // namespace

// x (b, H, W, c <= 8); w the scales' packed weights one after another, each
// (ceil(d_s / 32), k_s, (k_s + 1) / 2, 16, 32); bias (D,); out (b, H, W, D),
// D = sum d_s; all bf16 and contiguous. Scales past `nscales` are ignored.
extern "C" int cross_embed_stem_bf16(const void* x, const void* w, const void* bias, void* out,
                                     int b, int H, int W, int c, int nscales, int k0, int k1,
                                     int k2, int k3, int d0, int d1, int d2, int d3,
                                     void* stream) {
  const int ks[MAX_SCALES] = {k0, k1, k2, k3};
  const int ds[MAX_SCALES] = {d0, d1, d2, d3};
  if (c < 1 || c > CP || nscales < 1 || nscales > MAX_SCALES) return (int)cudaErrorInvalidValue;
  int D = 0;
  size_t smem_max = 0;
  for (int s = 0; s < nscales; ++s) {
    if (ks[s] < 1 || ks[s] % 2 == 0 || ds[s] < 1) return (int)cudaErrorInvalidValue;
    D += ds[s];
    if (smem_bytes(ks[s]) > smem_max) smem_max = smem_bytes(ks[s]);
  }
  cudaError_t err = cudaFuncSetAttribute(cross_embed_scale_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_max);
  if (err != cudaSuccess) return err;
  const int ntx = (W + TW - 1) / TW;
  const int nty = (H + TH - 1) / TH;
  const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(w);
  int coff = 0;
  for (int s = 0; s < nscales; ++s) {
    const int k = ks[s], d = ds[s], chunks = (d + NB - 1) / NB;
    dim3 grid((unsigned)b * nty * ntx, chunks);
    cross_embed_scale_kernel<<<grid, THREADS, smem_bytes(k), static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x), wp, static_cast<const __nv_bfloat16*>(bias) + coff,
        static_cast<__nv_bfloat16*>(out), H, W, c, D, coff, k, d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    wp += (size_t)chunks * k * ((k + 1) / 2) * 16 * NB;
    coff += d;
  }
  return 0;
}
