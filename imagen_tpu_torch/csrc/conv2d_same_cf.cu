// Stride-1 SAME k x k convolution with a tiny output width (cout <= 8),
// NHWC in, channel-first out, bf16, for sm_90a: implicit GEMM on mma.sync.
//
// Replaces `conv2d_same_cf` -> `_forward_cf` -> `_kernel_cf` of
// imagen_tpu/ops/conv2d.py. There the channel-first output avoided a
// 3-channel NHWC array padded to 128 lanes in HBM; the H100 has no lanes to
// pad, so the layout is kept only because it is the function's contract.
//
// out[b, o, y, x] = bias[o] + sum_{dy, dx, c} in[b, y+dy-p, x+dx-p, c] * w[dy, dx, c, o]
// with zeros outside the image (k = 2p + 1).
//
// What bounds it on the H100: a 3x3 conv to 3 channels does 18 * cin flops
// per pixel and reads cin * 2 bytes, so it is bound by reading x once (at
// the SR-1024 final conv, (2, 1024, 1024, 131) -> 3, 549 MB: 0.17 ms).
// Design: a block computes a 4-row x 64-pixel tile for all cout (padded to
// one n8 mma tile) and streams cin through shared memory 16 channels at a
// time: the chunk's input with its p-pixel halo (zero outside the image and
// past cin, so SAME padding and a ragged cin cost no pass) and the chunk's
// k * k taps of weights. Each of the 8 warps owns 32 pixels of one row, two
// m16 tiles, and accumulates in fp32 from the bias: per tap one ldmatrix
// and one mma per tile. cin need not be a multiple of 8: at cin 131 a pixel
// row is 262 bytes, not 16-byte aligned, so such an x is read 2 bytes a
// thread, consecutive threads on consecutive channels (the wrapper does not
// pad x, which would copy it); an aligned x is read 16 bytes a thread. The
// output tile is staged in shared memory and each channel plane is written
// along W. Loads are not pipelined: several blocks an SM hide their latency.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

constexpr int TH = 4;          // output rows per block
constexpr int TW = 64;         // output pixels per row
constexpr int CK = 16;         // input channels per chunk
constexpr int CKP = CK + 8;    // padded staged pixel (48 B): conflict-free ldmatrix
constexpr int NO = 8;          // output channels, padded
constexpr int WKP = CK + 8;    // padded weight row (48 B): conflict-free B loads
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

__host__ inline size_t smem_bytes(int k) {
  const int p = k / 2;
  const size_t in = size_t(TH + 2 * p) * (TW + 2 * p) * CKP * 2;
  const size_t wts = size_t(k) * k * NO * WKP * 2;
  const size_t staged_out = size_t(NO) * TH * TW * 4;  // reuses the input's space
  return (in > staged_out ? in : staged_out) + wts;
}

__global__ void __launch_bounds__(THREADS)
conv2d_same_cf_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,     // (chunks, k * k, NO, CK)
                      const __nv_bfloat16* __restrict__ bias,  // (cout,) or null
                      __nv_bfloat16* __restrict__ out,         // (b, cout, H, W)
                      int H, int W, int cin, int cout, int k, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int p = k / 2;
  const int cols = TW + 2 * p, rows = TH + 2 * p;
  const size_t in_bytes = size_t(rows) * cols * CKP * 2;
  const size_t out_bytes = size_t(NO) * TH * TW * 4;
  __nv_bfloat16* In = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(
      smem + (in_bytes > out_bytes ? in_bytes : out_bytes));

  const int ntx = (W + TW - 1) / TW;
  const int nty = (H + TH - 1) / TH;
  const int x0 = (blockIdx.x % ntx) * TW;
  const int y0 = ((blockIdx.x / ntx) % nty) * TH;
  const int bb = blockIdx.x / (ntx * nty);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp / 2;              // output row of this warp
  const int wp = (warp % 2) * 32;       // first pixel of this warp

  float acc[2][4];
  {
    const int n = 2 * t;
    const float b0 = (bias != nullptr && n < cout) ? __bfloat162float(bias[n]) : 0.f;
    const float b1 = (bias != nullptr && n + 1 < cout) ? __bfloat162float(bias[n + 1]) : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      acc[i][0] = b0;
      acc[i][1] = b1;
      acc[i][2] = b0;
      acc[i][3] = b1;
    }
  }

  const int taps = k * k;
  const int chunks = (cin + CK - 1) / CK;
  for (int ci = 0; ci < chunks; ++ci) {
    const int c0 = ci * CK;
    if (vec) {  // cin % 8 == 0 and x 16-byte aligned: 8-channel vectors
      for (int i = threadIdx.x; i < rows * cols * 2; i += THREADS) {
        const int half = i % 2, pix = i / 2;
        const int col = pix % cols, r = pix / cols;
        const int yi = y0 + r - p, xi = x0 + col - p, c = c0 + half * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (c < cin && yi >= 0 && yi < H && xi >= 0 && xi < W)
          v = __ldg(reinterpret_cast<const uint4*>(x + (((size_t)bb * H + yi) * W + xi) * cin + c));
        *reinterpret_cast<uint4*>(In + pix * CKP + half * 8) = v;
      }
    } else {
      const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
      unsigned short* Is = reinterpret_cast<unsigned short*>(In);
      for (int i = threadIdx.x; i < rows * cols * CK; i += THREADS) {
        const int cc = i % CK, pix = i / CK;
        const int col = pix % cols, r = pix / cols;
        const int yi = y0 + r - p, xi = x0 + col - p, c = c0 + cc;
        unsigned short v = 0;
        if (c < cin && yi >= 0 && yi < H && xi >= 0 && xi < W)
          v = __ldg(xs + (((size_t)bb * H + yi) * W + xi) * cin + c);
        Is[pix * CKP + cc] = v;
      }
    }
    const __nv_bfloat16* wsrc = w + (size_t)ci * taps * NO * CK;
    for (int i = threadIdx.x; i < taps * NO * 2; i += THREADS) {
      const int row = i / 2, half = i % 2;
      *reinterpret_cast<uint4*>(Ws + row * WKP + half * 8) =
          __ldg(reinterpret_cast<const uint4*>(wsrc + (size_t)row * CK + half * 8));
    }
    __syncthreads();
    for (int dy = 0; dy < k; ++dy) {
      for (int dx = 0; dx < k; ++dx) {
        // B (16 channels x 8 outputs): b0 rows 2t, 2t+1 of column g, b1 rows 2t+8, 2t+9
        const __nv_bfloat16* wrow = Ws + ((dy * k + dx) * NO + g) * WKP + 2 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(wrow);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(wrow + 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t a[4];
          ldmatrix_x4(a, In + ((wr + dy) * cols + wp + i * 16 + lane % 16 + dx) * CKP +
                             (lane / 16) * 8);
          mma_bf16(acc[i], a, b0, b1);
        }
      }
    }
    __syncthreads();  // the chunk's staging is free for the next one
  }

  // stage the tile channel-major in shared memory, then write each plane along W
  float* Os = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int px = wp + i * 16 + g + h * 8;
      Os[((2 * t) * TH + wr) * TW + px] = acc[i][2 * h];
      Os[((2 * t + 1) * TH + wr) * TW + px] = acc[i][2 * h + 1];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cout * TH * TW; i += THREADS) {
    const int px = i % TW, r = (i / TW) % TH, n = i / (TW * TH);
    const int y = y0 + r, xo = x0 + px;
    if (y < H && xo < W)
      out[(((size_t)bb * cout + n) * H + y) * W + xo] = __float2bfloat16(Os[i]);
  }
}

}  // namespace

// x (b, H, W, cin); w (ceil(cin / 16), k * k, 8, 16), the weight (k, k, cin,
// cout) zero-padded to 16-channel chunks and 8 outputs, channels innermost;
// bias (cout,) or null; out (b, cout, H, W); all bf16 and contiguous; k odd,
// 1 <= cout <= 8.
extern "C" int conv2d_same_cf_bf16(const void* x, const void* w, const void* bias, void* out,
                                   int b, int H, int W, int cin, int cout, int k,
                                   void* stream) {
  if (cout < 1 || cout > NO || k < 1 || k % 2 == 0 || cin < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(conv2d_same_cf_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int vec = cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int ntx = (W + TW - 1) / TW;
  const int nty = (H + TH - 1) / TH;
  conv2d_same_cf_kernel<<<(unsigned)b * nty * ntx, THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out), H, W, cin,
      cout, k, vec);
  return (int)cudaGetLastError();
}
