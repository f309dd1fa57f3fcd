// Stride-1 SAME 3x3 convolution, NHWC, bf16, for sm_90a: implicit GEMM.
//
// Replaces `conv2d_same` -> `_forward` -> `_kernel` of
// imagen_tpu/ops/conv2d.py (the halo-DMA Pallas conv). Its cin-split
// (`_tiles_with_split`) was a VMEM-fitting artifact and is not carried over:
// this kernel loops over cin in 16-channel chunks, so any cin that is a
// multiple of 16 runs in one launch.
//
// out[b, y, x, o] = bias[o] + sum_{dy, dx, c} in[b, y+dy-1, x+dx-1, c] * w[dy, dx, c, o]
// with zeros outside the image. w is (kh, kw, cin, cout), the layout the
// wrapper keeps beside the module's torch (cout, cin, kh, kw) weight.
//
// What bounds it on the H100: at the slice's shapes (cin 128..1024,
// cout 128..512) a 3x3 conv does 18 * cin flops per output element, so it is
// bound by the tensor cores, and the input must be read from HBM about once.
// Design: one block of 8 warps computes 2 output rows x 64 pixels x 128
// output channels; each warp owns 32 pixels x 64 channels, accumulated in
// registers by mma.sync m16n8k16 bf16 (fp32 accumulate) whose initial value
// is the bias, so the bias is folded into the fp32 accumulator. Per
// 16-channel chunk the block stages in shared memory the halo'd input band
// (4 rows x 66 columns; cp.async zero-fills what lies outside the image, so
// SAME padding costs no pass) and the 9 taps of the weight tile, double
// buffered so the next chunk loads while this one computes. Each tap is a
// product of shifted windows of that band with the tap's weights, read by
// ldmatrix from rows padded against bank conflicts. Simple first: no wgmma,
// no TMA; those are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

constexpr int TH = 2;          // output rows per block
constexpr int TW = 64;         // output pixels per row per block
constexpr int BN = 128;        // output channels per block
constexpr int CK = 16;         // input channels per chunk
constexpr int HALO = TW + 2;   // staged input columns
constexpr int CKP = CK + 8;    // padded input row (48 B)
constexpr int BNP = BN + 8;    // padded weight row (272 B)
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

constexpr size_t IN_ELEMS = size_t(TH + 2) * HALO * CKP;
constexpr size_t W_ELEMS = size_t(9) * CK * BNP;
constexpr size_t STAGE_BYTES = (IN_ELEMS + W_ELEMS) * 2;
constexpr size_t SMEM = 2 * STAGE_BYTES;
static_assert((IN_ELEMS * 2) % 16 == 0 && STAGE_BYTES % 16 == 0, "cp.async needs 16-B rows");

__global__ void __launch_bounds__(THREADS, 2)  // two blocks per SM: <= 128 registers
conv2d_same_3x3_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       const __nv_bfloat16* __restrict__ bias,
                       __nv_bfloat16* __restrict__ out,
                       int H, int W, int cin, int cout) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ntx = (W + TW - 1) / TW;
  const int nty = (H + TH - 1) / TH;
  const int x0 = (blockIdx.x % ntx) * TW;
  const int y0 = ((blockIdx.x / ntx) % nty) * TH;
  const int bb = blockIdx.x / (ntx * nty);
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wr = warp / 4;               // output row of this warp's tile
  const int wp = ((warp / 2) % 2) * 32;  // first pixel of this warp's tile
  const int wn = (warp % 2) * 64;        // first channel of this warp's tile

  auto in_stage = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem + s * STAGE_BYTES);
  };
  auto w_stage = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem + s * STAGE_BYTES + IN_ELEMS * 2);
  };

  // cout is a multiple of 8 (the wrapper pads it), so 8-channel vectors
  // are either wholly inside or wholly outside
  auto load_chunk = [&](int ci, int s) {
    const int c0 = ci * CK;
    __nv_bfloat16* In = in_stage(s);
    __nv_bfloat16* Wt = w_stage(s);
    for (int i = threadIdx.x; i < (TH + 2) * HALO * (CK / 8); i += THREADS) {
      const int v = i % (CK / 8);
      const int col = (i / (CK / 8)) % HALO;
      const int r = i / (CK / 8 * HALO);
      const int yi = y0 + r - 1, xi = x0 + col - 1;
      const bool valid = yi >= 0 && yi < H && xi >= 0 && xi < W;
      const size_t off = valid ? (((size_t)bb * H + yi) * W + xi) * cin + c0 + v * 8 : 0;
      cp_async16(In + (r * HALO + col) * CKP + v * 8, x + off, valid);
    }
    for (int i = threadIdx.x; i < 9 * CK * (BN / 8); i += THREADS) {
      const int n8 = i % (BN / 8);
      const int c = (i / (BN / 8)) % CK;
      const int tap = i / (BN / 8 * CK);
      const int n = n0 + n8 * 8;
      const bool valid = n < cout;
      const size_t off = valid ? ((size_t)tap * cin + c0 + c) * cout + n : 0;
      cp_async16(Wt + (tap * CK + c) * BNP + n8 * 8, w + off, valid);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // accumulators start at the bias: c0, c1 are (row g, cols 2t, 2t+1), c2, c3 row g+8
  float acc[2][8][4];
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    const int n = n0 + wn + nb * 8 + (lane % 4) * 2;
    const float b0 = (bias != nullptr && n < cout) ? __bfloat162float(bias[n]) : 0.f;
    const float b1 = (bias != nullptr && n + 1 < cout) ? __bfloat162float(bias[n + 1]) : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      acc[i][nb][0] = b0;
      acc[i][nb][1] = b1;
      acc[i][nb][2] = b0;
      acc[i][nb][3] = b1;
    }
  }

  const int nchunks = cin / CK;
  load_chunk(0, 0);
  for (int ci = 0; ci < nchunks; ++ci) {
    if (ci + 1 < nchunks) {
      load_chunk(ci + 1, (ci + 1) & 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const __nv_bfloat16* In = in_stage(ci & 1);
    const __nv_bfloat16* Wt = w_stage(ci & 1);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(a[i], In + ((wr + dy) * HALO + wp + i * 16 + lane % 16 + dx) * CKP +
                              (lane / 16) * 8);
#pragma unroll
      for (int nb2 = 0; nb2 < 4; ++nb2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Wt + (tap * CK + lane % 8 + ((lane / 8) % 2) * 8) * BNP + wn +
                                 nb2 * 16 + (lane / 16) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * nb2], a[i], b[0], b[1]);
          mma_bf16(acc[i][2 * nb2 + 1], a[i], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this stage is free for the load two chunks ahead
  }

  const int y = y0 + wr;
  if (y >= H) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int px = x0 + wp + i * 16 + lane / 4 + h * 8;
      if (px >= W) continue;
      __nv_bfloat16* orow = out + (((size_t)bb * H + y) * W + px) * cout;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int n = n0 + wn + nb * 8 + (lane % 4) * 2;
        if (n < cout)  // cout is even, so n + 1 < cout too
          *reinterpret_cast<__nv_bfloat162*>(orow + n) =
              __floats2bfloat162_rn(acc[i][nb][2 * h], acc[i][nb][2 * h + 1]);
      }
    }
  }
}

}  // namespace

// x (b, H, W, cin), w (3, 3, cin, cout), bias (cout,) or null, out (b, H, W, cout);
// all bf16 and contiguous; cin a multiple of 16, cout a multiple of 8.
extern "C" int conv2d_same_3x3_bf16(const void* x, const void* w, const void* bias,
                                    void* out, int b, int H, int W, int cin, int cout,
                                    void* stream) {
  if (cin % CK != 0 || cout % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(conv2d_same_3x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM);
  if (err != cudaSuccess) return err;
  const int ntx = (W + TW - 1) / TW;
  const int nty = (H + TH - 1) / TH;
  dim3 grid((unsigned)b * nty * ntx, (cout + BN - 1) / BN);
  conv2d_same_3x3_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out),
      H, W, cin, cout);
  return (int)cudaGetLastError();
}
