// LayerNorm fused with the time-centric relayout of the video temporal path,
// bf16, for sm_90a: kernels 12 and 13 of the port.
//
// Replaces, in imagen_tpu/ops/temporal_layout.py:
// - `fused_ln_transpose` -> `_ln_t_forward` (:128, its pallas_call at :136
//   over `_ln_t_kernel`): the LayerNorm over c fused with the fold
//   (b, f, h, w, c) -> ((b h w), f, c);
// - `fused_norm_untranspose` -> `_norm_ut_forward` (:175, pallas_call at
//   :184 over `_norm_ut_kernel`): the attention's out-norm fused with the
//   unfold ((b h w), f, c) -> (b, f, h, w, c) and the temporal residual.
// Per row of c values: the fp32 mean, the fp32 variance of the centred row,
// rsqrt(var + eps), times the fp32 gain (plus the residual in fp32 for
// kernel 13), one rounding to bf16. That is the arithmetic of the Pallas
// kernels and of the plain versions in ops/temporal_layout.py.
//
// What bounds them on the H100: bytes. Kernel 12 reads x and writes y,
// kernel 13 reads out and res and writes y, and each does about 5 flops per
// element. At training batch 4 the 32^2 sites (c 128) move 33.6 MB and
// 50.3 MB, 10.0 and 15.0 us at 3.35 TB/s; the 16^2 sites (c 256) half that.
//
// Design. In both layouts the c values of one (b, f, pixel) are contiguous
// (256 B at c 128, 512 B at c 256), so the relayout is a permutation of
// whole rows: where the TPU kernels staged an (f, hw, c) tile in VMEM and
// transposed it, here a group of lanes owns a row, reads it with 16-byte
// loads, reduces the mean and then the centred variance with shuffles inside
// the group, and writes the row to its permuted address with 16-byte
// stores. No shared memory, no second pass: each byte is read once and
// written once. The group is 8, 16 or 32 lanes (one 16-byte vector of 8
// values per lane, c <= 256), or a warp holding 2, 4 or 8 vectors per lane
// (c <= 2048). Rows go to groups in the order of the contiguous side (x for
// kernel 12; res and y for kernel 13), so that side streams and the other
// is touched in whole-row pieces of at least 256 B. One row per group and
// no grid-stride loop: the 16^2 sites have 16,384 rows at batch 4, 2,048
// blocks of 8 rows, several per SM, so every SM has loads in flight.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_rows.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_VECS = 256;  // c <= 2048

// UNFOLD false (kernel 12): src x in (b, f, p) row order, dst y in
// ((b p), f) order. UNFOLD true (kernel 13): src out in ((b p), f) order,
// res and dst y in (b, f, p) order. `row` runs over (b, f, p).
template <int GROUP, int VPL, bool UNFOLD>
__global__ void __launch_bounds__(THREADS)
    ln_relayout_kernel(const __nv_bfloat16* __restrict__ src,
                       const __nv_bfloat16* __restrict__ res, const float* __restrict__ g,
                       __nv_bfloat16* __restrict__ dst, int frames, int hw, int c,
                       long long rows, float eps) {
  const int lane = threadIdx.x % GROUP;
  const long long row = static_cast<long long>(blockIdx.x) * (THREADS / GROUP) +
                        threadIdx.x / GROUP;
  const bool valid = row < rows;  // invalid lanes still join the shuffles
  const int nvec = c / 8;
  const long long p = row % hw;
  const long long bf = row / hw;
  const long long folded = (bf / frames * hw + p) * frames + bf % frames;
  const long long src_row = UNFOLD ? folded : row;
  const long long dst_row = UNFOLD ? row : folded;

  float v[VPL * 8];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int vec = j * GROUP + lane;
    if (valid && vec < nvec) {
      unpack8(*reinterpret_cast<const uint4*>(src + src_row * c + vec * 8), v + 8 * j);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[8 * j + i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += v[8 * j + i];
  }
  const float mean = group_sum<GROUP>(sum) / c;

  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const bool live = valid && j * GROUP + lane < nvec;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float d = live ? v[8 * j + i] - mean : 0.f;
      v[8 * j + i] = d;
      sq += d * d;
    }
  }
  const float inv = rsqrtf(group_sum<GROUP>(sq) / c + eps);

#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int vec = j * GROUP + lane;
    if (!(valid && vec < nvec)) continue;
    float y[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) y[i] = v[8 * j + i] * inv * __ldg(g + vec * 8 + i);
    if constexpr (UNFOLD) {
      float r[8];
      unpack8(*reinterpret_cast<const uint4*>(res + dst_row * c + vec * 8), r);
#pragma unroll
      for (int i = 0; i < 8; ++i) y[i] += r[i];
    }
    *reinterpret_cast<uint4*>(dst + dst_row * c + vec * 8) = pack8(y);
  }
}

template <int GROUP, int VPL, bool UNFOLD>
cudaError_t run(const void* src, const void* res, const void* g, void* dst, int frames, int hw,
                int c, long long rows, float eps, cudaStream_t s) {
  constexpr int rows_per_block = THREADS / GROUP;
  const long long grid = (rows + rows_per_block - 1) / rows_per_block;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  ln_relayout_kernel<GROUP, VPL, UNFOLD><<<static_cast<unsigned>(grid), THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(src), static_cast<const __nv_bfloat16*>(res),
      static_cast<const float*>(g), static_cast<__nv_bfloat16*>(dst), frames, hw, c, rows, eps);
  return cudaGetLastError();
}

template <bool UNFOLD>
int launch(const void* src, const void* res, const void* g, void* dst, int b, int frames,
           int hw, int c, float eps, void* stream) {
  if (b < 1 || frames < 1 || hw < 1 || c < 8 || c % 8 || c / 8 > MAX_VECS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(b) * frames * hw;
  const int nvec = c / 8;
  if (nvec <= 8) return run<8, 1, UNFOLD>(src, res, g, dst, frames, hw, c, rows, eps, s);
  if (nvec <= 16) return run<16, 1, UNFOLD>(src, res, g, dst, frames, hw, c, rows, eps, s);
  if (nvec <= 32) return run<32, 1, UNFOLD>(src, res, g, dst, frames, hw, c, rows, eps, s);
  if (nvec <= 64) return run<32, 2, UNFOLD>(src, res, g, dst, frames, hw, c, rows, eps, s);
  if (nvec <= 128) return run<32, 4, UNFOLD>(src, res, g, dst, frames, hw, c, rows, eps, s);
  return run<32, 8, UNFOLD>(src, res, g, dst, frames, hw, c, rows, eps, s);
}

}  // namespace

// x (b, frames, hw, c) bf16 contiguous, g fp32 (c,), y ((b hw), frames, c)
// bf16; c % 8 == 0, c <= 2048, pointers 16-byte aligned.
extern "C" int ln_transpose_bf16(const void* x, const void* g, void* y, int b, int frames,
                                 int hw, int c, float eps, void* stream) {
  return launch<false>(x, nullptr, g, y, b, frames, hw, c, eps, stream);
}

// out ((b hw), frames, c) and res (b, frames, hw, c) bf16 contiguous, g fp32
// (c,), y (b, frames, hw, c) bf16; the same limits.
extern "C" int norm_untranspose_bf16(const void* out, const void* res, const void* g, void* y,
                                     int b, int frames, int hw, int c, float eps,
                                     void* stream) {
  return launch<true>(out, res, g, y, b, frames, hw, c, eps, stream);
}
