// ChanRMSNorm -> FiLM -> SiLU over the channels of an NHWC tensor, bf16, for
// sm_90a: kernel 8 of the port.
//
//   y = silu(x * rsqrt(max(sum_c x^2, 1e-24)) * sqrt(C) * gamma * (scale[b] + 1) + shift[b])
//
// Replaces `fused_film_norm` -> `_forward` of imagen_tpu/ops/fused_norm.py
// (its pallas_call at :63 over `_kernel`): the prologue of every 2-D `Block`
// of the U-Nets. Arithmetic as in `_kernel` and `_xla_reference`: x widened
// to fp32, the fp32 sum of squares, gamma fp32, scale and shift read in bf16
// and widened, one rounding to bf16 at the end. Without scale/shift (the
// first block of a ResnetBlock) the FiLM is the identity, as the JAX zeros.
//
// What bounds it on the H100: bytes. It reads x and writes y once, about 10
// flops per element against 4 bytes. The largest call of the EDM path is
// SRUnet256's 256^2 site at batch 8 with C 128: 524,288 rows, 268 MB in and
// out, 0.080 ms at 3.35 TB/s.
//
// Design. The C values of one (b, pixel) row are contiguous in NHWC, so a
// group of lanes owns a row: it reads it once with 16-byte loads, keeps it
// in registers as packed bf16 (4 registers per 8 values), reduces the sum of
// squares by shuffles inside the group, and writes silu(...) with 16-byte
// stores; gamma, scale[b] and shift[b] come through the read-only cache,
// which every row of a batch shares. No shared memory and each byte moves
// once. C runs from 128 to 3584 on the path: the group is 16 or 32 lanes with
// one vector each (C <= 256), or a warp holding 2 to 16 vectors a lane
// (C <= 4096, 64 registers for the row at the top), so one warp always holds
// its row and no block-wide reduction is needed. One row per group and no
// grid-stride loop: the 256^2 sites give 32,768 blocks of 16 rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_rows.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_VECS = 512;  // C <= 4096

template <int GROUP, int VPL>
__global__ void __launch_bounds__(THREADS)
    film_norm_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
                     const __nv_bfloat16* __restrict__ scale,
                     const __nv_bfloat16* __restrict__ shift, __nv_bfloat16* __restrict__ y,
                     long long rows, int hw, int c, long long film_stride) {
  const int lane = threadIdx.x % GROUP;
  const long long row = static_cast<long long>(blockIdx.x) * (THREADS / GROUP) +
                        threadIdx.x / GROUP;
  const bool valid = row < rows;  // invalid lanes still join the shuffles
  const int nvec = c / 8;
  const __nv_bfloat16* xr = x + row * c;

  uint4 raw[VPL];
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int vec = j * GROUP + lane;
    if (valid && vec < nvec) {
      raw[j] = *reinterpret_cast<const uint4*>(xr + vec * 8);
      float f[8];
      unpack8(raw[j], f);
#pragma unroll
      for (int i = 0; i < 8; ++i) sq += f[i] * f[i];
    }
  }
  const float inv = rsqrtf(fmaxf(group_sum<GROUP>(sq), 1e-24f)) * sqrtf(static_cast<float>(c));
  if (!valid) return;

  const bool film = scale != nullptr;
  const long long film_row = (row / hw) * film_stride;
  __nv_bfloat16* yr = y + row * c;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int vec = j * GROUP + lane;
    if (vec >= nvec) continue;
    float f[8], g[8];
    unpack8(raw[j], f);
    load8(gamma + vec * 8, g);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] *= inv * g[i];
    if (film) {
      float s[8], h[8];
      unpack8(__ldg(reinterpret_cast<const uint4*>(scale + film_row + vec * 8)), s);
      unpack8(__ldg(reinterpret_cast<const uint4*>(shift + film_row + vec * 8)), h);
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = f[i] * (s[i] + 1.f) + h[i];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = f[i] / (1.f + __expf(-f[i]));
    *reinterpret_cast<uint4*>(yr + vec * 8) = pack8(f);
  }
}

template <int GROUP, int VPL>
cudaError_t run(const void* x, const void* gamma, const void* scale, const void* shift, void* y,
                long long rows, int hw, int c, long long film_stride, cudaStream_t s) {
  constexpr int rows_per_block = THREADS / GROUP;
  const long long grid = (rows + rows_per_block - 1) / rows_per_block;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  film_norm_kernel<GROUP, VPL><<<static_cast<unsigned>(grid), THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<const __nv_bfloat16*>(scale), static_cast<const __nv_bfloat16*>(shift),
      static_cast<__nv_bfloat16*>(y), rows, hw, c, film_stride);
  return cudaGetLastError();
}

}  // namespace

// x (b, hw, c) bf16 contiguous, gamma (c,) fp32, scale and shift bf16 rows
// of c values film_stride elements apart per batch (both null, and
// film_stride 0, for no FiLM), y like x; c % 8 == 0, c <= 4096, every pointer
// and film_stride * 2 bytes 16-byte aligned.
extern "C" int fused_film_norm_bf16(const void* x, const void* gamma, const void* scale,
                                    const void* shift, void* y, int b, int hw, int c,
                                    long long film_stride, void* stream) {
  if (b < 1 || hw < 1 || c < 8 || c % 8 || c / 8 > MAX_VECS ||
      (scale == nullptr) != (shift == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(b) * hw;
  const int nvec = c / 8;
#define FILM_RUN(G, V) run<G, V>(x, gamma, scale, shift, y, rows, hw, c, film_stride, s)
  if (nvec <= 8) return FILM_RUN(8, 1);
  if (nvec <= 16) return FILM_RUN(16, 1);
  if (nvec <= 32) return FILM_RUN(32, 1);
  if (nvec <= 64) return FILM_RUN(32, 2);
  if (nvec <= 128) return FILM_RUN(32, 4);
  if (nvec <= 256) return FILM_RUN(32, 8);
  return FILM_RUN(32, 16);
#undef FILM_RUN
}
