// Bias-free LayerNorm over the last axis, with the optional stable variant,
// bf16, for sm_90a: kernel 9 of the port.
//
//   stable: x <- x / max_c(x)   (the signed row max, as the module divides)
//   y = (x - mean) * rsqrt(mean((x - mean)^2) + eps) * g
//
// Replaces `fused_layernorm` -> `_ln_forward` of imagen_tpu/ops/fused_norm.py
// (its pallas_call at :155 over `_ln_kernel`). Arithmetic as `_ln_kernel`:
// x widened to fp32, the division by the row max in fp32, the fp32 mean and
// then the variance of the centred row, the fp32 gain, one rounding to bf16.
// The JAX package wires it nowhere (`models/blocks.py` keeps the module's
// LayerNorm), and neither does the port.
//
// What bounds it on the H100: bytes, x read and y written once, 5-8 flops
// per element. At the EDM path's largest LayerNorm site, BaseUnet64's
// attention pre-norm at 32^2 and batch 8 (8192 rows of 1024), 33.6 MB:
// 0.010 ms at 3.35 TB/s.
//
// Design: kernel 12's row LayerNorm (csrc/temporal_layout.cu) with the
// identity map. A group of lanes owns a row, reads it once with 16-byte
// loads into registers as packed bf16, reduces the max (stable), the sum and
// the centred sum of squares by shuffles inside the group, and writes the
// row with 16-byte stores. The group is 16 or 32 lanes with one vector
// each (C <= 256), or a warp holding 2 to 16 vectors a lane (C <= 4096).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_rows.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_VECS = 512;  // C <= 4096

template <int GROUP, int VPL, bool STABLE>
__global__ void __launch_bounds__(THREADS)
    layernorm_rows_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ g,
                          __nv_bfloat16* __restrict__ y, long long rows, int c, float eps) {
  const int lane = threadIdx.x % GROUP;
  const long long row = static_cast<long long>(blockIdx.x) * (THREADS / GROUP) +
                        threadIdx.x / GROUP;
  const bool valid = row < rows;  // invalid lanes still join the shuffles
  const int nvec = c / 8;

  uint4 raw[VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int vec = j * GROUP + lane;
    if (valid && vec < nvec) raw[j] = *reinterpret_cast<const uint4*>(x + row * c + vec * 8);
  }
  auto live = [&](int j) { return valid && j * GROUP + lane < nvec; };

  float rmax = 1.f;
  if constexpr (STABLE) {
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      if (!live(j)) continue;
      float f[8];
      unpack8(raw[j], f);
#pragma unroll
      for (int i = 0; i < 8; ++i) m = fmaxf(m, f[i]);
    }
    rmax = group_max<GROUP>(m);
  }

  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    if (!live(j)) continue;
    float f[8];
    unpack8(raw[j], f);
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += STABLE ? f[i] / rmax : f[i];
  }
  const float mean = group_sum<GROUP>(sum) / c;

  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    if (!live(j)) continue;
    float f[8];
    unpack8(raw[j], f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float d = (STABLE ? f[i] / rmax : f[i]) - mean;
      sq += d * d;
    }
  }
  const float inv = rsqrtf(group_sum<GROUP>(sq) / c + eps);

#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    if (!live(j)) continue;
    const int vec = j * GROUP + lane;
    float f[8], gv[8];
    unpack8(raw[j], f);
    load8(g + vec * 8, gv);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = ((STABLE ? f[i] / rmax : f[i]) - mean) * inv * gv[i];
    *reinterpret_cast<uint4*>(y + row * c + vec * 8) = pack8(f);
  }
}

template <int GROUP, int VPL>
cudaError_t run(const void* x, const void* g, void* y, long long rows, int c, bool stable,
                float eps, cudaStream_t s) {
  constexpr int rows_per_block = THREADS / GROUP;
  const long long grid = (rows + rows_per_block - 1) / rows_per_block;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* gf = static_cast<const float*>(g);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  if (stable)
    layernorm_rows_kernel<GROUP, VPL, true>
        <<<static_cast<unsigned>(grid), THREADS, 0, s>>>(xb, gf, yb, rows, c, eps);
  else
    layernorm_rows_kernel<GROUP, VPL, false>
        <<<static_cast<unsigned>(grid), THREADS, 0, s>>>(xb, gf, yb, rows, c, eps);
  return cudaGetLastError();
}

}  // namespace

// x (rows, c) bf16 contiguous, g (c,) fp32, y (rows, c) bf16; stable 0 or 1;
// c % 8 == 0, c <= 4096, pointers 16-byte aligned.
extern "C" int fused_layernorm_bf16(const void* x, const void* g, void* y, int rows, int c,
                                    int stable, float eps, void* stream) {
  if (rows < 1 || c < 8 || c % 8 || c / 8 > MAX_VECS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nvec = c / 8;
#define LN_RUN(G, V) run<G, V>(x, g, y, rows, c, stable != 0, eps, s)
  if (nvec <= 8) return LN_RUN(8, 1);
  if (nvec <= 16) return LN_RUN(16, 1);
  if (nvec <= 32) return LN_RUN(32, 1);
  if (nvec <= 64) return LN_RUN(32, 2);
  if (nvec <= 128) return LN_RUN(32, 4);
  if (nvec <= 256) return LN_RUN(32, 8);
  return LN_RUN(32, 16);
#undef LN_RUN
}
