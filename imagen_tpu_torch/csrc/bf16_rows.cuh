// Building blocks of the row kernels of csrc/ (a group of lanes owns one
// contiguous row of bf16 values): 16-byte vectors of 8 bf16 values unpacked
// to fp32 and packed back, and sums and maxima over the lanes of a group.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// 8 consecutive fp32 values (32-byte aligned) through the read-only cache
__device__ __forceinline__ void load8(const float* __restrict__ p, float* f) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// Sum over the GROUP lanes of a row; every lane of the warp takes part.
template <int GROUP>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = GROUP / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o, GROUP);
  return v;
}

template <int GROUP>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = GROUP / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o, GROUP));
  return v;
}

}  // namespace
