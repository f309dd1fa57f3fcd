// Row LayerNorm routines shared by the fused feedforward (kernel 10,
// fused_feedforward.cu) and the LayerNorm<->matmul kernels (kernel 11,
// fused_ln_matmul.cu): the bias-free LayerNorm of one 16-byte chunk against
// its row's statistics, a row LayerNorm of a row-major matrix a warp a row,
// and a row statistic summed over the blocks of a thread block cluster in
// rank order. The statistics are fp32 and taken in two passes (the mean, then
// the centred squares), as the JAX kernels take them.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

#include "bf16_rows.cuh"
#include "hopper.cuh"

namespace {

constexpr int MAX_CLUSTER = 8;   // blocks of a cluster: the statistics buffers hold 8 ranks

// Sum of 8 bf16 values, and of their squared distances from `mean`.
__device__ __forceinline__ float sum8(const uint4& v) {
  float f[8];
  unpack8(v, f);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += f[i];
  return s;
}
__device__ __forceinline__ float sqdev8(const uint4& v, float mean) {
  float f[8];
  unpack8(v, f);
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) q += (f[i] - mean) * (f[i] - mean);
  return q;
}

// 8 bf16 values normalised with their row's mean and rstd and the fp32 gains
// gs, rounded to bf16.
__device__ __forceinline__ uint4 ln_chunk_gains(const uint4& v, float mean, float rstd,
                                                const float (&gs)[8]) {
  float f[8];
  unpack8(v, f);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = (f[i] - mean) * rstd * gs[i];
  return pack8(f);
}
// The same with the gains at g[0 .. 7] (32-byte aligned).
__device__ __forceinline__ uint4 ln_chunk(const uint4& v, float mean, float rstd,
                                          const float* __restrict__ g) {
  float gs[8];
  load8(g, gs);
  return ln_chunk_gains(v, mean, rstd, gs);
}

// A bias-free LayerNorm of row `row` of c columns (c % 8 == 0, rows 16-byte
// aligned) by one warp; `out` may be `in`.
__device__ __forceinline__ void row_layernorm(const __nv_bfloat16* in, const float* __restrict__ g,
                                              __nv_bfloat16* out, int row, int c, float eps,
                                              int lane) {
  const uint4* src = reinterpret_cast<const uint4*>(in + (size_t)row * c);
  uint4* dst = reinterpret_cast<uint4*>(out + (size_t)row * c);
  float s = 0.f;
  for (int i = lane; i < c / 8; i += 32) s += sum8(src[i]);
  const float mean = group_sum<32>(s) / c;
  float q = 0.f;
  for (int i = lane; i < c / 8; i += 32) q += sqdev8(src[i], mean);
  const float rstd = rsqrtf(group_sum<32>(q) / c + eps);
  for (int i = lane; i < c / 8; i += 32) dst[i] = ln_chunk(src[i], mean, rstd, g + i * 8);
}

// A row statistic over a row whose columns are split over the blocks of a
// cluster, the same bits in every run. Every one of the 256 consumer threads
// (threads 0 .. 255, two warpgroups) calls it with its partials a (block row
// r) and b (row r + 8) over its accumulator columns; they are summed over the
// thread's quad, then per block row in `red` (128 floats): with SHARED_ROWS
// the two warpgroups hold the same 64 rows and the block's partial is
// warpgroup 0's sum plus 1's; without, each holds its own rows. The block's
// partial goes into slot `rank` of every block's `stats` ([MAX_CLUSTER][BM])
// and, after a cluster barrier that every thread of the cluster passes, a
// and b become the cl slots summed in rank order.
template <int BM, bool SHARED_ROWS>
__device__ __forceinline__ void cluster_row_total(float& a, float& b, int r, float* red,
                                                  float* stats, int rank, int cl) {
  const int lane = threadIdx.x % 32, wg = threadIdx.x / 128, ct = threadIdx.x;
  a += __shfl_xor_sync(0xffffffffu, a, 1);
  a += __shfl_xor_sync(0xffffffffu, a, 2);
  b += __shfl_xor_sync(0xffffffffu, b, 1);
  b += __shfl_xor_sync(0xffffffffu, b, 2);
  if (lane % 4 == 0) {
    const int at = SHARED_ROWS ? wg * 64 + r : r;
    red[at] = a;
    red[at + 8] = b;
  }
  named_sync(1, 256);
  if (ct < BM) {
    const float part = SHARED_ROWS ? red[ct] + red[64 + ct] : red[ct];
    const uint32_t at = smem_u32(stats + rank * BM + ct);
    for (int dst = 0; dst < cl; ++dst) st_cluster(map_rank(at, dst), part);
  }
  cluster_sync();  // every block's partials are in
  a = stats[r];
  b = stats[r + 8];
  for (int src = 1; src < cl; ++src) {
    a += stats[src * BM + r];
    b += stats[src * BM + r + 8];
  }
}

}  // namespace
