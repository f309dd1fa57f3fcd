// Per-pixel causal temporal multi-query attention with a learned bias,
// forward, bf16, for sm_90a.
//
// Replaces, in imagen_tpu/ops/flash_attention.py, the grouped temporal kernel
// (`flash_grouped_cosine` -> `_grouped_packed_forward` at :868, its
// pallas_call at :886 over `_grouped_packed_kernel`) and the rows-packed one
// (`flash_temporal_rows` -> `_temporal_rows_forward` at :1031, pallas_call at
// :1056): both compute this function and differ only in how they pack pixels
// and lay out the bias for the TPU.
//
// What it computes, for each pixel p (P = b * H * W of them):
//   q  (f, h * d) row-major == (R = f * h, d) rows, row r = frame * h + head;
//   kn, v (nk, d), the null key first (nk = f + 1), kn already l2-normalised
//   times k_scale (outside, as `_grouped_packed_forward` does at :877);
//   bias2 (h, f, nk) fp32 = (DynamicPositionBias ++ null bias, with the
//   causal mask folded in as -1e30) * log2(e), one table shared by all pixels.
// Each q row is l2-normalised in fp32 (rsqrt(max(sum q^2, 1e-12))) times
// q_scale * scale * log2(e), rounded to bf16; S = q kn^T + bias2 in fp32; an
// exp2 softmax with fp32 statistics; P rounded to bf16 for P V; the sum
// divided by l after. That is the arithmetic of `_grouped_packed_kernel`.
//
// What bounds it on the H100: bytes. At the 64^2 sites (P 8192, R 128, nk 17,
// d 64) it reads q (134 MB) and kn, v (36 MB) and writes o (134 MB): 0.091 ms
// at 3.35 TB/s, against 4.6 GFLOP (0.005 ms at the bf16 peak). So the design
// reads each byte once, in 16-byte `cp.async` copies, and keeps a load in
// flight while it computes.
//
// Design. The Pallas kernels pack G pixels into one block-diagonal tile
// (about 7% of its score area live); here every pixel is its own small
// product and nothing is wasted on cross-pixel terms. One block of
// ceil(R / 16) warps (8 at R = 128) walks over pixels with a grid stride,
// double-buffering each pixel's q tile (R x d) and its K, V (nk x d, padded
// to 16, 32 or 64 keys, zero-filled) in shared memory with `cp.async`, so the
// next pixel loads while this one computes. Warp w owns rows 16w..16w+15 of
// every pixel; since the bias table is the same for every pixel, each thread
// keeps its share of it in registers for the whole walk. S and P V run as
// mma.sync m16n8k16 bf16 with fp32 accumulation (chosen over fp32 FMAs:
// the same ldmatrix/mma building blocks as the flash kernel, and the two
// products then cost nothing next to the memory traffic); the softmax is a
// single pass, because all keys fit one tile. The output is staged through
// the warp's q rows in shared memory and written in 16-byte stores. The grid
// is the number of blocks that fit the card at once (at most P), so the 512
// pixels of the 16^2 sites still spread over all SMs. No TMA or wgmma yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

constexpr int MAX_WARPS = 8;  // R <= 128 rows
constexpr float NEG = -1e30f;

template <int D, int NKP>
struct Layout {
  static constexpr int LD = D + 8;  // padded row, in elements
  int r16;                          // rows rounded up to 16
  __host__ __device__ size_t q() const { return size_t(r16) * LD * 2; }
  __host__ __device__ static constexpr size_t kv() { return size_t(NKP) * LD * 2; }
  __host__ __device__ size_t stage() const { return q() + 2 * kv(); }
  __host__ __device__ size_t total() const { return 2 * stage() + D * 4; }
};

template <int D, int NKP>
__global__ void __launch_bounds__(MAX_WARPS * 32)
temporal_attn_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const float* __restrict__ q_scale,
                         const float* __restrict__ bias2,
                         __nv_bfloat16* __restrict__ out,
                         int P, int frames, int heads, int nk, float scale2) {
  constexpr int LD = Layout<D, NKP>::LD;
  constexpr int CH = D / 8;  // 16-byte chunks per row
  const int R = frames * heads;
  const Layout<D, NKP> lay{(R + 15) / 16 * 16};
  extern __shared__ __align__(128) unsigned char smem[];
  float* gain = reinterpret_cast<float*>(smem + 2 * lay.stage());

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nthreads = blockDim.x;

  for (int c = threadIdx.x; c < D; c += nthreads) gain[c] = q_scale[c] * scale2;

  auto qs = [&](int stage) {
    return reinterpret_cast<__nv_bfloat16*>(smem + stage * lay.stage());
  };
  auto ks = [&](int stage) {
    return reinterpret_cast<__nv_bfloat16*>(smem + stage * lay.stage() + lay.q());
  };
  auto vs = [&](int stage) {
    return reinterpret_cast<__nv_bfloat16*>(smem + stage * lay.stage() + lay.q() + lay.kv());
  };
  auto load = [&](int p, int stage) {
    const __nv_bfloat16* qp = q + (size_t)p * R * D;
    const __nv_bfloat16* kp = k + (size_t)p * nk * D;
    const __nv_bfloat16* vp = v + (size_t)p * nk * D;
    __nv_bfloat16* Q = qs(stage);
    __nv_bfloat16* K = ks(stage);
    __nv_bfloat16* V = vs(stage);
    for (int i = threadIdx.x; i < lay.r16 * CH; i += nthreads) {
      const int row = i / CH, c = i % CH;
      const bool valid = row < R;
      cp_async16(Q + row * LD + c * 8, qp + (size_t)(valid ? row : 0) * D + c * 8, valid);
    }
    for (int i = threadIdx.x; i < NKP * CH; i += nthreads) {
      const int row = i / CH, c = i % CH;
      const bool valid = row < nk;
      const size_t off = (size_t)(valid ? row : 0) * D + c * 8;
      cp_async16(K + row * LD + c * 8, kp + off, valid);
      cp_async16(V + row * LD + c * 8, vp + off, valid);
    }
    cp_async_commit();
  };

  // this thread's share of the bias table: rows r0 = 16 * warp + lane / 4 and
  // r0 + 8, columns nb * 8 + 2 * (lane % 4) + {0, 1}; padded keys get NEG
  const int r0 = warp * 16 + lane / 4;
  float bias[NKP / 8][4];
#pragma unroll
  for (int nb = 0; nb < NKP / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + (e >= 2 ? 8 : 0);
      const int j = nb * 8 + (lane % 4) * 2 + (e & 1);
      float b = 0.f;
      if (j >= nk) {
        b = NEG;
      } else if (r < R) {
        const int fr = r / heads, hh = r % heads;
        b = bias2[((size_t)hh * frames + fr) * nk + j];
      }
      bias[nb][e] = b;
    }

  int stage = 0;
  if (blockIdx.x < P) load(blockIdx.x, 0);
  for (int p = blockIdx.x; p < P; p += gridDim.x, stage ^= 1) {
    const int pn = p + gridDim.x;
    if (pn < P) {
      load(pn, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    __nv_bfloat16* Q = qs(stage) + warp * 16 * LD;  // this warp's 16 rows
    const __nv_bfloat16* K = ks(stage);
    const __nv_bfloat16* V = vs(stage);

    // --- q prologue: l2norm * q_scale * scale * log2e, in place, two lanes a row ---
    {
      const int lr = lane / 2, half = lane % 2;
      __nv_bfloat162* row = reinterpret_cast<__nv_bfloat162*>(Q + lr * LD + half * (D / 2));
      float ss = 0.f;
#pragma unroll
      for (int c = 0; c < D / 4; ++c) {
        const float2 x = __bfloat1622float2(row[c]);
        ss += x.x * x.x + x.y * x.y;
      }
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      const float inv = rsqrtf(fmaxf(ss, 1e-12f));
      const float* g = gain + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 4; ++c) {
        const float2 x = __bfloat1622float2(row[c]);
        row[c] = __floats2bfloat162_rn((x.x * inv) * g[2 * c], (x.y * inv) * g[2 * c + 1]);
      }
    }
    __syncwarp();
    uint32_t qf[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldmatrix_x4(qf[kk], Q + (lane % 16) * LD + kk * 16 + (lane / 16) * 8);

    // --- S = q kn^T + bias (base-2 scaled) ---
    float s[NKP / 8][4];
#pragma unroll
    for (int nb = 0; nb < NKP / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nb2 = 0; nb2 < NKP / 16; ++nb2) {
        uint32_t b[4];
        ldmatrix_x4(b, K + (nb2 * 16 + lane % 8 + (lane / 16) * 8) * LD + kk * 16 +
                           ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * nb2], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * nb2 + 1], qf[kk], b[2], b[3]);
      }
    }

    // --- one-pass softmax; a row's 4 owners are a quad of lanes ---
    float m0 = NEG, m1 = NEG;
#pragma unroll
    for (int nb = 0; nb < NKP / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] += bias[nb][e];
      m0 = fmaxf(m0, fmaxf(s[nb][0], s[nb][1]));
      m1 = fmaxf(m1, fmaxf(s[nb][2], s[nb][3]));
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ *= 2) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o_));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o_));
    }
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int nb = 0; nb < NKP / 8; ++nb) {
      s[nb][0] = exp2f(s[nb][0] - m0);
      s[nb][1] = exp2f(s[nb][1] - m0);
      s[nb][2] = exp2f(s[nb][2] - m1);
      s[nb][3] = exp2f(s[nb][3] - m1);
      l0 += s[nb][0] + s[nb][1];
      l1 += s[nb][2] + s[nb][3];
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ *= 2) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
    }

    // --- O = P V, P rounded to bf16 straight from the score registers ---
    float o[D / 8][4];
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NKP / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nb2 = 0; nb2 < D / 16; ++nb2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, V + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD +
                                 nb2 * 16 + (lane / 16) * 8);
        mma_bf16(o[2 * nb2], pa, b[0], b[1]);
        mma_bf16(o[2 * nb2 + 1], pa, b[2], b[3]);
      }
    }

    // --- o / l, staged through this warp's q rows, then 16-byte stores ---
    const float il0 = 1.f / l0, il1 = 1.f / l1;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      const int c = nb * 8 + (lane % 4) * 2;
      *reinterpret_cast<__nv_bfloat162*>(Q + (lane / 4) * LD + c) =
          __floats2bfloat162_rn(o[nb][0] * il0, o[nb][1] * il0);
      *reinterpret_cast<__nv_bfloat162*>(Q + (lane / 4 + 8) * LD + c) =
          __floats2bfloat162_rn(o[nb][2] * il1, o[nb][3] * il1);
    }
    __syncwarp();
    __nv_bfloat16* op = out + ((size_t)p * R + warp * 16) * D;
    for (int i = lane; i < 16 * CH; i += 32) {
      const int row = i / CH, c = i % CH;
      if (warp * 16 + row < R)
        *reinterpret_cast<uint4*>(op + (size_t)row * D + c * 8) =
            *reinterpret_cast<const uint4*>(Q + row * LD + c * 8);
    }
    __syncthreads();  // this stage is free for the load two pixels ahead
  }
}

template <int D, int NKP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* q_scale,
                   const void* bias2, void* out, int P, int frames, int heads, int nk,
                   float scale2, cudaStream_t stream) {
  const int R = frames * heads;
  const int warps = (R + 15) / 16;
  const size_t smem = Layout<D, NKP>{warps * 16}.total();
  auto kernel = temporal_attn_fwd_kernel<D, NKP>;
  // host-side setup once per instantiation and block size, for the process's
  // device: the shared memory limit (for the largest block), then the number
  // of blocks that fit the whole card at once
  static bool attr_set = false;
  static int resident[MAX_WARPS + 1] = {};
  cudaError_t err;
  if (!attr_set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Layout<D, NKP>{MAX_WARPS * 16}.total());
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  if (resident[warps] == 0) {
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
        cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * 32,
                                                             smem)) != cudaSuccess)
      return err;
    resident[warps] = per_sm * sms;
  }
  const int grid = resident[warps] < P ? resident[warps] : P;
  if (grid < 1) return cudaErrorInvalidConfiguration;
  kernel<<<grid, warps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(q_scale),
      static_cast<const float*>(bias2), static_cast<__nv_bfloat16*>(out), P, frames, heads,
      nk, scale2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_nk(const void* q, const void* k, const void* v, const void* q_scale,
                      const void* bias2, void* out, int P, int frames, int heads, int nk,
                      float scale2, cudaStream_t s) {
  if (nk <= 16) return launch<D, 16>(q, k, v, q_scale, bias2, out, P, frames, heads, nk, scale2, s);
  if (nk <= 32) return launch<D, 32>(q, k, v, q_scale, bias2, out, P, frames, heads, nk, scale2, s);
  if (nk <= 64) return launch<D, 64>(q, k, v, q_scale, bias2, out, P, frames, heads, nk, scale2, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (P, frames * heads, d), k (normalised) and v (P, nk, d), bf16 contiguous;
// q_scale fp32 (d,); bias2 fp32 (heads, frames, nk), already times log2(e);
// out (P, frames * heads, d) bf16. d in {16, 32, 64, 128}, nk <= 64,
// frames * heads <= 128; scale2 = scale * log2(e).
extern "C" int temporal_attn_fwd_bf16(const void* q, const void* k, const void* v,
                                      const void* q_scale, const void* bias2, void* out, int P,
                                      int frames, int heads, int nk, int d, float scale2,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P < 1 || frames < 1 || heads < 1 || nk < 1 || frames * heads > MAX_WARPS * 16)
    return (int)cudaErrorInvalidValue;
  switch (d) {
    case 16: return launch_nk<16>(q, k, v, q_scale, bias2, out, P, frames, heads, nk, scale2, s);
    case 32: return launch_nk<32>(q, k, v, q_scale, bias2, out, P, frames, heads, nk, scale2, s);
    case 64: return launch_nk<64>(q, k, v, q_scale, bias2, out, P, frames, heads, nk, scale2, s);
    case 128: return launch_nk<128>(q, k, v, q_scale, bias2, out, P, frames, heads, nk, scale2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
