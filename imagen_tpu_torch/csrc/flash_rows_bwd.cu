// Flash multi-query attention over rows, backward, bf16, for sm_90a.
//
// Replaces the backward of imagen_tpu/ops/flash_attention.py: both of its
// Pallas tiers, `_flash_rows_backward_oneshot` (the whole K/V resident) and
// `_flash_rows_backward_impl`'s dq and dkv kernels (K streamed), which compute
// the same function and differ only in how they fit VMEM.
//
// In: q, dO (b, R, D) and k, v (b, nk, D), bf16; the forward's row
// log2-sum-exp2 `lse` (b, R) in the scaled base-2 domain and
// delta = rowsum(dO * O) (b, R), fp32. With c = scale * log2(e):
//   S  = (q k^T) * c           P  = exp2(S - lse)   (0 at keys >= nk)
//   dP = dO v^T                dS = P * (dP - delta) * scale
//   dq = dS k    dk = dS^T q   dv = P^T dO
// q is the normalised q the backward recomputes, unscaled: c is applied to
// the fp32 scores, as the Pallas kernels do. P is rounded to bf16 before
// P^T dO and dS before dS k and dS^T q (`:475-487` of the JAX module); every
// product accumulates in fp32 and the outputs are rounded to bf16 once.
//
// What bounds it on the H100: at the slice's shape (b 8, R 8192, nk 1063,
// D 64) the work is 2.5x the forward's tensor-core flops (5 products of
// 2*R*nk*D), against 4*R*D + 4*nk*D bf16 bytes of I/O, so the tensor cores
// bound it. Design: two kernels, deterministic, with no atomics.
// - dK/dV: one block of 4 warps per (batch, 64-key tile); each warp owns 16
//   keys. The block streams all R query rows through shared memory in 64-row
//   tiles of q and dO (with their lse and delta), double-buffered by cp.async,
//   and computes S^T and dP^T key-major, so P^T and dS^T come out of the
//   accumulators already in the A layout of P^T dO and dS^T q. The dK and dV
//   accumulators stay in fp32 registers over the whole loop: the multi-query
//   head reduction is this loop over R.
// - dQ: one block of 8 warps per (batch, 128-row tile), 16 rows per warp,
//   q and dO held in registers; K/V stream in 64-key tiles as in the forward.
// Both recompute S and dP with mma.sync m16n8k16 from ldmatrix over rows
// padded by 16 bytes, as the forward does. The ragged key tail is zero-filled
// by cp.async and P is zeroed there; rows past R and keys past nk are never
// written. Simple first: the dK/dV grid is b * ceil(nk / 64) blocks (136 at
// b 8), about one block per SM; splitting R across blocks with a second-pass
// sum is the later speed-up, as are wgmma and TMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

constexpr int BK = 64;          // keys per dK/dV block, keys per dQ tile
constexpr int BR = 64;          // q rows per step of the dK/dV loop
constexpr int KV_WARPS = BK / 16;
constexpr int KV_THREADS = KV_WARPS * 32;
constexpr int BQ = 128;         // q rows per dQ block
constexpr int Q_WARPS = BQ / 16;
constexpr int Q_THREADS = Q_WARPS * 32;

template <int D>
struct KvSmem {
  static constexpr int LD = D + 8;                  // padded row, in elements
  static constexpr size_t keys = size_t(BK) * LD * 2;  // the K or the V tile
  static constexpr size_t rows = size_t(BR) * LD * 2;  // one q or dO tile
  static constexpr size_t stats = size_t(BR) * 4;      // one lse or delta tile
  // K, V; q and dO in two stages; lse and delta in two stages
  static constexpr size_t total = 2 * keys + 4 * rows + 4 * stats;
};

template <int D>
struct QSmem {
  static constexpr int LD = D + 8;
  static constexpr size_t rows = size_t(BQ) * LD * 2;  // the q or the dO tile
  static constexpr size_t keys = size_t(BK) * LD * 2;  // one K or V tile
  static constexpr size_t total = 2 * rows + 4 * keys; // K and V in two stages
};

// A fragment (16 x 16 at column kk * 16) of a row-major tile whose warp rows
// start at row0
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* t, int LD,
                                       int row0, int kk, int lane) {
  ldmatrix_x4(a, t + (row0 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
}

// B fragments of two n8 blocks (rows n0..n0+15 of a [n][k] tile, k at kk * 16):
// b[0..1] for n0..n0+7, b[2..3] for n0+8..n0+15
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const __nv_bfloat16* t, int LD,
                                          int n0, int kk, int lane) {
  ldmatrix_x4(b, t + (n0 + lane % 8 + (lane / 16) * 8) * LD + kk * 16 + ((lane / 8) % 2) * 8);
}

// B fragments of two n8 blocks (columns n0..n0+15 of a [k][n] tile, k rows
// at kk * 16)
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const __nv_bfloat16* t, int LD,
                                          int n0, int kk, int lane) {
  ldmatrix_x4_trans(b, t + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD + n0 +
                           (lane / 16) * 8);
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.f;
}

// Store a warp's 16 x D fp32 accumulator as bf16 rows r (lane / 4) and r + 8.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[D / 8][4],
                                           int r0, int n_rows, int lane) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    const int c = nb * 8 + (lane % 4) * 2;
    if (r0 < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r0 * D + c) =
          __floats2bfloat162_rn(acc[nb][0], acc[nb][1]);
    if (r1 < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r1 * D + c) =
          __floats2bfloat162_rn(acc[nb][2], acc[nb][3]);
  }
}

template <int D>
__global__ void __launch_bounds__(KV_THREADS)
flash_rows_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv,
                           int rows, int nk, float scale) {
  using S = KvSmem<D>;
  constexpr int LD = S::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + S::keys);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + 2 * S::keys);
  __nv_bfloat16* dOs = reinterpret_cast<__nv_bfloat16*>(smem + 2 * S::keys + 2 * S::rows);
  float* Ls = reinterpret_cast<float*>(smem + 2 * S::keys + 4 * S::rows);
  float* Ds = Ls + 2 * BR;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bb = blockIdx.y;
  const int key0 = blockIdx.x * BK;
  const float scale2 = scale * 1.4426950408889634f;
  const __nv_bfloat16* qb = q + (size_t)bb * rows * D;
  const __nv_bfloat16* dob = dout + (size_t)bb * rows * D;
  const float* lb = lse + (size_t)bb * rows;
  const float* db = delta + (size_t)bb * rows;

  // this block's K and V tile, once
  {
    const __nv_bfloat16* kb = k + (size_t)bb * nk * D;
    const __nv_bfloat16* vb = v + (size_t)bb * nk * D;
    for (int i = threadIdx.x; i < BK * (D / 8); i += KV_THREADS) {
      const int j = i / (D / 8), c = i % (D / 8);
      const bool valid = key0 + j < nk;
      const size_t off = (size_t)(valid ? key0 + j : 0) * D + c * 8;
      cp_async16(Ks + j * LD + c * 8, kb + off, valid);
      cp_async16(Vs + j * LD + c * 8, vb + off, valid);
    }
    cp_async_commit();
  }

  // rows past R load as zeros: q = dO = 0 there, so they add nothing
  auto load_rows = [&](int t, int stage) {
    const int r0 = t * BR;
    for (int i = threadIdx.x; i < BR * (D / 8); i += KV_THREADS) {
      const int j = i / (D / 8), c = i % (D / 8);
      const bool valid = r0 + j < rows;
      const size_t off = (size_t)(valid ? r0 + j : 0) * D + c * 8;
      cp_async16(Qs + (stage * BR + j) * LD + c * 8, qb + off, valid);
      cp_async16(dOs + (stage * BR + j) * LD + c * 8, dob + off, valid);
    }
    for (int j = threadIdx.x; j < BR; j += KV_THREADS) {
      const bool valid = r0 + j < rows;
      const int r = valid ? r0 + j : 0;
      cp_async4(Ls + stage * BR + j, lb + r, valid);
      cp_async4(Ds + stage * BR + j, db + r, valid);
    }
    cp_async_commit();
  };
  load_rows(0, 0);

  // this thread's two keys (accumulator rows lane / 4 and lane / 4 + 8)
  const bool key_ok0 = key0 + warp * 16 + lane / 4 < nk;
  const bool key_ok1 = key0 + warp * 16 + lane / 4 + 8 < nk;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);

  const int num_tiles = (rows + BR - 1) / BR;
  for (int t = 0; t < num_tiles; ++t) {
    if (t + 1 < num_tiles) {
      load_rows(t + 1, (t + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Qt = Qs + (t & 1) * BR * LD;
    const __nv_bfloat16* dOt = dOs + (t & 1) * BR * LD;
    const float* Lt = Ls + (t & 1) * BR;
    const float* Dt = Ds + (t & 1) * BR;

    // S^T = K q^T and dP^T = V dO^T: 16 keys x BR rows per warp
    float st[BR / 8][4], dpt[BR / 8][4];
    zero(st);
    zero(dpt);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a(ka, Ks, LD, warp * 16, kk, lane);
      load_a(va, Vs, LD, warp * 16, kk, lane);
#pragma unroll
      for (int nb2 = 0; nb2 < BR / 16; ++nb2) {
        uint32_t b[4];
        load_b_nk(b, Qt, LD, nb2 * 16, kk, lane);
        mma_bf16(st[2 * nb2], ka, b[0], b[1]);
        mma_bf16(st[2 * nb2 + 1], ka, b[2], b[3]);
        load_b_nk(b, dOt, LD, nb2 * 16, kk, lane);
        mma_bf16(dpt[2 * nb2], va, b[0], b[1]);
        mma_bf16(dpt[2 * nb2 + 1], va, b[2], b[3]);
      }
    }

    // P^T into st, dS^T into dpt; columns are q rows of the tile
#pragma unroll
    for (int nb = 0; nb < BR / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nb * 8 + (lane % 4) * 2 + (e & 1);
        const bool ok = e < 2 ? key_ok0 : key_ok1;
        const float p = ok ? exp2f(st[nb][e] * scale2 - Lt[col]) : 0.f;
        st[nb][e] = p;
        dpt[nb][e] = p * (dpt[nb][e] - Dt[col]) * scale;
      }
    }

    // dV += P^T dO and dK += dS^T q, over the tile's rows
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk) {
      uint32_t pa[4], dsa[4];
      acc_to_a(pa, st[2 * kk], st[2 * kk + 1]);
      acc_to_a(dsa, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int nb2 = 0; nb2 < D / 16; ++nb2) {
        uint32_t b[4];
        load_b_kn(b, dOt, LD, nb2 * 16, kk, lane);
        mma_bf16(dv_acc[2 * nb2], pa, b[0], b[1]);
        mma_bf16(dv_acc[2 * nb2 + 1], pa, b[2], b[3]);
        load_b_kn(b, Qt, LD, nb2 * 16, kk, lane);
        mma_bf16(dk_acc[2 * nb2], dsa, b[0], b[1]);
        mma_bf16(dk_acc[2 * nb2 + 1], dsa, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is free for the load two tiles ahead
  }

  const int r0 = key0 + warp * 16 + lane / 4;
  store_rows<D>(dk + (size_t)bb * nk * D, dk_acc, r0, nk, lane);
  store_rows<D>(dv + (size_t)bb * nk * D, dv_acc, r0, nk, lane);
}

template <int D>
__global__ void __launch_bounds__(Q_THREADS)
flash_rows_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq,
                         int rows, int nk, float scale) {
  using S = QSmem<D>;
  constexpr int LD = S::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dOs = reinterpret_cast<__nv_bfloat16*>(smem + S::rows);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + 2 * S::rows);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + 2 * S::rows + 2 * S::keys);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bb = blockIdx.y;
  const int row0 = blockIdx.x * BQ;
  const float scale2 = scale * 1.4426950408889634f;
  const __nv_bfloat16* kb = k + (size_t)bb * nk * D;
  const __nv_bfloat16* vb = v + (size_t)bb * nk * D;
  const int num_tiles = (nk + BK - 1) / BK;

  {
    const __nv_bfloat16* qb = q + (size_t)bb * rows * D;
    const __nv_bfloat16* dob = dout + (size_t)bb * rows * D;
    for (int i = threadIdx.x; i < BQ * (D / 8); i += Q_THREADS) {
      const int j = i / (D / 8), c = i % (D / 8);
      const bool valid = row0 + j < rows;
      const size_t off = (size_t)(valid ? row0 + j : 0) * D + c * 8;
      cp_async16(Qs + j * LD + c * 8, qb + off, valid);
      cp_async16(dOs + j * LD + c * 8, dob + off, valid);
    }
    cp_async_commit();
  }

  auto load_kv = [&](int t, int stage) {
    const int j0 = t * BK;
    for (int i = threadIdx.x; i < BK * (D / 8); i += Q_THREADS) {
      const int j = i / (D / 8), c = i % (D / 8);
      const bool valid = j0 + j < nk;
      const size_t off = (size_t)(valid ? j0 + j : 0) * D + c * 8;
      cp_async16(Ks + (stage * BK + j) * LD + c * 8, kb + off, valid);
      cp_async16(Vs + (stage * BK + j) * LD + c * 8, vb + off, valid);
    }
    cp_async_commit();
  };
  load_kv(0, 0);

  // this thread's two rows: lane / 4 and lane / 4 + 8 of the warp's 16
  const int r0 = row0 + warp * 16 + lane / 4, r1 = r0 + 8;
  const size_t sb = (size_t)bb * rows;
  const float L0 = r0 < rows ? lse[sb + r0] : 0.f, L1 = r1 < rows ? lse[sb + r1] : 0.f;
  const float D0 = r0 < rows ? delta[sb + r0] : 0.f, D1 = r1 < rows ? delta[sb + r1] : 0.f;

  cp_async_wait<1>();  // q and dO have landed
  __syncthreads();
  uint32_t qf[D / 16][4], dof[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a(qf[kk], Qs, LD, warp * 16, kk, lane);
    load_a(dof[kk], dOs, LD, warp * 16, kk, lane);
  }

  float dq_acc[D / 8][4];
  zero(dq_acc);

  for (int t = 0; t < num_tiles; ++t) {
    if (t + 1 < num_tiles) {
      load_kv(t + 1, (t + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + (t & 1) * BK * LD;
    const __nv_bfloat16* Vt = Vs + (t & 1) * BK * LD;

    // S = q K^T and dP = dO V^T: 16 rows x BK keys per warp
    float s[BK / 8][4], dp[BK / 8][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nb2 = 0; nb2 < BK / 16; ++nb2) {
        uint32_t b[4];
        load_b_nk(b, Kt, LD, nb2 * 16, kk, lane);
        mma_bf16(s[2 * nb2], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * nb2 + 1], qf[kk], b[2], b[3]);
        load_b_nk(b, Vt, LD, nb2 * 16, kk, lane);
        mma_bf16(dp[2 * nb2], dof[kk], b[0], b[1]);
        mma_bf16(dp[2 * nb2 + 1], dof[kk], b[2], b[3]);
      }
    }

    // dS into dp
    const int j0 = t * BK;
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = j0 + nb * 8 + (lane % 4) * 2 + (e & 1) < nk;
        const float L = e < 2 ? L0 : L1, Dl = e < 2 ? D0 : D1;
        const float p = ok ? exp2f(s[nb][e] * scale2 - L) : 0.f;
        dp[nb][e] = p * (dp[nb][e] - Dl) * scale;
      }
    }

    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t dsa[4];
      acc_to_a(dsa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int nb2 = 0; nb2 < D / 16; ++nb2) {
        uint32_t b[4];
        load_b_kn(b, Kt, LD, nb2 * 16, kk, lane);
        mma_bf16(dq_acc[2 * nb2], dsa, b[0], b[1]);
        mma_bf16(dq_acc[2 * nb2 + 1], dsa, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is free for the load two tiles ahead
  }

  store_rows<D>(dq + sb * D, dq_acc, r0, rows, lane);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, void* dk, void* dv, int b,
                   int rows, int nk, float scale, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  cudaError_t err = cudaFuncSetAttribute(flash_rows_bwd_dkdv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)KvSmem<D>::total);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_rows_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)QSmem<D>::total);
  if (err != cudaSuccess) return err;
  const bf *q_ = static_cast<const bf*>(q), *k_ = static_cast<const bf*>(k),
           *v_ = static_cast<const bf*>(v), *do_ = static_cast<const bf*>(dout);
  const float *l_ = static_cast<const float*>(lse), *d_ = static_cast<const float*>(delta);
  flash_rows_bwd_dkdv_kernel<D><<<dim3((nk + BK - 1) / BK, b), KV_THREADS, KvSmem<D>::total,
                                  stream>>>(q_, k_, v_, do_, l_, d_, static_cast<bf*>(dk),
                                            static_cast<bf*>(dv), rows, nk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_rows_bwd_dq_kernel<D><<<dim3((rows + BQ - 1) / BQ, b), Q_THREADS, QSmem<D>::total,
                                stream>>>(q_, k_, v_, do_, l_, d_, static_cast<bf*>(dq), rows,
                                          nk, scale);
  return cudaGetLastError();
}

}  // namespace

// q, dout (b, rows, d) and k, v (b, nk, d) bf16 contiguous; lse, delta fp32
// (b, rows); dq (b, rows, d), dk, dv (b, nk, d) bf16. d must be a multiple of
// 16, at most 128. `scale` is the softmax scale (not times log2(e)).
extern "C" int flash_rows_bwd_bf16(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dq, void* dk, void* dv, int b, int rows, int nk,
                                   int d, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_BWD_CASE(D) \
  case D: return launch<D>(q, k, v, dout, lse, delta, dq, dk, dv, b, rows, nk, scale, s)
  switch (d) {
    FLASH_BWD_CASE(16);
    FLASH_BWD_CASE(32);
    FLASH_BWD_CASE(48);
    FLASH_BWD_CASE(64);
    FLASH_BWD_CASE(80);
    FLASH_BWD_CASE(96);
    FLASH_BWD_CASE(112);
    FLASH_BWD_CASE(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_BWD_CASE
}
