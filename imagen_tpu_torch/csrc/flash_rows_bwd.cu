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
// What bounds it on the H100: 5 products of 2 R nk D flops per batch row
// against 4 R D + 4 nk D bf16 values of I/O, so the tensor cores bound it,
// and only wgmma reaches their rate. The dK/dV work is a loop over all R q
// rows per key tile (the multi-query head reduction), so a grid of one block
// per (batch, key tile) is b * ceil(nk / 128) blocks: 72 at the image
// training shape, 132 at the video `mid_attn`, on 132 SMs. Design, three
// kernels on the stream, deterministic, no atomics. In the two big ones a
// block is 2 consumer warpgroups and a producer warpgroup that gives its
// registers to them (setmaxnreg); one producer thread streams tiles by TMA
// through a 3-stage ring with full/empty mbarriers, in the wgmma swizzle.
// The consumers take turns at issuing each tile's first products (named
// barriers), so one's exponentials run while the other's products do.
// - dK/dV: grid (key tiles, b, S). Each consumer owns 64 keys; K and V stay
//   in shared memory; the ring streams the q, dO, lse and delta tiles (64
//   rows) of the block's slice of R. S^T = K q^T and dP^T = V dO^T are wgmmas
//   from shared memory, key-major, so P^T and dS^T come out of the
//   accumulators as the register A operands of dV += P^T dO and dK += dS^T q,
//   whose B (the same dO and q tiles) is read MN-major. Tile t's S^T and dP^T
//   go out with tile t-1's dK; P^T's exponentials overlap dP^T, dS^T's
//   arithmetic tile t's dV. The split S is picked on the host (`bwd_splits`
//   in ops/flash_attention.py) so that the grid fills the SMs twice; each
//   block writes its slice's fp32 dK and dV to a scratch (2, S, b, nk, D).
// - reduce: sums the S partials in slice order in fp32, rounds once to bf16.
// - dQ: grid (row tiles of 128, b); each consumer holds 64 rows of q and dO
//   in shared memory, the ring streams 64-key K and V tiles. S = q K^T and
//   dP = dO V^T from shared memory, dQ += dS K with dS from registers and K
//   read MN-major; tile t's S and dP go out with tile t-1's dQ. It
//   recomputes S and dP: dQ fused into the dK/dV pass needs fp32 atomics.
// The ragged key tail and rows past R arrive as zeros from TMA; P is zeroed
// there, and keys past nk and rows past R are never written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_rows.cuh"
#include "hopper.cuh"

namespace {

constexpr int WGS = 2;                  // consumer warpgroups a block
constexpr int THREADS = 128 * (WGS + 1);  // and one producer warpgroup
constexpr int STAGES = 3;
constexpr int BKV = 64 * WGS;           // keys per dK/dV block
constexpr int BR = 64;                  // q rows per streamed dK/dV tile
constexpr int BQ = 64 * WGS;            // q rows per dQ block
constexpr int BK = 64;                  // keys per streamed dQ tile
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Dkdv {
  static constexpr int KV_BYTES = BKV * D * 2;  // the K or the V tile
  static constexpr int ROW_BYTES = BR * D * 2;  // one q or dO tile
  static constexpr int K_OFF = 0, V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;
  static constexpr int DO_OFF = Q_OFF + STAGES * ROW_BYTES;
  static constexpr int L_OFF = DO_OFF + STAGES * ROW_BYTES;  // BR lse values a stage
  static constexpr int DL_OFF = L_OFF + STAGES * BR * 4;     // BR delta values a stage
  static constexpr int BAR_OFF = DL_OFF + STAGES * BR * 4;
  static constexpr int SMEM = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;
  static constexpr int STAGE_TX = 2 * ROW_BYTES + 2 * BR * 4;
};

template <int D>
struct Dq {
  static constexpr int Q_BYTES = BQ * D * 2;    // the q or the dO tile
  static constexpr int KV_BYTES = BK * D * 2;   // one K or V tile
  static constexpr int Q_OFF = 0, DO_OFF = Q_BYTES;
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;
};

// This thread's rows r0 and r0 + 8 of a 64 x D accumulator, those below
// n_rows, as fp32 or bf16 pairs.
template <int D>
__device__ __forceinline__ void store_acc(float* out, const float (&acc)[D / 2], int r0,
                                          int n_rows, int lane) {
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    const int c = nb * 8 + (lane % 4) * 2;
    if (r0 < n_rows)
      *reinterpret_cast<float2*>(out + (size_t)r0 * D + c) =
          make_float2(acc[4 * nb], acc[4 * nb + 1]);
    if (r0 + 8 < n_rows)
      *reinterpret_cast<float2*>(out + (size_t)(r0 + 8) * D + c) =
          make_float2(acc[4 * nb + 2], acc[4 * nb + 3]);
  }
}

template <int D>
__device__ __forceinline__ void store_acc(__nv_bfloat16* out, const float (&acc)[D / 2], int r0,
                                          int n_rows, int lane) {
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    const int c = nb * 8 + (lane % 4) * 2;
    if (r0 < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r0 * D + c) =
          __floats2bfloat162_rn(acc[4 * nb], acc[4 * nb + 1]);
    if (r0 + 8 < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(r0 + 8) * D + c) =
          __floats2bfloat162_rn(acc[4 * nb + 2], acc[4 * nb + 3]);
  }
}

// --- dK/dV over one slice of R --------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_rows_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_do,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_lse,
                           const __grid_constant__ CUtensorMap tm_delta, float* __restrict__ part,
                           int rows, int nk, int splits, float scale) {
  using K_ = Dkdv<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_1024(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + K_::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* kv_full = empty + STAGES;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int key0 = blockIdx.x * BKV, bb = blockIdx.y, split = blockIdx.z;
  const int b = gridDim.y;
  // this block's row tiles: the slice `split` of a balanced split of all of them
  const int tiles = (rows + BR - 1) / BR;
  const int t_begin = (int)((long long)tiles * split / splits);
  const int t_end = (int)((long long)tiles * (split + 1) / splits);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * WGS);
    }
    mbar_init(kv_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * WGS) {  // the producer warpgroup: one thread issues the loads
    setmaxnreg_dec<24>();
    if (warp == 4 * WGS && lane == 0) {
      mbar_expect_tx(kv_full, 2 * K_::KV_BYTES);
      tma_load_rows<D, BKV>(sbase + K_::K_OFF, &tm_k, kv_full, key0, bb);
      tma_load_rows<D, BKV>(sbase + K_::V_OFF, &tm_v, kv_full, key0, bb);
      for (int t = t_begin; t < t_end; ++t) {
        const int i = t - t_begin, s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], (i / STAGES - 1) & 1);
        mbar_expect_tx(&full[s], K_::STAGE_TX);
        tma_load_rows<D, BR>(sbase + K_::Q_OFF + s * K_::ROW_BYTES, &tm_q, &full[s], t * BR, bb);
        tma_load_rows<D, BR>(sbase + K_::DO_OFF + s * K_::ROW_BYTES, &tm_do, &full[s], t * BR, bb);
        // lse and delta are read flat over (b, R): rows past R are masked below
        tma_load_1d(sbase + K_::L_OFF + s * BR * 4, &tm_lse, &full[s], bb * rows + t * BR);
        tma_load_1d(sbase + K_::DL_OFF + s * BR * 4, &tm_delta, &full[s], bb * rows + t * BR);
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int wg = warp / 4;
  const float scale2 = scale * LOG2E;
  // this thread's two keys: accumulator rows (warp % 4) * 16 + lane / 4 and
  // that + 8 of the warpgroup's 64
  const int kr0 = key0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const bool key_ok0 = kr0 < nk, key_ok1 = kr0 + 8 < nk;

  mbar_wait(kv_full, 0);

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  uint32_t pa[BR / 16][4], dsa[BR / 16][4];  // P^T and dS^T, the A operands of dV, dK

  // tile i of the slice: S^T = K q^T and dP^T = V dO^T, 64 keys x BR rows,
  // from shared memory
  auto issue_sdp = [&](float (&st)[BR / 2], float (&dpt)[BR / 2], int i) {
    const int s = i % STAGES;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BR, 0>(st, desc_k<D, BKV>(sbase + K_::K_OFF, wg * 64, kk),
                      desc_k<D, BR>(sbase + K_::Q_OFF + s * K_::ROW_BYTES, 0, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BR, 0>(dpt, desc_k<D, BKV>(sbase + K_::V_OFF, wg * 64, kk),
                      desc_k<D, BR>(sbase + K_::DO_OFF + s * K_::ROW_BYTES, 0, kk), kk);
    wgmma_commit();
  };
  // P^T into st: columns are the tile's q rows, 0 past R and at keys past nk
  auto p_of = [&](float (&st)[BR / 2], int i) {
    const float* Lt = reinterpret_cast<const float*>(smem + K_::L_OFF + (i % STAGES) * BR * 4);
    const int rows_left = rows - (t_begin + i) * BR;
#pragma unroll
    for (int nb = 0; nb < BR / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nb * 8 + (lane % 4) * 2 + (e & 1);
        const bool ok = (e < 2 ? key_ok0 : key_ok1) && col < rows_left;
        st[4 * nb + e] = ok ? exp2_fast(st[4 * nb + e] * scale2 - Lt[col]) : 0.f;
      }
    }
  };
  // dS^T into dpt
  auto ds_of = [&](const float (&st)[BR / 2], float (&dpt)[BR / 2], int i) {
    const float* Dt = reinterpret_cast<const float*>(smem + K_::DL_OFF + (i % STAGES) * BR * 4);
#pragma unroll
    for (int nb = 0; nb < BR / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nb * 8 + (lane % 4) * 2 + (e & 1);
        dpt[4 * nb + e] = st[4 * nb + e] * (dpt[4 * nb + e] - Dt[col]) * scale;
      }
    }
  };
  // dV += P^T dO and dK += dS^T q over tile i's rows, dO and q read MN-major
  auto issue_dv = [&](int i) {
    const uint32_t do_tile = sbase + K_::DO_OFF + (i % STAGES) * K_::ROW_BYTES;
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk) wgmma_rs<D, 1>(dv, pa[kk], desc_mn<D, BR>(do_tile, kk), 1);
    wgmma_commit();
  };
  auto issue_dk = [&](int i) {
    const uint32_t q_tile = sbase + K_::Q_OFF + (i % STAGES) * K_::ROW_BYTES;
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk) wgmma_rs<D, 1>(dk, dsa[kk], desc_mn<D, BR>(q_tile, kk), 1);
    wgmma_commit();
  };

  const int n_tiles = t_end - t_begin;
  if (n_tiles > 0) {
    {  // tile 0
      float st[BR / 2], dpt[BR / 2];
      mbar_wait(&full[0], 0);
      if (wg == 1) named_arrive(3, 256);  // warpgroup 0 issues first
      named_sync(3 + wg, 256);
      wgmma_fence();
      issue_sdp(st, dpt, 0);
      named_arrive(4 - wg, 256);
      wgmma_wait<1>();
      fence_regs(st);
      p_of(st, 0);
      acc_to_a<BR>(pa, st);
      fence_regs(pa);
      fence_regs(dv);
      wgmma_fence();
      issue_dv(0);
      wgmma_wait<1>();
      fence_regs(dpt);
      ds_of(st, dpt, 0);
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(pa);
      acc_to_a<BR>(dsa, dpt);
    }
    // Software pipeline: tile i's S^T and dP^T go out with tile i-1's dK;
    // P^T's exponentials overlap dP^T, dS^T's arithmetic tile i's dV.
    for (int i = 1; i < n_tiles; ++i) {
      float st[BR / 2], dpt[BR / 2];
      mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
      fence_regs(dk);
      fence_regs(dsa);
      named_sync(3 + wg, 256);
      wgmma_fence();
      issue_sdp(st, dpt, i);
      issue_dk(i - 1);
      named_arrive(4 - wg, 256);
      wgmma_wait<2>();
      fence_regs(st);
      p_of(st, i);
      acc_to_a<BR>(pa, st);
      fence_regs(pa);
      fence_regs(dv);
      wgmma_fence();
      issue_dv(i);
      wgmma_wait<2>();
      fence_regs(dpt);
      ds_of(st, dpt, i);
      wgmma_wait<0>();  // tile i-1's dK is done: its stage is free
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(pa);
      fence_regs(dsa);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(i - 1) % STAGES]);
      acc_to_a<BR>(dsa, dpt);
    }
    fence_regs(dk);
    fence_regs(dsa);
    named_sync(3 + wg, 256);
    wgmma_fence();
    issue_dk(n_tiles - 1);
    if (wg == 0) named_arrive(4, 256);  // warpgroup 1's last turn
    wgmma_wait<0>();
    fence_regs(dk);
  }

  // this slice's fp32 partials, part[0][split] for dK and part[1][split] for dV
  const size_t slab = (size_t)b * nk * D;
  float* pk = part + (size_t)split * slab + (size_t)bb * nk * D;
  float* pv = part + (size_t)(splits + split) * slab + (size_t)bb * nk * D;
  store_acc<D>(pk, dk, kr0, nk, lane);
  store_acc<D>(pv, dv, kr0, nk, lane);
}

// dk, dv (n values each) = the sum over the S slices of the partials, in
// slice order, rounded to bf16 once.
__global__ void __launch_bounds__(256)
flash_rows_bwd_reduce_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, long long n, int splits) {
  const long long stride = (long long)gridDim.x * blockDim.x * 8;
  for (long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 8; i < 2 * n;
       i += stride) {
    const int which = i >= n;
    const long long j = i - which * n;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < splits; ++s) {
      float f[8];
      load8(part + ((size_t)which * splits + s) * n + j, f);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += f[e];
    }
    *reinterpret_cast<uint4*>((which ? dv : dk) + j) = pack8(acc);
  }
}

// --- dQ -------------------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_rows_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ lse,
                    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int rows,
                    int nk, float scale) {
  using Q_ = Dq<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_1024(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Q_::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* qd_full = empty + STAGES;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * BQ, bb = blockIdx.y;
  const int num_tiles = (nk + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * WGS);
    }
    mbar_init(qd_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * WGS) {  // the producer warpgroup: one thread issues the loads
    setmaxnreg_dec<24>();
    if (warp == 4 * WGS && lane == 0) {
      mbar_expect_tx(qd_full, 2 * Q_::Q_BYTES);
      tma_load_rows<D, BQ>(sbase + Q_::Q_OFF, &tm_q, qd_full, row0, bb);
      tma_load_rows<D, BQ>(sbase + Q_::DO_OFF, &tm_do, qd_full, row0, bb);
      for (int t = 0; t < num_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[s], (t / STAGES - 1) & 1);
        mbar_expect_tx(&full[s], 2 * Q_::KV_BYTES);
        tma_load_rows<D, BK>(sbase + Q_::K_OFF + s * Q_::KV_BYTES, &tm_k, &full[s], t * BK, bb);
        tma_load_rows<D, BK>(sbase + Q_::V_OFF + s * Q_::KV_BYTES, &tm_v, &full[s], t * BK, bb);
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int wg = warp / 4;
  const float scale2 = scale * LOG2E;
  // this thread's two rows: accumulator rows (warp % 4) * 16 + lane / 4 and
  // that + 8 of the warpgroup's 64
  const int r0 = row0 + wg * 64 + (warp % 4) * 16 + lane / 4, r1 = r0 + 8;
  const size_t sb = (size_t)bb * rows;
  const float L0 = r0 < rows ? lse[sb + r0] : 0.f, L1 = r1 < rows ? lse[sb + r1] : 0.f;
  const float D0 = r0 < rows ? delta[sb + r0] : 0.f, D1 = r1 < rows ? delta[sb + r1] : 0.f;

  mbar_wait(qd_full, 0);

  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
  uint32_t dsa[BK / 16][4];  // dS, the A operand of dQ += dS K

  // key tile t: S = q K^T and dP = dO V^T, 64 rows x BK keys, from shared memory
  auto issue_sdp = [&](float (&sc)[BK / 2], float (&dp)[BK / 2], int t) {
    const int s = t % STAGES;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BK, 0>(sc, desc_k<D, BQ>(sbase + Q_::Q_OFF, wg * 64, kk),
                      desc_k<D, BK>(sbase + Q_::K_OFF + s * Q_::KV_BYTES, 0, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BK, 0>(dp, desc_k<D, BQ>(sbase + Q_::DO_OFF, wg * 64, kk),
                      desc_k<D, BK>(sbase + Q_::V_OFF + s * Q_::KV_BYTES, 0, kk), kk);
    wgmma_commit();
  };
  // P into sc, 0 at keys past nk
  auto p_of = [&](float (&sc)[BK / 2], int t) {
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = t * BK + nb * 8 + (lane % 4) * 2 + (e & 1) < nk;
        sc[4 * nb + e] = ok ? exp2_fast(sc[4 * nb + e] * scale2 - (e < 2 ? L0 : L1)) : 0.f;
      }
    }
  };
  // dS into dp
  auto ds_of = [&](const float (&sc)[BK / 2], float (&dp)[BK / 2]) {
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * nb + e] = sc[4 * nb + e] * (dp[4 * nb + e] - (e < 2 ? D0 : D1)) * scale;
    }
  };
  // dQ += dS K of key tile t, K read MN-major
  auto issue_dq = [&](int t) {
    const uint32_t k_tile = sbase + Q_::K_OFF + (t % STAGES) * Q_::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<D, 1>(dqa, dsa[kk], desc_mn<D, BK>(k_tile, kk), 1);
    wgmma_commit();
  };

  {  // tile 0
    float sc[BK / 2], dp[BK / 2];
    mbar_wait(&full[0], 0);
    if (wg == 1) named_arrive(3, 256);  // warpgroup 0 issues first
    named_sync(3 + wg, 256);
    wgmma_fence();
    issue_sdp(sc, dp, 0);
    named_arrive(4 - wg, 256);
    wgmma_wait<1>();
    fence_regs(sc);
    p_of(sc, 0);
    wgmma_wait<0>();
    fence_regs(dp);
    ds_of(sc, dp);
    acc_to_a<BK>(dsa, dp);
  }
  // Software pipeline: tile t's S and dP go out with tile t-1's dQ; P's
  // exponentials overlap dP, dS's arithmetic the dQ.
  for (int t = 1; t < num_tiles; ++t) {
    float sc[BK / 2], dp[BK / 2];
    mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
    fence_regs(dqa);
    fence_regs(dsa);
    named_sync(3 + wg, 256);
    wgmma_fence();
    issue_sdp(sc, dp, t);
    issue_dq(t - 1);
    named_arrive(4 - wg, 256);
    wgmma_wait<2>();
    fence_regs(sc);
    p_of(sc, t);
    wgmma_wait<1>();
    fence_regs(dp);
    ds_of(sc, dp);
    wgmma_wait<0>();  // tile t-1's dQ is done: its stage is free
    fence_regs(dqa);
    fence_regs(dsa);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[(t - 1) % STAGES]);
    acc_to_a<BK>(dsa, dp);
  }
  fence_regs(dqa);
  fence_regs(dsa);
  named_sync(3 + wg, 256);
  wgmma_fence();
  issue_dq(num_tiles - 1);
  if (wg == 0) named_arrive(4, 256);  // warpgroup 1's last turn
  wgmma_wait<0>();
  fence_regs(dqa);

  store_acc<D>(dq + sb * D, dqa, r0, rows, lane);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                   const void* delta, void* dq, void* dk, void* dv, void* part, int b, int rows,
                   int nk, int splits, float scale, cudaStream_t stream) {
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_lse, tm_delta;
  const long long flat = (long long)b * rows;
  if (!rows_map(&tm_q, q, b, rows, D, 64) || !rows_map(&tm_do, dout, b, rows, D, 64) ||
      !rows_map(&tm_k, k, b, nk, D, 64) || !rows_map(&tm_v, v, b, nk, D, 64) ||
      !flat_map(&tm_lse, lse, flat, BR) || !flat_map(&tm_delta, delta, flat, BR))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_rows_bwd_dkdv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Dkdv<D>::SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_rows_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Dq<D>::SMEM);
  if (err != cudaSuccess) return err;

  float* part_ = static_cast<float*>(part);
  flash_rows_bwd_dkdv_kernel<D><<<dim3((nk + BKV - 1) / BKV, b, splits), THREADS, Dkdv<D>::SMEM,
                             stream>>>(tm_q, tm_do, tm_k, tm_v, tm_lse, tm_delta, part_, rows, nk,
                                       splits, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = (long long)b * nk * D;
  const long long groups = (2 * n / 8 + 255) / 256;
  flash_rows_bwd_reduce_kernel<<<(int)(groups < 2048 ? groups : 2048), 256, 0, stream>>>(
      part_, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), n, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_rows_bwd_dq_kernel<D><<<dim3((rows + BQ - 1) / BQ, b), THREADS, Dq<D>::SMEM, stream>>>(
      tm_q, tm_do, tm_k, tm_v, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), rows, nk, scale);
  return cudaGetLastError();
}

}  // namespace

// q, dout (b, rows, d) and k, v (b, nk, d) bf16 contiguous, 16-byte aligned;
// lse, delta fp32 (b, rows); dq (b, rows, d), dk, dv (b, nk, d) bf16; part
// fp32 scratch (2, splits, b, nk, d), 1 <= splits <= ceil(rows / 64). d is
// 16, 32, 64 or 128. `scale` is the softmax scale (not times log2(e)).
extern "C" int flash_rows_bwd_bf16(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dq, void* dk, void* dv, void* part, int b, int rows,
                                   int nk, int d, int splits, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits < 1 || splits > (rows + BR - 1) / BR) return (int)cudaErrorInvalidValue;
#define FLASH_BWD_CASE(D)                                                                    \
  case D:                                                                                    \
    return launch<D>(q, k, v, dout, lse, delta, dq, dk, dv, part, b, rows, nk, splits, scale, \
                     s)
  switch (d) {
    FLASH_BWD_CASE(16);
    FLASH_BWD_CASE(32);
    FLASH_BWD_CASE(64);
    FLASH_BWD_CASE(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_BWD_CASE
}
