// Flash multi-query attention over rows, forward, bf16, for sm_90a.
//
// Replaces the forward of `_flash_rows_forward` in
// imagen_tpu/ops/flash_attention.py (its three Pallas tiers
// `_flash_rows_kernel`, `_flash_rows_loop_kernel` and
// `_flash_rows_stream_kernel`, which were only ways of fitting K/V in VMEM).
//
// q (b, R, D) rows attend to one shared K/V head (b, nk, D). The cosine
// prologue of `_q_prologue` is fused: each q row is l2-normalised in fp32
// (rsqrt(max(sum q^2, 1e-12))), times q_scale * scale * log2(e), then rounded
// to bf16. Without q_scale the row is only multiplied by scale * log2(e).
// k arrives already normalised. The softmax is an exp2 online softmax with
// fp32 statistics and an fp32 output accumulator; P is rounded to bf16 for
// the P @ V product, as the Pallas kernel does. Given an `lse` pointer it also
// writes each row's log2-sum-exp2 m + log2(l) in that scaled base-2 domain
// (`return_stats=True` of the JAX forward), which the backward
// (flash_rows_bwd.cu) needs; serving passes null and writes nothing.
//
// What bounds it on the H100: 4 R nk D flops per batch row against 2 R D +
// 2 nk D bf16 values of I/O, so at the paths' shapes (R 8192 or 32768, nk 1063
// or 4097, D 64) the tensor cores bound it, and only wgmma reaches their rate.
// At D 64 the exponentials weigh as much: a 64 x 128 tile's 8,192 exp2 take
// the special-function units as long as its two products take the tensor
// cores, so the design overlaps the two (FlashAttention-3 style).
// - A block is 2 consumer warpgroups of 64 q rows each and a producer
//   warpgroup that gives its registers to them (setmaxnreg). One producer
//   thread keeps the K and V tiles (128 keys at D <= 64, else 64) of a
//   3-stage ring in flight by TMA, into the wgmma swizzle, with full/empty
//   mbarriers.
// - Each consumer loads its q rows once, 16 bytes a thread, normalises them in
//   fp32 and writes the swizzled bf16 tile.
// - Per key tile, S = q K^T is a wgmma with both operands in shared memory
//   (K-major) and O += P V a wgmma with P as the register A operand (rounded
//   to bf16 in place) and V read MN-major through the descriptor. Tile t's S
//   and tile t-1's P V go out together, so tile t's softmax runs while the
//   P V does; the two warpgroups take turns at issuing (named barriers), so
//   one's softmax runs while the other's products do.
// - The last key tile's products and softmax are only as wide as its keys
//   need (16, 32 or 64 where fewer than half of it are left: 39 of 128 at nk
//   1063, 1 at 4097). The ragged key tail arrives as zeros from TMA and is
//   masked to -inf before the softmax.
// - O goes out through shared memory by TMA, which writes no row past R.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_rows.cuh"
#include "hopper.cuh"

namespace {

constexpr int WGS = 2;                  // consumer warpgroups, 64 q rows each
constexpr int BQ = 64 * WGS;            // q rows per block
constexpr int THREADS = 128 * (WGS + 1);  // and one producer warpgroup
constexpr int STAGES = 3;
constexpr float NEG = -1e30f;

template <int D>
struct Fwd {
  static constexpr int BK = D <= 64 ? 128 : 64;  // keys per tile
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;    // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 1024;  // + alignment slack
};

// One tile of the online softmax on the score accumulator `sc` (64 rows x BK
// keys in the wgmma layout, keys from j0): keys past nk to -inf, the running
// row maxima m and sums l of this thread's two rows updated, the rescale
// factors of the output returned in a0, a1, and sc turned into P. A row's 4
// owners are a quad of lanes.
template <int BK>
__device__ __forceinline__ void online_softmax(float (&sc)[BK / 2], float& m0, float& m1,
                                               float& l0, float& l1, float& a0, float& a1, int j0,
                                               int nk, int lane) {
  if (j0 + BK > nk) {
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j0 + nb * 8 + (lane % 4) * 2 + (e & 1) >= nk) sc[4 * nb + e] = NEG;
  }
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int nb = 0; nb < BK / 8; ++nb) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * nb], sc[4 * nb + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * nb + 2], sc[4 * nb + 3]));
  }
#pragma unroll
  for (int o = 1; o <= 2; o *= 2) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  a0 = exp2_fast(m0 - mx0);
  a1 = exp2_fast(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int nb = 0; nb < BK / 8; ++nb) {
    sc[4 * nb] = exp2_fast(sc[4 * nb] - mx0);
    sc[4 * nb + 1] = exp2_fast(sc[4 * nb + 1] - mx0);
    sc[4 * nb + 2] = exp2_fast(sc[4 * nb + 2] - mx1);
    sc[4 * nb + 3] = exp2_fast(sc[4 * nb + 3] - mx1);
    ps0 += sc[4 * nb] + sc[4 * nb + 1];
    ps1 += sc[4 * nb + 2] + sc[4 * nb + 3];
  }
#pragma unroll
  for (int o = 1; o <= 2; o *= 2) {
    ps0 += __shfl_xor_sync(0xffffffffu, ps0, o);
    ps1 += __shfl_xor_sync(0xffffffffu, ps1, o);
  }
  l0 = l0 * a0 + ps0;
  l1 = l1 * a1 + ps1;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_rows_fwd_kernel(const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_out,
                      const __nv_bfloat16* __restrict__ q, const float* __restrict__ q_scale,
                      float* __restrict__ lse, int rows, int nk, float scale2) {
  using F = Fwd<D>;
  constexpr int BK = F::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_1024(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + F::BAR_OFF);
  uint64_t* empty = full + STAGES;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bb = blockIdx.y, row0 = blockIdx.x * BQ;
  const int num_tiles = (nk + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * WGS);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * WGS) {  // the producer warpgroup: one thread issues the K/V loads
    setmaxnreg_dec<24>();
    if (warp == 4 * WGS && lane == 0) {
      for (int t = 0; t < num_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[s], (t / STAGES - 1) & 1);
        mbar_expect_tx(&full[s], 2 * F::KV_BYTES);
        tma_load_rows<D, BK>(sbase + F::K_OFF + s * F::KV_BYTES, &tm_k, &full[s], t * BK, bb);
        tma_load_rows<D, BK>(sbase + F::V_OFF + s * F::KV_BYTES, &tm_v, &full[s], t * BK, bb);
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int wg = warp / 4, tid = threadIdx.x % 128;
  const int wrow0 = wg * 64;  // this warpgroup's rows in the block's q tile

  // --- q prologue: each row once, 16 bytes a thread, D / 8 threads a row ---
  {
    constexpr int TPR = D / 8, RPP = 128 / TPR;
    const int c = tid % TPR;
    float gain[8];
    if (q_scale) {
      load8(q_scale + c * 8, gain);
#pragma unroll
      for (int i = 0; i < 8; ++i) gain[i] *= scale2;
    }
    uint4 u[64 / RPP];  // every load in flight before the first is used
#pragma unroll
    for (int p = 0; p < 64 / RPP; ++p) {
      const int grow = row0 + wrow0 + p * RPP + tid / TPR;
      u[p] = grow < rows
                 ? *reinterpret_cast<const uint4*>(q + ((size_t)bb * rows + grow) * D + c * 8)
                 : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int p = 0; p < 64 / RPP; ++p) {
      const int r = wrow0 + p * RPP + tid / TPR;
      float x[8];
      unpack8(u[p], x);
      if (q_scale) {
        float ss = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) ss += x[i] * x[i];
        const float inv = rsqrtf(fmaxf(group_sum<TPR>(ss), 1e-12f));
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = (x[i] * inv) * gain[i];
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] *= scale2;
      }
      *reinterpret_cast<uint4*>(smem + tile_offset<D, BQ>(r, c)) = pack8(x);
    }
  }
  fence_proxy_async();
  named_sync(1 + wg, 128);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // this thread's two rows: (warp % 4) * 16 + lane / 4 and that + 8
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f, a0, a1;
  uint32_t pa[BK / 16][4];  // P of the tile before, the A operand of its P V

  // S = q K^T of tile t: 64 rows x N keys (N = 2 * sc's size), base-2 scaled
  // logits
  auto issue_s = [&](auto& sc, int t) {
    constexpr int N = 2 * sizeof(sc) / sizeof(float);
    const uint32_t k_tile = sbase + F::K_OFF + (t % STAGES) * F::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<N, 0>(sc, desc_k<D, BQ>(sbase, wrow0, kk), desc_k<D, BK>(k_tile, 0, kk), kk);
    wgmma_commit();
  };
  // O += P V of tile t over P's keys (16 a k16 step of p), V read MN-major
  auto issue_pv = [&](auto& p, int t) {
    constexpr int STEPS = sizeof(p) / sizeof(p[0]);
    const uint32_t v_tile = sbase + F::V_OFF + (t % STAGES) * F::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < STEPS; ++kk) wgmma_rs<D, 1>(o, p[kk], desc_mn<D, BK>(v_tile, kk), 1);
    wgmma_commit();
  };
  // Key tile t >= 1 with tile t-1's P V (from pa): S and the P V are issued
  // together and tile t's softmax runs while the P V does; then O is
  // rescaled and tile t's P goes to p. p is pa, or for the last tile, whose
  // keys past nk need no products, a narrower array.
  auto step = [&](auto& p, int t) {
    float sc[8 * (sizeof(p) / sizeof(p[0]))];  // 16 keys a k16 step of p
    constexpr int N = 2 * sizeof(sc) / sizeof(float);
    mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
    fence_regs(o);  // the rescale and P's packing stay before the products
    fence_regs(pa);
    named_sync(3 + wg, 256);
    wgmma_fence();
    issue_s(sc, t);
    issue_pv(pa, t - 1);
    named_arrive(4 - wg, 256);
    wgmma_wait<1>();
    fence_regs(sc);
    online_softmax<N>(sc, m0, m1, l0, l1, a0, a1, t * BK, nk, lane);
    wgmma_wait<0>();  // tile t-1's P V is done: its stage is free, O can be rescaled
    fence_regs(o);
    fence_regs(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[(t - 1) % STAGES]);
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      o[4 * nb] *= a0;
      o[4 * nb + 1] *= a0;
      o[4 * nb + 2] *= a1;
      o[4 * nb + 3] *= a1;
    }
    acc_to_a<N>(p, sc);  // P rounded to bf16 straight from the score registers
  };
  // the last P V, from p
  auto last_pv = [&](auto& p) {
    fence_regs(o);
    fence_regs(p);
    named_sync(3 + wg, 256);
    wgmma_fence();
    issue_pv(p, num_tiles - 1);
    if (wg == 0) named_arrive(4, 256);  // warpgroup 1's last turn
    wgmma_wait<0>();
    fence_regs(o);
  };

  {  // tile 0
    float sc[BK / 2];
    mbar_wait(&full[0], 0);
    if (wg == 1) named_arrive(3, 256);  // warpgroup 0 issues first
    named_sync(3 + wg, 256);
    wgmma_fence();
    issue_s(sc, 0);
    named_arrive(4 - wg, 256);
    wgmma_wait<0>();
    fence_regs(sc);
    online_softmax<BK>(sc, m0, m1, l0, l1, a0, a1, 0, nk, lane);
    acc_to_a<BK>(pa, sc);
  }
  for (int t = 1; t < num_tiles - 1; ++t) step(pa, t);
  // the last tile, as wide as its keys need: 16, 32, 64 or BK
  const int last_keys = nk - (num_tiles - 1) * BK;
  if (num_tiles == 1 || last_keys > BK / 2) {
    if (num_tiles > 1) step(pa, num_tiles - 1);
    last_pv(pa);
  } else if (BK == 128 && last_keys > 32) {
    uint32_t p[4][4];
    step(p, num_tiles - 1);
    last_pv(p);
  } else if (last_keys > 16) {
    uint32_t p[2][4];
    step(p, num_tiles - 1);
    last_pv(p);
  } else {
    uint32_t p[1][4];
    step(p, num_tiles - 1);
    last_pv(p);
  }

  // O / l in bf16 over this warpgroup's q rows in shared memory (their q is
  // read), then to global memory by TMA, which drops the rows past R
  const int lr0 = wrow0 + (warp % 4) * 16 + lane / 4;
  const float il0 = 1.f / l0, il1 = 1.f / l1;
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    const int byte = (lane % 4) * 4;
    *reinterpret_cast<__nv_bfloat162*>(smem + tile_offset<D, BQ>(lr0, nb) + byte) =
        __floats2bfloat162_rn(o[4 * nb] * il0, o[4 * nb + 1] * il0);
    *reinterpret_cast<__nv_bfloat162*>(smem + tile_offset<D, BQ>(lr0 + 8, nb) + byte) =
        __floats2bfloat162_rn(o[4 * nb + 2] * il1, o[4 * nb + 3] * il1);
  }
  fence_proxy_async();
  named_sync(1 + wg, 128);
  if (tid == 0) {
    tma_store_rows<D, BQ>(sbase, wrow0, &tm_out, row0 + wrow0, bb);
    tma_store_wait();
  }
  const int r0 = row0 + lr0, r1 = r0 + 8;
  // row log2-sum-exp2 in the scaled base-2 domain, for the backward
  if (lse && lane % 4 == 0) {
    if (r0 < rows) lse[(size_t)bb * rows + r0] = m0 + log2f(l0);
    if (r1 < rows) lse[(size_t)bb * rows + r1] = m1 + log2f(l1);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* q_scale, void* out,
                   void* lse, int b, int rows, int nk, float scale2, cudaStream_t stream) {
  CUtensorMap tm_k, tm_v, tm_out;
  if (!rows_map(&tm_k, k, b, nk, D, 64) || !rows_map(&tm_v, v, b, nk, D, 64) ||
      !rows_map(&tm_out, out, b, rows, D, 64))
    return cudaErrorInvalidValue;
  const int smem = Fwd<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_rows_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((rows + BQ - 1) / BQ, b);
  flash_rows_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      tm_k, tm_v, tm_out, static_cast<const __nv_bfloat16*>(q),
      static_cast<const float*>(q_scale), static_cast<float*>(lse), rows, nk, scale2);
  return cudaGetLastError();
}

}  // namespace

// q (b, rows, d), k/v (b, nk, d) bf16 contiguous, 16-byte aligned; q_scale
// fp32 (d,) or null; out (b, rows, d) bf16; lse fp32 (b, rows) or null. d is
// 16, 32, 64 or 128.
extern "C" int flash_rows_fwd_bf16(const void* q, const void* k, const void* v,
                                   const void* q_scale, void* out, void* lse, int b,
                                   int rows, int nk, int d, float scale2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(q, k, v, q_scale, out, lse, b, rows, nk, scale2, s);
    case 32: return launch<32>(q, k, v, q_scale, out, lse, b, rows, nk, scale2, s);
    case 64: return launch<64>(q, k, v, q_scale, out, lse, b, rows, nk, scale2, s);
    case 128: return launch<128>(q, k, v, q_scale, out, lse, b, rows, nk, scale2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
