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
// What bounds it on the H100: at the slice's shape (b 8, R 8192, nk 1063,
// D 64) it does 4*R*nk*D flops per batch row for 2*R*D bytes of q and o, so
// it is bound by the tensor cores, not by HBM. Design (FlashAttention-2
// style): one block of 8 warps per (batch, 128-row tile); each warp keeps
// its 16 q rows, its scores and its output accumulator in registers and runs
// both products as mma.sync m16n8k16 bf16 (fp32 accumulate), with operands
// read from shared memory by ldmatrix. K/V stream through shared memory in
// 64-key tiles, double-buffered with cp.async so the next tile loads while
// this one computes; rows are padded by 16 bytes so ldmatrix is free of bank
// conflicts. The ragged key tail (nk is not a multiple of 64) is zero-filled
// by cp.async and masked to -inf before the softmax. Simple first: no wgmma,
// no TMA; those are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

constexpr int BQ = 128;   // q rows per block
constexpr int BK = 64;    // keys per tile
constexpr int WARPS = 8;  // 16 rows per warp
constexpr int THREADS = WARPS * 32;
constexpr float NEG = -1e30f;

template <int D>
struct Smem {
  static constexpr int LD = D + 8;  // padded row, in elements
  static constexpr size_t q = size_t(BQ) * LD * 2;
  static constexpr size_t kv = size_t(BK) * LD * 2;  // one tile of K or V
  static constexpr size_t total = q + 4 * kv;        // K and V, two stages each
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_rows_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const float* __restrict__ q_scale,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse,
                      int rows, int nk, float scale2) {
  using S = Smem<D>;
  constexpr int LD = S::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + S::q);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + S::q + 2 * S::kv);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bb = blockIdx.y;
  const int row0 = blockIdx.x * BQ;
  const __nv_bfloat16* qb = q + (size_t)bb * rows * D;
  const __nv_bfloat16* kb = k + (size_t)bb * nk * D;
  const __nv_bfloat16* vb = v + (size_t)bb * nk * D;
  const int num_tiles = (nk + BK - 1) / BK;

  auto load_kv = [&](int t, int stage) {
    const int j0 = t * BK;
    for (int i = threadIdx.x; i < BK * (D / 8); i += THREADS) {
      const int j = i / (D / 8), c = i % (D / 8);
      const bool valid = j0 + j < nk;
      const size_t off = (size_t)(valid ? j0 + j : 0) * D + c * 8;
      cp_async16(Ks + (stage * BK + j) * LD + c * 8, kb + off, valid);
      cp_async16(Vs + (stage * BK + j) * LD + c * 8, vb + off, valid);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  load_kv(0, 0);

  // --- q prologue: l2norm * q_scale * scale * log2e (or * scale * log2e) -> Qs ---
  {
    const int r = lane / 2, half = lane % 2;  // lane pair per row, half the columns each
    const int lr = warp * 16 + r;
    const int grow = row0 + lr;
    float ss = 0.f;
    for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c) {
      const float x = grow < rows ? __bfloat162float(qb[(size_t)grow * D + c]) : 0.f;
      ss += x * x;
    }
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    const float inv = q_scale ? rsqrtf(fmaxf(ss, 1e-12f)) : 1.f;
    for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c) {
      const float x = grow < rows ? __bfloat162float(qb[(size_t)grow * D + c]) : 0.f;
      const float y = q_scale ? (x * inv) * (q_scale[c] * scale2) : x * scale2;
      Qs[lr * LD + c] = __float2bfloat16(y);
    }
  }
  __syncwarp();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk], Qs + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);

  float o[D / 8][4];
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
  // this thread's two rows: lane / 4 and lane / 4 + 8 of the warp's 16
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < num_tiles; ++t) {
    if (t + 1 < num_tiles) {
      load_kv(t + 1, (t + 1) & 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + (t & 1) * BK * LD;
    const __nv_bfloat16* Vt = Vs + (t & 1) * BK * LD;

    // S = Q K^T: 16 x BK per warp, in base-2 scaled logits
    float s[BK / 8][4];
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nb2 = 0; nb2 < BK / 16; ++nb2) {
        uint32_t b[4];
        ldmatrix_x4(b, Kt + (nb2 * 16 + lane % 8 + (lane / 16) * 8) * LD + kk * 16 +
                           ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * nb2], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * nb2 + 1], qf[kk], b[2], b[3]);
      }
    }
    const int j0 = t * BK;
    if (j0 + BK > nk) {
#pragma unroll
      for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j0 + nb * 8 + (lane % 4) * 2 + (e & 1) >= nk) s[nb][e] = NEG;
    }

    // online softmax over the tile; a row's 4 owners are a quad of lanes
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb) {
      mx0 = fmaxf(mx0, fmaxf(s[nb][0], s[nb][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nb][2], s[nb][3]));
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ *= 2) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb) {
      s[nb][0] = exp2f(s[nb][0] - mx0);
      s[nb][1] = exp2f(s[nb][1] - mx0);
      s[nb][2] = exp2f(s[nb][2] - mx1);
      s[nb][3] = exp2f(s[nb][3] - mx1);
      ps0 += s[nb][0] + s[nb][1];
      ps1 += s[nb][2] + s[nb][3];
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ *= 2) {
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, o_);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, o_);
    }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      o[nb][0] *= a0;
      o[nb][1] *= a0;
      o[nb][2] *= a1;
      o[nb][3] *= a1;
    }

    // O += P V, P rounded to bf16 straight from the score registers
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nb2 = 0; nb2 < D / 16; ++nb2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Vt + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD +
                                 nb2 * 16 + (lane / 16) * 8);
        mma_bf16(o[2 * nb2], pa, b[0], b[1]);
        mma_bf16(o[2 * nb2 + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is free for the load two tiles ahead
  }

  const int r0 = row0 + warp * 16 + lane / 4, r1 = r0 + 8;
  const float il0 = 1.f / l0, il1 = 1.f / l1;
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    const int c = nb * 8 + (lane % 4) * 2;
    if (r0 < rows)
      *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)bb * rows + r0) * D + c) =
          __floats2bfloat162_rn(o[nb][0] * il0, o[nb][1] * il0);
    if (r1 < rows)
      *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)bb * rows + r1) * D + c) =
          __floats2bfloat162_rn(o[nb][2] * il1, o[nb][3] * il1);
  }
  // row log2-sum-exp2 in the scaled base-2 domain, for the backward
  if (lse && lane % 4 == 0) {
    if (r0 < rows) lse[(size_t)bb * rows + r0] = m0 + log2f(l0);
    if (r1 < rows) lse[(size_t)bb * rows + r1] = m1 + log2f(l1);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* q_scale,
                   void* out, void* lse, int b, int rows, int nk, float scale2,
                   cudaStream_t stream) {
  const size_t smem = Smem<D>::total;
  cudaError_t err = cudaFuncSetAttribute(flash_rows_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((rows + BQ - 1) / BQ, b);
  flash_rows_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(q_scale),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), rows, nk, scale2);
  return cudaGetLastError();
}

}  // namespace

// q (b, rows, d), k/v (b, nk, d) bf16 contiguous; q_scale fp32 (d,) or null;
// out (b, rows, d) bf16; lse fp32 (b, rows) or null. d must be a multiple of
// 16, at most 128.
extern "C" int flash_rows_fwd_bf16(const void* q, const void* k, const void* v,
                                   const void* q_scale, void* out, void* lse, int b,
                                   int rows, int nk, int d, float scale2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(q, k, v, q_scale, out, lse, b, rows, nk, scale2, s);
    case 32: return launch<32>(q, k, v, q_scale, out, lse, b, rows, nk, scale2, s);
    case 48: return launch<48>(q, k, v, q_scale, out, lse, b, rows, nk, scale2, s);
    case 64: return launch<64>(q, k, v, q_scale, out, lse, b, rows, nk, scale2, s);
    case 80: return launch<80>(q, k, v, q_scale, out, lse, b, rows, nk, scale2, s);
    case 96: return launch<96>(q, k, v, q_scale, out, lse, b, rows, nk, scale2, s);
    case 112: return launch<112>(q, k, v, q_scale, out, lse, b, rows, nk, scale2, s);
    case 128: return launch<128>(q, k, v, q_scale, out, lse, b, rows, nk, scale2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
