// LayerNorm fused into the matrix product after it, and the product fused
// into the LayerNorm after it, bf16, for sm_90a: kernel 11 of the port.
//
//   fused_ln_matmul_bf16:  y = bf16(LN_k(x) * g) @ W^T        x (rows, k) -> y (rows, n)
//   fused_matmul_ln_bf16:  y = LN_n(bf16(x @ W^T)) * g        x (rows, k) -> y (rows, n)
//
// (bias-free LayerNorms, W the torch Linear weight (n, k)). Replaces
// `fused_ln_matmul` / `fused_matmul_ln` -> `_lnmm_forward` / `_mmln_forward`
// of imagen_tpu/ops/fused_norm.py, whose pallas_call is
// `_pallas_rowblock_call` (:384) over `_lnmm_kernel` / `_mmln_kernel`.
// Arithmetic as those kernels: LayerNorm statistics in fp32 (mean, then the
// variance of the centred row), the normalised row rounded to bf16 before
// the product; products of bf16 with fp32 accumulation; in the second, the
// product rounded to bf16 before its LayerNorm, as the module chain rounds
// it. The JAX package wires neither into `Attention`/`CrossAttention`, and
// neither does the port.
//
// What bounds it on the H100: at the sites they would take in the EDM path
// (the attention pre-norm into to_q and to_kv, k 512-2048, n 512-640; the
// out-projection into the out-norm, k 512, n 512-2048) 2 * k * n flops per row
// against 2 * (k + n) bytes, 300-800 flops a byte: the tensor cores, at
// 989 TFLOP/s, bound every site, e.g. 10.7 GFLOP and 0.011 ms for the
// 32^2 pre-norm at batch 8 (8192 x 1024 x 640).
//
// Design. A block owns a row block of x: BM rows (64, 32 or 16, the most
// that fits in shared memory beside the rest) of k values, normalised into
// shared memory once (LN -> matmul) or copied there by cp.async (matmul ->
// LN). The weight is streamed through shared memory in 128 x 32 tiles,
// double-buffered by cp.async, so the B fragments come from shared memory
// by ldmatrix rather than from global memory as in kernel 10 (the reason it
// loses to cuBLAS). 8 warps split each 16 x 128 output tile pair of rows
// and columns; each warp runs mma.sync m16n8k16 over its share. LN -> matmul
// gives each block one 128-column tile of the output (grid rows/BM x n/128);
// matmul -> LN needs the whole output row before its norm, so one block
// walks every column tile, keeps the bf16-rounded product rows (BM x n) in
// shared memory, and normalises them at the end. Simple first: no wgmma, no
// TMA; those are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_rows.cuh"
#include "warp_mma.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BN = 128;                      // output columns per tile
constexpr int BK = 32;                       // depth of a staged weight tile
constexpr int BKP = BK + 8;                  // padded weight tile row (80 B)
constexpr int W_STAGE = BN * BKP;            // elements per weight stage
constexpr size_t W_BYTES = 2 * W_STAGE * 2;  // two stages
constexpr size_t SMEM_LIMIT = 227 * 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LayerNorm of one row of n bf16 values (16-byte aligned) by one warp:
// fp32 mean, then the centred variance, times the fp32 gain, rounded to
// bf16 into dst (16-byte aligned).
__device__ __forceinline__ void layernorm_row(const __nv_bfloat16* src, const float* __restrict__ g,
                                              int n, float eps, __nv_bfloat16* dst, int lane) {
  float s = 0.f;
  for (int c = lane * 8; c < n; c += 256) {
    float f[8];
    unpack8(*reinterpret_cast<const uint4*>(src + c), f);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += f[i];
  }
  const float mean = warp_sum(s) / n;
  float v = 0.f;
  for (int c = lane * 8; c < n; c += 256) {
    float f[8];
    unpack8(*reinterpret_cast<const uint4*>(src + c), f);
#pragma unroll
    for (int i = 0; i < 8; ++i) v += (f[i] - mean) * (f[i] - mean);
  }
  const float rstd = rsqrtf(warp_sum(v) / n + eps);
  for (int c = lane * 8; c < n; c += 256) {
    float f[8], gv[8];
    unpack8(*reinterpret_cast<const uint4*>(src + c), f);
    load8(g + c, gv);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = (f[i] - mean) * rstd * gv[i];
    *reinterpret_cast<uint4*>(dst + c) = pack8(f);
  }
}

template <int BM>
struct Tile {
  static constexpr int WARPS_M = BM / 16;           // warps along the rows
  static constexpr int WARPS_N = WARPS / WARPS_M;   // warps along the columns
  static constexpr int WN = BN / WARPS_N;           // columns per warp
  static constexpr int NB = WN / 8;                 // n8 blocks per warp
};

// acc = As[BM, k] @ W[n0 : n0 + BN, :]^T for this warp's share of the tile:
// rows (warp / WARPS_N) * 16 .. +16, columns (warp % WARPS_N) * WN .. +WN.
// As is bf16 in shared memory with row stride lda; the weight tiles stream
// through Ws (two stages). Ends with every thread past its last read of Ws.
template <int BM>
__device__ __forceinline__ void tile_product(const __nv_bfloat16* As, int lda,
                                             const __nv_bfloat16* __restrict__ w, int k, int n0,
                                             __nv_bfloat16* Ws, float (&acc)[Tile<BM>::NB][4]) {
  using T = Tile<BM>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
#pragma unroll
  for (int nb = 0; nb < T::NB; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nb][i] = 0.f;

  auto load = [&](int kc, int s) {
    __nv_bfloat16* dst = Ws + s * W_STAGE;
    for (int i = threadIdx.x; i < BN * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8), v = i % (BK / 8);
      cp_async16(dst + r * BKP + v * 8, w + (size_t)(n0 + r) * k + kc * BK + v * 8, true);
    }
    cp_async_commit();
  };

  const int nk = k / BK;
  load(0, 0);
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) {
      load(kc + 1, (kc + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Wt = Ws + (kc & 1) * W_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, As + (wm * 16 + lane % 16) * lda + kc * BK + kk + (lane / 16) * 8);
#pragma unroll
      for (int nb2 = 0; nb2 < T::NB / 2; ++nb2) {
        uint32_t b[4];  // W rows are output columns: the col-major B of m16n8k16
        ldmatrix_x4(b, Wt + (wn * T::WN + nb2 * 16 + (lane / 16) * 8 + lane % 8) * BKP + kk +
                           ((lane / 8) % 2) * 8);
        mma_bf16(acc[2 * nb2], a, b[0], b[1]);
        mma_bf16(acc[2 * nb2 + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is free for the load two tiles ahead
  }
}

// Writes this warp's accumulators, rounded to bf16, into the row-major
// (ld columns) tile at out, rows from row0 below `rows` only.
template <int BM>
__device__ __forceinline__ void store_tile(const float (&acc)[Tile<BM>::NB][4],
                                           __nv_bfloat16* out, int ld, int col0, int row0,
                                           int rows) {
  using T = Tile<BM>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wm * 16 + lane / 4 + h * 8;
    if (row0 + r >= rows) continue;
#pragma unroll
    for (int nb = 0; nb < T::NB; ++nb) {
      const int col = col0 + wn * T::WN + nb * 8 + (lane % 4) * 2;
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * ld + col) =
          __floats2bfloat162_rn(acc[nb][2 * h], acc[nb][2 * h + 1]);
    }
  }
}

template <int BM>
__global__ void __launch_bounds__(THREADS)
    ln_matmul_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ g,
                     const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ y, int rows,
                     int k, int n, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = k + 8;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ws = As + BM * lda;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  for (int r = warp; r < BM; r += WARPS) {
    __nv_bfloat16* dst = As + r * lda;
    if (row0 + r < rows) {
      layernorm_row(x + (size_t)(row0 + r) * k, g, k, eps, dst, lane);
    } else {
      for (int c = lane * 8; c < k; c += 256) *reinterpret_cast<uint4*>(dst + c) = uint4{};
    }
  }
  __syncthreads();

  float acc[Tile<BM>::NB][4];
  tile_product<BM>(As, lda, w, k, n0, Ws, acc);
  store_tile<BM>(acc, y + (size_t)row0 * n, n, n0, row0, rows);
}

template <int BM>
__global__ void __launch_bounds__(THREADS)
    matmul_ln_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ g, __nv_bfloat16* __restrict__ y, int rows, int k,
                     int n, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = k + 8, ldh = n + 8;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ws = As + BM * lda;
  __nv_bfloat16* Hs = Ws + 2 * W_STAGE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * BM;

  for (int i = threadIdx.x; i < BM * (k / 8); i += THREADS) {
    const int r = i / (k / 8), v = i % (k / 8);
    const bool valid = row0 + r < rows;  // zero-filled past the last row
    cp_async16(As + r * lda + v * 8, x + (valid ? (size_t)(row0 + r) * k + v * 8 : 0), valid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  for (int n0 = 0; n0 < n; n0 += BN) {
    float acc[Tile<BM>::NB][4];
    tile_product<BM>(As, lda, w, k, n0, Ws, acc);
    store_tile<BM>(acc, Hs, ldh, n0, 0, BM);
  }
  __syncthreads();

  for (int r = warp; r < BM; r += WARPS)
    if (row0 + r < rows) layernorm_row(Hs + r * ldh, g, n, eps, y + (size_t)(row0 + r) * n, lane);
}

template <int BM>
size_t smem_bytes(int k, int n, bool keeps_output) {
  return size_t(BM) * (k + 8) * 2 + W_BYTES + (keeps_output ? size_t(BM) * (n + 8) * 2 : 0);
}

template <int BM>
cudaError_t run(bool ln_first, const void* x, const void* g, const void* w, void* y, int rows,
                int k, int n, float eps, cudaStream_t s) {
  const size_t smem = smem_bytes<BM>(k, n, !ln_first);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  const auto* gf = static_cast<const float*>(g);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  const unsigned row_blocks = (rows + BM - 1) / BM;
  cudaError_t err;
  if (ln_first) {
    err = cudaFuncSetAttribute(ln_matmul_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    ln_matmul_kernel<BM><<<dim3(row_blocks, n / BN), THREADS, smem, s>>>(xb, gf, wb, yb, rows,
                                                                          k, n, eps);
  } else {
    err = cudaFuncSetAttribute(matmul_ln_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    matmul_ln_kernel<BM><<<row_blocks, THREADS, smem, s>>>(xb, wb, gf, yb, rows, k, n, eps);
  }
  return cudaGetLastError();
}

int launch(bool ln_first, const void* x, const void* g, const void* w, void* y, int rows, int k,
           int n, float eps, void* stream) {
  if (rows < 1 || k < BK || k % BK || n < BN || n % BN) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool keeps = !ln_first;
  if (smem_bytes<64>(k, n, keeps) <= SMEM_LIMIT)
    return run<64>(ln_first, x, g, w, y, rows, k, n, eps, s);
  if (smem_bytes<32>(k, n, keeps) <= SMEM_LIMIT)
    return run<32>(ln_first, x, g, w, y, rows, k, n, eps, s);
  if (smem_bytes<16>(k, n, keeps) <= SMEM_LIMIT)
    return run<16>(ln_first, x, g, w, y, rows, k, n, eps, s);
  return (int)cudaErrorInvalidValue;  // the row block does not fit in shared memory
}

}  // namespace

// x (rows, k) bf16, g (k,) fp32, w (n, k) bf16, y (rows, n) bf16, all
// contiguous and 16-byte aligned; k % 32 == 0, n % 128 == 0, and 16 rows
// of k (plus the weight stages) fit in shared memory.
extern "C" int fused_ln_matmul_bf16(const void* x, const void* g, const void* w, void* y, int rows,
                                    int k, int n, float eps, void* stream) {
  return launch(true, x, g, w, y, rows, k, n, eps, stream);
}

// x (rows, k) bf16, w (n, k) bf16, g (n,) fp32, y (rows, n) bf16, as above;
// 16 rows of k and of n (plus the weight stages) fit in shared memory.
extern "C" int fused_matmul_ln_bf16(const void* x, const void* w, const void* g, void* y, int rows,
                                    int k, int n, float eps, void* stream) {
  return launch(false, x, g, w, y, rows, k, n, eps, stream);
}
