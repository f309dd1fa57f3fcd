// Stride-1 SAME 3x3 convolution, NHWC, bf16, for sm_90a: an implicit GEMM on
// wgmma, fed by TMA.
//
// Replaces `conv2d_same` -> `_forward` -> `_kernel` of imagen_tpu/ops/conv2d.py
// (the halo-DMA Pallas conv). Its cin-split (`_tiles_with_split`) was a
// VMEM-fitting artifact and is not carried over: this kernel loops over cin,
// so any cin that is a multiple of 16 runs in one launch.
//
// out[b, y, x, o] = bias[o] + sum_{dy, dx, c} in[b, y+dy-1, x+dx-1, c] * w[dy, dx, c, o]
// with zeros outside the image; bf16 inputs, fp32 sums, the output rounded to
// bf16 once. w is (3, 3, cin, cout), the layout the wrapper keeps beside the
// module's torch (cout, cin, 3, 3) weight; cout is a multiple of 8.
//
// What bounds it on the H100: a GEMM of M = b H W pixels, N = cout and K =
// 9 cin. At the paths' shapes (cin 128-2048, cout 128-1024) that is 575 to
// 3,500 flop per byte of HBM traffic: the tensor cores bound it, and only
// wgmma reaches their rate. Next comes the traffic from L2 into the SMs: a
// tile of P pixels x N channels reads 9 cin N weights for its P pixels, so P
// has to be large.
//
// Design.
// - A tile is TH output rows (2 or 4) x 64 pixels x 128 output channels. A
//   block is a producer warpgroup, which gives its registers up (setmaxnreg),
//   and two consumer warpgroups, each TH / 2 output rows: one m64 block of
//   wgmma m64n128k16 a row, fp32 accumulators in registers (64 a row a thread).
// - K runs over 64-channel chunks, and in each over the 9 taps. Per chunk one
//   TMA load brings the input band, (TH + 2) rows x 66 pixels x 64 channels
//   (a 4-D map over x, 128-byte swizzle), at the signed coordinates (c0, x0 -
//   1, y0 - 1, b): TMA writes zeros for every element outside the tensor, so
//   the SAME halo, ragged H and W, and channels past cin cost nothing. Per tap
//   two TMA loads bring the weights, 64 channels x 128 outputs of w viewed as
//   (9, cin, cout): the MN-major B operand in 64-column blocks, rows past cin
//   zero (the map's cin dimension ends there, so nothing comes from the next
//   tap). The (3, 3, cin, cout) layout needs no repack.
// - Tap (dy, dx) of output row r is the band's 64 consecutive pixels from
//   (r + dy) * 66 + dx: a shifted window of the one band, read as the
//   K-major A operand by descriptor. Its start is in general not on the
//   1,024-byte period of the swizzle; the H100 swizzles by the absolute
//   shared-memory address, as TMA wrote the band, so the descriptor's base
//   offset stays 0 (set to the start's phase, as the PTX manual describes
//   it, it gave wrong products on the card). This is chosen over ldmatrix
//   into registers and the RS form: every operand stays in shared memory, the
//   products need no registers beyond the accumulators, and nothing is held
//   across products (see hopper.cuh on ptxas serializing wgmma).
// - Rings with full and empty mbarriers: 2 bands, and per-tap weight stages,
//   as many as fit beside the output staging (3 at TH 4, 7 at TH 2; stages of
//   half a tap, twice as many, measured slower). The producer loads the next
//   chunk's band while the consumers start on this chunk, 8 taps ahead. Each
//   consumer keeps one tap's products in flight while it issues the next and
//   frees a stage when the products that read it are done.
// - The epilogue adds the bias in fp32, rounds once, writes the tile into
//   swizzled shared memory of its own and stores it by TMA, which writes no
//   pixel past W, no row past H and no channel past cout. The wait for that
//   store is deferred to the tile after.
// - The grid walks the tiles with the output-channel blocks fastest, so the
//   blocks in flight share each input band in L2 (pixels fastest re-read the
//   input from HBM once per channel block and measured up to 16% slower).
//   With more tiles than SMs the grid is persistent, one block an SM: each
//   block loops over tiles, and its producer loads the next tile's band and
//   weights during the epilogue (up to 15% faster at cin 128).
//   `conv_tiles` (ops/conv2d.py) chooses TH, the stages and the grid.
//
// L2 -> SM traffic per call: a 4 x 64 x 128 tile reads 9 x 256 bytes of
// weights and (6 x 66 x 128) / 64 = 792 bytes of band per input channel, 3,096
// cin bytes in all; the mma.sync design before it (2 x 64 x 128 tiles,
// 16-channel chunks, every tap's weights staged again per tile) read 2,832
// cin bytes per 128 pixels. Per call at the paths' shapes:
//   (b, H, W, cin) -> cout     tiles  waves(132)   this design   mma.sync design
//   (2, 64, 64, 1024) -> 1024    256     1.94       0.81 GB       1.49 GB
//   (2, 64, 64, 2048) -> 1024    256     1.94       1.62 GB       2.97 GB
//   (2, 128, 128, 512) -> 512    512     3.88       0.81 GB       1.49 GB
//   (2, 128, 128, 1024) -> 512   512     3.88       1.62 GB       2.97 GB
//   (2, 256, 256, 256) -> 256   1024     7.76       0.81 GB       1.49 GB
//   (2, 256, 256, 512) -> 256   1024     7.76       1.62 GB       2.97 GB
//   (2, 512, 512, 128) -> 128   2048    15.52       0.81 GB       1.49 GB
//   (2, 512, 512, 256) -> 128   2048    15.52       1.62 GB       2.97 GB
//   (2, 1024, 1024, 128) -> 128 8192    62.06       3.25 GB       5.94 GB
//   (8, 64, 64, 1024) -> 512     512     3.88       1.62 GB       2.97 GB
//   (8, 128, 128, 128) -> 128    512     3.88       0.20 GB       0.37 GB
//   (8, 128, 128, 256) -> 128    512     3.88       0.41 GB       0.74 GB
//   (8, 256, 256, 128) -> 128   2048    15.52       0.81 GB       1.49 GB
// That is 5.2 TB/s at the tensor cores' full rate, 190 flop a byte.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int TW = 64;                  // output pixels of a tile row: one m64 block
constexpr int BN = 128;                 // output channels of a tile
constexpr int CK = 64;                  // input channels of a chunk: 128 bytes a pixel
constexpr int PITCH = TW + 2;           // band pixels of a band row
constexpr int THREADS = 384;            // a producer and two consumer warpgroups
constexpr int BANDS = 2;                // band ring
constexpr int W_BYTES = CK * BN * 2;    // one tap of the weights, 2 column blocks
constexpr int OUT_BYTES = 64 * BN * 2;  // one staged m64 block of the output
constexpr int MAX_SMEM = 232448;        // shared memory a block may use on the H100

template <int TH>
struct Tile {
  static constexpr int MB = TH / 2;                          // rows a consumer computes
  static constexpr int BAND_BYTES = (TH + 2) * PITCH * 128;  // what one band load writes
  static constexpr int BAND_STAGE = (BAND_BYTES + 1023) / 1024 * 1024;
  static constexpr int OUT_OFF = BANDS * BAND_STAGE;
  static constexpr int W_OFF = OUT_OFF + TH * OUT_BYTES;
  // + the weight ring, its barriers and the 1024-byte alignment slack
  // (ops/conv2d.py `conv_smem` computes the same)
  static int smem(int stages) {
    return W_OFF + stages * W_BYTES + 8 * 2 * (BANDS + stages) + 1024;
  }
};

// The K-major A operand of k16 step ks: 64 band pixels from pixel p (128
// bytes each), in the 128-byte swizzle; the base offset stays 0 (hopper.cuh).
__device__ __forceinline__ uint64_t desc_band(uint32_t band, int p, int ks) {
  return make_desc(band + p * 128 + ks * 32, 16, 1024, 1);
}

struct TileCoords {
  int x0, y0, b, n0;
};

__device__ __forceinline__ TileCoords tile_coords(int t, int n_tiles, int ntx, int nty, int th) {
  const int mt = t / n_tiles;
  return {(mt % ntx) * TW, ((mt / ntx) % nty) * th, mt / (ntx * nty), (t % n_tiles) * BN};
}

template <int TH>
__global__ void __launch_bounds__(THREADS, 1)
conv2d_same_3x3_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_w,
                       const __grid_constant__ CUtensorMap tm_out,
                       const __nv_bfloat16* __restrict__ bias, int b, int H, int W, int cin,
                       int cout, int stages) {
  using T = Tile<TH>;
  constexpr int MB = T::MB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_1024(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  uint64_t* band_full = reinterpret_cast<uint64_t*>(smem + T::W_OFF + stages * W_BYTES);
  uint64_t* band_empty = band_full + BANDS;
  uint64_t* w_full = band_empty + BANDS;
  uint64_t* w_empty = w_full + stages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ntx = (W + TW - 1) / TW, nty = (H + TH - 1) / TH;
  const int n_tiles = (cout + BN - 1) / BN;
  const int tiles = b * nty * ntx * n_tiles;
  const int chunks = (cin + CK - 1) / CK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < BANDS; ++s) {
      mbar_init(&band_full[s], 1);
      mbar_init(&band_empty[s], 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < stages; ++s) {
      mbar_init(&w_full[s], 1);
      mbar_init(&w_empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup: one thread issues every load
    setmaxnreg_dec<24>();
    if (warp == 8 && lane == 0) {
      auto load_band = [&](int t, int c, int item) {
        const int slot = item % BANDS;
        if (item >= BANDS) mbar_wait(&band_empty[slot], (item / BANDS - 1) & 1);
        const TileCoords tc = tile_coords(t, n_tiles, ntx, nty, TH);
        mbar_expect_tx(&band_full[slot], T::BAND_BYTES);
        tma_load_4d(sbase + slot * T::BAND_STAGE, &tm_x, &band_full[slot], c * CK, tc.x0 - 1,
                    tc.y0 - 1, tc.b);
      };
      int t = blockIdx.x, c = 0, item = 0, kw = 0;
      if (t < tiles) load_band(t, 0, 0);
      while (t < tiles) {
        const int n0 = tile_coords(t, n_tiles, ntx, nty, TH).n0;
        for (int tap = 0; tap < 9; ++tap, ++kw) {
          const int s = kw % stages;
          if (kw >= stages) mbar_wait(&w_empty[s], (kw / stages - 1) & 1);
          mbar_expect_tx(&w_full[s], W_BYTES);
          const uint32_t dst = sbase + T::W_OFF + s * W_BYTES;
          tma_load_3d(dst, &tm_w, &w_full[s], n0, c * CK, tap);
          tma_load_3d(dst + W_BYTES / 2, &tm_w, &w_full[s], n0 + 64, c * CK, tap);
          if (tap == 1) {  // the next chunk's band (the next tile's first after the last)
            const bool last = c + 1 == chunks;
            const int t2 = last ? t + (int)gridDim.x : t;
            if (t2 < tiles) load_band(t2, last ? 0 : c + 1, item + 1);
          }
        }
        ++item;
        if (++c == chunks) {
          c = 0;
          t += gridDim.x;
        }
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int wg = warp / 4, tid = threadIdx.x % 128;
  const int p_wg = MB * wg * PITCH;  // this consumer's first band pixel at tap (0, 0)
  const int r = (warp % 4) * 16 + lane / 4;  // this thread's rows of an m64 block: r, r + 8
  float acc[MB][BN / 2];
  int item = 0, kw = 0;
  bool stored = false;  // a TMA store of this consumer's staging may be reading it

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    for (int c = 0; c < chunks; ++c, ++item) {
      const int slot = item % BANDS;
      mbar_wait(&band_full[slot], (item / BANDS) & 1);
      const uint32_t band = sbase + slot * T::BAND_STAGE;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap, ++kw) {
        const int s = kw % stages;
        mbar_wait(&w_full[s], (kw / stages) & 1);
        const uint32_t wt = sbase + T::W_OFF + s * W_BYTES;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < CK / 16; ++ks) {
#pragma unroll
          for (int j = 0; j < MB; ++j)
            wgmma_ss<BN, 1>(acc[j], desc_band(band, p_wg + (j + tap / 3) * PITCH + tap % 3, ks),
                            desc_mn<BN, CK>(wt, ks), (c | tap | ks) != 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the tap before is done: free its stages
        __syncwarp();
        if (lane == 0 && (c | tap) != 0) {
          mbar_arrive(&w_empty[(kw - 1) % stages]);
          if (tap == 0) mbar_arrive(&band_empty[(item - 1) % BANDS]);
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < MB; ++j) fence_regs(acc[j]);
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(&w_empty[(kw - 1) % stages]);
      mbar_arrive(&band_empty[(item - 1) % BANDS]);
    }

    // epilogue: + bias in fp32, one rounding, through this consumer's staging
    const TileCoords tc = tile_coords(t, n_tiles, ntx, nty, TH);
    const uint32_t stage_out = T::OUT_OFF + wg * MB * OUT_BYTES;
    if (tid == 0 && stored) tma_store_wait();  // the last tile's store has read the staging
    named_sync(1 + wg, 128);
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
      const int n = tc.n0 + nb * 8 + (lane % 4) * 2;
      float b0 = 0.f, b1 = 0.f;
      if (bias != nullptr && n < cout) {  // cout is even, so n + 1 < cout too
        const __nv_bfloat162 bv = *reinterpret_cast<const __nv_bfloat162*>(bias + n);
        b0 = __low2float(bv);
        b1 = __high2float(bv);
      }
#pragma unroll
      for (int j = 0; j < MB; ++j) {
        uint8_t* tile = smem + stage_out + j * OUT_BYTES;
        const int byte = (lane % 4) * 4;
        *reinterpret_cast<__nv_bfloat162*>(tile + tile_offset<BN, 64>(r, nb) + byte) =
            __floats2bfloat162_rn(acc[j][4 * nb] + b0, acc[j][4 * nb + 1] + b1);
        *reinterpret_cast<__nv_bfloat162*>(tile + tile_offset<BN, 64>(r + 8, nb) + byte) =
            __floats2bfloat162_rn(acc[j][4 * nb + 2] + b0, acc[j][4 * nb + 3] + b1);
      }
    }
    fence_proxy_async();
    named_sync(1 + wg, 128);
    if (tid == 0) {
#pragma unroll
      for (int j = 0; j < MB; ++j) {
        const int y = tc.y0 + MB * wg + j;
        if (y >= H) continue;
#pragma unroll
        for (int blk = 0; blk < BN / 64; ++blk)
          if (tc.n0 + 64 * blk < cout)
            tma_store_4d(&tm_out, sbase + stage_out + j * OUT_BYTES + blk * (OUT_BYTES / 2),
                         tc.n0 + 64 * blk, tc.x0, y, tc.b);
      }
      tma_store_commit();
    }
    stored = true;
  }
  if (tid == 0 && stored) tma_store_wait();
}

template <int TH>
cudaError_t launch(const void* x, const void* w, const void* bias, void* out, int b, int H, int W,
                   int cin, int cout, int stages, int grid, cudaStream_t stream) {
  using T = Tile<TH>;
  const int smem = T::smem(stages);
  if (stages < 2 || smem > MAX_SMEM) return cudaErrorInvalidValue;
  using u64 = cuuint64_t;
  const u64 px = (u64)cin * 2, po = (u64)cout * 2;  // bytes of a pixel in x and in out
  const u64 x_dims[4] = {(u64)cin, (u64)W, (u64)H, (u64)b};
  const u64 x_strides[3] = {px, px * W, px * W * H};
  const cuuint32_t x_box[4] = {CK, PITCH, TH + 2, 1};
  const u64 w_dims[3] = {(u64)cout, (u64)cin, 9};
  const u64 w_strides[2] = {po, po * cin};
  const cuuint32_t w_box[3] = {64, CK, 1};
  const u64 o_dims[4] = {(u64)cout, (u64)W, (u64)H, (u64)b};
  const u64 o_strides[3] = {po, po * W, po * W * H};
  const cuuint32_t o_box[4] = {64, TW, 1, 1};
  CUtensorMap tm_x, tm_w, tm_out;
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!encode_cached(&tm_x, bf16, 4, x, x_dims, x_strides, x_box, sw,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B) ||
      !encode_cached(&tm_w, bf16, 3, w, w_dims, w_strides, w_box, sw,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B) ||
      !encode_cached(&tm_out, bf16, 4, out, o_dims, o_strides, o_box, sw,
                     CU_TENSOR_MAP_L2_PROMOTION_NONE))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(conv2d_same_3x3_kernel<TH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)b * ((H + TH - 1) / TH) * ((W + TW - 1) / TW) *
                          ((cout + BN - 1) / BN);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  if (grid <= 0 || grid > tiles) grid = (int)tiles;
  conv2d_same_3x3_kernel<TH><<<grid, THREADS, smem, stream>>>(
      tm_x, tm_w, tm_out, static_cast<const __nv_bfloat16*>(bias), b, H, W, cin, cout, stages);
  return cudaGetLastError();
}

}  // namespace

// x (b, H, W, cin), w (3, 3, cin, cout), bias (cout,) or null, out (b, H, W, cout);
// all bf16, contiguous and 16-byte aligned; cin a multiple of 16, cout of 8.
// `rows` (2 or 4) output rows a tile, `stages` weight stages, `grid` blocks
// (at most one a tile; 0 for one a tile), as `conv_tiles` chooses them.
extern "C" int conv2d_same_3x3_bf16(const void* x, const void* w, const void* bias, void* out,
                                    int b, int H, int W, int cin, int cout, int rows, int stages,
                                    int grid, void* stream) {
  if (b < 1 || H < 1 || W < 1 || cin < 16 || cin % 16 != 0 || cout < 8 || cout % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 2: return (int)launch<2>(x, w, bias, out, b, H, W, cin, cout, stages, grid, s);
    case 4: return (int)launch<4>(x, w, bias, out, b, H, W, cin, cout, stages, grid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
