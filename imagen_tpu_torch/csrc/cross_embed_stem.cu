// The CrossEmbed stem, every scale in one launch, NHWC, bf16, for sm_90a: an
// implicit GEMM on wgmma, the input bands double-buffered by TMA, each
// weight set resident in shared memory, a persistent work list.
//
// Replaces `cross_embed_stem` -> `_forward` -> `_kernel` of
// imagen_tpu/ops/stem_conv.py. That kernel fed the MXU from a 4x4
// space-to-depth copy of the input (K = 96 per tap) and un-tiled the phases
// in registers; the H100 needs neither, so neither is carried over.
//
// out[b, y, x, coff_s + o] = bias[coff_s + o]
//     + sum_{dy, dx < k_s, c} in[b, y + dy - p_s, x + dx - p_s, c] * w_s[dy, dx, c, o]
// for each scale s (kernel k_s = 2 p_s + 1, d_s output channels at offset
// coff_s), zeros outside the image; fp32 sums, the bias added in fp32, one
// rounding to bf16.
//
// What bounds it on the H100: at the SR-1024 stem, (2, 1024, 1024, 6) with
// kernels (3, 7, 15) and (64, 32, 32) channels, the convs do 2.35e11 flops
// against 0.56 GB of bytes: the tensor cores bound it (0.24 ms at the dense
// bf16 peak); the 15 x 15 scale does 77% of the work. At the 3-channel stems
// (BaseUnet64's, 256 + 128 + 128 channels out, and the video U-Net's) the
// output bytes bound it.
//
// Design.
// - Staging: cp.async or TMA? The input is 6 or 3 channels, 12- or 6-byte
//   pixels, and TMA wants every global stride but the innermost a multiple of
//   16 bytes. So a first small kernel of this call pads the input to 8
//   channels, 16-byte pixels (one pass over the input, 2 to 4% of the
//   output's bytes); from that copy one 4-D TMA load per tile brings the
//   halo'd band, (8 + 2p) rows x (64 + 2P) pixels, whose zero fill is the SAME
//   padding and the ragged H and W. The bands are double-buffered, so the next
//   tile's band lands while this tile's products run.
// - Products: wgmma m64nNk16 with both operands in shared memory, no swizzle.
//   A k16 step is a pair of horizontally neighbouring taps (2q, 2q + 1), 8
//   channels each; for 64 output pixels its A is 64 band pixels of one band
//   row from 2q: core matrices of 8 pixels x 16 bytes, the next 8 pixels 128
//   bytes on (SBO), and the K half of the odd tap one pixel, 16 bytes, on (LBO
//   = 16: the two halves overlap in memory). No copy of the band per tap. A
//   15-tap row takes P = 8 pairs, the last pair's odd tap with zero weights;
//   channels past c have zero weights. P is rounded up to 2, 4 or 8 and is a
//   template parameter with N, so a loop iteration issues a band row's P
//   wgmmas unrolled, with no branch around them, and waits one row behind.
//   The set's k, N and P are broadcast from lane 0 so ptxas sees the
//   branches on them uniform. On the card, a branch it could not prove
//   uniform serialized every wgmma (C7520); a guard around each wgmma made
//   it fence each (C7519) and run up to 1.2x as long; two wgmmas an
//   iteration were slower still.
// - A scale has few channels (32 at the SR stems' 15 x 15 scale), and a
//   wgmma of N 32 ran far below the tensor cores' rate on the card (each
//   reads its 64 x 16 A again for 32 columns). So a wgmma stacks RP output
//   rows along N (4 at n <= 32 channels, 2 at 64): band row R times, for
//   stacked row j, the weights of tap row R - j. The set's weights are laid
//   out per tap column (2P groups) as k blocks of n rows in falling tap row,
//   RP - 1 zero blocks between the groups, so the RP blocks a band row needs
//   are one window of consecutive rows, zero where R - j is no tap row
//   (k / (k + RP - 1) of the products count: 83% at k 15). N is 64 or 128.
// - A set is a scale's channels (n 16 to 128, a power of two) or a chunk of
//   them where the weights would not fit beside the bands (at k 15, 32
//   channels, 146 KB) or d passes 128. It stays resident in shared memory as
//   `stem_conv.pack_stem_weights` lays it out, loaded by bulk copies when a
//   block's work turns to the next set.
// - A tile is 8 output rows x 64 pixels of one set. A block is two consumer
//   warpgroups of 4 rows each and a producer warp (288 threads). Each
//   warpgroup computes its 4 rows RP at a time, N / 2 fp32 accumulators a
//   thread (64 at N 128), the band and the weights staying put between
//   passes: so every N path fits ptxas's 168 registers without spills (128
//   accumulators a thread spilled and serialized every wgmma, C7512).
// - The two warpgroups take turns at the tensor cores (named barriers, as a
//   ping-pong): one issues a pass's products while the other drains its
//   last ones and stores its rows, so the stores hide behind products.
// - All scales run in one launch: a persistent grid, one block an SM, walks
//   the work list of every set's tiles, the largest kernel first
//   (`stem_conv.stem_plan`), so the cheap 3 x 3 tiles fill the end.
// - The epilogue adds the bias and stores each pixel's channels of the set
//   straight from the registers (bounds-checked: d need not fill N).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int TH = 8;            // output rows of a tile
constexpr int TW = 64;           // output pixels of a tile row: one m64 block
constexpr int MB = TH / 2;       // rows a consumer warpgroup computes
constexpr int THREADS = 288;     // two consumer warpgroups and a producer warp
constexpr int MAX_SCALES = 4;
constexpr int MAX_P = 7;         // kernels up to 15
constexpr int MAX_SETS = 32;
constexpr int BAND_STAGE = ((TH + 2 * MAX_P) * (TW + 2 * (MAX_P + 1)) * 16 + 1023) / 1024 * 1024;
constexpr int W_OFF = 2 * BAND_STAGE;
constexpr int MAX_SMEM = 232448;
constexpr int TURN = 2;          // named barriers TURN + w: warpgroup w's turn to issue

struct Set {
  int scale, k, d, coff, n0, n, woff;  // woff: the set's first weight element
};
constexpr int SET_INTS = sizeof(Set) / sizeof(int);

struct Plan {
  Set set[MAX_SETS];
  int nsets, b, H, W, D, ntx, nty, tiles, w_max;  // w_max: the largest set's weight bytes
};

// Tap pairs of a row of k taps (one k16 step each; the last pair's odd tap
// has zero weights), and the band pixels a tile row reads, 64 + 2 pairs.
__host__ __device__ inline int tap_pairs(int k) {
  const int P = (k + 1) / 2;
  return P <= 2 ? 2 : P <= 4 ? 4 : 8;
}
__host__ __device__ inline int band_width(int k) { return TW + 2 * tap_pairs(k); }

// A value every thread of the warp holds, broadcast from lane 0 so that ptxas
// sees it uniform: a branch on it around wgmma is then not divergent (one it
// cannot prove uniform serializes every wgmma, C7520).
__device__ __forceinline__ int uniform(int v) { return __shfl_sync(0xffffffffu, v, 0); }

// No-swizzle K-major operands: 16-byte rows, 8-row core matrices 128 bytes
// apart; the K halves `lbo` bytes apart.
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t lbo) {
  return make_desc(addr, lbo, 128, 0);
}

// Output rows a wgmma stacks along N for a set of n channels: 4 at n <= 32,
// 2 at 64, 1 at 128 (N = 64 or 128), and the zero blocks between the tap
// groups of the set's weights that make every window of rows whole.
__host__ __device__ constexpr int stacked_rows(int n) {
  return n >= 128 ? 1 : 128 / n > MB ? MB : 128 / n;
}

__host__ __device__ inline int weight_bytes(const Set& s) {
  const int groups = 2 * tap_pairs(s.k), pad = stacked_rows(s.n) - 1;  // tap columns
  return (groups * s.k + (groups + 1) * pad) * s.n * 16;
}

// A warpgroup's MB output rows of a tile, RP of them at a time stacked along
// N: band row r0 + R (R < k + RP - 1) against, for stacked row j, the
// weights of tap row R - j, a window of RP consecutive blocks of the tap
// group (zero where R - j is not a tap row). fp32 accumulators, + bias, one
// rounding, stored; channels past `nvalid` and pixels past the image are not.
template <int N, int P>
__device__ __forceinline__ void tile_rows(uint32_t band, uint32_t wts, int k, int ch0, int nvalid,
                                          const Plan& pl, int x0, int y0, int b, int wg,
                                          const __nv_bfloat16* __restrict__ bias,
                                          __nv_bfloat16* __restrict__ out, int warp, int lane) {
  constexpr int RP = stacked_rows(N), NS = RP * N;  // rows stacked, the wgmma's N
  const int bw = band_width(k);
  const uint32_t group = (k + RP - 1) * N * 16;      // bytes from a tap group to the next (LBO)
  const int px = x0 + (warp % 4) * 16 + lane / 4;    // this thread's pixels: px, px + 8
  const int cq = 2 * (lane % 4);
  const int H = pl.H, W = pl.W, D = pl.D;
#pragma unroll 1
  for (int pass = 0; pass < MB / RP; ++pass) {
    const int r0 = wg * MB + pass * RP;
    float acc[NS / 2];
    named_sync(TURN + wg, 2 * 128);  // this warpgroup's turn at the tensor cores
    // a band row's tap pairs an iteration, committed and waited one behind
    for (int R = 0; R < k + RP - 1; ++R) {
      const uint32_t arow = band + (r0 + R) * bw * 16;
      const uint32_t brow = wts + (RP - 1 + k - 1 - R) * N * 16;  // block k - 1 - R of column 0
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < P; ++q)
        wgmma_ss<NS, 0>(acc, desc_plain(arow + q * 32, 16),
                        desc_plain(brow + 2 * q * group, group), (R | q) != 0);
      wgmma_commit();
      wgmma_wait<1>();
    }
    named_arrive(TURN + (wg ^ 1), 2 * 128);  // the other's turn, while this one drains and stores
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int j = 0; j < RP; ++j) {
      const int y = y0 + r0 + j;
      if (y >= H) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = px + 8 * h;
        if (x >= W) continue;
        const size_t at = (((size_t)b * H + y) * W + x) * D + ch0;
        __nv_bfloat16* o = out + at;
        const bool even = at % 2 == 0;
#pragma unroll
        for (int c8 = 0; c8 < N / 8; ++c8) {
          const int n = 8 * c8 + cq, a = 4 * (j * (N / 8) + c8) + 2 * h;
          if (n >= nvalid) continue;
          const float v0 = acc[a] + __bfloat162float(bias[ch0 + n]);
          if (n + 1 < nvalid) {
            const float v1 = acc[a + 1] + __bfloat162float(bias[ch0 + n + 1]);
            if (even) {
              *reinterpret_cast<__nv_bfloat162*>(o + n) = __floats2bfloat162_rn(v0, v1);
            } else {
              o[n] = __float2bfloat16(v0);
              o[n + 1] = __float2bfloat16(v1);
            }
          } else {
            o[n] = __float2bfloat16(v0);
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
cross_embed_stem_kernel(const __grid_constant__ CUtensorMap tm0,
                        const __grid_constant__ CUtensorMap tm1,
                        const __grid_constant__ CUtensorMap tm2,
                        const __grid_constant__ CUtensorMap tm3, const __grid_constant__ Plan pl,
                        const __nv_bfloat16* __restrict__ w,
                        const __nv_bfloat16* __restrict__ bias,
                        __nv_bfloat16* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_1024(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  uint64_t* band_full = reinterpret_cast<uint64_t*>(smem + W_OFF + pl.w_max);
  uint64_t* band_empty = band_full + 2;
  uint64_t* w_full = band_empty + 2;
  uint64_t* w_empty = w_full + 1;
  Set* sets = reinterpret_cast<Set*>(w_empty + 1);  // the work list's sets, read by index

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int items = pl.nsets * pl.tiles;

  if (threadIdx.x < pl.nsets * SET_INTS)
    reinterpret_cast<int*>(sets)[threadIdx.x] = reinterpret_cast<const int*>(pl.set)[threadIdx.x];
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&band_full[s], 1);
      mbar_init(&band_empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init(w_full, 1);
    mbar_init(w_empty, 8);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // the producer warp: one thread issues every load
    if (lane == 0) {
      int cur = -1, loads = 0, i = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++i) {
        const int s = item / pl.tiles, t = item % pl.tiles;
        const Set st = sets[s];
        if (s != cur) {  // the next set's weights, once the last set's tiles are done
          if (loads > 0) mbar_wait(w_empty, (loads - 1) & 1);
          const int bytes = weight_bytes(st);
          mbar_expect_tx(w_full, bytes);
          for (int off = 0; off < bytes; off += 32768)
            bulk_load(sbase + W_OFF + off, w + st.woff + off / 2,
                      bytes - off < 32768 ? bytes - off : 32768, w_full);
          cur = s;
          ++loads;
        }
        const int slot = i % 2, p = st.k / 2;
        if (i >= 2) mbar_wait(&band_empty[slot], (i / 2 - 1) & 1);
        const CUtensorMap* map = st.scale == 0 ? &tm0 : st.scale == 1 ? &tm1
                                                  : st.scale == 2 ? &tm2 : &tm3;
        mbar_expect_tx(&band_full[slot], (TH + 2 * p) * band_width(st.k) * 16);
        tma_load_4d(sbase + slot * BAND_STAGE, map, &band_full[slot], 0,
                    (t % pl.ntx) * TW - p, ((t / pl.ntx) % pl.nty) * TH - p,
                    t / (pl.ntx * pl.nty));
      }
    }
    return;
  }

  const int wg = warp / 4;
  if (wg == 1) named_arrive(TURN, 2 * 128);  // warpgroup 0 takes the first turn
  int cur = -1, loads = 0, i = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++i) {
    const int s = item / pl.tiles, t = item % pl.tiles;
    const Set st = sets[s];
    const int k = uniform(st.k), n = uniform(st.n);
    if (s != cur) {
      mbar_wait(w_full, loads & 1);
      cur = s;
      ++loads;
    }
    const int slot = i % 2;
    mbar_wait(&band_full[slot], (i / 2) & 1);
    const uint32_t band = sbase + slot * BAND_STAGE, wts = sbase + W_OFF;
    const int x0 = (t % pl.ntx) * TW, y0 = ((t / pl.ntx) % pl.nty) * TH;
    const int b = t / (pl.ntx * pl.nty), ch0 = st.coff + st.n0;
    const int nvalid = st.d - st.n0 < st.n ? st.d - st.n0 : st.n;
    // one instance per (N, tap pairs): the wgmmas of a band row unrolled, no
    // branch around them
    const int P = uniform(tap_pairs(k));
#define STEM_ROWS_CASE(NN)                                                                   \
  case NN:                                                                                   \
    if (P == 2)                                                                              \
      tile_rows<NN, 2>(band, wts, k, ch0, nvalid, pl, x0, y0, b, wg, bias, out, warp, lane); \
    else if (P == 4)                                                                         \
      tile_rows<NN, 4>(band, wts, k, ch0, nvalid, pl, x0, y0, b, wg, bias, out, warp, lane); \
    else                                                                                     \
      tile_rows<NN, 8>(band, wts, k, ch0, nvalid, pl, x0, y0, b, wg, bias, out, warp, lane); \
    break;
    switch (n) {
      STEM_ROWS_CASE(16)
      STEM_ROWS_CASE(32)
      STEM_ROWS_CASE(64)
      default:
        STEM_ROWS_CASE(128)
    }
#undef STEM_ROWS_CASE
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(&band_empty[slot]);
      const int next = item + gridDim.x;
      if (next >= items || next / pl.tiles != s) mbar_arrive(w_empty);  // the set's last tile
    }
  }
}

// x (b, H, W, c < 8) -> x8 (b, H, W, 8), channels past c zero: 16-byte pixels for TMA.
__global__ void cross_embed_pad_kernel(const __nv_bfloat16* __restrict__ x, uint4* __restrict__ x8,
                                       long long pixels, int c) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < pixels;
       i += (long long)gridDim.x * blockDim.x) {
    __align__(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = e < c ? x[i * c + e] : __float2bfloat16(0.f);
    x8[i] = *reinterpret_cast<const uint4*>(v);
  }
}

}  // namespace

// x (b, H, W, c <= 8); x8 (b, H, W, 8), the padded copy this call writes (x
// itself when c is 8); w the sets' packed weights, `plan` (host memory)
// nsets rows of (scale, k, d, coff, n0, n, woff) as `stem_conv.stem_plan`
// makes them; bias (D,), out (b, H, W, D), D = sum d_s; all bf16,
// contiguous, 16-byte aligned. `grid` blocks (at most one an SM).
extern "C" int cross_embed_stem_bf16(const void* x, void* x8, const void* w, const void* bias,
                                     void* out, const int* plan, int b, int H, int W, int c,
                                     int nscales, int k0, int k1, int k2, int k3, int d0, int d1,
                                     int d2, int d3, int nsets, int grid, void* stream) {
  const int ks[MAX_SCALES] = {k0, k1, k2, k3};
  const int ds[MAX_SCALES] = {d0, d1, d2, d3};
  if (b < 1 || H < 1 || W < 1 || c < 1 || c > 8 || nscales < 1 || nscales > MAX_SCALES ||
      nsets < 1 || nsets > MAX_SETS || grid < 1 || (c == 8 && x8 != x))
    return (int)cudaErrorInvalidValue;
  Plan pl = {};
  pl.nsets = nsets;
  pl.b = b, pl.H = H, pl.W = W;
  for (int s = 0; s < nscales; ++s) {
    if (ks[s] < 1 || ks[s] % 2 == 0 || ks[s] / 2 > MAX_P || ds[s] < 1)
      return (int)cudaErrorInvalidValue;
    pl.D += ds[s];
  }
  int w_max = 0;
  for (int i = 0; i < nsets; ++i) {
    const int* r = plan + 7 * i;
    pl.set[i] = {r[0], r[1], r[2], r[3], r[4], r[5], r[6]};
    const Set& st = pl.set[i];
    if (st.scale < 0 || st.scale >= nscales || st.k != ks[st.scale] || st.d != ds[st.scale] ||
        !(st.n == 16 || st.n == 32 || st.n == 64 || st.n == 128))
      return (int)cudaErrorInvalidValue;
    w_max = weight_bytes(st) > w_max ? weight_bytes(st) : w_max;
  }
  pl.ntx = (W + TW - 1) / TW;
  pl.nty = (H + TH - 1) / TH;
  pl.tiles = b * pl.ntx * pl.nty;
  pl.w_max = w_max;
  const int smem = W_OFF + w_max + 8 * 6 + (int)sizeof(Set) * MAX_SETS + 1024;
  if (smem > MAX_SMEM || (long long)pl.tiles * nsets > 0x7fffffff) return (int)cudaErrorInvalidValue;

  // one tensor map a scale: 8 channels x band_width(k) pixels x (8 + 2p) rows
  CUtensorMap tm[MAX_SCALES];
  using u64 = cuuint64_t;
  const u64 dims[4] = {8, (u64)W, (u64)H, (u64)b};
  const u64 strides[3] = {16, (u64)16 * W, (u64)16 * W * H};
  for (int s = 0; s < MAX_SCALES; ++s) {
    const int k = s < nscales ? ks[s] : ks[0];
    const cuuint32_t box[4] = {8, (cuuint32_t)band_width(k), (cuuint32_t)(TH + k - 1), 1};
    if (!encode_cached(&tm[s], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x8, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B))
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c < 8) {
    const long long pixels = (long long)b * H * W;
    const long long blocks = (pixels + 255) / 256;
    cross_embed_pad_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<uint4*>(x8), pixels, c);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  cudaError_t err = cudaFuncSetAttribute(cross_embed_stem_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int items = pl.tiles * nsets;
  cross_embed_stem_kernel<<<grid < items ? grid : items, THREADS, smem, st>>>(
      tm[0], tm[1], tm[2], tm[3], pl, static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}
