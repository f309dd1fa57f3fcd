// LayerNorm fused into the matrix product after it, and the product fused
// into the LayerNorm after it, bf16, for sm_90a: kernel 11 of the port, wgmma
// products fed by TMA, the column tiles of a row tile in one thread block
// cluster.
//
//   fused_ln_matmul_bf16:  y = bf16(LN_k(x) * g) @ W^T        x (rows, k) -> y (rows, n)
//   fused_matmul_ln_bf16:  y = LN_n(bf16(x @ W^T)) * g        x (rows, k) -> y (rows, n)
//
// (bias-free LayerNorms, W the torch Linear weight (n, k), K-major for wgmma's
// B operand as it lies). Replaces `fused_ln_matmul` / `fused_matmul_ln` ->
// `_lnmm_forward` / `_mmln_forward` of imagen_tpu/ops/fused_norm.py, whose
// pallas_call is `_pallas_rowblock_call` (:384) over `_lnmm_kernel` /
// `_mmln_kernel`. Arithmetic as those kernels: LayerNorm statistics in fp32 in
// two passes (the mean, then the variance of the centred row), the normalised
// row rounded to bf16 before the product; products of bf16 with fp32
// accumulation; in the second, the product rounded to bf16 before its
// LayerNorm, as the module chain rounds it. The JAX package wires neither into
// `Attention`/`CrossAttention`, and neither does the port.
//
// What bounds it on the H100: at the sites they would take in the EDM path
// (the attention pre-norm into to_q and to_kv, k 1024-2048, n 512-640; the
// out-projection into the out-norm, k 512, n 1024-2048) 2 k n flops a row
// against 2 (k + n) bytes, 300-800 flops a byte: the tensor cores, at 989
// TFLOP/s, bound every site, e.g. 10.7 GFLOP and 0.011 ms for the 32^2
// pre-norm at batch 8 (8192 x 1024 x 640). Next comes the traffic from L2
// into the SMs: every row tile reads W's column tile whole, every column tile
// x's row tile, 2 k (1 / BN + 1 / BM) bytes a product.
//
// Design.
// - A block computes one BM x BN output tile: two consumer warpgroups, each
//   64 rows x WN columns of wgmma m64nWNk16 (WN 64-320, as N1 + N2 wgmmas
//   when past 256), split by rows (BM 128, BN = WN) or by columns (BM 64,
//   BN = 2 WN), and a producer warpgroup that gives its registers up
//   (setmaxnreg). `ops/fused_norm.lnmm_tiles` chooses the tile (and
//   `plan` below the same): the fewest waves of blocks, each costed by its
//   products and by its L2 traffic.
// - The producer streams the x row tile and W's column tile by TMA through an
//   mbarrier ring of 64-column K stages (128-byte swizzle; rows past `rows`
//   arrive as zeros, so no row is masked). x is not held whole: at k 2048 a
//   64-row tile would take 256 KB.
// - LN -> matmul. The blocks of a cluster are the column tiles of one row
//   tile (up to 8; more tiles are more clusters). Each block takes the
//   statistics of BM / cl of the rows from global memory, 8 threads a row,
//   two passes, and writes them into every block of the cluster through
//   distributed shared memory: the LayerNorm is computed once per row tile,
//   not once per column tile. Then, stage by stage, the consumers normalise
//   the x stage in place (rounded to bf16: the A operand) while the tensor
//   cores run the stage before, a barrier between. Timed in development: the
//   largest single part of the time at 512-2048 rows; handing it to three
//   producer warps (a third mbarrier a stage) was slower, the warps too few
//   for 1024 chunks a stage.
// - matmul -> LN. The cluster is every column tile of the row (n / BN <= 8
//   blocks). The products run as the producer streams (two stages in
//   flight); the accumulators are rounded to bf16 and each row's sum crosses
//   the cluster by distributed shared memory, summed in rank order
//   (row_norm.cuh, kernel 10's LN1 statistics), then the centred squares the
//   same way; the normalised tile is stored. The result is bitwise the same
//   from call to call.
// - Epilogue: the bf16 tile is staged over the ring (128-byte swizzle) and
//   written by one TMA store a 64-column box, clipping the ragged last rows.
// - The staged route: matmul -> LN where no tile of the set divides n into 1,
//   2, 4 or 8 blocks (n 896, 1152, n past 5120, ...; no site of the paths):
//   the product with no norm writes bf16(x W^T) to y, then a row LayerNorm
//   (row_norm.cuh) normalises y in place, a warp a row.
// What was weighed: the in-place LayerNorm of a resident x tile (kernel 10's
// LN0) holds 64 x k, 256 KB at the k 2048 sites, and makes every row tile
// read W whole for 64 rows only; streaming x in stages and normalising each
// stage keeps 128-row tiles at every k. Statistics from a separate pass over
// x by their own kernel would read x once from HBM but need a scratch buffer
// the C entry does not take.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "row_norm.cuh"

namespace {

constexpr int THREADS = 384;      // two consumer warpgroups and a producer warpgroup
constexpr int CONSUMERS = 256;
constexpr int KC = 64;            // K of a stage: 128-byte rows, 128-byte swizzle
constexpr int MAX_STAGES = 6;
constexpr int MAX_SMEM = 232448;  // shared memory a block may use on the H100

enum Mode { LN_FIRST = 0, LN_AFTER = 1, PLAIN = 2 };

// Shared memory, every region on a 1024-byte boundary (ops/fused_norm.py
// `lnmm_smem` computes the same): the ring of stages (the x stage, BM rows,
// then W's, BN rows), which the output tile takes over at the end; the row
// statistics ([2 passes][8 ranks][BM] partials; LN -> matmul keeps each row's
// mean and rstd there); the per-row sums of the two warpgroups (128 floats);
// matmul -> LN's gains of the tile's columns (up to MAX_BN); the mbarriers;
// 1024 bytes of alignment slack.
constexpr int MAX_BN = 640;

struct Layout {
  int stage, stats, red, gain, bars, total;
};

__host__ __device__ inline Layout layout(int bm, int bn, int stages) {
  Layout L;
  L.stage = (bm + bn) * KC * 2;
  L.stats = stages * L.stage;
  L.red = L.stats + 2 * MAX_CLUSTER * bm * 4;
  L.gain = L.red + 128 * 4;
  L.bars = L.gain + MAX_BN * 4;
  L.total = L.bars + 8 * 2 * stages + 1024;
  return L;
}

// K-major operand at k16 step ks of a 64-column stage block (128-byte swizzle)
// whose rows start at `tile`.
__device__ __forceinline__ uint64_t desc_kc(uint32_t tile, int ks) {
  return make_desc(tile + ks * 32, 16, 1024, 1);
}

template <int MODE, int BM, int N1, int N2>
__global__ void __launch_bounds__(THREADS, 1)
fused_ln_matmul_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_w,
                       const __grid_constant__ CUtensorMap tm_y,
                       const __nv_bfloat16* __restrict__ x, const float* __restrict__ g,
                       int rows, int k, int col_tiles, int cl, int stages, float eps) {
  constexpr int WN = N1 + N2;             // columns of a warpgroup
  constexpr bool ROWSPLIT = BM == 128;    // the warpgroups take rows 0-63 and 64-127
  constexpr int BN = ROWSPLIT ? WN : 2 * WN;
  const Layout L = layout(BM, BN, stages);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_1024(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + stages;
  float* stats = reinterpret_cast<float*>(smem + L.stats);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* gain = reinterpret_cast<float*>(smem + L.gain);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = (blockIdx.x / col_tiles) * BM;
  const int col0 = (blockIdx.x % col_tiles) * BN;
  const int rank = (int)cluster_rank();
  const int iters = k / KC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  // every block of the cluster runs, its barriers set up, before any block
  // writes another's shared memory
  cluster_sync();

  float* mean_s = stats;
  float* rstd_s = stats + BM;
  if (warp >= 8) {  // the producer warpgroup: one thread issues every load
    setmaxnreg_dec<40>();
    const bool issuer = warp == 8 && lane == 0;
    auto load = [&](int it) {
      const int s = it % stages;
      if (it >= stages) mbar_wait(&empty[s], (it / stages - 1) & 1);
      const uint32_t dst = sbase + s * L.stage;
      mbar_expect_tx(&full[s], L.stage);
      tma_load_2d(dst, &tm_x, &full[s], it * KC, row0);
      for (int b = 0; b < BN / 64; ++b)
        tma_load_2d(dst + (BM + b * 64) * 128, &tm_w, &full[s], it * KC, col0 + b * 64);
    };
    int it = 0;
    if (MODE == LN_FIRST) {
      // the first stages need nothing from the consumers; the rest wait for
      // stages that they free after the statistics' cluster barrier
      cluster_arrive();
      if (issuer)
        for (; it < iters && it < stages; ++it) load(it);
      __syncwarp();
      cluster_wait();
    }
    if (issuer)
      for (; it < iters; ++it) load(it);
    __syncwarp();
    if (MODE == LN_AFTER) {  // the consumers' two statistics barriers
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int wg = warp / 4, ct = threadIdx.x;
  const int r = (ROWSPLIT ? wg * 64 : 0) + (warp % 4) * 16 + lane / 4;  // block rows r, r + 8
  const int cq = 2 * (lane % 4);  // the thread's first column of each n8 block
  const int bcol = ROWSPLIT ? 0 : wg * WN;  // the warpgroup's first column in the tile
  const uint32_t a_off = ROWSPLIT ? wg * 64 * 128 : 0;
  const uint32_t b_off = (BM + bcol) * 128;
  if (MODE == LN_AFTER) {  // the tile's gains, for the epilogue (read after barriers)
    for (int c = ct; c < BN; c += CONSUMERS) gain[c] = g[col0 + c];
  }

  if constexpr (MODE == LN_FIRST) {
    // this block's share of the row tile's statistics, 8 threads a row (a
    // warp's 4 rows together: BM / cl is a multiple of 4), into every block
    const int per = BM / cl, part = ct % 8;
    for (int rr = ct / 8; rr < per; rr += CONSUMERS / 8) {
      const int row = rank * per + rr;
      const bool valid = row0 + row < rows;
      const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)(row0 + row) * k);
      float s = 0.f;
      if (valid)
        for (int c = part; c < k / 8; c += 8) s += sum8(__ldg(src + c));
      const float mean = group_sum<8>(s) / k;
      float q = 0.f;
      if (valid)
        for (int c = part; c < k / 8; c += 8) q += sqdev8(__ldg(src + c), mean);
      q = group_sum<8>(q);  // every lane: a warp's rows may be valid and not
      const float rstd = valid ? rsqrtf(q / k + eps) : 0.f;
      if (part == 0) {
        for (int dst = 0; dst < cl; ++dst) {
          st_cluster(map_rank(smem_u32(mean_s + row), dst), mean);
          st_cluster(map_rank(smem_u32(rstd_s + row), dst), rstd);
        }
      }
    }
    cluster_sync();  // every row's statistics are in
  }

  // x stage `it` normalised in place, rounded to bf16: the A operand. Rows
  // past `rows` arrived as zeros and have rstd 0. A thread's chunks are all
  // column chunk ct % 8 of their rows, so its gains of a stage are 8 values,
  // loaded a stage ahead.
  auto gains = [&](int it, float (&gv)[8]) {
    if (it < iters) load8(g + it * KC + (ct % 8) * 8, gv);
  };
  auto normalise = [&](int it, const float (&gv)[8]) {
    uint8_t* a = smem + (it % stages) * L.stage;
    for (int i = ct; i < BM * 8; i += CONSUMERS) {
      const int row = i / 8;
      uint4* at = reinterpret_cast<uint4*>(a + tile_offset<64, BM>(row, i % 8));
      *at = ln_chunk_gains(*at, mean_s[row], rstd_s[row], gv);
    }
  };

  float acc1[N1 / 2];
  float acc2[N2 > 0 ? N2 / 2 : 1];
  auto issue = [&](int it) {
    const uint32_t st = sbase + (it % stages) * L.stage;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      wgmma_ss<N1, 0>(acc1, desc_kc(st + a_off, ks), desc_kc(st + b_off, ks), (it | ks) != 0);
      if constexpr (N2 > 0)
        wgmma_ss<N2, 0>(acc2, desc_kc(st + a_off, ks), desc_kc(st + b_off + N1 * 128, ks),
                        (it | ks) != 0);
    }
    wgmma_commit();
  };

  if constexpr (MODE == LN_FIRST) {
    // stage it + 1 is normalised while the tensor cores run stage it
    float gv[8];
    gains(0, gv);
    mbar_wait(&full[0], 0);
    normalise(0, gv);
    gains(1, gv);
    fence_proxy_async();
    named_sync(1, CONSUMERS);
    for (int it = 0; it < iters; ++it) {
      issue(it);
      if (it + 1 < iters) {
        mbar_wait(&full[(it + 1) % stages], ((it + 1) / stages) & 1);
        normalise(it + 1, gv);
        gains(it + 2, gv);
        fence_proxy_async();
      }
      wgmma_wait<0>();
      named_sync(1, CONSUMERS);  // stage it + 1 is normalised, stage it read
      if (lane == 0) mbar_arrive(&empty[it % stages]);
    }
  } else {
    for (int it = 0; it < iters; ++it) {
      mbar_wait(&full[it % stages], (it / stages) & 1);
      issue(it);
      wgmma_wait<1>();  // the stage before is read: free it
      __syncwarp();
      if (lane == 0 && it > 0) mbar_arrive(&empty[(it - 1) % stages]);
    }
    wgmma_wait<0>();
  }
  fence_regs(acc1);
  if constexpr (N2 > 0) fence_regs(acc2);

  // acc[4j + {0, 1}] are row r, acc[4j + {2, 3}] row r + 8, columns 8j + cq + {0, 1}
  if constexpr (MODE == LN_AFTER) {
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int i = 0; i < N1 / 2; ++i) {
      acc1[i] = __bfloat162float(__float2bfloat16(acc1[i]));
      if (i & 2) s1 += acc1[i];
      else s0 += acc1[i];
    }
#pragma unroll
    for (int i = 0; i < N2 / 2; ++i) {
      acc2[i] = __bfloat162float(__float2bfloat16(acc2[i]));
      if (i & 2) s1 += acc2[i];
      else s0 += acc2[i];
    }
    const int n = col_tiles * BN;
    cluster_row_total<BM, !ROWSPLIT>(s0, s1, r, red, stats, rank, cl);
    const float m0 = s0 / n, m1 = s1 / n;
    float v0 = 0.f, v1 = 0.f;
#pragma unroll
    for (int i = 0; i < N1 / 2; ++i) {
      if (i & 2) v1 += (acc1[i] - m1) * (acc1[i] - m1);
      else v0 += (acc1[i] - m0) * (acc1[i] - m0);
    }
#pragma unroll
    for (int i = 0; i < N2 / 2; ++i) {
      if (i & 2) v1 += (acc2[i] - m1) * (acc2[i] - m1);
      else v0 += (acc2[i] - m0) * (acc2[i] - m0);
    }
    cluster_row_total<BM, !ROWSPLIT>(v0, v1, r, red, stats + MAX_CLUSTER * BM, rank, cl);
    const float rs0 = rsqrtf(v0 / n + eps), rs1 = rsqrtf(v1 / n + eps);
    const float* gn = gain + bcol + cq;
#pragma unroll
    for (int j = 0; j < N1 / 8; ++j) {
      const float2 gv = *reinterpret_cast<const float2*>(gn + 8 * j);
      acc1[4 * j] = (acc1[4 * j] - m0) * rs0 * gv.x;
      acc1[4 * j + 1] = (acc1[4 * j + 1] - m0) * rs0 * gv.y;
      acc1[4 * j + 2] = (acc1[4 * j + 2] - m1) * rs1 * gv.x;
      acc1[4 * j + 3] = (acc1[4 * j + 3] - m1) * rs1 * gv.y;
    }
#pragma unroll
    for (int j = 0; j < N2 / 8; ++j) {
      const float2 gv = *reinterpret_cast<const float2*>(gn + N1 + 8 * j);
      acc2[4 * j] = (acc2[4 * j] - m0) * rs0 * gv.x;
      acc2[4 * j + 1] = (acc2[4 * j + 1] - m0) * rs0 * gv.y;
      acc2[4 * j + 2] = (acc2[4 * j + 2] - m1) * rs1 * gv.x;
      acc2[4 * j + 3] = (acc2[4 * j + 3] - m1) * rs1 * gv.y;
    }
  }

  // the bf16 tile over the ring (both warpgroups are past their last stage),
  // then one TMA store a 64-column box
  named_sync(1, CONSUMERS);
  auto put = [&](int col, float d0, float d1, float d2, float d3) {
    const int byte = (col % 8) * 2;
    *reinterpret_cast<__nv_bfloat162*>(smem + tile_offset<128, BM>(r, col / 8) + byte) =
        __floats2bfloat162_rn(d0, d1);
    *reinterpret_cast<__nv_bfloat162*>(smem + tile_offset<128, BM>(r + 8, col / 8) + byte) =
        __floats2bfloat162_rn(d2, d3);
  };
#pragma unroll
  for (int j = 0; j < N1 / 8; ++j)
    put(bcol + 8 * j + cq, acc1[4 * j], acc1[4 * j + 1], acc1[4 * j + 2], acc1[4 * j + 3]);
#pragma unroll
  for (int j = 0; j < N2 / 8; ++j)
    put(bcol + N1 + 8 * j + cq, acc2[4 * j], acc2[4 * j + 1], acc2[4 * j + 2], acc2[4 * j + 3]);
  fence_proxy_async();
  named_sync(1, CONSUMERS);
  if (ct == 0) {
    for (int b = 0; b < BN / 64; ++b)
      tma_store_2d(&tm_y, sbase + b * BM * 128, col0 + b * 64, row0);
    tma_store_commit();
    tma_store_wait();
  }
}

__global__ void __launch_bounds__(256)
fused_ln_matmul_rownorm_kernel(__nv_bfloat16* y, const float* __restrict__ g, int rows, int n,
                               float eps) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  if (row < rows) row_layernorm(y, g, y, row, n, eps, threadIdx.x % 32);
}

// ---- the tiling (ops/fused_norm.py `lnmm_tiles` mirrors it) ------------------------------

struct Plan {
  int staged, bm, wn, col_tiles, cl, stages, grid, smem;
};

// (BM, WN) of the instantiated kernels, by mode
constexpr int LN_FIRST_TILES[][2] = {{128, 128}, {128, 256}, {128, 320}, {64, 64}, {64, 128}};
constexpr int LN_AFTER_TILES[][2] = {{128, 128}, {128, 192}, {128, 256}, {128, 320},
                                     {64, 128},  {64, 192},  {64, 256},  {64, 320}};
constexpr int STAGED_TILE[2] = {128, 128};

// As many stages as fit (at most MAX_STAGES), at least 2 and enough to hold
// the output tile; 0 if none fits.
int stages_for(int bm, int bn) {
  int best = 0;
  for (int s = 2; s <= MAX_STAGES; ++s) {
    const Layout L = layout(bm, bn, s);
    if (L.total <= MAX_SMEM && bm * bn * 2 <= s * L.stage) best = s;
  }
  return best;
}

Plan fill(int staged, int bm, int wn, int rows, int n, int cl) {
  const int bn = bm == 128 ? wn : 2 * wn;
  Plan p;
  p.staged = staged, p.bm = bm, p.wn = wn, p.col_tiles = n / bn, p.cl = cl;
  p.stages = stages_for(bm, bn);
  p.grid = (rows + bm - 1) / bm * p.col_tiles;
  p.smem = layout(bm, bn, p.stages).total;
  return p;
}

// The tile of the fewest waves, a block costed by the larger of its products
// (BM BN / 2048 a K column, at 2048 bf16 FMAs a clock on an SM) and its loads
// (2 (BM + BN) bytes a K column at 48 bytes a clock from L2), plus, for
// LN -> matmul, its share of the statistics (two passes over BM / cl rows),
// all times 6144 to stay in integers; the first of equal costs.
Plan plan(bool ln_first, int rows, int n, int sms) {
  const int(*tiles)[2] = ln_first ? LN_FIRST_TILES : LN_AFTER_TILES;
  const int count = ln_first ? 5 : 8;
  Plan best{};
  long long best_cost = -1;
  for (int i = 0; i < count; ++i) {
    const int bm = tiles[i][0], wn = tiles[i][1], bn = bm == 128 ? wn : 2 * wn;
    if (n % bn != 0) continue;
    const int col_tiles = n / bn;
    int cl = 1;
    if (ln_first) {
      while (cl < MAX_CLUSTER && col_tiles % (2 * cl) == 0) cl *= 2;
    } else {
      if (col_tiles > MAX_CLUSTER || (col_tiles & (col_tiles - 1)) != 0) continue;
      cl = col_tiles;
    }
    if (stages_for(bm, bn) == 0) continue;
    const long long blocks = (long long)(rows + bm - 1) / bm * col_tiles;
    const long long waves = (blocks + sms - 1) / sms;
    const long long products = 3LL * bm * bn, loads = 256LL * (bm + bn);
    const long long cost =
        waves * ((products > loads ? products : loads) + (ln_first ? 512LL * bm / cl : 0));
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = fill(0, bm, wn, rows, n, cl);
    }
  }
  if (best_cost < 0) best = fill(1, STAGED_TILE[0], STAGED_TILE[1], rows, n, 1);
  return best;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

template <int MODE, int BM, int N1, int N2>
cudaError_t run(const Plan& p, const void* x, const void* g, const void* w, void* y, int rows,
                int k, int n, float eps, cudaStream_t stream) {
  CUtensorMap tm_x, tm_w, tm_y;
  const auto l2 = CU_TENSOR_MAP_L2_PROMOTION_L2_256B;
  if (!matrix_map(&tm_x, x, k, rows, 64, BM, CU_TENSOR_MAP_SWIZZLE_128B, l2) ||
      !matrix_map(&tm_w, w, k, n, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B, l2) ||
      !matrix_map(&tm_y, y, n, rows, 64, BM, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_NONE))
    return cudaErrorInvalidValue;
  auto kernel = fused_ln_matmul_kernel<MODE, BM, N1, N2>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tm_x, tm_w, tm_y, static_cast<const __nv_bfloat16*>(x),
                           static_cast<const float*>(g), rows, k, p.col_tiles, p.cl, p.stages,
                           eps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

#define TILE_CASE(MODE, BM, WN, N1, N2) \
  if (p.bm == BM && p.wn == WN) return run<MODE, BM, N1, N2>(p, x, g, w, y, rows, k, n, eps, s)

cudaError_t launch(bool ln_first, const void* x, const void* g, const void* w, void* y, int rows,
                   int k, int n, float eps, void* stream) {
  if (rows < 1 || k < KC || k % KC || n < 128 || n % 128) return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  const Plan p = plan(ln_first, rows, n, sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ln_first) {
    TILE_CASE(LN_FIRST, 128, 128, 128, 0);
    TILE_CASE(LN_FIRST, 128, 256, 256, 0);
    TILE_CASE(LN_FIRST, 128, 320, 256, 64);
    TILE_CASE(LN_FIRST, 64, 64, 64, 0);
    TILE_CASE(LN_FIRST, 64, 128, 128, 0);
  } else if (!p.staged) {
    TILE_CASE(LN_AFTER, 128, 128, 128, 0);
    TILE_CASE(LN_AFTER, 128, 192, 192, 0);
    TILE_CASE(LN_AFTER, 128, 256, 256, 0);
    TILE_CASE(LN_AFTER, 128, 320, 256, 64);
    TILE_CASE(LN_AFTER, 64, 128, 128, 0);
    TILE_CASE(LN_AFTER, 64, 192, 192, 0);
    TILE_CASE(LN_AFTER, 64, 256, 256, 0);
    TILE_CASE(LN_AFTER, 64, 320, 256, 64);
  } else {
    cudaError_t err = run<PLAIN, 128, 128, 0>(p, x, g, w, y, rows, k, n, eps, s);
    if (err != cudaSuccess) return err;
    fused_ln_matmul_rownorm_kernel<<<(rows + 7) / 8, 256, 0, s>>>(
        static_cast<__nv_bfloat16*>(y), static_cast<const float*>(g), rows, n, eps);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

#undef TILE_CASE

}  // namespace

// x (rows, k) bf16, g (k,) fp32, w (n, k) bf16, y (rows, n) bf16, all
// contiguous and 16-byte aligned; k % 64 == 0, n % 128 == 0.
extern "C" int fused_ln_matmul_bf16(const void* x, const void* g, const void* w, void* y, int rows,
                                    int k, int n, float eps, void* stream) {
  return (int)launch(true, x, g, w, y, rows, k, n, eps, stream);
}

// x (rows, k) bf16, w (n, k) bf16, g (n,) fp32, y (rows, n) bf16, as above.
extern "C" int fused_matmul_ln_bf16(const void* x, const void* w, const void* g, void* y, int rows,
                                    int k, int n, float eps, void* stream) {
  return (int)launch(false, x, g, w, y, rows, k, n, eps, stream);
}

// The tiling either entry takes for (rows, k, n) on a card of `sms` SMs, as
// 8 ints: staged, BM, WN, column tiles, cluster, stages, grid, shared memory
// bytes (for the tests, which hold `lnmm_tiles` to it).
extern "C" int fused_ln_matmul_plan(int ln_first, int rows, int k, int n, int sms, int* out) {
  if (rows < 1 || k < KC || k % KC || n < 128 || n % 128 || sms < 1) return 1;
  const Plan p = plan(ln_first != 0, rows, n, sms);
  const int v[8] = {p.staged, p.bm, p.wn, p.col_tiles, p.cl, p.stages, p.grid, p.smem};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}
