// Fused transformer feedforward, bf16, for sm_90a: wgmma products fed by TMA,
// the hidden row split over a thread block cluster.
//   out = LN1(gelu(LN0(x) @ W0^T)) @ W1^T        (bias-free LayerNorms, no biases)
//
// Replaces `fused_feedforward` -> `_ff_forward` -> `_ff_kernel` of
// imagen_tpu/ops/fused_norm.py. Rounding follows `_ff_kernel`: LayerNorm
// statistics in fp32 in two passes (the mean, then the centred variance), each
// product's input rounded to bf16, products accumulated in fp32, the first
// product rounded to bf16 before the exact erf GELU, the GELU output rounded to
// bf16 before LN1, the output rounded to bf16 once. CUDA has erff, so the GELU
// is exact rather than the Pallas kernel's A&S polynomial.
//
// x and out are (rows, k); W0 is the torch Linear weight (hid, k) and W1 is
// (k, hid), bf16, as the module stores them (both K-major for wgmma's B
// operand as they lie); the gains g0 (k,) and g1 (hid,) are fp32.
//
// What bounds it on the H100: 4 k hid flops a row. At the paths' sites,
// (8192, 512, 1024) does 17.2 GFLOP against 19 MB (0.017 ms at the dense
// bf16 peak: the tensor cores bound it); the Perceiver's (b 36, 512, 2048)
// and (b 36, 128, 512) are a few rows against 4 MB and 0.25 MB of weights
// (the bytes bound them, 1.4 us and less), so there only latency and the
// spread over SMs count. Next after the tensor cores comes the traffic from L2
// into the SMs: every 64-row block reads both weights whole, 2 k hid bytes.
//
// Design.
// - A cluster of `cl` blocks (1, 2, 4 or 8; `ops/fused_norm.ff_tiles` picks
//   it) shares 64 rows; block `rank` owns the hidden columns [rank HS, (rank +
//   1) HS), HS = hid / cl (128, 256 or 512). A block is a producer warpgroup,
//   which gives its registers up (setmaxnreg), and two consumer warpgroups.
// - One TMA load per 64 columns brings the x tile (128-byte swizzle; rows past
//   `rows` arrive as zeros); the consumers take LN0 in place, 8 threads a row,
//   each on its own 16 bytes of every 128-byte row block (no bank conflicts).
// - The producer streams the weights by TMA through an mbarrier ring of 32-K
//   stages (64-byte swizzle): first W0's HS rows, then, for the second
//   product, all k rows of W1's block columns. W0 and W1 need no repack: each
//   is K-major as stored.
// - Product 1, wgmma m64nHS/2k16: warpgroup w computes hidden columns w HS/2 ..
//   of its block; bf16 round, GELU, bf16 round, in registers.
// - LN1's row statistics over the whole hidden row: each block sums its
//   columns (two warpgroups, then a fixed order), writes the partial into
//   every block of the cluster through distributed shared memory, and after a
//   cluster barrier each block sums the cl partials in rank order: the mean,
//   then the same for the centred squares. The normalised slice goes to
//   shared memory as bf16, the A operand of product 2, over the x tile, which
//   product 1 no longer reads: so a 512-column slice fits beside a 4-stage
//   ring (128 KB in flight).
// - Product 2, wgmma m64n(k/2)k16: warpgroup w computes output columns w k/2 ..
//   over the block's HS hidden columns, a partial sum in fp32 registers (128 a
//   thread at k = 512).
// - The partials are reduced across the cluster and scattered: block j owns
//   output columns [j k / cl, (j + 1) k / cl). After a cluster barrier (every
//   block's products done, so its hidden slice and ring are free), each
//   thread writes the float4s of each block's columns into that block's
//   shared memory (its own by a local store); after another, each owner's 256
//   consumer threads sum the cl partials in rank order, round once and stage
//   its columns, which one TMA store a 64-column box writes, clipping the
//   ragged last rows. The order is fixed, so a result is bitwise the same
//   from run to run.
// What was weighed: one block holding a whole 64-row hidden tile takes 128 KB
// at hid 1024 and 256 KB at hid 2048 beside 64 KB of x, past shared memory,
// and gives 5 blocks at 288 rows; the split puts up to 40 blocks on that
// shape. Gathering the normalised hidden slices (all-gather, 2 hid bytes a
// row) in place of scattering fp32 partials (4 k bytes a row) moves fewer
// bytes at hid 1024 but needs either the whole hidden row in every block's
// shared memory or the register A form fed by remote loads. Timed on the
// card in development: separate x and hidden regions with 256-column slices
// (4 blocks a cluster at hid 1024) and a 3-stage ring lost to the layout
// above by 2.5x at (8192, 512, 1024); the products there waited on the
// ring, and the work outside them (LN0, GELU, the statistics, the scatter)
// repeats in every block of a cluster, so fewer, wider blocks and a deeper
// ring won. Summing the partials in the registers of the owner's
// warpgroup, half the block idle, lost to the 256-thread loop below; GELU
// as a called function, not inlined, lost too.
//
// The staged route. The cluster kernel holds a 64-row x tile whole and
// product 2's k / 2 columns in a warpgroup's registers, so it takes k up to
// 512 and hid = 128, 256 or 512 times 1, 2, 4 or 8 blocks. Every other shape
// the gate admits (k and hid multiples of 128, 2 k hid <= 2M weights: (384,
// 768) at ff_mult 2 of a 384-wide stage, (1024, 1024), (128, 8192), ...)
// takes four launches with the same roundings: a row LayerNorm writes LN0(x)
// as bf16; a wgmma product fed by a TMA ring writes gelu of its bf16
// rounding as H; LN1 normalises H in place; the second product writes out.
// H goes through global memory (L2 at these sizes), 4 hid bytes a row more
// than the cluster kernel moves. No site of the presets takes this route.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 64;              // rows of a block: one m64 block
constexpr int THREADS = 384;        // two consumer warpgroups and a producer warpgroup
constexpr int CONSUMERS = 256;
constexpr int KC = 32;              // K of a weight stage: 64-byte rows, 64-byte swizzle
constexpr int MAX_CLUSTER = 8;
constexpr int MAX_SMEM = 232448;    // shared memory a block may use on the H100

// Shared memory, every region on a 1024-byte boundary (ops/fused_norm.py
// `ff_smem` computes the same): the x tile, which the normalised hidden slice
// takes over once product 1 has read it; the weight ring; the row statistics
// ([2 passes][8 ranks][64 rows] partials and [2 warpgroups][64 rows] sums);
// the mbarriers; 1024 bytes of alignment slack. After product 2 the first two
// regions hold the partials of the cluster's blocks ([cl][k / cl / 8 n8
// blocks][128 threads] float4, k 256 bytes), then the output staging.
struct Layout {
  int ring, stats, red, bars, stage, total;
};

__host__ __device__ inline Layout layout(int k, int hs, int stages) {
  Layout L;
  const int wide = hs > k ? hs : k;
  L.stage = wide * KC * 2;
  L.ring = BM * wide * 2;
  L.stats = L.ring + stages * L.stage;
  L.red = L.stats + 2 * MAX_CLUSTER * BM * 4;
  L.bars = L.red + 2 * BM * 4;
  L.total = L.bars + 8 * (2 * stages + 1) + 1024;
  return L;
}

// K-major operands: k16 step at column `col` of a tile of 64-column blocks in
// the 128-byte swizzle (x and the hidden slice, A), and k16 step `ks` of a
// 32-column stage in the 64-byte swizzle (the weights, B).
__device__ __forceinline__ uint64_t desc_a(uint32_t tile, int col) {
  return make_desc(tile + (col / 64) * BM * 128 + (col % 64) * 2, 16, 1024, 1);
}
__device__ __forceinline__ uint64_t desc_b(uint32_t stage, int ks) {
  return make_desc(stage + ks * 32, 16, 512, 2);
}

__device__ __forceinline__ float gelu_bf16(float acc) {
  const float h = __bfloat162float(__float2bfloat16(acc));
  return __bfloat162float(__float2bfloat16(0.5f * h * (1.f + erff(h * 0.70710678118654752f))));
}

template <int N1, int N2>
__global__ void __launch_bounds__(THREADS, 1)
fused_feedforward_kernel(const __grid_constant__ CUtensorMap tm_x,
                         const __grid_constant__ CUtensorMap tm_w0,
                         const __grid_constant__ CUtensorMap tm_w1,
                         const __grid_constant__ CUtensorMap tm_out,
                         const float* __restrict__ g0, const float* __restrict__ g1, int hid,
                         int stages, float eps) {
  constexpr int K = 2 * N2;          // the model width k
  constexpr int HS = 2 * N1;         // hidden columns of a block
  constexpr int ITEMS1 = K / KC;     // weight stages of product 1
  constexpr int ITEMS2 = HS / KC;    // and of product 2
  const Layout L = layout(K, HS, stages);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_1024(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + stages;
  uint64_t* x_full = empty + stages;
  float* stats = reinterpret_cast<float*>(smem + L.stats);
  float* red = reinterpret_cast<float*>(smem + L.red);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cl = hid / HS;
  const int rank = (int)cluster_rank();
  const int row0 = (blockIdx.x / cl) * BM;
  const int hs0 = rank * HS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init(x_full, 1);
    mbar_fence_init();
  }
  // every block of the cluster runs, its barriers set up, before any block
  // writes another's shared memory
  cluster_sync();

  if (warp >= 8) {  // the producer warpgroup: one thread issues every load
    setmaxnreg_dec<40>();
    const bool issuer = warp == 8 && lane == 0;
    auto load = [&](int it) {
      const int s = it % stages;
      if (it >= stages) mbar_wait(&empty[s], (it / stages - 1) & 1);
      const uint32_t dst = sbase + L.ring + s * L.stage;
      if (it < ITEMS1) {
        mbar_expect_tx(&full[s], HS * KC * 2);
        tma_load_2d(dst, &tm_w0, &full[s], it * KC, hs0);
        tma_load_2d(dst + N1 * KC * 2, &tm_w0, &full[s], it * KC, hs0 + N1);
      } else {
        const int c = hs0 + (it - ITEMS1) * KC;
        mbar_expect_tx(&full[s], K * KC * 2);
        tma_load_2d(dst, &tm_w1, &full[s], c, 0);
        tma_load_2d(dst + N2 * KC * 2, &tm_w1, &full[s], c, N2);
      }
    };
    // The cluster barriers come in the consumers' order: the statistics' two
    // (arrived at once: these loads wait on nothing but this block), then the
    // products' end and the partials'. Stages past the ring's depth into
    // product 2 wait on consumers that are past the statistics.
    cluster_arrive();
    int it = 0;
    if (issuer) {
      mbar_expect_tx(x_full, BM * K * 2);
      for (int b = 0; b < K / 64; ++b)
        tma_load_2d(sbase + b * BM * 128, &tm_x, x_full, b * 64, row0);
      const int first = ITEMS1 + (stages < ITEMS2 ? stages : ITEMS2);
      for (; it < first; ++it) load(it);
    }
    __syncwarp();
    cluster_wait();
    cluster_sync();
    if (issuer)
      for (; it < ITEMS1 + ITEMS2; ++it) load(it);
    __syncwarp();
    cluster_sync();
    cluster_sync();
    return;
  }

  setmaxnreg_inc<232>();
  const int wg = warp / 4, tid = threadIdx.x % 128, ct = threadIdx.x;
  const int r = (warp % 4) * 16 + lane / 4;  // this thread's accumulator rows: r, r + 8
  const int cq = 2 * (lane % 4);             // its first column of each n8 block

  // LN0 of the x tile in place: 8 threads a row, each a 16-byte chunk of every
  // 128-byte row block (8 chunks of one swizzled row: no bank conflicts)
  mbar_wait(x_full, 0);
  const int part = ct % 8;
  for (int row = ct / 8; row < BM; row += CONSUMERS / 8) {
    float s = 0.f;
#pragma unroll
    for (int c = part; c < K / 8; c += 8) {
      const uint4 v = *reinterpret_cast<const uint4*>(smem + tile_offset<128, BM>(row, c));
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(p[e]);
        s += f.x + f.y;
      }
    }
#pragma unroll
    for (int o = 1; o < 8; o *= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mean = s / K;
    float q = 0.f;
#pragma unroll
    for (int c = part; c < K / 8; c += 8) {
      const uint4 v = *reinterpret_cast<const uint4*>(smem + tile_offset<128, BM>(row, c));
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(p[e]);
        q += (f.x - mean) * (f.x - mean) + (f.y - mean) * (f.y - mean);
      }
    }
#pragma unroll
    for (int o = 1; o < 8; o *= 2) q += __shfl_xor_sync(0xffffffffu, q, o);
    const float rstd = rsqrtf(q / K + eps);
#pragma unroll
    for (int c = part; c < K / 8; c += 8) {
      uint4* at = reinterpret_cast<uint4*>(smem + tile_offset<128, BM>(row, c));
      uint4 v = *at;
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
      const float4 ga = *reinterpret_cast<const float4*>(g0 + c * 8);
      const float4 gb = *reinterpret_cast<const float4*>(g0 + c * 8 + 4);
      const float gs[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(p[e]);
        p[e] = __floats2bfloat162_rn((f.x - mean) * rstd * gs[2 * e],
                                     (f.y - mean) * rstd * gs[2 * e + 1]);
      }
      *at = v;
    }
  }
  fence_proxy_async();
  named_sync(1, CONSUMERS);

  // product 1: hidden columns wg N1 .. of this block's slice
  float acc1[N1 / 2];
  for (int it = 0; it < ITEMS1; ++it) {
    const int s = it % stages;
    mbar_wait(&full[s], (it / stages) & 1);
    const uint32_t wt = sbase + L.ring + s * L.stage + wg * N1 * KC * 2;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks)
      wgmma_ss<N1, 0>(acc1, desc_a(sbase, it * KC + ks * 16), desc_b(wt, ks), (it | ks) != 0);
    wgmma_commit();
    wgmma_wait<1>();  // the stage before is read: free it
    __syncwarp();
    if (lane == 0 && it > 0) mbar_arrive(&empty[(it - 1) % stages]);
  }
  wgmma_wait<0>();
  fence_regs(acc1);
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[(ITEMS1 - 1) % stages]);

  // gelu(bf16(h)) rounded to bf16, kept in acc1; d[4j + {0, 1}] are row r,
  // d[4j + {2, 3}] row r + 8
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int i = 0; i < N1 / 2; ++i) {
    acc1[i] = gelu_bf16(acc1[i]);
    if (i & 2) s1 += acc1[i];
    else s0 += acc1[i];
  }

  // A row statistic over the whole hidden row: this thread's sums (rows r, r
  // + 8) over its columns -> the warpgroup's -> the block's (warpgroup 0, then
  // 1) -> into every block's `stats[pass][rank]` -> summed in rank order.
  auto row_total = [&](int pass, float& a, float& b) {
    a += __shfl_xor_sync(0xffffffffu, a, 1);
    a += __shfl_xor_sync(0xffffffffu, a, 2);
    b += __shfl_xor_sync(0xffffffffu, b, 1);
    b += __shfl_xor_sync(0xffffffffu, b, 2);
    if (lane % 4 == 0) {
      red[wg * BM + r] = a;
      red[wg * BM + r + 8] = b;
    }
    named_sync(1, CONSUMERS);
    if (ct < BM) {
      const float part = red[ct] + red[BM + ct];
      const uint32_t at = smem_u32(stats + (pass * MAX_CLUSTER + rank) * BM + ct);
      for (int dst = 0; dst < cl; ++dst) st_cluster(map_rank(at, dst), part);
    }
    cluster_sync();  // every block's partials are in
    const float* col = stats + pass * MAX_CLUSTER * BM;
    a = col[r];
    b = col[r + 8];
    for (int src = 1; src < cl; ++src) {
      a += col[src * BM + r];
      b += col[src * BM + r + 8];
    }
  };
  row_total(0, s0, s1);
  const float m0 = s0 / hid, m1 = s1 / hid;
  float v0 = 0.f, v1 = 0.f;
#pragma unroll
  for (int i = 0; i < N1 / 2; ++i) {
    if (i & 2) v1 += (acc1[i] - m1) * (acc1[i] - m1);
    else v0 += (acc1[i] - m0) * (acc1[i] - m0);
  }
  row_total(1, v0, v1);
  const float rs0 = rsqrtf(v0 / hid + eps), rs1 = rsqrtf(v1 / hid + eps);

  // the normalised slice, bf16, the A operand of product 2, over the x tile:
  // both warpgroups are past product 1 (the statistics' barriers)
#pragma unroll
  for (int j = 0; j < N1 / 8; ++j) {
    const int col = wg * N1 + 8 * j + cq;
    const float2 g = *reinterpret_cast<const float2*>(g1 + hs0 + col);
    const int byte = (col % 8) * 2;
    *reinterpret_cast<__nv_bfloat162*>(smem + tile_offset<128, BM>(r, col / 8) + byte) =
        __floats2bfloat162_rn((acc1[4 * j] - m0) * rs0 * g.x, (acc1[4 * j + 1] - m0) * rs0 * g.y);
    *reinterpret_cast<__nv_bfloat162*>(smem + tile_offset<128, BM>(r + 8, col / 8) + byte) =
        __floats2bfloat162_rn((acc1[4 * j + 2] - m1) * rs1 * g.x,
                              (acc1[4 * j + 3] - m1) * rs1 * g.y);
  }
  fence_proxy_async();
  named_sync(1, CONSUMERS);

  // product 2: output columns wg N2 .., over this block's hidden columns
  float acc2[N2 / 2];
  for (int i = 0; i < ITEMS2; ++i) {
    const int it = ITEMS1 + i, s = it % stages;
    mbar_wait(&full[s], (it / stages) & 1);
    const uint32_t wt = sbase + L.ring + s * L.stage + wg * N2 * KC * 2;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks)
      wgmma_ss<N2, 0>(acc2, desc_a(sbase, i * KC + ks * 16), desc_b(wt, ks), (i | ks) != 0);
    wgmma_commit();
    wgmma_wait<1>();
    __syncwarp();
    if (lane == 0 && i > 0) mbar_arrive(&empty[(it - 1) % stages]);
  }
  wgmma_wait<0>();
  fence_regs(acc2);
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[(ITEMS1 + ITEMS2 - 1) % stages]);

  // the partials: block j owns output columns [j oc, (j + 1) oc). Each
  // thread writes the float4 of each n8 block of its accumulator into the
  // owner's slot `rank` (its own block's by a local store): slots [cl][ob n8
  // blocks][128 threads] float4 over the hidden slice and the ring
  const int oc = K / cl, ob = oc / 8;
  cluster_sync();  // every block's products are done: its hidden slice and ring are free
#pragma unroll
  for (int j = 0; j < N2 / 8; ++j) {
    const int J = wg * (N2 / 8) + j;
    const uint32_t at = sbase + ((rank * ob + J % ob) * 128 + tid) * 16;
    st_cluster_v4(map_rank(at, J / ob), acc2[4 * j], acc2[4 * j + 1], acc2[4 * j + 2],
                  acc2[4 * j + 3]);
  }
  cluster_sync();  // every partial is in

  // The owner's sums, slot by slot in rank order (the same in every run),
  // one rounding, into the output staging past the slots; every consumer
  // thread takes entries. Entry (jl, t) of a slot is thread t's float4 of n8
  // block jl: rows 16 (t / 32) + (t % 32) / 4 and + 8, columns 8 jl + 2 (t %
  // 4) + {0, 1}.
  const int out_off = K * 256;
  for (int e = ct; e < ob * 128; e += CONSUMERS) {
    const int jl = e / 128, t = e % 128;
    float4 sum = *reinterpret_cast<const float4*>(smem + e * 16);
    for (int src = 1; src < cl; ++src) {
      const float4 p = *reinterpret_cast<const float4*>(smem + (src * ob * 128 + e) * 16);
      sum.x += p.x, sum.y += p.y, sum.z += p.z, sum.w += p.w;
    }
    const int row = (t / 32) * 16 + (t % 32) / 4, col = jl * 8 + 2 * (t % 4);
    const int byte = (col % 8) * 2;
    *reinterpret_cast<__nv_bfloat162*>(smem + out_off + tile_offset<128, BM>(row, col / 8) +
                                       byte) = __floats2bfloat162_rn(sum.x, sum.y);
    *reinterpret_cast<__nv_bfloat162*>(smem + out_off + tile_offset<128, BM>(row + 8, col / 8) +
                                       byte) = __floats2bfloat162_rn(sum.z, sum.w);
  }
  fence_proxy_async();
  named_sync(1, CONSUMERS);
  if (ct == 0) {
    for (int b = 0; b < oc / 64; ++b)
      tma_store_2d(&tm_out, sbase + out_off + b * BM * 128, rank * oc + b * 64, row0);
    tma_store_commit();
    tma_store_wait();
  }
}

// ---- the staged route: any k and hid that are multiples of 128 ---------------------------
// LN0 of x into xn; H = gelu(xn W0^T) through global memory (L2 at these
// sizes); LN1 of H in place; out = H W1^T. Four launches, the same roundings.
constexpr int GM = 128, GN = 128, GK = 64;  // a product's block tile; K stages of 64 columns
constexpr int GSTAGES = 4;
constexpr int GSTAGE = (GM + GN) * GK * 2;  // an A and a B stage, each in the 128-byte swizzle
constexpr int GSMEM = GSTAGES * GSTAGE + 16 * GSTAGES + 1024;

// A bias-free LayerNorm of each row of c columns, a warp a row, as LN0 and
// LN1 above take it; `out` may be `in`.
__global__ void __launch_bounds__(256)
fused_feedforward_rownorm_kernel(const __nv_bfloat16* in, const float* __restrict__ g,
                                 __nv_bfloat16* out, int rows, int c, float eps) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const uint4* src = reinterpret_cast<const uint4*>(in + (size_t)row * c);
  uint4* dst = reinterpret_cast<uint4*>(out + (size_t)row * c);
  float s = 0.f;
  for (int i = lane; i < c / 8; i += 32) {
    const uint4 v = src[i];
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(p[e]);
      s += f.x + f.y;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float mean = s / c;
  float q = 0.f;
  for (int i = lane; i < c / 8; i += 32) {
    const uint4 v = src[i];
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(p[e]);
      q += (f.x - mean) * (f.x - mean) + (f.y - mean) * (f.y - mean);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) q += __shfl_xor_sync(0xffffffffu, q, o);
  const float rstd = rsqrtf(q / c + eps);
  for (int i = lane; i < c / 8; i += 32) {
    uint4 v = src[i];
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
    const float4 ga = *reinterpret_cast<const float4*>(g + i * 8);
    const float4 gb = *reinterpret_cast<const float4*>(g + i * 8 + 4);
    const float gs[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(p[e]);
      p[e] = __floats2bfloat162_rn((f.x - mean) * rstd * gs[2 * e],
                                   (f.y - mean) * rstd * gs[2 * e + 1]);
    }
    dst[i] = v;
  }
}

// out (m, n) = a (m, kd) b (n, kd)^T, both K-major, rounded to bf16 once (GELU:
// rounded, the exact GELU, rounded again). A block is a producer warpgroup
// streaming 128 x 64 tiles of a and b by TMA through a GSTAGES ring (rows
// past m arrive as zeros) and two consumer warpgroups, each 64 rows x 128
// columns of wgmma m64n128k16; the accumulators go straight to global memory,
// rows past m not written.
template <bool GELU>
__global__ void __launch_bounds__(THREADS, 1)
fused_feedforward_gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                              const __grid_constant__ CUtensorMap tm_b,
                              __nv_bfloat16* __restrict__ out, int m, int n, int kd) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_1024(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + GSTAGES * GSTAGE);
  uint64_t* empty = full + GSTAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * GN, m0 = blockIdx.y * GM, iters = kd / GK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < GSTAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {
    setmaxnreg_dec<40>();
    if (warp == 8 && lane == 0)
      for (int it = 0; it < iters; ++it) {
        const int s = it % GSTAGES;
        if (it >= GSTAGES) mbar_wait(&empty[s], (it / GSTAGES - 1) & 1);
        const uint32_t dst = sbase + s * GSTAGE;
        mbar_expect_tx(&full[s], GSTAGE);
        tma_load_2d(dst, &tm_a, &full[s], it * GK, m0);
        tma_load_2d(dst + GM * GK * 2, &tm_b, &full[s], it * GK, n0);
      }
    return;
  }

  setmaxnreg_inc<232>();
  const int wg = warp / 4;
  float acc[GN / 2];
  for (int it = 0; it < iters; ++it) {
    const int s = it % GSTAGES;
    mbar_wait(&full[s], (it / GSTAGES) & 1);
    const uint32_t a = sbase + s * GSTAGE, b = a + GM * GK * 2;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < GK / 16; ++ks)
      wgmma_ss<GN, 0>(acc, desc_k<GK, GM>(a, wg * 64, ks), desc_k<GK, GN>(b, 0, ks),
                      (it | ks) != 0);
    wgmma_commit();
    wgmma_wait<1>();  // the stage before is read: free it
    __syncwarp();
    if (lane == 0 && it > 0) mbar_arrive(&empty[(it - 1) % GSTAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const int r = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  __nv_bfloat16* o = out + (size_t)r * n + n0 + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < GN / 8; ++j) {
    float v[4] = {acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]};
    if (GELU)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = gelu_bf16(v[e]);
    if (r < m)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) = __floats2bfloat162_rn(v[0], v[1]);
    if (r + 8 < m)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * (size_t)n + 8 * j) =
          __floats2bfloat162_rn(v[2], v[3]);
  }
}

// A contiguous bf16 (outer, inner) matrix as TMA boxes of box_inner x box_outer.
inline bool matrix_map(CUtensorMap* map, const void* base, int inner, int outer, int box_inner,
                       int box_outer, CUtensorMapSwizzle swizzle, CUtensorMapL2promotion l2) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  return encode_cached(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, dims, strides, box,
                       swizzle, l2);
}

template <int N1, int N2>
cudaError_t launch(const void* x, const void* g0, const void* w0, const void* g1, const void* w1,
                   void* out, int rows, int hid, float eps, int cl, int stages,
                   cudaStream_t stream) {
  constexpr int K = 2 * N2, HS = 2 * N1;
  const Layout L = layout(K, HS, stages);
  // the partials and the output staging fit in the x tile and the ring
  if (L.total > MAX_SMEM || K * 256 + BM * (K / cl) * 2 > L.stats)
    return cudaErrorInvalidValue;
  CUtensorMap tm_x, tm_w0, tm_w1, tm_out;
  const auto l2 = CU_TENSOR_MAP_L2_PROMOTION_L2_256B;
  if (!matrix_map(&tm_x, x, K, rows, 64, BM, CU_TENSOR_MAP_SWIZZLE_128B, l2) ||
      !matrix_map(&tm_w0, w0, K, hid, KC, N1, CU_TENSOR_MAP_SWIZZLE_64B, l2) ||
      !matrix_map(&tm_w1, w1, hid, K, KC, N2, CU_TENSOR_MAP_SWIZZLE_64B, l2) ||
      !matrix_map(&tm_out, out, K, rows, 64, BM, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_NONE))
    return cudaErrorInvalidValue;
  auto kernel = fused_feedforward_kernel<N1, N2>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((rows + BM - 1) / BM * cl));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tm_x, tm_w0, tm_w1, tm_out,
                           static_cast<const float*>(g0), static_cast<const float*>(g1), hid,
                           stages, eps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int N1>
cudaError_t launch_k(int k, const void* x, const void* g0, const void* w0, const void* g1,
                     const void* w1, void* out, int rows, int hid, float eps, int cl, int stages,
                     cudaStream_t s) {
  switch (k) {
    case 128: return launch<N1, 64>(x, g0, w0, g1, w1, out, rows, hid, eps, cl, stages, s);
    case 256: return launch<N1, 128>(x, g0, w0, g1, w1, out, rows, hid, eps, cl, stages, s);
    case 384: return launch<N1, 192>(x, g0, w0, g1, w1, out, rows, hid, eps, cl, stages, s);
    case 512: return launch<N1, 256>(x, g0, w0, g1, w1, out, rows, hid, eps, cl, stages, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool GELU>
cudaError_t launch_gemm(const void* a, const void* b, void* out, int m, int n, int kd,
                        cudaStream_t stream) {
  CUtensorMap tm_a, tm_b;
  const auto l2 = CU_TENSOR_MAP_L2_PROMOTION_L2_256B;
  if (!matrix_map(&tm_a, a, kd, m, GK, GM, CU_TENSOR_MAP_SWIZZLE_128B, l2) ||
      !matrix_map(&tm_b, b, kd, n, GK, GN, CU_TENSOR_MAP_SWIZZLE_128B, l2))
    return cudaErrorInvalidValue;
  auto kernel = fused_feedforward_gemm_kernel<GELU>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GSMEM);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n / GN, (m + GM - 1) / GM), THREADS, GSMEM, stream>>>(
      tm_a, tm_b, static_cast<__nv_bfloat16*>(out), m, n, kd);
  return cudaGetLastError();
}

cudaError_t launch_staged(const void* x, const void* g0, const void* w0, const void* g1,
                          const void* w1, void* out, void* xn, void* h, int rows, int k, int hid,
                          float eps, cudaStream_t stream) {
  if (!xn || !h || k % GN != 0 || hid % GN != 0) return cudaErrorInvalidValue;
  const dim3 norm_grid((rows + 7) / 8);
  auto* hb = static_cast<__nv_bfloat16*>(h);
  fused_feedforward_rownorm_kernel<<<norm_grid, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(g0),
      static_cast<__nv_bfloat16*>(xn), rows, k, eps);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = launch_gemm<true>(xn, w0, h, rows, hid, k, stream);
  if (err != cudaSuccess) return err;
  fused_feedforward_rownorm_kernel<<<norm_grid, 256, 0, stream>>>(
      hb, static_cast<const float*>(g1), hb, rows, hid, eps);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = launch_gemm<false>(h, w1, out, rows, k, hid, stream);
  return err;
}

}  // namespace

// x (rows, k) bf16, g0 (k,) fp32, w0 (hid, k) bf16, g1 (hid,) fp32,
// w1 (k, hid) bf16, out (rows, k) bf16; all contiguous and 16-byte aligned.
// The cluster kernel: k is 128, 256, 384 or 512; `cluster` blocks (1, 2, 4
// or 8) split hid into slices of 128, 256 or 512 and k into multiples of 64;
// `stages` weight stages (`ff_tiles` chooses both); xn and h are null.
// `cluster` 0 takes the staged route: k and hid multiples of 128, xn (rows,
// k) and h (rows, hid) bf16 scratch.
extern "C" int fused_feedforward_bf16(const void* x, const void* g0, const void* w0,
                                      const void* g1, const void* w1, void* out, void* xn,
                                      void* h, int rows, int k, int hid, float eps, int cluster,
                                      int stages, void* stream) {
  if (cluster == 0 && rows >= 1)
    return (int)launch_staged(x, g0, w0, g1, w1, out, xn, h, rows, k, hid, eps,
                              static_cast<cudaStream_t>(stream));
  const bool cluster_ok = cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8;
  if (rows < 1 || !cluster_ok || hid % cluster != 0 || k % (64 * cluster) != 0 || stages < 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hid / cluster) {
    case 128:
      return (int)launch_k<64>(k, x, g0, w0, g1, w1, out, rows, hid, eps, cluster, stages, s);
    case 256:
      return (int)launch_k<128>(k, x, g0, w0, g1, w1, out, rows, hid, eps, cluster, stages, s);
    case 512:
      return (int)launch_k<256>(k, x, g0, w0, g1, w1, out, rows, hid, eps, cluster, stages, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
