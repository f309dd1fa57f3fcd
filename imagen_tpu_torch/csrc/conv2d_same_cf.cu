// Stride-1 SAME k x k convolution with a tiny output width (cout <= 8),
// NHWC in, channel-first out, bf16, for sm_90a: a conv that streams its input
// rows once, bound by bytes.
//
// Replaces `conv2d_same_cf` -> `_forward_cf` -> `_kernel_cf` of
// imagen_tpu/ops/conv2d.py. There the channel-first output avoided a
// 3-channel NHWC array padded to 128 lanes in HBM; the H100 has no lanes to
// pad, so the layout is kept only because it is the function's contract.
//
// out[b, o, y, x] = bias[o] + sum_{dy, dx, c} in[b, y+dy-p, x+dx-p, c] * w[dy, dx, c, o]
// with zeros outside the image (k = 2p + 1).
//
// What bounds it on the H100: a 3x3 conv to 3 channels does 18 cin flops a
// pixel and reads 2 cin bytes, 9 flops a byte against the card's 295, so it is
// bound by reading x once (at the SR-1024 final conv, (2, 1024, 1024, 131) ->
// 3, 549 MB: 0.164 ms at 3.35 TB/s). Next comes shared memory: every tap
// reads a pixel's channels again.
//
// Design (`plan` below; ops/conv2d.py `cf_plan` mirrors it).
// - A strip is `sw` output columns (128 at most) of one image; the
//   strip-rows of all strips, top to bottom, are cut into one contiguous run
//   a block, so every block gets the same number of rows (a run may cross
//   into the next strip) and reads each input row of its run once: a run of
//   n rows reads n + 2p, and a strip's halo columns cost (sw + 2p) / sw.
// - Rows arrive by `cp.async.bulk` into a ring of staging slots with
//   mbarriers, `nst` rows in flight. A pixel at cin 131 is 262 bytes, so the
//   row segment is not 16-byte aligned and no TMA tensor map takes (b, H, W,
//   cin) (strides must be multiples of 16 bytes); the copy takes the 16-byte
//   aligned superset of the segment, at most 15 bytes on either side, inside
//   the 512-byte blocks PyTorch's allocator hands out. Where the ring does
//   not fit (thousands of channels), the same re-layout reads the row from
//   global memory directly (`nst` 0).
// - The re-layout: the block copies the row into a window of 16-byte
//   chunks, channels padded with zeros to 16 and each pixel to an odd number
//   of chunks, so `ldmatrix` rows are aligned and fall in distinct banks. A
//   chunk is read as the two aligned 16-byte words that hold it and shifted
//   down by its offset in them (8, 4, then 2 bytes). Weighed (by count, not
//   timed) against 32-bit fragment loads straight from the raw row: those
//   need two words and a shift for every odd pixel of every fragment, about
//   twice the shared-memory traffic of ldmatrix.
// - The products: mma.sync m16n8k16, 16 pixels x 8 outputs per tap and 16
//   channels; two warps a 16-pixel tile, each over half of the channel
//   chunks, the second's sums added to the first's when a row is finished.
//   wgmma's smallest tile is 64 pixels and reads A from shared memory in its
//   own layout; at 9 flops a byte the tensor cores idle either way, and
//   mma.sync lets a warp keep, in registers, the running sums of the k output
//   rows the current input row feeds: each input row is multiplied into all
//   of them (tap dy into output row r - dy + p) and the oldest is finished. So
//   each fragment is loaded once a row, not k times. The weights, (k^2, cin /
//   16, 8, 24) with 48-byte rows, sit in shared memory where they fit (two
//   taps' B fragments a ldmatrix) and are read through L1 otherwise.
// - Output: a finished row is staged channel-major in shared memory and each
//   plane's run of columns is written along W, coalesced, while the next
//   rows' copies are in flight.
// What holds it back (development builds with one part cut out, timed on the
// card at the SR-1024 final conv): the copies alone, the ring and its
// barriers, come near the bytes bound; the re-layout and the products run one
// after the other, since the same warps do both with barriers between, and
// the products take the most. A second window, re-laid by the same warps
// while the products of the first ran, was slower; warps specialised to the
// re-layout are untried.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "warp_mma.cuh"

namespace {

constexpr int NO = 8;          // output channels, padded: one n8 tile
constexpr int WKP = 24;        // a weight row: 16 channels and 8 of padding
constexpr int MAX_SW = 128;    // strip width: 8 tiles of 16 pixels, two warps a tile
constexpr int MAX_K = 19;
constexpr int MAX_SMEM = 232448;
constexpr int SM_SMEM = 233472;  // shared memory of an SM
constexpr int MIN_RUN = 16;      // rows a block at least, where there are that many

struct Plan {
  int sw, cgc, nst, wsmem, grid, smem;  // cgc: 16-channel chunks of a window group
};

struct Layout {
  int window, staging, slot, weights, outbuf, partial, bars, total;
};

__host__ __device__ inline int align16(int v) { return (v + 15) & ~15; }

__host__ __device__ inline Layout layout(int sw, int cgc, int nst, int wsmem, int cin, int k) {
  const int pix = sw + 2 * (k / 2), ch16 = (cin + 15) / 16;
  Layout L;
  L.window = 0;
  L.staging = pix * (2 * cgc + 1) * 16;
  L.slot = align16(pix * cin * 2 + 32);
  L.weights = L.staging + nst * L.slot;
  L.outbuf = L.weights + (wsmem ? k * k * ch16 * NO * WKP * 2 : 0);
  L.partial = L.outbuf + NO * sw * 2;
  L.bars = L.partial + sw / 16 * 32 * 16;
  L.total = L.bars + 8 * nst;
  return L;
}

// The block's run of strip-rows, one input row at a time: strip `strip`
// (image strip / xs, columns xs sw ..), output rows [ya, yb), input row r
// from ya - p to yb + p - 1, then the next strip's rows.
struct Walk {
  int strip, ya, yb, r;
  bool done;
};

__device__ __forceinline__ Walk walk_start(long long begin, long long end, int H, int p) {
  Walk w;
  w.done = begin >= end;
  w.strip = (int)(begin / H);
  w.ya = (int)(begin % H);
  w.yb = (int)(w.ya + end - begin < H ? w.ya + end - begin : H);
  w.r = w.ya - p;
  return w;
}

__device__ __forceinline__ void walk_next(Walk& w, long long end, int H, int p) {
  if (++w.r < w.yb + p) return;
  const long long s = (long long)(w.strip + 1) * H;
  if (w.yb < H || s >= end) {
    w.done = true;
    return;
  }
  w = walk_start(s, end, H, p);
}

// Values n .. 7 of 8 bf16 values (4 words) set to zero.
__device__ __forceinline__ uint4 clip8(uint4 v, int n) {
  uint32_t* o = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (2 * i >= n) o[i] = 0;
    else if (2 * i + 1 >= n) o[i] &= 0xffffu;
  }
  return v;
}

// 8 bf16 values from a 2-byte aligned address in shared memory, read as the
// two 16-byte words that hold them (neighbouring lanes on neighbouring words:
// no bank conflicts) and shifted down by the address's offset in them: 8
// bytes, then 4, then 2. Reads up to 32 bytes from the 16-byte boundary below
// the address.
__device__ __forceinline__ uint4 load8_shared(const uint8_t* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint4* v = reinterpret_cast<const uint4*>(a & ~15ull);
  const uint4 lo = v[0], hi = v[1];
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  uint32_t u[6], s[5];
#pragma unroll
  for (int i = 0; i < 6; ++i) u[i] = (a & 8) ? w[i + 2] : w[i];
#pragma unroll
  for (int i = 0; i < 5; ++i) s[i] = (a & 4) ? u[i + 1] : u[i];
  const uint32_t sh = (a & 2) * 8;
  return make_uint4(__funnelshift_r(s[0], s[1], sh), __funnelshift_r(s[1], s[2], sh),
                    __funnelshift_r(s[2], s[3], sh), __funnelshift_r(s[3], s[4], sh));
}

// The same from global memory, as five 4-byte words: reads at most 4 bytes
// past the last value.
__device__ __forceinline__ uint4 load8_global(const uint8_t* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint32_t* v = reinterpret_cast<const uint32_t*>(a & ~3ull);
  uint32_t w[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) w[i] = v[i];
  const uint32_t sh = (a & 2) * 8;
  return make_uint4(__funnelshift_r(w[0], w[1], sh), __funnelshift_r(w[1], w[2], sh),
                    __funnelshift_r(w[2], w[3], sh), __funnelshift_r(w[3], w[4], sh));
}

// The copy of the next row of the walk inside the image into staging slot
// `issued` % nst of the ring (thread 0): the 16-byte aligned superset of the
// row segment, columns x0 - p .. x0 + sw + p of the image clipped to it.
__device__ __forceinline__ void issue_row(Walk& pw, int& issued, long long end,
                                          const __nv_bfloat16* x, int H, int W, int cin, int p,
                                          int sw, int strips_x, int nst, uint8_t* staging,
                                          int slot_bytes, uint64_t* full) {
  while (!pw.done && (pw.r < 0 || pw.r >= H)) walk_next(pw, end, H, p);
  if (pw.done) return;
  const int bb = pw.strip / strips_x, x0 = (pw.strip % strips_x) * sw;
  const int xl = max(0, x0 - p), xr = min(W, x0 + sw + p);
  const uintptr_t src = reinterpret_cast<uintptr_t>(x + (((size_t)bb * H + pw.r) * W + xl) * cin);
  const uintptr_t a = src & ~15ull, e = (src + (size_t)(xr - xl) * cin * 2 + 15) & ~15ull;
  const int slot = issued % nst;
  mbar_expect_tx(&full[slot], (uint32_t)(e - a));
  bulk_load(smem_u32(staging + slot * slot_bytes), reinterpret_cast<const void*>(a),
            (uint32_t)(e - a), &full[slot]);
  ++issued;
  walk_next(pw, end, H, p);
}

// The staged output row (outbuf: 8 channels x sw columns) to row y of each
// of the cout planes, columns x0 .. x0 + sw clipped to W, by all threads.
__device__ __forceinline__ void write_row(const __nv_bfloat16* outbuf, __nv_bfloat16* out, int bb,
                                          int y, int x0, int H, int W, int cout, int sw) {
  const int n = min(sw, W - x0);
  __nv_bfloat16* dst = out + (((size_t)bb * cout) * H + y) * W + x0;
  const size_t plane = (size_t)H * W;
  if (W % 8 == 0 && n % 8 == 0) {
    for (int i = threadIdx.x; i < cout * n / 8; i += blockDim.x) {
      const int o = i / (n / 8), v = i % (n / 8);
      *reinterpret_cast<uint4*>(dst + o * plane + v * 8) =
          *reinterpret_cast<const uint4*>(outbuf + o * sw + v * 8);
    }
  } else {
    for (int i = threadIdx.x; i < cout * n; i += blockDim.x)
      dst[(i / n) * plane + i % n] = outbuf[(i / n) * sw + i % n];
  }
}

// KT: the kernel size, or 0 for any odd k up to MAX_K (the running sums then
// sized for MAX_K)
template <int KT>
__global__ void __launch_bounds__(512, 1)
conv2d_same_cf_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ wp,    // (k * k, ch16, 8, WKP)
                      const __nv_bfloat16* __restrict__ bias,  // (cout,) or null
                      __nv_bfloat16* __restrict__ out,         // (b, cout, H, W)
                      int b, int H, int W, int cin, int cout, int k_any, Plan plan) {
  constexpr int KMAX = KT > 0 ? KT : MAX_K;
  const int k = KT > 0 ? KT : k_any;
  extern __shared__ __align__(16) uint8_t smem[];
  const int sw = plan.sw, cgc = plan.cgc, nst = plan.nst;
  const Layout L = layout(sw, cgc, nst, plan.wsmem, cin, k);
  const int p = k / 2, pix = sw + 2 * p, ch16 = (cin + 15) / 16, ps = 2 * cgc + 1;
  const int groups = (ch16 + cgc - 1) / cgc;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  // two warps a 16-pixel tile, each over its half of the channel chunks
  const int tiles = sw / 16, tile = warp % tiles, half = warp / tiles;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint8_t* window = smem + L.window;
  __nv_bfloat16* outbuf = reinterpret_cast<__nv_bfloat16*>(smem + L.outbuf);
  float4* partial = reinterpret_cast<float4*>(smem + L.partial) + tile * 32 + lane;

  const __nv_bfloat16* wsrc = wp;
  if (plan.wsmem) {
    const int n16 = k * k * ch16 * NO * WKP / 8;
    uint4* dst = reinterpret_cast<uint4*>(smem + L.weights);
    for (int i = tid; i < n16; i += nthreads) dst[i] = __ldg(reinterpret_cast<const uint4*>(wp) + i);
    wsrc = reinterpret_cast<const __nv_bfloat16*>(smem + L.weights);
  }
  if (tid == 0) {
    for (int s = 0; s < nst; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int strips_x = (W + sw - 1) / sw;
  const long long total = (long long)b * strips_x * H;
  const long long begin = total * blockIdx.x / gridDim.x;
  const long long end = total * (blockIdx.x + 1) / gridDim.x;
  uint8_t* staging = smem + L.staging;

  // thread 0 keeps the copies of the next rows inside the image in flight
  Walk pw = walk_start(begin, end, H, p);
  int issued = 0;
  if (nst > 0 && tid == 0)
    for (int s = 0; s < nst; ++s)
      issue_row(pw, issued, end, x, H, W, cin, p, sw, strips_x, nst, staging, L.slot, full);

  // running sums of the k output rows the current input row feeds: slot j is
  // output row r - p + j, fed by tap dy = k - 1 - j; the first half's start
  // from the bias
  const bool biased = bias != nullptr && half == 0;
  const float b0 = (biased && 2 * t < cout) ? __bfloat162float(bias[2 * t]) : 0.f;
  const float b1 = (biased && 2 * t + 1 < cout) ? __bfloat162float(bias[2 * t + 1]) : 0.f;
  float acc[KMAX][4];

  // the finished row staged in outbuf, written once every thread has staged it
  bool pending = false;
  int pend_strip = 0, pend_y = 0;
  auto flush = [&]() {
    write_row(outbuf, out, pend_strip / strips_x, pend_y, (pend_strip % strips_x) * sw, H, W, cout,
              sw);
    pending = false;
  };

  Walk cw = walk_start(begin, end, H, p);
  int consumed = 0;
  while (!cw.done) {
    if (cw.r == cw.ya - p) {
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        acc[j][0] = acc[j][2] = b0;
        acc[j][1] = acc[j][3] = b1;
      }
    }
    if (cw.r >= 0 && cw.r < H) {
      const int bb = cw.strip / strips_x, x0 = (cw.strip % strips_x) * sw, xl = max(0, x0 - p);
      // the row segment from its first pixel in the image: in its staging
      // slot, at the offset of the segment in its 16-byte aligned superset
      const uint8_t* src =
          reinterpret_cast<const uint8_t*>(x + (((size_t)bb * H + cw.r) * W + xl) * cin);
      if (nst > 0) {
        const int slot = consumed % nst;
        mbar_wait(&full[slot], (consumed / nst) & 1);
        src = staging + slot * L.slot + (reinterpret_cast<uintptr_t>(src) & 15);
      }
      for (int gi = 0; gi < groups; ++gi) {
        // the window: pixel q of column x0 - p + q, 16-byte chunk c of channels
        // 8 (2 cgc gi + c) .., zero outside the image and past cin; neighbouring
        // threads on neighbouring chunks. Where a pass of the block covers
        // whole pixels, a thread keeps its chunk and steps over pixels.
        const int chunks = 2 * cgc;
        auto put = [&](int q, int c) {
          const int xc = x0 - p + q, c0 = (gi * chunks + c) * 8;
          uint4 v = make_uint4(0, 0, 0, 0);
          if (xc >= 0 && xc < W && c0 < cin) {
            const uint8_t* at = src + ((size_t)(xc - xl) * cin + c0) * 2;
            v = clip8(nst > 0 ? load8_shared(at) : load8_global(at), cin - c0);
          }
          *reinterpret_cast<uint4*>(window + (q * ps + c) * 16) = v;
        };
        if (chunks <= nthreads) {
          const int per = nthreads / chunks;  // pixels a pass
          if (tid < per * chunks)
            for (int q = tid / chunks; q < pix; q += per) put(q, tid % chunks);
        } else {
          for (int i = tid; i < pix * chunks; i += nthreads) put(i / chunks, i % chunks);
        }
        __syncthreads();
        if (gi == groups - 1 && nst > 0 && tid == 0)  // the slot is consumed
          issue_row(pw, issued, end, x, H, W, cin, p, sw, strips_x, nst, staging, L.slot, full);
        if (pending) flush();
        const int cg = min(cgc, ch16 - gi * cgc), c_half = (cg + 1) / 2;
        const int c_begin = half * c_half, c_end = half ? cg : c_half;
        const size_t tap = (size_t)ch16 * NO * WKP;  // weights of one tap
        for (int dx = 0; dx < k; ++dx) {
          for (int c = c_begin; c < c_end; ++c) {
            uint32_t a[4];
            ldmatrix_x4(a, window + ((tile * 16 + dx + lane % 16) * ps + 2 * c + lane / 16) * 16);
            const __nv_bfloat16* wt = wsrc + (dx * ch16 + gi * cgc + c) * NO * WKP;
            if (plan.wsmem) {
              // two taps' B fragments a ldmatrix: lanes 0-15 the rows (outputs)
              // and channel halves of tap dy, 16-31 of dy - 1
              const __nv_bfloat16* wl = wt + (lane % 8) * WKP + (lane / 8 % 2) * 8;
#pragma unroll
              for (int j = 0; j < KMAX; j += 2) {
                const int dy = k - 1 - j;
                if (j + 1 < k) {
                  uint32_t b[4];
                  ldmatrix_x4(b, wl + (dy - lane / 16) * k * tap);
                  mma_bf16(acc[j], a, b[0], b[1]);
                  mma_bf16(acc[j + 1], a, b[2], b[3]);
                } else if (j < k) {
                  uint32_t b[2];
                  ldmatrix_x2(b, wl + dy * k * tap);
                  mma_bf16(acc[j], a, b[0], b[1]);
                }
              }
            } else {
              const __nv_bfloat16* wr = wt + g * WKP + 2 * t;
#pragma unroll
              for (int j = 0; j < KMAX; ++j) {
                if (j < k) {
                  const __nv_bfloat16* wj = wr + (k - 1 - j) * k * tap;
                  mma_bf16(acc[j], a, *reinterpret_cast<const uint32_t*>(wj),
                           *reinterpret_cast<const uint32_t*>(wj + 8));
                }
              }
            }
          }
        }
        __syncthreads();  // the window is free
      }
      ++consumed;
    } else if (pending) {  // a row outside the image: write the staged row here
      __syncthreads();
      flush();
    }
    // output row r - p is finished: the second half's sums added to the
    // first's, staged channel-major
    const int y = cw.r - p;
    if (y >= cw.ya && y < cw.yb) {
      if (half) *partial = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
      __syncthreads();
      if (!half) {
        const float4 o = *partial;
        const int px = tile * 16 + g;
        outbuf[(2 * t) * sw + px] = __float2bfloat16(acc[0][0] + o.x);
        outbuf[(2 * t + 1) * sw + px] = __float2bfloat16(acc[0][1] + o.y);
        outbuf[(2 * t) * sw + px + 8] = __float2bfloat16(acc[0][2] + o.z);
        outbuf[(2 * t + 1) * sw + px + 8] = __float2bfloat16(acc[0][3] + o.w);
      }
      pending = true;
      pend_strip = cw.strip;
      pend_y = y;
    }
#pragma unroll
    for (int j = 0; j + 1 < KMAX; ++j) {
      acc[j][0] = acc[j + 1][0];
      acc[j][1] = acc[j + 1][1];
      acc[j][2] = acc[j + 1][2];
      acc[j][3] = acc[j + 1][3];
    }
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j == k - 1) {
        acc[j][0] = acc[j][2] = b0;
        acc[j][1] = acc[j][3] = b1;
      }
    }
    walk_next(cw, end, H, p);
  }
  if (pending) {
    __syncthreads();
    flush();
  }
}

// ---- the plan (ops/conv2d.py `cf_plan` mirrors it) ------------------------------------

// The widest strip (128, 64, 32, 16 pixels) whose window of every channel,
// ring of 3 (else 2) staging rows and output staging fit, with the weights
// where they fit too; failing all, 16-pixel strips without the ring, as many
// channel chunks a window group as fit. Then one block for each run of at
// least MIN_RUN strip-rows, at most as many as the SMs hold at once.
Plan plan(int b, int H, int W, int cin, int k, int sms) {
  const int ch16 = (cin + 15) / 16;
  Plan p{};
  bool found = false;
  for (int sw = MAX_SW; sw >= 16 && !found; sw /= 2)
    for (int nst = 3; nst >= 2 && !found; --nst)
      for (int wsmem = 1; wsmem >= 0 && !found; --wsmem)
        if (layout(sw, ch16, nst, wsmem, cin, k).total <= MAX_SMEM) {
          p = Plan{sw, ch16, nst, wsmem, 0, 0};
          found = true;
        }
  if (!found) {
    const int wsmem = layout(16, 1, 0, 1, cin, k).total <= MAX_SMEM ? 1 : 0;
    int cgc = 1;
    while (cgc < ch16 && layout(16, cgc + 1, 0, wsmem, cin, k).total <= MAX_SMEM) ++cgc;
    p = Plan{16, cgc, 0, wsmem, 0, 0};
  }
  p.smem = layout(p.sw, p.cgc, p.nst, p.wsmem, cin, k).total;
  const int warps = p.sw / 8;
  int per_sm = SM_SMEM / (p.smem + 1024);
  per_sm = per_sm < 64 / warps ? per_sm : 64 / warps;
  per_sm = per_sm > 1 ? per_sm : 1;
  const long long rows = (long long)b * ((W + p.sw - 1) / p.sw) * H;
  long long grid = rows / MIN_RUN;
  grid = grid < (long long)sms * per_sm ? grid : (long long)sms * per_sm;
  p.grid = (int)(grid > 1 ? grid : 1);
  return p;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

template <int KT>
cudaError_t run(const Plan& p, const void* x, const void* w, const void* bias, void* out, int b,
                int H, int W, int cin, int cout, int k, cudaStream_t stream) {
  auto kernel = conv2d_same_cf_kernel<KT>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.grid, p.sw * 4, p.smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out), b, H, W, cin,
      cout, k, p);
  return cudaGetLastError();
}

bool takes(int b, int H, int W, int cin, int cout, int k) {
  return b >= 1 && H >= 1 && W >= 1 && cin >= 1 && cout >= 1 && cout <= NO && k >= 1 &&
         k <= MAX_K && k % 2 == 1;
}

}  // namespace

// x (b, H, W, cin); w (k * k, ceil(cin / 16), 8, 24), the weight (k, k, cin,
// cout) zero-padded to 16-channel chunks, 8 outputs and 24-value rows, channels
// innermost; bias (cout,) or null; out (b, cout, H, W); all bf16 and
// contiguous, w and out 16-byte aligned; k odd and at most 19, 1 <= cout <= 8.
extern "C" int conv2d_same_cf_bf16(const void* x, const void* w, const void* bias, void* out,
                                   int b, int H, int W, int cin, int cout, int k,
                                   void* stream) {
  if (!takes(b, H, W, cin, cout, k)) return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  const Plan p = plan(b, H, W, cin, k, sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return (int)run<1>(p, x, w, bias, out, b, H, W, cin, cout, k, s);
    case 3: return (int)run<3>(p, x, w, bias, out, b, H, W, cin, cout, k, s);
    case 5: return (int)run<5>(p, x, w, bias, out, b, H, W, cin, cout, k, s);
    case 7: return (int)run<7>(p, x, w, bias, out, b, H, W, cin, cout, k, s);
    default: return (int)run<0>(p, x, w, bias, out, b, H, W, cin, cout, k, s);
  }
}

// The plan the entry takes for these sizes on a card of `sms` SMs, as 6 ints:
// strip width, channel chunks a window group, staging slots, weights in shared
// memory, grid, shared memory bytes (for the tests, which hold `cf_plan` to it).
extern "C" int conv2d_same_cf_plan(int b, int H, int W, int cin, int cout, int k, int sms,
                                   int* out) {
  if (!takes(b, H, W, cin, cout, k) || sms < 1) return 1;
  const Plan p = plan(b, H, W, cin, k, sms);
  const int v[6] = {p.sw, p.cgc, p.nst, p.wsmem, p.grid, p.smem};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}
