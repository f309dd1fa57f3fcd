// Hopper (sm_90a) building blocks of the flash attention, 3x3 conv, fused
// feedforward and CrossEmbed stem kernels of csrc/: tiles in shared memory in
// the swizzled layouts that wgmma reads, their matrix descriptors, the wgmma
// products (A from shared memory or from registers, fp32 accumulators in
// registers), mbarriers, TMA tile loads and stores, bulk copies, thread block
// clusters and their distributed shared memory, and the host-side tensor maps
// those loads read.
//
// Tiles. A tile of ROWS rows x D bf16 columns (D = 16, 32, 64 or 128) is kept
// as D / C column blocks of ROWS rows x C columns, C = min(D, 64), so one row
// of a block is RB = 2C bytes (32, 64 or 128). Each block is in the swizzle
// of width RB (CU_TENSOR_MAP_SWIZZLE_32B/64B/128B, wgmma layout types 3/2/1):
// the 16-byte chunk c of row r sits at chunk c ^ ((r * RB / 128) & (RB/16 - 1)),
// a pattern that repeats every 8 rows. TMA writes that layout itself; the
// kernels' own stores use `tile_offset`. Tiles start on 1024-byte boundaries.
//
// Descriptors. A tile read K-major (the bf16 columns are the reduction dim
// K, as q and k are in S = q k^T) takes SBO = 8 * RB between 8-row groups;
// the k16 step s starts 32 * s bytes into its column block. A tile read
// MN-major (its rows are K, its columns N, as V in O += P V) takes SBO = 8 *
// RB between 8-row groups of K, LBO = ROWS * RB between column blocks of N,
// and the k16 step s starts 16 * RB * s bytes in.
//
// The accumulator of a m64nNk16 product: thread t of the warpgroup holds rows
// 16 * (t / 32) + (t % 32) / 4 and that + 8, columns 8 j + 2 (t % 4) + {0, 1}
// of each n8 block j, as d[4 j + {0, 1}] and d[4 j + {2, 3}]. That is the
// mma.sync m16n8 layout of each warp's 16 rows, and its bf16 pairs of the n8
// blocks 2 kk and 2 kk + 1 are the register A operand of the k16 step kk.
#pragma once
#include <cuda.h>  // CUtensorMap and its enums; the driver is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

namespace {

// ---- tiles and descriptors -------------------------------------------------------------

template <int D>
struct Swz {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128, "D is 16, 32, 64 or 128");
  static constexpr int C = D < 64 ? D : 64;        // columns of a column block
  static constexpr int RB = 2 * C;                 // bytes of a row of a column block
  static constexpr int BLOCKS = D / C;
  static constexpr int LAYOUT = RB == 128 ? 1 : RB == 64 ? 2 : 3;
  static constexpr int K_STEPS = RB / 32;          // k16 steps in one column block
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (columns 8c .. 8c + 7) of row r in a
// swizzled ROWS x D tile.
template <int D, int ROWS>
__device__ __forceinline__ int tile_offset(int r, int c) {
  using S = Swz<D>;
  const int o = r * S::RB + (c % (S::RB / 16)) * 16;
  return (c / (S::RB / 16)) * ROWS * S::RB + (o ^ (((o >> 7) & (S::RB / 16 - 1)) << 4));
}

// The matrix base offset (bits 49-51) stays 0, also for a matrix that starts
// off the swizzle's 1024-byte period (the conv's shifted windows): the H100
// swizzles by the absolute shared-memory address, as TMA writes (setting the
// field to the start's phase gave wrong products there).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)layout << 62;
}

// K-major operand: rows row0 .. row0 + 63 (A) or all ROWS (B) of the tile at
// shared address `tile`, k16 step s of its D columns.
template <int D, int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int row0, int s) {
  using S = Swz<D>;
  return make_desc(tile + (s / S::K_STEPS) * ROWS * S::RB + row0 * S::RB +
                       (s % S::K_STEPS) * 32,
                   16, 8 * S::RB, S::LAYOUT);
}

// MN-major B operand: tile rows 16 s .. 16 s + 15 are K, its D columns N.
template <int D, int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int s) {
  using S = Swz<D>;
  return make_desc(tile + s * 16 * S::RB, ROWS * S::RB, 8 * S::RB, S::LAYOUT);
}

// ---- wgmma -------------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Ties registers that an in-flight wgmma reads or writes to this point, so
// the compiler neither reads an accumulator early nor writes an operand late.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}
// Move registers between warpgroups: the producer gives its registers up, the
// consumers take them (counts are multiples of 8; every warp of the warpgroup
// executes it).
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
// 2^x on the special-function unit; denormal results flush to 0.
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// Generic-proxy stores to shared memory become visible to wgmma and TMA.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x N) = / += A (64 x 16) B (16 x N); A, B by descriptor (SS) or A from
// registers (RS). TB = 1 reads B MN-major. scale_d = 0 overwrites d.
// ptxas serializes every wgmma of a kernel (its notes C7514/C7515) where
// plain code may touch an accumulator that, as far as it can tell, a wgmma
// still holds: so each loop iteration waits for every wgmma it issues, and
// the waits do not depend on the iteration.
template <int TB>
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7} "
      ", %8, %9, p, 1, 1, 0, %11;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7} "
      ", {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15} "
      ", %16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15} "
      ", {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31} "
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31} "
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63} "
      ", %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63} "
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

// SS only: the fused feedforward's products (N = 192 and 256 columns).
template <int TB>
__device__ __forceinline__ void wgmma_ss_n192(float (&d)[96], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95} "
      ", %96, %97, p, 1, 1, 0, %99;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127} "
      ", %128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

template <int N, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (N == 16) wgmma_ss_n16<TB>(d, da, db, scale_d);
  else if constexpr (N == 32) wgmma_ss_n32<TB>(d, da, db, scale_d);
  else if constexpr (N == 64) wgmma_ss_n64<TB>(d, da, db, scale_d);
  else if constexpr (N == 128) wgmma_ss_n128<TB>(d, da, db, scale_d);
  else if constexpr (N == 192) wgmma_ss_n192<TB>(d, da, db, scale_d);
  else wgmma_ss_n256<TB>(d, da, db, scale_d);
}

template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (N == 16) wgmma_rs_n16<TB>(d, a, db, scale_d);
  else if constexpr (N == 32) wgmma_rs_n32<TB>(d, a, db, scale_d);
  else if constexpr (N == 64) wgmma_rs_n64<TB>(d, a, db, scale_d);
  else wgmma_rs_n128<TB>(d, a, db, scale_d);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The register A operands (64 x 16 bf16 per k16 step) of an accumulator of
// N columns, rounded to bf16: the columns become K.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[N / 16][4], const float (&d)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16x2(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
  }
}

// ---- mbarriers, TMA, named barriers -------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A box at signed coordinates (c0 innermost); what lies outside the tensor
// arrives as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// A box from shared memory to the tensor; what lies outside it is not written.
// Commit with `tma_store_commit`, then `tma_store_wait` before the shared
// memory is written again.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

// Rows r0 .. r0 + 63 of the swizzled ROWS x D tile at `tile` to rows row ..
// row + 63 of batch `batch` of a (batch, n, D) tensor, one TMA store per
// column block; rows past n are not written. Then `tma_store_wait`.
template <int D, int ROWS>
__device__ __forceinline__ void tma_store_rows(uint32_t tile, int r0, const CUtensorMap* map,
                                               int row, int batch) {
  using S = Swz<D>;
#pragma unroll
  for (int blk = 0; blk < S::BLOCKS; ++blk)
    asm volatile(
        "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
            reinterpret_cast<uint64_t>(map)),
        "r"(tile + (blk * ROWS + r0) * S::RB), "r"(blk * S::C), "r"(row), "r"(batch)
        : "memory");
  tma_store_commit();
}
// Waits until the TMA stores have read their shared memory.
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Rows row .. row + ROWS - 1 of batch `batch` of a (batch, n, D) tensor into
// the swizzled ROWS x D tile at `dst`, one TMA load per column block; rows
// past n arrive as zeros. The tensor map's box is C columns x 64 rows.
template <int D, int ROWS>
__device__ __forceinline__ void tma_load_rows(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                              int row, int batch) {
  using S = Swz<D>;
#pragma unroll
  for (int blk = 0; blk < S::BLOCKS; ++blk)
#pragma unroll
    for (int r = 0; r < ROWS; r += 64)
      tma_load_3d(dst + blk * ROWS * S::RB + r * S::RB, map, bar, blk * S::C, row + r, batch);
}

// A 2-D box at (c0 innermost, c1); what lies outside the tensor arrives as zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// A 2-D box from shared memory to the tensor; what lies outside it is not written.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned) from
// global memory, completing on `bar` like a TMA load.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- thread block clusters and distributed shared memory ------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// Every thread of every block of the cluster arrives (its shared-memory
// writes, local and remote, released), then waits for all (acquired). Each
// warp executes them converged; a thread waits once between two arrivals.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}
// The address in block `rank`'s shared memory of this block's shared address `addr`.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}
__device__ __forceinline__ void st_cluster_v4(uint32_t addr, float a, float b, float c, float d) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(a), "f"(b),
               "f"(c), "f"(d)
               : "memory");
}

// bar.sync on barrier `id` (1 ..) among `count` threads; 0 is __syncthreads'.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// bar.arrive on barrier `id`: counts toward `count` without waiting.
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The dynamic shared memory, rounded up to 1024 bytes (the caller asks 1024 more).
__device__ __forceinline__ uint8_t* smem_1024(uint8_t* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023) & ~1023u) - a);
}

// ---- host: tensor maps ----------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Encoding a tensor map costs the host a driver call per map on every
// launch. The same few tensors come back call after call (PyTorch's caching
// allocator hands the same blocks out again), so the maps are kept by all of
// their arguments, the newest 64; a kept map is the one encoding would give.
inline bool encode_cached(CUtensorMap* map, CUtensorMapDataType type, cuuint32_t rank,
                          const void* base, const cuuint64_t* dims, const cuuint64_t* strides,
                          const cuuint32_t* box, CUtensorMapSwizzle swizzle,
                          CUtensorMapL2promotion l2) {
  constexpr int KEY = 16, ENTRIES = 64;
  struct Entry {
    uint64_t key[KEY];
    CUtensorMap map;
  };
  static std::mutex mu;
  static Entry kept[ENTRIES];
  static int used = 0, next = 0;
  uint64_t key[KEY] = {(uint64_t)type, rank, (uint64_t)base, (uint64_t)swizzle, (uint64_t)l2};
  for (cuuint32_t i = 0; i < rank; ++i) {  // rank <= 4
    key[5 + i] = dims[i];
    key[9 + i] = box[i];
    if (i > 0) key[13 + i - 1] = strides[i - 1];
  }
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    if (memcmp(kept[i].key, key, sizeof key) == 0) {
      *map = kept[i].map;
      return true;
    }
  }
  const EncodeTiled encode = encode_tiled();
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  if (!encode || rank > 4 ||
      encode(map, type, rank, const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, l2,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  memcpy(kept[next].key, key, sizeof key);
  kept[next].map = *map;
  next = (next + 1) % ENTRIES;
  used = used < ENTRIES ? used + 1 : ENTRIES;
  return true;
}

// A contiguous bf16 (batch, n, d) tensor as TMA boxes of min(d, 64) columns x
// box_rows rows in the wgmma swizzle of that width. Rows past n read as 0.
inline bool rows_map(CUtensorMap* map, const void* base, int batch, int n, int d, int box_rows) {
  const int cols = d < 64 ? d : 64;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)n * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)box_rows, 1};
  const CUtensorMapSwizzle swizzle = cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode_cached(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims, strides, box,
                       swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
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

// A contiguous fp32 vector of n values as TMA boxes of `box` values.
inline bool flat_map(CUtensorMap* map, const void* base, long long n, int box) {
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {0};  // none at rank 1
  const cuuint32_t boxes[1] = {(cuuint32_t)box};
  return encode_cached(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, base, dims, strides, boxes,
                       CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE);
}

}  // namespace
