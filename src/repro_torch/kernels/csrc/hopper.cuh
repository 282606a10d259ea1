// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels:
// cp.async copies into shared memory, the 128-byte-swizzled tile layout that
// wgmma's shared-memory descriptors read, and wgmma m64n64k16 in bf16 with
// f32 accumulators.
//
// Tile layout. A tile of ROWS rows and WIDTH bf16 columns (WIDTH a multiple
// of 64) lies in column blocks of 64 elements, block j at j * ROWS * 128
// bytes; row r of a block at r * 128 bytes within it, and its 16-byte chunk
// c at (c ^ (r % 8)) * 16. Read K-major (along the row) it is an A or B
// operand whose K dimension runs along the columns; read MN-major (the
// transposed operand) the same bytes give one whose K dimension runs along
// the rows. The tile's base lies on 1024 bytes (the swizzle's period).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

// 2^x in one MUFU instruction (exp2f adds a range fix-up around it); tiny
// results flush to 0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy to shared memory; src_bytes (0 to 16) are read, the rest of
// the 16 bytes is zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// 4-byte copy to shared memory; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// makes this thread's shared-memory writes visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of an accumulator across wgmma
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B from shared memory, K-major
// unless TRANS_A / TRANS_B (then MN-major: the transposed operand)
template <int TRANS_A = 0, int TRANS_B = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_A), "n"(TRANS_B));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A in registers (bf16 pairs), B
// MN-major (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// byte offset of element (r, c) in a swizzled tile of ROWS rows
template <int ROWS>
__device__ __forceinline__ uint32_t tile_offset(int r, int c) {
  return (c >> 6) * (ROWS * 128) + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// ROWS rows from row0 of a [S, cols] slice (row stride `ss` elements) into
// the swizzled tile of WIDTH columns at `dst`, by THREADS threads. Rows at or
// past s_len and columns at or past `cols` are zero-filled; the source rows
// must start on 16 bytes.
template <int WIDTH, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src, int64_t ss,
                                          int row0, int s_len, int cols, int tid) {
  constexpr int CPR = WIDTH / 8;  // 16-byte chunks a row
#pragma unroll 4
  for (int e = tid; e < ROWS * CPR; e += THREADS) {
    const int r = e / CPR, c = e % CPR;
    const int pos = row0 + r;
    const int bytes = pos < s_len ? min(16, max(0, 2 * (cols - c * 8))) : 0;
    const __nv_bfloat16* g = bytes ? src + pos * ss + c * 8 : src;
    cp_async16(dst + (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4), g, bytes);
  }
}

}  // namespace hopper
