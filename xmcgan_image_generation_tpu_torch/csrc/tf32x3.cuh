// Float32-accurate products on Hopper's tensor cores (mma.sync and the
// warpgroup wgmma), and asynchronous copies into and out of shared memory.
//
// A TF32 tensor-core product keeps 10 bits of each operand's mantissa, so
// one pass loses about three decimal digits.  The 3xTF32 split recovers
// them: x = big + small with big = tf32(x) and small = tf32(x - big), and
// a b ~= small_a big_b + big_a small_b + big_a big_b, accumulated in
// float32 with the small terms first (small_a small_b, below float32's
// last bit, is dropped); a kernel issues the three products in that
// order.  Each product of two TF32 values is exact in the float32
// accumulator, so the result keeps float32 accuracy at a third of the
// TF32 rate.

#pragma once

#include <cstdint>

namespace tf32x3 {

__device__ __forceinline__ uint32_t round_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x -> (big, small), each a TF32 value in a 32-bit register.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = round_tf32(x);
  small = round_tf32(x - __uint_as_float(big));
}

// Four 8 x 4 blocks of 32-bit values from shared memory (ldmatrix on the
// values viewed as pairs of 16-bit halves): lane l gives the address of
// row l % 8 of block l / 8 (16 bytes, 16-byte aligned), and register j of
// lane 4 g + t receives element (g, t) of block j, the register layout of
// an mma.m16n8k8 .tf32 fragment.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const float* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// Warpgroup products (wgmma; the four warps of a warpgroup issue them
// together and each holds 16 rows of the 64-row tile, in the register
// layouts of mma.m16n8k8 .tf32).

// Shared-memory descriptor of a K-major wgmma operand without swizzle:
// 8-row x 16-byte core matrices, `lead` bytes apart along K and `stride`
// bytes apart along the rows.
__device__ __forceinline__ uint64_t smem_desc(const float* p, uint32_t lead,
                                              uint32_t stride) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lead >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((stride >> 4) & 0x3FFF) << 32);
}

// Orders this thread's writes to shared memory before later reads of the
// tensor cores' asynchronous proxy (wgmma's shared-memory operands).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keeps the compiler from moving accesses of `v` across a point where the
// tensor cores may still write it, or from giving its register to another
// value while they may still read it.
__device__ __forceinline__ void fence_operand(float& v) {
  asm volatile("" : "+f"(v) :: "memory");
}
__device__ __forceinline__ void fence_operand(uint32_t& v) {
  asm volatile("" : "+r"(v) :: "memory");
}

// `bytes` (a multiple of 16) from shared to global memory by the bulk-copy
// engine, asynchronously; both addresses 16-byte aligned.  The issuing
// thread commits and waits for its own copies.
__device__ __forceinline__ void bulk_store(float* dst, const float* src,
                                           uint32_t bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(src));
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      :: "l"(dst), "r"(s), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Until the copies' sources may be overwritten.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Until the copies are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// d[kOff .. kOff + 9) += a b for a 64 x 72 tile of depth 8: a from
// registers (this warp's 16 rows), b (72 rows of 8) by descriptor.
template <int kOff, int kTiles>
__device__ __forceinline__ void wgmma_m64n72k8(float (&d)[kTiles][4],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
  static_assert(kOff + 9 <= kTiles, "72 columns");
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1;\n"
      "}\n"
      : "+f"(d[kOff + 0][0]), "+f"(d[kOff + 0][1]), "+f"(d[kOff + 0][2]), "+f"(d[kOff + 0][3]),
        "+f"(d[kOff + 1][0]), "+f"(d[kOff + 1][1]), "+f"(d[kOff + 1][2]), "+f"(d[kOff + 1][3]),
        "+f"(d[kOff + 2][0]), "+f"(d[kOff + 2][1]), "+f"(d[kOff + 2][2]), "+f"(d[kOff + 2][3]),
        "+f"(d[kOff + 3][0]), "+f"(d[kOff + 3][1]), "+f"(d[kOff + 3][2]), "+f"(d[kOff + 3][3]),
        "+f"(d[kOff + 4][0]), "+f"(d[kOff + 4][1]), "+f"(d[kOff + 4][2]), "+f"(d[kOff + 4][3]),
        "+f"(d[kOff + 5][0]), "+f"(d[kOff + 5][1]), "+f"(d[kOff + 5][2]), "+f"(d[kOff + 5][3]),
        "+f"(d[kOff + 6][0]), "+f"(d[kOff + 6][1]), "+f"(d[kOff + 6][2]), "+f"(d[kOff + 6][3]),
        "+f"(d[kOff + 7][0]), "+f"(d[kOff + 7][1]), "+f"(d[kOff + 7][2]), "+f"(d[kOff + 7][3]),
        "+f"(d[kOff + 8][0]), "+f"(d[kOff + 8][1]), "+f"(d[kOff + 8][2]), "+f"(d[kOff + 8][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += a b for a 64 x 128 tile of depth 8: a from registers (this warp's
// 16 rows), b (128 rows of 8) by descriptor.
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[16][4],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += a b for one m16n8k8 tile: a row-major 16 x 8, b column-major 8 x 8,
// d 16 x 8 in float32 (the register layouts of the PTX ISA's
// mma.m16n8k8 .tf32).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes from global to shared memory, asynchronously; zeros when
// !valid (nothing is read from `src` then).  Both addresses 16-byte
// aligned.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace tf32x3
