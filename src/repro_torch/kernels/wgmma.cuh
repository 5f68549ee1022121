// Hopper (sm_90a) warpgroup matrix multiply: the inline-PTX pieces that
// the port's wgmma kernels share (flash_attention/kernel.cu, backward.cu and
// proxy_blocks/kernel.cu).  build.py compiles each source with this
// directory on the include path and hashes this header into the name of
// every library that includes it.
//
// Accumulator layout of wgmma m64nN (f32, one warpgroup of 128 threads):
// thread t of warp w holds value 4j + e of its 64 x N / 128 floats at row
// 16w + (t % 32) / 4 (+ 8 for e >= 2), column 8j + 2 (t % 4) + (e & 1).
// The A operand from registers (m64k16, bf16) holds the same rows: register
// r of the four is columns 2 (t % 4) (+1) (+8 for r >= 2), row +8 for odd r.
// So the accumulator pair (j, j + 1) of an m64nN product, rounded to bf16
// and packed (pack_bf16), is A register j / 2 of the next product, and
// k-step kk of that product reads registers 4 kk .. 4 kk + 3.
//
// Shared-memory operands use the 128 B swizzle: a tile of bf16 rows wider
// than 64 columns is stored as 64-column "atoms", each its own region of
// 128 B rows starting on a 1024 B boundary, in which the 16-byte chunk c of
// row r sits at chunk c ^ (r % 8) (what TMA's SWIZZLE_128B writes, and what
// a descriptor of layout type 1 reads).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

static __device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout type (1 = 128 B, 2 = 64 B,
// 3 = 32 B).
static __device__ __forceinline__ uint64_t make_desc(uint32_t addr,
                                                     uint32_t lbo,
                                                     uint32_t sbo,
                                                     uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

// `desc` with its start address advanced by `bytes` (a multiple of 16 that
// stays inside shared memory): the address is the low field, in 16-byte
// units, so one 32-bit add of a constant steps a descriptor through the
// k-steps of a tile instead of building each one anew.
static __device__ __forceinline__ uint64_t desc_add(uint64_t desc,
                                                    uint32_t bytes) {
  const uint32_t lo = static_cast<uint32_t>(desc) + (bytes >> 4);
  return (desc & 0xFFFFFFFF00000000ull) | lo;
}

static __device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
static __device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
static __device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Generic-proxy writes to shared memory (plain stores) made visible to the
// async proxy that wgmma reads its shared operands through; follow with a
// barrier.
static __device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

static __device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

#define WGMMA_R4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WGMMA_R8(i) WGMMA_R4(i), WGMMA_R4(i + 4)

// d[0:64] (+)= A (64x16, shared, K-major) * B (16x128, shared, K-major);
// scale_d 0 overwrites d.
static __device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                                     uint64_t db,
                                                     int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_R8(0), WGMMA_R8(8), WGMMA_R8(16), WGMMA_R8(24), WGMMA_R8(32),
        WGMMA_R8(40), WGMMA_R8(48), WGMMA_R8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[0:32] (+)= A (64x16, shared, K-major) * B (16x64, shared, K-major);
// scale_d 0 overwrites d.
static __device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                                    uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_R8(0), WGMMA_R8(8), WGMMA_R8(16), WGMMA_R8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// wgmma_ss_n<N> for N = 64 or 128.
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_ss: N");
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}

// d[0:N/2] (+)= A (64x16, registers) * B (16xN, shared, MN-major: the
// transpose bit); scale_d 0 overwrites d.  N = 16, 32, 64 or 128.
template <int N>
__device__ __forceinline__ void wgmma_rs_t(float* d, const uint32_t* a,
                                           uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs_t<16>(float* d, const uint32_t* a,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "1;\n}\n"
      : WGMMA_R8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_t<32>(float* d, const uint32_t* a,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : WGMMA_R8(0), WGMMA_R8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_t<64>(float* d, const uint32_t* a,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WGMMA_R8(0), WGMMA_R8(8), WGMMA_R8(16), WGMMA_R8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_t<128>(float* d, const uint32_t* a,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WGMMA_R8(0), WGMMA_R8(8), WGMMA_R8(16), WGMMA_R8(24), WGMMA_R8(32),
        WGMMA_R8(40), WGMMA_R8(48), WGMMA_R8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

#undef WGMMA_R8
#undef WGMMA_R4
