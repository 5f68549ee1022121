// Warp-level tensor-core pieces (mma.sync) and asynchronous copies that the
// SSD diagonal block's forward and backward share (ssd/kernel.cu,
// ssd/backward.cu).  build.py compiles each source with this directory on
// the include path and hashes this header into the name of every library.
//
// Fragments of mma m16n8k8 (TF32) and m16n8k16 (bf16), f32 accumulator:
// thread t of a warp (gq = t / 4, tq = t % 4) holds accumulator elements
// (gq, 2 tq), (gq, 2 tq + 1), (gq + 8, 2 tq), (gq + 8, 2 tq + 1).
//
// f32 accuracy from TF32 products: an f32 operand x is split into
// x = hi + lo (split_tf32) and a product takes two TF32 products where the
// other factor is exact in TF32 (a bf16 value is), three where both are
// split (hi.hi + hi.lo + lo.hi; the dropped lo.lo is below 2^-21 of a
// term).  The small products go first.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "wgmma.cuh"   // smem_u32

// 16 (4) bytes global -> shared, asynchronously; zero-filled if !in
static __device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                                  bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(in ? 16 : 0) : "memory");
}
static __device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                                 bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(in ? 4 : 0) : "memory");
}
static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
static __device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// c (16x8 f32) += a (16x16 bf16) b (16x8 bf16)
static __device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                                const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c (16x8 f32) += a (16x8 tf32) b (8x8 tf32)
static __device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                                const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = hi + lo, hi its TF32 rounding and lo the TF32 rounding of the rest,
// to nearest with ties away from zero: cvt.rna.tf32.f32's bits, by integer
// ops (adding half of the dropped 13 bits to the sign-magnitude pattern
// rounds the magnitude), since the conversion instruction made the SSD
// backward 13% slower on an H100
static __device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                                  uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// c += a b in 3xTF32: the two small cross products first, then hi.hi
static __device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* ahi,
                                                  const uint32_t* alo,
                                                  const uint32_t* bhi,
                                                  const uint32_t* blo) {
  mma_tf32(c, alo, bhi);
  mma_tf32(c, ahi, blo);
  mma_tf32(c, ahi, bhi);
}

// c += a b with a exact in TF32 (bf16 values) and b split: the low first
static __device__ __forceinline__ void mma_a_2xtf32(float* c, const uint32_t* a,
                                                    const uint32_t* bhi,
                                                    const uint32_t* blo) {
  mma_tf32(c, a, blo);
  mma_tf32(c, a, bhi);
}

// c += a b with b exact in TF32 and a split: the low first
static __device__ __forceinline__ void mma_b_2xtf32(float* c, const uint32_t* ahi,
                                                    const uint32_t* alo,
                                                    const uint32_t* b) {
  mma_tf32(c, alo, b);
  mma_tf32(c, ahi, b);
}

// elements k and k + 1 (k even) of a bf16 row of n, zero past n or without
// a row; one 32-bit load when n is even (the row is then 4-byte aligned)
static __device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* row,
                                                   int k, int n) {
  if (row == nullptr) return 0u;
  const unsigned short* u = reinterpret_cast<const unsigned short*>(row);
  if ((n & 1) == 0)
    return k < n ? __ldg(reinterpret_cast<const unsigned int*>(u + k)) : 0u;
  const uint32_t lo = k < n ? __ldg(u + k) : 0u;
  const uint32_t hi = k + 1 < n ? __ldg(u + k + 1) : 0u;
  return lo | (hi << 16);
}

// element k of a bf16 or f32 row of n as f32, zero past n or without a row
template <typename T>
__device__ __forceinline__ float ld_elem(const T* row, int k, int n) {
  if (row == nullptr || k >= n) return 0.f;
  if constexpr (sizeof(T) == 2) {
    const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(row) + k);
    return __uint_as_float(static_cast<uint32_t>(u) << 16);
  } else {
    return __ldg(row + k);
  }
}

// acc[nt] += the products of C rows c0 (fragment row gq) and c1 (gq + 8)
// with B rows brow[nt] (fragment column gq of key block nt) over the state
// of n: 16 rows by 8 NT keys of S = C B^T.  A null row reads zeros.  bf16
// C and B go through bf16 mma with f32 accumulation (the products are exact
// in f32), f32 ones through 3xTF32; each unrolled step issues 16 products.
template <int NT, typename T>
__device__ __forceinline__ void mma_cbt(float (*acc)[4], const T* c0,
                                        const T* c1, const T* const* brow,
                                        int n, int tq) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll (16 / NT)
    for (int k = 0; k < n; k += 16) {
      const int kc = k + 2 * tq;
      const uint32_t a[4] = {ld_pair(c0, kc, n), ld_pair(c1, kc, n),
                             ld_pair(c0, kc + 8, n), ld_pair(c1, kc + 8, n)};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint32_t b[2] = {ld_pair(brow[nt], kc, n),
                               ld_pair(brow[nt], kc + 8, n)};
        mma_bf16(acc[nt], a, b);
      }
    }
  } else {
#pragma unroll (8 / NT)
    for (int k = 0; k < n; k += 8) {
      const int kc = k + tq;
      uint32_t ahi[4], alo[4];
      split_tf32(ld_elem(c0, kc, n), ahi[0], alo[0]);
      split_tf32(ld_elem(c1, kc, n), ahi[1], alo[1]);
      split_tf32(ld_elem(c0, kc + 4, n), ahi[2], alo[2]);
      split_tf32(ld_elem(c1, kc + 4, n), ahi[3], alo[3]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bhi[2], blo[2];
        split_tf32(ld_elem(brow[nt], kc, n), bhi[0], blo[0]);
        split_tf32(ld_elem(brow[nt], kc + 4, n), bhi[1], blo[1]);
        mma_3xtf32(acc[nt], ahi, alo, bhi, blo);
      }
    }
  }
}
