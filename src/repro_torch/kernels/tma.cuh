// Hopper (sm_90a) TMA loads and mbarriers: the inline-PTX pieces, the tile
// layout and the tensor-map encoder that the port's TMA kernels share
// (flash_attention/kernel.cu and backward.cu).  build.py hashes this header
// into the name of every library, as it does wgmma.cuh.
//
// A tile of `Rows` rows of d bf16 columns is stored as d / cols "atoms" of
// `cols` columns, each its own region of Rows rows of 2 cols bytes, in the
// swizzle of that row width (128 B for d >= 64, else 64 B or 32 B): what a
// TMA box of one atom writes and what a wgmma descriptor of the same layout
// type reads (wgmma.cuh).  Every atom starts on a 1024 B boundary, so the
// hardware's address-based XOR agrees between the two.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

// Polls of an mbarrier before a wait traps: a fault that stalls a barrier
// ends the kernel with an error instead of hanging the card.
constexpr unsigned kWatchdog = 1u << 26;

template <int D, int Rows>
struct Swz {
  static constexpr int kBytes = 2 * D < 128 ? 2 * D : 128;  // a row of an atom
  static constexpr int kCols = kBytes / 2;                 // columns per atom
  static constexpr int kAtoms = D / kCols;
  static constexpr int kAtomBytes = Rows * kBytes;
  static constexpr int kTileBytes = kAtoms * kAtomBytes;
  // wgmma descriptor layout type: 1 = 128 B, 2 = 64 B, 3 = 32 B swizzle
  static constexpr uint64_t kDescLayout = kBytes == 128 ? 1 : kBytes == 64 ? 2 : 3;
};

// The first 1024-aligned byte at or after p: where a tile's atoms start.
static __device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

static __device__ __forceinline__ void mbar_init(uint64_t* bar,
                                                 unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

static __device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

static __device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.
static __device__ __forceinline__ void mbar_wait(uint64_t* bar,
                                                 unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  for (unsigned spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (spins == kWatchdog) __trap();
  }
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
static __device__ __forceinline__ void tma_load(void* dst,
                                                const CUtensorMap* map,
                                                uint64_t* bar, int c0, int c1,
                                                int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16; both ends 16-byte aligned)
// into shared memory, completing on `bar`.
static __device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                                 unsigned bytes,
                                                 uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: reached through
// cudaGetDriverEntryPoint, so the library needs no -lcuda.
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map (d, heads, positions, batch) of a contiguous bf16 tensor
// (batch, positions, heads, d), read in boxes of one atom's columns by
// Rows positions of one head: a box never crosses into the next batch,
// TMA zero-fills positions past len, and a GQA head is a coordinate.
template <int D, int Rows>
bool make_map(CUtensorMap* map, const void* ptr, int heads, int len, int b) {
  using W = Swz<D, Rows>;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {D, static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {2ull * D, 2ull * D * heads,
                                 2ull * D * heads * len};
  const cuuint32_t box[4] = {W::kCols, 1, Rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = W::kBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : W::kBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
