// Hopper (sm_90a) kernels for the two proxy blocks that carry replay.
//
// mxu_iter  replaces repro/kernels/proxy_blocks/kernel.py:_mxu_iter_kernel
//           (mxu_pallas): a <- bf16((a @ b) in f32 * scale), reps times,
//           with a and b kept on chip between turns.
//   Bound:  one (128,128) bf16 product is 4.19 MFLOP against 96 KiB of
//           input and output, so at reps = 5 the 98,304 bytes bound it
//           (29 ns at 3.35 TB/s); from a few dozen turns on the tensor-core
//           FLOPs do (reps = 4096: 17.4 us at 989 TFLOP/s).  But each turn
//           needs the last one's result, so one item's chain can use only
//           the SMs its rows are split over: two here (below), a bound of
//           66 x 17.4 us = 1.15 ms at reps = 4096.
//   Design: row i of a after a turn depends only on row i before it, so
//           the 128 rows split into two 64-row halves that never talk to
//           each other: two CTAs per item, CTA (item, h) owns rows
//           [64h, 64h + 64), one warpgroup of 128 threads, which is the
//           64-row tile of one wgmma.  b is loaded once into shared memory
//           (32 KiB, under the 48 KiB default) with plain 16-byte loads in
//           the 128 B-swizzled layout of wgmma.cuh, as two 64-column
//           atoms; no TMA, since a tensor map is encoded on the host and
//           the host's cost per call is what this launch-bound block pays
//           for.  The CTA's strip of a is loaded once straight into the
//           registers of wgmma's A fragment and never goes back to memory
//           between turns.  Each turn is 8 wgmma m64n128k16 (A from
//           registers, B = the k-slice of b read as MN-major through the
//           transpose bit, as flash_fwd's O += P V reads V) into one f32
//           accumulator, then in registers acc * scale rounded to bf16 and
//           packed pairwise into the next turn's A fragment.  The rounding
//           per element is __float2bfloat16_rn(__fmul_rn(acc, scale)).
//
// stream_iter replaces repro/kernels/proxy_blocks/kernel.py:_stream_iter_kernel
//           (stream_pallas): v <- v * 0.999999 + 1e-6, reps times per tile.
//   Bound:  at reps = 5 the bytes (read v once, write once: 262,144 B for
//           n = 32,768, 78 ns); at reps = 4096 the f32 operations (4.0 us
//           at 67 TFLOP/s), though each element is a chain of 2 * reps
//           dependent operations, so latency, not rate, limits a small n.
//   Design: each thread loads one float4 once, loops reps times in
//           registers and stores once.  __fmaf_rn rounds each turn once, as
//           the reference's XLA program (which contracts the update into a
//           fused multiply-add) does.
//
// C interface for ctypes: each launcher returns cudaGetLastError() after the
// launch (0 on success).  Launches go on the caller's stream and allocate
// nothing.  Pointers must be 16-byte aligned (ops.py copies a view that is
// not) and the work non-empty (ops.py launches nothing for an empty input).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int kMM = 128;
constexpr int kRows = 64;                   // rows of a per CTA: one m64 tile
constexpr int kThreads = 128;               // one warpgroup
constexpr int kKSteps = kMM / 16;           // k16 steps of one product
constexpr int kRowBytes = 128;              // one row of a 64-column atom
constexpr int kAtomBytes = kMM * kRowBytes; // b's 128 rows x 64 columns
// b as two atoms, plus slack to align them to 1024 B
constexpr int kMxuSmem = 2 * kAtomBytes + 1024;

// A-fragment register r of k-step kk sits at row (r & 1) * 8 and column
// 16 kk + (r >> 1) * 8 from the thread's first element (wgmma.cuh).
__device__ __forceinline__ int frag_offset(int kk, int r) {
  return (r & 1) * 8 * kMM + 16 * kk + (r >> 1) * 8;
}

__global__ void __launch_bounds__(kThreads)
mxu_iter_kernel(const __nv_bfloat16* __restrict__ a,
                const __nv_bfloat16* __restrict__ b,
                __nv_bfloat16* __restrict__ out,
                long long b_stride, int reps, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sb = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const long long item = blockIdx.x / 2;
  const int half = blockIdx.x % 2;

  // b into its two swizzled atoms: 16-byte chunk c of row k (8 columns)
  // goes to atom c / 8, chunk (c % 8) ^ (k % 8) of that atom's row k
  const uint4* gb = reinterpret_cast<const uint4*>(b + item * b_stride);
  for (int i = threadIdx.x; i < kMM * kMM / 8; i += kThreads) {
    const int k = i / 16, c = i % 16;
    *reinterpret_cast<uint4*>(sb + (c / 8) * kAtomBytes + k * kRowBytes +
                              ((c % 8) ^ (k % 8)) * 16) = gb[i];
  }

  // the CTA's 64 rows of a, straight into the A fragment: thread t of warp
  // w holds rows 16w + (t % 32) / 4 (+8), columns 2 (t % 4) (+1) of each
  // 16-column k-step (+8)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long first = item * kMM * kMM +
                          (kRows * half + 16 * warp + lane / 4) * kMM +
                          2 * (lane % 4);
  uint32_t pa[4 * kKSteps];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[4 * kk + r] = *reinterpret_cast<const uint32_t*>(
          a + first + frag_offset(kk, r));

  fence_proxy_async_shared();
  __syncthreads();

  const uint32_t sb0 = smem_u32(sb);
  float acc[kMM / 2];
#pragma unroll
  for (int j = 0; j < kMM / 2; ++j) acc[j] = 0.f;
  for (int turn = 0; turn < reps; ++turn) {
    wgmma_fence();                      // pa and acc were just written
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk)
      wgmma_rs_t<kMM>(acc, pa + 4 * kk,
                      make_desc(sb0 + kk * 16 * kRowBytes, kAtomBytes,
                                8 * kRowBytes, 1), kk);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < kMM / 2; j += 2)
      pa[j / 2] = pack_bf16(__fmul_rn(acc[j], scale),
                            __fmul_rn(acc[j + 1], scale));
  }

#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<uint32_t*>(out + first + frag_offset(kk, r)) =
          pa[4 * kk + r];
}

constexpr int kStreamThreads = 256;

__global__ void __launch_bounds__(kStreamThreads)
stream_iter_kernel(const float4* __restrict__ v, float4* __restrict__ out,
                   long long n4, int reps, float c, float d) {
  const long long i = blockIdx.x * static_cast<long long>(kStreamThreads) + threadIdx.x;
  if (i >= n4) return;
  float4 x = v[i];
  for (int r = 0; r < reps; ++r) {
    x.x = __fmaf_rn(x.x, c, d);
    x.y = __fmaf_rn(x.y, c, d);
    x.z = __fmaf_rn(x.z, c, d);
    x.w = __fmaf_rn(x.w, c, d);
  }
  out[i] = x;
}

}  // namespace

extern "C" {

// a, out: (batch, 128, 128) bf16, contiguous; b: (128, 128) bf16 shared by
// every item (b_stride = 0) or one per item (b_stride = 128 * 128).
int mxu_iter_launch(const void* a, const void* b, void* out, long long batch,
                    long long b_stride, int reps, float scale, void* stream) {
  if (batch <= 0) return 0;
  mxu_iter_kernel<<<static_cast<unsigned>(2 * batch), kThreads, kMxuSmem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<__nv_bfloat16*>(out), b_stride, reps, scale);
  return static_cast<int>(cudaGetLastError());
}

// v, out: n f32 values, contiguous, n % 1024 == 0; c = 0.999999 and
// d = 1e-6 come from the caller, rounded to f32 as PyTorch rounds them.
int stream_iter_launch(const void* v, void* out, long long n, int reps,
                       float c, float d, void* stream) {
  if (n <= 0) return 0;
  const long long n4 = n / 4;
  const long long blocks = (n4 + kStreamThreads - 1) / kStreamThreads;
  stream_iter_kernel<<<static_cast<unsigned>(blocks), kStreamThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(v), static_cast<float4*>(out), n4, reps, c, d);
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_name(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
