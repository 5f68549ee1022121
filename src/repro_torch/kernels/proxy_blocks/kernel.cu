// Hopper (sm_90a) kernels for the two proxy blocks that carry replay.
//
// mxu_iter  replaces repro/kernels/proxy_blocks/kernel.py:_mxu_iter_kernel
//           (mxu_pallas): a <- bf16((a @ b) in f32 * scale), reps times,
//           with a and b kept on chip between turns.
//   Bound:  one (128,128) bf16 product is 4.19 MFLOP against 96 KiB of
//           input and output, so at reps = 5 the 98,304 bytes bound it
//           (29 ns at 3.35 TB/s); from a few dozen turns on the tensor-core
//           FLOPs do (reps = 4096: 17.4 us at 989 TFLOP/s).
//   Design: one CTA per batch element holds a and b in shared memory
//           (64 KiB, opted in above the 48 KiB default) and loops over the
//           turns with no global traffic.  8 warps; warp w owns output rows
//           [16w, 16w+16), which depend only on the same rows of a, so a
//           warp reads and rewrites its own strip and never races another.
//           Each turn is 8 x 8 WMMA bf16 16x16x16 products with f32
//           accumulators, staged through shared memory to scale and round
//           to bf16.  One CTA reaches at most 1/132 of the card's tensor
//           cores; wgmma and TMA are later work.
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
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int kMM = 128;
constexpr int kWarps = kMM / 16;            // one 16-row strip per warp
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 16;
// a and b (bf16) plus one f32 staging strip per warp
constexpr int kMxuSmem = 2 * kMM * kMM * 2 + kWarps * kTile * kMM * 4;

__global__ void __launch_bounds__(kThreads)
mxu_iter_kernel(const __nv_bfloat16* __restrict__ a,
                const __nv_bfloat16* __restrict__ b,
                __nv_bfloat16* __restrict__ out,
                long long b_stride, int reps, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sb = sa + kMM * kMM;
  float* stage = reinterpret_cast<float*>(sb + kMM * kMM);

  const long long item = blockIdx.x;
  const uint4* ga = reinterpret_cast<const uint4*>(a + item * kMM * kMM);
  const uint4* gb = reinterpret_cast<const uint4*>(b + item * b_stride);
  uint4* sa4 = reinterpret_cast<uint4*>(sa);
  uint4* sb4 = reinterpret_cast<uint4*>(sb);
  constexpr int kVec = kMM * kMM / 8;        // 16-byte vectors per matrix
  for (int i = threadIdx.x; i < kVec; i += kThreads) {
    sa4[i] = ga[i];
    sb4[i] = gb[i];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * kTile;
  float* wstage = stage + warp * kTile * kMM;

  for (int r = 0; r < reps; ++r) {
    wmma::fragment<wmma::accumulator, kTile, kTile, kTile, float> acc[kMM / kTile];
#pragma unroll
    for (int j = 0; j < kMM / kTile; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
    for (int k = 0; k < kMM; k += kTile) {
      wmma::fragment<wmma::matrix_a, kTile, kTile, kTile, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::load_matrix_sync(fa, sa + row0 * kMM + k, kMM);
#pragma unroll
      for (int j = 0; j < kMM / kTile; ++j) {
        wmma::fragment<wmma::matrix_b, kTile, kTile, kTile, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fb, sb + k * kMM + j * kTile, kMM);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kMM / kTile; ++j)
      wmma::store_matrix_sync(wstage + j * kTile, acc[j], kMM, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < kTile * kMM; i += 32)
      sa[row0 * kMM + i] = __float2bfloat16_rn(__fmul_rn(wstage[i], scale));
    __syncthreads();
  }

  uint4* go = reinterpret_cast<uint4*>(out + item * kMM * kMM);
  for (int i = threadIdx.x; i < kVec; i += kThreads) go[i] = sa4[i];
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
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        mxu_iter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMxuSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  if (batch <= 0) return 0;
  mxu_iter_kernel<<<static_cast<unsigned>(batch), kThreads, kMxuSmem,
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
