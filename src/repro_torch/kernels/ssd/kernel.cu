// Hopper (sm_90a) kernel for the SSD (Mamba2) intra-chunk diagonal block.
//
// ssd_diag replaces repro/kernels/ssd/kernel.py:_ssd_diag_kernel
//   (ssd_diag_pallas).  Per (batch, chunk, group) and each head of the
//   group, with i, j rows of the chunk:
//
//     Y[i] = sum_{j <= i} (C_i . B_j) * exp(cum_i - cum_j) * dt_j * X[j]
//
//   all in f32, as the reference computes it; output in x's dtype or f32.
//   It takes the model layout: x (b,c,q,h,p), dt/cum (b,c,q,h), B/C
//   (b,c,q,g,n), with h = g * r.
//
// Bound: at the Mamba2 2.7B prefill shape (b 4, c 8, q 256, g 1, h 80,
//   p 64, n 128) the causal (S o L)(dt X) products are 2*b*c*h*q*q*p/2 =
//   1.07e10 FLOP (plus 2.7e8 for C B^T).  On the tensor cores in 3xTF32
//   that is 3 x 1.07e10 at 495 TFLOP/s, 65 us (two products here: 43 us);
//   the bytes (x and B/C in bf16, dt and cum in f32, an f32 y: about
//   261 MB) take 78 us.  So the bytes bound this design (on the CUDA cores in f32 the operations did:
//   160 us at 67 TFLOP/s).
//
// Design: both products on the tensor cores (mma.sync), with f32 accuracy.
//   - S = C B^T.  With bf16 inputs (the serve path) it is a bf16 mma with
//     f32 accumulation: products of bf16 values are exact in f32, so this
//     is the reference's f32 product up to the order of the sum.  With f32
//     inputs (the smoke configs) it is 3xTF32: each operand split into a
//     TF32 hi part and the TF32 rounding of its remainder, lo, and the sum
//     hi.hi + hi.lo + lo.hi (the dropped lo.lo is below 2^-21 of a term).
//   - Y = (S o L)(dt X), computed as ((S o L) o dt_j) X.  The left factor
//     is an f32 value, split into hi + lo; a bf16 x is exact in TF32, so
//     3xTF32's hi.lo term vanishes and two mma m16n8k8 TF32 products,
//     lo.x + hi.x, give the f32 product to about 2^-22 of each term (an
//     f32 x takes all three).  Folding dt_j into the left factor computes
//     it once per element (the right factor is read by the four warps that
//     share a key half) and rounds M dt_j where the reference rounds dt x:
//     the same terms to an ulp.  A single TF32 or bf16 rounding of M would miss the 2^-14
//     row-RMS floor of KERNEL_TOL (tests/test_torch_kernels_zoo.py shows
//     it).  The exponent is masked to -inf before exp (for i < j it is
//     positive and can overflow, and 0 * inf is NaN where the reference's
//     where selects 0).
//   - Work split: a CTA of 8 warps takes one 64-row block I of the chunk
//     and a slice of 20 heads of one group.  It computes S_I = C_I B^T for
//     all keys j < end of I once into shared memory (64 x 256 f32, 65 KiB)
//     and keeps it for every head of the slice, since the r heads of a
//     group share it; the heads are sliced 20 wide so that the card gets
//     r / 20 times as many CTAs, at the cost of computing S r / 20 times
//     (its loads unrolled so that they overlap).  Warp w owns rows
//     16 (w % 4) .. +16 of I and half of each 64-key block J (w / 4):
//     its M fragments come straight from S, cum and exp in registers, each
//     element computed by exactly one thread, and the two halves' partial
//     Y are added through shared memory once per head.
//   - Copies overlap products: x_J, dt_J and cum_J of the next (head, J)
//     step stream in with cp.async into the next of kStages stages while
//     the warps multiply this one (the first stage's copy overlaps S); one
//     __syncthreads a step both publishes a stage and frees the last one.
//   - Balance: blocks J > I are never visited, so block I does I + 1 steps
//     a head; the grid puts I slowest and walks it from the last (most
//     work) down, so the heavy CTAs start first and the light ones fill
//     the tail.  Shared memory (103 KiB with bf16 x at p 64) lets 2 CTAs of
//     8 warps share an SM.
//
// C interface for ctypes: the launcher returns cudaGetLastError() after the
// launch (0 on success), on the caller's stream, allocating nothing.  The
// tensors are contiguous and 16-byte aligned (ops.py copies views that are
// not); ops.py launches nothing for empty inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kBI = 64;          // query rows per CTA
constexpr int kBJ = 64;          // key rows per step
constexpr int kThreads = 256;    // 8 warps: 4 row groups x 2 key halves
constexpr int kHeads = 20;       // heads per CTA
constexpr int kStages = 2;       // x/dt/cum staging ring depth
constexpr int kMaxQ = 256;       // chunk length
constexpr int kMaxN = 128;       // state size
constexpr int kLdS = kMaxQ + 4;  // f32 row stride of S, against conflicts

// Shared memory, in bytes: S, kStages stages of (x_J, dt_J, cum_J), and the
// buffer in which the second key half hands its partial Y to the first.
template <typename T, int P>
struct Smem {
  // x rows padded so that the B-fragment reads of a warp hit distinct banks
  static constexpr int kLdX = sizeof(T) == 2 ? P + 16 : P + 8;
  static constexpr int kXBytes = kBJ * kLdX * sizeof(T);   // 16-byte multiple
  static constexpr int kStageBytes = kXBytes + 2 * kBJ * 4;
  static constexpr int kLdR = P + 4;
  static constexpr int kS = 0;
  static constexpr int kStage = kS + kBI * kLdS * 4;
  static constexpr int kRed = kStage + kStages * kStageBytes;
  static constexpr int kBytes = kRed + kBI * kLdR * 4;
};

// wait until at most kStages - 2 groups are in flight
__device__ __forceinline__ void cp_async_wait_step() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 2) : "memory");
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 2)
ssd_diag_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ cum, const T* __restrict__ bm,
                const T* __restrict__ cm, void* __restrict__ y, int out_bf16,
                int q, int h, int g, int n, int n_iblk, int n_slices) {
  using L = Smem<T, P>;
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char sm[];
  float* sS = reinterpret_cast<float*>(sm + L::kS);
  float* sRed = reinterpret_cast<float*>(sm + L::kRed);

  // I block slowest, from the last (most work) down
  const int per_i = gridDim.x / n_iblk;
  const int iblk = n_iblk - 1 - static_cast<int>(blockIdx.x / per_i);
  const int rest = blockIdx.x % per_i;       // ((bc * g) + gi) * n_slices + slice
  const int slice = rest % n_slices;
  const int gi = (rest / n_slices) % g;
  const long long bc = (rest / n_slices) / g;  // batch * chunks + chunk
  const int r = h / g;
  const int i0 = iblk * kBI;
  const int n_jb = iblk + 1;                 // key blocks J <= I
  const int h0 = gi * r + slice * kHeads;    // first head of the slice
  const int n_steps = min(kHeads, r - slice * kHeads) * n_jb;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rw = warp % 4, kh = warp / 4;    // 16-row group, key half
  const int gq = lane / 4, tq = lane % 4;    // mma group and thread in group
  const int ri0 = 16 * rw + gq, ri1 = ri0 + 8;   // this thread's rows of I

  // stage x_J, dt_J, cum_J of step (head, J) into stage step % kStages; a
  // step past the last commits an empty group, so the count stays uniform
  auto prefetch = [&](int step) {
    if (step >= n_steps) {
      cp_async_commit();
      return;
    }
    const int hd = h0 + step / n_jb;
    const int jc = (step % n_jb) * kBJ;
    unsigned char* st = sm + L::kStage + (step % kStages) * L::kStageBytes;
    T* sx = reinterpret_cast<T*>(st);
    float* sdt = reinterpret_cast<float*>(st + L::kXBytes);
    constexpr int kVec = P * static_cast<int>(sizeof(T)) / 16;
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));
    for (int idx = threadIdx.x; idx < kBJ * kVec; idx += kThreads) {
      const int jj = idx / kVec, cc = idx % kVec;
      const bool in = jc + jj < q;
      cp_async16(sx + jj * L::kLdX + cc * kPer,
                 x + ((bc * q + (in ? jc + jj : 0)) * h + hd) * P + cc * kPer,
                 in);
    }
    if (threadIdx.x < 2 * kBJ) {             // dt, then cum
      const int jj = threadIdx.x % kBJ;
      const bool in = jc + jj < q;
      cp_async4(sdt + threadIdx.x,
                (threadIdx.x < kBJ ? dt : cum) +
                    (bc * q + (in ? jc + jj : 0)) * h + hd,
                in);
    }
    cp_async_commit();
  };
  for (int step = 0; step < kStages - 1; ++step) prefetch(step);

  // ---- S = C_I B^T for the keys of blocks J <= I, once per CTA ----
  {
    const int r0 = i0 + ri0, r1 = i0 + ri1;
    const T* c0 = r0 < q ? cm + ((bc * q + r0) * g + gi) * n : nullptr;
    const T* c1 = r1 < q ? cm + ((bc * q + r1) * g + gi) * n : nullptr;
    for (int jb = 0; jb < n_jb; ++jb) {
      const int kb = jb * kBJ + kh * 32;     // this warp's 32 keys
      float acc[4][4] = {};
      const T* brow[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int key = kb + nt * 8 + gq;
        brow[nt] = key < q ? bm + ((bc * q + key) * g + gi) * n : nullptr;
      }
      mma_cbt<4>(acc, c0, c1, brow, n, tq);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = kb + nt * 8 + 2 * tq;
        sS[ri0 * kLdS + col] = acc[nt][0];
        sS[ri0 * kLdS + col + 1] = acc[nt][1];
        sS[ri1 * kLdS + col] = acc[nt][2];
        sS[ri1 * kLdS + col + 1] = acc[nt][3];
      }
    }
  }

  // ---- per head: Y_I = sum_J ((S o L) o dt)_IJ X_J on the tensor cores ----
  float acc[P / 8][4];
  float cum0 = 0.f, cum1 = 0.f;
  for (int step = 0; step < n_steps; ++step) {
    const int jb = step % n_jb;
    const int hd = h0 + step / n_jb;
    if (jb == 0) {
#pragma unroll
      for (int nt = 0; nt < P / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
      cum0 = i0 + ri0 < q ? cum[(bc * q + i0 + ri0) * h + hd] : 0.f;
      cum1 = i0 + ri1 < q ? cum[(bc * q + i0 + ri1) * h + hd] : 0.f;
    }
    cp_async_wait_step();     // this thread's copies of the step landed
    __syncthreads();          // everyone's; S written; step - 1 consumed
    prefetch(step + kStages - 1);   // into the stage step - 1 used
    const unsigned char* st = sm + L::kStage + (step % kStages) * L::kStageBytes;
    const T* sx = reinterpret_cast<const T*>(st);
    const float* sdt = reinterpret_cast<const float*>(st + L::kXBytes);
    const float* scum = sdt + kBJ;
    const int jc = jb * kBJ;
    // M o dt_j; the exponent is masked to -inf for j > i
    auto m_dt = [&](int ri, int ig, float cumi, int jl, int jg, float dtj) {
      return sS[ri * kLdS + jg] *
             expf(jg <= ig ? cumi - scum[jl] : -INFINITY) * dtj;
    };
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {         // 8 keys of this warp's 32
      const int ja = kh * 32 + ks * 8 + tq, jz = ja + 4;   // stage rows
      const int ga = jc + ja, gz = jc + jz;                 // chunk rows
      const int ig0 = i0 + ri0, ig1 = i0 + ri1;
      // A = M o dt_j (f32, split hi + lo); B = x (bf16 x is exact in TF32,
      // so the hi.lo product is zero and two products suffice)
      const float dta = sdt[ja], dtz = sdt[jz];
      const float av[4] = {m_dt(ri0, ig0, cum0, ja, ga, dta),
                           m_dt(ri1, ig1, cum1, ja, ga, dta),
                           m_dt(ri0, ig0, cum0, jz, gz, dtz),
                           m_dt(ri1, ig1, cum1, jz, gz, dtz)};
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(av[e], ahi[e], alo[e]);
#pragma unroll
      for (int nt = 0; nt < P / 8; ++nt) {
        const T xa = sx[ja * L::kLdX + nt * 8 + gq];
        const T xz = sx[jz * L::kLdX + nt * 8 + gq];
        if constexpr (kBf16) {
          const uint32_t b[2] = {
              static_cast<uint32_t>(__bfloat16_as_ushort(xa)) << 16,
              static_cast<uint32_t>(__bfloat16_as_ushort(xz)) << 16};
          mma_b_2xtf32(acc[nt], ahi, alo, b);
        } else {
          uint32_t bhi[2], blo[2];
          split_tf32(xa, bhi[0], blo[0]);
          split_tf32(xz, bhi[1], blo[1]);
          mma_3xtf32(acc[nt], ahi, alo, bhi, blo);
        }
      }
    }
    if (jb == n_jb - 1) {     // the head's last block: add the halves, store
      if (kh == 1) {
#pragma unroll
        for (int nt = 0; nt < P / 8; ++nt) {
          const int col = nt * 8 + 2 * tq;
          sRed[ri0 * L::kLdR + col] = acc[nt][0];
          sRed[ri0 * L::kLdR + col + 1] = acc[nt][1];
          sRed[ri1 * L::kLdR + col] = acc[nt][2];
          sRed[ri1 * L::kLdR + col + 1] = acc[nt][3];
        }
      }
      __syncthreads();
      if (kh == 0) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int ri = half ? ri1 : ri0;
          if (i0 + ri >= q) continue;
          const long long o = ((bc * q + i0 + ri) * h + hd) * P;
#pragma unroll
          for (int nt = 0; nt < P / 8; ++nt) {
            const int col = nt * 8 + 2 * tq;
            const float v0 = acc[nt][2 * half] + sRed[ri * L::kLdR + col];
            const float v1 = acc[nt][2 * half + 1] + sRed[ri * L::kLdR + col + 1];
            if (out_bf16) {
              *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(y) + o + col) =
                  __floats2bfloat162_rn(v0, v1);
            } else {
              *reinterpret_cast<float2*>(static_cast<float*>(y) + o + col) =
                  make_float2(v0, v1);
            }
          }
        }
      }
    }
  }
}

template <typename T, int P>
int launch(const void* x, const void* dt, const void* cum, const void* b,
           const void* c, void* y, long long nbc, int q, int h, int g, int n,
           int out_bf16, cudaStream_t stream) {
  using L = Smem<T, P>;
  static bool set = false;
  if (!set) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_diag_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::kBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    set = true;
  }
  const int n_iblk = (q + kBI - 1) / kBI;
  const int n_slices = (h / g + kHeads - 1) / kHeads;
  const long long blocks = nbc * g * n_slices * n_iblk;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  ssd_diag_kernel<T, P><<<static_cast<unsigned>(blocks), kThreads, L::kBytes,
                          stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(cum), static_cast<const T*>(b),
      static_cast<const T*>(c), y, out_bf16, q, h, g, n, n_iblk, n_slices);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_p(const void* x, const void* dt, const void* cum, const void* b,
             const void* c, void* y, long long nbc, int q, int h, int g, int n,
             int p, int out_bf16, cudaStream_t stream) {
  switch (p) {
    case 8: return launch<T, 8>(x, dt, cum, b, c, y, nbc, q, h, g, n, out_bf16, stream);
    case 16: return launch<T, 16>(x, dt, cum, b, c, y, nbc, q, h, g, n, out_bf16, stream);
    case 32: return launch<T, 32>(x, dt, cum, b, c, y, nbc, q, h, g, n, out_bf16, stream);
    case 64: return launch<T, 64>(x, dt, cum, b, c, y, nbc, q, h, g, n, out_bf16, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// x: (nbc, q, h, p) and b, c: (nbc, q, g, n) in bf16 (in_bf16 = 1) or f32;
// dt, cum: (nbc, q, h) f32; y: (nbc, q, h, p) in bf16 (out_bf16 = 1) or
// f32.  nbc = batch * chunks; q <= 256, n <= 128, p in {8, 16, 32, 64},
// h % g == 0.
int ssd_diag_launch(const void* x, const void* dt, const void* cum,
                    const void* b, const void* c, void* y, long long nbc,
                    int q, int h, int g, int n, int p, int in_bf16,
                    int out_bf16, void* stream) {
  if (nbc <= 0 || q <= 0 || h <= 0) return 0;
  if (q > kMaxQ || n > kMaxN || n <= 0 || g <= 0 || h % g)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return launch_p<bf16>(x, dt, cum, b, c, y, nbc, q, h, g, n, p, out_bf16, st);
  return launch_p<float>(x, dt, cum, b, c, y, nbc, q, h, g, n, p, out_bf16, st);
}

const char* cuda_error_name(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
