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
//   p 64, n 128) the causal (scores o L) (dt X) products are
//   2*b*c*h*q*q*p/2 = 1.07e10 FLOP in f32 (plus 2.7e8 for C B^T), 160 us
//   at the 67 TFLOP/s f32 rate; the bytes (x and B/C in bf16, dt and cum
//   in f32, an f32 y: about 261 MB) take 78 us.  So f32 operations bound
//   it, and the design stays on the CUDA cores in f32, like the reference.
//
// Design: shared memory is the constraint.  One (b, c, g) program's
//   C B^T tile at q = 256 is 256 KiB of f32, more than a CTA's 227 KiB,
//   and the TPU kernel's r x q x q masked-score block is r times that.  So
//   a CTA takes one 64-row block I of the chunk and a slice of 16 heads of
//   one group.  It computes S = C_I B_J^T once for all keys J <= I (64 x
//   at most 256 f32, 65 KiB) and keeps it, since S is shared by the r
//   heads of the group; then for each head it walks 64-key blocks J,
//   builds M = S o exp(cum_i - cum_j) only where i >= j (the exponent is
//   masked before exp: for i < j it is positive and can overflow, and
//   0 * inf is NaN where the reference's where selects 0), stages
//   dt_j * X_j, and accumulates Y_I += M (dt X)_J in registers, 4 rows by
//   4 columns per thread.  Blocks with j > i are never visited.  The JAX
//   wrapper's slabs of r <= 8 heads are a VMEM limit, not part of the
//   function; here the head slices are 16 wide, so S is recomputed
//   r / 16 times (5 at r = 80, 13% more work) to give the card 4 x as
//   many CTAs.  Plain SIMT f32; tensor cores (3xTF32) are later work.
//
// C interface for ctypes: the launcher returns cudaGetLastError() after the
// launch (0 on success), on the caller's stream, allocating nothing.  The
// tensors are contiguous and 16-byte aligned (ops.py copies views that are
// not); ops.py launches nothing for empty inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kBI = 64;          // query rows per CTA
constexpr int kBJ = 64;          // key rows per step
constexpr int kThreads = 256;
constexpr int kHeads = 16;       // heads per CTA
constexpr int kMaxQ = 256;       // chunk length
constexpr int kMaxN = 128;       // state size
constexpr int kLdS = kMaxQ + 4;  // f32 row strides, padded against conflicts
constexpr int kLdBt = kBJ + 4;
constexpr int kLdM = kBJ + 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// floats of shared memory: S, then a region that holds C_I and B_J^T while
// S is built and M and dt X afterwards, then the block's cum rows
constexpr int kRegion1 = kBI * (kMaxN + 4) + kMaxN * kLdBt;
constexpr int kRegion2 = kBI * kLdM + kBJ * (64 + 4);
constexpr int kRegion = kRegion1 > kRegion2 ? kRegion1 : kRegion2;
constexpr int kSmemFloats = kBI * kLdS + kRegion + 2 * kBI;
constexpr int kSmemBytes = kSmemFloats * 4;

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
ssd_diag_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ cum, const T* __restrict__ bm,
                const T* __restrict__ cm, void* __restrict__ y, int out_bf16,
                int q, int h, int g, int n, int n_iblk) {
  extern __shared__ __align__(16) float sm[];
  float* sS = sm;                            // kBI x kLdS
  float* region = sS + kBI * kLdS;
  float* sC = region;                        // kBI x (n + 4)
  const int ldC = n + 4;
  float* sBt = sC + kBI * ldC;               // n x kLdBt
  float* sM = region;                        // kBI x kLdM
  constexpr int kLdDX = P + 4;
  float* sDX = sM + kBI * kLdM;              // kBJ x kLdDX
  float* sCumI = region + kRegion;
  float* sCumJ = sCumI + kBI;

  const int iblk = blockIdx.x % n_iblk;
  const long long cg = blockIdx.x / n_iblk;  // (batch * chunk) * g + group
  const int gi = static_cast<int>(cg % g);
  const long long bc = cg / g;               // batch * chunks + chunk
  const int r = h / g;
  const int i0 = iblk * kBI;
  const int j_end = min(q, i0 + kBI);        // keys any row of I can see
  const int tid = threadIdx.x;

  // ---- S = C_I B_J^T for J < j_end, once for every head of the slice ----
  for (int idx = tid; idx < kBI * n; idx += kThreads) {
    const int i = idx / n, kk = idx % n;
    sC[i * ldC + kk] = i0 + i < q
        ? to_f32(cm[((bc * q + i0 + i) * g + gi) * n + kk]) : 0.f;
  }
  {
    const int rg = tid / 16, cgp = tid % 16;   // rows rg + 16 ii, cols 4 cgp..
    for (int jc = 0; jc < j_end; jc += kBJ) {
      __syncthreads();
      for (int idx = tid; idx < kBJ * n; idx += kThreads) {
        const int jj = idx / n, kk = idx % n;
        sBt[kk * kLdBt + jj] = jc + jj < j_end
            ? to_f32(bm[((bc * q + jc + jj) * g + gi) * n + kk]) : 0.f;
      }
      __syncthreads();
      float acc[4][4] = {};
      for (int kk = 0; kk < n; ++kk) {
        const float4 bv = *reinterpret_cast<const float4*>(sBt + kk * kLdBt + cgp * 4);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const float a = sC[(rg + 16 * ii) * ldC + kk];
          acc[ii][0] = fmaf(a, bv.x, acc[ii][0]);
          acc[ii][1] = fmaf(a, bv.y, acc[ii][1]);
          acc[ii][2] = fmaf(a, bv.z, acc[ii][2]);
          acc[ii][3] = fmaf(a, bv.w, acc[ii][3]);
        }
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          sS[(rg + 16 * ii) * kLdS + jc + cgp * 4 + jj] = acc[ii][jj];
    }
  }

  // ---- per head: Y_I = sum_J (S o L)_IJ (dt X)_J ----
  constexpr int kCG = P / 4;                          // column groups of 4
  constexpr int kRG = kThreads / kCG < kBI ? kThreads / kCG : kBI;
  constexpr int kTR = kBI / kRG;                      // rows per thread
  const bool active = tid < kCG * kRG;
  const int rg = tid / kCG, cgp = tid % kCG;
  for (int hs = 0; hs < kHeads; ++hs) {
    const int hr = blockIdx.y * kHeads + hs;
    if (hr >= r) break;
    const int hd = gi * r + hr;
    __syncthreads();                     // S complete; last head's reads done
    if (tid < kBI)
      sCumI[tid] = i0 + tid < q ? cum[(bc * q + i0 + tid) * h + hd] : 0.f;
    float acc[kTR][4] = {};
    for (int jc = 0; jc < j_end; jc += kBJ) {
      __syncthreads();
      for (int idx = tid; idx < kBJ * P; idx += kThreads) {
        const int jj = idx / P, pp = idx % P;
        float val = 0.f;
        if (jc + jj < j_end) {
          const long long row = (bc * q + jc + jj) * h + hd;
          val = dt[row] * to_f32(x[row * P + pp]);
        }
        sDX[jj * kLdDX + pp] = val;
      }
      if (tid < kBJ)
        sCumJ[tid] = jc + tid < j_end ? cum[(bc * q + jc + tid) * h + hd] : 0.f;
      __syncthreads();
      for (int idx = tid; idx < kBI * kBJ; idx += kThreads) {
        const int i = idx / kBJ, jj = idx % kBJ;
        const int ig = i0 + i, jg = jc + jj;
        sM[i * kLdM + jj] = (ig < q && jg <= ig)
            ? sS[i * kLdS + jg] * expf(sCumI[i] - sCumJ[jj]) : 0.f;
      }
      __syncthreads();
      if (active) {
        for (int jj = 0; jj < kBJ; ++jj) {
          const float4 dv = *reinterpret_cast<const float4*>(sDX + jj * kLdDX + cgp * 4);
#pragma unroll
          for (int ii = 0; ii < kTR; ++ii) {
            const float a = sM[(rg + kRG * ii) * kLdM + jj];
            acc[ii][0] = fmaf(a, dv.x, acc[ii][0]);
            acc[ii][1] = fmaf(a, dv.y, acc[ii][1]);
            acc[ii][2] = fmaf(a, dv.z, acc[ii][2]);
            acc[ii][3] = fmaf(a, dv.w, acc[ii][3]);
          }
        }
      }
    }
    if (active) {
#pragma unroll
      for (int ii = 0; ii < kTR; ++ii) {
        const int ig = i0 + rg + kRG * ii;
        if (ig >= q) continue;
        const long long o = ((bc * q + ig) * h + hd) * P + cgp * 4;
        if (out_bf16) {
          bf16* yo = static_cast<bf16*>(y) + o;
#pragma unroll
          for (int c = 0; c < 4; ++c) yo[c] = __float2bfloat16_rn(acc[ii][c]);
        } else {
          *reinterpret_cast<float4*>(static_cast<float*>(y) + o) =
              make_float4(acc[ii][0], acc[ii][1], acc[ii][2], acc[ii][3]);
        }
      }
    }
  }
}

template <typename T, int P>
int launch(const void* x, const void* dt, const void* cum, const void* b,
           const void* c, void* y, long long nbc, int q, int h, int g, int n,
           int out_bf16, cudaStream_t stream) {
  static bool set = false;
  if (!set) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_diag_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    set = true;
  }
  const int n_iblk = (q + kBI - 1) / kBI;
  const int r = h / g;
  const dim3 grid(static_cast<unsigned>(nbc * g * n_iblk), (r + kHeads - 1) / kHeads);
  ssd_diag_kernel<T, P><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(cum), static_cast<const T*>(b),
      static_cast<const T*>(c), y, out_bf16, q, h, g, n, n_iblk);
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
