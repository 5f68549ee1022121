// Hopper (sm_90a) flash-attention forward.
//
// flash_fwd replaces repro/kernels/flash_attention/kernel.py:_flash_fwd_kernel
//   (flash_fwd_pallas): online-softmax attention over KV tiles, causal and
//   sliding-window block bounds, output acc / max(l, 1e-30) in q's dtype,
//   scale 1/sqrt(d).  It takes the model layout, q (b,s,h,d) and k/v
//   (b,t,g,d): a CTA reads KV head head / (h/g) directly, so GQA needs no
//   repeated copy of K and V.  Any s and t: rows past s are not written,
//   keys past t are masked (the Pallas kernel asserts s, t % 128 == 0).
//
// Bound: at the Llama 3.2 3B prefill shape (b 4, s 2048, h 24, d 128,
//   causal) the work is 4*b*h*s*s*d/2 = 1.03e11 FLOP against 134 MB read
//   and written, so the tensor cores bound it (104 us at 989 TFLOP/s, the
//   bytes 40 us).
//
// Design (bf16, the serve path): one CTA of 4 warps per (b, head, 64-row
//   q tile); each warp owns 16 query rows.  Q stays in registers as WMMA
//   fragments; 64-key K and V tiles are staged through shared memory.  Per
//   tile S = Q K^T (WMMA bf16 16x16x16, f32 accumulate: products of bf16
//   values are exact in f32, so this is the reference's product up to the
//   order of the sum), then a pair of lanes per row runs the online softmax
//   in f32, and O += P V on WMMA with P rounded to bf16 -- as the JAX serve
//   path does (models/flash.py: p.astype(v.dtype)), not as the Pallas
//   kernel, which keeps P in f32.  The running sum l adds the f32 P.  The
//   f32 accumulator lives in shared memory so that each row can be
//   rescaled by exp(m_old - m_new) between tiles.  Tiles above the diagonal
//   and behind the window are skipped by bounding the loop, as the Pallas
//   kernel does; inside a tile the mask is the Pallas kernel's.  Simple and
//   unpipelined (no TMA, no wgmma, no cp.async): the perf PR's work.
//
// Design (f32, off the serve path of a bf16 model; the f32 smoke configs
//   and the kernel sweeps run it): one thread per query row, 64 rows per
//   CTA, 32-key K/V tiles in shared memory, scores, softmax and P V in f32
//   on the CUDA cores, the row's accumulator in registers.
//
// C interface for ctypes: the launcher returns cudaGetLastError() after the
// launch (0 on success), on the caller's stream, allocating nothing.
// Pointers are 16-byte aligned and the tensors contiguous (ops.py copies
// views that are not); ops.py launches nothing for empty inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr float kNegInf = -1e30f;     // the Pallas kernel's mask value
constexpr int kBQ = 64;               // query rows per CTA
constexpr int kBK = 64;               // keys per tile (bf16 kernel)
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = kWarps * 32;

// Shared-memory layout of the bf16 kernel, in bytes; rows padded by 16
// bytes against bank conflicts, every WMMA tile 32-byte aligned.
template <int D>
struct Layout {
  static constexpr int kLdQ = D + 8;    // bf16, Q/K/V rows
  static constexpr int kLdS = kBK + 4;  // f32 scores
  static constexpr int kLdP = kBK + 8;  // bf16 probabilities
  static constexpr int kLdO = D + 4;    // f32 accumulator
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBQ * kLdQ * 2;
  static constexpr int kV = kK + kBK * kLdQ * 2;
  static constexpr int kS = kV + kBK * kLdQ * 2;
  static constexpr int kP = kS + kBQ * kLdS * 4;
  static constexpr int kO = kP + kBQ * kLdP * 2;
  static constexpr int kBytes = kO + kBQ * kLdO * 4;
};

__device__ __forceinline__ bool visible(int qpos, int kpos, int t, int causal,
                                        int window) {
  if (kpos >= t) return false;
  if (!causal) return true;
  return kpos <= qpos && (window <= 0 || kpos > qpos - window);
}

// KV tiles [lo, hi) that can hold a visible key for query rows
// [q0, q0 + rows): the Pallas kernel's block skip.
__device__ __forceinline__ void tile_range(int q0, int rows, int tile, int t,
                                           int causal, int window, int* lo,
                                           int* hi) {
  *lo = 0;
  *hi = (t + tile - 1) / tile;
  if (causal) {
    *hi = min(*hi, (q0 + rows - 1) / tile + 1);
    const int first = q0 - window + 1;   // the oldest key row q0 sees
    if (window > 0 && first > 0) *lo = first / tile;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      int s, int t, int h, int g, int causal, int window,
                      float scale) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::kQ);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::kK);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::kV);
  float* sS = reinterpret_cast<float*>(smem + L::kS);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::kP);
  float* sO = reinterpret_cast<float*>(smem + L::kO);

  const int q0 = blockIdx.x * kBQ;
  const int head = blockIdx.y;
  const long long bi = blockIdx.z;
  const int kvh = head / (h / g);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  constexpr int kVec = D / 8;           // 16-byte vectors per row

  for (int i = threadIdx.x; i < kBQ * kVec; i += kThreads) {
    const int row = i / kVec, c = i % kVec;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + row < s)
      val = reinterpret_cast<const uint4*>(
          q + ((bi * s + q0 + row) * h + head) * D)[c];
    *reinterpret_cast<uint4*>(sQ + row * L::kLdQ + c * 8) = val;
  }
  float* sOw = sO + warp * 16 * L::kLdO;
  for (int i = lane; i < 16 * L::kLdO; i += 32) sOw[i] = 0.f;
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fq[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(fq[kk], sQ + warp * 16 * L::kLdQ + kk * 16, L::kLdQ);

  // lanes 2r and 2r+1 share query row r of this warp's 16
  const int row = lane >> 1, half = lane & 1;
  const int qpos = q0 + warp * 16 + row;
  float* srow = sS + (warp * 16 + row) * L::kLdS;
  bf16* prow = sP + (warp * 16 + row) * L::kLdP;
  float* orow = sOw + row * L::kLdO;
  float m_run = kNegInf, l_run = 0.f;

  int lo, hi;
  tile_range(q0, kBQ, kBK, t, causal, window, &lo, &hi);
  for (int jt = lo; jt < hi; ++jt) {
    const int k0 = jt * kBK;
    __syncthreads();                     // every warp is done with the last tile
    for (int i = threadIdx.x; i < kBK * kVec; i += kThreads) {
      const int r = i / kVec, c = i % kVec;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
      if (k0 + r < t) {
        const long long off = ((bi * t + k0 + r) * g + kvh) * D;
        kv = reinterpret_cast<const uint4*>(k + off)[c];
        vv = reinterpret_cast<const uint4*>(v + off)[c];
      }
      *reinterpret_cast<uint4*>(sK + r * L::kLdQ + c * 8) = kv;
      *reinterpret_cast<uint4*>(sV + r * L::kLdQ + c * 8) = vv;
    }
    __syncthreads();

#pragma unroll
    for (int n = 0; n < kBK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fk;
        wmma::load_matrix_sync(fk, sK + n * 16 * L::kLdQ + kk * 16, L::kLdQ);
        wmma::mma_sync(acc, fq[kk], fk, acc);
      }
      wmma::store_matrix_sync(sS + warp * 16 * L::kLdS + n * 16, acc, L::kLdS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    float sc[kBK / 2];
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const int c = half + 2 * i;
      const float x = srow[c] * scale;
      sc[i] = visible(qpos, k0 + c, t, causal, window) ? x : kNegInf;
      mx = fmaxf(mx, sc[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    const float corr = expf(m_run - m_new);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const float p = expf(sc[i] - m_new);
      sum += p;
      prow[half + 2 * i] = __float2bfloat16_rn(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = l_run * corr + sum;
    m_run = m_new;
    for (int c = half; c < D; c += 2) orow[c] *= corr;
    __syncwarp();

    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp[kBK / 16];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wmma::load_matrix_sync(fp[kk], sP + warp * 16 * L::kLdP + kk * 16, L::kLdP);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sOw + n * 16, L::kLdO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fv;
        wmma::load_matrix_sync(fv, sV + kk * 16 * L::kLdQ + n * 16, L::kLdQ);
        wmma::mma_sync(acc, fp[kk], fv, acc);
      }
      wmma::store_matrix_sync(sOw + n * 16, acc, L::kLdO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (qpos < s) {
    bf16* o = out + ((bi * s + qpos) * h + head) * D;
    const float den = fmaxf(l_run, 1e-30f);
    for (int c = half; c < D; c += 2) o[c] = __float2bfloat16_rn(orow[c] / den);
  }
}

constexpr int kF32Keys = 32;          // keys per tile (f32 kernel)
constexpr int kF32LdS = kF32Keys + 1; // per-thread score row, padded

template <int D>
constexpr int f32_smem_bytes() {
  return (kBQ * (D + 1) + 2 * kF32Keys * D + kBQ * kF32LdS) * 4;
}

template <int D>
__global__ void __launch_bounds__(kBQ)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int s, int t, int h, int g, int causal, int window,
                     float scale) {
  extern __shared__ __align__(16) float fsm[];
  float* sQ = fsm;                           // kBQ x (D + 1)
  float* sK = sQ + kBQ * (D + 1);            // kF32Keys x D
  float* sV = sK + kF32Keys * D;
  float* sSc = sV + kF32Keys * D;            // kBQ x kF32LdS scores

  const int q0 = blockIdx.x * kBQ;
  const int head = blockIdx.y;
  const long long bi = blockIdx.z;
  const int kvh = head / (h / g);
  for (int i = threadIdx.x; i < kBQ * D; i += kBQ) {
    const int r = i / D, c = i % D;
    sQ[r * (D + 1) + c] =
        q0 + r < s ? q[((bi * s + q0 + r) * h + head) * D + c] : 0.f;
  }
  const int qpos = q0 + threadIdx.x;
  const float* qrow = sQ + threadIdx.x * (D + 1);
  float* sc = sSc + threadIdx.x * kF32LdS;
  // the accumulator stays in registers: only the loops over d unroll, the
  // loops over keys do not (fully unrolled, they cost minutes of nvcc)
  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;
  float m_run = kNegInf, l_run = 0.f;

  int lo, hi;
  tile_range(q0, kBQ, kF32Keys, t, causal, window, &lo, &hi);
  for (int jt = lo; jt < hi; ++jt) {
    const int k0 = jt * kF32Keys;
    __syncthreads();
    for (int i = threadIdx.x; i < kF32Keys * D; i += kBQ) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < t;
      const long long off = ((bi * t + k0 + r) * g + kvh) * D + c;
      sK[i] = in ? k[off] : 0.f;
      sV[i] = in ? v[off] : 0.f;
    }
    __syncthreads();

    float mx = kNegInf;
#pragma unroll 1
    for (int j = 0; j < kF32Keys; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) dot = fmaf(qrow[c], sK[j * D + c], dot);
      const float x = visible(qpos, k0 + j, t, causal, window) ? dot * scale
                                                             : kNegInf;
      sc[j] = x;
      mx = fmaxf(mx, x);
    }
    const float m_new = fmaxf(m_run, mx);
    const float corr = expf(m_run - m_new);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] *= corr;
#pragma unroll 1
    for (int j = 0; j < kF32Keys; ++j) {
      const float p = expf(sc[j] - m_new);
      sum += p;
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] = fmaf(p, sV[j * D + c], acc[c]);
    }
    l_run = l_run * corr + sum;
    m_run = m_new;
  }

  if (qpos < s) {
    float* o = out + ((bi * s + qpos) * h + head) * D;
    const float den = fmaxf(l_run, 1e-30f);
#pragma unroll
    for (int c = 0; c < D; ++c) o[c] = acc[c] / den;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int s, int t, int h, int g, int is_bf16, int causal, int window,
           float scale, cudaStream_t stream) {
  const dim3 grid((s + kBQ - 1) / kBQ, h, b);
  if (is_bf16) {
    static bool set = false;
    if (!set) {
      cudaError_t e = cudaFuncSetAttribute(
          flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          Layout<D>::kBytes);
      if (e != cudaSuccess) return static_cast<int>(e);
      set = true;
    }
    flash_fwd_bf16_kernel<D><<<grid, kThreads, Layout<D>::kBytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), s, t, h, g,
        causal, window, scale);
  } else {
    static bool set = false;
    if (!set) {
      cudaError_t e = cudaFuncSetAttribute(
          flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          f32_smem_bytes<D>());
      if (e != cudaSuccess) return static_cast<int>(e);
      set = true;
    }
    flash_fwd_f32_kernel<D><<<grid, kBQ, f32_smem_bytes<D>(), stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), s, t, h, g,
        causal, window, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, out: (b, s, h, d); k, v: (b, t, g, d); all bf16 (is_bf16 = 1) or all
// f32; h % g == 0; d in {16, 32, 64, 128}; window <= 0 means none (and is
// ignored unless causal, as in the Pallas kernel).
int flash_fwd_launch(const void* q, const void* k, const void* v, void* out,
                     int b, int s, int t, int h, int g, int d, int is_bf16,
                     int causal, int window, float scale, void* stream) {
  if (b <= 0 || s <= 0 || t <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(q, k, v, out, b, s, t, h, g, is_bf16, causal, window, scale, st);
    case 32: return launch<32>(q, k, v, out, b, s, t, h, g, is_bf16, causal, window, scale, st);
    case 64: return launch<64>(q, k, v, out, b, s, t, h, g, is_bf16, causal, window, scale, st);
    case 128: return launch<128>(q, k, v, out, b, s, t, h, g, is_bf16, causal, window, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* cuda_error_name(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
