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
// Design (bf16, the serve path): warp-specialised, in the shape Hopper's
//   tensor cores want.  A CTA of three warpgroups covers a 128-row q tile
//   of one (batch, head).  Warpgroup 0 is the producer: it gives up its
//   registers (setmaxnreg) and one of its threads loads Q once and then
//   keeps 128-key K and V tiles in flight with TMA, in a ring of kStages
//   stages in shared memory, each stage guarded by a "full" mbarrier (TMA
//   completes its bytes on it) and an "empty" one (the consumers arrive on
//   it when done).  Warpgroups 1 and 2 are consumers, 64 q rows each.  Per
//   tile, S = Q K^T is a wgmma with both operands in shared memory into
//   f32 registers (products of bf16 values are exact in f32, so this is
//   the reference's product up to the order of the sum); the online
//   softmax runs in registers in the wgmma accumulator layout (a row's
//   values lie in the 4 lanes of a quad: max and sum reduce over them with
//   two shuffles); P = exp(s - m) at the tile's running maximum is rounded
//   to bf16 -- as the JAX serve path does (models/flash.py:
//   p.astype(v.dtype)) -- and packed straight into the A-operand registers
//   of O += P V, a wgmma whose B operand V (keys x d, d contiguous, so
//   MN-major) is read through the descriptor's transpose bit.  O, the
//   running maximum m and each lane's share of the sum l stay in f32
//   registers for the whole walk; nothing round-trips through shared
//   memory.  Scores are scaled by 1/sqrt(d) in f32 (times log2 e, so that
//   exp is one exp2) and masked to -1e30 (the Pallas kernel's value) only
//   on tiles that cross the causal diagonal, the window's lower edge or t.  Tiles above the diagonal and behind the
//   window are never loaded (tile_range, as the Pallas kernel's block
//   skip).  The grid puts the q tile slowest and walks it from the last
//   tile down, so the causal tiles with the most work start first and the
//   short ones fill the tail.
//
//   Query position offset (qoff): row i of q is position qoff + i for the
//   causal and window masks and the tile skip, while it is still read and
//   written at row i.  A context-parallel block of q rows [o, o + s) runs
//   against all t keys with qoff = o; qoff 0 computes what the kernel
//   computed before the offset, bit for bit.
//
//   With a non-null lse (the training forward), the consumers also write
//   each row's log-sum-exp, m + log l, in natural-log units: m is kept in
//   log2-scaled units (exp2 above), so it is multiplied by ln 2 first.
//
//   Hazards, and what the design does about each:
//   - TMA swizzle against the wgmma descriptor.  A bf16 row of d 128 is
//     256 B, wider than the 128 B swizzle span, so every tile is loaded as
//     d / 64 boxes ("atoms") of 64 columns, each its own 128-row region of
//     128 B rows written with SWIZZLE_128B; at d 32 and 16 the row is 64 B
//     and 32 B and the swizzle span shrinks to match (SWIZZLE_64B, _32B).
//     The descriptor's layout type is the same swizzle (Swz, tma.cuh), its
//     stride byte offset is 8 rows of the atom, and every region starts on
//     a 1024 B boundary so the hardware's address-based XOR agrees between
//     the two.  A K-major k-step of 16 columns inside an atom advances the
//     start address by 32 B; an MN-major (V) k-step of 16 keys by 16 rows.
//     P V at d 128 is one wgmma of n 128 across both atoms: the leading
//     byte offset of its MN-major descriptor is the atom stride.  S = Q K^T
//     is one wgmma of n 128 a k-step too: two of n 64 would read Q from
//     shared memory twice.
//   - cuTensorMapEncodeTiled is a driver-API function; it is reached
//     through cudaGetDriverEntryPoint, so the library needs no -lcuda, and
//     the maps are __grid_constant__ kernel parameters.  The maps are 4-D
//     (d, heads, positions, batch): a box never crosses into the next
//     batch, TMA zero-fills positions past s or t, and GQA is a coordinate.
//   - setmaxnreg moves registers from the producer (40) to the consumers
//     (232): the launcher checks that ptxas gave the kernel the 168 a thread that this needs and refuses
//     to launch otherwise.
//   - A fault that stalls a barrier would hang the card: every mbarrier
//     wait traps after kWatchdog polls instead.
//   - Build time: the loops over tiles are not unrolled, only those over
//     registers.
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"
#include "wgmma.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr float kNegInf = -1e30f;     // the Pallas kernel's mask value
constexpr int kBQ = 64;               // query rows per CTA (f32 kernel)

// ---- bf16 kernel: shape ----
constexpr int kTile = 128;            // q rows per CTA, keys per KV tile
constexpr int kStages = 2;            // K/V ring depth
constexpr int kThreads = 384;         // producer + two consumer warpgroups
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

__device__ __forceinline__ bool visible(int qpos, int kpos, int t, int causal,
                                        int window) {
  if (kpos >= t) return false;
  if (!causal) return true;
  return kpos <= qpos && (window <= 0 || kpos > qpos - window);
}

// KV tiles [lo, hi) that can hold a visible key for query positions
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

// Shared memory of the bf16 kernel, in bytes from a 1024-aligned base.
template <int D>
struct Smem {
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + Swz<D, kTile>::kTileBytes;
  static constexpr int kV = kK + kStages * Swz<D, kTile>::kTileBytes;
  static constexpr int kBar = kV + kStages * Swz<D, kTile>::kTileBytes;
  // q_full, then full[kStages], then empty[kStages]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      bf16* __restrict__ out, float* __restrict__ lse, int s,
                      int t, int h, int g, int causal, int window, int qoff,
                      float scale) {
  using W = Swz<D, kTile>;
  using L = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTile;   // heaviest first
  const int head = blockIdx.x;
  const int bi = blockIdx.y;
  const int wg = threadIdx.x / 128;
  int lo, hi;
  tile_range(q0 + qoff, kTile, kTile, t, causal, window, &lo, &hi);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 256);          // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (threadIdx.x == 0) {
      const int kvh = head / (h / g);
      mbar_expect_tx(q_full, W::kTileBytes);
      for (int a = 0; a < W::kAtoms; ++a)
        tma_load(smem + L::kQ + a * W::kAtomBytes, &tq, q_full, a * W::kCols,
                 head, q0, bi);
      for (int jt = lo, i = 0; jt < hi; ++jt, ++i) {
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(&empty[st], (i / kStages - 1) & 1);
        mbar_expect_tx(&full[st], 2 * W::kTileBytes);
        for (int a = 0; a < W::kAtoms; ++a) {
          const int off = st * W::kTileBytes + a * W::kAtomBytes;
          tma_load(smem + L::kK + off, &tk, &full[st], a * W::kCols, kvh,
                   jt * kTile, bi);
          tma_load(smem + L::kV + off, &tv, &full[st], a * W::kCols, kvh,
                   jt * kTile, bi);
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int quad = tid % 4;
    const int qw0 = q0 + 64 * c;                         // warpgroup's rows
    const int qpos0 = qw0 + 16 * (tid / 32) + (tid % 32) / 4;
    const int qpos1 = qpos0 + 8;
    const int pw0 = qw0 + qoff;                          // their positions
    constexpr uint32_t kSbo = 8 * W::kBytes;             // 8 rows of an atom
    const uint32_t sq = smem_u32(smem + L::kQ) + 64 * c * W::kBytes;

    // accumulator layout (wgmma m64nN): value 4j + e is row qpos0 (e < 2)
    // or qpos1 (e >= 2), column 8j + 2 quad + (e & 1)
    float sacc[2 * kTile / 4];
    float oacc[D / 2];
    uint32_t pa[kTile / 4];                              // P as bf16 pairs
#pragma unroll
    for (int j = 0; j < D / 2; ++j) oacc[j] = 0.f;
#pragma unroll
    for (int j = 0; j < 2 * kTile / 4; ++j) sacc[j] = 0.f;
    // scores in log2 units: exp(x - m) = exp2(x log2e - m log2e), one FMUL
    // and one MUFU.EX2 an element (expf costs a range reduction more)
    const float sl = scale * 1.4426950408889634f;
    float m0 = kNegInf, m1 = kNegInf;
    float l0 = 0.f, l1 = 0.f;                            // this lane's share

    mbar_wait(q_full, 0);
    for (int jt = lo, i = 0; jt < hi; ++jt, ++i) {
      const int st = i % kStages;
      mbar_wait(&full[st], (i / kStages) & 1);
      const int k0 = jt * kTile;
      const uint32_t sk = smem_u32(smem + L::kK + st * W::kTileBytes);
      const uint32_t sv = smem_u32(smem + L::kV + st * W::kTileBytes);

      // S = Q K^T, one wgmma of n 128 a k-step
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk * 16 / W::kCols) * W::kAtomBytes +
                             (kk * 16 % W::kCols) * 2;
        const uint64_t dq = make_desc(sq + off, 16, kSbo, W::kDescLayout);
        wgmma_ss_n128(sacc, dq, make_desc(sk + off, 16, kSbo, W::kDescLayout),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();

      // online softmax in f32, a row's values in the 4 lanes of a quad
      const bool masked =
          k0 + kTile > t ||
          (causal && (k0 + kTile - 1 > pw0 ||
                      (window > 0 && k0 <= pw0 + 63 - window)));
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < 2 * kTile / 4; ++j) {
        float x = sacc[j] * sl;
        if (masked &&
            !visible(((j & 2) ? qpos1 : qpos0) + qoff,
                     k0 + 8 * (j / 4) + 2 * quad + (j & 1), t, causal, window))
          x = kNegInf;
        sacc[j] = x;
        if (j & 2) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float corr0 = exp2f(m0 - mn0), corr1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < 2 * kTile / 4; j += 2) {
        const float mn = (j & 2) ? mn1 : mn0;
        const float p0 = exp2f(sacc[j] - mn), p1 = exp2f(sacc[j + 1] - mn);
        if (j & 2) sum1 += p0 + p1; else sum0 += p0 + p1;
        // the accumulator pair (j, j + 1) is the A-fragment register j / 2
        pa[j / 2] = pack_bf16(p0, p1);
      }
      l0 = l0 * corr0 + sum0;
      l1 = l1 * corr1 + sum1;
#pragma unroll
      for (int j = 0; j < D / 2; ++j) oacc[j] *= (j & 2) ? corr1 : corr0;

      // O += P V, 16 keys a step; V is MN-major (the transpose bit)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        const uint32_t vk = sv + kk * 16 * W::kBytes;
        wgmma_rs_t<D>(oacc, pa + 4 * kk,
                      make_desc(vk, W::kAtomBytes, kSbo, W::kDescLayout), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      mbar_arrive(&empty[st]);
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
    bf16* o0 = out + ((static_cast<long long>(bi) * s + qpos0) * h + head) * D;
    bf16* o1 = o0 + 8LL * h * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * quad;
      if (qpos0 < s)
        *reinterpret_cast<uint32_t*>(o0 + col) =
            pack_bf16(oacc[4 * j] / den0, oacc[4 * j + 1] / den0);
      if (qpos1 < s)
        *reinterpret_cast<uint32_t*>(o1 + col) =
            pack_bf16(oacc[4 * j + 2] / den1, oacc[4 * j + 3] / den1);
    }
    if (lse != nullptr && quad == 0) {
      constexpr float kLn2 = 0.6931471805599453f;
      float* l_row = lse + (static_cast<long long>(bi) * s + qpos0) * h + head;
      if (qpos0 < s) l_row[0] = m0 * kLn2 + logf(den0);
      if (qpos1 < s) l_row[8LL * h] = m1 * kLn2 + logf(den1);
    }
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
                     float* __restrict__ lse, int s, int t, int h, int g,
                     int causal, int window, int qoff, float scale) {
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
  tile_range(q0 + qoff, kBQ, kF32Keys, t, causal, window, &lo, &hi);
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
      const float x = visible(qpos + qoff, k0 + j, t, causal, window)
                          ? dot * scale : kNegInf;
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
    if (lse != nullptr) lse[(bi * s + qpos) * h + head] = m_run + logf(den);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, int b, int s, int t, int h, int g, int causal,
                int window, int qoff, float scale, cudaStream_t stream) {
  static bool set = false;
  if (!set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Smem<D>::kBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    // setmaxnreg hands the producer's registers to the consumers: the
    // kernel must start with enough for both, or the consumers would wait
    // for registers forever
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, flash_fwd_bf16_kernel<D>);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (attr.numRegs * kThreads < kProducerRegs * 128 + kConsumerRegs * 256)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    set = true;
  }
  CUtensorMap tq, tk, tv;
  if (!make_map<D, kTile>(&tq, q, h, s, b) ||
      !make_map<D, kTile>(&tk, k, g, t, b) ||
      !make_map<D, kTile>(&tv, v, g, t, b))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(h, b, (s + kTile - 1) / kTile);
  flash_fwd_bf16_kernel<D><<<grid, kThreads, Smem<D>::kBytes, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), lse, s, t, h, g, causal, window,
      qoff, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int b, int s, int t, int h, int g, int is_bf16,
           int causal, int window, int qoff, float scale,
           cudaStream_t stream) {
  if (is_bf16)
    return launch_bf16<D>(q, k, v, out, lse, b, s, t, h, g, causal, window,
                          qoff, scale, stream);
  static bool set = false;
  if (!set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        f32_smem_bytes<D>());
    if (e != cudaSuccess) return static_cast<int>(e);
    set = true;
  }
  const dim3 grid((s + kBQ - 1) / kBQ, h, b);
  flash_fwd_f32_kernel<D><<<grid, kBQ, f32_smem_bytes<D>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, s, t, h,
      g, causal, window, qoff, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, out: (b, s, h, d); k, v: (b, t, g, d); all bf16 (is_bf16 = 1) or all
// f32; h % g == 0; d in {16, 32, 64, 128}; window <= 0 means none (and is
// ignored unless causal, as in the Pallas kernel).  lse: null, or f32
// (b, s, h) to receive each row's log-sum-exp (natural log).  qoff >= 0:
// the position of q's first row (the masks' and the tile skip's).
int flash_fwd_launch(const void* q, const void* k, const void* v, void* out,
                     void* lse, int b, int s, int t, int h, int g, int d,
                     int is_bf16, int causal, int window, int qoff,
                     float scale, void* stream) {
  if (b <= 0 || s <= 0 || t <= 0) return 0;
  if (qoff < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (d) {
    case 16: return launch<16>(q, k, v, out, l, b, s, t, h, g, is_bf16, causal, window, qoff, scale, st);
    case 32: return launch<32>(q, k, v, out, l, b, s, t, h, g, is_bf16, causal, window, qoff, scale, st);
    case 64: return launch<64>(q, k, v, out, l, b, s, t, h, g, is_bf16, causal, window, qoff, scale, st);
    case 128: return launch<128>(q, k, v, out, l, b, s, t, h, g, is_bf16, causal, window, qoff, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* cuda_error_name(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
