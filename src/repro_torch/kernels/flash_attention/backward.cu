// Hopper (sm_90a) flash-attention backward.
//
// flash_bwd has no TPU kernel to replace: the reference's backward is an
// XLA custom VJP (repro/models/flash.py:219, _flash_bwd, FlashAttention-2
// recomputation).  It computes what that function computes, in the model
// layout: from q (b,s,h,d), k/v (b,t,g,d), the forward's out (b,s,h,d) and
// row log-sum-exp lse (b,s,h, f32, natural log) and dout (b,s,h,d) it gives
// dq (b,s,h,d) and dk, dv (b,t,g,d), with the query heads of a KV group
// summed into their group (repro/models/flash.py:281-283).  Causal, sliding
// window (causal rows only, as the forward) and full attention; any s and
// t; d in {16, 32, 64, 128}; f32 or bf16.  A query position offset (qoff,
// poff inside) places q's row i at position poff + i for the masks and the
// tile skips, as the forward's: a context-parallel block of q rows against
// every key.  Offset 0 computes what the kernels computed before it.
//
//   D  = rowsum(dO o O)
//   per (q tile x key tile):  S = Q K^T scale, masked as the forward masks;
//     P = exp(S - lse);  dV += P^T dO;  dP = dO V^T;  dS = P o (dP - D) scale;
//     dQ += dS K;  dK += dS^T Q.
//
// Bound: at the Llama 3.2 3B training shape (b 4, s = t = 2048, h 24, g 8,
// d 128, causal) the five products of the algorithm are 2.5 times the
// forward's two, 2.58e11 FLOP on the causal half, against about 170 MB read
// and written: the tensor cores bound it (0.26 ms at 989 TFLOP/s).  The
// two passes below compute S and dP twice, seven products: 3.6e11 FLOP,
// 0.365 ms.
//
// Design (bf16, the training path): flash_fwd's tools (kernel.cu: TMA tiles
// in a ring of stages guarded by mbarriers, 4-D tensor maps, 128 B-swizzled
// atoms, wgmma with the accumulator of one product packed straight into
// the A registers of the next) in two passes, with no float atomics, so GQA
// needs no reduction across CTAs and two calls give the same bits.
//   - flash_bwd_prep_kernel: D = rowsum(dO o O) in f32 and lse log2 e, each
//     written head-major, (b, h, s_pad) with s_pad = s rounded up to kPad
//     and zeros past s, so the rows of a q tile are one contiguous, aligned
//     bulk copy (LSE and D come (b, s, h): a row is one float wide there,
//     too narrow for a TMA box).  D / 8 threads a row, 16 bytes each.
//   - flash_bwd_dkdv_bf16_kernel: one CTA per (KV group, batch, 128-key
//     tile); the grid puts the key tile slowest and walks it from the
//     first, so the heaviest causal CTAs start first.  Two warpgroups, 64
//     keys each.  Thread 0 loads the K and V tiles once and the first
//     kDkdvStages 64-row Q and dO tiles with their rows of log2 LSE and D
//     (TMA for the tiles, bulk copies for the rows, completing on the
//     stage's "full" mbarrier); after that the second warpgroup to be done
//     with a stage refills it (last_of_two: a ticket each, no waiting), so
//     neither waits for the other.  Per q tile, S^T = K Q^T and dP^T =
//     V dO^T are wgmma with both operands in shared memory (Q and dO,
//     d contiguous, are K-major B operands: no transposed copy), so P^T and
//     dS^T come out in the accumulator layout with keys as rows.  P^T =
//     exp2(S^T scale log2 e - lse log2 e) is computed while dP^T is still
//     in flight and packed into the A registers of dV += P^T dO; dS^T =
//     P^T (dP^T - D) scale while dV is in flight, packed for dK += dS^T Q
//     (both wgmma with B, q rows by d, d contiguous, read MN-major through
//     the descriptor's transpose bit).  dK and dV stay in f32 registers
//     over the group's r query heads and every live q tile, in a fixed
//     order, and are written once.  A warpgroup skips the products of a q
//     tile that sees none of its keys (a causal CTA's first, for its upper
//     64 keys).
//   - flash_bwd_dq_bf16_kernel: one CTA per (head, batch, 128-row q tile),
//     walked from the last tile down; two warpgroups of 64 rows.  Q and dO
//     are loaded once, 128-key K and V tiles in a ring of kDqStages,
//     refilled as above; each warpgroup reads its rows' log2 LSE and D
//     once.  Per key tile, S = Q K^T and dP = dO V^T (wgmma from shared
//     memory), P while dP is in flight, dS, then dQ += dS K with K
//     MN-major.  dQ stays in f32 registers and is written once.
//   So S and dP are computed twice (seven products for the algorithm's
//   five): the price of determinism without atomics.  Tiles that the causal
//   mask or the window leave empty are never loaded (key_range, q_range:
//   the reference's `needed` test, flash.py:290-294); the mask is applied
//   in registers only on tiles that cross the diagonal, the window's lower
//   edge, s or t.  P and dS are rounded to bf16 before the products that
//   take them, as flash_fwd rounds P; the reference keeps them in f32
//   (ROADMAP, port difference 4).  Scores in log2 units (one exp2).
//
//   Hazards, and what the design does about each:
//   - Registers.  A dK/dV warpgroup holds dK and dV (128 f32 a thread at
//     d 128) with S^T and dP^T (64) and P^T, dS^T packed (32); a dQ
//     warpgroup dQ (64) with S, dP (128) and dS (32).  flash_fwd's layout,
//     a producer warpgroup that gives its registers to two consumers with
//     setmaxnreg (384 threads), did not hold them: ptxas (CUDA 12.9) kept
//     the consumers of these kernels at the 168 registers a thread of 384
//     threads, spilled the accumulators and serialised every wgmma.  With
//     256 threads a thread may use 255, and ptxas allocates 240 (dK/dV) and
//     218 (dQ) with no spills; the launcher refuses a build that spills.
//   - Descriptors: built once a tile and stepped through the k-steps by a
//     32-bit add of a constant to the address field (desc_add), not rebuilt
//     for each wgmma.
//   - The swizzle: every tile is stored as atoms of 64 columns (the row
//     width for d < 64), each its own 1024-aligned region, as TMA writes
//     them and the wgmma descriptors read them (Swz, tma.cuh).  A K-major
//     k-step of 16 columns advances the start address by 32 B inside an
//     atom (kstep_k); an MN-major k-step of 16 rows by 16 rows, with the
//     atom stride as the descriptor's leading byte offset; a warpgroup's 64
//     keys (rows) of a 128-row tile start 64 rows into each atom (a
//     multiple of the 8-row swizzle period).
//   - LSE and D: see the prep kernel above.
//   - A fault that stalls a barrier would hang the card: every mbarrier
//     wait traps after kWatchdog polls (tma.cuh).  The warpgroups wait for
//     the once-loaded tiles even when they have no step, so no copy is in
//     flight when the CTA exits.
//   - Build time: the loops over tiles are not unrolled, only those over
//     registers.
//
// Design (f32, the f32 smoke configs): on the CUDA cores, one thread per
//   key row (dK/dV) or per query row (dQ), accumulators in shared memory
//   rows of d + 1 floats, D from flash_bwd_dot_kernel in (b, s, h).
//
// C interface for ctypes: flash_bwd_launch returns cudaGetLastError() after
// the three launches (0 on success), on the caller's stream, allocating
// nothing: dvec is the caller's f32 scratch of 2 b h s_pad floats (the f32
// kernels use its first b s h).  Pointers are 16-byte aligned and the
// tensors contiguous (ops.py copies views that are not).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"
#include "wgmma.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// ---- bf16 kernels: shape ----
constexpr int kKeys = 128;        // dK/dV: keys a CTA, 64 a consumer
constexpr int kRows = 64;         // dK/dV: q rows a ring stage
constexpr int kDkdvStages = 3;    // dK/dV: Q/dO ring depth
constexpr int kQRows = 128;       // dQ: q rows a CTA, 64 a consumer
constexpr int kKTile = 128;       // dQ: keys a ring stage
constexpr int kDqStages = 2;      // dQ: K/V ring depth
constexpr int kPad = 128;         // rows of the prep kernel's outputs: s_pad
constexpr int kThreads = 256;     // two warpgroups

// ---- f32 kernels: shape ----
constexpr int kBQ = 64;           // q rows a tile
constexpr int kBK = 64;           // keys a tile
constexpr int kF32Rows = 32;      // rows or keys staged a step

// Whether q row `qrow` (at position qrow + poff) sees key `kpos`.
__device__ __forceinline__ bool visible(int qrow, int poff, int kpos, int s,
                                        int t, int causal, int window) {
  if (qrow >= s || kpos >= t) return false;
  if (!causal) return true;
  const int qpos = qrow + poff;
  return kpos <= qpos && (window <= 0 || kpos > qpos - window);
}

// Key tiles [lo, hi) of `keys` keys that can hold a visible key for query
// positions [q0, q0 + rows): the forward's tile_range.
__device__ __forceinline__ void key_range(int q0, int rows, int keys, int t,
                                          int causal, int window, int* lo,
                                          int* hi) {
  *lo = 0;
  *hi = (t + keys - 1) / keys;
  if (causal) {
    *hi = min(*hi, (q0 + rows - 1) / keys + 1);
    const int first = q0 - window + 1;   // the oldest key row q0 sees
    if (window > 0 && first > 0) *lo = first / keys;
  }
}

// Q tiles [lo, hi) of `rows` rows (row i at position i + poff) holding a
// row that sees a key of [k0, k0 + keys); empty (lo >= hi) when none does.
__device__ __forceinline__ void q_range(int k0, int keys, int rows, int s,
                                        int causal, int window, int poff,
                                        int* lo, int* hi) {
  *lo = 0;
  *hi = (s + rows - 1) / rows;
  if (causal) {
    *lo = max(k0 - poff, 0) / rows;      // earlier rows see none of them
    if (window > 0) {
      // the last row that sees key k0 + keys - 1
      const long long last =
          static_cast<long long>(k0) + keys - 1 + window - 1 - poff;
      *hi = last < 0 ? 0
                     : static_cast<int>(min(static_cast<long long>(*hi),
                                            last / rows + 1));
    }
  }
}

// ---- bf16 kernels ----

// D = rowsum(dO o O) and lse log2 e, each (b, h, s_pad) f32, 0 past s.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const bf16* __restrict__ out,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ dvec,
                      float* __restrict__ lse2, int s, int s_pad, int h,
                      long long rows) {
  constexpr int kLanes = D / 8;          // threads a row, 8 values each
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kLanes;
  const int part = threadIdx.x % kLanes;
  const int p = static_cast<int>(row % s_pad);
  const long long bh = row / s_pad;
  const long long src = (bh / h * s + p) * h + bh % h;   // (b, s, h) row
  const bool in = row < rows && p < s;
  float acc = 0.f;
  if (in) {
    const uint4 o = *reinterpret_cast<const uint4*>(out + src * D + 8 * part);
    const uint4 g = *reinterpret_cast<const uint4*>(dout + src * D + 8 * part);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(o2[i]), b = __bfloat1622float2(g2[i]);
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
    }
  }
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (row < rows && part == 0) {
    dvec[row] = p < s ? acc : 0.f;
    lse2[row] = p < s ? lse[src] * kLog2e : 0.f;
  }
}

// Shared memory of the dK/dV kernel, in bytes from a 1024-aligned base.
template <int D>
struct DkdvSmem {
  using KW = Swz<D, kKeys>;
  using QW = Swz<D, kRows>;
  static constexpr int kK = 0;
  static constexpr int kV = kK + KW::kTileBytes;
  static constexpr int kQ = kV + KW::kTileBytes;            // a tile a stage
  static constexpr int kDO = kQ + kDkdvStages * QW::kTileBytes;
  static constexpr int kL = kDO + kDkdvStages * QW::kTileBytes;  // log2 LSE
  static constexpr int kD = kL + kDkdvStages * kRows * 4;        // D
  static constexpr int kBar = kD + kDkdvStages * kRows * 4;
  // kv_full, then full[kDkdvStages], then the tickets (int[kDkdvStages])
  static constexpr int kBytes = kBar + 8 * (1 + kDkdvStages) +
                                4 * kDkdvStages + 1024;
};

// Shared memory of the dQ kernel, in bytes from a 1024-aligned base.
template <int D>
struct DqSmem {
  using QW = Swz<D, kQRows>;
  using KW = Swz<D, kKTile>;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + QW::kTileBytes;
  static constexpr int kK = kDO + QW::kTileBytes;           // a tile a stage
  static constexpr int kV = kK + kDqStages * KW::kTileBytes;
  static constexpr int kBar = kV + kDqStages * KW::kTileBytes;
  // q_full, then full[kDqStages], then the tickets (int[kDqStages])
  static constexpr int kBytes = kBar + 8 * (1 + kDqStages) +
                                4 * kDqStages + 1024;
};

// Byte offset of K-major k-step kk (16 columns) in a tile of layout W: the
// atom it falls in, then 32 B a step inside the atom.
template <typename W>
__device__ __forceinline__ constexpr uint32_t kstep_k(int kk) {
  return (kk * 16 / W::kCols) * W::kAtomBytes + (kk * 16 % W::kCols) * 2;
}

// Called by each warpgroup's first thread once its warpgroup is done with
// ring stage `st` (its wgmma have completed, so every read of the stage is
// over): true for the second of the two warpgroups, which then refills the
// stage.  Neither warpgroup waits for the other.
__device__ __forceinline__ bool last_of_two(int* tickets, int st) {
  __threadfence_block();
  const bool last = atomicAdd(&tickets[st], 1) & 1;
  __threadfence_block();
  return last;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const float* __restrict__ lse2,
                           const float* __restrict__ dvec,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int s, int s_pad, int t, int h, int g, int causal,
                           int window, int poff, float scale) {
  using KW = Swz<D, kKeys>;
  using QW = Swz<D, kRows>;
  using L = DkdvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = kv_full + 1;
  int* tickets = reinterpret_cast<int*>(full + kDkdvStages);

  const int kvh = blockIdx.x;
  const int bi = blockIdx.y;
  const int k0 = blockIdx.z * kKeys;       // the heaviest causal tiles first
  const int r = h / g;
  int qlo, qhi;
  q_range(k0, kKeys, kRows, s, causal, window, poff, &qlo, &qhi);
  const int per_head = max(qhi - qlo, 0);
  const int steps = r * per_head;        // (head, q tile), head slowest

  // step i's Q and dO tiles and rows of log2 LSE and D into its stage
  auto load_step = [&](int i) {
    const int st = i % kDkdvStages;
    const int hq = kvh * r + i / per_head;
    const int q0 = (qlo + i % per_head) * kRows;
    mbar_expect_tx(&full[st], 2 * QW::kTileBytes + 2 * kRows * 4);
    for (int a = 0; a < QW::kAtoms; ++a) {
      const int off = st * QW::kTileBytes + a * QW::kAtomBytes;
      tma_load(smem + L::kQ + off, &tq, &full[st], a * QW::kCols, hq, q0, bi);
      tma_load(smem + L::kDO + off, &tdo, &full[st], a * QW::kCols, hq, q0,
               bi);
    }
    const long long row = (static_cast<long long>(bi) * h + hq) * s_pad + q0;
    bulk_load(smem + L::kL + st * kRows * 4, lse2 + row, kRows * 4, &full[st]);
    bulk_load(smem + L::kD + st * kRows * 4, dvec + row, kRows * 4, &full[st]);
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int i = 0; i < kDkdvStages; ++i) {
      mbar_init(&full[i], 1);
      tickets[i] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(kv_full, 2 * KW::kTileBytes);
    for (int a = 0; a < KW::kAtoms; ++a) {
      tma_load(smem + L::kK + a * KW::kAtomBytes, &tk, kv_full, a * KW::kCols,
               kvh, k0, bi);
      tma_load(smem + L::kV + a * KW::kAtomBytes, &tv, kv_full, a * KW::kCols,
               kvh, k0, bi);
    }
    for (int i = 0; i < min(steps, kDkdvStages); ++i) load_step(i);
  }
  __syncthreads();

  // two warpgroups, 64 keys each
  const int c = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int quad = tid % 4;
  const int kw0 = k0 + 64 * c;                           // warpgroup's keys
  const int kpos0 = kw0 + 16 * (tid / 32) + (tid % 32) / 4;
  const int kpos1 = kpos0 + 8;
  constexpr uint32_t kSbo = 8 * QW::kBytes;              // 8 rows of an atom
  static_assert(KW::kBytes == QW::kBytes, "one swizzle for every tile");
  // the warpgroup's 64 rows of K and V, as K-major A operands
  const uint64_t dk0 = make_desc(smem_u32(smem + L::kK) + 64 * c * KW::kBytes,
                                 16, kSbo, KW::kDescLayout);
  const uint64_t dv0 = make_desc(smem_u32(smem + L::kV) + 64 * c * KW::kBytes,
                                 16, kSbo, KW::kDescLayout);
  const float sl = scale * kLog2e;

  // accumulator layout (wgmma m64nN): value 4j + e is key kpos0 (e < 2) or
  // kpos1 (e >= 2), column 8j + 2 quad + (e & 1): a q row of S^T and dP^T,
  // a d column of dK and dV
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) dka[j] = dva[j] = 0.f;

  mbar_wait(kv_full, 0);
  for (int i = 0; i < steps; ++i) {
    const int st = i % kDkdvStages;
    const int q0 = (qlo + i % per_head) * kRows;
    const int p0 = q0 + poff;                            // its position
    mbar_wait(&full[st], (i / kDkdvStages) & 1);
    // a q tile that sees none of this warpgroup's keys is skipped
    const bool dead = causal && (kw0 > p0 + kRows - 1 ||
                                 (window > 0 && kw0 + 63 <= p0 - window));
    if (!dead) {
      const uint32_t sq = smem_u32(smem + L::kQ + st * QW::kTileBytes);
      const uint32_t sdo = smem_u32(smem + L::kDO + st * QW::kTileBytes);
      // the tiles as K-major B operands, and as MN-major B operands (the
      // transpose bit)
      const uint64_t dq0 = make_desc(sq, 16, kSbo, QW::kDescLayout);
      const uint64_t ddo0 = make_desc(sdo, 16, kSbo, QW::kDescLayout);
      const uint64_t dq_t = make_desc(sq, QW::kAtomBytes, kSbo,
                                      QW::kDescLayout);
      const uint64_t ddo_t = make_desc(sdo, QW::kAtomBytes, kSbo,
                                       QW::kDescLayout);
      float sacc[kRows / 2], dpacc[kRows / 2];

      // S^T = K Q^T and dP^T = V dO^T, one wgmma of n kRows a k-step each,
      // as two groups
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kRows>(sacc, desc_add(dk0, kstep_k<KW>(kk)),
                        desc_add(dq0, kstep_k<QW>(kk)), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kRows>(dpacc, desc_add(dv0, kstep_k<KW>(kk)),
                        desc_add(ddo0, kstep_k<QW>(kk)), kk > 0);
      wgmma_commit();

      // P^T in f32 (in place) while dP^T is in flight; rounded to bf16 as
      // the A operand of dV += P^T dO, 16 q rows a step, MN-major B
      wgmma_wait<1>();
      const bool masked =
          q0 + kRows > s || kw0 + 64 > t ||
          (causal && (kw0 + 63 > p0 ||
                      (window > 0 && kw0 <= p0 + kRows - 1 - window)));
      const float* lrow =
          reinterpret_cast<const float*>(smem + L::kL + st * kRows * 4);
      const float* drow =
          reinterpret_cast<const float*>(smem + L::kD + st * kRows * 4);
      uint32_t pa[kRows / 4], dsa[kRows / 4];
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j) {
        const int col = 8 * j + 2 * quad;
        const float2 lv = *reinterpret_cast<const float2*>(lrow + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& p = sacc[4 * j + e];
          p = exp2f(p * sl - ((e & 1) ? lv.y : lv.x));
          if (masked && !visible(q0 + col + (e & 1), poff,
                                 (e & 2) ? kpos1 : kpos0, s, t, causal,
                                 window))
            p = 0.f;
        }
        // the accumulator pair (4j, 4j + 1) is A register 2j
        pa[2 * j] = pack_bf16(sacc[4 * j], sacc[4 * j + 1]);
        pa[2 * j + 1] = pack_bf16(sacc[4 * j + 2], sacc[4 * j + 3]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)
        wgmma_rs_t<D>(dva, pa + 4 * kk,
                      desc_add(ddo_t, kk * 16 * QW::kBytes), 1);
      wgmma_commit();

      // dS^T = P^T (dP^T - D) scale while dV is in flight (0 where P^T is
      // masked), rounded to bf16 for dK += dS^T Q
      wgmma_wait<1>();
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j) {
        const float2 dd =
            *reinterpret_cast<const float2*>(drow + 8 * j + 2 * quad);
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[e] = sacc[4 * j + e] *
                  (dpacc[4 * j + e] - ((e & 1) ? dd.y : dd.x)) * scale;
        dsa[2 * j] = pack_bf16(ds[0], ds[1]);
        dsa[2 * j + 1] = pack_bf16(ds[2], ds[3]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)
        wgmma_rs_t<D>(dka, dsa + 4 * kk,
                      desc_add(dq_t, kk * 16 * QW::kBytes), 1);
      wgmma_commit();
      wgmma_wait_all();
    }
    if (tid == 0 && last_of_two(tickets, st) && i + kDkdvStages < steps)
      load_step(i + kDkdvStages);
  }

  bf16* k_row0 = dk + ((static_cast<long long>(bi) * t + kpos0) * g + kvh) * D;
  bf16* v_row0 = dv + ((static_cast<long long>(bi) * t + kpos0) * g + kvh) * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * quad;
    if (kpos0 < t) {
      *reinterpret_cast<uint32_t*>(k_row0 + col) =
          pack_bf16(dka[4 * j], dka[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(v_row0 + col) =
          pack_bf16(dva[4 * j], dva[4 * j + 1]);
    }
    if (kpos1 < t) {
      *reinterpret_cast<uint32_t*>(k_row0 + 8LL * g * D + col) =
          pack_bf16(dka[4 * j + 2], dka[4 * j + 3]);
      *reinterpret_cast<uint32_t*>(v_row0 + 8LL * g * D + col) =
          pack_bf16(dva[4 * j + 2], dva[4 * j + 3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const float* __restrict__ lse2,
                         const float* __restrict__ dvec,
                         bf16* __restrict__ dq, int s, int s_pad, int t, int h,
                         int g, int causal, int window, int poff,
                         float scale) {
  using QW = Swz<D, kQRows>;
  using KW = Swz<D, kKTile>;
  using L = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = q_full + 1;
  int* tickets = reinterpret_cast<int*>(full + kDqStages);

  const int head = blockIdx.x;
  const int bi = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kQRows;   // heaviest first
  const int kvh = head / (h / g);
  int lo, hi;
  key_range(q0 + poff, kQRows, kKTile, t, causal, window, &lo, &hi);
  const int steps = max(hi - lo, 0);

  // key tile lo + i of K and V into step i's stage
  auto load_step = [&](int i) {
    const int st = i % kDqStages;
    mbar_expect_tx(&full[st], 2 * KW::kTileBytes);
    for (int a = 0; a < KW::kAtoms; ++a) {
      const int off = st * KW::kTileBytes + a * KW::kAtomBytes;
      tma_load(smem + L::kK + off, &tk, &full[st], a * KW::kCols, kvh,
               (lo + i) * kKTile, bi);
      tma_load(smem + L::kV + off, &tv, &full[st], a * KW::kCols, kvh,
               (lo + i) * kKTile, bi);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < kDqStages; ++i) {
      mbar_init(&full[i], 1);
      tickets[i] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(q_full, 2 * QW::kTileBytes);
    for (int a = 0; a < QW::kAtoms; ++a) {
      tma_load(smem + L::kQ + a * QW::kAtomBytes, &tq, q_full, a * QW::kCols,
               head, q0, bi);
      tma_load(smem + L::kDO + a * QW::kAtomBytes, &tdo, q_full,
               a * QW::kCols, head, q0, bi);
    }
    for (int i = 0; i < min(steps, kDqStages); ++i) load_step(i);
  }
  __syncthreads();

  // two warpgroups, 64 q rows each
  const int c = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int quad = tid % 4;
  const int qw0 = q0 + 64 * c;                           // warpgroup's rows
  const int qpos0 = qw0 + 16 * (tid / 32) + (tid % 32) / 4;
  const int qpos1 = qpos0 + 8;
  constexpr uint32_t kSbo = 8 * QW::kBytes;              // 8 rows of an atom
  static_assert(KW::kBytes == QW::kBytes, "one swizzle for every tile");
  // the warpgroup's 64 rows of Q and dO, as K-major A operands
  const uint64_t dq0 = make_desc(smem_u32(smem + L::kQ) + 64 * c * QW::kBytes,
                                 16, kSbo, QW::kDescLayout);
  const uint64_t ddo0 = make_desc(
      smem_u32(smem + L::kDO) + 64 * c * QW::kBytes, 16, kSbo,
      QW::kDescLayout);
  const float sl = scale * kLog2e;
  // the rows' log2 LSE and D (rows past s read the zero padding)
  const long long hrow = (static_cast<long long>(bi) * h + head) * s_pad;
  const float l0 = lse2[hrow + qpos0], l1 = lse2[hrow + qpos1];
  const float d0 = dvec[hrow + qpos0], d1 = dvec[hrow + qpos1];

  // accumulator layout (wgmma m64nN): value 4j + e is row qpos0 (e < 2) or
  // qpos1 (e >= 2), column 8j + 2 quad + (e & 1): a key of S and dP, a d
  // column of dQ
  float dqa[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) dqa[j] = 0.f;

  mbar_wait(q_full, 0);
  for (int i = 0; i < steps; ++i) {
    const int st = i % kDqStages;
    const int k0 = (lo + i) * kKTile;
    mbar_wait(&full[st], (i / kDqStages) & 1);
    const uint32_t sk = smem_u32(smem + L::kK + st * KW::kTileBytes);
    const uint32_t sv = smem_u32(smem + L::kV + st * KW::kTileBytes);
    const uint64_t dk0 = make_desc(sk, 16, kSbo, KW::kDescLayout);
    const uint64_t dv0 = make_desc(sv, 16, kSbo, KW::kDescLayout);
    // K as the MN-major B operand of dQ += dS K (the transpose bit)
    const uint64_t dk_t = make_desc(sk, KW::kAtomBytes, kSbo, KW::kDescLayout);
    float sacc[kKTile / 2], dpacc[kKTile / 2];

    // S = Q K^T and dP = dO V^T, one wgmma of n kKTile a k-step each, as two
    // groups
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kKTile>(sacc, desc_add(dq0, kstep_k<QW>(kk)),
                       desc_add(dk0, kstep_k<KW>(kk)), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kKTile>(dpacc, desc_add(ddo0, kstep_k<QW>(kk)),
                       desc_add(dv0, kstep_k<KW>(kk)), kk > 0);
    wgmma_commit();

    // P in f32 (in place) while dP is in flight, then dS = P (dP - D) scale
    // (0 where P is masked), rounded to bf16 as the next A operand
    wgmma_wait<1>();
    const bool masked =
        k0 + kKTile > t ||
        (causal && (k0 + kKTile - 1 > qw0 + poff ||
                    (window > 0 && k0 <= qw0 + poff + 63 - window)));
#pragma unroll
    for (int j = 0; j < kKTile / 2; ++j) {
      const bool hi_row = j & 2;
      float& p = sacc[j];
      p = exp2f(p * sl - (hi_row ? l1 : l0));
      if (masked && !visible(hi_row ? qpos1 : qpos0, poff,
                             k0 + 8 * (j / 4) + 2 * quad + (j & 1), s, t,
                             causal, window))
        p = 0.f;
    }
    wgmma_wait_all();
    uint32_t dsa[kKTile / 4];
#pragma unroll
    for (int j = 0; j < kKTile / 2; j += 2) {
      const float dr = (j & 2) ? d1 : d0;
      dsa[j / 2] = pack_bf16(sacc[j] * (dpacc[j] - dr) * scale,
                             sacc[j + 1] * (dpacc[j + 1] - dr) * scale);
    }

    // dQ += dS K, 16 keys a step; K is MN-major (the transpose bit)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKTile / 16; ++kk)
      wgmma_rs_t<D>(dqa, dsa + 4 * kk, desc_add(dk_t, kk * 16 * KW::kBytes),
                    1);
    wgmma_commit();
    wgmma_wait_all();
    if (tid == 0 && last_of_two(tickets, st) && i + kDqStages < steps)
      load_step(i + kDqStages);
  }

  bf16* row0 = dq + ((static_cast<long long>(bi) * s + qpos0) * h + head) * D;
  bf16* row1 = row0 + 8LL * h * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * quad;
    if (qpos0 < s)
      *reinterpret_cast<uint32_t*>(row0 + col) =
          pack_bf16(dqa[4 * j], dqa[4 * j + 1]);
    if (qpos1 < s)
      *reinterpret_cast<uint32_t*>(row1 + col) =
          pack_bf16(dqa[4 * j + 2], dqa[4 * j + 3]);
  }
}

// ---- f32 kernels: the CUDA cores ----

template <int D>
constexpr int f32_dkdv_smem_bytes() {
  return (4 * kBK * (D + 1) + 2 * kF32Rows * D + 2 * kF32Rows) * 4;
}

template <int D>
constexpr int f32_dq_smem_bytes() {
  return (3 * kBQ * (D + 1) + 2 * kF32Rows * D) * 4;
}

// One thread per key row of a 64-key tile; rows staged 32 at a time.
template <int D>
__global__ void __launch_bounds__(kBK)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dvec,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int s, int t, int h, int g, int causal, int window,
                          int poff, float scale) {
  extern __shared__ __align__(16) float fsm[];
  float* sK = fsm;                           // kBK x (D + 1), a row a thread
  float* sV = sK + kBK * (D + 1);
  float* sdK = sV + kBK * (D + 1);
  float* sdV = sdK + kBK * (D + 1);
  float* sQ = sdV + kBK * (D + 1);           // kF32Rows x D
  float* sO = sQ + kF32Rows * D;
  float* sL = sO + kF32Rows * D;
  float* sD = sL + kF32Rows;

  const int k0 = blockIdx.x * kBK;
  const int kvh = blockIdx.y;
  const long long bi = blockIdx.z;
  const int r = h / g;
  const int kpos = k0 + threadIdx.x;
  float* myK = sK + threadIdx.x * (D + 1);
  float* myV = sV + threadIdx.x * (D + 1);
  float* mydK = sdK + threadIdx.x * (D + 1);
  float* mydV = sdV + threadIdx.x * (D + 1);
  const long long koff = ((bi * t + kpos) * g + kvh) * D;
  for (int c = 0; c < D; ++c) {
    myK[c] = kpos < t ? k[koff + c] : 0.f;
    myV[c] = kpos < t ? v[koff + c] : 0.f;
    mydK[c] = 0.f;
    mydV[c] = 0.f;
  }
  int qlo, qhi;
  q_range(k0, kBK, kBQ, s, causal, window, poff, &qlo, &qhi);
  const int qend = min(qhi * kBQ, s);

  for (int hq = kvh * r; hq < (kvh + 1) * r; ++hq) {
    const long long qoff = bi * s * h + hq;
    for (int q0 = qlo * kBQ; q0 < qend; q0 += kF32Rows) {
      __syncthreads();
      for (int i = threadIdx.x; i < kF32Rows * D; i += kBK) {
        const int row = i / D, c = i % D;
        const bool in = q0 + row < s;
        const long long off = (qoff + static_cast<long long>(q0 + row) * h) * D + c;
        sQ[i] = in ? q[off] : 0.f;
        sO[i] = in ? dout[off] : 0.f;
      }
      for (int i = threadIdx.x; i < kF32Rows; i += kBK) {
        const bool in = q0 + i < s;
        sL[i] = in ? lse[qoff + static_cast<long long>(q0 + i) * h] : 0.f;
        sD[i] = in ? dvec[qoff + static_cast<long long>(q0 + i) * h] : 0.f;
      }
      __syncthreads();
#pragma unroll 1
      for (int j = 0; j < kF32Rows; ++j) {
        if (!visible(q0 + j, poff, kpos, s, t, causal, window)) continue;
        const float* qr = sQ + j * D;
        const float* orow = sO + j * D;
        float sc = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < D; ++c) {
          sc = fmaf(myK[c], qr[c], sc);
          dp = fmaf(myV[c], orow[c], dp);
        }
        const float p = expf(sc * scale - sL[j]);
        const float ds = p * (dp - sD[j]) * scale;
#pragma unroll
        for (int c = 0; c < D; ++c) {
          mydV[c] = fmaf(p, orow[c], mydV[c]);
          mydK[c] = fmaf(ds, qr[c], mydK[c]);
        }
      }
    }
  }
  if (kpos < t) {
    for (int c = 0; c < D; ++c) {
      dk[koff + c] = mydK[c];
      dv[koff + c] = mydV[c];
    }
  }
}

// One thread per query row of a 64-row tile; keys staged 32 at a time.
template <int D>
__global__ void __launch_bounds__(kBQ)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dvec,
                        float* __restrict__ dq, int s, int t, int h, int g,
                        int causal, int window, int poff, float scale) {
  extern __shared__ __align__(16) float fsm[];
  float* sQ = fsm;                           // kBQ x (D + 1), a row a thread
  float* sO = sQ + kBQ * (D + 1);
  float* sdQ = sO + kBQ * (D + 1);
  float* sK = sdQ + kBQ * (D + 1);           // kF32Rows x D
  float* sV = sK + kF32Rows * D;

  const int q0 = blockIdx.x * kBQ;
  const int hq = blockIdx.y;
  const long long bi = blockIdx.z;
  const int kvh = hq / (h / g);
  const int qpos = q0 + threadIdx.x;
  const long long qoff = ((bi * s + qpos) * h + hq) * D;
  const long long koff = bi * t * g + kvh;
  float* myQ = sQ + threadIdx.x * (D + 1);
  float* myO = sO + threadIdx.x * (D + 1);
  float* mydQ = sdQ + threadIdx.x * (D + 1);
  for (int c = 0; c < D; ++c) {
    myQ[c] = qpos < s ? q[qoff + c] : 0.f;
    myO[c] = qpos < s ? dout[qoff + c] : 0.f;
    mydQ[c] = 0.f;
  }
  const long long lrow = (bi * s + qpos) * h + hq;
  const float lq = qpos < s ? lse[lrow] : 0.f;
  const float dq_d = qpos < s ? dvec[lrow] : 0.f;
  int lo, hi;
  key_range(q0 + poff, kBQ, kBK, t, causal, window, &lo, &hi);
  const int kend = min(hi * kBK, t);

  for (int k0 = lo * kBK; k0 < kend; k0 += kF32Rows) {
    __syncthreads();
    for (int i = threadIdx.x; i < kF32Rows * D; i += kBQ) {
      const int row = i / D, c = i % D;
      const bool in = k0 + row < t;
      const long long off = (koff + static_cast<long long>(k0 + row) * g) * D + c;
      sK[i] = in ? k[off] : 0.f;
      sV[i] = in ? v[off] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < kF32Rows; ++j) {
      if (!visible(qpos, poff, k0 + j, s, t, causal, window)) continue;
      const float* kr = sK + j * D;
      const float* vr = sV + j * D;
      float sc = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        sc = fmaf(myQ[c], kr[c], sc);
        dp = fmaf(myO[c], vr[c], dp);
      }
      const float p = expf(sc * scale - lq);
      const float ds = p * (dp - dq_d) * scale;
#pragma unroll
      for (int c = 0; c < D; ++c) mydQ[c] = fmaf(ds, kr[c], mydQ[c]);
    }
  }
  if (qpos < s)
    for (int c = 0; c < D; ++c) dq[qoff + c] = mydQ[c];
}

// D = rowsum(dO o O) in f32, one warp a (b, s, h) row.
__global__ void flash_bwd_dot_kernel(const float* __restrict__ out,
                                     const float* __restrict__ dout,
                                     float* __restrict__ dvec, long long rows,
                                     int d) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;                   // the whole warp
  float acc = 0.f;
  for (int c = lane; c < d; c += 32)
    acc = fmaf(out[row * d + c], dout[row * d + c], acc);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) dvec[row] = acc;
}

template <typename K>
cudaError_t opt_in(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// A bf16 kernel whose accumulators ptxas spilled to local memory would run
// several times slower (and ptxas serialises its wgmma): refuse to launch
// it rather than be slow in silence.
template <typename K>
cudaError_t check_no_spills(K kernel) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  return attr.localSizeBytes == 0 ? cudaSuccess
                                  : cudaErrorInvalidConfiguration;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* out,
                const void* dout, const float* lse, float* dvec, void* dq,
                void* dk, void* dv, int b, int s, int t, int h, int g,
                int causal, int window, int poff, float scale,
                cudaStream_t stream) {
  static bool set = false;
  if (!set) {
    cudaError_t e = opt_in(flash_bwd_dkdv_bf16_kernel<D>, DkdvSmem<D>::kBytes);
    if (e == cudaSuccess)
      e = opt_in(flash_bwd_dq_bf16_kernel<D>, DqSmem<D>::kBytes);
    if (e == cudaSuccess) e = check_no_spills(flash_bwd_dkdv_bf16_kernel<D>);
    if (e == cudaSuccess) e = check_no_spills(flash_bwd_dq_bf16_kernel<D>);
    if (e != cudaSuccess) return static_cast<int>(e);
    set = true;
  }
  // boxes of kRows (dK/dV) and kQRows (dQ) rows of Q and dO, kKeys (dK/dV)
  // and kKTile (dQ) keys of K and V
  CUtensorMap tq_r, tdo_r, tk_k, tv_k, tq_q, tdo_q, tk_t, tv_t;
  if (!make_map<D, kRows>(&tq_r, q, h, s, b) ||
      !make_map<D, kRows>(&tdo_r, dout, h, s, b) ||
      !make_map<D, kKeys>(&tk_k, k, g, t, b) ||
      !make_map<D, kKeys>(&tv_k, v, g, t, b) ||
      !make_map<D, kQRows>(&tq_q, q, h, s, b) ||
      !make_map<D, kQRows>(&tdo_q, dout, h, s, b) ||
      !make_map<D, kKTile>(&tk_t, k, g, t, b) ||
      !make_map<D, kKTile>(&tv_t, v, g, t, b))
    return static_cast<int>(cudaErrorInvalidValue);
  const int s_pad = (s + kPad - 1) / kPad * kPad;
  const long long rows = 1LL * b * h * s_pad;
  float* lse2 = dvec + rows;
  const int prep_blocks = static_cast<int>((rows * (D / 8) + 255) / 256);
  flash_bwd_prep_kernel<D><<<prep_blocks, 256, 0, stream>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), lse,
      dvec, lse2, s, s_pad, h, rows);
  flash_bwd_dq_bf16_kernel<D>
      <<<dim3(h, b, (s + kQRows - 1) / kQRows), kThreads, DqSmem<D>::kBytes,
         stream>>>(tq_q, tdo_q, tk_t, tv_t, lse2, dvec, static_cast<bf16*>(dq),
                   s, s_pad, t, h, g, causal, window, poff, scale);
  flash_bwd_dkdv_bf16_kernel<D>
      <<<dim3(g, b, (t + kKeys - 1) / kKeys), kThreads, DkdvSmem<D>::kBytes,
         stream>>>(tq_r, tdo_r, tk_k, tv_k, lse2, dvec, static_cast<bf16*>(dk),
                   static_cast<bf16*>(dv), s, s_pad, t, h, g, causal, window,
                   poff, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* dvec, void* dq,
           void* dk, void* dv, int b, int s, int t, int h, int g, int is_bf16,
           int causal, int window, int poff, float scale,
           cudaStream_t stream) {
  if (is_bf16)
    return launch_bf16<D>(q, k, v, out, dout, lse, dvec, dq, dk, dv, b, s, t,
                          h, g, causal, window, poff, scale, stream);
  static bool set = false;
  if (!set) {
    cudaError_t e = opt_in(flash_bwd_dkdv_f32_kernel<D>, f32_dkdv_smem_bytes<D>());
    if (e == cudaSuccess) e = opt_in(flash_bwd_dq_f32_kernel<D>, f32_dq_smem_bytes<D>());
    if (e != cudaSuccess) return static_cast<int>(e);
    set = true;
  }
  const long long rows = 1LL * b * s * h;
  const int dot_blocks = static_cast<int>((rows + 7) / 8);
  const dim3 gq((s + kBQ - 1) / kBQ, h, b), gk((t + kBK - 1) / kBK, g, b);
  const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v), *fo = static_cast<const float*>(dout);
  flash_bwd_dot_kernel<<<dot_blocks, 256, 0, stream>>>(
      static_cast<const float*>(out), fo, dvec, rows, D);
  flash_bwd_dq_f32_kernel<D><<<gq, kBQ, f32_dq_smem_bytes<D>(), stream>>>(
      fq, fk, fv, fo, lse, dvec, static_cast<float*>(dq), s, t, h, g, causal,
      window, poff, scale);
  flash_bwd_dkdv_f32_kernel<D><<<gk, kBK, f32_dkdv_smem_bytes<D>(), stream>>>(
      fq, fk, fv, fo, lse, dvec, static_cast<float*>(dk),
      static_cast<float*>(dv), s, t, h, g, causal, window, poff, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, out, dout, dq: (b, s, h, d); k, v, dk, dv: (b, t, g, d); all bf16
// (is_bf16 = 1) or all f32; lse: (b, s, h) f32; dvec: f32 scratch of
// 2 b h s_pad floats, s_pad = s rounded up to 128; h % g == 0; d in
// {16, 32, 64, 128}; window <= 0 means none (and is ignored unless causal);
// qoff >= 0: the position of q's first row, as flash_fwd_launch's.
int flash_bwd_launch(const void* q, const void* k, const void* v,
                     const void* out, const void* dout, const void* lse,
                     void* dvec, void* dq, void* dk, void* dv, int b, int s,
                     int t, int h, int g, int d, int is_bf16, int causal,
                     int window, int qoff, float scale, void* stream) {
  if (b <= 0 || s <= 0 || t <= 0) return 0;
  if (qoff < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dd = static_cast<float*>(dvec);
  switch (d) {
    case 16: return launch<16>(q, k, v, out, dout, l, dd, dq, dk, dv, b, s, t, h, g, is_bf16, causal, window, qoff, scale, st);
    case 32: return launch<32>(q, k, v, out, dout, l, dd, dq, dk, dv, b, s, t, h, g, is_bf16, causal, window, qoff, scale, st);
    case 64: return launch<64>(q, k, v, out, dout, l, dd, dq, dk, dv, b, s, t, h, g, is_bf16, causal, window, qoff, scale, st);
    case 128: return launch<128>(q, k, v, out, dout, l, dd, dq, dk, dv, b, s, t, h, g, is_bf16, causal, window, qoff, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* cuda_error_name(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
