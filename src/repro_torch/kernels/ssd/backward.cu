// Hopper (sm_90a) backward of the SSD (Mamba2) intra-chunk diagonal block.
//
// ssd_diag_bwd has no TPU kernel to replace: the reference differentiates
//   its XLA einsums (repro/models/ssm.py).  Per (batch, chunk, group) and
//   each head of the group, with i a row and j a key of the chunk, j <= i:
//
//     S_ij = C_i . B_j        L_ij = exp(cum_i - cum_j)     m_ij = S_ij L_ij
//     M_ij = m_ij dt_j        Y_i  = sum_j M_ij X_j
//
//   Given dY (f32), it writes the gradients of all five inputs:
//
//     U_j    = sum_i m_ij dY_i                 dX_j = dt_j U_j
//     dM_ij  = dY_i . X_j                      d(dt)_j = X_j . U_j
//     G_ij   = dM_ij m_ij dt_j                 d(cum)_i = sum_j G_ij - dt_i d(dt)_i
//     dS_ij  = sum over the group's heads of dM_ij L_ij dt_j
//     dC_i   = sum_j dS_ij B_j                 dB_j = sum_i dS_ij C_i
//
//   (the column sum of G at i is dt_i sum_k dM_ki m_ki = dt_i d(dt)_i), all
//   in f32 as the plain version (ref.py under autograd) computes them; dX,
//   dB, dC in the inputs' dtype, d(dt), d(cum) in f32.  The model layout:
//   x, dY (b,c,q,h,p), dt/cum (b,c,q,h), B/C (b,c,q,g,n), h = g * r.
//
// Bound: at the Mamba2 2.7B training shape (b 4, c 8, q 256, g 1, h 80,
//   p 64, n 128) the causal products dM = dY X^T and U = m^T dY are
//   2.15e10 FLOP with 5.4e8 for dB and dC; the bytes (x, B, C, dX, dB, dC
//   in bf16, dt, cum, their gradients and dY in f32: about 354 MB) take
//   0.106 ms, the operations 0.045 ms at 495 TFLOP/s.  So the bytes bound
//   it.  This design computes each f32 product in two or three TF32
//   products on mma.sync, reads dY once per key block J <= I (about 420 MB
//   at that shape) and writes and reads about 40 MB of partial sums.  On an
//   H100 it took 0.920 ms (11.5% of the bound) against 12.66 ms for
//   autograd of the plain version, timed in turns; the steps of the head loop, not the bytes, set
//   its time: 8 warps an SM (the shared memory below) wait on mma.sync and
//   shared-memory latency.
//
// Design: two kernels, no float atomics, so two calls give the same bits.
//   - ssd_bwd_kernel: one CTA per (batch * chunk, group, 64-key block J,
//     slice of kHeads heads of the group); the grid puts J slowest and
//     walks it from the first, which has the most row blocks I >= J, so
//     the heavy CTAs start first.  At the Mamba2 shape that is 256 CTAs of
//     40 heads, 160 to 40 (head, I) steps each (slices of 20 took 14% longer:
//     each slice pays for S and for dB's and dC's shares).  The CTA
//     computes S_{I>=J, J} = C B_J^T once into shared memory (256 x 64 f32)
//     and keeps it for every head of the slice, since the r heads of a
//     group share it.  L comes from cum in registers, masked to -inf before
//     exp as the forward masks it.  No q x q tensor reaches device memory.
//     Per head it walks I = J, J + 1, ...: 8 warps, warp w owns keys
//     16 (w % 4) .. +16 of J and half the rows of I (w / 4).
//       1. dM^T = X_J dY_I^T on the tensor cores, in the accumulator
//          layout with keys as rows.
//       2. Each thread takes its accumulator's elements: m, G and
//          dM L dt from S (shared), cum and dt; it adds dM L dt into dS
//          in shared memory (each element has one owner thread, so the sum
//          over the slice's heads is in head order) and sums G over its
//          keys for the row sums (then across the warp with shuffles, and
//          across the four key groups in shared memory, in a fixed order).
//       3. U_J += m^T dY_I with m straight from those registers: the
//          accumulator's columns 2t, 2t + 1 are the A fragment's k slots t,
//          t + 4 when dY's rows are read in the same order.
//     After a head's last I the two row halves' U are added through the
//     stage that the step has finished with; dX = dt U and d(dt) = X . U
//     are written once, and so is the head's row sums of G over J.  dY_I
//     and cum_I stream in with cp.async a step ahead, X_J, dt_J and cum_J
//     with a head's first step into the other of two head buffers.  After
//     the last head, S's shared memory takes B_J and a 64-row block C_I at
//     a time (C_{I+1} streams in while dC_I is computed), and the slice's
//     shares of dB_J = dS^T C and of each dC_I = dS_IJ B_J go on the tensor
//     cores to a workspace (reading B and C from device memory inside the
//     product loop instead cost a quarter of the kernel's time).
//   - ssd_bwd_finish_kernel sums the workspace in a fixed order: dB over
//     the slices, dC over the slices and the key blocks J <= I, the row
//     sums of G over J, and subtracts dt d(dt) for d(cum).
//
// Precision, as the forward's: an f32 operand goes through the tensor cores
//   split into TF32 hi + lo (split_tf32; truncating instead of rounding
//   was 5% faster, but its errors all lean one way and, summed, reached
//   0.68 of KERNEL_TOL with f32 inputs in the CPU emulation).  bf16 X, B,
//   C are exact in TF32, so
//   dM = X (dY_hi + dY_lo), dB and dC take two products (2xTF32); U = m^T dY
//   has two f32 factors and takes three (3xTF32: hi.hi, hi.lo, lo.hi); f32
//   inputs take three everywhere.  S from bf16 B, C is a bf16 product with
//   f32 accumulation (exact products).  A single TF32 or bf16 rounding of
//   an f32 operand misses KERNEL_TOL (tests/test_torch_kernels_zoo.py).
//
// C interface for ctypes: ssd_bwd_workspace gives the floats of workspace a
// shape needs; ssd_bwd_launch launches both kernels on the caller's stream,
// allocating nothing, and returns cudaGetLastError() (0 on success).  The
// tensors are contiguous and 16-byte aligned (ops.py copies views that are
// not); ops.py launches nothing for empty inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kBJ = 64;          // keys per CTA
constexpr int kBI = 64;          // rows per step
constexpr int kThreads = 256;    // 8 warps: 4 key groups x 2 row halves
constexpr int kHeads = 40;       // heads per CTA
constexpr int kMaxQ = 256;       // chunk length
constexpr int kMaxN = 128;       // state size
constexpr int kLdS = kBJ + 4;    // f32 row stride of S and dS, against conflicts
constexpr int kLdN = kMaxN + 8;  // row stride (elements) of staged B and C rows

// Shared memory, in bytes: S and dS (rows i >= j0 of the chunk, keys of J),
// the row sums of G of the four key groups, two head buffers (X_J, dt_J,
// cum_J) and two step stages (dY_I, cum_I).
template <typename T, int P>
struct Smem {
  static constexpr int kLdX = sizeof(T) == 2 ? P + 8 : P + 4;
  static constexpr int kLdY = P + 4;
  static constexpr int kXBytes = kBJ * kLdX * sizeof(T);   // 16-byte multiple
  static constexpr int kHeadBytes = kXBytes + 2 * kBJ * 4;
  static constexpr int kYBytes = kBI * kLdY * 4;
  static constexpr int kStepBytes = kYBytes + kBI * 4;
  static constexpr int kS = 0;
  static constexpr int kDS = kS + kMaxQ * kLdS * 4;
  static constexpr int kRow = kDS + kMaxQ * kLdS * 4;
  static constexpr int kHead = kRow + 4 * kMaxQ * 4;
  static constexpr int kStep = kHead + 2 * kHeadBytes;
  static constexpr int kBytes = kStep + 2 * kStepBytes;
  // after the heads, B_J and one block C_I take S's place
  static_assert(2 * kBJ * kLdN * sizeof(T) <= kMaxQ * kLdS * 4, "B, C staging");
};

// a bf16 or f32 value as f32 (a bf16 is exact in f32 and in TF32)
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

__device__ __forceinline__ void st_one(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void st_one(float* p, float v) { *p = v; }

// two adjacent outputs, in T
__device__ __forceinline__ void st_pair(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void st_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

// rows r0 .. r0 + 64 of group gi of a (nbc, q, g, n) matrix into shared
// memory with row stride kLdN, zero past q and past n up to a multiple of 8;
// whole 16-byte pieces by cp.async (committed), the rest by plain loads
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, long long bc,
                                           int r0, int q, int g, int gi,
                                           int n) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  int from = 0;                              // first column loaded one by one
  if (n % kPer == 0) {
    const int vec = n / kPer;
    for (int idx = threadIdx.x; idx < kBJ * vec; idx += kThreads) {
      const int rr = idx / vec, cc = idx % vec;
      const bool in = r0 + rr < q;
      cp_async16(dst + rr * kLdN + cc * kPer,
                 src + ((bc * q + (in ? r0 + rr : 0)) * g + gi) * n + cc * kPer,
                 in);
    }
    from = n;
  }
  const int w = ((n + 7) & ~7) - from;
  for (int idx = threadIdx.x; idx < kBJ * w; idx += kThreads) {
    const int rr = idx / w, cc = from + idx % w;
    const int row = r0 + rr;
    st_one(dst + rr * kLdN + cc,
           row < q ? ld_elem(src + ((bc * q + row) * g + gi) * n, cc, n) : 0.f);
  }
  cp_async_commit();
}

// acc[nt] += A (16 rows x 8 k, given as f32 values av) times rows k and
// k + 4 of a staged (k x n) block (rk: row k), columns nb + 8 nt + gq
template <typename T>
__device__ __forceinline__ void mma_staged(float (*acc)[4], const float* av,
                                           const T* rk, int nb, int n,
                                           int gq) {
  uint32_t ahi[4], alo[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(av[e], ahi[e], alo[e]);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nb + nt * 8 >= n) continue;
    const int col = nb + nt * 8 + gq;
    const float b0 = to_f32(rk[col]), b1 = to_f32(rk[4 * kLdN + col]);
    if constexpr (sizeof(T) == 2) {
      const uint32_t b[2] = {__float_as_uint(b0), __float_as_uint(b1)};
      mma_b_2xtf32(acc[nt], ahi, alo, b);
    } else {
      uint32_t bhi[2], blo[2];
      split_tf32(b0, bhi[0], blo[0]);
      split_tf32(b1, bhi[1], blo[1]);
      mma_3xtf32(acc[nt], ahi, alo, bhi, blo);
    }
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ cum, const T* __restrict__ bm,
               const T* __restrict__ cm, const float* __restrict__ dy,
               T* __restrict__ dx, float* __restrict__ ddt,
               float* __restrict__ rowp, float* __restrict__ dbp,
               float* __restrict__ dcp, int q, int h, int g, int n,
               int n_jblk, int n_slices) {
  using L = Smem<T, P>;
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char sm[];
  float* sS = reinterpret_cast<float*>(sm + L::kS);
  float* sdS = reinterpret_cast<float*>(sm + L::kDS);
  float* sRow = reinterpret_cast<float*>(sm + L::kRow);

  // J block slowest, from the first (most work) up
  const int per_j = gridDim.x / n_jblk;
  const int jblk = static_cast<int>(blockIdx.x / per_j);
  const int rest = blockIdx.x % per_j;       // ((bc * g) + gi) * n_slices + slice
  const int slice = rest % n_slices;
  const int gi = (rest / n_slices) % g;
  const long long bc = (rest / n_slices) / g;  // batch * chunks + chunk
  const int r = h / g;
  const int j0 = jblk * kBJ;
  const int n_ib = n_jblk - jblk;            // row blocks I >= J
  const int n_rows = n_ib * kBI;             // rows j0 .. of S and dS
  const int h0 = gi * r + slice * kHeads;    // first head of the slice
  const int n_steps = min(kHeads, r - slice * kHeads) * n_ib;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rw = warp % 4, kh = warp / 4;    // 16-key group, row half
  const int gq = lane / 4, tq = lane % 4;    // mma group and thread in group
  const int jl0 = 16 * rw + gq, jl1 = jl0 + 8;   // this thread's keys of J

  // stage dY_I, cum_I of step (head, I) into stage step % 2, and with a
  // head's first step X_J, dt_J, cum_J into head buffer head % 2; a step
  // past the last commits an empty group
  auto prefetch = [&](int step) {
    if (step >= n_steps) {
      cp_async_commit();
      return;
    }
    const int hl = step / n_ib, ib = step % n_ib;
    const int hd = h0 + hl;
    const int i0 = j0 + ib * kBI;
    unsigned char* st = sm + L::kStep + (step % 2) * L::kStepBytes;
    float* sy = reinterpret_cast<float*>(st);
    constexpr int kVecY = P / 4;
    for (int idx = threadIdx.x; idx < kBI * kVecY; idx += kThreads) {
      const int ii = idx / kVecY, cc = idx % kVecY;
      const bool in = i0 + ii < q;
      cp_async16(sy + ii * L::kLdY + cc * 4,
                 dy + ((bc * q + (in ? i0 + ii : 0)) * h + hd) * P + cc * 4,
                 in);
    }
    if (threadIdx.x < kBI) {
      const bool in = i0 + threadIdx.x < q;
      cp_async4(reinterpret_cast<float*>(st + L::kYBytes) + threadIdx.x,
                cum + (bc * q + (in ? i0 + threadIdx.x : 0)) * h + hd, in);
    }
    if (ib == 0) {
      unsigned char* hb = sm + L::kHead + (hl % 2) * L::kHeadBytes;
      T* sx = reinterpret_cast<T*>(hb);
      constexpr int kVecX = P * static_cast<int>(sizeof(T)) / 16;
      constexpr int kPer = 16 / static_cast<int>(sizeof(T));
      for (int idx = threadIdx.x; idx < kBJ * kVecX; idx += kThreads) {
        const int jj = idx / kVecX, cc = idx % kVecX;
        const bool in = j0 + jj < q;
        cp_async16(sx + jj * L::kLdX + cc * kPer,
                   x + ((bc * q + (in ? j0 + jj : 0)) * h + hd) * P + cc * kPer,
                   in);
      }
      if (threadIdx.x < 2 * kBJ) {           // dt, then cum
        const int jj = threadIdx.x % kBJ;
        const bool in = j0 + jj < q;
        cp_async4(reinterpret_cast<float*>(hb + L::kXBytes) + threadIdx.x,
                  (threadIdx.x < kBJ ? dt : cum) +
                      (bc * q + (in ? j0 + jj : 0)) * h + hd,
                  in);
      }
    }
    cp_async_commit();
  };
  prefetch(0);

  for (int idx = threadIdx.x; idx < n_rows * kLdS; idx += kThreads)
    sdS[idx] = 0.f;

  // ---- S_{i, j} = C_i . B_j for rows i >= j0 and the keys of J, once ----
  for (int rg = warp; rg < n_rows / 16; rg += kThreads / 32) {
    const int r0 = j0 + 16 * rg + gq, r1 = r0 + 8;
    const T* c0 = r0 < q ? cm + ((bc * q + r0) * g + gi) * n : nullptr;
    const T* c1 = r1 < q ? cm + ((bc * q + r1) * g + gi) * n : nullptr;
    float acc[8][4] = {};
    const T* brow[8];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int key = j0 + nt * 8 + gq;
      brow[nt] = key < q ? bm + ((bc * q + key) * g + gi) * n : nullptr;
    }
    mma_cbt<8>(acc, c0, c1, brow, n, tq);
    const int s0 = 16 * rg + gq, s1 = s0 + 8;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = nt * 8 + 2 * tq;
      sS[s0 * kLdS + col] = acc[nt][0];
      sS[s0 * kLdS + col + 1] = acc[nt][1];
      sS[s1 * kLdS + col] = acc[nt][2];
      sS[s1 * kLdS + col + 1] = acc[nt][3];
    }
  }

  // ---- per head and row block I >= J ----
  float uacc[P / 8][4];      // U of keys jl0, jl1 over this warp's rows
  float dt0 = 0.f, dt1 = 0.f, cj0 = 0.f, cj1 = 0.f;
  for (int step = 0; step < n_steps; ++step) {
    const int hl = step / n_ib, ib = step % n_ib;
    const int hd = h0 + hl;
    const int i0 = j0 + ib * kBI;
    cp_async_wait_all();      // this thread's copies of the step landed
    __syncthreads();          // everyone's; S written; step - 1 consumed
    prefetch(step + 1);       // into the stage step - 1 used
    float* sy = reinterpret_cast<float*>(sm + L::kStep + (step % 2) * L::kStepBytes);
    const float* scum = sy + L::kYBytes / 4;
    const unsigned char* hb = sm + L::kHead + (hl % 2) * L::kHeadBytes;
    const T* sx = reinterpret_cast<const T*>(hb);
    if (ib == 0) {
#pragma unroll
      for (int nt = 0; nt < P / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) uacc[nt][e] = 0.f;
      const float* sdt = reinterpret_cast<const float*>(hb + L::kXBytes);
      dt0 = sdt[jl0];
      dt1 = sdt[jl1];
      cj0 = sdt[kBJ + jl0];
      cj1 = sdt[kBJ + jl1];
    }

    // 1. dM^T = X_J dY_I^T: keys jl0, jl1 by this warp's 32 rows
    float acc[4][4] = {};
#pragma unroll 2
    for (int kk = 0; kk < P / 8; ++kk) {
      const int pc = kk * 8 + tq;
      const T xa[4] = {sx[jl0 * L::kLdX + pc], sx[jl1 * L::kLdX + pc],
                       sx[jl0 * L::kLdX + pc + 4], sx[jl1 * L::kLdX + pc + 4]};
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kBf16)
          ahi[e] = static_cast<uint32_t>(__bfloat16_as_ushort(xa[e])) << 16;
        else
          split_tf32(to_f32(xa[e]), ahi[e], alo[e]);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* yr = sy + (kh * 32 + t * 8 + gq) * L::kLdY + pc;
        uint32_t bhi[2], blo[2];
        split_tf32(yr[0], bhi[0], blo[0]);
        split_tf32(yr[4], bhi[1], blo[1]);
        if constexpr (kBf16)
          mma_a_2xtf32(acc[t], ahi, bhi, blo);
        else
          mma_3xtf32(acc[t], ahi, alo, bhi, blo);
      }
    }

    // 2., 3. per 8 rows: m, G and dS from the accumulator, then U += m^T dY
    float grow[4][2];         // sum of G over keys jl0, jl1, per row
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int il = kh * 32 + t * 8 + 2 * tq;   // rows il, il + 1 of I
      float mv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ii = il + (e & 1);
        const int ig = i0 + ii;
        const int jl = e < 2 ? jl0 : jl1;
        const float dtj = e < 2 ? dt0 : dt1;
        const int srow = ig - j0;
        // masked before exp: for j > i the exponent is positive and can
        // overflow, and 0 * inf would be NaN where the plain version has 0
        const float lv =
            expf(j0 + jl <= ig && ig < q ? scum[ii] - (e < 2 ? cj0 : cj1)
                                         : -INFINITY);
        const float m = sS[srow * kLdS + jl] * lv;
        const float dm = acc[t][e];
        sdS[srow * kLdS + jl] += dm * lv * dtj;
        mv[e] = m;
        acc[t][e] = dm * m * dtj;              // G
      }
      grow[t][0] = acc[t][0] + acc[t][2];
      grow[t][1] = acc[t][1] + acc[t][3];
      // A fragment: k slot tq <- row il, slot tq + 4 <- row il + 1
      uint32_t ahi[4], alo[4];
      split_tf32(mv[0], ahi[0], alo[0]);
      split_tf32(mv[2], ahi[1], alo[1]);
      split_tf32(mv[1], ahi[2], alo[2]);
      split_tf32(mv[3], ahi[3], alo[3]);
      const float* y0 = sy + il * L::kLdY + gq;
#pragma unroll
      for (int nt = 0; nt < P / 8; ++nt) {
        uint32_t bhi[2], blo[2];
        split_tf32(y0[nt * 8], bhi[0], blo[0]);
        split_tf32(y0[L::kLdY + nt * 8], bhi[1], blo[1]);
        mma_3xtf32(uacc[nt], ahi, alo, bhi, blo);
      }
    }
    // G's sums over this warp's 16 keys, per row, into the key group's slot
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float v = grow[t][c];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (gq == 0)
          sRow[rw * kMaxQ + ib * kBI + kh * 32 + t * 8 + 2 * tq + c] = v;
      }

    if (ib == n_ib - 1) {     // the head's last block: finish the head
      __syncthreads();        // the stage's dY and every row sum are done
      float* sRed = sy;       // the second row half's U, in the free stage
      if (kh == 1) {
#pragma unroll
        for (int nt = 0; nt < P / 8; ++nt) {
          const int col = nt * 8 + 2 * tq;
          sRed[jl0 * L::kLdY + col] = uacc[nt][0];
          sRed[jl0 * L::kLdY + col + 1] = uacc[nt][1];
          sRed[jl1 * L::kLdY + col] = uacc[nt][2];
          sRed[jl1 * L::kLdY + col + 1] = uacc[nt][3];
        }
      }
      // the head's row sums of G over J: the four key groups in order
      for (int idx = threadIdx.x; idx < n_rows; idx += kThreads) {
        if (j0 + idx >= q) break;
        rowp[((bc * n_jblk + jblk) * h + hd) * q + j0 + idx] =
            ((sRow[idx] + sRow[kMaxQ + idx]) + sRow[2 * kMaxQ + idx]) +
            sRow[3 * kMaxQ + idx];
      }
      __syncthreads();
      if (kh == 0) {
        float dd0 = 0.f, dd1 = 0.f;
#pragma unroll
        for (int nt = 0; nt < P / 8; ++nt) {
          const int col = nt * 8 + 2 * tq;
          const float u00 = uacc[nt][0] + sRed[jl0 * L::kLdY + col];
          const float u01 = uacc[nt][1] + sRed[jl0 * L::kLdY + col + 1];
          const float u10 = uacc[nt][2] + sRed[jl1 * L::kLdY + col];
          const float u11 = uacc[nt][3] + sRed[jl1 * L::kLdY + col + 1];
          dd0 = fmaf(to_f32(sx[jl0 * L::kLdX + col]), u00, dd0);
          dd0 = fmaf(to_f32(sx[jl0 * L::kLdX + col + 1]), u01, dd0);
          dd1 = fmaf(to_f32(sx[jl1 * L::kLdX + col]), u10, dd1);
          dd1 = fmaf(to_f32(sx[jl1 * L::kLdX + col + 1]), u11, dd1);
          if (j0 + jl0 < q)
            st_pair(dx + ((bc * q + j0 + jl0) * h + hd) * P + col, dt0 * u00,
                    dt0 * u01);
          if (j0 + jl1 < q)
            st_pair(dx + ((bc * q + j0 + jl1) * h + hd) * P + col, dt1 * u10,
                    dt1 * u11);
        }
        dd0 += __shfl_xor_sync(0xffffffffu, dd0, 1);
        dd0 += __shfl_xor_sync(0xffffffffu, dd0, 2);
        dd1 += __shfl_xor_sync(0xffffffffu, dd1, 1);
        dd1 += __shfl_xor_sync(0xffffffffu, dd1, 2);
        if (tq == 0 && j0 + jl0 < q) ddt[(bc * q + j0 + jl0) * h + hd] = dd0;
        if (tq == 0 && j0 + jl1 < q) ddt[(bc * q + j0 + jl1) * h + hd] = dd1;
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();            // dS summed over the slice's heads; S is free

  // ---- the slice's shares of dB_J = dS^T C and of dC_I = dS_IJ B_J for each
  //      I >= J, from B_J and C_I staged in S's place; C_{I+1} streams in
  //      while dC_I is computed ----
  T* sB = reinterpret_cast<T*>(sm + L::kS);
  T* sC = sB + kBJ * kLdN;
  const long long part = (bc * g + gi) * n_slices + slice;
  const int nb = kh * 64;                   // this warp's half of the state
  stage_rows(sB, bm, bc, j0, q, g, gi, n);
  stage_rows(sC, cm, bc, j0, q, g, gi, n);
  float dbacc[8][4] = {};                   // dB of keys jl0, jl1
  for (int ib = 0; ib < n_ib; ++ib) {
    cp_async_wait_all();
    __syncthreads();                        // C_I staged
#pragma unroll 2
    for (int k = 0; k < kBI; k += 8) {
      const int sr = ib * kBI + k + tq;     // rows of dS
      const float av[4] = {sdS[sr * kLdS + jl0], sdS[sr * kLdS + jl1],
                           sdS[(sr + 4) * kLdS + jl0],
                           sdS[(sr + 4) * kLdS + jl1]};
      mma_staged(dbacc, av, sC + (k + tq) * kLdN, nb, n, gq);
    }
    __syncthreads();                        // C_I consumed
    if (ib + 1 < n_ib) stage_rows(sC, cm, bc, j0 + (ib + 1) * kBI, q, g, gi, n);
    const int s0 = ib * kBI + 16 * rw + gq, s1 = s0 + 8;   // rows of dS
    float acc[8][4] = {};
#pragma unroll 2
    for (int k = 0; k < kBJ; k += 8) {
      const float av[4] = {sdS[s0 * kLdS + k + tq], sdS[s1 * kLdS + k + tq],
                           sdS[s0 * kLdS + k + tq + 4],
                           sdS[s1 * kLdS + k + tq + 4]};
      mma_staged(acc, av, sB + (k + tq) * kLdN, nb, n, gq);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = nb + nt * 8 + 2 * tq;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = j0 + (e < 2 ? s0 : s1), cl = col + (e & 1);
        if (i < q && cl < n)
          dcp[((part * n_jblk + jblk) * q + i) * n + cl] = acc[nt][e];
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = nb + nt * 8 + 2 * tq;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + (e < 2 ? jl0 : jl1), cl = col + (e & 1);
      if (j < q && cl < n) dbp[(part * q + j) * n + cl] = dbacc[nt][e];
    }
  }
}

// dB, dC and d(cum) from the workspace, each sum in a fixed order
template <typename T>
__global__ void __launch_bounds__(256)
ssd_bwd_finish_kernel(const float* __restrict__ rowp,
                      const float* __restrict__ dbp,
                      const float* __restrict__ dcp,
                      const float* __restrict__ dt,
                      const float* __restrict__ ddt, T* __restrict__ db,
                      T* __restrict__ dc, float* __restrict__ dcum,
                      long long nbc, int q, int h, int g, int n, int n_jblk,
                      int n_slices) {
  const long long n_bn = nbc * q * g * n, n_all = n_bn + nbc * q * h;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < n_all; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (idx < n_bn) {                  // idx = ((bc * q + i) * g + gi) * n + col
      const int col = static_cast<int>(idx % n);
      const long long rg = idx / n;
      const int gi = static_cast<int>(rg % g);
      const int i = static_cast<int>((rg / g) % q);
      const long long bc = rg / g / q;
      float sb = 0.f, sc = 0.f;
      for (int s = 0; s < n_slices; ++s) {
        const long long part = (bc * g + gi) * n_slices + s;
        sb += dbp[(part * q + i) * n + col];
        for (int jb = 0; jb <= i / kBI; ++jb)
          sc += dcp[((part * n_jblk + jb) * q + i) * n + col];
      }
      st_one(db + idx, sb);
      st_one(dc + idx, sc);
    } else {                           // k = (bc * q + i) * h + hd
      const long long k = idx - n_bn;
      const int hd = static_cast<int>(k % h);
      const int i = static_cast<int>((k / h) % q);
      const long long bc = k / h / q;
      float s = 0.f;
      for (int jb = 0; jb <= i / kBI; ++jb)
        s += rowp[((bc * n_jblk + jb) * h + hd) * q + i];
      dcum[k] = s - dt[k] * ddt[k];
    }
  }
}

// floats of workspace: row sums of G (nbc, n_jblk, h, q), dB's shares
// (nbc, g, n_slices, q, n) and dC's (nbc, g, n_slices, n_jblk, q, n)
struct Work {
  long long row, db, dc;
  Work(long long nbc, int q, int h, int g, int n) {
    const long long n_jblk = (q + kBJ - 1) / kBJ;
    const long long n_slices = (h / g + kHeads - 1) / kHeads;
    row = nbc * n_jblk * h * q;
    db = nbc * g * n_slices * q * n;
    dc = db * n_jblk;
  }
  long long total() const { return row + db + dc; }
};

template <typename T, int P>
int launch(const void* x, const void* dt, const void* cum, const void* b,
           const void* c, const void* dy, void* dx, void* ddt, void* dcum,
           void* db, void* dc, float* work, long long nbc, int q, int h,
           int g, int n, cudaStream_t stream) {
  using L = Smem<T, P>;
  static bool set = false;
  if (!set) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_bwd_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::kBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    set = true;
  }
  const int n_jblk = (q + kBJ - 1) / kBJ;
  const int n_slices = (h / g + kHeads - 1) / kHeads;
  const long long blocks = nbc * g * n_slices * n_jblk;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const Work w(nbc, q, h, g, n);
  float* rowp = work;
  float* dbp = rowp + w.row;
  float* dcp = dbp + w.db;
  ssd_bwd_kernel<T, P><<<static_cast<unsigned>(blocks), kThreads, L::kBytes,
                         stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(cum), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const float*>(dy),
      static_cast<T*>(dx), static_cast<float*>(ddt), rowp, dbp, dcp, q, h, g,
      n, n_jblk, n_slices);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n_all = nbc * q * (static_cast<long long>(g) * n + h);
  const long long fin = (n_all + 255) / 256;
  ssd_bwd_finish_kernel<T><<<static_cast<unsigned>(fin < 8192 ? fin : 8192),
                             256, 0, stream>>>(
      rowp, dbp, dcp, static_cast<const float*>(dt),
      static_cast<const float*>(ddt), static_cast<T*>(db), static_cast<T*>(dc),
      static_cast<float*>(dcum), nbc, q, h, g, n, n_jblk, n_slices);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_p(const void* x, const void* dt, const void* cum, const void* b,
             const void* c, const void* dy, void* dx, void* ddt, void* dcum,
             void* db, void* dc, float* work, long long nbc, int q, int h,
             int g, int n, int p, cudaStream_t stream) {
  switch (p) {
    case 8: return launch<T, 8>(x, dt, cum, b, c, dy, dx, ddt, dcum, db, dc, work, nbc, q, h, g, n, stream);
    case 16: return launch<T, 16>(x, dt, cum, b, c, dy, dx, ddt, dcum, db, dc, work, nbc, q, h, g, n, stream);
    case 32: return launch<T, 32>(x, dt, cum, b, c, dy, dx, ddt, dcum, db, dc, work, nbc, q, h, g, n, stream);
    case 64: return launch<T, 64>(x, dt, cum, b, c, dy, dx, ddt, dcum, db, dc, work, nbc, q, h, g, n, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// floats of f32 workspace that ssd_bwd_launch needs at this shape
long long ssd_bwd_workspace(long long nbc, int q, int h, int g, int n) {
  if (nbc <= 0 || q <= 0 || h <= 0 || g <= 0 || h % g) return 0;
  return Work(nbc, q, h, g, n).total();
}

// x, dx: (nbc, q, h, p) and b, c, db, dc: (nbc, q, g, n) in bf16 (in_bf16 =
// 1) or f32; dt, cum, ddt, dcum: (nbc, q, h) f32; dy: (nbc, q, h, p) f32;
// work: ssd_bwd_workspace(...) floats.  nbc = batch * chunks; q <= 256,
// n <= 128, p in {8, 16, 32, 64}, h % g == 0.
int ssd_bwd_launch(const void* x, const void* dt, const void* cum,
                   const void* b, const void* c, const void* dy, void* dx,
                   void* ddt, void* dcum, void* db, void* dc, void* work,
                   long long nbc, int q, int h, int g, int n, int p,
                   int in_bf16, void* stream) {
  if (nbc <= 0 || q <= 0 || h <= 0) return 0;
  if (q > kMaxQ || n > kMaxN || n <= 0 || g <= 0 || h % g)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  if (in_bf16)
    return launch_p<bf16>(x, dt, cum, b, c, dy, dx, ddt, dcum, db, dc, w, nbc, q, h, g, n, p, st);
  return launch_p<float>(x, dt, cum, b, c, dy, dx, ddt, dcum, db, dc, w, nbc, q, h, g, n, p, st);
}

const char* cuda_error_name(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
