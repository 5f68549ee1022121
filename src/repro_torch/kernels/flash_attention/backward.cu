// Hopper (sm_90a) flash-attention backward.
//
// flash_bwd has no TPU kernel to replace: the reference's backward is an
// XLA custom VJP (repro/models/flash.py:_flash_bwd, FlashAttention-2
// recomputation).  It computes what that function computes, in the model
// layout: from q (b,s,h,d), k/v (b,t,g,d), the forward's out (b,s,h,d) and
// row log-sum-exp lse (b,s,h, f32, natural log) and dout (b,s,h,d) it gives
// dq (b,s,h,d) and dk, dv (b,t,g,d), with the query heads of a KV group
// summed into their group (repro/models/flash.py:281-283).  Causal, sliding
// window (causal rows only, as the forward) and full attention; any s and
// t; d in {16, 32, 64, 128}; f32 or bf16.
//
//   D  = rowsum(dO o O)                  (f32, flash_bwd_dot_kernel)
//   per (q tile x key tile):  S = Q K^T scale, masked as the forward masks;
//     P = exp(S - lse);  dV += P^T dO;  dP = dO V^T;  dS = P o (dP - D) scale;
//     dQ += dS K;  dK += dS^T Q.
//
// Bound: at the Llama 3.2 3B training shape (b 4, s = t = 2048, h 24, g 8,
// d 128, causal) the five products of the algorithm are 2.5 times the
// forward's two, 2.58e11 FLOP on the causal half, against about 170 MB read
// and written: the tensor cores bound it (0.26 ms at 989 TFLOP/s).
//
// Design (a simple kernel that is right; wgmma and TMA are later work):
//   - No float atomics, so the backward is deterministic and GQA needs no
//     reduction across CTAs.  flash_bwd_dkdv_*: one CTA per (batch, KV
//     group, 64-key tile) walks the group's r query heads and every live
//     64-row q tile in a fixed order, accumulating dK and dV in f32
//     registers, and writes them once.  flash_bwd_dq_*: one CTA per
//     (batch, head, 64-row q tile) walks its live key tiles.  So S and dP
//     are computed twice (seven products for the algorithm's five).
//   - Tiles that the causal mask or the window leave empty are skipped, as
//     the reference's `needed` test does (flash.py:290-294): key_range and
//     q_range below.
//   - bf16: every product on the tensor cores, mma.sync m16n8k16 with bf16
//     operands and f32 accumulation; 4 warps, 16 rows each.  In the dK/dV
//     kernel a warp owns 16 keys and computes S^T = K Q^T and dP^T = V dO^T,
//     so P^T and dS^T come out in the accumulator layout, rounded to bf16
//     and packed straight into the A fragments of dV += P^T dO and
//     dK += dS^T Q (the accumulator of two n8 tiles is the A fragment of
//     one k16 step).  In the dQ kernel a warp owns 16 q rows and dS feeds
//     dQ += dS K the same way.  B operands that need the transpose of a
//     row-major tile (dO and Q for dV and dK, K for dQ) are read with
//     ldmatrix.trans; the others with 32-bit loads.  Tiles live in shared
//     memory with rows padded by 8 elements (16 B), which makes both
//     conflict-free.  P and dS are rounded to bf16 before the products
//     that take them, as flash_fwd rounds P; the reference keeps them in
//     f32 (ROADMAP, port difference 4).  Scores in log2 units (one exp2).
//   - f32: on the CUDA cores, one thread per key row (dK/dV) or per query
//     row (dQ), accumulators in shared memory rows of d + 1 floats.
//
// C interface for ctypes: flash_bwd_launch returns cudaGetLastError() after
// the three launches (0 on success), on the caller's stream, allocating
// nothing (dvec is the caller's (b,s,h) f32 scratch).  Pointers are 16-byte
// aligned and the tensors contiguous (ops.py copies views that are not).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kBQ = 64;        // q rows per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // bf16 kernels: 4 warps of 16 rows
constexpr int kF32Rows = 32;   // f32 kernels: rows or keys staged per step
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ bool visible(int qpos, int kpos, int s, int t,
                                        int causal, int window) {
  if (qpos >= s || kpos >= t) return false;
  if (!causal) return true;
  return kpos <= qpos && (window <= 0 || kpos > qpos - window);
}

// Key tiles [lo, hi) that can hold a visible key for rows [q0, q0 + kBQ):
// the forward's tile_range.
__device__ __forceinline__ void key_range(int q0, int t, int causal,
                                          int window, int* lo, int* hi) {
  *lo = 0;
  *hi = (t + kBK - 1) / kBK;
  if (causal) {
    *hi = min(*hi, (q0 + kBQ - 1) / kBK + 1);
    const int first = q0 - window + 1;   // the oldest key row q0 sees
    if (window > 0 && first > 0) *lo = first / kBK;
  }
}

// Q tiles [lo, hi) holding a row that sees a key of [k0, k0 + kBK).
__device__ __forceinline__ void q_range(int k0, int s, int causal, int window,
                                        int* lo, int* hi) {
  *lo = 0;
  *hi = (s + kBQ - 1) / kBQ;
  if (causal) {
    *lo = k0 / kBQ;                      // earlier rows see none of them
    if (window > 0) {
      // the last row that sees key k0 + kBK - 1
      const long long last = static_cast<long long>(k0) + kBK - 1 + window - 1;
      *hi = static_cast<int>(min(static_cast<long long>(*hi), last / kBQ + 1));
    }
  }
}

// ---- bf16 kernels: mma.sync m16n8k16, fragments from shared memory ----

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment (16 x 16) at rows r0.., columns c0.. of a row-major tile:
// register 0 is (row g, cols 2t, 2t+1), 1 row g + 8, 2 cols + 8, 3 both.
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* s, int ld,
                                       int r0, int c0, int lane) {
  const bf16* p = s + (r0 + lane / 4) * ld + c0 + 2 * (lane % 4);
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
}

// B fragment (k16 x n8) with B[k][n] = s[(n0 + n) * ld + k0 + k]: a tile
// whose rows are B's columns (K or V for S = Q K^T, dP = dO V^T).
__device__ __forceinline__ void load_b(uint32_t* b, const bf16* s, int ld,
                                       int n0, int k0, int lane) {
  const bf16* p = s + (n0 + lane / 4) * ld + k0 + 2 * (lane % 4);
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B fragment (k16 x n8) with B[k][n] = s[(k0 + k) * ld + n0 + n]: a
// row-major tile read transposed (dO or Q for dV, dK; K for dQ).  Lanes
// 0-15 give the addresses of rows k0 .. k0 + 15 (16-byte aligned).
__device__ __forceinline__ void load_b_trans(uint32_t* b, const bf16* s,
                                             int ld, int k0, int n0,
                                             int lane) {
  const bf16* p = s + (k0 + (lane & 15)) * ld + n0;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(smem_u32(p)));
}

// rows [r0, r0 + rows) of a (len, heads, D) head slice into a row-major
// shared tile of row stride ld; rows at or past len are zeros
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          long long row_stride, int r0,
                                          int rows, int len) {
  for (int i = threadIdx.x; i < rows * D / 8; i += kThreads) {
    const int row = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r0 + row < len)
      x = *reinterpret_cast<const uint4*>(src + (r0 + row) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + row * ld + c) = x;
  }
}

template <int D>
constexpr int bf16_smem_bytes() {
  return 4 * 64 * (D + 8) * 2;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ dvec,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int s, int t, int h, int g, int causal, int window,
                           float scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kBK * LD;
  bf16* sQ = sV + kBK * LD;
  bf16* sO = sQ + kBQ * LD;                  // dO
  __shared__ float sL[kBQ], sD[kBQ];         // lse in log2 units, D

  const int k0 = blockIdx.x * kBK;
  const int kvh = blockIdx.y;
  const long long bi = blockIdx.z;
  const int r = h / g;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane % 4;
  const int key0 = k0 + 16 * warp + lane / 4;   // and key0 + 8

  load_tile<D>(sK, LD, k + (bi * t * g + kvh) * D, 1LL * g * D, k0, kBK, t);
  load_tile<D>(sV, LD, v + (bi * t * g + kvh) * D, 1LL * g * D, k0, kBK, t);

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  const float sl = scale * kLog2e;
  int qlo, qhi;
  q_range(k0, s, causal, window, &qlo, &qhi);

  for (int hq = kvh * r; hq < (kvh + 1) * r; ++hq) {
    const long long qoff = bi * s * h + hq;      // row q of head hq: qoff + q h
    for (int qt = qlo; qt < qhi; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();                           // the last step is done
      load_tile<D>(sQ, LD, q + qoff * D, 1LL * h * D, q0, kBQ, s);
      load_tile<D>(sO, LD, dout + qoff * D, 1LL * h * D, q0, kBQ, s);
      for (int i = threadIdx.x; i < kBQ; i += kThreads) {
        const bool in = q0 + i < s;
        sL[i] = in ? lse[qoff + static_cast<long long>(q0 + i) * h] * kLog2e : 0.f;
        sD[i] = in ? dvec[qoff + static_cast<long long>(q0 + i) * h] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 64 rows
      float st[kBQ / 8][4], dpt[kBQ / 8][4];
#pragma unroll
      for (int j = 0; j < kBQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        load_a(ak, sK, LD, 16 * warp, 16 * kk, lane);
        load_a(av, sV, LD, 16 * warp, 16 * kk, lane);
#pragma unroll
        for (int nt = 0; nt < kBQ / 8; ++nt) {
          uint32_t bq[2], bo[2];
          load_b(bq, sQ, LD, 8 * nt, 16 * kk, lane);
          load_b(bo, sO, LD, 8 * nt, 16 * kk, lane);
          mma16816(st[nt], ak, bq);
          mma16816(dpt[nt], av, bo);
        }
      }

      // P^T = exp(S^T - lse), dS^T = P^T (dP^T - D) scale, 0 where masked;
      // n8 tile nt is half of the A fragment of k16 step nt / 2
      uint32_t pa[kBQ / 16][4], dsa[kBQ / 16][4];
#pragma unroll
      for (int nt = 0; nt < kBQ / 8; ++nt) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = 8 * nt + 2 * quad + (e & 1);
          const int kpos = key0 + ((e & 2) ? 8 : 0);
          p[e] = 0.f;
          ds[e] = 0.f;
          if (visible(q0 + ql, kpos, s, t, causal, window)) {
            p[e] = exp2f(st[nt][e] * sl - sL[ql]);
            ds[e] = p[e] * (dpt[nt][e] - sD[ql]) * scale;
          }
        }
        const int ks = nt / 2, hb = 2 * (nt & 1);
        pa[ks][hb] = pack_bf16(p[0], p[1]);
        pa[ks][hb + 1] = pack_bf16(p[2], p[3]);
        dsa[ks][hb] = pack_bf16(ds[0], ds[1]);
        dsa[ks][hb + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dV += P^T dO, dK += dS^T Q over the tile's 64 rows
#pragma unroll
      for (int ks = 0; ks < kBQ / 16; ++ks) {
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          uint32_t bo[2], bq[2];
          load_b_trans(bo, sO, LD, 16 * ks, 8 * nd, lane);
          load_b_trans(bq, sQ, LD, 16 * ks, 8 * nd, lane);
          mma16816(dva[nd], pa[ks], bo);
          mma16816(dka[nd], dsa[ks], bq);
        }
      }
    }
  }

#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = 8 * nd + 2 * quad;
#pragma unroll
    for (int hb = 0; hb < 2; ++hb) {
      const int key = key0 + 8 * hb;
      if (key >= t) continue;
      const long long off = ((bi * t + key) * g + kvh) * D + col;
      *reinterpret_cast<uint32_t*>(dk + off) =
          pack_bf16(dka[nd][2 * hb], dka[nd][2 * hb + 1]);
      *reinterpret_cast<uint32_t*>(dv + off) =
          pack_bf16(dva[nd][2 * hb], dva[nd][2 * hb + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dvec,
                         bf16* __restrict__ dq, int s, int t, int h, int g,
                         int causal, int window, float scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sO = sQ + kBQ * LD;                  // dO
  bf16* sK = sO + kBQ * LD;
  bf16* sV = sK + kBK * LD;

  const int q0 = blockIdx.x * kBQ;
  const int hq = blockIdx.y;
  const long long bi = blockIdx.z;
  const int kvh = hq / (h / g);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane % 4;
  const int row0 = q0 + 16 * warp + lane / 4;   // and row0 + 8
  const long long qoff = bi * s * h + hq;
  const long long koff = bi * t * g + kvh;

  load_tile<D>(sQ, LD, q + qoff * D, 1LL * h * D, q0, kBQ, s);
  load_tile<D>(sO, LD, dout + qoff * D, 1LL * h * D, q0, kBQ, s);
  const float sl = scale * kLog2e;
  float lrow[2], drow[2];
#pragma unroll
  for (int hb = 0; hb < 2; ++hb) {
    const int row = row0 + 8 * hb;
    const bool in = row < s;
    lrow[hb] = in ? lse[qoff + static_cast<long long>(row) * h] * kLog2e : 0.f;
    drow[hb] = in ? dvec[qoff + static_cast<long long>(row) * h] : 0.f;
  }

  float dqa[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;
  int lo, hi;
  key_range(q0, t, causal, window, &lo, &hi);

  for (int jt = lo; jt < hi; ++jt) {
    const int k0 = jt * kBK;
    __syncthreads();                             // the last tile is done
    load_tile<D>(sK, LD, k + koff * D, 1LL * g * D, k0, kBK, t);
    load_tile<D>(sV, LD, v + koff * D, 1LL * g * D, k0, kBK, t);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: this warp's 16 rows x 64 keys
    float sa[kBK / 8][4], dpa[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sa[j][e] = dpa[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ao[4];
      load_a(aq, sQ, LD, 16 * warp, 16 * kk, lane);
      load_a(ao, sO, LD, 16 * warp, 16 * kk, lane);
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
        uint32_t bk[2], bv[2];
        load_b(bk, sK, LD, 8 * nt, 16 * kk, lane);
        load_b(bv, sV, LD, 8 * nt, 16 * kk, lane);
        mma16816(sa[nt], aq, bk);
        mma16816(dpa[nt], ao, bv);
      }
    }

    // dS = P (dP - D) scale with P = exp(S - lse), 0 where masked
    uint32_t dsa[kBK / 16][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hb = (e & 2) ? 1 : 0;
        const int kpos = k0 + 8 * nt + 2 * quad + (e & 1);
        ds[e] = 0.f;
        if (visible(row0 + 8 * hb, kpos, s, t, causal, window)) {
          const float p = exp2f(sa[nt][e] * sl - lrow[hb]);
          ds[e] = p * (dpa[nt][e] - drow[hb]) * scale;
        }
      }
      const int ks = nt / 2, part = 2 * (nt & 1);
      dsa[ks][part] = pack_bf16(ds[0], ds[1]);
      dsa[ks][part + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dQ += dS K over the tile's 64 keys
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        uint32_t bk[2];
        load_b_trans(bk, sK, LD, 16 * ks, 8 * nd, lane);
        mma16816(dqa[nd], dsa[ks], bk);
      }
    }
  }

#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = 8 * nd + 2 * quad;
#pragma unroll
    for (int hb = 0; hb < 2; ++hb) {
      const int row = row0 + 8 * hb;
      if (row >= s) continue;
      *reinterpret_cast<uint32_t*>(dq + (qoff + static_cast<long long>(row) * h) * D + col) =
          pack_bf16(dqa[nd][2 * hb], dqa[nd][2 * hb + 1]);
    }
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
                          float scale) {
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
  q_range(k0, s, causal, window, &qlo, &qhi);
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
        if (!visible(q0 + j, kpos, s, t, causal, window)) continue;
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
                        int causal, int window, float scale) {
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
  key_range(q0, t, causal, window, &lo, &hi);
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
      if (!visible(qpos, k0 + j, s, t, causal, window)) continue;
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
template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void flash_bwd_dot_kernel(const T* __restrict__ out,
                                     const T* __restrict__ dout,
                                     float* __restrict__ dvec, long long rows,
                                     int d) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;                   // the whole warp
  float acc = 0.f;
  for (int c = lane; c < d; c += 32)
    acc = fmaf(to_f32(out[row * d + c]), to_f32(dout[row * d + c]), acc);
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

template <int D>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* dvec, void* dq,
           void* dk, void* dv, int b, int s, int t, int h, int g, int is_bf16,
           int causal, int window, float scale, cudaStream_t stream) {
  const long long rows = 1LL * b * s * h;
  const int dot_blocks = static_cast<int>((rows + 7) / 8);
  const dim3 gq((s + kBQ - 1) / kBQ, h, b), gk((t + kBK - 1) / kBK, g, b);
  if (is_bf16) {
    static bool set = false;
    if (!set) {
      cudaError_t e = opt_in(flash_bwd_dkdv_bf16_kernel<D>, bf16_smem_bytes<D>());
      if (e == cudaSuccess) e = opt_in(flash_bwd_dq_bf16_kernel<D>, bf16_smem_bytes<D>());
      if (e != cudaSuccess) return static_cast<int>(e);
      set = true;
    }
    const bf16 *bq = static_cast<const bf16*>(q), *bk = static_cast<const bf16*>(k),
               *bv = static_cast<const bf16*>(v), *bo = static_cast<const bf16*>(dout);
    flash_bwd_dot_kernel<bf16><<<dot_blocks, 256, 0, stream>>>(
        static_cast<const bf16*>(out), bo, dvec, rows, D);
    flash_bwd_dq_bf16_kernel<D><<<gq, kThreads, bf16_smem_bytes<D>(), stream>>>(
        bq, bk, bv, bo, lse, dvec, static_cast<bf16*>(dq), s, t, h, g, causal,
        window, scale);
    flash_bwd_dkdv_bf16_kernel<D><<<gk, kThreads, bf16_smem_bytes<D>(), stream>>>(
        bq, bk, bv, bo, lse, dvec, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), s, t, h, g, causal, window, scale);
    return static_cast<int>(cudaGetLastError());
  }
  static bool set = false;
  if (!set) {
    cudaError_t e = opt_in(flash_bwd_dkdv_f32_kernel<D>, f32_dkdv_smem_bytes<D>());
    if (e == cudaSuccess) e = opt_in(flash_bwd_dq_f32_kernel<D>, f32_dq_smem_bytes<D>());
    if (e != cudaSuccess) return static_cast<int>(e);
    set = true;
  }
  const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v), *fo = static_cast<const float*>(dout);
  flash_bwd_dot_kernel<float><<<dot_blocks, 256, 0, stream>>>(
      static_cast<const float*>(out), fo, dvec, rows, D);
  flash_bwd_dq_f32_kernel<D><<<gq, kBQ, f32_dq_smem_bytes<D>(), stream>>>(
      fq, fk, fv, fo, lse, dvec, static_cast<float*>(dq), s, t, h, g, causal,
      window, scale);
  flash_bwd_dkdv_f32_kernel<D><<<gk, kBK, f32_dkdv_smem_bytes<D>(), stream>>>(
      fq, fk, fv, fo, lse, dvec, static_cast<float*>(dk),
      static_cast<float*>(dv), s, t, h, g, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, out, dout, dq: (b, s, h, d); k, v, dk, dv: (b, t, g, d); all bf16
// (is_bf16 = 1) or all f32; lse, dvec: (b, s, h) f32; h % g == 0; d in
// {16, 32, 64, 128}; window <= 0 means none (and is ignored unless causal).
int flash_bwd_launch(const void* q, const void* k, const void* v,
                     const void* out, const void* dout, const void* lse,
                     void* dvec, void* dq, void* dk, void* dv, int b, int s,
                     int t, int h, int g, int d, int is_bf16, int causal,
                     int window, float scale, void* stream) {
  if (b <= 0 || s <= 0 || t <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dd = static_cast<float*>(dvec);
  switch (d) {
    case 16: return launch<16>(q, k, v, out, dout, l, dd, dq, dk, dv, b, s, t, h, g, is_bf16, causal, window, scale, st);
    case 32: return launch<32>(q, k, v, out, dout, l, dd, dq, dk, dv, b, s, t, h, g, is_bf16, causal, window, scale, st);
    case 64: return launch<64>(q, k, v, out, dout, l, dd, dq, dk, dv, b, s, t, h, g, is_bf16, causal, window, scale, st);
    case 128: return launch<128>(q, k, v, out, dout, l, dd, dq, dk, dv, b, s, t, h, g, is_bf16, causal, window, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* cuda_error_name(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
