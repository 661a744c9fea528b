// Pieces shared by K6's forward (attn_block.cu) and backward
// (attn_block_bwd.cu): the shapes of the qkv recompute's shared memory (x
// staged for wgmma, the weight ring's units and granules), and one head's
// attention over a window from staged q, k, v (head_probs and probs_times_v;
// the backward's row and column passes), with K5's arithmetic
// (window_attn.cu, window_attn_bwd.cu). K5 keeps its own fused loops: built
// on these helpers it measured 20% slower (official forward) and 18% slower
// (tpu backward) on an H100.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <numeric>

#include "hopper.cuh"
#include "window_attn_common.cuh"

namespace {

constexpr int kCluster = 2;     // blocks sharing each weight tile (TMA multicast)
constexpr int kMaxRows = 128;   // the M rows of a block (2 x 64)
constexpr int kSms = 132;       // an H100 SXM's SMs
constexpr int kMaxStages = 8;   // the weight ring's depth, at most
constexpr int kMaxKB = 2;       // 64-column weight tiles a stage may hold
constexpr int kUnits[6] = {192, 144, 128, 64, 48, 32};  // the wgmma widths, widest first

__host__ __device__ constexpr int pad16(int n) { return (n + 15) / 16 * 16; }

// Units of NT weight rows a ring stage holds: one when the block's rows make
// two warpgroup row groups, else two (one per warpgroup).
__host__ __device__ constexpr int stage_slots(int Mx) { return Mx > 64 ? 1 : 2; }

// x staged for wgmma: the block's Mx = G N token rows packed densely, in
// 64-column blocks of pad8(Mx) 128-byte rows (128-byte swizzle), and after
// the last block room for the rest of the last warpgroup tile's 64 rows
// (read, never used).
__host__ __device__ constexpr int x_smem_bytes(int Mx, int Cp) {
  return (cdiv(Cp, kKTile) * pad8(Mx) + 64 * (Mx > 64 ? 2 : 1) - pad8(Mx)) * kRowBytes;
}

// A head group's f32 qkv bias (3 HG Dp) and, when staged, its f32 bias
// tables (HG N N), each 16-byte rounded.
__host__ __device__ constexpr int bias_smem_bytes(int N, int Dp, int HG, int staged) {
  return cdiv(3 * HG * Dp, 4) * 16 + (staged ? cdiv(HG * N * N, 4) * 16 : 0);
}

// The row of wqkv ([3, heads, Dp] rows) behind column col of a head group's
// products: the group's columns run part-major (q of its hn heads, then k,
// then v); past 3 hn Dp they fall past the tensor (TMA reads zeros).
__host__ __device__ __forceinline__ int group_row(int col, int hn, int heads, int h0, int Dp) {
  const int part = col / (hn * Dp), rem = col % (hn * Dp);
  return (part * heads + h0) * Dp + rem;
}

// Rows of the weight boxes TMA loads (half of them a block): the most that
// divide a unit and a head, so that a box never straddles q, k and v.
inline int granule(int NT, int Dp) { return std::gcd(NT, Dp); }

// One warp's query rows r0 = 16 mt + lane / 4 and r0 + 8 of one head:
// p = softmax((q k^T accumulated in f32) * scale + bias_h) over the N keys,
// in f32, with the plain version's exactly rounded scale, bias add,
// subtraction and division; columns >= N and rows >= N are 0. q and k are
// staged [Np, Dp] with row stride ld, zero past d.
template <int KT, int DT>
__device__ __forceinline__ void head_probs(float (&s)[2 * KT][4], const __nv_bfloat16* qs,
                                           const __nv_bfloat16* ks, int ld, int mt, int kt,
                                           int dt, const float* __restrict__ bias_h, int N,
                                           float scale) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int ldw = ld / 2, r0 = mt * 16 + g, r1 = r0 + 8;
  const uint32_t* qa = reinterpret_cast<const uint32_t*>(qs) + r0 * ldw + t4;
  const uint32_t* qb = qa + 8 * ldw;
  const uint32_t* ks32 = reinterpret_cast<const uint32_t*>(ks);
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DT; ++kk) {
    if (kk >= dt) continue;
    const uint32_t a[4] = {qa[kk * 8], qb[kk * 8], qa[kk * 8 + 4], qb[kk * 8 + 4]};
#pragma unroll
    for (int nt = 0; nt < 2 * KT; ++nt) {
      if (nt >= 2 * kt) continue;
      const uint32_t* kb = ks32 + (nt * 8 + g) * ldw + kk * 8 + t4;
      mma_bf16_16816(s[nt], a, kb[0], kb[4]);
    }
  }
  const float* brow0 = bias_h + static_cast<long long>(min(r0, N - 1)) * N;
  const float* brow1 = bias_h + static_cast<long long>(min(r1, N - 1)) * N;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt) {
    if (nt >= 2 * kt) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = nt * 8 + 2 * t4 + e;
      float v0 = -INFINITY, v1 = -INFINITY;
      if (c < N) {
        v0 = r0 < N ? __fadd_rn(__fmul_rn(s[nt][e], scale), brow0[c]) : 0.0f;
        v1 = r1 < N ? __fadd_rn(__fmul_rn(s[nt][2 + e], scale), brow1[c]) : 0.0f;
      }
      s[nt][e] = v0;
      s[nt][2 + e] = v1;
      m0 = fmaxf(m0, v0);
      m1 = fmaxf(m1, v1);
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
  float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt) {
    if (nt >= 2 * kt) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[nt][e] = expf(__fsub_rn(s[nt][e], m0));
      s[nt][2 + e] = expf(__fsub_rn(s[nt][2 + e], m1));
      l0 += s[nt][e];
      l1 += s[nt][2 + e];
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt) {
    if (nt >= 2 * kt) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[nt][e] = r0 < N ? __fdiv_rn(s[nt][e], l0) : 0.0f;
      s[nt][2 + e] = r1 < N ? __fdiv_rn(s[nt][2 + e], l1) : 0.0f;
    }
  }
}

// ctx rows of one warp's query tile: bf16(p) . v over the key tiles, each
// 16x8 output tile rounded once and stored through store_pair_rows (rows >=
// N and columns >= d skipped). p is head_probs' output; v is staged [Np, Dp]
// with row stride ld.
template <int KT, int DT>
__device__ __forceinline__ void probs_times_v(const float (&s)[2 * KT][4], const __nv_bfloat16* vs,
                                              int ld, int mt, int kt, int dt,
                                              __nv_bfloat16* out, long long sr, int N, int d,
                                              bool pair) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  // p as the A fragments: key tile j is the score tiles 2j and 2j+1
  uint32_t p[KT][4];
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    if (j >= kt) continue;
    p[j][0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
    p[j][1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
    p[j][2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
    p[j][3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
  }
#pragma unroll
  for (int nt = 0; nt < 2 * DT; ++nt) {
    if (nt >= 2 * dt) continue;
    float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      if (j >= kt) continue;
      const __nv_bfloat16* vp = vs + (j * 16 + 2 * t4) * ld + g + nt * 8;
      mma_bf16_16816(o, p[j], pack_raw(vp[0], vp[ld]), pack_raw(vp[8 * ld], vp[9 * ld]));
    }
    store_pair_rows(out, sr, o, mt * 16 + g, nt * 8 + 2 * t4, N, d, 1.0f, pair);
  }
}


// The rest of one warp's query tile of the attention backward, after
// head_probs gave p (f32, zero past N): dp = do v^T, the row term
// t = rowsum(dp * p) with the f32 p (not FlashAttention's rowsum(do * o),
// which would read the bf16-rounded o), ds = p (dp - t), each ds element
// handed to add_dbias(row, column, ds) for the dbias sum (elements past N
// carry 0), bf16(p) and bf16(ds) into ps and gs (row stride ldp) for the
// column pass, and dq = bf16(ds) k * scale stored through store_pair_rows
// (row stride dq_sr). do, v and k are staged [Np, Dp] with row stride ld.
template <int KT, int DT, class AddDbias>
__device__ __forceinline__ void head_bwd_rows(const float (&p)[2 * KT][4],
                                              const __nv_bfloat16* dos, const __nv_bfloat16* vs,
                                              const __nv_bfloat16* ks, int ld, __nv_bfloat16* ps,
                                              __nv_bfloat16* gs, int ldp, int mt, int kt, int dt,
                                              int N, int d, float scale, __nv_bfloat16* dq,
                                              long long dq_sr, bool pair, AddDbias add_dbias) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int ldw = ld / 2, r0 = mt * 16 + g, r1 = r0 + 8;
  const uint32_t* do32 = reinterpret_cast<const uint32_t*>(dos);
  const uint32_t* vs32 = reinterpret_cast<const uint32_t*>(vs);
  float ds[2 * KT][4];
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt) ds[nt][0] = ds[nt][1] = ds[nt][2] = ds[nt][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DT; ++kk) {  // dp = do v^T
    if (kk >= dt) continue;
    const uint32_t* da = do32 + r0 * ldw + t4 + kk * 8;
    const uint32_t ad[4] = {da[0], da[8 * ldw], da[4], da[8 * ldw + 4]};
#pragma unroll
    for (int nt = 0; nt < 2 * KT; ++nt) {
      if (nt >= 2 * kt) continue;
      const uint32_t* vb = vs32 + (nt * 8 + g) * ldw + kk * 8 + t4;
      mma_bf16_16816(ds[nt], ad, vb[0], vb[4]);
    }
  }
  float t0 = 0.0f, t1 = 0.0f;  // the row term over the quad that shares the row
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt) {
    if (nt >= 2 * kt) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      t0 += __fmul_rn(ds[nt][e], p[nt][e]);
      t1 += __fmul_rn(ds[nt][2 + e], p[nt][2 + e]);
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    t0 += __shfl_xor_sync(0xffffffffu, t0, off);
    t1 += __shfl_xor_sync(0xffffffffu, t1, off);
  }
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt) {
    if (nt >= 2 * kt) continue;
    const int c = nt * 8 + 2 * t4;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      ds[nt][e] = __fmul_rn(p[nt][e], __fsub_rn(ds[nt][e], t0));
      ds[nt][2 + e] = __fmul_rn(p[nt][2 + e], __fsub_rn(ds[nt][2 + e], t1));
      add_dbias(r0, c + e, ds[nt][e]);
      add_dbias(r1, c + e, ds[nt][2 + e]);
    }
    *reinterpret_cast<uint32_t*>(ps + r0 * ldp + c) = pack_bf16(p[nt][0], p[nt][1]);
    *reinterpret_cast<uint32_t*>(ps + r1 * ldp + c) = pack_bf16(p[nt][2], p[nt][3]);
    *reinterpret_cast<uint32_t*>(gs + r0 * ldp + c) = pack_bf16(ds[nt][0], ds[nt][1]);
    *reinterpret_cast<uint32_t*>(gs + r1 * ldp + c) = pack_bf16(ds[nt][2], ds[nt][3]);
  }
  // dq = bf16(ds) k * scale: bf16(ds) as the A fragments (key tile j is the
  // score tiles 2j and 2j+1), k as the B operand
  uint32_t a[KT][4];
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    if (j >= kt) continue;
    a[j][0] = pack_bf16(ds[2 * j][0], ds[2 * j][1]);
    a[j][1] = pack_bf16(ds[2 * j][2], ds[2 * j][3]);
    a[j][2] = pack_bf16(ds[2 * j + 1][0], ds[2 * j + 1][1]);
    a[j][3] = pack_bf16(ds[2 * j + 1][2], ds[2 * j + 1][3]);
  }
#pragma unroll
  for (int nt = 0; nt < 2 * DT; ++nt) {
    if (nt >= 2 * dt) continue;
    float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      if (j >= kt) continue;
      const __nv_bfloat16* kp = ks + (j * 16 + 2 * t4) * ld + g + nt * 8;
      mma_bf16_16816(o, a[j], pack_raw(kp[0], kp[ld]), pack_raw(kp[8 * ld], kp[9 * ld]));
    }
    store_pair_rows(dq, dq_sr, o, r0, nt * 8 + 2 * t4, N, d, scale, pair);
  }
}

// One item of the attention backward's column pass: the 16 key rows from
// j0 of lhs^T rhs * mult, contracting over the query rows, stored through
// store_pair_rows at out (row stride sr): dv = bf16(p)^T do (lhs ps, rhs do,
// mult 1) or dk = bf16(ds)^T q * scale (lhs gs, rhs q). lhs is [Np, Np]
// (row stride ldp), rhs [Np, Dp] (row stride ld).
template <int KT, int DT>
__device__ __forceinline__ void head_bwd_cols(const __nv_bfloat16* lhs, int ldp,
                                              const __nv_bfloat16* rhs, int ld, int j0, int kt,
                                              int dt, __nv_bfloat16* out, long long sr, int N,
                                              int d, float mult, bool pair) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 2 * DT; ++nt) {
    if (nt >= 2 * dt) continue;
    float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      if (kk >= kt) continue;
      // A[key j0 + r][query kk*16 + c] = lhs[kk*16 + c][j0 + r]
      const __nv_bfloat16* lp = lhs + (kk * 16 + 2 * t4) * ldp + j0 + g;
      const uint32_t af[4] = {pack_raw(lp[0], lp[ldp]), pack_raw(lp[8], lp[ldp + 8]),
                              pack_raw(lp[8 * ldp], lp[9 * ldp]),
                              pack_raw(lp[8 * ldp + 8], lp[9 * ldp + 8])};
      // B[query kk*16 + r][column nt*8 + c] = rhs[kk*16 + r][nt*8 + c]
      const __nv_bfloat16* rp = rhs + (kk * 16 + 2 * t4) * ld + g + nt * 8;
      mma_bf16_16816(o, af, pack_raw(rp[0], rp[ld]), pack_raw(rp[8 * ld], rp[9 * ld]));
    }
    store_pair_rows(out, sr, o, j0 + g, nt * 8 + 2 * t4, N, d, mult, pair);
  }
}

}  // namespace
