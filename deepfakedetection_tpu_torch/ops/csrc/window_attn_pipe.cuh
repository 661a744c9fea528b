// Pieces of the K5 forward's (window_attn.cu) and backward's
// (window_attn_bwd.cu) pipelines: a warp group, its ring copies of one
// window's head rows counted on an mbarrier, the ldmatrix operand loads (K7's
// too) and the quotient from one reciprocal a row; and of the long kernels'
// (window_attn_long.cu, attn4d_long.cu): zero-filling copies, exponentials,
// quad reductions, the permuted key order and accumulators as A fragments.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "window_attn_common.cuh"

namespace {

constexpr int kGroupWarps = 4;            // warps of a warp group
constexpr int kGroup = 32 * kGroupWarps;  // threads of a warp group
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int pad16(int n) { return (n + 15) / 16 * 16; }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// a / b rounded to nearest from inv = 1 / b rounded to nearest: q = a inv
// corrected by its exact residual a - b q (Markstein's theorem: the result is
// IEEE division's, for the finite, normal a / b here: a in [0, 1], b >= 1),
// without the division's range checks and slow path.
__device__ __forceinline__ float quotient(float a, float b, float inv) {
  const float q = __fmul_rn(a, inv);
  return __fmaf_rn(__fmaf_rn(-q, b, a), inv, q);
}

// One arrival on `bar` when all of this thread's earlier cp.async copies
// have landed (the barrier's count includes it: .noinc).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// A warp group's copy of window b's rows of head h of T tensors into a ring
// slot (T [Np][ld] tiles), announced on `bar` by all the group's threads
// (t is the thread's index in the group): 16-byte cp.async where vec allows,
// else element by element. Rows past N and columns past d are not written.
template <int T>
__device__ __forceinline__ void load_window(__nv_bfloat16* slot, const View (&src)[T], int b,
                                            int h, int N, int d, int Np, int ld, bool vec,
                                            uint64_t* bar, int t) {
  if (vec) {
    // the thread's 16-byte chunks (row r, column 8 c) step by kGroup chunks
    const int chunks = d / 8, dr = kGroup / chunks, dc = kGroup - dr * chunks;
    const __nv_bfloat16* base[T];
#pragma unroll
    for (int i = 0; i < T; ++i) base[i] = src[i].p + b * src[i].sb + h * src[i].sh;
    int r = t / chunks, c = t - r * chunks;
    for (; r < N; r += dr, c += dc) {
      if (c >= chunks) {
        c -= chunks;
        if (++r >= N) break;
      }
#pragma unroll
      for (int i = 0; i < T; ++i)
        cp_async16(slot + i * Np * ld + r * ld + 8 * c, base[i] + r * src[i].sr + 8 * c);
    }
    cp_async_arrive(bar);
  } else {
#pragma unroll
    for (int i = 0; i < T; ++i) {
      const __nv_bfloat16* base = src[i].p + b * src[i].sb + h * src[i].sh;
      __nv_bfloat16* dst = slot + i * Np * ld;
      for (int e = t; e < N * d; e += kGroup) {
        const int r = e / d, c = e - r * d;
        dst[r * ld + c] = base[r * src[i].sr + c];
      }
    }
    mbar_arrive(bar);
  }
}

// 16-byte cp.async that writes zeros (reads nothing) where `in` is false.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// exp(x - m) as 2^((x - m) log2 e): 0 where x is -inf.
__device__ __forceinline__ float exp_sub(float x, float m) {
  return ex2(__fmul_rn(__fsub_rn(x, m), kLog2e));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The key of position k (0..15) of a 16-key chunk in the long kernels' score
// products: the accumulator's n-tiles 2p and 2p + 1 hold keys {0, 1, 4, 5,
// ...} and {2, 3, 6, 7, ...}, so a thread's four columns of a chunk, 4 t4 ..
// 4 t4 + 3, are adjacent and its bias is one 16-byte load.
__device__ __forceinline__ int key_of(int k) { return 4 * ((k & 7) >> 1) + 2 * (k >> 3) + (k & 1); }

// A 16x16 accumulator tile (rows x columns) as the bf16 A fragment of the
// same tile.
__device__ __forceinline__ void as_a(uint32_t (&a)[4], const float (&x0)[4], const float (&x1)[4]) {
  a[0] = pack_bf16(x0[0], x0[1]);
  a[1] = pack_bf16(x0[2], x0[3]);
  a[2] = pack_bf16(x1[0], x1[1]);
  a[3] = pack_bf16(x1[2], x1[3]);
}

}  // namespace
