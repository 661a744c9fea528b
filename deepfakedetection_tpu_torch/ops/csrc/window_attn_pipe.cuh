// Pieces of the K5 forward's (window_attn.cu) and backward's
// (window_attn_bwd.cu) pipelines: a warp group, its ring copies of one
// window's head rows counted on an mbarrier, the ldmatrix operand loads (K7's
// too) and the quotient from one reciprocal a row.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "window_attn_common.cuh"

namespace {

constexpr int kGroupWarps = 4;            // warps of a warp group
constexpr int kGroup = 32 * kGroupWarps;  // threads of a warp group

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

}  // namespace
