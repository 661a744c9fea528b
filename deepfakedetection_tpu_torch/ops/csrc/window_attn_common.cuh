// Pieces shared by the K5 forward (window_attn.cu) and backward
// (window_attn_bwd.cu), K6 and K7: the bf16 tensor-core product, bf16
// packing, a strided view of one head, and the paired-column output store.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxSmemBytes = 232448;  // shared memory one sm_90 block may use

// d += a . b on the tensor cores: m16n8k16, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

struct View {
  const __nv_bfloat16* p;
  long long sb, sr, sh;  // batch, row and head strides, in elements
};

// Stores one 16x8 accumulator tile's two rows (r0 and r0 + 8) of two columns
// (c, c + 1) times `mult`, rounded to bf16, skipping rows >= N and columns
// >= d. vec promises d % 8 == 0 and 4-byte aligned pairs.
__device__ __forceinline__ void store_pair_rows(__nv_bfloat16* base, long long sr, const float (&o)[4],
                                                int r0, int c, int N, int d, float mult, bool vec) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    if (row >= N || c >= d) continue;
    const float lo = __fmul_rn(o[2 * half], mult), hi = __fmul_rn(o[2 * half + 1], mult);
    __nv_bfloat16* dst = base + row * sr + c;
    if (vec) {
      *reinterpret_cast<uint32_t*>(dst) = pack_bf16(lo, hi);
    } else {
      dst[0] = __float2bfloat16_rn(lo);
      if (c + 1 < d) dst[1] = __float2bfloat16_rn(hi);
    }
  }
}

}  // namespace
