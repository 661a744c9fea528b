// Pieces shared by the MBConv kernels (depthwise_se.cu, expand_dw.cu,
// fused_mbconv.cu): the SiLU, bf16 packing, the tensor-core product of K2's
// expand and the shared-memory limit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace dfd {

// Shared memory one block may use on sm_90 (227 KB).
constexpr int kMaxSmemBytes = 232448;

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

__device__ __forceinline__ float bf2f(__nv_bfloat16 v) { return __bfloat162float(v); }

// D += A B on the tensor cores: m16n8k16, bf16 in, f32 accumulate; a holds
// the row-major A fragment, b0/b1 the col-major B fragment (k-major bf16
// pairs).
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

__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Raises the dynamic shared memory limit of `kernel` when a launch needs
// more than the default 48 KB.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > static_cast<size_t>(kMaxSmemBytes)) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace dfd

extern "C" const char* dfd_error_string(int code);
