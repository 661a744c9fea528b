// Pieces shared by the MBConv kernels (depthwise_se.cu, expand_dw.cu,
// fused_mbconv.cu).
//
// K1 (depthwise_se.cu) works on one spatial tile of one image and one block
// of channels: threadIdx.x walks the channels of the block (neighbouring
// threads on neighbouring channels, so NHWC loads and stores coalesce) and
// threadIdx.y walks the pixels of the tile. Every thread keeps one channel
// for the whole tile, so its share of the SE pool is a plain register sum;
// the ny partial sums of a channel are added in a fixed order in shared
// memory and written to a [B, tiles, C] scratch, and pool_finalize adds the
// tiles in a fixed order. No atomics: a run repeats bit for bit.
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

// Tile geometry of one block: output rows [oy0, oy0+th) x cols [ox0, ox0+tw).
struct Tile {
  int oy0, ox0, th, tw;
};

__device__ __forceinline__ Tile tile_of(int tile, int tiles_w, int TH, int TW, int H, int W) {
  Tile t;
  t.oy0 = (tile / tiles_w) * TH;
  t.ox0 = (tile % tiles_w) * TW;
  t.th = min(TH, H - t.oy0);
  t.tw = min(TW, W - t.ox0);
  return t;
}

// Depthwise k x k taps over a bf16 halo tile in shared memory, laid out
// [(TH+K-1) x (TW+K-1)][stride], for output pixel (py, px) of the tile and
// the thread's channel lane. Taps run dy-major in f32, as the TPU kernels do.
template <int K>
__device__ __forceinline__ float dw_taps(const __nv_bfloat16* halo, int WW, int stride, int lane,
                                         int py, int px, const float (&wr)[K * K]) {
  float acc = 0.0f;
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
#pragma unroll
    for (int dx = 0; dx < K; ++dx) {
      acc = fmaf(bf2f(halo[((py + dy) * WW + px + dx) * stride + lane]), wr[dy * K + dx], acc);
    }
  }
  return acc;
}

// Adds the ny per-lane partial sums of each channel in a fixed order and
// writes the block's tile sum to partial[b, tile, c].
__device__ __forceinline__ void write_tile_sum(float* red, float psum, float* partial, int b,
                                               int tiles, int tile, int C, int c) {
  const int CB = blockDim.x, ny = blockDim.y;
  red[threadIdx.y * CB + threadIdx.x] = psum;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float s = 0.0f;
    for (int r = 0; r < ny; ++r) s += red[r * CB + threadIdx.x];
    partial[(static_cast<size_t>(b) * tiles + tile) * C + c] = s;
  }
}

// pool[b, c] = sum over tiles of partial[b, t, c] / (H * W), tiles in order.
static __global__ void pool_finalize(const float* __restrict__ partial, float* __restrict__ pool, int B,
                              int tiles, int C, int HW) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * C) return;
  const int b = i / C, c = i % C;
  float s = 0.0f;
  for (int t = 0; t < tiles; ++t) s += partial[(static_cast<size_t>(b) * tiles + t) * C + c];
  pool[i] = s / static_cast<float>(HW);
}

static inline cudaError_t launch_pool_finalize(const float* partial, float* pool, int B, int tiles, int C,
                                        int HW, cudaStream_t stream) {
  const int n = B * C;
  pool_finalize<<<(n + 255) / 256, 256, 0, stream>>>(partial, pool, B, tiles, C, HW);
  return cudaGetLastError();
}

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
