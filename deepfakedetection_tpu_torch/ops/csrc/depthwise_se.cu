// K1: fused stride-1 depthwise conv + folded-BN bias + SiLU + SE spatial mean.
//
// Replaces: deepfakedetection_tpu/ops/pallas/depthwise_se.py,
//   depthwise_silu_pool (_dw_kernel), the TPU kernel for the expand-free
//   MBConv depthwise (EfficientNet stage 0).
// Contract: x [B,H,W,C] bf16, w [k,k,C] f32, b [C] f32, zero padding k//2 ->
//   y [B,H,W,C] bf16 = silu(dw(x) + b), pool [B,C] f32 = mean over H,W of the
//   bf16-ROUNDED y.
// Bound on the H100: HBM bytes. Per output element it reads one bf16 and
//   writes one bf16 (4 bytes) for 2k^2 flops: 4.5 flop/byte at k=3 and 12.5
//   at k=5, far below the ~295 flop/byte where bf16 compute would bind.
// Design: one pass over HBM. A block stages its haloed input tile once in
//   shared memory and reads the k^2 taps from there, so x is read from HBM
//   about once (halo re-reads hit L2), y is written once, and the SE mean
//   comes out of registers instead of a second pass over y. The pool is
//   reduced deterministically (dw_common.cuh).
#include "dw_common.cuh"

namespace {

using dfd::bf2f;

// grid (tiles, channel blocks, B); block (CB channels, ny pixel lanes).
// Shared memory: halo tile [(TH+K-1)*(TW+K-1)][CB] bf16, then [ny][CB] f32.
template <int K>
__global__ void depthwise_silu_pool_kernel(const __nv_bfloat16* __restrict__ x,
                                           const float* __restrict__ w,
                                           const float* __restrict__ bias,
                                           __nv_bfloat16* __restrict__ y,
                                           float* __restrict__ partial, int H, int W, int C,
                                           int TH, int TW, int tiles_w, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int R = K / 2;
  const int CB = blockDim.x, ny = blockDim.y;
  const int lane = threadIdx.x;
  const int tid = threadIdx.y * CB + lane, nthreads = CB * ny;
  const int tile = blockIdx.x, c0 = blockIdx.y * CB, b = blockIdx.z;
  const dfd::Tile t = dfd::tile_of(tile, tiles_w, TH, TW, H, W);
  const int HH = TH + K - 1, WW = TW + K - 1;

  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem);
  float* red = reinterpret_cast<float*>(smem + dfd::align16(sizeof(__nv_bfloat16) * HH * WW * CB));

  // Haloed input tile; the zero padding of the conv is the zero fill here.
  // 16-byte loads (8 channels) when C and CB are multiples of 8.
  if ((C & 7) == 0 && (CB & 7) == 0) {
    const int chunks = CB / 8;
#pragma unroll 4
    for (int i = tid; i < HH * WW * chunks; i += nthreads) {
      const int ch = i % chunks, hp = i / chunks;
      const int gy = t.oy0 - R + hp / WW, gx = t.ox0 - R + hp % WW, c = c0 + ch * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < C)
        v = *reinterpret_cast<const uint4*>(x + ((static_cast<size_t>(b) * H + gy) * W + gx) * C + c);
      *reinterpret_cast<uint4*>(halo + hp * CB + ch * 8) = v;
    }
  } else {
    for (int i = tid; i < HH * WW * CB; i += nthreads) {
      const int j = i % CB, hp = i / CB;
      const int gy = t.oy0 - R + hp / WW, gx = t.ox0 - R + hp % WW, c = c0 + j;
      __nv_bfloat16 v = __float2bfloat16(0.0f);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < C)
        v = x[((static_cast<size_t>(b) * H + gy) * W + gx) * C + c];
      halo[i] = v;
    }
  }
  __syncthreads();

  const int c = c0 + lane;
  float psum = 0.0f;
  if (c < C) {
    float wr[K * K];
#pragma unroll
    for (int tap = 0; tap < K * K; ++tap) wr[tap] = w[tap * C + c];
    const float bv = bias[c];
    for (int p = threadIdx.y; p < t.th * t.tw; p += ny) {
      const int py = p / t.tw, px = p % t.tw;
      const float acc = dfd::dw_taps<K>(halo, WW, CB, lane, py, px, wr) + bv;
      const __nv_bfloat16 yb = __float2bfloat16_rn(dfd::silu(acc));
      y[((static_cast<size_t>(b) * H + t.oy0 + py) * W + t.ox0 + px) * C + c] = yb;
      psum += bf2f(yb);  // the pool is the mean of the rounded activation
    }
  }
  dfd::write_tile_sum(red, psum, partial, b, tiles, tile, C, c);
}

template <int K>
cudaError_t launch(const void* x, const void* w, const void* b, void* y, void* partial,
                   void* pool, int B, int H, int W, int C, int TH, int TW, int CB,
                   cudaStream_t stream) {
  const int tiles_h = (H + TH - 1) / TH, tiles_w = (W + TW - 1) / TW;
  const int tiles = tiles_h * tiles_w;
  const int ny = 256 / CB;
  const size_t smem = dfd::align16(sizeof(__nv_bfloat16) * (TH + K - 1) * (TW + K - 1) * CB) +
                      sizeof(float) * ny * CB;
  cudaError_t err = dfd::allow_smem(depthwise_silu_pool_kernel<K>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles, (C + CB - 1) / CB, B), block(CB, ny);
  depthwise_silu_pool_kernel<K><<<grid, block, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(partial), H, W, C, TH, TW, tiles_w, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return dfd::launch_pool_finalize(static_cast<const float*>(partial), static_cast<float*>(pool),
                                   B, tiles, C, H * W, stream);
}

}  // namespace

extern "C" const char* dfd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns a cudaError_t: 0 on success. CB channels per block, 1 <= CB <= 256.
extern "C" int dfd_depthwise_silu_pool(const void* x, const void* w, const void* b, void* y,
                                       void* partial, void* pool, int B, int H, int W, int C,
                                       int k, int TH, int TW, int CB, void* stream) {
  if (CB < 1 || CB > 256 || TH < 1 || TW < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 3:
      return launch<3>(x, w, b, y, partial, pool, B, H, W, C, TH, TW, CB, s);
    case 5:
      return launch<5>(x, w, b, y, partial, pool, B, H, W, C, TH, TW, CB, s);
    default:
      return cudaErrorInvalidValue;
  }
}
