// int8 depthwise convolution, dequantised in its epilogue, with the
// activation fused.
//
// Replaces: no Pallas kernel. The JAX package computes its int8 depthwise conv
//   in XLA (deepfakedetection_tpu/ops/quant.py:110, int8_conv's
//   conv_general_dilated with int32 accumulation); PyTorch has no CUDA int8
//   convolution, so the port's int8 eval (ops/quant.py) needs this kernel for
//   every depthwise ConvBN: B3's 26 (SiLU), EfficientFormerV2's FFN `mid`
//   (GELU), its strided local conv, its attention's `v_local` and its
//   downsample's stride-2 `v_local` (no activation).
// Contract: xq [B,H,W,C] int8, wq [k,k,C] int8, scale [C] f32 (sw * sx),
//   bias [C] f32, stride 1 or 2, k 3 or 5, zero pads (top, bottom, left,
//   right), which may be asymmetric -> y [B,Ho,Wo,C] bf16 or f32 =
//   act(acc * scale + bias), acc the exact int32 sum of the k*k taps, the
//   product and the sum rounded apart (__fmul_rn, then __fadd_rn: no FMA
//   contraction), as ops/int8_dw.py's plain version rounds. act: none, SiLU
//   (v / (1 + expf(-v))), GELU's tanh form or its erf form.
// Bound on the H100: HBM bytes. At stride 1 an output element reads one int8
//   byte and writes two (bf16) for 2k^2 integer operations: 6 operations a
//   byte at k 3, 17 at k 5, under the ~20 a byte where the CUDA cores' rate
//   would bind.
// Design (a first kernel, right before fast): a block owns R output rows of
//   one chunk of 4 TX channels; its k*k*4*TX tap weights are staged in shared
//   memory once. Thread x holds 4 channels (char4 loads, 4 bytes a pixel; a
//   warp reads 128 contiguous bytes), thread y walks units of 4 consecutive
//   output pixels of one row: for each tap row it reads each input pixel of
//   the unit's window once and feeds it to up to k of its outputs from
//   registers. Zero padding is a bounds test, never a padded copy. Channel
//   counts off 4 take the byte-wise path (VEC false).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kNPX = 4;          // output pixels of one unit
constexpr int kThreads = 256;    // a block's threads at most

enum Act { kNone = 0, kSilu = 1, kGeluTanh = 2, kGeluErf = 3 };

struct Params {
  const int8_t* x;
  const int8_t* w;
  const float* scale;
  const float* bias;
  void* y;
  int B, H, W, C, Ho, Wo, pt, pl, act;
  int TX, TY, R, units;  // launch shape: channel groups, pixel threads, rows a block, units a row
};

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kSilu:
      return v / (1.0f + expf(-v));
    case kGeluTanh: {
      const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
      const float inner = kBeta * (v + 0.044715f * v * v * v);
      return 0.5f * v * (1.0f + tanhf(inner));
    }
    case kGeluErf:
      return 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
    default:
      return v;
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* y, const float (&v)[4], int n, bool vec) {
  if (vec && n == 4) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&lo);
    packed.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(y) = packed;
    return;
  }
  for (int i = 0; i < n; ++i) y[i] = __float2bfloat16_rn(v[i]);
}

__device__ __forceinline__ void store4(float* y, const float (&v)[4], int n, bool vec) {
  if (vec && n == 4) {
    *reinterpret_cast<float4*>(y) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
  for (int i = 0; i < n; ++i) y[i] = v[i];
}

// The 4 channels c0..c0+3 of one pixel (zero past C).
template <bool VEC>
__device__ __forceinline__ char4 load4(const int8_t* px, int c0, int C) {
  char4 v = make_char4(0, 0, 0, 0);
  if (VEC) return c0 < C ? *reinterpret_cast<const char4*>(px + c0) : v;
  if (c0 < C) v.x = px[c0];
  if (c0 + 1 < C) v.y = px[c0 + 1];
  if (c0 + 2 < C) v.z = px[c0 + 2];
  if (c0 + 3 < C) v.w = px[c0 + 3];
  return v;
}

__device__ __forceinline__ void mac(int (&acc)[4], char4 a, char4 b) {
  acc[0] += int(a.x) * int(b.x);
  acc[1] += int(a.y) * int(b.y);
  acc[2] += int(a.z) * int(b.z);
  acc[3] += int(a.w) * int(b.w);
}

template <int K, int S, typename Out, bool VEC>
__global__ void __launch_bounds__(kThreads) int8_dw_kernel(const Params p) {
  extern __shared__ char4 taps[];  // [K * K][TX]: the chunk's weights, 4 channels an entry
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c0 = (blockIdx.y * p.TX + tx) * 4;
  for (int i = ty; i < K * K; i += p.TY)
    taps[i * p.TX + tx] = load4<VEC>(p.w + static_cast<long long>(i) * p.C, c0, p.C);
  __syncthreads();
  if (c0 >= p.C) return;
  const int nc = min(4, p.C - c0);
  float sc[4], bi[4];
  for (int i = 0; i < 4; ++i) {
    sc[i] = i < nc ? p.scale[c0 + i] : 0.0f;
    bi[i] = i < nc ? p.bias[c0 + i] : 0.0f;
  }
  const int rows = p.B * p.Ho;
  const int row0 = blockIdx.x * p.R;
  for (int item = ty; item < p.R * p.units; item += p.TY) {
    const int r = row0 + item / p.units;
    if (r >= rows) break;
    const int b = r / p.Ho, ho = r - b * p.Ho;
    const int wo0 = (item % p.units) * kNPX;
    int acc[kNPX][4] = {};
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
      const int hi = ho * S + dy - p.pt;
      if (hi < 0 || hi >= p.H) continue;
      char4 wr[K];
#pragma unroll
      for (int dx = 0; dx < K; ++dx) wr[dx] = taps[(dy * K + dx) * p.TX + tx];
      const int8_t* row = p.x + (static_cast<long long>(b) * p.H + hi) * p.W * p.C;
      const int wi0 = wo0 * S - p.pl;
#pragma unroll
      for (int j = 0; j < (kNPX - 1) * S + K; ++j) {
        const int wi = wi0 + j;
        if (wi < 0 || wi >= p.W) continue;
        const char4 v = load4<VEC>(row + static_cast<long long>(wi) * p.C, c0, p.C);
#pragma unroll
        for (int q = 0; q < kNPX; ++q) {
          const int dx = j - q * S;
          if (dx >= 0 && dx < K) mac(acc[q], v, wr[dx]);
        }
      }
    }
    Out* y = static_cast<Out*>(p.y) + (static_cast<long long>(r) * p.Wo + wo0) * p.C + c0;
#pragma unroll
    for (int q = 0; q < kNPX; ++q) {
      if (wo0 + q >= p.Wo) break;
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = activate(__fadd_rn(__fmul_rn(__int2float_rn(acc[q][i]), sc[i]), bi[i]), p.act);
      store4(y + static_cast<long long>(q) * p.C, v, nc, VEC);
    }
  }
}

template <int K, int S, typename Out>
cudaError_t launch(const Params& p, bool vec, dim3 grid, dim3 block, size_t smem,
                   cudaStream_t stream) {
  if (vec)
    int8_dw_kernel<K, S, Out, true><<<grid, block, smem, stream>>>(p);
  else
    int8_dw_kernel<K, S, Out, false><<<grid, block, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename Out>
cudaError_t dispatch(const Params& p, int k, int stride, bool vec, dim3 grid, dim3 block,
                     size_t smem, cudaStream_t stream) {
  if (k == 3) {
    return stride == 1 ? launch<3, 1, Out>(p, vec, grid, block, smem, stream)
                       : launch<3, 2, Out>(p, vec, grid, block, smem, stream);
  }
  return stride == 1 ? launch<5, 1, Out>(p, vec, grid, block, smem, stream)
                     : launch<5, 2, Out>(p, vec, grid, block, smem, stream);
}

}  // namespace

// Returns a cudaError_t: 0 on success. xq [B,H,W,C] int8, wq [k,k,C] int8,
// scale and bias [C] f32, y [B,Ho,Wo,C] bf16 (out_f32 0) or f32 (out_f32 1),
// Ho = (H + pt + pb - k) / stride + 1 and Wo likewise; k 3 or 5, stride 1 or
// 2, act 0 none, 1 SiLU, 2 GELU (tanh), 3 GELU (erf).
extern "C" int dfd_int8_depthwise(const void* x, const void* w, const void* scale,
                                  const void* bias, void* y, int B, int H, int W, int C, int k,
                                  int stride, int pt, int pb, int pl, int pr, int act,
                                  int out_f32, void* stream) {
  if ((k != 3 && k != 5) || (stride != 1 && stride != 2) || act < 0 || act > 3 || B < 1 ||
      H < 1 || W < 1 || C < 1 || pt < 0 || pb < 0 || pl < 0 || pr < 0)
    return cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.y = y;
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = C;
  p.pt = pt;
  p.pl = pl;
  p.act = act;
  const int hp = H + pt + pb, wp = W + pl + pr;
  if (hp < k || wp < k) return cudaErrorInvalidValue;
  p.Ho = (hp - k) / stride + 1;
  p.Wo = (wp - k) / stride + 1;
  if (static_cast<long long>(B) * p.Ho > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int groups = (C + 3) / 4;
  p.TX = groups < 32 ? groups : 32;
  p.TY = kThreads / p.TX;
  p.units = (p.Wo + kNPX - 1) / kNPX;
  p.R = p.TY / p.units > 1 ? p.TY / p.units : 1;
  const bool vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % (out_f32 ? 16 : 8) == 0;
  const long long rows = static_cast<long long>(B) * p.Ho;
  const dim3 grid(static_cast<unsigned>((rows + p.R - 1) / p.R),
                  static_cast<unsigned>((groups + p.TX - 1) / p.TX));
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const dim3 block(p.TX, p.TY);
  const size_t smem = sizeof(char4) * k * k * p.TX;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(out_f32 ? dispatch<float>(p, k, stride, vec, grid, block, smem, s)
                                  : dispatch<__nv_bfloat16>(p, k, stride, vec, grid, block,
                                                            smem, s));
}
