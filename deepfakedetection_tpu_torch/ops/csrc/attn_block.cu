// K6 forward: FasterViT's whole attention sub-block in one kernel, the qkv
// projection, multi-head attention with a per-head bias, and the output
// projection.
//
// Replaces: deepfakedetection_tpu/ops/pallas/attn_block.py, _fwd_call
//   (:167, kernel _fwd_kernel :51), the forward of the attn_subblock
//   custom_vjp that FasterViT's TokenAttention takes under DFD_FUSED_ATTN.
// Contract: x [B, N, C] bf16 (contiguous); wqkv the qkv Linear's weight cast
//   to bf16 and laid out [3, heads, Dp, Cp] (rows = output features, zero
//   rows past d and columns past C; with d % 16 == 0 and C % 16 == 0 that is
//   the Linear's own [3C, C]); bqkv f32 [3, heads, Dp], zero past d; bias
//   [heads, N, N] f32; wproj bf16 [Cp, Cp] (the proj Linear's [C, C], zero
//   padded); bproj f32 [C]; out [B, N, C] bf16. Per window, as _fwd_kernel:
//     qkv = bf16(x . Wqkv^T accumulated in f32 + bqkv)
//     per head h: p = softmax(f32(q_h . k_h^T) * scale + bias[h]), rounded
//                 to bf16; ctx_h = bf16(p . v_h, f32 sums)
//     out = bf16(ctx . Wproj^T accumulated in f32 + bproj)
//   N <= 128, d = C / heads <= 128, and the block's shared memory (below)
//   within 227 KB. No padding of x: rows past N are zero in shared memory
//   and never stored, key columns past N are -inf before the softmax (the
//   TPU pads rows to 16 and puts -1e9 on the padded keys).
// Bound on the H100: tensor-core operations at the FasterViT-2 shapes. A
//   window reads x and writes out (4 N C bytes) for 2 N C (3C + C) + 4 N N C
//   flops: ~4,300 flops per byte of x and out at C 384, far above the ~295
//   flop/byte bf16 line (the weights are read once per launch by the bound;
//   the kernel reads them from L2 once per block: 0.88 MB of Wqkv and 0.29 MB
//   of Wproj at C 384, 3.5 MB and 1.2 MB at C 768).
// Design: one block of 8 warps per window. The block stages the window's x
//   in shared memory (16-byte loads where C and the base allow). Per head, the
//   warps share the head's 3 d qkv output columns in 8-column tiles: each
//   warp multiplies all of x's 16-row tiles by its tile's weight rows, read
//   from device memory straight into the mma B fragments (the Linear's
//   [out, in] layout is the col-major B operand), adds the f32 bias, rounds
//   once and writes q, k and v to shared memory: qkv never reaches device
//   memory. Each warp then takes 16-query-row tiles of the head's attention
//   as K5 does (scores, softmax and probabilities in registers) and writes the
//   head's ctx columns straight into the window's rows of out, which serve as
//   the ctx scratch: no other block touches them. After the last head the
//   block reads its ctx back over x in shared memory (__ldcg: from L2, past
//   L1) and computes out = ctx . Wproj^T + bproj the same way as qkv,
//   overwriting the scratch. Keeping ctx in shared memory instead would need
//   2 Np (C + 8) bf16 beside q, k and v: 250 KB at stage 4 of the tpu
//   configuration (C 768, d 128), over the 227 KB a block has.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attn_block_common.cuh"

namespace {

__host__ __device__ constexpr size_t fwd_smem_bytes(int Np, int Cp, int Dp) {
  // x then ctx (bf16, row stride Cp + 8); q, k, v of one head (row stride Dp + 8)
  return (static_cast<size_t>(Np) * (Cp + 8) + 3 * static_cast<size_t>(Np) * (Dp + 8)) *
         sizeof(__nv_bfloat16);
}

// Stages rows [0, Np) x columns [0, Cp) of src (row stride C) into dst (row
// stride ld), zero past N rows and C columns, loading through L2 (ld.cg): the
// block wrote src itself in this launch.
__device__ __forceinline__ void stage_cg(__nv_bfloat16* dst, const __nv_bfloat16* src, int N, int C,
                                         int Np, int Cp, int ld, bool vec) {
  if (vec) {  // C % 8 == 0, 16-byte aligned base
    const int chunks = Cp / 8;
    for (int i = threadIdx.x; i < Np * chunks; i += blockDim.x) {
      const int row = i / chunks, ch = i % chunks;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (row < N && ch * 8 < C)
        v = __ldcg(reinterpret_cast<const uint4*>(src + static_cast<long long>(row) * C + ch * 8));
      *reinterpret_cast<uint4*>(dst + row * ld + ch * 8) = v;
    }
  } else {
    for (int i = threadIdx.x; i < Np * Cp; i += blockDim.x) {
      const int row = i / Cp, col = i % Cp;
      unsigned short v = 0;
      if (row < N && col < C)
        v = __ldcg(reinterpret_cast<const unsigned short*>(src) + static_cast<long long>(row) * C +
                   col);
      dst[row * ld + col] = __ushort_as_bfloat16(v);
    }
  }
}

// KT bounds the 16-token tiles (N <= 16 KT), DT the 16-wide head tiles
// (d <= 16 DT); the loops run over the actual counts, kt and dt.
template <int KT, int DT>
__global__ void __launch_bounds__(kBlockWarps * 32)
    attn_block_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wqkv,
                      const float* __restrict__ bqkv, const float* __restrict__ bias,
                      const __nv_bfloat16* __restrict__ wproj, const float* __restrict__ bproj,
                      __nv_bfloat16* out, int N, int C, int heads, float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = C / heads, kt = (N + 15) / 16, dt = (d + 15) / 16;
  const int Np = kt * 16, Dp = dt * 16, Cp = pad16(C), ldx = Cp + 8, ld = Dp + 8;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* qs = xs + Np * ldx;
  __nv_bfloat16* ks = qs + Np * ld;
  __nv_bfloat16* vs = ks + Np * ld;
  const long long b = blockIdx.x;
  __nv_bfloat16* out_b = out + b * N * C;
  const bool pair = C % 2 == 0 && d % 2 == 0;  // 4-byte stores of column pairs
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;

  stage(xs, x + b * N * C, C, N, C, Np, Cp, ldx, vec);
  for (int hh = 0; hh < heads; ++hh) {
    __syncthreads();  // x staged; the previous head's attention is done with q, k, v
    qkv_head<KT>(qs, ks, vs, ld, xs, ldx, wqkv, bqkv, hh, heads, N, kt, Dp, Cp);
    __syncthreads();
    for (int mt = warp; mt < kt; mt += kBlockWarps) {
      float s[2 * KT][4];
      head_probs<KT, DT>(s, qs, ks, ld, mt, kt, dt, bias + static_cast<long long>(hh) * N * N, N,
                         scale);
      probs_times_v<KT, DT>(s, vs, ld, mt, kt, dt, out_b + hh * d, C, N, d, pair);
    }
  }
  __syncthreads();  // every head's ctx is in out_b
  stage_cg(xs, out_b, N, C, Np, Cp, ldx, vec);
  __syncthreads();

  // out = ctx . Wproj^T + bproj over 8-column tiles, shared by the warps
  const uint32_t* xs32 = reinterpret_cast<const uint32_t*>(xs);
  for (int j = warp; j < Cp / 8; j += kBlockWarps) {
    float acc[KT][4];
    rows_times_wt<KT>(acc, xs32, ldx / 2, kt, wproj + static_cast<long long>(j * 8 + g) * Cp, Cp);
    const int c = j * 8 + 2 * t4;
    const float b0 = c < C ? bproj[c] : 0.0f, b1 = c + 1 < C ? bproj[c + 1] : 0.0f;
#pragma unroll
    for (int m = 0; m < KT; ++m) {
      if (m >= kt) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m * 16 + g + 8 * half;
        if (row >= N || c >= C) continue;
        const float lo = __fadd_rn(acc[m][2 * half], b0), hi = __fadd_rn(acc[m][2 * half + 1], b1);
        __nv_bfloat16* dst = out_b + static_cast<long long>(row) * C + c;
        if (pair) {
          *reinterpret_cast<uint32_t*>(dst) = pack_bf16(lo, hi);
        } else {
          dst[0] = __float2bfloat16_rn(lo);
          if (c + 1 < C) dst[1] = __float2bfloat16_rn(hi);
        }
      }
    }
  }
}

template <int KT, int DT>
cudaError_t launch(const __nv_bfloat16* x, const __nv_bfloat16* wqkv, const float* bqkv,
                   const float* bias, const __nv_bfloat16* wproj, const float* bproj,
                   __nv_bfloat16* out, int B, int N, int C, int heads, float scale, int vec,
                   cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(pad16(N), pad16(C), pad16(C / heads));
  if (smem > static_cast<size_t>(kMaxSmemBytes)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(attn_block_kernel<KT, DT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  attn_block_kernel<KT, DT><<<B, kBlockWarps * 32, smem, stream>>>(
      x, wqkv, bqkv, bias, wproj, bproj, out, N, C, heads, scale, vec);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: 0 on success. vec = 1 promises C % 8 == 0 and
// 16-byte aligned x and out, for 16-byte loads of their rows.
extern "C" int dfd_attn_subblock(const void* x, const void* wqkv, const void* bqkv,
                                 const void* bias, const void* wproj, const void* bproj, void* out,
                                 int B, int N, int C, int heads, float scale, int vec,
                                 void* stream) {
  if (B < 1 || N < 1 || N > 128 || heads < 1 || C < heads || C % heads || C / heads > 128)
    return cudaErrorInvalidValue;
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wq = static_cast<const __nv_bfloat16*>(wqkv);
  const auto* bq = static_cast<const float*>(bqkv);
  const auto* bs = static_cast<const float*>(bias);
  const auto* wp = static_cast<const __nv_bfloat16*>(wproj);
  const auto* bp = static_cast<const float*>(bproj);
  auto* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool small_n = N <= 64, small_d = C / heads <= 64;
  if (small_n && small_d)
    return static_cast<int>(launch<4, 4>(xp, wq, bq, bs, wp, bp, o, B, N, C, heads, scale, vec, st));
  if (small_n)
    return static_cast<int>(launch<4, 8>(xp, wq, bq, bs, wp, bp, o, B, N, C, heads, scale, vec, st));
  if (small_d)
    return static_cast<int>(launch<8, 4>(xp, wq, bq, bs, wp, bp, o, B, N, C, heads, scale, vec, st));
  return static_cast<int>(launch<8, 8>(xp, wq, bq, bs, wp, bp, o, B, N, C, heads, scale, vec, st));
}
