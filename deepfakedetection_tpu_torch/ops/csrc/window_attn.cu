// K5 forward: multi-head attention over short token windows, with a per-head
// additive bias.
//
// Replaces: deepfakedetection_tpu/ops/pallas/window_attn.py,
//   fused_window_attention_v2 (_attn_kernel_v2, :799, the head-masked eval
//   forward that FasterViT's TokenAttention takes for N >= 32),
//   fused_window_attention_v5 (_attn_kernel_v5, :265, the sliced-head forward)
//   and fused_window_attention (_attn_kernel, :831, the [B, h, Np, Dp] v1
//   layout). The three compute one function and differ only in how they fit
//   the TPU's 128 lanes, so one kernel serves them, through strides.
// Contract: q, k, v, out are [B, N, h, d] bf16 reached through (batch, row,
//   head) strides with unit stride along d (the natural layout is three views
//   of one qkv [B, N, 3C] tensor, features ordered [3, h, d]); bias [h, N, N]
//   f32. Per window b and head h:
//     s   = (q_h . k_h^T accumulated in f32) * scale + bias[h]
//     p   = exp(s - max s) / sum exp(s - max s), in f32, rounded to bf16
//     out = p . v_h accumulated in f32, rounded to bf16.
//   N <= 128 and d <= 128. No padding: the TPU pads N to its tile and puts
//   -1e9 on the padded key columns; here the ragged edge of the 16-row mma
//   tiles is masked inside the kernel (columns >= N are -inf, rows >= N are
//   never stored).
// Bound on the H100: HBM bytes. At the FasterViT-2 eval shapes (53 and 49
//   tokens, d 48 or 128) a window and head read 3*N*d*2 bytes and write N*d*2
//   for 4*N*N*d flops: ~26 flops per byte, far below the ~295 flop/byte bf16
//   line. One stage-3 launch at batch 256 moves 167 MB (~50 us at 3.35 TB/s)
//   for 4.4 GFLOP (~4.5 us on the tensor cores).
// Design: one block of 4 warps per (window, head). The block stages q_h, k_h
//   and v_h in shared memory (16-byte loads when the strides allow, zero rows
//   past N and columns past d), so the scores never reach device memory.
//   Each warp owns 16-query-row tiles: s = q k^T on the tensor cores
//   (mma.sync m16n8k16, bf16 in, f32 accumulate) into registers, the softmax
//   on those registers with the row max and sum reduced across the four
//   threads that share a row, and the bf16 probabilities fed straight back as
//   the A operand of p v (the accumulator layout of two 8-column tiles is the
//   A layout of one 16-column tile). Shared-memory rows are padded by 8
//   elements so the fragment loads hit distinct banks. The scale, bias add,
//   subtraction and division use exactly rounded f32 operations, as the plain
//   version computes them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "window_attn_common.cuh"

namespace {

// KT bounds the 16-key tiles (N <= 16 KT), DT the 16-wide d tiles (d <= 16 DT);
// the loops run over the actual counts, kt and dt.
template <int KT, int DT>
__global__ void __launch_bounds__(kWarps * 32)
    window_attention_kernel(View q, View k, View v, const float* __restrict__ bias,
                            __nv_bfloat16* __restrict__ out, long long o_sb, long long o_sr,
                            long long o_sh, int N, int heads, int d, float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kt = (N + 15) / 16, dt = (d + 15) / 16;
  const int Np = kt * 16, Dp = dt * 16, ld = Dp + 8, ldw = ld / 2;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + Np * ld;
  __nv_bfloat16* vs = ks + Np * ld;
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;

  stage(qs, q.p + b * q.sb + h * q.sh, q.sr, N, d, Np, Dp, ld, vec);
  stage(ks, k.p + b * k.sb + h * k.sh, k.sr, N, d, Np, Dp, ld, vec);
  stage(vs, v.p + b * v.sb + h * v.sh, v.sr, N, d, Np, Dp, ld, vec);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;  // mma group (row) and thread in group
  const uint32_t* qs32 = reinterpret_cast<const uint32_t*>(qs);
  const uint32_t* ks32 = reinterpret_cast<const uint32_t*>(ks);
  const float* bias_h = bias + static_cast<long long>(h) * N * N;
  __nv_bfloat16* out_bh = out + b * o_sb + h * o_sh;

  for (int mt = warp; mt < kt; mt += kWarps) {
    const int r0 = mt * 16 + g, r1 = r0 + 8;  // the two rows this thread holds

    // s = q k^T: 2*kt tiles of 8 keys.
    float s[2 * KT][4];
#pragma unroll
    for (int nt = 0; nt < 2 * KT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
    const uint32_t* qa = qs32 + r0 * ldw + t4;
    const uint32_t* qb = qa + 8 * ldw;
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

    // Scale, bias, mask; the row max over the quad that shares the row.
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

    // p = e / l in bf16, as the A fragments of p v: key tile j is the score
    // tiles 2j (columns 0-7) and 2j+1 (columns 8-15).
    uint32_t p[KT][4];
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      if (j >= kt) continue;
      p[j][0] = pack_bf16(__fdiv_rn(s[2 * j][0], l0), __fdiv_rn(s[2 * j][1], l0));
      p[j][1] = pack_bf16(__fdiv_rn(s[2 * j][2], l1), __fdiv_rn(s[2 * j][3], l1));
      p[j][2] = pack_bf16(__fdiv_rn(s[2 * j + 1][0], l0), __fdiv_rn(s[2 * j + 1][1], l0));
      p[j][3] = pack_bf16(__fdiv_rn(s[2 * j + 1][2], l1), __fdiv_rn(s[2 * j + 1][3], l1));
    }

    // out = p v: 2*dt tiles of 8 columns of d.
    float o[2 * DT][4];
#pragma unroll
    for (int nt = 0; nt < 2 * DT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.0f;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      if (j >= kt) continue;
      const __nv_bfloat16* vrow = vs + (j * 16 + 2 * t4) * ld + g;
#pragma unroll
      for (int nt = 0; nt < 2 * DT; ++nt) {
        if (nt >= 2 * dt) continue;
        const __nv_bfloat16* vp = vrow + nt * 8;
        mma_bf16_16816(o[nt], p[j], pack_raw(vp[0], vp[ld]), pack_raw(vp[8 * ld], vp[9 * ld]));
      }
    }

#pragma unroll
    for (int nt = 0; nt < 2 * DT; ++nt) {
      if (nt >= 2 * dt) continue;
      store_pair_rows(out_bh, o_sr, o[nt], r0, nt * 8 + 2 * t4, N, d, 1.0f, vec);
    }
  }
}

template <int KT, int DT>
cudaError_t launch(View q, View k, View v, const float* bias, __nv_bfloat16* out, long long o_sb,
                   long long o_sr, long long o_sh, int B, int N, int heads, int d, float scale,
                   int vec, cudaStream_t stream) {
  const int Np = (N + 15) / 16 * 16, Dp = (d + 15) / 16 * 16;
  const size_t smem = 3 * static_cast<size_t>(Np) * (Dp + 8) * sizeof(__nv_bfloat16);
  if (smem > static_cast<size_t>(kMaxSmemBytes)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(window_attention_kernel<KT, DT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  window_attention_kernel<KT, DT><<<B * heads, kWarps * 32, smem, stream>>>(
      q, k, v, bias, out, o_sb, o_sr, o_sh, N, heads, d, scale, vec);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: 0 on success. Strides are in elements; vec = 1
// promises d % 8 == 0, every stride % 8 == 0 and 16-byte aligned q, k, v and
// out, for 16-byte loads and 4-byte stores.
extern "C" int dfd_window_attention(const void* q, const void* k, const void* v, const void* bias,
                                    void* out, int B, int N, int heads, int d, long long q_sb,
                                    long long q_sr, long long q_sh, long long k_sb, long long k_sr,
                                    long long k_sh, long long v_sb, long long v_sr, long long v_sh,
                                    long long o_sb, long long o_sr, long long o_sh, float scale,
                                    int vec, void* stream) {
  if (B < 1 || N < 1 || N > 128 || heads < 1 || d < 1 || d > 128 ||
      static_cast<long long>(B) * heads > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const View qv{static_cast<const __nv_bfloat16*>(q), q_sb, q_sr, q_sh};
  const View kv{static_cast<const __nv_bfloat16*>(k), k_sb, k_sr, k_sh};
  const View vv{static_cast<const __nv_bfloat16*>(v), v_sb, v_sr, v_sh};
  const float* bs = static_cast<const float*>(bias);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool small_n = N <= 64, small_d = d <= 64;
  if (small_n && small_d)
    return static_cast<int>(
        launch<4, 4>(qv, kv, vv, bs, o, o_sb, o_sr, o_sh, B, N, heads, d, scale, vec, st));
  if (small_n)
    return static_cast<int>(
        launch<4, 8>(qv, kv, vv, bs, o, o_sb, o_sr, o_sh, B, N, heads, d, scale, vec, st));
  if (small_d)
    return static_cast<int>(
        launch<8, 4>(qv, kv, vv, bs, o, o_sb, o_sr, o_sh, B, N, heads, d, scale, vec, st));
  return static_cast<int>(
      launch<8, 8>(qv, kv, vv, bs, o, o_sb, o_sr, o_sh, B, N, heads, d, scale, vec, st));
}
