// K5 backward: the gradients of multi-head window attention with a per-head
// additive bias.
//
// Replaces: deepfakedetection_tpu/ops/pallas/window_attn.py,
//   fused_window_attention_v2_bwd (_attn_bwd_kernel_v2, :397, lane-masked
//   over the full C), fused_window_attention_v5_bwd (_attn_bwd_kernel_v5,
//   :587, sliced heads, the default of window_attention_v2's custom_vjp) and
//   _headed_window_attention_bwd (_attn_bwd_kernel_v3, :636, a per-head
//   layout behind XLA transposes). The three compute one function and differ
//   only in how they fit the TPU's 128 lanes, so one kernel serves them.
// Contract: qkv [B, N, 3C] bf16 (features ordered [3, h, d]), bias [h, N, N]
//   f32, dout [B, N, C] bf16 -> dqkv [B, N, 3C] bf16 (dq | dk | dv) and
//   dbias [h, N, N] f32, the sum over windows. Per window b and head h, as
//   sliced_head_attention_bwd (:179) computes it:
//     s    = (q_h . k_h^T in f32) * scale + bias[h]
//     p    = exp(s - max s) / sum exp(s - max s), in f32
//     dv_h = bf16(bf16(p)^T . do_h, f32 sums)
//     dp   = do_h . v_h^T in f32
//     ds   = p * (dp - rowsum(dp * p)), f32, with the f32 p (not the
//            FlashAttention row term rowsum(do * o), which would read the
//            bf16-rounded o)
//     dbias[h] += ds
//     dq_h = bf16((bf16(ds) . k_h) * scale), dk_h = bf16((bf16(ds)^T . q_h) * scale).
//   N <= 128, d <= 128, and the block's shared memory (below) within 227 KB.
//   No padding: rows past N are zero in shared memory and never stored,
//   columns past N are -inf before the softmax.
// Bound on the H100: HBM bytes. A window and head read q, k, v and do
//   (4*N*d*2 bytes) and write dq, dk, dv (3*N*d*2) for five products of
//   2*N*N*d flops: ~7 flops per byte at N 53, far below the ~295 flop/byte
//   bf16 line. One FasterViT-2 fine-tune step at batch 128 moves ~1.5 GB over
//   13 launches (~0.45 ms at 3.35 TB/s) for ~56 GFLOP (~0.06 ms).
// Design: one block of 4 warps per (group of windows, head); the block loops
//   over its windows. Per window it stages q_h, k_h, v_h and do_h in shared
//   memory (16-byte loads when the strides allow). A row pass, each warp on
//   16-query-row tiles, recomputes the scores on the tensor cores (mma.sync
//   m16n8k16), the softmax on the accumulator registers, dp = do v^T, the
//   row term and ds; it adds ds into the block's f32 dbias accumulator in
//   shared memory, writes bf16(p) and bf16(ds) to shared memory and computes
//   dq from the ds registers (the accumulator layout of two 8-column tiles is
//   the A operand of one 16-column tile). A column pass, each warp on
//   16-key-row tiles, reads p and ds transposed from shared memory for
//   dv = p^T do and dk = ds^T q. dbias is a sum across blocks: Hopper's blocks
//   run in no order, so instead of the TPU's revisited block in a sequential
//   grid each block writes its partial sum (every element owned by one
//   thread, adding its windows in order) and a second kernel sums the
//   partials in group order. No float atomics: two runs give bit-identical
//   dbias.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "window_attn_common.cuh"

namespace {

__host__ __device__ constexpr size_t bwd_smem_bytes(int Np, int Dp) {
  // q, k, v, do (bf16, row stride Dp + 8); p, ds (bf16, row stride Np + 8);
  // the dbias accumulator (f32, Np x Np)
  return (4 * static_cast<size_t>(Np) * (Dp + 8) + 2 * static_cast<size_t>(Np) * (Np + 8)) *
             sizeof(__nv_bfloat16) +
         static_cast<size_t>(Np) * Np * sizeof(float);
}

// KT bounds the 16-token tiles (N <= 16 KT), DT the 16-wide d tiles (d <= 16 DT);
// the loops run over the actual counts, kt and dt.
template <int KT, int DT>
__global__ void __launch_bounds__(kWarps * 32)
    window_attention_bwd_kernel(View q, View k, View v, View dout, const float* __restrict__ bias,
                                __nv_bfloat16* __restrict__ dqkv, long long g_sb, long long g_sr,
                                float* __restrict__ partial, int B, int N, int heads, int d,
                                int per_block, float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kt = (N + 15) / 16, dt = (d + 15) / 16;
  const int Np = kt * 16, Dp = dt * 16, ld = Dp + 8, ldw = ld / 2, ldp = Np + 8;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + Np * ld;
  __nv_bfloat16* vs = ks + Np * ld;
  __nv_bfloat16* ds_ = vs + Np * ld;  // do_h
  __nv_bfloat16* ps = ds_ + Np * ld;  // bf16(p)
  __nv_bfloat16* gs = ps + Np * ldp;  // bf16(ds)
  float* acc = reinterpret_cast<float*>(gs + Np * ldp);  // dbias partial, Np x Np
  const int grp = blockIdx.x / heads, h = blockIdx.x % heads;
  const int b_first = grp * per_block, b_end = min(B, b_first + per_block);
  const int C = heads * d;

  for (int i = threadIdx.x; i < Np * Np; i += blockDim.x) acc[i] = 0.0f;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;  // mma group (row) and thread in group
  const uint32_t* qs32 = reinterpret_cast<const uint32_t*>(qs);
  const uint32_t* ks32 = reinterpret_cast<const uint32_t*>(ks);
  const uint32_t* vs32 = reinterpret_cast<const uint32_t*>(vs);
  const uint32_t* do32 = reinterpret_cast<const uint32_t*>(ds_);
  const float* bias_h = bias + static_cast<long long>(h) * N * N;

  for (int b = b_first; b < b_end; ++b) {
    __syncthreads();  // the previous window's column pass is done with the buffers
    stage(qs, q.p + b * q.sb + h * q.sh, q.sr, N, d, Np, Dp, ld, vec);
    stage(ks, k.p + b * k.sb + h * k.sh, k.sr, N, d, Np, Dp, ld, vec);
    stage(vs, v.p + b * v.sb + h * v.sh, v.sr, N, d, Np, Dp, ld, vec);
    stage(ds_, dout.p + b * dout.sb + h * dout.sh, dout.sr, N, d, Np, Dp, ld, vec);
    __syncthreads();
    __nv_bfloat16* dq_bh = dqkv + b * g_sb + h * d;

    // ---- row pass: 16 query rows per warp and tile
    for (int mt = warp; mt < kt; mt += kWarps) {
      const int r0 = mt * 16 + g, r1 = r0 + 8;  // the two rows this thread holds

      // s = q k^T and dp = do v^T: 2*kt tiles of 8 keys each.
      float s[2 * KT][4], dp[2 * KT][4];
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DT; ++kk) {
        if (kk >= dt) continue;
        const uint32_t* qa = qs32 + r0 * ldw + t4 + kk * 8;
        const uint32_t* da = do32 + r0 * ldw + t4 + kk * 8;
        const uint32_t aq[4] = {qa[0], qa[8 * ldw], qa[4], qa[8 * ldw + 4]};
        const uint32_t ad[4] = {da[0], da[8 * ldw], da[4], da[8 * ldw + 4]};
#pragma unroll
        for (int nt = 0; nt < 2 * KT; ++nt) {
          if (nt >= 2 * kt) continue;
          const uint32_t* kb = ks32 + (nt * 8 + g) * ldw + kk * 8 + t4;
          const uint32_t* vb = vs32 + (nt * 8 + g) * ldw + kk * 8 + t4;
          mma_bf16_16816(s[nt], aq, kb[0], kb[4]);
          mma_bf16_16816(dp[nt], ad, vb[0], vb[4]);
        }
      }

      // Scale, bias, mask; the softmax with the row max and sum over the quad.
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
      // p in f32 (zero on rows past N); the row term sum(dp * p)
      float t0 = 0.0f, t1 = 0.0f;
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt) {
        if (nt >= 2 * kt) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[nt][e] = r0 < N ? __fdiv_rn(s[nt][e], l0) : 0.0f;
          s[nt][2 + e] = r1 < N ? __fdiv_rn(s[nt][2 + e], l1) : 0.0f;
          t0 += __fmul_rn(dp[nt][e], s[nt][e]);
          t1 += __fmul_rn(dp[nt][2 + e], s[nt][2 + e]);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        t0 += __shfl_xor_sync(0xffffffffu, t0, off);
        t1 += __shfl_xor_sync(0xffffffffu, t1, off);
      }

      // ds = p (dp - t) into dp's registers; the f32 dbias accumulator (each
      // element owned by this thread); bf16(p) and bf16(ds) to shared memory.
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt) {
        if (nt >= 2 * kt) continue;
        const int c = nt * 8 + 2 * t4;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          dp[nt][e] = __fmul_rn(s[nt][e], __fsub_rn(dp[nt][e], t0));
          dp[nt][2 + e] = __fmul_rn(s[nt][2 + e], __fsub_rn(dp[nt][2 + e], t1));
          acc[r0 * Np + c + e] = __fadd_rn(acc[r0 * Np + c + e], dp[nt][e]);
          acc[r1 * Np + c + e] = __fadd_rn(acc[r1 * Np + c + e], dp[nt][2 + e]);
        }
        *reinterpret_cast<uint32_t*>(ps + r0 * ldp + c) = pack_bf16(s[nt][0], s[nt][1]);
        *reinterpret_cast<uint32_t*>(ps + r1 * ldp + c) = pack_bf16(s[nt][2], s[nt][3]);
        *reinterpret_cast<uint32_t*>(gs + r0 * ldp + c) = pack_bf16(dp[nt][0], dp[nt][1]);
        *reinterpret_cast<uint32_t*>(gs + r1 * ldp + c) = pack_bf16(dp[nt][2], dp[nt][3]);
      }

      // dq = bf16(ds) k * scale: bf16(ds) as the A fragments (key tile j is
      // the score tiles 2j and 2j+1), k as the B operand.
      uint32_t a[KT][4];
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        if (j >= kt) continue;
        a[j][0] = pack_bf16(dp[2 * j][0], dp[2 * j][1]);
        a[j][1] = pack_bf16(dp[2 * j][2], dp[2 * j][3]);
        a[j][2] = pack_bf16(dp[2 * j + 1][0], dp[2 * j + 1][1]);
        a[j][3] = pack_bf16(dp[2 * j + 1][2], dp[2 * j + 1][3]);
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
        store_pair_rows(dq_bh, g_sr, o, r0, nt * 8 + 2 * t4, N, d, scale, vec);
      }
    }
    __syncthreads();

    // ---- column pass: 16 key rows per warp and tile; dv = bf16(p)^T do,
    // then dk = bf16(ds)^T q * scale, both contracting over the query rows.
#pragma unroll 1
    for (int which = 0; which < 2; ++which) {
      const __nv_bfloat16* lhs = which ? gs : ps;
      const __nv_bfloat16* rhs = which ? qs : ds_;
      __nv_bfloat16* out_bh = dq_bh + (which ? C : 2 * C);
      const float mult = which ? scale : 1.0f;
      for (int jt = warp; jt < kt; jt += kWarps) {
        const int j0 = jt * 16;
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
          store_pair_rows(out_bh, g_sr, o, j0 + g, nt * 8 + 2 * t4, N, d, mult, vec);
        }
      }
    }
  }
  __syncthreads();
  float* part = partial + (static_cast<long long>(grp) * heads + h) * N * N;
  for (int i = threadIdx.x; i < N * N; i += blockDim.x) part[i] = acc[(i / N) * Np + i % N];
}

// dbias[i] = the sum of the groups' partials at i, in group order.
__global__ void dbias_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dbias,
                                    int groups, long long plane) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= plane) return;
  float sum = 0.0f;
  for (int gi = 0; gi < groups; ++gi) sum = __fadd_rn(sum, partial[gi * plane + i]);
  dbias[i] = sum;
}

template <int KT, int DT>
cudaError_t launch(View q, View k, View v, View dout, const float* bias, __nv_bfloat16* dqkv,
                   float* partial, float* dbias, int B, int N, int heads, int d, int per_block,
                   float scale, int vec, cudaStream_t stream) {
  const int Np = (N + 15) / 16 * 16, Dp = (d + 15) / 16 * 16;
  const size_t smem = bwd_smem_bytes(Np, Dp);
  if (smem > static_cast<size_t>(kMaxSmemBytes)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(window_attention_bwd_kernel<KT, DT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int groups = (B + per_block - 1) / per_block;
  const long long C = static_cast<long long>(heads) * d;
  window_attention_bwd_kernel<KT, DT><<<groups * heads, kWarps * 32, smem, stream>>>(
      q, k, v, dout, bias, dqkv, N * 3 * C, 3 * C, partial, B, N, heads, d, per_block, scale, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long plane = static_cast<long long>(heads) * N * N;
  const int threads = 256;
  dbias_reduce_kernel<<<static_cast<unsigned>((plane + threads - 1) / threads), threads, 0,
                        stream>>>(partial, dbias, groups, plane);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: 0 on success. qkv [B, N, 3C] and dout [B, N, C]
// with unit feature stride and (batch, row) strides in elements; dqkv
// contiguous [B, N, 3C]; partial [ceil(B / per_block), heads, N, N] f32
// scratch; dbias [heads, N, N] f32. vec = 1 promises d % 8 == 0, every stride
// % 8 == 0 and 16-byte aligned qkv, dout and dqkv, for 16-byte loads and
// 4-byte stores.
extern "C" int dfd_window_attention_bwd(const void* qkv, const void* dout, const void* bias,
                                        void* dqkv, void* partial, void* dbias, int B, int N,
                                        int heads, int d, long long qkv_sb, long long qkv_sr,
                                        long long do_sb, long long do_sr, int per_block,
                                        float scale, int vec, void* stream) {
  if (B < 1 || N < 1 || N > 128 || heads < 1 || d < 1 || d > 128 || per_block < 1 ||
      static_cast<long long>((B + per_block - 1) / per_block) * heads > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(qkv);
  const long long C = static_cast<long long>(heads) * d;
  const View qv{base, qkv_sb, qkv_sr, d};
  const View kv{base + C, qkv_sb, qkv_sr, d};
  const View vv{base + 2 * C, qkv_sb, qkv_sr, d};
  const View dv{static_cast<const __nv_bfloat16*>(dout), do_sb, do_sr, d};
  const float* bs = static_cast<const float*>(bias);
  __nv_bfloat16* g = static_cast<__nv_bfloat16*>(dqkv);
  float* part = static_cast<float*>(partial);
  float* db = static_cast<float*>(dbias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool small_n = N <= 64, small_d = d <= 64;
  if (small_n && small_d)
    return static_cast<int>(
        launch<4, 4>(qv, kv, vv, dv, bs, g, part, db, B, N, heads, d, per_block, scale, vec, st));
  if (small_n)
    return static_cast<int>(
        launch<4, 8>(qv, kv, vv, dv, bs, g, part, db, B, N, heads, d, per_block, scale, vec, st));
  if (small_d)
    return static_cast<int>(
        launch<8, 4>(qv, kv, vv, dv, bs, g, part, db, B, N, heads, d, per_block, scale, vec, st));
  return static_cast<int>(
      launch<8, 8>(qv, kv, vv, dv, bs, g, part, db, B, N, heads, d, per_block, scale, vec, st));
}
