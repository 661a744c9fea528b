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
//   N <= 128, d <= 128, and a plan (below) within a block's 227 KB.
//   No padding: rows past N are zero in shared memory and never stored,
//   columns past N are -inf before the softmax.
// Bound on the H100: HBM bytes. A window and head read q, k, v and do
//   (4*N*d*2 bytes) and write dq, dk, dv (3*N*d*2) for five products of
//   2*N*N*d flops: ~7 flops per byte at N 53, far below the ~295 flop/byte
//   bf16 line. A launch at official stage 3 (512 windows, N 53, C 384)
//   moves 146 MB, 0.044 ms at 3.35 TB/s; one FasterViT-2 fine-tune step at
//   batch 128 moves ~1.5 GB over 13 launches (0.450 ms).
// Measured (chip_smoke.py phase 1, device time, H100 80GB HBM3 at 700 W):
//   0.105 ms a launch at official stage 3 (1.39 TB/s, 2.4x the bound; the
//   one-group-a-block kernel this replaced took 0.369 in turns), 1.124 ms
//   per official fine-tune step and 0.892 per tpu one, where SDPA's backward
//   takes 2.234 and 3.651.
//
// Design. Persistent blocks of 8 warps, one a SM: the grid holds H * P
//   blocks, P = the SMs over the heads (at most the windows), and block
//   (h, i) owns head h's windows [i B / P, (i + 1) B / P), a fixed, even
//   split with no wave tail. In the block two warp groups run a pipeline
//   over its windows through shared memory, synchronised by mbarriers:
//   - the row group (warps 0-3, one 16-query-row tile a warp; two at
//     N > 64; at N <= 48 the warps without a tile leave) recomputes
//     s = q k^T and dp = do v^T on the tensor cores (mma.sync m16n8k16,
//     both operands by ldmatrix), the softmax on the
//     accumulator registers (the quotient from one reciprocal a row,
//     corrected to IEEE division's result), the row term and ds; it adds ds
//     into its thread's own dbias elements, in registers across the block's
//     windows (in shared memory, at a padded stride, at N > 64), and writes
//     bf16(p) and bf16(ds) to one of two p/ds buffers;
//   - the column group (warps 4-7) stages the windows' q, k, v and do into
//     a ring of slots with 16-byte cp.async (completion counted on the
//     slot's mbarrier, cp.async.mbarrier.arrive.noinc), SLOTS - 1 windows
//     ahead of the row group; where 16-byte copies are not allowed (d or a
//     stride not a multiple of 8, an unaligned view) it copies element by
//     element. It computes dq = bf16(ds) k (a query tile a warp), and dv =
//     bf16(p)^T do and dk = bf16(ds)^T q on separate warps (warps 4-5 dv,
//     6-7 dk, two key tiles each), every transposed operand by
//     ldmatrix.trans, while the row group works on the next window.
//   The bias of the block's head stays in the row group's registers, the
//   mask folded in (at N > 64 it is read from L1). Each
//   block writes its dbias partial once; a second kernel sums each head's P
//   partials in order. No float atomics: two runs give bit-identical dqkv
//   and dbias.
// Plan (bwd_plan below; ops/window_attn.py bwd_plan mirrors it): the
//   deepest ring of up to 4 slots that fits 227 KB with two p/ds buffers,
//   else 2 slots and one buffer, else 1 and 1 (N 128 at d 80). FasterViT-2,
//   fine-tune batch 128, 132 SMs:
//     shape (windows, N, C, heads)  P  grid  windows/block  slots  buffers  shared memory
//     official (512, 53, 384, 8)   16   128        32          4        2       151,680
//     official (128, 49, 768, 16)   8   128        16          4        2       151,680
//     tpu (512, 53, 384, 3)        44   132     11 - 12        2        2       176,256
//     tpu (128, 49, 768, 6)        22   132      5 - 6         2        2       176,256
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"
#include "window_attn_common.cuh"
#include "window_attn_pipe.cuh"

namespace {

constexpr int kBwdThreads = 2 * kGroup;
constexpr int kMaxSlots = 4;                    // the input ring's deepest
constexpr int kBarrierBytes = 128;              // full[kMaxSlots], pfull[2], pempty[2]

// Shared memory of a plan: the barriers, `slots` windows' q, k, v and do
// (bf16, row stride Dp + 8), `buffers` pairs of bf16 p and ds (row stride
// Np + 8), and at N > 64 the f32 dbias accumulator (row stride Np + 8).
__host__ __device__ constexpr int bwd_smem_bytes(int Np, int Dp, int slots, int buffers) {
  return kBarrierBytes + slots * 4 * Np * (Dp + 8) * 2 + buffers * 2 * Np * (Np + 8) * 2 +
         (Np > 64 ? Np * (Np + 8) * 4 : 0);
}

struct BwdPlan {
  int per_head;  // blocks a head, each owning a contiguous range of its windows
  int slots;     // windows in the input ring
  int buffers;   // p/ds buffers
  int smem;      // bytes of dynamic shared memory
};

// The launch plan; slots == 0 when none fits.
__host__ __device__ inline BwdPlan bwd_plan(int B, int N, int heads, int d, int sms) {
  const int Np = pad16(N), Dp = pad16(d);
  BwdPlan p{0, 0, 0, 0};
  for (int s = kMaxSlots; s >= 2 && p.slots == 0; --s)
    if (bwd_smem_bytes(Np, Dp, s, 2) <= kMaxSmemBytes) p = {0, s, 2, bwd_smem_bytes(Np, Dp, s, 2)};
  for (int s = 2; s >= 1 && p.slots == 0; --s)
    if (bwd_smem_bytes(Np, Dp, s, 1) <= kMaxSmemBytes) p = {0, s, 1, bwd_smem_bytes(Np, Dp, s, 1)};
  const int fill = sms / heads;
  p.per_head = fill < 1 ? 1 : (fill < B ? fill : B);
  return p;
}

// KT bounds the 16-token tiles (N <= 16 KT), DT the 16-wide d tiles (d <= 16 DT);
// the loops run over the actual counts, kt and dt.
template <int KT, int DT>
__global__ void __launch_bounds__(kBwdThreads, 1)
    window_attention_bwd_kernel(View q, View k, View v, View dout, const float* __restrict__ bias,
                                __nv_bfloat16* __restrict__ dqkv, long long g_sb, long long g_sr,
                                float* __restrict__ partial, int B, int N, int heads, int d,
                                int per_head, int slots, int buffers, float scale, int vec) {
  constexpr bool kRegAcc = KT <= 4;  // one query tile a row warp: dbias and bias in registers
  extern __shared__ __align__(16) unsigned char smem[];
  const int kt = (N + 15) / 16, dt = (d + 15) / 16;
  const int Np = kt * 16, Dp = dt * 16, ld = Dp + 8, ldp = Np + 8;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // a slot's window has landed
  uint64_t* pfull = full + kMaxSlots;                  // a buffer's p and ds are written
  uint64_t* pempty = pfull + 2;                        // a buffer's p and ds are read
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + kBarrierBytes);
  __nv_bfloat16* pds = ring + slots * 4 * Np * ld;
  float* acc = reinterpret_cast<float*>(pds + buffers * 2 * Np * ldp);  // N > 64 only

  const int h = blockIdx.x / per_head, part = blockIdx.x % per_head;
  const int b_first = static_cast<int>(static_cast<long long>(part) * B / per_head);
  const int windows = static_cast<int>(static_cast<long long>(part + 1) * B / per_head) - b_first;
  const int C = heads * d;

  // Rows past N and columns past d stay zero: the copies never write them.
  {
    uint4* z = reinterpret_cast<uint4*>(ring);
    const int n16 = (bwd_smem_bytes(Np, Dp, slots, buffers) - kBarrierBytes) / 16;
    for (int i = threadIdx.x; i < n16; i += kBwdThreads) z[i] = make_uint4(0, 0, 0, 0);
  }
  // At N <= 48 the row warps past the last query tile have no work: they
  // leave at once, and pfull counts only the row warps that own a tile (each
  // of which waits on pempty before it writes a buffer and arrives).
  const int row_warps = kt < kGroupWarps ? kt : kGroupWarps;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMaxSlots; ++s) mbar_init(&full[s], kGroup);
    for (int i = 0; i < 2; ++i) {
      mbar_init(&pfull[i], 32 * row_warps);
      mbar_init(&pempty[i], kGroup);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;  // mma group (row) and thread in group
  const int tile_row = lane & 15, tile_col = (lane >> 4) * 8;  // ldmatrix: A rows, trans B rows
  const int key_row = (lane & 7) + ((lane >> 4) << 3), key_col = ((lane >> 3) & 1) * 8;

  if (warp >= kGroupWarps) {
    // ---- column group: the ring's copies, then dq, dv and dk per window
    const int cw = warp - kGroupWarps, t = threadIdx.x - kGroup;
    const View src[4] = {q, k, v, dout};
    const int first = windows < slots ? windows : slots;
    for (int j = 0; j < first; ++j)
      load_window(ring + j * 4 * Np * ld, src, b_first + j, h, N, d, Np, ld, vec, &full[j], t);
    const bool is_dk = cw >= 2;  // warps 4-5: dv, 6-7: dk
#pragma unroll 1
    for (int j = 0; j < windows; ++j) {
      const int s = j % slots, buf = j % buffers;
      mbar_wait(&full[s], (j / slots) & 1);
      mbar_wait(&pfull[buf], (j / buffers) & 1);
      const __nv_bfloat16* qs = ring + s * 4 * Np * ld;
      const __nv_bfloat16* ks = qs + Np * ld;
      const __nv_bfloat16* dos = ks + 2 * Np * ld;
      const __nv_bfloat16* ps = pds + buf * 2 * Np * ldp;
      const __nv_bfloat16* gs = ps + Np * ldp;  // bf16(ds)
      __nv_bfloat16* dq_bh = dqkv + (b_first + j) * g_sb + h * d;

      // dq = bf16(ds) k * scale: ds rows as A, k [key][d] as B by ldmatrix.trans
      for (int mt = cw; mt < kt; mt += kGroupWarps) {
        float o[2 * DT][4];
#pragma unroll
        for (int nt = 0; nt < 2 * DT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[nt][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          if (kk >= kt) continue;
          uint32_t a[4];
          ldmatrix_x4(a, gs + (mt * 16 + tile_row) * ldp + kk * 16 + tile_col);
#pragma unroll
          for (int np = 0; np < DT; ++np) {
            if (np >= dt) continue;
            uint32_t bb[4];
            ldmatrix_x4_trans(bb, ks + (kk * 16 + tile_row) * ld + np * 16 + tile_col);
            mma_bf16_16816(o[2 * np], a, bb[0], bb[1]);
            mma_bf16_16816(o[2 * np + 1], a, bb[2], bb[3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 2 * DT; ++nt)
          if (nt < 2 * dt)
            store_pair_rows(dq_bh, g_sr, o[nt], mt * 16 + g, nt * 8 + 2 * t4, N, d, scale, vec);
      }

      // dv = bf16(p)^T do (warps 4-5), dk = bf16(ds)^T q * scale (warps 6-7):
      // the transposed p or ds as A and do or q [query][d] as B, both by
      // ldmatrix.trans, contracting over the query rows
      const __nv_bfloat16* lhs = is_dk ? gs : ps;
      const __nv_bfloat16* rhs = is_dk ? qs : dos;
      __nv_bfloat16* out_bh = dq_bh + (is_dk ? C : 2 * C);
      const float mult = is_dk ? scale : 1.0f;
      for (int jt = cw & 1; jt < kt; jt += 2) {
        float o[2 * DT][4];
#pragma unroll
        for (int nt = 0; nt < 2 * DT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[nt][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          if (kk >= kt) continue;
          uint32_t a[4];
          ldmatrix_x4_trans(a, lhs + (kk * 16 + key_row) * ldp + jt * 16 + key_col);
#pragma unroll
          for (int np = 0; np < DT; ++np) {
            if (np >= dt) continue;
            uint32_t bb[4];
            ldmatrix_x4_trans(bb, rhs + (kk * 16 + tile_row) * ld + np * 16 + tile_col);
            mma_bf16_16816(o[2 * np], a, bb[0], bb[1]);
            mma_bf16_16816(o[2 * np + 1], a, bb[2], bb[3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 2 * DT; ++nt)
          if (nt < 2 * dt)
            store_pair_rows(out_bh, g_sr, o[nt], jt * 16 + g, nt * 8 + 2 * t4, N, d, mult, vec);
      }
      mbar_arrive(&pempty[buf]);
      if (j + slots < windows) {
        named_sync(1, kGroup);  // every column warp is done with slot s
        load_window(ring + s * 4 * Np * ld, src, b_first + j + slots, h, N, d, Np, ld, vec,
                    &full[s], t);
      }
    }
    return;
  }

  // ---- row group: s, dp, the softmax and ds of one query tile a warp
  if (warp >= row_warps) return;
  const float* bias_h = bias + static_cast<long long>(h) * N * N;
  // At N <= 64 this thread's dbias elements and their bias stay in registers,
  // the bias with the mask folded in: -inf on columns past N, 0 on rows past
  // N (whose scores are 0: their q rows are zero), so s * scale + bias is the
  // masked score everywhere.
  float db[kRegAcc ? 2 * KT : 1][4] = {};
  float br[kRegAcc ? 2 * KT : 1][4] = {};
  if constexpr (kRegAcc) {
    const int r0 = warp * 16 + g, r1 = r0 + 8;
#pragma unroll
    for (int nt = 0; nt < 2 * KT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nt * 8 + 2 * t4 + e;
        br[nt][e] = c >= N ? -INFINITY : r0 < N ? bias_h[r0 * N + c] : 0.0f;
        br[nt][2 + e] = c >= N ? -INFINITY : r1 < N ? bias_h[r1 * N + c] : 0.0f;
      }
  }
#pragma unroll 1
  for (int j = 0; j < windows; ++j) {
    const int s_ = j % slots, buf = j % buffers;
    mbar_wait(&full[s_], (j / slots) & 1);
    const __nv_bfloat16* qs = ring + s_ * 4 * Np * ld;
    const __nv_bfloat16* ks = qs + Np * ld;
    const __nv_bfloat16* vs = ks + Np * ld;
    const __nv_bfloat16* dos = vs + Np * ld;
    __nv_bfloat16* ps = pds + buf * 2 * Np * ldp;
    __nv_bfloat16* gs = ps + Np * ldp;
#pragma unroll 1
    for (int mt = warp; mt < kt; mt += kGroupWarps) {
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
        uint32_t aq[4], ad[4];
        ldmatrix_x4(aq, qs + (mt * 16 + tile_row) * ld + kk * 16 + tile_col);
        ldmatrix_x4(ad, dos + (mt * 16 + tile_row) * ld + kk * 16 + tile_col);
#pragma unroll
        for (int np = 0; np < KT; ++np) {
          if (np >= kt) continue;
          uint32_t bk[4], bv[4];
          ldmatrix_x4(bk, ks + (np * 16 + key_row) * ld + kk * 16 + key_col);
          ldmatrix_x4(bv, vs + (np * 16 + key_row) * ld + kk * 16 + key_col);
          mma_bf16_16816(s[2 * np], aq, bk[0], bk[1]);
          mma_bf16_16816(s[2 * np + 1], aq, bk[2], bk[3]);
          mma_bf16_16816(dp[2 * np], ad, bv[0], bv[1]);
          mma_bf16_16816(dp[2 * np + 1], ad, bv[2], bv[3]);
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
          if constexpr (kRegAcc) {
            v0 = __fadd_rn(__fmul_rn(s[nt][e], scale), br[kRegAcc ? nt : 0][e]);
            v1 = __fadd_rn(__fmul_rn(s[nt][2 + e], scale), br[kRegAcc ? nt : 0][2 + e]);
          } else if (c < N) {
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
      // p in f32 (zero on rows past N), the quotient correctly rounded from
      // one reciprocal a row; the row term sum(dp * p)
      const float i0 = __frcp_rn(l0), i1 = __frcp_rn(l1);
      float t0 = 0.0f, t1 = 0.0f;
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt) {
        if (nt >= 2 * kt) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[nt][e] = r0 < N ? quotient(s[nt][e], l0, i0) : 0.0f;
          s[nt][2 + e] = r1 < N ? quotient(s[nt][2 + e], l1, i1) : 0.0f;
          t0 += __fmul_rn(dp[nt][e], s[nt][e]);
          t1 += __fmul_rn(dp[nt][2 + e], s[nt][2 + e]);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        t0 += __shfl_xor_sync(0xffffffffu, t0, off);
        t1 += __shfl_xor_sync(0xffffffffu, t1, off);
      }

      // ds = p (dp - t) into dp's registers; this thread's dbias elements;
      // bf16(p) and bf16(ds) to the buffer once the column group has read
      // its previous window.
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt) {
        if (nt >= 2 * kt) continue;
        const int c = nt * 8 + 2 * t4;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          dp[nt][e] = __fmul_rn(s[nt][e], __fsub_rn(dp[nt][e], t0));
          dp[nt][2 + e] = __fmul_rn(s[nt][2 + e], __fsub_rn(dp[nt][2 + e], t1));
        }
        if constexpr (kRegAcc) {
#pragma unroll
          for (int e = 0; e < 4; ++e) db[nt][e] = __fadd_rn(db[nt][e], dp[nt][e]);
        } else {
          float2* a0 = reinterpret_cast<float2*>(acc + r0 * ldp + c);
          float2* a1 = reinterpret_cast<float2*>(acc + r1 * ldp + c);
          const float2 x0 = *a0, x1 = *a1;
          *a0 = make_float2(__fadd_rn(x0.x, dp[nt][0]), __fadd_rn(x0.y, dp[nt][1]));
          *a1 = make_float2(__fadd_rn(x1.x, dp[nt][2]), __fadd_rn(x1.y, dp[nt][3]));
        }
      }
      if (j >= buffers) mbar_wait(&pempty[buf], ((j / buffers) - 1) & 1);
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt) {
        if (nt >= 2 * kt) continue;
        const int c = nt * 8 + 2 * t4;
        *reinterpret_cast<uint32_t*>(ps + r0 * ldp + c) = pack_bf16(s[nt][0], s[nt][1]);
        *reinterpret_cast<uint32_t*>(ps + r1 * ldp + c) = pack_bf16(s[nt][2], s[nt][3]);
        *reinterpret_cast<uint32_t*>(gs + r0 * ldp + c) = pack_bf16(dp[nt][0], dp[nt][1]);
        *reinterpret_cast<uint32_t*>(gs + r1 * ldp + c) = pack_bf16(dp[nt][2], dp[nt][3]);
      }
    }
    mbar_arrive(&pfull[buf]);
  }

  // This block's dbias partial, each element written by its owner.
  float* out = partial + (static_cast<long long>(h) * per_head + part) * N * N;
  for (int mt = warp; mt < kt; mt += kGroupWarps) {
    const int r0 = mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < 2 * KT; ++nt) {
      if (nt >= 2 * kt) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + (e >> 1) * 8, c = nt * 8 + 2 * t4 + (e & 1);
        if (r >= N || c >= N) continue;
        out[r * N + c] = kRegAcc ? db[kRegAcc ? nt : 0][e] : acc[r * ldp + c];
      }
    }
  }
}

// dbias[h][i] = the sum of head h's `parts` partials at i, in order.
__global__ void dbias_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dbias,
                                    int parts, long long plane, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long h = i / plane, e = i - h * plane;
  const float* src = partial + h * parts * plane + e;
  float sum = 0.0f;
  for (int p = 0; p < parts; ++p) sum = __fadd_rn(sum, src[p * plane]);
  dbias[i] = sum;
}

template <int KT, int DT>
cudaError_t launch(View q, View k, View v, View dout, const float* bias, __nv_bfloat16* dqkv,
                   float* partial, float* dbias, int B, int N, int heads, int d, const BwdPlan& p,
                   float scale, int vec, cudaStream_t stream) {
  auto kernel = window_attention_bwd_kernel<KT, DT>;
  if (p.smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return e;
  }
  const long long C = static_cast<long long>(heads) * d;
  kernel<<<heads * p.per_head, kBwdThreads, p.smem, stream>>>(
      q, k, v, dout, bias, dqkv, N * 3 * C, 3 * C, partial, B, N, heads, d, p.per_head, p.slots,
      p.buffers, scale, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long plane = static_cast<long long>(N) * N, total = heads * plane;
  const int threads = 256;
  dbias_reduce_kernel<<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0,
                        stream>>>(partial, dbias, p.per_head, plane, total);
  return cudaGetLastError();
}

}  // namespace

// The backward's launch plan for a shape on a card of `sms` SMs: {blocks a
// head, slots, p/ds buffers, shared memory bytes}. Returns a cudaError_t: 0,
// or cudaErrorInvalidValue (and zeros) when the shape is out of range or no
// plan fits.
extern "C" int dfd_window_attention_bwd_plan(int B, int N, int heads, int d, int sms, int* plan) {
  for (int i = 0; i < 4; ++i) plan[i] = 0;
  if (B < 1 || N < 1 || N > 128 || heads < 1 || d < 1 || d > 128 || sms < 1)
    return cudaErrorInvalidValue;
  const BwdPlan p = bwd_plan(B, N, heads, d, sms);
  if (p.slots == 0) return cudaErrorInvalidValue;
  plan[0] = p.per_head;
  plan[1] = p.slots;
  plan[2] = p.buffers;
  plan[3] = p.smem;
  return cudaSuccess;
}

// Returns a cudaError_t: 0 on success. qkv [B, N, 3C] and dout [B, N, C]
// with unit feature stride and (batch, row) strides in elements; dqkv
// contiguous [B, N, 3C]; partial f32 scratch of `planes` [N, N] planes, at
// least heads x the plan's blocks a head (for a card of `sms` SMs); dbias
// [heads, N, N] f32. vec = 1 promises d % 8 == 0, every stride % 8 == 0 and
// 16-byte aligned qkv, dout and dqkv, for 16-byte copies and 4-byte stores.
extern "C" int dfd_window_attention_bwd(const void* qkv, const void* dout, const void* bias,
                                        void* dqkv, void* partial, long long planes, void* dbias,
                                        int B, int N, int heads, int d, long long qkv_sb,
                                        long long qkv_sr, long long do_sb, long long do_sr,
                                        int sms, float scale, int vec, void* stream) {
  int plan[4];
  const int rc = dfd_window_attention_bwd_plan(B, N, heads, d, sms, plan);
  if (rc != 0 || static_cast<long long>(heads) * plan[0] > planes ||
      static_cast<long long>(heads) * plan[0] > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const BwdPlan p{plan[0], plan[1], plan[2], plan[3]};
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
        launch<4, 4>(qv, kv, vv, dv, bs, g, part, db, B, N, heads, d, p, scale, vec, st));
  if (small_n)
    return static_cast<int>(
        launch<4, 8>(qv, kv, vv, dv, bs, g, part, db, B, N, heads, d, p, scale, vec, st));
  if (small_d)
    return static_cast<int>(
        launch<8, 4>(qv, kv, vv, dv, bs, g, part, db, B, N, heads, d, p, scale, vec, st));
  return static_cast<int>(
      launch<8, 8>(qv, kv, vv, dv, bs, g, part, db, B, N, heads, d, p, scale, vec, st));
}
