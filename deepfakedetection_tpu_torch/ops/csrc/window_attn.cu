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
//   -1e9 on the padded key columns; here rows past N are zero in shared
//   memory and never stored, columns past N are -inf before the softmax.
// Bound on the H100: HBM bytes. At the FasterViT-2 eval shapes (53 and 49
//   tokens, d 48 or 128) a window and head read 3*N*d*2 bytes and write N*d*2
//   for 4*N*N*d flops: ~26 flops per byte, far below the ~295 flop/byte bf16
//   line. One stage-3 launch at batch 256 moves 167 MB (~50 us at 3.35 TB/s)
//   for 4.4 GFLOP (~4.5 us on the tensor cores).
// Measured (chip_smoke.py --parent, phase 1, device time, H100 80GB HBM3 at
//   700.00 W): 0.089 ms a launch at official stage 3 (1.88 TB/s, 1.8x the
//   bound), 0.078 at tpu stage 3 (1.5x); per FasterViT-2 forward at batch 256
//   0.956 ms official and 0.841 tpu, where SDPA's forward takes 4.420 and
//   2.004; in turns with the one-block-a-(window, head) kernel this replaced
//   0.864 against 2.191 and 0.788 against 1.776, with bit-identical outputs.
//
// Design. Persistent blocks, one a SM: the grid holds H * P blocks, P = the
//   SMs over the heads (at most the windows), and block (h, i) owns head h's
//   windows [i B / P, (i + 1) B / P), a fixed, even split with no wave tail;
//   the bias of head h is read once a block, not once a window. A block is G
//   warp groups of 4 warps (G = 4 at N <= 64 and d <= 64, else 2) that take
//   interleaved windows of its range (group g the windows g, g + G, ...),
//   each through its own ring of `slots` slots of q, k and v: the group's
//   threads copy a window's rows with 16-byte cp.async (completion counted on
//   the slot's mbarrier by cp.async.mbarrier.arrive.noinc), slots - 1
//   windows ahead of the one they compute, and refill a slot once all four
//   warps are done with it (a named barrier of the group); where 16-byte
//   copies are not allowed (d or a stride not a multiple of 8, an unaligned
//   view) they copy element by element. So G windows are computed at once
//   while later ones are in flight. Each warp owns a 16-query-row tile (two
//   at N > 64; at N <= 48 the warps without a tile only copy): s = q k^T on
//   the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate; q and k
//   by ldmatrix), the softmax on the accumulator registers with the row max
//   and sum reduced over the four threads that share a row, the quotient
//   from one reciprocal a row corrected to IEEE division's result, and the
//   bf16 probabilities fed straight back as the A operand of p v (v by
//   ldmatrix.trans). At N <= 64 the head's bias stays in the registers that
//   hold each thread's scores, the mask folded in (-inf on columns past N, 0
//   on rows past N, whose q rows are zero); at N > 64 it is read from L1.
//   The output tile is staged through the warp's own q rows (which it has
//   finished reading) and stored 16 bytes a thread. The products, the scale
//   and bias, the row max, expf, the sum, the quotient and the roundings are
//   those of the one-block-a-(window, head) kernel this replaced, in the same
//   order, so the two give bit-identical outputs.
// Plan (fwd_plan below; ops/window_attn.py fwd_plan mirrors it): G as above
//   and the deepest ring of up to 4 slots a group that fits 227 KB.
//   FasterViT-2, eval batch 256, 132 SMs:
//     shape (windows, N, C, heads)  P  grid  windows/block  groups  slots  shared memory
//     official (1024, 53, 384, 8)  16   128        64          4       2       172,160
//     official (256, 49, 768, 16)   8   128        32          4       2       172,160
//     tpu (1024, 53, 384, 3)       44   132     23 - 24        2       2       209,024
//     tpu (256, 49, 768, 6)        22   132     11 - 12        2       2       209,024
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"
#include "window_attn_common.cuh"
#include "window_attn_pipe.cuh"

namespace {

constexpr int kMaxGroups = 4;    // warp groups a block, on interleaved windows
constexpr int kFwdMaxSlots = 4;  // a group's deepest ring
constexpr int kFwdBarrierBytes = 8 * kMaxGroups * kFwdMaxSlots;  // full[groups][kFwdMaxSlots]

// Warp groups a block: four at N <= 64 and d <= 64 (one query tile a warp, a
// narrow head: each window is little work, so more are computed at once),
// else two (more registers a thread, and room for a ring of two).
__host__ __device__ constexpr int fwd_groups(int Np, int Dp) {
  return Np <= 64 && Dp <= 64 ? 4 : 2;
}

// Shared memory of a plan: the barriers and each group's `slots` windows of
// q, k and v (bf16, row stride Dp + 8).
__host__ __device__ constexpr int fwd_smem_bytes(int Np, int Dp, int slots) {
  return kFwdBarrierBytes + fwd_groups(Np, Dp) * slots * 3 * Np * (Dp + 8) * 2;
}

struct FwdPlan {
  int per_head;  // blocks a head, each owning a contiguous range of its windows
  int groups;    // warp groups a block
  int slots;     // windows in each group's ring
  int smem;      // bytes of dynamic shared memory
};

// The launch plan; slots == 0 when none fits.
__host__ __device__ inline FwdPlan fwd_plan(int B, int N, int heads, int d, int sms) {
  const int Np = pad16(N), Dp = pad16(d);
  FwdPlan p{0, fwd_groups(Np, Dp), 0, 0};
  for (int s = kFwdMaxSlots; s >= 1 && p.slots == 0; --s)
    if (fwd_smem_bytes(Np, Dp, s) <= kMaxSmemBytes) {
      p.slots = s;
      p.smem = fwd_smem_bytes(Np, Dp, s);
    }
  const int fill = sms / heads;
  p.per_head = fill < 1 ? 1 : (fill < B ? fill : B);
  return p;
}

// One warp's query tile mt of a window whose q, k and v rows sit in
// qs, ks, vs: out rows [16 mt, 16 mt + 16) of out_bh. br holds the thread's
// bias, mask folded in, when KT <= 4; else bias_h is read.
template <int KT, int DT>
__device__ __forceinline__ void attend_tile(__nv_bfloat16* qs, const __nv_bfloat16* ks,
                                            const __nv_bfloat16* vs,
                                            const float (&br)[KT <= 4 ? 2 * KT : 1][4],
                                            const float* __restrict__ bias_h,
                                            __nv_bfloat16* __restrict__ out_bh, long long o_sr,
                                            int mt, int N, int d, int ld, float scale, bool vec) {
  constexpr bool kRegBias = KT <= 4;
  const int kt = (N + 15) / 16, dt = (d + 15) / 16;
  const int lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int tile_row = lane & 15, tile_col = (lane >> 4) * 8;  // ldmatrix: A rows, trans B rows
  const int key_row = (lane & 7) + ((lane >> 4) << 3), key_col = ((lane >> 3) & 1) * 8;
  const int r0 = mt * 16 + g, r1 = r0 + 8;  // the two rows this thread holds

  // s = q k^T: 2*kt tiles of 8 keys, each summed over the d tiles in order.
  float s[2 * KT][4];
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DT; ++kk) {
    if (kk >= dt) continue;
    uint32_t a[4];
    ldmatrix_x4(a, qs + (mt * 16 + tile_row) * ld + kk * 16 + tile_col);
#pragma unroll
    for (int np = 0; np < KT; ++np) {
      if (np >= kt) continue;
      uint32_t bk[4];
      ldmatrix_x4(bk, ks + (np * 16 + key_row) * ld + kk * 16 + key_col);
      mma_bf16_16816(s[2 * np], a, bk[0], bk[1]);
      mma_bf16_16816(s[2 * np + 1], a, bk[2], bk[3]);
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
      if constexpr (kRegBias) {
        v0 = __fadd_rn(__fmul_rn(s[nt][e], scale), br[kRegBias ? nt : 0][e]);
        v1 = __fadd_rn(__fmul_rn(s[nt][2 + e], scale), br[kRegBias ? nt : 0][2 + e]);
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

  // p = e / l in bf16, as the A fragments of p v: key tile j is the score
  // tiles 2j (columns 0-7) and 2j+1 (columns 8-15).
  const float i0 = __frcp_rn(l0), i1 = __frcp_rn(l1);
  uint32_t p[KT][4];
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    if (j >= kt) continue;
    p[j][0] = pack_bf16(quotient(s[2 * j][0], l0, i0), quotient(s[2 * j][1], l0, i0));
    p[j][1] = pack_bf16(quotient(s[2 * j][2], l1, i1), quotient(s[2 * j][3], l1, i1));
    p[j][2] = pack_bf16(quotient(s[2 * j + 1][0], l0, i0), quotient(s[2 * j + 1][1], l0, i0));
    p[j][3] = pack_bf16(quotient(s[2 * j + 1][2], l1, i1), quotient(s[2 * j + 1][3], l1, i1));
  }

  // out = p v: 2*dt tiles of 8 columns of d, each summed over the key tiles
  // in order.
  float o[2 * DT][4];
#pragma unroll
  for (int nt = 0; nt < 2 * DT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.0f;
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    if (j >= kt) continue;
#pragma unroll
    for (int np = 0; np < DT; ++np) {
      if (np >= dt) continue;
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, vs + (j * 16 + tile_row) * ld + np * 16 + tile_col);
      mma_bf16_16816(o[2 * np], p[j], bv[0], bv[1]);
      mma_bf16_16816(o[2 * np + 1], p[j], bv[2], bv[3]);
    }
  }

  if (!vec) {
#pragma unroll
    for (int nt = 0; nt < 2 * DT; ++nt)
      if (nt < 2 * dt) store_pair_rows(out_bh, o_sr, o[nt], r0, nt * 8 + 2 * t4, N, d, 1.0f, false);
    return;
  }
  // Stage the tile in this warp's q rows (rows past N and columns past d
  // stay zero), then 16-byte stores.
#pragma unroll
  for (int nt = 0; nt < 2 * DT; ++nt) {
    if (nt >= 2 * dt || nt * 8 >= d) continue;
    const int c = nt * 8 + 2 * t4;
    if (r0 < N) *reinterpret_cast<uint32_t*>(qs + r0 * ld + c) = pack_bf16(o[nt][0], o[nt][1]);
    if (r1 < N) *reinterpret_cast<uint32_t*>(qs + r1 * ld + c) = pack_bf16(o[nt][2], o[nt][3]);
  }
  __syncwarp();
  const int chunks = d / 8, dr = 32 / chunks, dc = 32 - dr * chunks;
  const int rows = min(16, N - mt * 16);
  int r = lane / chunks, c = lane - r * chunks;
  for (; r < rows; r += dr, c += dc) {
    if (c >= chunks) {
      c -= chunks;
      if (++r >= rows) break;
    }
    const int row = mt * 16 + r;
    *reinterpret_cast<uint4*>(out_bh + row * o_sr + 8 * c) =
        *reinterpret_cast<const uint4*>(qs + row * ld + 8 * c);
  }
}

// KT bounds the 16-token tiles (N <= 16 KT), DT the 16-wide d tiles (d <= 16 DT);
// the loops run over the actual counts, kt and dt.
template <int KT, int DT>
__global__ void __launch_bounds__(kGroup * fwd_groups(16 * KT, 16 * DT), 1)
    window_attention_kernel(View q, View k, View v, const float* __restrict__ bias,
                            __nv_bfloat16* __restrict__ out, long long o_sb, long long o_sr,
                            long long o_sh, int B, int N, int heads, int d, int per_head,
                            int slots, float scale, int vec) {
  constexpr bool kRegBias = KT <= 4;  // one query tile a warp: the bias in registers
  constexpr int kGroups = fwd_groups(16 * KT, 16 * DT), kThreads = kGroup * kGroups;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kt = (N + 15) / 16, dt = (d + 15) / 16;
  const int Np = kt * 16, Dp = dt * 16, ld = Dp + 8, tile = Np * ld;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // a slot's window has landed
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + kFwdBarrierBytes);

  const int h = blockIdx.x / per_head, part = blockIdx.x % per_head;
  const int b_first = static_cast<int>(static_cast<long long>(part) * B / per_head);
  const int windows = static_cast<int>(static_cast<long long>(part + 1) * B / per_head) - b_first;

  // Rows past N and columns past d stay zero: the copies never write them.
  {
    uint4* z = reinterpret_cast<uint4*>(ring);
    const int n16 = (fwd_smem_bytes(Np, Dp, slots) - kFwdBarrierBytes) / 16;
    for (int i = threadIdx.x; i < n16; i += kThreads) z[i] = make_uint4(0, 0, 0, 0);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kGroups * kFwdMaxSlots; ++s) mbar_init(&full[s], kGroup);
    mbar_init_fence();
  }
  __syncthreads();

  // This group's windows: b_first + grp + kGroups j for j < count.
  const int grp = threadIdx.x / kGroup, t = threadIdx.x % kGroup, gw = t / 32;
  const int count = windows > grp ? (windows - grp + kGroups - 1) / kGroups : 0;
  uint64_t* gfull = full + grp * kFwdMaxSlots;
  __nv_bfloat16* gring = ring + grp * slots * 3 * tile;
  const View src[3] = {q, k, v};
  for (int j = 0; j < count && j < slots; ++j)
    load_window(gring + j * 3 * tile, src, b_first + grp + kGroups * j, h, N, d, Np, ld, vec,
                &gfull[j], t);

  const float* bias_h = bias + static_cast<long long>(h) * N * N;
  float br[kRegBias ? 2 * KT : 1][4] = {};
  if constexpr (kRegBias) {
    const int lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
    const int r0 = gw * 16 + g, r1 = r0 + 8;
#pragma unroll
    for (int nt = 0; nt < 2 * KT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nt * 8 + 2 * t4 + e;
        br[kRegBias ? nt : 0][e] = c >= N ? -INFINITY : r0 < N ? bias_h[r0 * N + c] : 0.0f;
        br[kRegBias ? nt : 0][2 + e] = c >= N ? -INFINITY : r1 < N ? bias_h[r1 * N + c] : 0.0f;
      }
  }

#pragma unroll 1
  for (int j = 0; j < count; ++j) {
    const int s = j % slots, b = b_first + grp + kGroups * j;
    mbar_wait(&gfull[s], (j / slots) & 1);
    __nv_bfloat16* qs = gring + s * 3 * tile;
    __nv_bfloat16* out_bh = out + b * o_sb + h * o_sh;
#pragma unroll 1
    for (int mt = gw; mt < kt; mt += kGroupWarps)
      attend_tile<KT, DT>(qs, qs + tile, qs + 2 * tile, br, bias_h, out_bh, o_sr, mt, N, d, ld,
                          scale, vec);
    if (j + slots < count) {
      named_sync(1 + grp, kGroup);  // every warp of the group is done with slot s
      load_window(qs, src, b + kGroups * slots, h, N, d, Np, ld, vec, &gfull[s], t);
    }
  }
}

template <int KT, int DT>
cudaError_t launch(View q, View k, View v, const float* bias, __nv_bfloat16* out, long long o_sb,
                   long long o_sr, long long o_sh, int B, int N, int heads, int d,
                   const FwdPlan& p, float scale, int vec, cudaStream_t stream) {
  auto kernel = window_attention_kernel<KT, DT>;
  if (p.smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return e;
  }
  if (p.groups != fwd_groups(16 * KT, 16 * DT)) return cudaErrorInvalidValue;
  kernel<<<heads * p.per_head, kGroup * p.groups, p.smem, stream>>>(
      q, k, v, bias, out, o_sb, o_sr, o_sh, B, N, heads, d, p.per_head, p.slots, scale, vec);
  return cudaGetLastError();
}

}  // namespace

// The forward's launch plan for a shape on a card of `sms` SMs: {blocks a
// head, warp groups a block, slots a group, shared memory bytes}. Returns a
// cudaError_t: 0, or cudaErrorInvalidValue (and zeros) when the shape is out
// of range or no plan fits.
extern "C" int dfd_window_attention_plan(int B, int N, int heads, int d, int sms, int* plan) {
  for (int i = 0; i < 4; ++i) plan[i] = 0;
  if (B < 1 || N < 1 || N > 128 || heads < 1 || d < 1 || d > 128 || sms < 1)
    return cudaErrorInvalidValue;
  const FwdPlan p = fwd_plan(B, N, heads, d, sms);
  if (p.slots == 0) return cudaErrorInvalidValue;
  plan[0] = p.per_head;
  plan[1] = p.groups;
  plan[2] = p.slots;
  plan[3] = p.smem;
  return cudaSuccess;
}

// Returns a cudaError_t: 0 on success. Strides are in elements; vec = 1
// promises d % 8 == 0, every stride % 8 == 0 and 16-byte aligned q, k, v and
// out, for 16-byte copies and stores. The plan is that of a card of `sms` SMs.
extern "C" int dfd_window_attention(const void* q, const void* k, const void* v, const void* bias,
                                    void* out, int B, int N, int heads, int d, long long q_sb,
                                    long long q_sr, long long q_sh, long long k_sb, long long k_sr,
                                    long long k_sh, long long v_sb, long long v_sr, long long v_sh,
                                    long long o_sb, long long o_sr, long long o_sh, int sms,
                                    float scale, int vec, void* stream) {
  int plan[4];
  const int rc = dfd_window_attention_plan(B, N, heads, d, sms, plan);
  if (rc != 0 || static_cast<long long>(heads) * plan[0] > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const FwdPlan p{plan[0], plan[1], plan[2], plan[3]};
  const View qv{static_cast<const __nv_bfloat16*>(q), q_sb, q_sr, q_sh};
  const View kv{static_cast<const __nv_bfloat16*>(k), k_sb, k_sr, k_sh};
  const View vv{static_cast<const __nv_bfloat16*>(v), v_sb, v_sr, v_sh};
  const float* bs = static_cast<const float*>(bias);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool small_n = N <= 64, small_d = d <= 64;
  if (small_n && small_d)
    return static_cast<int>(
        launch<4, 4>(qv, kv, vv, bs, o, o_sb, o_sr, o_sh, B, N, heads, d, p, scale, vec, st));
  if (small_n)
    return static_cast<int>(
        launch<4, 8>(qv, kv, vv, bs, o, o_sb, o_sr, o_sh, B, N, heads, d, p, scale, vec, st));
  if (small_d)
    return static_cast<int>(
        launch<8, 4>(qv, kv, vv, bs, o, o_sb, o_sr, o_sh, B, N, heads, d, p, scale, vec, st));
  return static_cast<int>(
      launch<8, 8>(qv, kv, vv, bs, o, o_sb, o_sr, o_sh, B, N, heads, d, p, scale, vec, st));
}
