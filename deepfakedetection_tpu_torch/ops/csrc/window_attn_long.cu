// K5 past 128 tokens: the forward and the backward of multi-head attention
// with a per-head additive bias over windows of any length (FasterViT's
// stage 4: 196 tokens at 448 px, 324 at 560, 441 at 672). window_attn.cu and
// window_attn_bwd.cu keep N <= 128; ops/window_attn.py chooses by N.
//
// Replaces: deepfakedetection_tpu/ops/pallas/window_attn.py at these sizes,
//   fused_window_attention_v2 (_attn_kernel_v2, :799; the forward) and
//   fused_window_attention_v5_bwd (_attn_bwd_kernel_v5, :587; the backward),
//   which pad N to a multiple of 64 and mask the padded key columns
//   (deepfakedetection_tpu/ops/attention.py:111-127).
// Contract: as window_attn.cu and window_attn_bwd.cu. Forward: q, k, v, out
//   [B, N, h, d] bf16 through (batch, row, head) strides, bias [h, N, N] f32:
//     s   = (q_h . k_h^T accumulated in f32) * scale + bias[h]
//     out = softmax(s) . v_h accumulated in f32, rounded to bf16.
//   Backward: qkv [B, N, 3C], dout [B, N, C] -> dqkv [B, N, 3C] bf16 and
//   dbias [h, N, N] f32 summed over windows: the f32 p recomputed, dv =
//   bf16(bf16(p)^T do), dp = do v^T, ds = p (dp - rowsum(dp p)), dq =
//   bf16(bf16(ds) k * scale), dk = bf16(bf16(ds)^T q * scale). Any N up to
//   46,340 (N^2 an int), d <= 128; only tiles live in shared memory.
// Rounding: the forward is an online softmax: p = exp(s - running row max)
//   is rounded to bf16 before p v, and the f32 row sum and output are
//   rescaled when the max moves and divided by the sum at the end; the plain
//   version (the JAX kernel's order) divides first and rounds p / sum. The
//   two agree within two bf16 steps of the output's scale. The backward's p
//   is the plain version's quotient exp(s - max) / sum from the row max and
//   sum of a first walk.
// Bound on the H100: HBM bytes. At FasterViT-2's official stage 4 (N 196,
//   d 48) a window and head read 3 N d 2 bytes and write N d 2 for 4 N^2 d
//   flops, ~98 flops a byte, below the ~295 flop/byte bf16 line: a 448 px
//   forward at batch 64 moves 80 MB (0.024 ms at 3.35 TB/s) for 7.6 GFLOP
//   (0.008 ms on the tensor cores). The exponentials (N^2 a window and head,
//   on the 16-a-clock MUFU units) take about as long as the products.
//
// Measured (chip_smoke.py --parent, phase 1: profile_k5.compare_long,
//   device time by launch, H100 80GB HBM3 at 700.00 W): a FasterViT-2 pass
//   at 448 px (5 launches), in turns with the three-pass kernels this
//   replaced: forward 1.193 ms official (batch 64) against 1.858, 0.775 tpu
//   against 1.624; backward (fine-tune step, batch 32) 2.351 against 4.841,
//   1.654 against 3.423. SDPA with the bias as its mask: 0.470, 0.261, 1.771
//   and 1.129; the bound 0.119, 0.116, 0.108 and 0.103. What holds them back
//   is L2 traffic: each window re-reads its head's whole bias and each query
//   group the window's k and v. In scratch copies of this design's earlier
//   versions with clock64 counters, starting those loads took 39-56% of a
//   forward step while the consumers did it; the producer warpgroup now
//   does.
//
// Design. Every kernel is a block of 4 consumer warps, each a 16-row tile of
//   one operand, and a producer warpgroup of which one warp loads (the other
//   three leave at once; setmaxnreg gives the consumers 216 registers and
//   the producers 40, so that two blocks an SM fit). The loading warp walks
//   the block's steps ahead of the consumers and copies each step's 64-row
//   tiles of the other operand into a ring of 2 to 4 shared-memory stages
//   with 16-byte cp.async (zero-filled past N; element copies where a
//   stride, d or an address does not allow them), each stage's completion
//   counted on its full mbarrier by cp.async.mbarrier.arrive.noinc; the
//   consumers free a stage on its empty mbarrier. An item's own rows (q, or
//   the key group's k and v) go through one or two item buffers the same
//   way, so the next item's rows load under the current one's steps. The
//   plan (dfd_window_attention_long_plan, dfd_window_attention_long_bwd_plan,
//   mirrored by ops/window_attn.py) takes two blocks an SM and the deepest
//   ring that fits them, two item buffers before one. Products are mma.sync
//   m16n8k16 (bf16 in, f32 accumulate; operands by ldmatrix, ldmatrix.trans
//   where the key axis is the reduction), row statistics are reduced over
//   the four threads that share a row, exponentials are ex2.approx of
//   (x - m) log2(e). In the forward and the row kernel the keys of each
//   16-key chunk sit in the products in key_of's order, so each thread's four
//   bias values (and dbias partials) are adjacent: one 16-byte load, read
//   from L2 into registers one step or unit ahead of its use.
//   Forward: an item is (window, head, group of <= 4 query tiles), the
//   groups splitting a window's 16-row tiles evenly; persistent blocks, as
//   many as two an SM hold, each own an even, contiguous range of the items
//   (windows outermost, so a window's groups follow each other and its k
//   and v come from L2). A warp keeps its tile's running max and sum and
//   its f32 output in registers and makes one q k^T and one p v per 64-key
//   step: one pass over the keys.
//   Backward: three kernels, no float atomics. (1) A row kernel: block (head,
//   query group, part) walks part's windows in order; per window two walks
//   over the key tiles: the first finds each row's max, sum and row term
//   rowsum(dp p) online (the row term rescaled with the sum), writes them to
//   a [B, h, 4, N] scratch, and the second recomputes p, dp and ds, adds ds
//   into the block's rows of its partial dbias plane (each element owned by
//   one thread, windows in order) and accumulates dq = bf16(ds) k. (2) A
//   column kernel: block (head, key group, part), a warp a 16-key tile whose
//   k and v rows stay in the item buffer, walks each window's query tiles
//   (q, do and the row statistics in the ring), computing s^T = k q^T and
//   dp^T = v do^T with the keys as the product's rows, so p^T and ds^T are
//   already the A operands of dv = p^T do and dk = ds^T q. (3) A sum of each
//   head's part planes in order. Two runs give bit-identical dqkv and dbias.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"
#include "window_attn_common.cuh"
#include "window_attn_pipe.cuh"

namespace {

constexpr int kConsumers = 4;         // a block's consumer warps, each one 16-row tile
// and a producer warpgroup, one warp of which loads: setmaxnreg moves the
// group's registers to the consumers, 2 x (216 + 40) a lane of each SM
// quadrant at two blocks an SM, where five warps of one count get 168
constexpr int kThreads = 32 * (kConsumers + 4);
constexpr int kConsumerRegs = 216, kProducerRegs = 40;
constexpr int kRows = 16 * kConsumers;  // rows of a group, of a step's tile: 64
constexpr int kBarBytes = 128;        // the mbarriers, at the start of shared memory
constexpr int kMaxTokens = 46340;     // N^2 fits an int
constexpr int kMaxStages = 4;
constexpr int kSmemPerSm = 233472;    // an H100 SM's shared memory (228 KB)
constexpr int kBlockReserve = 1024;   // shared memory the card keeps for each block
constexpr int kStats = 4;             // a row's max, sum, 1 / sum and row term

// Bytes of one [kRows][pad16(d) + 8] bf16 tile.
__host__ __device__ constexpr int tile_bytes(int d) { return kRows * (pad16(d) + 8) * 2; }

// Query (key) groups a window's 16-row tiles are split into: <= kConsumers each.
__host__ __device__ constexpr int long_groups(int N) { return cdiv(cdiv(N, 16), kConsumers); }

struct Ring {
  int stages, buffers, per_sm, smem;
};

// The ring of a kernel that keeps `item` bytes an item buffer and `stage`
// bytes a step: two blocks an SM where any ring fits them, two item buffers
// before one, then the most stages (2 to 4). {0, 0, 0, 0} when none fits.
Ring ring_plan(int item, int stage) {
  for (int per_sm = 2; per_sm >= 1; --per_sm)
    for (int buffers = 2; buffers >= 1; --buffers)
      for (int s = kMaxStages; s >= 2; --s) {
        const int smem = kBarBytes + buffers * item + s * stage;
        if (smem <= kMaxSmemBytes && per_sm * (smem + kBlockReserve) <= kSmemPerSm)
          return {s, buffers, per_sm, smem};
      }
  return {0, 0, 0, 0};
}

// Rows [row0, row0 + kRows) of window b, head h of `src` into a [kRows][ld]
// tile (columns < d), by the producer warp's 32 lanes; rows at or past
// `limit` are written as zeros. 16-byte cp.async (zero-filled past the limit)
// where vec allows, else element copies.
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const View& src, int b, int h,
                                          int row0, int limit, int d, int ld, bool vec,
                                          int lane) {
  const __nv_bfloat16* base = src.p + b * src.sb + h * src.sh;
  if (vec) {
    // the lane's 16-byte chunks (row r, column 8 c) step by 32 chunks
    const int chunks = d >> 3, dr = 32 / chunks, dc = 32 - dr * chunks;
    int r = lane / chunks, c = lane - r * chunks;
    for (; r < kRows; r += dr, c += dc) {
      if (c >= chunks) {
        c -= chunks;
        if (++r >= kRows) break;
      }
      const bool in = row0 + r < limit;
      cp_async16_zfill(dst + r * ld + 8 * c, base + (in ? (row0 + r) * src.sr : 0) + 8 * c, in);
    }
  } else {
    for (int e = lane; e < kRows * d; e += 32) {
      const int r = e / d, c = e - r * d;
      dst[r * ld + c] =
          row0 + r < limit ? base[(row0 + r) * src.sr + c] : __float2bfloat16_rn(0.0f);
    }
  }
}

// The producer lane's copies so far complete on bar, whose count holds the
// 32 lanes: the arrival follows the lane's cp.async (vec), or its stores.
__device__ __forceinline__ void arrive_loaded(uint64_t* bar, bool vec) {
  if (vec)
    cp_async_arrive(bar);
  else
    mbar_arrive(bar);
}

// The pipeline's mbarriers: each stage's full (the producer's 32 lanes) and
// empty (an arrival a consumer warp), and the same of each item buffer.
struct Bars {
  uint64_t *full, *empty, *item_full, *item_empty;

  __device__ explicit Bars(unsigned char* smem)
      : full(reinterpret_cast<uint64_t*>(smem)), empty(full + kMaxStages),
        item_full(empty + kMaxStages), item_empty(item_full + 2) {}

  // Thread 0 initialises them, then a block barrier.
  __device__ void init(int stages, int buffers) const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < stages; ++s) {
        mbar_init(&full[s], 32);
        mbar_init(&empty[s], kConsumers);
      }
      for (int b = 0; b < buffers; ++b) {
        mbar_init(&item_full[b], 32);
        mbar_init(&item_empty[b], kConsumers);
      }
      mbar_init_fence();
    }
    __syncthreads();
  }

  // A consumer warp is done with stage s and, at an item's last step
  // (ib >= 0), with item buffer ib.
  __device__ void release(int s, int ib, int lane) const {
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(&empty[s]);
      if (ib >= 0) mbar_arrive(&item_empty[ib]);
    }
  }
};

// The zeroed shared memory: columns past d stay zero for good.
__device__ __forceinline__ void zero_smem(unsigned char* smem, int bytes) {
  uint4* z = reinterpret_cast<uint4*>(smem);
  for (int i = threadIdx.x; i < bytes / 16; i += kThreads) z[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
}

// row[c .. c + 3], 0 past N: one 16-byte load where N % 4 == 0 (c % 4 == 0).
__device__ __forceinline__ float4 load_quad(const float* row, int c, int N, bool quad) {
  if (quad && c + 3 < N) return __ldg(reinterpret_cast<const float4*>(row + c));
  return make_float4(c < N ? __ldg(row + c) : 0.0f, c + 1 < N ? __ldg(row + c + 1) : 0.0f,
                     c + 2 < N ? __ldg(row + c + 2) : 0.0f, c + 3 < N ? __ldg(row + c + 3) : 0.0f);
}

// s = rows [16 i, 16 i + 16) of A . rows [16 j, 16 j + 16) of B^T ([*][ld]
// bf16 in shared memory), over the dt 16-wide column tiles in order: s[t]
// holds columns 8 t .. 8 t + 7 of the 16x16 tile.
template <int DT>
__device__ __forceinline__ void tile_product(float (&s)[2][4], const __nv_bfloat16* A,
                                             const __nv_bfloat16* Bm, int i, int j, int dt,
                                             int ld, int lane, bool perm = false) {
  const int tile_row = lane & 15, tile_col = (lane >> 4) * 8;
  const int key_row = perm ? key_of((lane & 7) + ((lane >> 4) << 3))
                           : (lane & 7) + ((lane >> 4) << 3),
            key_col = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int t = 0; t < 2; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DT; ++kk) {
    if (kk >= dt) break;
    uint32_t a[4], b[4];
    ldmatrix_x4(a, A + (i * 16 + tile_row) * ld + kk * 16 + tile_col);
    ldmatrix_x4(b, Bm + (j * 16 + key_row) * ld + kk * 16 + key_col);
    mma_bf16_16816(s[0], a, b[0], b[1]);
    mma_bf16_16816(s[1], a, b[2], b[3]);
  }
}

// s[8] = the 16 rows at A . rows [0, 16 nsub) of B^T: the forward's scores
// of one 64-key step (n8 tiles from 2 nsub on stay zero).
template <int DT>
__device__ __forceinline__ void scores64(float (&s)[8][4], const __nv_bfloat16* A,
                                         const __nv_bfloat16* Bm, int nsub, int dt, int ld,
                                         int lane) {
  const int tile_row = lane & 15, tile_col = (lane >> 4) * 8;
  const int key_row = key_of((lane & 7) + ((lane >> 4) << 3)), key_col = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DT; ++kk) {
    if (kk >= dt) break;
    uint32_t a[4];
    ldmatrix_x4(a, A + tile_row * ld + kk * 16 + tile_col);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (p >= nsub) break;
      uint32_t b[4];
      ldmatrix_x4(b, Bm + (p * 16 + key_row) * ld + kk * 16 + key_col);
      mma_bf16_16816(s[2 * p], a, b[0], b[1]);
      mma_bf16_16816(s[2 * p + 1], a, b[2], b[3]);
    }
  }
}

// o[2 DT] += a . rows [16 j, 16 j + 16) of B ([*][ld], B's columns < 16 dt)
// through ldmatrix.trans: the A fragment times a [16 x d] tile; `perm` takes
// the A fragment's keys in key_of's order.
template <int DT>
__device__ __forceinline__ void mma_rows(float (&o)[2 * DT][4], const uint32_t (&a)[4],
                                         const __nv_bfloat16* Bm, int j, int dt, int ld,
                                         int lane, bool perm = false) {
  const int tile_row = perm ? key_of(lane & 15) : lane & 15, tile_col = (lane >> 4) * 8;
#pragma unroll
  for (int nd = 0; nd < DT; ++nd) {
    if (nd >= dt) break;
    uint32_t b[4];
    ldmatrix_x4_trans(b, Bm + (j * 16 + tile_row) * ld + nd * 16 + tile_col);
    mma_bf16_16816(o[2 * nd], a, b[0], b[1]);
    mma_bf16_16816(o[2 * nd + 1], a, b[2], b[3]);
  }
}

template <int DT>
__device__ __forceinline__ void zero(float (&o)[2 * DT][4]) {
#pragma unroll
  for (int n = 0; n < 2 * DT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
}

// The 16 rows of tile i held in o (times `mult`, rounded to bf16) at base.
template <int DT>
__device__ __forceinline__ void store_tile(__nv_bfloat16* base, long long sr,
                                           const float (&o)[2 * DT][4], int i, int N, int d,
                                           int dt, float mult, bool vec, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < 2 * DT; ++n)
    if (n < 2 * dt) store_pair_rows(base, sr, o[n], i * 16 + g, n * 8 + 2 * t4, N, d, mult, vec);
}

// The scaled, biased, masked score of row r at column c: -inf on columns
// past N, 0 on rows past N (whose q rows are zero).
__device__ __forceinline__ float masked(float acc, float scale, float b, int r, int c, int N) {
  return c < N ? (r < N ? __fadd_rn(__fmul_rn(acc, scale), b) : 0.0f) : -INFINITY;
}

// One 64-key step of the forward for a warp's query tile i: the scores with
// this step's bias, the online softmax (reset at the item's first step) and
// p v; at the item's last step the output divided by the row sums.
template <int DT>
__device__ __forceinline__ void forward_step(float (&o)[2 * DT][4], float (&m)[2], float (&l)[2],
                                             const float (&bias_t)[8][4],
                                             const __nv_bfloat16* qs, const __nv_bfloat16* ks,
                                             int tile, int N, int d, int dt, int ld, int j, int nk,
                                             int i, float scale, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  if (j == 0) {
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.0f;
    zero<DT>(o);
  }
  const int key0 = kRows * j, nsub = min(4, cdiv(N - key0, 16));
  const int r0 = 16 * i + g, r1 = r0 + 8;
  float s[8][4];
  scores64<DT>(s, qs, ks, nsub, dt, ld, lane);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = key0 + 16 * (n >> 1) + 4 * t4 + 2 * (n & 1) + e;
      s[n][e] = masked(s[n][e], scale, bias_t[n][e], r0, c, N);
      s[n][2 + e] = masked(s[n][2 + e], scale, bias_t[n][2 + e], r1, c, N);
      mx[0] = fmaxf(mx[0], s[n][e]);
      mx[1] = fmaxf(mx[1], s[n][2 + e]);
    }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], quad_max(mx[r]));
    alpha[r] = exp_sub(m[r], mn);
    m[r] = mn;
    l[r] = __fmul_rn(l[r], alpha[r]);
  }
#pragma unroll
  for (int n = 0; n < 2 * DT; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (n >= 2 * nsub) break;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[n][e] = exp_sub(s[n][e], m[0]);
      s[n][2 + e] = exp_sub(s[n][2 + e], m[1]);
      l[0] += s[n][e];
      l[1] += s[n][2 + e];
    }
  }
  const __nv_bfloat16* vs = ks + tile;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk >= nsub) break;
    uint32_t a[4];
    as_a(a, s[2 * kk], s[2 * kk + 1]);
    mma_rows<DT>(o, a, vs, kk, dt, ld, lane, true);
  }
  if (j == nk - 1) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) inv[r] = __frcp_rn(quad_sum(l[r]));
#pragma unroll
    for (int n = 0; n < 2 * DT; ++n) {
      o[n][0] = __fmul_rn(o[n][0], inv[0]);
      o[n][1] = __fmul_rn(o[n][1], inv[0]);
      o[n][2] = __fmul_rn(o[n][2], inv[1]);
      o[n][3] = __fmul_rn(o[n][3], inv[1]);
    }
  }
}

// The forward. DT bounds the 16-wide d tiles (d <= 16 DT); loops run over dt.
template <int DT>
__global__ void __launch_bounds__(kThreads, 2)
    window_attention_long_kernel(View q, View k, View v, const float* __restrict__ bias,
                                 __nv_bfloat16* __restrict__ out, long long o_sb, long long o_sr,
                                 long long o_sh, int B, int N, int heads, int d, float scale,
                                 int groups, int stages, int buffers, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kt = cdiv(N, 16), nk = cdiv(N, kRows), dt = cdiv(d, 16), ld = 16 * dt + 8;
  const int tile = kRows * ld;
  Bars bars(smem);
  __nv_bfloat16* qbuf = reinterpret_cast<__nv_bfloat16*>(smem + kBarBytes);
  __nv_bfloat16* ring = qbuf + buffers * tile;
  const long long items = static_cast<long long>(B) * heads * groups;
  const int first = static_cast<int>(blockIdx.x * items / gridDim.x);
  const int end = static_cast<int>((blockIdx.x + 1) * items / gridDim.x);
  const int steps = (end - first) * nk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const bool quad = (N & 3) == 0;
  zero_smem(smem, kBarBytes + (buffers + 2 * stages) * tile * 2);
  bars.init(stages, buffers);

  // a position in the block's steps: item (window b, head h, group gi, its
  // query tiles [t0, t1)) and key step j, advanced one step at a time
  struct Cursor {
    int j, b, h, gi, t0, t1;
  };
  auto start = [&](Cursor& c, int t) {
    const int li = t / nk, it = first + li, bh = it / groups;
    c.j = t - li * nk;
    c.gi = it - bh * groups;
    c.b = bh / heads;
    c.h = bh - c.b * heads;
    c.t0 = c.gi * kt / groups;
    c.t1 = (c.gi + 1) * kt / groups;
  };
  auto advance = [&](Cursor& c) {
    if (++c.j < nk) return;
    c.j = 0;
    if (++c.gi == groups) {
      c.gi = 0;
      if (++c.h == heads) {
        c.h = 0;
        ++c.b;
      }
    }
    c.t0 = c.gi * kt / groups;
    c.t1 = (c.gi + 1) * kt / groups;
  };

  if (warp >= kConsumers) {  // the producer warpgroup, of which one warp loads
    setmaxnreg_dec<kProducerRegs>();
    if (warp > kConsumers) return;
    // the loading warp: an item's q, then k and v a step
    Cursor c;
    start(c, 0);
    int li = 0;
#pragma unroll 1
    for (int t = 0; t < steps; ++t) {
      if (c.j == 0) {
        const int qb = li % buffers;
        if (li >= buffers) mbar_wait(&bars.item_empty[qb], (li / buffers - 1) & 1);
        load_rows(qbuf + qb * tile, q, c.b, c.h, 16 * c.t0, min(N, 16 * c.t1), d, ld, vec, lane);
        arrive_loaded(&bars.item_full[qb], vec);
      }
      const int s = t % stages;
      if (t >= stages) mbar_wait(&bars.empty[s], (t / stages - 1) & 1);
      __nv_bfloat16* st = ring + s * 2 * tile;
      load_rows(st, k, c.b, c.h, kRows * c.j, N, d, ld, vec, lane);
      load_rows(st + tile, v, c.b, c.h, kRows * c.j, N, d, ld, vec, lane);
      arrive_loaded(&bars.full[s], vec);
      if (c.j == nk - 1) ++li;
      advance(c);
    }
    cp_async_wait<0>();
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  // the bias of this warp's rows at step t's 64 keys, into registers: a step
  // ahead, so that no step waits on its L2 reads
  auto load_bias = [&](float (&bb)[8][4], const Cursor& c, int t) {
    if (t >= steps || c.t0 + warp >= c.t1) return;
    const int r0 = 16 * (c.t0 + warp) + g;
    const float* bias_h = bias + static_cast<long long>(c.h) * N * N;
    const float* brow0 = bias_h + min(r0, N - 1) * N;
    const float* brow1 = bias_h + min(r0 + 8, N - 1) * N;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int col = kRows * c.j + 16 * p + 4 * t4;
      const float4 x0 = load_quad(brow0, col, N, quad), x1 = load_quad(brow1, col, N, quad);
      bb[2 * p][0] = x0.x;
      bb[2 * p][1] = x0.y;
      bb[2 * p + 1][0] = x0.z;
      bb[2 * p + 1][1] = x0.w;
      bb[2 * p][2] = x1.x;
      bb[2 * p][3] = x1.y;
      bb[2 * p + 1][2] = x1.z;
      bb[2 * p + 1][3] = x1.w;
    }
  };

  Cursor at, next;  // step t and step t + 1
  start(at, 0);
  start(next, min(1, steps));
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, o[2 * DT][4], bb[8][4];
  zero<DT>(o);
  load_bias(bb, at, 0);
  int li = 0;
#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
    const int j = at.j, b = at.b, h = at.h, t0 = at.t0, t1 = at.t1;
    const int s = t % stages, qb = li % buffers;
    float bias_t[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) bias_t[n][e] = bb[n][e];
    load_bias(bb, next, t + 1);
    advance(next);
    mbar_wait(&bars.full[s], (t / stages) & 1);
    if (j == 0) mbar_wait(&bars.item_full[qb], (li / buffers) & 1);
    const int i = t0 + warp;
    if (i < t1) {  // a group of fewer than four tiles leaves a warp out
      forward_step<DT>(o, m, l, bias_t, qbuf + qb * tile + warp * 16 * ld,
                       ring + s * 2 * tile, tile, N, d, dt, ld, j, nk, i, scale, lane);
      if (j == nk - 1)
        store_tile<DT>(out + b * o_sb + h * o_sh, o_sr, o, i, N, d, dt, 1.0f, vec, lane);
    }
    bars.release(s, j == nk - 1 ? qb : -1, lane);
    if (j == nk - 1) ++li;
    advance(at);
  }
}

// The backward's row kernel: dq, the row statistics and the partial dbias.
template <int DT>
__global__ void __launch_bounds__(kThreads, 2)
    window_attention_long_rows_kernel(View q, View k, View v, View dout,
                                      const float* __restrict__ bias,
                                      __nv_bfloat16* __restrict__ dqkv, long long g_sb,
                                      long long g_sr, float* __restrict__ partial,
                                      float* __restrict__ stats, int B, int N, int heads, int d,
                                      int groups, int parts, float scale, int stages,
                                      int buffers, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kt = cdiv(N, 16), nk = cdiv(N, kRows), dt = cdiv(d, 16), ld = 16 * dt + 8;
  const int tile = kRows * ld, npad = nk * kRows, per = 2 * nk;
  Bars bars(smem);
  __nv_bfloat16* ibuf = reinterpret_cast<__nv_bfloat16*>(smem + kBarBytes);  // q and do
  __nv_bfloat16* ring = ibuf + buffers * 2 * tile;                // k and v of a key tile
  const int part = blockIdx.x % parts, hg = blockIdx.x / parts;
  const int gi = hg % groups, h = hg / groups;
  const int t0 = gi * kt / groups, t1 = (gi + 1) * kt / groups;
  const int first = static_cast<int>(static_cast<long long>(part) * B / parts);
  const int end = static_cast<int>(static_cast<long long>(part + 1) * B / parts);
  const int steps = (end - first) * per;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const bool quad = (N & 3) == 0;
  const float* bias_h = bias + static_cast<long long>(h) * N * N;
  float* plane = partial + static_cast<long long>(h * parts + part) * N * N;
  zero_smem(smem, kBarBytes + (2 * buffers + 2 * stages) * tile * 2);
  bars.init(stages, buffers);

  if (warp >= kConsumers) {  // the producer warpgroup, of which one warp loads
    setmaxnreg_dec<kProducerRegs>();
    if (warp > kConsumers) return;
    // the loading warp: a window's q and do, k and v a step of each walk
#pragma unroll 1
    for (int t = 0; t < steps; ++t) {
      const int w = t / per, s = t - w * per, j = s < nk ? s : s - nk, b = first + w;
      if (s == 0) {
        const int qb = w % buffers;
        if (w >= buffers) mbar_wait(&bars.item_empty[qb], (w / buffers - 1) & 1);
        __nv_bfloat16* dst = ibuf + qb * 2 * tile;
        load_rows(dst, q, b, h, 16 * t0, min(N, 16 * t1), d, ld, vec, lane);
        load_rows(dst + tile, dout, b, h, 16 * t0, min(N, 16 * t1), d, ld, vec, lane);
        arrive_loaded(&bars.item_full[qb], vec);
      }
      const int st = t % stages;
      if (t >= stages) mbar_wait(&bars.empty[st], (t / stages - 1) & 1);
      __nv_bfloat16* dst = ring + st * 2 * tile;
      load_rows(dst, k, b, h, kRows * j, N, d, ld, vec, lane);
      load_rows(dst + tile, v, b, h, kRows * j, N, d, ld, vec, lane);
      arrive_loaded(&bars.full[st], vec);
    }
    cp_async_wait<0>();
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int i = t0 + warp, r0 = 16 * i + g, r1 = r0 + 8;
  const float* brow0 = bias_h + min(r0, N - 1) * N;
  const float* brow1 = bias_h + min(r1, N - 1) * N;
  // the bias (and, in a second walk after the block's first window, the
  // partial dbias) of this thread's four keys 4 t4 .. 4 t4 + 3 (key_of's
  // order) of the 16-key unit u of step t, rows r0 and r1, into registers: a
  // unit ahead, so that no unit waits on its L2 reads
  auto load_unit = [&](float4 (&bb)[2], float4 (&old)[2], int t, int u) {
    if (t >= steps) return;
    const int w = t / per, s = t - w * per, j = s < nk ? s : s - nk;
    const int c = kRows * j + 16 * u + 4 * t4;
    bb[0] = load_quad(brow0, c, N, quad);
    bb[1] = load_quad(brow1, c, N, quad);
    old[0] = old[1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (s >= nk && w > 0) {
      if (r0 < N) old[0] = load_quad(plane + r0 * N, c, N, quad);
      if (r1 < N) old[1] = load_quad(plane + r1 * N, c, N, quad);
    }
  };
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, D[2] = {0.0f, 0.0f};
  float inv[2] = {1.0f, 1.0f}, dq[2 * DT][4];
  float4 next_bb[2], next_old[2];
  zero<DT>(dq);
  if (i < t1) load_unit(next_bb, next_old, 0, 0);
#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
    const int w = t / per, s = t - w * per, j = s < nk ? s : s - nk, b = first + w;
    const int st = t % stages, qb = w % buffers, last = s == per - 1 ? qb : -1;
    mbar_wait(&bars.full[st], (t / stages) & 1);
    if (s == 0) mbar_wait(&bars.item_full[qb], (w / buffers) & 1);
    if (i >= t1) {  // a group of fewer than four tiles leaves a warp out
      bars.release(st, last, lane);
      continue;
    }
    const __nv_bfloat16* qs = ibuf + qb * 2 * tile + warp * 16 * ld;
    const __nv_bfloat16* dos = qs + tile;
    const __nv_bfloat16* ks = ring + st * 2 * tile;
    const __nv_bfloat16* vs = ks + tile;
    const bool second = s >= nk;
    if (s == 0) {
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = D[0] = D[1] = 0.0f;
    }
    if (s == nk) zero<DT>(dq);
    const int key0 = kRows * j, nsub = min(4, cdiv(N - key0, 16));
#pragma unroll 1
    for (int u = 0; u < nsub; ++u) {
      // this unit's bias and partials as the accumulators hold them: n-tile
      // t8, row half, column e <-> key 4 t4 + 2 t8 + e of the unit
      const float bb[2][4] = {{next_bb[0].x, next_bb[0].y, next_bb[1].x, next_bb[1].y},
                              {next_bb[0].z, next_bb[0].w, next_bb[1].z, next_bb[1].w}};
      const float4 old[2] = {next_old[0], next_old[1]};
      if (u + 1 < nsub)
        load_unit(next_bb, next_old, t, u + 1);
      else
        load_unit(next_bb, next_old, t + 1, 0);
      float sv[2][4], dp[2][4];
      tile_product<DT>(sv, qs, ks, 0, u, dt, ld, lane, true);
      tile_product<DT>(dp, dos, vs, 0, u, dt, ld, lane, true);
#pragma unroll
      for (int t8 = 0; t8 < 2; ++t8)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = key0 + 16 * u + 4 * t4 + 2 * t8 + (e & 1);
          sv[t8][e] = masked(sv[t8][e], scale, bb[t8][e], e < 2 ? r0 : r1, c, N);
        }
      if (!second) {
        // the first walk: the running max, and the sum and row term rescaled with it
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mx = fmaxf(fmaxf(sv[0][2 * r], sv[0][2 * r + 1]),
                                 fmaxf(sv[1][2 * r], sv[1][2 * r + 1]));
          const float mn = fmaxf(m[r], quad_max(mx));
          const float alpha = exp_sub(m[r], mn);
          m[r] = mn;
          l[r] = __fmul_rn(l[r], alpha);
          D[r] = __fmul_rn(D[r], alpha);
#pragma unroll
          for (int t8 = 0; t8 < 2; ++t8)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float x = exp_sub(sv[t8][2 * r + e], mn);
              l[r] += x;
              D[r] = __fmaf_rn(dp[t8][2 * r + e], x, D[r]);
            }
        }
        continue;
      }
      // the second walk: p, ds, the dbias partial and dq
#pragma unroll
      for (int t8 = 0; t8 < 2; ++t8)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = quotient(exp_sub(sv[t8][e], m[r]), l[r], inv[r]);
          dp[t8][e] = __fmul_rn(p, __fsub_rn(dp[t8][e], D[r]));
        }
      const int c = key0 + 16 * u + 4 * t4;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = half ? r1 : r0;
        if (r >= N || c >= N) continue;
        const float4 x = make_float4(__fadd_rn(old[half].x, dp[0][2 * half]),
                                     __fadd_rn(old[half].y, dp[0][2 * half + 1]),
                                     __fadd_rn(old[half].z, dp[1][2 * half]),
                                     __fadd_rn(old[half].w, dp[1][2 * half + 1]));
        float* cell = plane + r * N + c;
        if (quad && c + 3 < N) {
          *reinterpret_cast<float4*>(cell) = x;
        } else {
          cell[0] = x.x;
          if (c + 1 < N) cell[1] = x.y;
          if (c + 2 < N) cell[2] = x.z;
          if (c + 3 < N) cell[3] = x.w;
        }
      }
      uint32_t a[4];
      as_a(a, dp[0], dp[1]);
      mma_rows<DT>(dq, a, ks, u, dt, ld, lane, true);
    }
    if (s == nk - 1) {  // the row statistics, for the second walk and the column kernel
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = quad_sum(l[r]);
        D[r] = __fdiv_rn(quad_sum(D[r]), l[r]);
        inv[r] = __frcp_rn(l[r]);
      }
      if (t4 == 0) {
        float* st = stats + static_cast<long long>(b * heads + h) * kStats * npad;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r ? r1 : r0;
          if (row >= N) continue;
          st[row] = m[r];
          st[npad + row] = l[r];
          st[2 * npad + row] = inv[r];
          st[3 * npad + row] = D[r];
        }
      }
    }
    if (s == per - 1)
      store_tile<DT>(dqkv + b * g_sb + h * d, g_sr, dq, i, N, d, dt, scale, vec, lane);
    bars.release(st, last, lane);
  }
}

// The backward's column kernel: dk and dv.
template <int DT>
__global__ void __launch_bounds__(kThreads, 2)
    window_attention_long_cols_kernel(View q, View k, View v, View dout,
                                      const float* __restrict__ bias,
                                      __nv_bfloat16* __restrict__ dqkv, long long g_sb,
                                      long long g_sr, const float* __restrict__ stats, int B,
                                      int N, int heads, int d, int groups, int parts, float scale,
                                      int stages, int buffers, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kt = cdiv(N, 16), nq = cdiv(N, kRows), dt = cdiv(d, 16), ld = 16 * dt + 8;
  const int tile = kRows * ld, npad = nq * kRows;
  const int stage = 2 * tile + kStats * kRows * 2;  // q, do, then the f32 row statistics
  Bars bars(smem);
  __nv_bfloat16* ibuf = reinterpret_cast<__nv_bfloat16*>(smem + kBarBytes);  // k and v
  __nv_bfloat16* ring = ibuf + buffers * 2 * tile;
  const int part = blockIdx.x % parts, hg = blockIdx.x / parts;
  const int gi = hg % groups, h = hg / groups;
  const int t0 = gi * kt / groups, t1 = (gi + 1) * kt / groups;
  const int first = static_cast<int>(static_cast<long long>(part) * B / parts);
  const int end = static_cast<int>(static_cast<long long>(part + 1) * B / parts);
  const int steps = (end - first) * nq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const long long C = static_cast<long long>(heads) * d;
  const float* bias_h = bias + static_cast<long long>(h) * N * N;
  zero_smem(smem, kBarBytes + (2 * buffers * tile + stages * stage) * 2);
  bars.init(stages, buffers);

  if (warp >= kConsumers) {  // the producer warpgroup, of which one warp loads
    setmaxnreg_dec<kProducerRegs>();
    if (warp > kConsumers) return;
    // the loading warp: a window's k and v; q, do and the stats a step
#pragma unroll 1
    for (int t = 0; t < steps; ++t) {
      const int w = t / nq, j = t - w * nq, b = first + w;
      if (j == 0) {
        const int kb = w % buffers;
        if (w >= buffers) mbar_wait(&bars.item_empty[kb], (w / buffers - 1) & 1);
        __nv_bfloat16* dst = ibuf + kb * 2 * tile;
        load_rows(dst, k, b, h, 16 * t0, min(N, 16 * t1), d, ld, vec, lane);
        load_rows(dst + tile, v, b, h, 16 * t0, min(N, 16 * t1), d, ld, vec, lane);
        arrive_loaded(&bars.item_full[kb], vec);
      }
      const int st = t % stages;
      if (t >= stages) mbar_wait(&bars.empty[st], (t / stages - 1) & 1);
      __nv_bfloat16* dst = ring + st * stage;
      load_rows(dst, q, b, h, kRows * j, N, d, ld, vec, lane);
      load_rows(dst + tile, dout, b, h, kRows * j, N, d, ld, vec, lane);
      // the row statistics, our own aligned scratch: always 16-byte copies
      const float* src = stats + static_cast<long long>(b * heads + h) * kStats * npad + kRows * j;
      float* sdst = reinterpret_cast<float*>(dst + 2 * tile);
      for (int e = lane; e < kStats * kRows / 4; e += 32)
        cp_async16(sdst + 4 * e, src + (e / (kRows / 4)) * npad + 4 * (e % (kRows / 4)));
      if (!vec) cp_async_wait<0>();  // the element copies' arrival then orders the copies too
      arrive_loaded(&bars.full[st], vec);
    }
    cp_async_wait<0>();
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int i = t0 + warp, kr0 = 16 * i + g, kr1 = kr0 + 8;
  // the bias^T of this thread's elements of the 16-query unit u of step t,
  // into registers a unit ahead
  auto load_unit = [&](float (&bb)[2][4], int t, int u) {
    if (t >= steps) return;
    const int j = t % nq;
#pragma unroll
    for (int t8 = 0; t8 < 2; ++t8)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = kRows * j + 16 * u + 8 * t8 + 2 * t4 + (e & 1), kr = e < 2 ? kr0 : kr1;
        bb[t8][e] = qc < N && kr < N ? __ldg(bias_h + qc * N + kr) : 0.0f;
      }
  };
  float dk[2 * DT][4], dv[2 * DT][4], next_bb[2][4];
  zero<DT>(dk);
  zero<DT>(dv);
  if (i < t1) load_unit(next_bb, 0, 0);
#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
    const int w = t / nq, j = t - w * nq, b = first + w;
    const int stg = t % stages, kb = w % buffers, last = j == nq - 1 ? kb : -1;
    mbar_wait(&bars.full[stg], (t / stages) & 1);
    if (j == 0) mbar_wait(&bars.item_full[kb], (w / buffers) & 1);
    if (i >= t1) {  // a group of fewer than four tiles leaves a warp out
      bars.release(stg, last, lane);
      continue;
    }
    if (j == 0) {
      zero<DT>(dk);
      zero<DT>(dv);
    }
    const __nv_bfloat16* ks = ibuf + kb * 2 * tile + warp * 16 * ld;
    const __nv_bfloat16* vs = ks + tile;
    const __nv_bfloat16* qs = ring + stg * stage;
    const __nv_bfloat16* dos = qs + tile;
    const float* st = reinterpret_cast<const float*>(qs + 2 * tile);
    const int q0 = kRows * j, nsub = min(4, cdiv(N - q0, 16));
#pragma unroll 1
    for (int u = 0; u < nsub; ++u) {
      float bb[2][4];
#pragma unroll
      for (int t8 = 0; t8 < 2; ++t8)
#pragma unroll
        for (int e = 0; e < 4; ++e) bb[t8][e] = next_bb[t8][e];
      if (u + 1 < nsub)
        load_unit(next_bb, t, u + 1);
      else
        load_unit(next_bb, t + 1, 0);
      float sT[2][4], dpT[2][4];
      tile_product<DT>(sT, ks, qs, 0, u, dt, ld, lane);
      tile_product<DT>(dpT, vs, dos, 0, u, dt, ld, lane);
#pragma unroll
      for (int t8 = 0; t8 < 2; ++t8)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = 16 * u + 8 * t8 + 2 * t4 + (e & 1), kr = e < 2 ? kr0 : kr1;
          const bool in = q0 + ql < N && kr < N;
          const float sc = __fadd_rn(__fmul_rn(sT[t8][e], scale), bb[t8][e]);
          const float p = in ? quotient(exp_sub(sc, st[ql]), st[kRows + ql], st[2 * kRows + ql])
                             : 0.0f;
          sT[t8][e] = p;
          dpT[t8][e] = in ? __fmul_rn(p, __fsub_rn(dpT[t8][e], st[3 * kRows + ql])) : 0.0f;
        }
      uint32_t a[4];
      as_a(a, sT[0], sT[1]);
      mma_rows<DT>(dv, a, dos, u, dt, ld, lane);
      as_a(a, dpT[0], dpT[1]);
      mma_rows<DT>(dk, a, qs, u, dt, ld, lane);
    }
    if (j == nq - 1) {
      store_tile<DT>(dqkv + b * g_sb + C + h * d, g_sr, dk, i, N, d, dt, scale, vec, lane);
      store_tile<DT>(dqkv + b * g_sb + 2 * C + h * d, g_sr, dv, i, N, d, dt, 1.0f, vec, lane);
    }
    bars.release(stg, last, lane);
  }
}

// dbias[h] = the sum of head h's `parts` partial planes, in order.
__global__ void long_dbias_reduce_kernel(const float* __restrict__ partial,
                                         float* __restrict__ dbias, int parts, long long plane,
                                         long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long h = i / plane, e = i - h * plane;
  const float* src = partial + h * parts * plane + e;
  float sum = 0.0f;
  for (int p = 0; p < parts; ++p) sum = __fadd_rn(sum, src[p * plane]);
  dbias[i] = sum;
}

bool long_sizes(int B, int N, int heads, int d) {
  return B >= 1 && heads >= 1 && d >= 1 && d <= 128 && N >= 1 && N <= kMaxTokens;
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// The forward's launch plan on a card of `sms` SMs: {blocks, query groups a
// window, ring stages, item buffers, shared memory bytes}. Returns a
// cudaError_t: 0, or cudaErrorInvalidValue (and zeros) when the shape is out
// of range.
extern "C" int dfd_window_attention_long_plan(int B, int N, int heads, int d, int sms,
                                              int* plan) {
  for (int i = 0; i < 5; ++i) plan[i] = 0;
  if (sms < 1 || !long_sizes(B, N, heads, d)) return cudaErrorInvalidValue;
  const int groups = long_groups(N), nk = cdiv(N, kRows);
  const long long items = static_cast<long long>(B) * heads * groups;
  if (items * nk > 0x7fffffffLL) return cudaErrorInvalidValue;
  const Ring r = ring_plan(tile_bytes(d), 2 * tile_bytes(d));
  if (r.stages == 0) return cudaErrorInvalidValue;
  const long long fill = static_cast<long long>(r.per_sm) * sms;
  plan[0] = static_cast<int>(items < fill ? items : fill);
  plan[1] = groups;
  plan[2] = r.stages;
  plan[3] = r.buffers;
  plan[4] = r.smem;
  return cudaSuccess;
}

// The backward's launch plan on a card of `sms` SMs: {parts (blocks a head
// and group, each owning a contiguous range of the windows), groups a
// window, then the row kernel's stages, item buffers and shared memory
// bytes, then the column kernel's}; as dfd_window_attention_long_plan.
extern "C" int dfd_window_attention_long_bwd_plan(int B, int N, int heads, int d, int sms,
                                                  int* plan) {
  for (int i = 0; i < 8; ++i) plan[i] = 0;
  if (sms < 1 || !long_sizes(B, N, heads, d)) return cudaErrorInvalidValue;
  const int groups = long_groups(N), nk = cdiv(N, kRows), tile = tile_bytes(d);
  const Ring rows = ring_plan(2 * tile, 2 * tile);
  const Ring cols = ring_plan(2 * tile, 2 * tile + kStats * kRows * 4);
  const long long hg = static_cast<long long>(heads) * groups;
  if (rows.stages == 0 || cols.stages == 0 || hg * B > 0x7fffffffLL ||
      static_cast<long long>(B) * 2 * nk > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const long long fill = (rows.per_sm < cols.per_sm ? rows.per_sm : cols.per_sm) * sms / hg;
  plan[0] = static_cast<int>(fill < 1 ? 1 : (fill < B ? fill : B));
  plan[1] = groups;
  plan[2] = rows.stages;
  plan[3] = rows.buffers;
  plan[4] = rows.smem;
  plan[5] = cols.stages;
  plan[6] = cols.buffers;
  plan[7] = cols.smem;
  return cudaSuccess;
}

// The forward: arguments as dfd_window_attention's.
extern "C" int dfd_window_attention_long(const void* q, const void* k, const void* v,
                                         const void* bias, void* out, int B, int N, int heads,
                                         int d, long long q_sb, long long q_sr, long long q_sh,
                                         long long k_sb, long long k_sr, long long k_sh,
                                         long long v_sb, long long v_sr, long long v_sh,
                                         long long o_sb, long long o_sr, long long o_sh, int sms,
                                         float scale, int vec, void* stream) {
  int plan[5];
  if (dfd_window_attention_long_plan(B, N, heads, d, sms, plan) != 0)
    return cudaErrorInvalidValue;
  const View qv{static_cast<const __nv_bfloat16*>(q), q_sb, q_sr, q_sh};
  const View kv{static_cast<const __nv_bfloat16*>(k), k_sb, k_sr, k_sh};
  const View vv{static_cast<const __nv_bfloat16*>(v), v_sb, v_sr, v_sh};
  auto kernel = d <= 64 ? window_attention_long_kernel<4> : window_attention_long_kernel<8>;
  cudaError_t e = set_smem(kernel, plan[4]);
  if (e != cudaSuccess) return e;
  kernel<<<plan[0], kThreads, plan[4], static_cast<cudaStream_t>(stream)>>>(
      qv, kv, vv, static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), o_sb, o_sr,
      o_sh, B, N, heads, d, scale, plan[1], plan[2], plan[3], vec);
  return static_cast<int>(cudaGetLastError());
}

// The backward: qkv and dout as dfd_window_attention_bwd's; `partial` holds
// `planes` f32 [N, N] planes (at least heads x parts), `stats` `stats_len`
// f32 (at least B x heads x 4 x 64 ceil(N / 64)).
extern "C" int dfd_window_attention_long_bwd(const void* qkv, const void* dout, const void* bias,
                                             void* dqkv, void* partial, long long planes,
                                             void* dbias, void* stats, long long stats_len,
                                             int B, int N, int heads, int d, long long qkv_sb,
                                             long long qkv_sr, long long do_sb, long long do_sr,
                                             int sms, float scale, int vec, void* stream) {
  int plan[8];
  if (dfd_window_attention_long_bwd_plan(B, N, heads, d, sms, plan) != 0)
    return cudaErrorInvalidValue;
  const int parts = plan[0], groups = plan[1];
  const long long npad = static_cast<long long>(cdiv(N, kRows)) * kRows;
  if (static_cast<long long>(heads) * parts > planes ||
      static_cast<long long>(B) * heads * kStats * npad > stats_len)
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
  float* st = static_cast<float*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(heads * groups * parts);
  auto rows = d <= 64 ? window_attention_long_rows_kernel<4> : window_attention_long_rows_kernel<8>;
  auto cols = d <= 64 ? window_attention_long_cols_kernel<4> : window_attention_long_cols_kernel<8>;
  cudaError_t e = set_smem(rows, plan[4]);
  if (e == cudaSuccess) e = set_smem(cols, plan[7]);
  if (e != cudaSuccess) return e;
  rows<<<grid, kThreads, plan[4], s>>>(qv, kv, vv, dv, bs, g, N * 3 * C, 3 * C, part, st, B, N,
                                       heads, d, groups, parts, scale, plan[2], plan[3], vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  cols<<<grid, kThreads, plan[7], s>>>(qv, kv, vv, dv, bs, g, N * 3 * C, 3 * C, st, B, N, heads,
                                       d, groups, parts, scale, plan[5], plan[6], vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long plane = static_cast<long long>(N) * N, total = heads * plane;
  const int threads = 256;
  long_dbias_reduce_kernel<<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0,
                             s>>>(part, static_cast<float*>(dbias), parts, plane, total);
  return static_cast<int>(cudaGetLastError());
}
