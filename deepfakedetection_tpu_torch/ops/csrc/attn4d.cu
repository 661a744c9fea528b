// K7: EfficientFormerV2's talking-head attention (Attention4D), inference.
//
// Replaces: deepfakedetection_tpu/ops/pallas/attn4d.py, fused_attn4d
//   (_attn4d_kernel, :92; wrapper attn4d_pallas, :149).
// Contract: q, k [B, N, h*d] and v [B, N, h*dv] bf16, each reached through
//   (batch, row) strides with unit stride along features; bias [h, N, N] f32
//   (the gathered table); th1, th2 [h, h] f32 in the flax orientation
//   [h_in, g_out]; th1_b, th2_b [h] f32; out [B, N, h*dv] bf16, contiguous.
//   Per image and output head g, for key columns m < N:
//     s_h  = (q_h . k_h^T accumulated in f32) * scale + bias[h]
//     p_g  = softmax_m(sum_h th1[h, g] * s_h + th1_b[g])
//     p2_g = sum_h th2[h, g] * p_h + th2_b[g], rounded to bf16
//     out_g = p2_g . v_g accumulated in f32, rounded to bf16.
//   N <= 128, h <= 8, d % 16 == 0, dv % 8 == 0, and a plan whose shared
//   memory fits a block (every N <= 128 with h <= 8, d <= 32 and dv <= 128
//   does; the plan is refused with cudaErrorInvalidValue otherwise).
// Bound on the H100: HBM bytes. At EfficientFormerV2-S1's shapes (N 49, h 8,
//   d 32, dv 128) an image reads q, k (50 KB) and v (100 KB) and writes 100 KB
//   for 3.2 MFLOP on the tensor cores and 0.3 MFLOP of f32 head mixing: ~14
//   flops per byte, far below the ~295 flop/byte bf16 line. One launch at
//   batch 256 moves 64 MB (~19 us at 3.35 TB/s).
//
// Design. The talking-head mixes combine every head at each (query, key)
//   pair, so a block cannot own one head as K5's does. The kernel this
//   replaced gave a block one image's 16-row query tile (four blocks an
//   image, two an SM): each block staged all of its image's k and v (four
//   reads of each) through registers, a block barrier after every copy, and
//   stored 4 bytes a thread. Measured on the card (PERF.md, PR 14 Step 1):
//   without its v staging it took 0.61 of its time, without its k staging
//   0.91, without its stores 1.00, without its softmax phase 0.69; with four
//   tiles a block (k and v read once an image, one block of four warps an
//   SM, the same synchronous copies) 1.6x its time. So the copies must run
//   behind the arithmetic, and the softmax phase needs many warps:
//   - A block owns whole images, persistently: the grid holds
//     ceil(B / images) blocks, images = ceil(B / min(B, SMs)), and block i
//     takes images i, i + grid, ... . An image is walked in row groups of T
//     16-row query tiles; T is every tile of the image when it fits (at N 49
//     it does), so q, k and v leave device memory once an image. (A cluster
//     of blocks sharing k and v was the other way; one block an SM holds a
//     whole image, so the cluster's ring release across SMs buys nothing.)
//   - Two producer warps keep the copies in flight with bulk asynchronous
//     copies (cp.async.bulk, one a row, completion counted in bytes on an
//     mbarrier): one loads the next row group's q (and at an image's first
//     group its k) as soon as this group's phase A has read them; the other
//     streams v one head at a time through a ring of `slots` slots, running
//     ahead into the next image's heads while this image's products run.
//     Where 16-byte copies are not allowed (a stride not a multiple of 8, an
//     unaligned view) they copy element by element.
//   - Fourteen consumer warps run the phases of each group, with a barrier
//     of the consumers between phases (at 8 heads and N 49 they fill 126
//     registers a thread; fewer warps were slower, PERF.md):
//     A: items (head, query tile): s_h = q_h k_h^T on the tensor cores
//        (ldmatrix + mma.sync m16n8k16, contracting d in 16-wide steps),
//        raw f32 scores of the group's rows < N and columns < N into S.
//     B: a warp takes one query row at a time; a lane holds key columns lane
//        and lane + 32 (and + 64, + 96 for N > 64): scale and bias (the next
//        row's bias loaded from L2 while this row runs), the th1 mix in f32
//        FMAs, the mask on columns >= N (after the mix: a -inf mixed across
//        heads with signed weights would corrupt the valid ones), the row
//        softmax with the max and sum reduced across the warp, the th2 mix,
//        and bf16 p2 written over the row's own scores (zero on columns >= N:
//        there th2_b would otherwise add th2_b[g] * v past the last token).
//        Each step runs over all heads before the next, so the heads'
//        shuffle chains interleave; with 8 heads (every shipped model) the
//        head count is a compile-time constant and the per-head branches
//        fold away. Columns past N skip the division (0 / l is 0).
//     C: items (head g, query tile) take the heads in ring order: a warp
//        waits for v_g's slot, loads its tile of p2_g by ldmatrix, runs p2_g
//        . v_g (v by ldmatrix.trans) 64 columns at a time, stages the bf16
//        tile in its own p2 rows and stores it 16 bytes a thread; every
//        consumer warp then frees the slot for the producer.
//   Rows past N are never copied: q, k and p2 operand rows past the last
//   valid one repeat it (their products land in rows or columns that are
//   masked or never stored), and the products read keys past N of v from
//   one zero row.
//   The scores, scale and bias, both mixes (FMAs over h ascending), expf,
//   the max and sum shuffles, the division, the single roundings of p2 and
//   the output and the order of the products are those of the kernel this
//   replaced, so the two give bit-identical outputs.
// Plan (plan below; ops/attn4d.py plan mirrors it): T, the most tiles a
//   group with a ring of at least two slots, else one tile; then the deepest
//   ring of up to kMaxSlots slots that fits 227 KB. On an H100 (132 SMs):
//     shape (B, N, heads, d, dv)  blocks images tiles slots shared memory
//     (256, 49, 8, 32, 128):    128   2   4   7   227872
//     (8, 49, 8, 32, 128):        8   1   4   7   227872
//     (133, 49, 8, 32, 128):     67   2   4   7   227872
//     (8, 128, 8, 32, 128):       8   1   1   2   214544
//     (8, 100, 3, 32, 40):        8   1   7   6   229936
//     (8, 64, 8, 32, 128):        8   1   3   3   217104
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"
#include "window_attn_common.cuh"
#include "window_attn_pipe.cuh"

namespace {

constexpr int kConsumers = 14;                 // warps that compute
constexpr int kThreads = 32 * (kConsumers + 2);  // and the q/k and v producer warps
constexpr int kMaxHeads = 8;
constexpr int kMaxSlots = 8;
constexpr int kChunk = 64;     // output columns a warp stages at once, at most
constexpr int kTables = 256;   // byte offset of th1, th1_b, th2, th2_b
constexpr int kHeader = 1024;  // barriers, then the tables

struct Src {
  const __nv_bfloat16* p;
  long long sb, sr;  // batch and row strides, in elements
};

// Shared memory of a plan (byte offsets): the header, then q (the group's
// rows < N), k (the image's rows < N), the f32 scores [h][rows][lds] (p2 in
// bf16 over each row's first Np columns after phase B), one zero row of v
// (which the products read for keys past N), and the v ring (`slots` slots
// of N rows).
struct Layout {
  int Np, kt, R, Rr, ldq, lds, ldv, q, k, s, zero, v, slot, total;
  __host__ __device__ Layout(int N, int heads, int d, int dv, int T, int slots) {
    Np = pad16(N);
    kt = Np / 16;
    R = 16 * T;
    Rr = R < N ? R : N;
    ldq = heads * d + 8;
    lds = (N + 3) / 4 * 4;
    if (lds < Np / 2) lds = Np / 2;
    if (lds % 8 == 0) lds += 4;                 // conflict-free ldmatrix rows of p2
    ldv = dv + ((dv / 8) % 2 == 0 ? 8 : 16);    // the same for v; room for a pair of tiles
    q = kHeader;
    k = q + Rr * ldq * 2;
    s = k + N * ldq * 2;
    zero = s + heads * Rr * lds * 4;
    v = zero + ldv * 2;
    slot = N * ldv * 2;
    total = v + slots * slot;
  }
};

struct Plan {
  int blocks;  // persistent blocks
  int images;  // images a block, at most
  int T;       // 16-row query tiles a group
  int slots;   // v ring slots
  int smem;    // bytes of dynamic shared memory
};

// The launch plan; T == 0 when no layout fits.
__host__ __device__ inline Plan plan(int B, int N, int heads, int d, int dv, int sms) {
  Plan p{0, 0, 0, 0, 0};
  const int kt = pad16(N) / 16;
  for (int T = kt; T >= 1 && p.T == 0; --T) {
    const Layout L(N, heads, d, dv, T, 0);
    if (L.total > kMaxSmemBytes) continue;
    int slots = (kMaxSmemBytes - L.total) / L.slot;
    if (slots > kMaxSlots) slots = kMaxSlots;
    if (slots >= 2 || (T == 1 && slots == 1)) {
      p.T = T;
      p.slots = slots;
      p.smem = L.total + slots * L.slot;
    }
  }
  if (p.T == 0) return p;
  const int fill = B < sms ? B : sms;
  p.images = (B + fill - 1) / fill;
  p.blocks = (B + p.images - 1) / p.images;
  return p;
}

// One bulk asynchronous copy of `bytes` (a multiple of 16; both addresses
// 16-byte aligned) from global into shared memory, counted in bytes on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The warp's copies of `parts` row blocks into shared memory, completed on
// bar: bulk copies (vec) or element stores and one arrival.
struct Part {
  __nv_bfloat16* dst;
  int ld;
  const __nv_bfloat16* src;
  long long sr;
  int rows, width;
};

template <int P>
__device__ __forceinline__ void load_parts(const Part (&parts)[P], int n, bool vec, uint64_t* bar,
                                           int lane) {
  if (vec) {
    uint32_t bytes = 0;
#pragma unroll
    for (int i = 0; i < P; ++i)
      if (i < n) bytes += static_cast<uint32_t>(parts[i].rows) * parts[i].width * 2;
    if (lane == 0) mbar_arrive_expect_tx(bar, bytes);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (i >= n) continue;
      const Part& t = parts[i];
      for (int r = lane; r < t.rows; r += 32)
        bulk_load(t.dst + r * t.ld, t.src + r * t.sr, static_cast<uint32_t>(t.width) * 2, bar);
    }
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (i >= n) continue;
      const Part& t = parts[i];
      for (int e = lane; e < t.rows * t.width; e += 32) {
        const int r = e / t.width, c = e - r * t.width;
        t.dst[r * t.ld + c] = t.src[r * t.sr + c];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  }
}

// The bias of query row r for key columns lane + 32 j, every head (zero
// past N, past the heads, and for no row).
template <int CPL>
__device__ __forceinline__ void load_bias(float (&out)[kMaxHeads][CPL],
                                          const float* __restrict__ bias, int r, bool live, int N,
                                          int heads, int lane) {
  const float* row = bias + r * N + lane;  // the table holds at most 8 * 128 * 128 floats
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h)
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      out[h][j] = live && h < heads && lane + 32 * j < N ? row[h * N * N + 32 * j] : 0.0f;
}

// KT bounds the 16-key tiles (N <= 16 KT); the loops run over the actual kt.
// H is the head count when it is fixed at compile time (8, the models'), 0
// for any count: the per-head branches then fold away.
template <int KT, int H>
__global__ void __launch_bounds__(kThreads, 1)
    attn4d_kernel(Src q, Src k, Src v, const float* __restrict__ bias,
                  const float* __restrict__ th1, const float* __restrict__ th1_b,
                  const float* __restrict__ th2, const float* __restrict__ th2_b,
                  __nv_bfloat16* __restrict__ out, int B, int N, int heads_arg, int d, int dv,
                  int T, int slots, float scale, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int heads = H > 0 ? H : heads_arg;
  const int Cq = heads * d, Cv = heads * dv;
  const Layout L(N, heads, d, dv, T, slots);
  const int Np = L.Np, kt = L.kt;
  uint64_t* qk_full = reinterpret_cast<uint64_t*>(smem);  // a group's q (and k) landed
  uint64_t* qk_empty = qk_full + 1;                       // the consumers' phase A read them
  uint64_t* v_full = qk_full + 2;                         // [kMaxSlots] a slot's v landed
  uint64_t* v_empty = v_full + kMaxSlots;                 // [kMaxSlots] every consumer read it
  float* t1 = reinterpret_cast<float*>(smem + kTables);
  float* t1b = t1 + heads * heads;
  float* t2 = t1b + heads;
  float* t2b = t2 + heads * heads;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L.q);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + L.k);
  float* S = reinterpret_cast<float*>(smem + L.s);
  __nv_bfloat16* vzero = reinterpret_cast<__nv_bfloat16*>(smem + L.zero);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + L.v);

  for (int i = threadIdx.x; i < L.ldv / 8; i += kThreads)
    reinterpret_cast<uint4*>(vzero)[i] = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < heads * heads; i += kThreads) {
    t1[i] = th1[i];
    t2[i] = th2[i];
  }
  for (int i = threadIdx.x; i < heads; i += kThreads) {
    t1b[i] = th1_b[i];
    t2b[i] = th2_b[i];
  }
  if (threadIdx.x == 0) {
    mbar_init(qk_full, 1);
    mbar_init(qk_empty, 1);
    for (int s = 0; s < kMaxSlots; ++s) {
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int images = (B - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int groups = (kt + T - 1) / T;
  const int items = images * groups;  // (image, row group), image-major

  if (warp == kConsumers) {  // the q/k producer
    for (int n = 0; n < items; ++n) {
      const long long b = blockIdx.x + static_cast<long long>(n / groups) * gridDim.x;
      const int r0 = (n % groups) * L.R, rows = min(L.R, N - r0);
      if (n > 0) mbar_wait(qk_empty, (n - 1) & 1);
      const Part parts[2] = {{qs, L.ldq, q.p + b * q.sb + r0 * q.sr, q.sr, rows, Cq},
                             {ks, L.ldq, k.p + b * k.sb, k.sr, N, Cq}};
      load_parts(parts, r0 == 0 ? 2 : 1, vec, qk_full, lane);
    }
    return;
  }
  if (warp == kConsumers + 1) {  // the v producer
    int vi = 0;
    for (int n = 0; n < items; ++n) {
      const long long b = blockIdx.x + static_cast<long long>(n / groups) * gridDim.x;
      for (int g = 0; g < heads; ++g, ++vi) {
        const int s = vi % slots;
        if (vi >= slots) mbar_wait(&v_empty[s], (vi / slots - 1) & 1);
        const Part parts[1] = {{ring + s * (L.slot / 2), L.ldv, v.p + b * v.sb + g * dv, v.sr, N,
                                dv}};
        load_parts(parts, 1, vec, &v_full[s], lane);
      }
    }
    return;
  }

  // The consumers.
  const int g8 = lane >> 2, t4 = lane & 3;  // mma group (row) and thread in group
  const int tile_row = lane & 15, tile_col = (lane >> 4) * 8;  // ldmatrix: A rows, trans B rows
  const int key_row = (lane & 7) + ((lane >> 4) << 3), key_col = ((lane >> 3) & 1) * 8;
  const int lds = L.lds, ldp = 2 * lds;  // p2's row stride in bf16
  const int cwid = min(kChunk, ldp / 8 * 8);
  const int nchunks = (dv + cwid - 1) / cwid;
  int vi = 0;
#pragma unroll 1
  for (int n = 0; n < items; ++n) {
    const long long b = blockIdx.x + static_cast<long long>(n / groups) * gridDim.x;
    const int r0 = (n % groups) * L.R, rows = min(L.R, N - r0), tiles = (rows + 15) / 16;
    mbar_wait(qk_full, n & 1);

    // Phase A: raw f32 scores of every head, S[h][row][key], rows < rows and keys < N.
#pragma unroll 1
    for (int it = warp; it < heads * tiles; it += kConsumers) {
      const int h = it / tiles, mt = it % tiles;
      float s[2 * KT][4];
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
      const __nv_bfloat16* qa = qs + min(mt * 16 + tile_row, rows - 1) * L.ldq + h * d + tile_col;
      for (int kk = 0; kk < d / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, qa + kk * 16);
#pragma unroll
        for (int np = 0; np < KT; ++np) {
          if (np >= kt) continue;
          uint32_t bk[4];
          ldmatrix_x4(bk, ks + min(np * 16 + key_row, N - 1) * L.ldq + h * d + kk * 16 + key_col);
          mma_bf16_16816(s[2 * np], a, bk[0], bk[1]);
          mma_bf16_16816(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }
      const int rr0 = mt * 16 + g8, rr1 = rr0 + 8;
      float* S0 = S + (h * L.Rr + rr0) * lds;
      float* S1 = S0 + 8 * lds;
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt) {
        const int c = nt * 8 + 2 * t4;
        if (nt >= 2 * kt || c >= N) continue;
        if (c + 1 < N) {
          if (rr0 < rows) *reinterpret_cast<float2*>(S0 + c) = make_float2(s[nt][0], s[nt][1]);
          if (rr1 < rows) *reinterpret_cast<float2*>(S1 + c) = make_float2(s[nt][2], s[nt][3]);
        } else {
          if (rr0 < rows) S0[c] = s[nt][0];
          if (rr1 < rows) S1[c] = s[nt][2];
        }
      }
    }
    named_sync(1, 32 * kConsumers);  // S written; q and k read
    if (warp == 0 && lane == 0) mbar_arrive(qk_empty);

    // Phase B: scale and bias, th1 mix, mask, row softmax, th2 mix; bf16 p2
    // over the row's scores, p2[g][row][key]. Each step runs over all heads
    // before the next (the heads' shuffle chains interleave), and the bias
    // of a warp's next row is loaded while it works on this one.
    constexpr int CPL = KT / 2;  // key columns per lane
    float bias_next[kMaxHeads][CPL];
    load_bias<CPL>(bias_next, bias, r0 + warp, warp < rows, N, heads, lane);
#pragma unroll 1
    for (int rr = warp; rr < rows; rr += kConsumers) {
      float bias_row[kMaxHeads][CPL];
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h)
#pragma unroll
        for (int j = 0; j < CPL; ++j) bias_row[h][j] = bias_next[h][j];
      load_bias<CPL>(bias_next, bias, r0 + rr + kConsumers, rr + kConsumers < rows, N, heads,
                     lane);
      float x[kMaxHeads][CPL];
#pragma unroll
      for (int gg = 0; gg < kMaxHeads; ++gg)
#pragma unroll
        for (int j = 0; j < CPL; ++j) x[gg][j] = 0.0f;
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h) {
        if (h >= heads) continue;
        const float* srow = S + (h * L.Rr + rr) * lds;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int c = lane + 32 * j;
          const float sv = c < N ? __fadd_rn(__fmul_rn(srow[c], scale), bias_row[h][j]) : 0.0f;
#pragma unroll
          for (int gg = 0; gg < kMaxHeads; ++gg)
            if (gg < heads) x[gg][j] = fmaf(t1[h * heads + gg], sv, x[gg][j]);
        }
      }
      __syncwarp();  // every lane has read the row's scores before p2 overwrites them
      float m[kMaxHeads], l[kMaxHeads];
#pragma unroll
      for (int gg = 0; gg < kMaxHeads; ++gg) {
        m[gg] = -INFINITY;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int c = lane + 32 * j;
          x[gg][j] = c < N && gg < heads ? __fadd_rn(x[gg][j], t1b[gg]) : -INFINITY;
          m[gg] = fmaxf(m[gg], x[gg][j]);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int gg = 0; gg < kMaxHeads; ++gg)
          if (gg < heads) m[gg] = fmaxf(m[gg], __shfl_xor_sync(0xffffffffu, m[gg], off));
#pragma unroll
      for (int gg = 0; gg < kMaxHeads; ++gg) {
        l[gg] = 0.0f;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int c = lane + 32 * j;
          x[gg][j] = c < N && gg < heads ? expf(__fsub_rn(x[gg][j], m[gg])) : 0.0f;
          l[gg] += x[gg][j];
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int gg = 0; gg < kMaxHeads; ++gg)
          if (gg < heads) l[gg] += __shfl_xor_sync(0xffffffffu, l[gg], off);
#pragma unroll
      for (int gg = 0; gg < kMaxHeads; ++gg)
#pragma unroll
        for (int j = 0; j < CPL; ++j)  // 0 / l is 0: columns past N skip the division
          if (gg < heads && lane + 32 * j < N) x[gg][j] = __fdiv_rn(x[gg][j], l[gg]);
#pragma unroll
      for (int go = 0; go < kMaxHeads; ++go) {
        if (go >= heads) continue;
        __nv_bfloat16* prow = reinterpret_cast<__nv_bfloat16*>(S + (go * L.Rr + rr) * lds);
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int c = lane + 32 * j;
          if (c >= Np) continue;
          float acc = 0.0f;
#pragma unroll
          for (int gg = 0; gg < kMaxHeads; ++gg)
            if (gg < heads) acc = fmaf(t2[gg * heads + go], x[gg][j], acc);
          prow[c] = __float2bfloat16_rn(c < N ? __fadd_rn(acc, t2b[go]) : 0.0f);
        }
      }
    }
    named_sync(1, 32 * kConsumers);  // p2 written

    // Phase C: out_g = p2_g . v_g, items (g, tile) in ring order; every
    // consumer warp frees each head's slot.
#pragma unroll 1
    for (int go = 0; go < heads; ++go, ++vi) {
      const int slot = vi % slots;
      mbar_wait(&v_full[slot], (vi / slots) & 1);
      const __nv_bfloat16* vs = ring + slot * (L.slot / 2);
#pragma unroll 1
      for (int mt = 0; mt < tiles; ++mt) {
        if ((go * tiles + mt) % kConsumers != warp) continue;
        __nv_bfloat16* p2 = reinterpret_cast<__nv_bfloat16*>(S + (go * L.Rr + mt * 16) * lds);
        uint32_t a[KT][4];
#pragma unroll
        for (int j = 0; j < KT; ++j)
          if (j < kt)
            ldmatrix_x4(a[j], p2 + min(tile_row, rows - 1 - mt * 16) * ldp + j * 16 + tile_col);
        __syncwarp();  // the tile's p2 is in registers: its rows take the staged output
        const int trows = min(16, rows - mt * 16);
        __nv_bfloat16* orow = out + ((b * N + r0 + mt * 16) * Cv + go * dv);
#pragma unroll 1
        for (int ch = 0; ch < nchunks; ++ch) {
          const int c0 = ch * cwid, width = min(cwid, dv - c0), ntiles = (width + 7) / 8;
          float o[kChunk / 8][4];
#pragma unroll
          for (int nt = 0; nt < kChunk / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.0f;
#pragma unroll
          for (int j = 0; j < KT; ++j) {
            if (j >= kt) continue;
#pragma unroll
            for (int np = 0; np < kChunk / 16; ++np) {
              if (2 * np >= ntiles) continue;
              uint32_t bv[4];
              const int key = j * 16 + tile_row;  // keys past N read the zero row
              ldmatrix_x4_trans(bv, (key < N ? vs + key * L.ldv : vzero) + c0 + np * 16 + tile_col);
              mma_bf16_16816(o[2 * np], a[j], bv[0], bv[1]);
              mma_bf16_16816(o[2 * np + 1], a[j], bv[2], bv[3]);
            }
          }
          // Stage the chunk in the tile's p2 rows (valid rows only), then store it.
#pragma unroll
          for (int nt = 0; nt < kChunk / 8; ++nt) {
            if (nt >= ntiles) continue;
            const int c = nt * 8 + 2 * t4;
            if (g8 < trows)
              *reinterpret_cast<uint32_t*>(p2 + g8 * ldp + c) = pack_bf16(o[nt][0], o[nt][1]);
            if (g8 + 8 < trows)
              *reinterpret_cast<uint32_t*>(p2 + (g8 + 8) * ldp + c) = pack_bf16(o[nt][2], o[nt][3]);
          }
          __syncwarp();
          if (vec) {
            const int per_row = width / 8;
            for (int e = lane; e < trows * per_row; e += 32) {
              const int rr = e / per_row, cc = (e - rr * per_row) * 8;
              *reinterpret_cast<uint4*>(orow + rr * Cv + c0 + cc) =
                  *reinterpret_cast<const uint4*>(p2 + rr * ldp + cc);
            }
          } else {
            for (int e = lane; e < trows * width; e += 32) {
              const int rr = e / width, cc = e - rr * width;
              orow[rr * Cv + c0 + cc] = p2[rr * ldp + cc];
            }
          }
          __syncwarp();
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&v_empty[slot]);
    }
    named_sync(1, 32 * kConsumers);  // p2 read: the next group's scores may take its place
  }
}

template <int KT, int H>
cudaError_t launch(Src q, Src k, Src v, const float* bias, const float* th1, const float* th1_b,
                   const float* th2, const float* th2_b, __nv_bfloat16* out, int B, int N,
                   int heads, int d, int dv, const Plan& p, float scale, int vec,
                   cudaStream_t stream) {
  auto kernel = attn4d_kernel<KT, H>;
  if (p.smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<p.blocks, kThreads, p.smem, stream>>>(q, k, v, bias, th1, th1_b, th2, th2_b, out, B,
                                                 N, heads, d, dv, p.T, p.slots, scale, vec);
  return cudaGetLastError();
}

}  // namespace

// The launch plan for a shape on a card of `sms` SMs: {blocks, images a
// block, tiles a row group, ring slots, shared memory bytes}. Returns a
// cudaError_t: 0, or cudaErrorInvalidValue (and zeros) when the shape is out
// of range or no plan fits.
extern "C" int dfd_attn4d_plan(int B, int N, int heads, int d, int dv, int sms, int* out) {
  for (int i = 0; i < 5; ++i) out[i] = 0;
  if (B < 1 || N < 1 || N > 128 || heads < 1 || heads > kMaxHeads || d < 16 || d % 16 ||
      dv < 8 || dv % 8 || sms < 1)
    return cudaErrorInvalidValue;
  const Plan p = plan(B, N, heads, d, dv, sms);
  if (p.T == 0) return cudaErrorInvalidValue;
  out[0] = p.blocks;
  out[1] = p.images;
  out[2] = p.T;
  out[3] = p.slots;
  out[4] = p.smem;
  return cudaSuccess;
}

// Returns a cudaError_t: 0 on success. Strides are in elements; vec = 1
// promises h*d, dv and every stride % 8 == 0 and 16-byte aligned q, k, v and
// out, for 16-byte copies and stores. The plan is that of a card of `sms` SMs.
extern "C" int dfd_attn4d(const void* q, const void* k, const void* v, const void* bias,
                          const void* th1, const void* th1_b, const void* th2, const void* th2_b,
                          void* out, int B, int N, int heads, int d, int dv, long long q_sb,
                          long long q_sr, long long k_sb, long long k_sr, long long v_sb,
                          long long v_sr, int sms, float scale, int vec, void* stream) {
  int pl[5];
  if (dfd_attn4d_plan(B, N, heads, d, dv, sms, pl) != 0) return cudaErrorInvalidValue;
  const Plan p{pl[0], pl[1], pl[2], pl[3], pl[4]};
  const Src qv{static_cast<const __nv_bfloat16*>(q), q_sb, q_sr};
  const Src kv{static_cast<const __nv_bfloat16*>(k), k_sb, k_sr};
  const Src vv{static_cast<const __nv_bfloat16*>(v), v_sb, v_sr};
  const float *bs = static_cast<const float*>(bias), *t1 = static_cast<const float*>(th1),
              *t1b = static_cast<const float*>(th1_b), *t2 = static_cast<const float*>(th2),
              *t2b = static_cast<const float*>(th2_b);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (N <= 64)
    rc = heads == kMaxHeads
             ? launch<4, kMaxHeads>(qv, kv, vv, bs, t1, t1b, t2, t2b, o, B, N, heads, d, dv, p,
                                    scale, vec, st)
             : launch<4, 0>(qv, kv, vv, bs, t1, t1b, t2, t2b, o, B, N, heads, d, dv, p, scale,
                            vec, st);
  else
    rc = heads == kMaxHeads
             ? launch<8, kMaxHeads>(qv, kv, vv, bs, t1, t1b, t2, t2b, o, B, N, heads, d, dv, p,
                                    scale, vec, st)
             : launch<8, 0>(qv, kv, vv, bs, t1, t1b, t2, t2b, o, B, N, heads, d, dv, p, scale,
                            vec, st);
  return static_cast<int>(rc);
}
