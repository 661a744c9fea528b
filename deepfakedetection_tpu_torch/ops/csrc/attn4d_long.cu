// K7 past 128 tokens: EfficientFormerV2's talking-head attention
// (Attention4D), inference, over any N from 129 to 46,340 tokens
// (EfficientFormerV2-S1's stages 3 and 4 at 384 px: 144 tokens; at 512 px:
// 256; at 544 px: 289; at 640 px: 400). attn4d.cu keeps N <= 128;
// ops/attn4d.py chooses by N.
//
// Replaces: deepfakedetection_tpu/ops/pallas/attn4d.py, fused_attn4d
//   (_attn4d_kernel, :92; wrapper attn4d_pallas, :149) at these sizes, where
//   it pads N to a multiple of 16.
// Contract: as attn4d.cu. q, k [B, N, h*d], v [B, N, h*dv] bf16 through
//   (batch, row) strides, bias [h, N, N], th1, th2 [h, h] (flax [h_in,
//   g_out]), th1_b, th2_b [h] f32 -> out [B, N, h*dv] bf16, contiguous; per
//   image and output head g, for key columns m < N:
//     s_h  = (q_h . k_h^T accumulated in f32) * scale + bias[h]
//     p_g  = softmax_m(sum_h th1[h, g] * s_h + th1_b[g])
//     p2_g = sum_h th2[h, g] * p_h + th2_b[g], rounded to bf16
//     out_g = p2_g . v_g accumulated in f32, rounded to bf16.
//   128 < N <= 46,340 (N^2 an int), h <= 8, d % 16 == 0 and d <= 128, dv % 8
//   == 0 and dv <= 128, and a ring of two stages within a block's 227 KB
//   (every shape at h 8, d 32).
// Rounding: s_h, the th1 mix (head order), the th2 mix (head order) and p2's
//   rounding are the plain version's; the softmax is two walks over the keys,
//   the first keeping each row's running max and sum online, the second
//   forming p = exp(x - max) / sum (a quotient from one reciprocal a row,
//   IEEE division's result), with exp as ex2.approx. The plain version sums
//   in another order: the two agree within two bf16 steps of the output's
//   scale.
// Bound on the H100: HBM bytes at S1's 384 px shape (N 144, h 8, d 32, dv
//   128): an image reads q, k (147 KB) and v (295 KB) and writes 295 KB for 2
//   N^2 h (d + dv) = 53 MFLOP on the tensor cores and 2 N^2 h^2 f32 mixes; the
//   operations bound it from 256 tokens (the mixes on the CUDA cores).
// Measured: PERF.md (chip_smoke.py phase 1, profile_k7). What holds it back
//   is traffic more than math: every 32-row item reads its image's k and v
//   and its rows' bias from L2 once a walk, and every warp reads its share
//   of each stage, the exchanges and v from shared memory.
//
// Design. p2 is rounded after the normalisation and mixes all heads'
//   normalised p, so an online softmax cannot give the output in one walk:
//   each row's max and sum come first. A block is 8 consumer warps and a
//   producer warpgroup (setmaxnreg: 232 registers a consumer thread, 40 a
//   producer); an item is an image's group of 32 query rows, two 16-row
//   tiles of four warps each, a warp owning two heads. Persistent blocks, one
//   an SM, take items blockIdx.x, + gridDim.x, ... (images outermost, so the
//   blocks at work share a few images' k and v in L2). The producer walks
//   each item's steps ahead of the consumers: its q rows into one of two
//   item buffers, then twice over the 16-key tiles, each tile's k rows (and,
//   the second time, v rows) of every head and the item rows' bias of every
//   head into a ring stage (2 to 4 stages): q, k and v a bulk copy a row (512
//   and 2,048 bytes at S1's widths), counted on the stage's full mbarrier's
//   transaction count, the bias and rows past N by 16-byte cp.async (zero
//   past N), counted on its arrivals; the consumers free a stage on its empty
//   mbarrier. Unaligned views take element copies. Shared memory does not
//   grow with N.
//   Each step of either walk: a warp computes its two heads' q_h k_h^T for
//   its 16 rows (mma.sync m16n8k16, q by ldmatrix, k by ldmatrix from rows
//   permuted in key_of's order, so each thread's four bias values are one
//   16-byte load), scales and adds the bias into a score exchange in shared
//   memory (an m16n8 accumulator holds the same (row, key) in the same lane
//   for every head, so a lane reads back its own positions); a named
//   barrier over the row tile's four warps; each warp mixes th1 over every
//   head's scores into its two output heads.
//   Walk 1 keeps a running max and sum per (row, output head) over the
//   thread's own columns, merged over the four threads of a row at the end.
//   Walk 2 forms p = exp(x - max) / sum of the warp's heads into a p
//   exchange; a second barrier; each warp reads every head's p, mixes th2
//   into its two heads, rounds p2 to bf16 straight into the A fragment and
//   multiplies v (ldmatrix.trans from the permuted rows) into f32
//   accumulators: 2 heads x dv 128 = 128 registers a thread. The score
//   exchange has two buffers (walk 1 has one barrier a step); the p
//   exchange one (its next write follows the next step's first barrier). No
//   atomics: two runs give bit-identical outputs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"
#include "window_attn_common.cuh"
#include "window_attn_pipe.cuh"

namespace {

constexpr int kMinN = 129, kMaxN = 46340;  // N^2 fits an int
constexpr int kHeads = 8;                  // the most heads; the tables take this many
constexpr int kMaxD = 128, kMaxDv = 128;
constexpr int kDvTiles = kMaxDv / 8;       // a head's n8 output tiles
constexpr int kRowTiles = 2;               // 16-row query tiles an item
constexpr int kRows = 16 * kRowTiles;      // query rows an item
constexpr int kQuarters = 4;               // warps a row tile, two output heads each
constexpr int kConsumers = kRowTiles * kQuarters;
constexpr int kProducers = 128;            // the producer warpgroup's threads
constexpr int kThreads = 32 * kConsumers + kProducers;
constexpr int kConsumerRegs = 232, kProducerRegs = 40;
constexpr int kKeys = 16;                  // keys a ring stage
constexpr int kMaxStages = 4;
constexpr int kHeader = 1024;              // the mbarriers, then the tables
constexpr int kTables = 128;               // the tables' offset
static_assert(kProducers == 4 * kRows, "copy_bias gives a producer thread one row's four keys");
static_assert(kRows <= 32 && kKeys <= 32, "load_rows gives a lane one row");

struct Src {
  const __nv_bfloat16* p;
  long long sb, sr;  // batch and row strides, in elements
};

// Shared memory (byte offsets): the header (mbarriers; th1, th1_b, th2, th2_b
// at kTables), the score exchange [kRowTiles][2][heads][2][32 lanes][4] f32
// (two buffers a row tile), the p exchange [kRowTiles][heads][2][32][4] f32,
// the q item buffers [kRows][ldq] bf16, then the ring, each stage k
// [kKeys][ldq] and v [kKeys][ldv] bf16 and the bias [heads][kRows][kKeys] f32.
struct LongLayout {
  int ldq, ldv, xbuf, qbuf, kbytes, vbytes, stage, p, q;
  __host__ __device__ LongLayout(int heads, int d, int dv) {
    ldq = heads * d + 8;  // conflict-free ldmatrix rows (heads * d % 16 == 0)
    const int cv = heads * dv;
    ldv = cv + ((cv / 8) % 2 == 0 ? 8 : 16);
    xbuf = heads * 2 * 32 * 16;
    qbuf = kRows * ldq * 2;
    kbytes = kKeys * ldq * 2;
    vbytes = kKeys * ldv * 2;
    stage = kbytes + vbytes + heads * kRows * kKeys * 4;
    p = kHeader + kRowTiles * 2 * xbuf;
    q = p + kRowTiles * xbuf;
  }
  __host__ __device__ int bytes(int qbufs, int stages) const {
    return q + qbufs * qbuf + stages * stage;
  }
};

// The pipeline's mbarriers: each stage's full (the producer's threads) and
// empty (a consumer warp each), and the same of each q item buffer.
struct Bars {
  uint64_t *full, *empty, *item_full, *item_empty;

  __device__ explicit Bars(unsigned char* smem)
      : full(reinterpret_cast<uint64_t*>(smem)), empty(full + kMaxStages),
        item_full(empty + kMaxStages), item_empty(item_full + 2) {}
};

// The categories of a build with -DDFD_K7_CLOCKS (profile_k7.phases): the
// consumers' walk 1, walk 2's scores and p, its exchange barrier, its th2
// mix and p2 v, and their waits on full barriers (warp 0's lane 0); the
// producer's waits on empty barriers and its copies (its first thread).
enum { kWalk1, kWalk2Scores, kExchange, kWalk2Pv, kFullWait, kEmptyWait, kCopies, kLaps };
#ifdef DFD_K7_CLOCKS
__device__ unsigned long long dfd_k7_clocks[kLaps];  // cycles summed over blocks
#endif

// Laps of one thread's clock into the categories; nothing without
// DFD_K7_CLOCKS.
struct Clocks {
#ifdef DFD_K7_CLOCKS
  unsigned long long acc[kLaps] = {};
  long long last = 0;
  __device__ void start() { last = clock64(); }
  __device__ void lap(int i) {
    const long long now = clock64();
    acc[i] += now - last;
    last = now;
  }
  __device__ void flush(bool leader) const {
    if (leader)
      for (int i = 0; i < kLaps; ++i) atomicAdd(&dfd_k7_clocks[i], acc[i]);
  }
#else
  __device__ void start() {}
  __device__ void lap(int) {}
  __device__ void flush(bool) const {}
#endif
};

// 4-byte cp.async that writes zeros (reads nothing) where `in` is false.
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) into shared memory, counted on bar's transaction count.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Adds `bytes` to the transaction count bar's phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Rows [row0, row0 + rows) (rows <= 32) of a bf16 view with row stride sr
// (columns [0, width)) into [rows][ld] shared memory, rows at or past
// `limit` zero, by the producer's threads (t its thread). vec: producer warp
// w alone, a bulk copy a row (its lane 0 adds their bytes to bar's
// transaction count first) and 16-byte zero-filling cp.async for the rows
// past the limit; else element copies by every producer thread.
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src,
                                          long long sr, int row0, int rows, int limit, int width,
                                          bool vec, int w, uint64_t* bar, int t) {
  if (!vec) {
    for (int e = t; e < rows * width; e += kProducers) {
      const int r = e / width, c = e - r * width;
      dst[r * ld + c] = row0 + r < limit ? src[(row0 + r) * sr + c] : __float2bfloat16_rn(0.0f);
    }
    return;
  }
  if (t / 32 != w) return;
  const int lane = t & 31, valid = max(0, min(rows, limit - row0)), chunks = width >> 3;
  if (lane == 0) mbar_expect_tx(bar, valid * width * 2);
  __syncwarp();
  if (lane < valid) bulk_copy(dst + lane * ld, src + (row0 + lane) * sr, width * 2, bar);
  for (int e = lane; e < (rows - valid) * chunks; e += 32) {
    const int r = e / chunks;
    cp_async16_zfill(dst + (valid + r) * ld + 8 * (e - r * chunks), src, false);
  }
}

enum { kBiasQuad, kBiasWords, kBiasPlain };

// The bias of rows [row0, row0 + kRows) at keys [key0, key0 + kKeys) of every
// head into [heads][kRows][kKeys] f32 (zero past N): thread t row t / 4, keys
// 4 (t % 4) .. + 3; one 16-byte cp.async (N % 4 == 0 and an aligned bias: the
// four keys are in or out together), four 4-byte ones, or element copies.
__device__ __forceinline__ void copy_bias(float* dst, const float* bias, int heads, int N,
                                          int row0, int key0, int mode, int t) {
  const int r = t >> 2, c = 4 * (t & 3), row = row0 + r, key = key0 + c;
  for (int h = 0; h < heads; ++h) {
    float* to = dst + (h * kRows + r) * kKeys + c;
    const float* from = bias + (static_cast<long long>(h) * N + min(row, N - 1)) * N + key;
    if (mode == kBiasQuad) {
      const bool in = row < N && key < N;
      cp_async16_zfill(to, in ? from : bias, in);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = row < N && key + e < N;
        if (mode == kBiasWords)
          cp_async4_zfill(to + e, in ? from + e : bias, in);
        else
          to[e] = in ? from[e] : 0.0f;
      }
    }
  }
}

// The producer's copies so far complete on bar, whose count holds its
// threads: the arrival follows the thread's cp.async (vec), or its stores.
__device__ __forceinline__ void arrive_loaded(uint64_t* bar, bool vec) {
  if (vec)
    cp_async_arrive(bar);
  else
    mbar_arrive(bar);
}

// A consumer warp is done with what bar guards.
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// The scores of this warp's heads h = g0 + hi (hi < ng) at its row tile's 16
// rows (q rows qs, bias rows bs) and the stage's 16 keys (k rows ks; the
// accumulators' keys in key_of's order): (q_h k_h^T accumulated in f32) *
// scale + bias[h], into the exchange xs ([heads][2][32 lanes][4]: head,
// n-tile, lane). DT, where not 0, is d / 16 at compile time.
template <int DT>
__device__ __forceinline__ void scores(float* xs, const __nv_bfloat16* qs, const __nv_bfloat16* ks,
                                       int ld, const float* bs, int d, int g0, int ng,
                                       float scale, int lane) {
  const int g8 = lane >> 2, t4 = lane & 3;
  const __nv_bfloat16* qrow = qs + (lane & 15) * ld + (lane >> 4) * 8;
  const __nv_bfloat16* krow =
      ks + key_of((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
  const float* brow = bs + g8 * kKeys + 4 * t4;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    if (hi >= ng) break;
    const int h = g0 + hi;
    float s[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < (DT ? DT : kMaxD / 16); ++kk) {
      if (!DT && 16 * kk >= d) break;
      uint32_t a[4], b[4];
      ldmatrix_x4(a, qrow + h * d + 16 * kk);
      ldmatrix_x4(b, krow + h * d + 16 * kk);
      mma_bf16_16816(s[0], a, b[0], b[1]);
      mma_bf16_16816(s[1], a, b[2], b[3]);
    }
    const float4 b0 = *reinterpret_cast<const float4*>(brow + h * kRows * kKeys);
    const float4 b1 = *reinterpret_cast<const float4*>(brow + h * kRows * kKeys + 8 * kKeys);
    // n-tile t8, entry e <-> row g8 + 8 (e >> 1), key 4 t4 + 2 t8 + (e & 1)
    const float bb[2][4] = {{b0.x, b0.y, b1.x, b1.y}, {b0.z, b0.w, b1.z, b1.w}};
#pragma unroll
    for (int t8 = 0; t8 < 2; ++t8) {
      float sv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) sv[e] = __fadd_rn(__fmul_rn(s[t8][e], scale), bb[t8][e]);
      *reinterpret_cast<float4*>(xs + ((h * 2 + t8) * 32 + lane) * 4) =
          make_float4(sv[0], sv[1], sv[2], sv[3]);
    }
  }
}

// x[gi] = the th1 mix of output head g0 + gi (gi < ng) over every head's
// exchanged scores xs (the f32 products in head order), plus th1_b; -inf at
// keys >= N. H, where not 0, is heads at compile time.
template <int H>
__device__ __forceinline__ void mix_th1(float (&x)[2][2][4], const float* xs, const float* t1,
                                        const float* t1b, int heads, int g0, int ng, int key0,
                                        int N, int lane) {
  const int t4 = lane & 3;
#pragma unroll
  for (int gi = 0; gi < 2; ++gi)
#pragma unroll
    for (int t8 = 0; t8 < 2; ++t8) x[gi][t8][0] = x[gi][t8][1] = x[gi][t8][2] = x[gi][t8][3] = 0.0f;
#pragma unroll
  for (int h = 0; h < (H ? H : kHeads); ++h) {
    if (!H && h >= heads) break;
    const float4 sa = *reinterpret_cast<const float4*>(xs + ((h * 2) * 32 + lane) * 4);
    const float4 sb = *reinterpret_cast<const float4*>(xs + ((h * 2 + 1) * 32 + lane) * 4);
    const float sv[2][4] = {{sa.x, sa.y, sa.z, sa.w}, {sb.x, sb.y, sb.z, sb.w}};
    const float w[2] = {t1[h * heads + g0], ng > 1 ? t1[h * heads + g0 + 1] : 0.0f};
#pragma unroll
    for (int t8 = 0; t8 < 2; ++t8)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[0][t8][e] = fmaf(w[0], sv[t8][e], x[0][t8][e]);
        x[1][t8][e] = fmaf(w[1], sv[t8][e], x[1][t8][e]);
      }
  }
#pragma unroll
  for (int gi = 0; gi < 2; ++gi)
#pragma unroll
    for (int t8 = 0; t8 < 2; ++t8)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[gi][t8][e] = key0 + 4 * t4 + 2 * t8 + (e & 1) < N
                           ? __fadd_rn(x[gi][t8][e], t1b[g0 + gi])
                           : -INFINITY;
}

// o[n] += a . v for the n8 tiles n < dv / 8 (rounded up to pairs): a the p2
// fragment of 16 keys in key_of's order, v one head's [kKeys][ldv] rows;
// DVT, where not 0, is dv / 8 at compile time.
template <int DVT>
__device__ __forceinline__ void pv(float (&o)[kDvTiles][4], const uint32_t (&a)[4],
                                   const __nv_bfloat16* v, int ldv, int dv, int lane) {
  const __nv_bfloat16* row = v + key_of(lane & 15) * ldv + (lane >> 4) * 8;
#pragma unroll
  for (int nd = 0; nd < (DVT ? (DVT + 1) / 2 : kDvTiles / 2); ++nd) {
    if (!DVT && 16 * nd >= dv) break;
    uint32_t b[4];
    ldmatrix_x4_trans(b, row + 16 * nd);
    mma_bf16_16816(o[2 * nd], a, b[0], b[1]);
    mma_bf16_16816(o[2 * nd + 1], a, b[2], b[3]);
  }
}

// H, DT and DVT, where not 0, fix heads, d / 16 and dv / 8 at compile time
// (EfficientFormerV2's 8, 2 and 16): the head and tile loops unroll without
// branches; 0, 0, 0 takes any shape.
template <int H, int DT, int DVT>
__global__ void __launch_bounds__(kThreads, 1)
    attn4d_long_kernel(Src q, Src k, Src v, const float* __restrict__ bias,
                       const float* __restrict__ th1, const float* __restrict__ th1_b,
                       const float* __restrict__ th2, const float* __restrict__ th2_b,
                       __nv_bfloat16* __restrict__ out, int B, int N, int heads, int d, int dv,
                       float scale, int qbufs, int stages, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (H) heads = H;
  if (DT) d = 16 * DT;
  if (DVT) dv = 8 * DVT;
  const LongLayout L(heads, d, dv);
  const int groups = cdiv(N, kRows), items = B * groups, nk = cdiv(N, kKeys);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Bars bars(smem);
  float* t1 = reinterpret_cast<float*>(smem + kTables);
  float* t1b = t1 + kHeads * kHeads;
  float* t2 = t1b + kHeads;
  float* t2b = t2 + kHeads * kHeads;
  __nv_bfloat16* qbase = reinterpret_cast<__nv_bfloat16*>(smem + L.q);
  unsigned char* ring = smem + L.q + qbufs * L.qbuf;
  const bool bvec = vec != 0;
  Clocks clk;
  clk.start();

  for (int i = threadIdx.x; i < kHeads * kHeads; i += kThreads) {
    t1[i] = i < heads * heads ? th1[i] : 0.0f;
    t2[i] = i < heads * heads ? th2[i] : 0.0f;
  }
  if (threadIdx.x < kHeads) {
    t1b[threadIdx.x] = threadIdx.x < heads ? th1_b[threadIdx.x] : 0.0f;
    t2b[threadIdx.x] = threadIdx.x < heads ? th2_b[threadIdx.x] : 0.0f;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&bars.full[s], kProducers);
      mbar_init(&bars.empty[s], kConsumers);
    }
    for (int i = 0; i < qbufs; ++i) {
      mbar_init(&bars.item_full[i], kProducers);
      mbar_init(&bars.item_empty[i], kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kConsumers) {  // the producer warpgroup
    setmaxnreg_dec<kProducerRegs>();
    const int t = threadIdx.x - 32 * kConsumers;
    const int mode = !bvec ? kBiasPlain
                     : (N % 4 == 0 && (reinterpret_cast<uintptr_t>(bias) & 15) == 0) ? kBiasQuad
                                                                                     : kBiasWords;
    int step = 0, li = 0;
#pragma unroll 1
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++li) {
      const int b = item / groups, row0 = (item - b * groups) * kRows;
      const int qb = li % qbufs;
      if (li >= qbufs) mbar_wait(&bars.item_empty[qb], (li / qbufs - 1) & 1);
      clk.lap(kEmptyWait);
      load_rows(qbase + qb * (L.qbuf / 2), L.ldq, q.p + b * q.sb, q.sr, row0, kRows, N,
                heads * d, bvec, 0, &bars.item_full[qb], t);
      arrive_loaded(&bars.item_full[qb], bvec);
      clk.lap(kCopies);
#pragma unroll 1
      for (int walk = 0; walk < 2; ++walk)
#pragma unroll 1
        for (int j = 0; j < nk; ++j, ++step) {
          const int s = step % stages;
          if (step >= stages) mbar_wait(&bars.empty[s], (step / stages - 1) & 1);
          clk.lap(kEmptyWait);
          unsigned char* st = ring + s * L.stage;
          load_rows(reinterpret_cast<__nv_bfloat16*>(st), L.ldq, k.p + b * k.sb, k.sr, j * kKeys,
                    kKeys, N, heads * d, bvec, 0, &bars.full[s], t);
          if (walk)
            load_rows(reinterpret_cast<__nv_bfloat16*>(st + L.kbytes), L.ldv, v.p + b * v.sb,
                      v.sr, j * kKeys, kKeys, N, heads * dv, bvec, 1, &bars.full[s], t);
          copy_bias(reinterpret_cast<float*>(st + L.kbytes + L.vbytes), bias, heads, N, row0,
                    j * kKeys, mode, t);
          arrive_loaded(&bars.full[s], bvec);
          clk.lap(kCopies);
        }
    }
    if (bvec) cp_async_wait<0>();
    clk.flush(t == 0);
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int rt = warp / kQuarters, g0 = 2 * (warp % kQuarters);
  // this warp's heads, of the scores and of the output: g0 .. g0 + ng - 1 (none if <= 0)
  const int ng = H == kHeads ? 2 : min(2, heads - g0);
  const bool mine = ng > 0;
  const int g8 = lane >> 2, t4 = lane & 3, Cv = heads * dv, xf = L.xbuf / 4;
  float* xs_tile = reinterpret_cast<float*>(smem + kHeader) + rt * 2 * xf;  // scores, 2 buffers
  float* xp = reinterpret_cast<float*>(smem + L.p) + rt * xf;               // p, one buffer
  int step = 0, li = 0;
#pragma unroll 1
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++li) {
    const int b = item / groups, row0 = (item - b * groups) * kRows + 16 * rt;  // this tile's
    const bool live = row0 < N;
    const int qb = li % qbufs;
    const __nv_bfloat16* qs = qbase + qb * (L.qbuf / 2) + 16 * rt * L.ldq;
    mbar_wait(&bars.item_full[qb], (li / qbufs) & 1);
    clk.lap(kFullWait);

    // walk 1: each (row, output head)'s max and sum over this thread's keys
    float m[2][2], l[2][2];
#pragma unroll
    for (int gi = 0; gi < 2; ++gi) m[gi][0] = m[gi][1] = -INFINITY, l[gi][0] = l[gi][1] = 0.0f;
#pragma unroll 1
    for (int j = 0; j < nk; ++j, ++step) {
      const int s = step % stages;
      mbar_wait(&bars.full[s], (step / stages) & 1);
      clk.lap(kFullWait);
      if (live) {
        const unsigned char* st = ring + s * L.stage;
        float* xs = xs_tile + (step & 1) * xf;
        if (mine)
          scores<DT>(xs, qs, reinterpret_cast<const __nv_bfloat16*>(st), L.ldq,
                     reinterpret_cast<const float*>(st + L.kbytes + L.vbytes) + 16 * rt * kKeys,
                     d, g0, ng, scale, lane);
        named_sync(1 + rt, 32 * kQuarters);
        if (mine) {
          float x[2][2][4];
          mix_th1<H>(x, xs, t1, t1b, heads, g0, ng, j * kKeys, N, lane);
#pragma unroll
          for (int gi = 0; gi < 2; ++gi)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const float mt = fmaxf(fmaxf(x[gi][0][2 * r], x[gi][0][2 * r + 1]),
                                     fmaxf(x[gi][1][2 * r], x[gi][1][2 * r + 1]));
              const float mn = fmaxf(m[gi][r], mt);
              float acc = __fmul_rn(l[gi][r], exp_sub(m[gi][r], mn));
#pragma unroll
              for (int t8 = 0; t8 < 2; ++t8)
                acc += exp_sub(x[gi][t8][2 * r], mn) + exp_sub(x[gi][t8][2 * r + 1], mn);
              m[gi][r] = mn;
              l[gi][r] = acc;
            }
        }
      }
      release(&bars.empty[s], lane);
      clk.lap(kWalk1);
    }
    // the rows' max and sum over the four threads of each row; 1 / sum
    float inv[2][2];
#pragma unroll
    for (int gi = 0; gi < 2; ++gi)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mx = quad_max(m[gi][r]);
        l[gi][r] = quad_sum(__fmul_rn(l[gi][r], exp_sub(m[gi][r], mx)));
        m[gi][r] = mx;
        inv[gi][r] = __frcp_rn(l[gi][r]);
      }

    // walk 2: the scores and mix again, p of this warp's heads exchanged, p2
    // of its heads times v
    float o[2][kDvTiles][4];
#pragma unroll
    for (int gi = 0; gi < 2; ++gi)
#pragma unroll
      for (int n = 0; n < kDvTiles; ++n) o[gi][n][0] = o[gi][n][1] = o[gi][n][2] = o[gi][n][3] = 0.0f;
#pragma unroll 1
    for (int j = 0; j < nk; ++j, ++step) {
      const int s = step % stages;
      mbar_wait(&bars.full[s], (step / stages) & 1);
      clk.lap(kFullWait);
      if (live) {
        const unsigned char* st = ring + s * L.stage;
        float* xs = xs_tile + (step & 1) * xf;
        if (mine)
          scores<DT>(xs, qs, reinterpret_cast<const __nv_bfloat16*>(st), L.ldq,
                     reinterpret_cast<const float*>(st + L.kbytes + L.vbytes) + 16 * rt * kKeys,
                     d, g0, ng, scale, lane);
        named_sync(1 + rt, 32 * kQuarters);
        if (mine) {
          float x[2][2][4];
          mix_th1<H>(x, xs, t1, t1b, heads, g0, ng, j * kKeys, N, lane);
#pragma unroll
          for (int gi = 0; gi < 2; ++gi) {
            if (gi >= ng) break;
#pragma unroll
            for (int t8 = 0; t8 < 2; ++t8) {
              float p[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int r = e >> 1;
                p[e] = quotient(exp_sub(x[gi][t8][e], m[gi][r]), l[gi][r], inv[gi][r]);
              }
              *reinterpret_cast<float4*>(xp + (((g0 + gi) * 2 + t8) * 32 + lane) * 4) =
                  make_float4(p[0], p[1], p[2], p[3]);
            }
          }
        }
        clk.lap(kWalk2Scores);
        named_sync(1 + rt, 32 * kQuarters);
        clk.lap(kExchange);
        if (mine) {
          float p2[2][2][4] = {};
#pragma unroll
          for (int g = 0; g < (H ? H : kHeads); ++g) {
            if (!H && g >= heads) break;
            const float4 pa = *reinterpret_cast<const float4*>(xp + ((g * 2) * 32 + lane) * 4);
            const float4 pb = *reinterpret_cast<const float4*>(xp + ((g * 2 + 1) * 32 + lane) * 4);
            const float pg[2][4] = {{pa.x, pa.y, pa.z, pa.w}, {pb.x, pb.y, pb.z, pb.w}};
            const float w[2] = {t2[g * heads + g0], ng > 1 ? t2[g * heads + g0 + 1] : 0.0f};
#pragma unroll
            for (int gi = 0; gi < 2; ++gi)
#pragma unroll
              for (int t8 = 0; t8 < 2; ++t8)
#pragma unroll
                for (int e = 0; e < 4; ++e) p2[gi][t8][e] = fmaf(w[gi], pg[t8][e], p2[gi][t8][e]);
          }
          const __nv_bfloat16* vs = reinterpret_cast<const __nv_bfloat16*>(st + L.kbytes);
#pragma unroll
          for (int gi = 0; gi < 2; ++gi) {
            if (gi >= ng) break;
#pragma unroll
            for (int t8 = 0; t8 < 2; ++t8)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                p2[gi][t8][e] = j * kKeys + 4 * t4 + 2 * t8 + (e & 1) < N
                                    ? __fadd_rn(p2[gi][t8][e], t2b[g0 + gi])
                                    : 0.0f;
            uint32_t a[4];
            as_a(a, p2[gi][0], p2[gi][1]);
            pv<DVT>(o[gi], a, vs + (g0 + gi) * dv, L.ldv, dv, lane);
          }
        }
      }
      release(&bars.empty[s], lane);
      clk.lap(kWalk2Pv);
    }
    release(&bars.item_empty[qb], lane);
    if (live && mine) {
      __nv_bfloat16* obase = out + (static_cast<long long>(b) * N + row0) * Cv;
#pragma unroll
      for (int gi = 0; gi < 2; ++gi) {
        if (gi >= ng) break;
#pragma unroll
        for (int n = 0; n < kDvTiles; ++n)
          if (8 * n < dv)
            store_pair_rows(obase + (g0 + gi) * dv, Cv, o[gi][n], g8, 8 * n + 2 * t4, N - row0,
                            dv, 1.0f, true);
      }
    }
    clk.lap(kWalk2Pv);
  }
  clk.flush(threadIdx.x == 0);
}

}  // namespace

// The launch plan {blocks, threads a block, q item buffers, ring stages,
// shared memory bytes} on a card of `sms` SMs: the most stages (4 down to
// 2) whose shared memory fits a block, two q buffers before one at each
// depth; one block an SM, min(B ceil(N / 32), sms) blocks. Returns a
// cudaError_t: 0, or cudaErrorInvalidValue (and zeros) when the shape is
// out of range or no ring fits.
extern "C" int dfd_attn4d_long_plan(int B, int N, int heads, int d, int dv, int sms, int* plan) {
  for (int i = 0; i < 5; ++i) plan[i] = 0;
  if (B < 1 || N < kMinN || N > kMaxN || heads < 1 || heads > kHeads || d < 16 || d % 16 ||
      d > kMaxD || dv < 8 || dv % 8 || dv > kMaxDv || sms < 1)
    return cudaErrorInvalidValue;
  const long long items = static_cast<long long>(B) * cdiv(N, kRows);
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  const LongLayout L(heads, d, dv);
  for (int stages = kMaxStages; stages >= 2; --stages)
    for (int qbufs = 2; qbufs >= 1; --qbufs)
      if (L.bytes(qbufs, stages) <= kMaxSmemBytes) {
        plan[0] = static_cast<int>(items < sms ? items : sms);
        plan[1] = kThreads;
        plan[2] = qbufs;
        plan[3] = stages;
        plan[4] = L.bytes(qbufs, stages);
        return cudaSuccess;
      }
  return cudaErrorInvalidValue;
}

// Returns a cudaError_t: 0 on success. Arguments as dfd_attn4d's.
extern "C" int dfd_attn4d_long(const void* q, const void* k, const void* v, const void* bias,
                               const void* th1, const void* th1_b, const void* th2,
                               const void* th2_b, void* out, int B, int N, int heads, int d,
                               int dv, long long q_sb, long long q_sr, long long k_sb,
                               long long k_sr, long long v_sb, long long v_sr, int sms,
                               float scale, int vec, void* stream) {
  int plan[5];
  if (dfd_attn4d_long_plan(B, N, heads, d, dv, sms, plan) != 0) return cudaErrorInvalidValue;
  const auto kernel = heads == 8 && d == 32 && dv == 128 ? attn4d_long_kernel<8, 2, 16>
                                                         : attn4d_long_kernel<0, 0, 0>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan[4]);
  if (e != cudaSuccess) return e;
  kernel<<<plan[0], plan[1], plan[4], static_cast<cudaStream_t>(stream)>>>(
      Src{static_cast<const __nv_bfloat16*>(q), q_sb, q_sr},
      Src{static_cast<const __nv_bfloat16*>(k), k_sb, k_sr},
      Src{static_cast<const __nv_bfloat16*>(v), v_sb, v_sr}, static_cast<const float*>(bias),
      static_cast<const float*>(th1), static_cast<const float*>(th1_b),
      static_cast<const float*>(th2), static_cast<const float*>(th2_b),
      static_cast<__nv_bfloat16*>(out), B, N, heads, d, dv, scale, plan[2], plan[3], vec);
  return static_cast<int>(cudaGetLastError());
}

#ifdef DFD_K7_CLOCKS
// Copies the cycle counters into out[kLaps] and zeroes them.
extern "C" int dfd_attn4d_long_clocks(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, dfd_k7_clocks, sizeof(dfd_k7_clocks));
  const unsigned long long zero[kLaps] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(dfd_k7_clocks, zero, sizeof(zero));
  return static_cast<int>(e);
}
#endif
