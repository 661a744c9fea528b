// K6 forward: FasterViT's whole attention sub-block, the qkv projection,
// multi-head attention with a per-head bias, and the output projection.
//
// Replaces: deepfakedetection_tpu/ops/pallas/attn_block.py, _fwd_call
//   (:167, kernel _fwd_kernel :51), the forward of the attn_subblock
//   custom_vjp that FasterViT's TokenAttention takes under DFD_FUSED_ATTN.
// Contract: x [B, N, C] bf16 (contiguous); wqkv the qkv Linear's weight cast
//   to bf16 and laid out [3, heads, Dp, Cp] (rows = output features, zero
//   rows past d and columns past C; with d % 16 == 0 and C % 16 == 0 that is
//   the Linear's own [3C, C]); bqkv f32 [3, heads, Dp], zero past d; bias
//   [heads, N, N] f32; wproj bf16 [Cp, Cp] (the proj Linear's [C, C], zero
//   padded); bproj f32 [C]; out [B, N, C] bf16; ctx a bf16 scratch of
//   [B N, Cp]. wqkv, wproj and ctx 16-byte aligned. Per window, as
//   _fwd_kernel:
//     qkv = bf16(x . Wqkv^T accumulated in f32 + bqkv)
//     per head h: p = softmax(f32(q_h . k_h^T) * scale + bias[h]), rounded
//                 to bf16; ctx_h = bf16(p . v_h, f32 sums)
//     out = bf16(ctx . Wproj^T accumulated in f32 + bproj)
//   N <= 128, d = C / heads <= 128, and the plan below within a block's
//   227 KB. No padding of x: a window's q, k and v rows past N are zero in
//   shared memory and never stored, key columns past N are -inf before the
//   softmax (the TPU pads rows to 16 and puts -1e9 on the padded keys).
// Bound on the H100: tensor-core operations at the FasterViT-2 shapes. A
//   window reads x and writes out (4 N C bytes) for 2 N C (3C + C) + 4 N N C
//   flops: ~4,300 flops per byte at C 384, far above the ~295 flop/byte bf16
//   line. What a block must not do is read the weights for a few rows only:
//   all of Wqkv and Wproj from L2 for each window would be ~18 GB per
//   FasterViT-2 forward at batch 256, and bound the kernel.
//
// Design (two kernels, one launch of the C entry point):
//  1. attn_qkv_kernel: qkv and attention, ctx out. Blocks of two consumer
//     warpgroups and a producer warp, in clusters of 2. A block takes G whole
//     windows; their G N token rows, packed, are the M rows of the qkv
//     product (G N <= 128): warpgroup w takes rows [64 w, 64 w + 64), or,
//     where G N <= 64, both take all rows and two different weight units.
//     x is staged once (16-byte loads where C % 8 == 0, else 2-byte loads)
//     in the 128-byte-swizzled K-major layout wgmma reads from shared memory,
//     and stays for every head. The weights stream through a ring of 2-8
//     stages, each KB (1 or 2) 64-column tiles of NT weight rows a unit (NT
//     32 to 192: at head_dim 48 a unit is one head's q, k and v, 144 rows,
//     the group's columns taken part-major), with a full and an empty
//     mbarrier a stage: the producer warp loads each tile with TMA in 16-row
//     granules, each block of the cluster 8 rows of every granule multicast
//     to both, so each tile read from L2 serves both blocks' rows (table:
//     wgmma rows and token rows a read), and runs ahead across heads while
//     the consumers attend. The consumers run wgmma m64nNTk16 (A and B from
//     shared memory), keep the stage's products in flight while the next
//     stage's are issued, and release each stage to both blocks. Heads go in
//     groups of HG: the epilogue adds the group's qkv bias (staged by
//     cp.async) in f32 and rounds q, k and v once into shared memory; then
//     the 8 consumer warps split the group's attention over (window, head,
//     16-row query tile) items, K5's mma.sync arithmetic (head_probs,
//     probs_times_v) with FasterViT's tile counts as compile-time constants,
//     reading the group's bias tables from shared memory where the plan
//     staged them (cp.async during the group's products), else from L2. ctx
//     goes to the ctx scratch, rounded once.
//  2. out = ctx . Wproj^T + bproj: gemm_tma.cuh's gemm_kernel (128 x 128
//     output tiles, two blocks a SM, ctx and Wproj tiles by TMA through a
//     3-stage ring, wgmma m64n128k16 with both operands K-major in shared
//     memory), with the bias add and one rounding as its epilogue.
//  ctx leaves the chip because it does not fit beside what kernel 1 keeps:
//  at FasterViT-2's stage 3 (two windows, C 384) x takes 88 KB and a head's
//  q, k and v 43 KB (official) or 104 KB (tpu); ctx would add 81 KB (106
//  rows x 384 bf16): 212 and 273 KB before the ring and the biases, over the
//  227 KB a block has. Written once and read once, it is 4 B N C bytes.
// Plan (fwd_plan below; ops/attn_block.py fwd_plan mirrors it): G the most
//   windows whose rows fit 128, but no more than a cluster needs for 128
//   rows at a 16-row stride a window (4 at N 16, 1 at N 49-64) or the card
//   for about two blocks a SM (2 at stage 3); then the first that fits
//   227 KB with a ring of four stages, else three, else two: NT the widest
//   of 192, 144, 128, 64, 48 dividing the group's 3 HG Dp columns (32 last),
//   HG from the least that gives each consumer warp an attention item down
//   to 1, bias tables staged, else not, KB 2, else 1, and the most stages up
//   to 8. FasterViT-2, batch 256:
//     shape (N, C, heads)      G  HG  NT  KB stages staged rows/read (real) shared memory
//     official (53, 384, 8)     2   1 144  1    4      1    256 (212)  217,712
//     official (16, 384, 8)     4   2  48  2    5      1    128 (128)  219,344
//     official (49, 768, 16)    1   2  48  1    6      1    128 ( 98)  225,264
//     tpu (53, 384, 3)          2   1  64  1    4      0    256 (212)  227,904
//     tpu (16, 384, 3)          4   2  64  1    4      1    128 (128)  225,344
//     tpu (49, 768, 6)          1   1  64  1    4      1    128 ( 98)  217,040
// Deterministic: no atomics, every sum in a fixed order.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <numeric>

#include "attn_block_common.cuh"
#include "gemm_tma.cuh"
#include "hopper.cuh"

namespace {

// G windows of N tokens, q, k and v at a 16-row stride a window (G Np); ring
// stages of KB 64-column tiles of NT weight rows a slot; the bias tables
// staged or not.
__host__ __device__ constexpr int fwd_smem_bytes(int N, int Cp, int Dp, int G, int HG, int NT,
                                                 int KB, int stages, int staged) {
  // alignment slack, the ring, x, one head group's q, k, v and biases, the
  // ring's full and empty barriers
  return kAlign + stages * KB * stage_slots(G * N) * NT * kRowBytes + x_smem_bytes(G * N, Cp) +
         HG * 3 * G * pad16(N) * (Dp + 8) * 2 + bias_smem_bytes(N, Dp, HG, staged) +
         2 * stages * 8;
}

struct FwdPlan {
  int G, HG, NT, KB, stages, staged, smem;  // G == 0: the shape does not fit
};

FwdPlan fwd_plan(int B, int N, int C, int heads) {
  const int Cp = pad16(C), Dp = pad16(C / heads), kt = pad16(N) / 16;
  int G = kMaxRows / N;
  // a cluster's blocks hold 128 rows at a 16-row stride a window, or about
  // two blocks a SM
  const int fill = cdiv(64, pad16(N));
  const int want = fill > cdiv(B, 2 * kSms) ? fill : cdiv(B, 2 * kSms);
  if (want < G) G = want;
  if (B < G) G = B;
  for (; G >= 1; --G) {
    const int target = cdiv(8, G * kt) < heads ? cdiv(8, G * kt) : heads;
    for (int need = 4; need >= 2; --need) {
      for (int NT : kUnits) {
        for (int HG = target; HG >= 1; --HG) {
          const int units = 3 * HG * Dp / NT;  // NT 32 may waste, as the last resort
          if (NT != 32 && (units * NT != 3 * HG * Dp || (stage_slots(G * N) == 2 && units % 2)))
            continue;  // whole units, and an even count where a stage holds two
          for (int staged = 1; staged >= 0; --staged) {
            for (int KB = kMaxKB; KB >= 1; --KB) {  // two tiles a stage only with 4 stages or more
              const int least = KB == 2 && need < 4 ? 4 : need;
              for (int stages = kMaxStages; stages >= least; --stages) {
                const int smem = fwd_smem_bytes(N, Cp, Dp, G, HG, NT, KB, stages, staged);
                if (smem <= kMaxSmemBytes) return {G, HG, NT, KB, stages, staged, smem};
              }
            }
          }
        }
      }
    }
  }
  return {0, 0, 0, 0, 0, 0, 0};
}

// One warp's attention item, rows [16 mt, 16 mt + 16) of one window and head:
// K5's head_probs and probs_times_v. With EXACT the tile counts are the
// template's (KT = kt, DT = dt), so that their loops unroll without a branch
// an iteration; else KT and DT bound the actual counts.
template <int KT, int DT, bool EXACT>
__device__ __forceinline__ void attend(const __nv_bfloat16* qs, int Mq, int ld, int mt, int kt,
                                       int dt, const float* bias_h, int N, float scale,
                                       __nv_bfloat16* out, long long sr, int d, bool pair) {
  float s[2 * KT][4];
  head_probs<KT, DT>(s, qs, qs + Mq * ld, ld, mt, EXACT ? KT : kt, EXACT ? DT : dt, bias_h, N,
                     scale);
  probs_times_v<KT, DT>(s, qs + 2 * Mq * ld, ld, mt, EXACT ? KT : kt, EXACT ? DT : dt, out, sr, N,
                        d, pair);
}

// NT is the unit of weight rows a wgmma takes; KT bounds the 16-token tiles
// (N <= 16 KT), for the attention's register arrays (head_dim <= 128).
template <int NT, int KT>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    attn_qkv_kernel(const __grid_constant__ CUtensorMap wmap, const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ bqkv, const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ ctx, int B, int N, int C, int heads, float scale,
                    int G, int HG, int KB, int stages, int staged, int gran, int vec) {
  constexpr int DT = 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = aligned_smem(smem_raw);
  const int d = C / heads, Np = pad16(N), Cp = pad16(C), Dp = pad16(d);
  const int kt = Np / 16, dt = Dp / 16, Mx = G * N, Mq = G * Np, slots = stage_slots(Mx);
  const int tile_bytes = slots * NT * kRowBytes, stage_bytes = KB * tile_bytes;
  const int ld = Dp + 8, groups = cdiv(heads, HG);
  const int nkb = cdiv(Cp, kKTile), ksteps = Cp / 16, nsteps = cdiv(nkb, KB);
  const int Mr = pad8(Mx), x_block = Mr * kRowBytes;  // one 64-column block of x
  unsigned char* xs = ring + stages * stage_bytes;
  __nv_bfloat16* qkv = reinterpret_cast<__nv_bfloat16*>(xs + x_smem_bytes(Mx, Cp));
  float* bq_s = reinterpret_cast<float*>(qkv + HG * 3 * Mq * ld);  // the group's bqkv
  float* bias_s = bq_s + cdiv(3 * HG * Dp, 4) * 4;                  // its bias tables
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(bq_s) +
                                               bias_smem_bytes(N, Dp, HG, staged));
  uint64_t* empty = full + stages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long win0 = static_cast<long long>(blockIdx.x) * G;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kCluster * kConsumers / 32);
    }
    mbar_init_fence();
  }
  cluster_sync();

  if (warp == kConsumers / 32) {  // the producer
    if (lane == 0) {
      tma_prefetch_map(&wmap);
      const int rank = static_cast<int>(cluster_rank());
      int s = 0;
      uint32_t phase = 0;
      for (int grp = 0; grp < groups; ++grp) {
        const int h0 = grp * HG, hn = min(HG, heads - h0), units = cdiv(3 * hn * Dp, NT);
        for (int u = 0; u < cdiv(units, slots); ++u) {
          for (int step = 0; step < nsteps; ++step) {
            const int kb0 = step * KB, nb = min(KB, nkb - kb0);
            mbar_wait(&empty[s], phase ^ 1);
            mbar_arrive_expect_tx(&full[s], nb * tile_bytes);
            for (int q = 0; q < nb; ++q) {
              for (int w = 0; w < slots; ++w) {
                const int unit = min(u * slots + w, units - 1);  // a missing unit repeats the last
                // granules of gran rows, which never straddle two parts: this
                // block loads the first or second half of each, for both blocks
                for (int g0 = 0; g0 < NT; g0 += gran) {
                  const int row = group_row(unit * NT + g0, hn, heads, h0, Dp);
                  const int half = gran / kCluster * rank;
                  tma_load_multicast(ring + s * stage_bytes + q * tile_bytes +
                                         (w * NT + g0 + half) * kRowBytes,
                                     &wmap, &full[s], (kb0 + q) * kKTile, row + half,
                                     (1 << kCluster) - 1);
                }
              }
            }
            if (++s == stages) s = 0, phase ^= 1;
          }
        }
      }
    }
    __syncwarp();
  } else {  // the consumers: two warpgroups
    const int wg = warp / 4, g = lane >> 2, t4 = lane & 3;
    // x: the block's windows' rows, packed (row r = token r % N of window
    // r / N), zero past C and past the last window; q, k, v zeroed once, so
    // the rows past N of each window stay zero
    const long long x0 = win0 * N, x_end = static_cast<long long>(B) * N;
    // (16-byte chunk ch of row r of a block at r * 128 + ((ch ^ r % 8) * 16))
    const int cols = nkb * kKTile;
    if (vec) {  // C % 8 == 0, 16-byte aligned x
      for (int i = threadIdx.x; i < Mr * cols / 8; i += kConsumers) {
        const int row = i / (cols / 8), ch = i % (cols / 8);
        uint4 v = make_uint4(0, 0, 0, 0);
        if (row < Mx && x0 + row < x_end && ch * 8 < C)
          v = *reinterpret_cast<const uint4*>(x + (x0 + row) * C + ch * 8);
        *reinterpret_cast<uint4*>(xs + ch / 8 * x_block + row * kRowBytes +
                                  ((ch % 8 ^ row % 8) << 4)) = v;
      }
    } else {
      for (int i = threadIdx.x; i < Mr * cols; i += kConsumers) {
        const int row = i / cols, col = i % cols;
        __nv_bfloat16 v = __float2bfloat16(0.0f);
        if (row < Mx && x0 + row < x_end && col < C) v = x[(x0 + row) * C + col];
        *reinterpret_cast<__nv_bfloat16*>(xs + col / kKTile * x_block + row * kRowBytes +
                                          ((col % kKTile / 8 ^ row % 8) << 4) + col % 8 * 2) = v;
      }
    }
    for (int i = threadIdx.x; i < HG * 3 * Mq * ld / 8; i += kConsumers)
      reinterpret_cast<uint4*>(qkv)[i] = make_uint4(0, 0, 0, 0);
    named_sync(1, kConsumers);

    const int m0 = slots == 1 ? 64 * wg : 0, slot = slots == 1 ? 0 : wg;
    const int r0 = m0 + 16 * (warp % 4);  // this warp's 16 rows of the product
    const bool pair = d % 2 == 0;  // 4-byte stores of ctx column pairs
    // a ring stage's release: each warp, once its reads are done, to the
    // stage's empty barrier in both blocks of the cluster
    const auto release = [&](int stage) {
      __syncwarp();
      if (lane == 0)
        for (int r = 0; r < kCluster; ++r) mbar_arrive_cluster(&empty[stage], r);
    };
    // the token rows of this thread's two accumulator rows in q, k and v
    const int ra = r0 + g, rb = ra + 8;
    const int qa = ra / N * Np + ra % N, qb = rb / N * Np + rb % N;
    float acc[NT / 2];
    int s = 0;
    uint32_t phase = 0;
    for (int grp = 0; grp < groups; ++grp) {
      const int h0 = grp * HG, hn = min(HG, heads - h0), units = cdiv(3 * hn * Dp, NT);
      const int gcols = 3 * hn * Dp;
      // the group's qkv bias (part-major, as its product columns) and, where
      // the plan has room, its bias tables into shared memory, while the
      // products run
      for (int i = threadIdx.x; i < gcols; i += kConsumers)
        cp_async4(bq_s + i, bqkv + group_row(i, hn, heads, h0, Dp));
      cp_async_commit();
      const float* bias_g = bias + static_cast<long long>(h0) * N * N;
      if (staged)
        for (int i = threadIdx.x; i < hn * N * N; i += kConsumers)
          cp_async4(bias_s + i, bias_g + i);
      cp_async_commit();
      for (int u = 0; u < cdiv(units, slots); ++u) {
        const int unit = u * slots + slot;
        const bool live = unit < units;
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) acc[j] = 0.0f;
        // the stages whose products may still be running, older first: two
        // groups of products stay in flight where the ring has three stages
        int held0 = -1, held1 = -1;
        for (int step = 0; step < nsteps; ++step) {
          const int kb0 = step * KB;
          mbar_wait(&full[s], phase);
          if (live) {
            wgmma_fence();
#pragma unroll
            for (int q = 0; q < kMaxKB; ++q) {
              if (q >= KB || kb0 + q >= nkb) break;
              // this warpgroup's 64 rows of x and the stage's tile, 64 columns
              const uint64_t da = wgmma_desc(xs + (kb0 + q) * x_block + m0 * kRowBytes);
              const uint64_t db =
                  wgmma_desc(ring + s * stage_bytes + q * tile_bytes + slot * NT * kRowBytes);
#pragma unroll
              for (int ks = 0; ks < kKTile / 16; ++ks) {
                if ((kb0 + q) * (kKTile / 16) + ks >= ksteps) break;
                wgmma_ss<NT>(acc, da + 2 * ks, db + 2 * ks);
              }
            }
            wgmma_commit();
            if (stages < 3 && held1 >= 0) {  // the previous stage's products are done
              wgmma_wait<1>();
              release(held1);
              held1 = -1;
            } else if (held0 >= 0) {  // the products two stages back are done
              wgmma_wait<2>();
              release(held0);
              held0 = -1;
            }
            if (held1 >= 0) held0 = held1;
            held1 = s;
          } else {
            release(s);
          }
          if (++s == stages) s = 0, phase ^= 1;
        }
        if (u == 0) {  // the group's qkv bias has landed, every thread's part
          cp_async_wait<1>();
          named_sync(1, kConsumers);
        }
        if (!live) continue;
        wgmma_wait<0>();
        if (held0 >= 0) release(held0);
        release(held1);
        // epilogue: + bqkv in f32, one rounding, into the group's q, k or v;
        // column col of the group is part `part`, head hh, feature dc, each
        // stepped by 8 a tile
        int col = unit * NT + 2 * t4, part = col / (hn * Dp), hh = col % (hn * Dp) / Dp;
        int dc = col % Dp;
#pragma unroll
        for (int j = 0; j < NT / 8; ++j, col += 8, dc += 8) {
          if (dc >= Dp) dc -= Dp, ++hh;
          if (hh == hn) hh = 0, ++part;
          if (col >= gcols) continue;
          __nv_bfloat16* dst = qkv + (hh * 3 + part) * Mq * ld + dc;
          const float b0 = bq_s[col], b1 = bq_s[col + 1];
          if (ra < Mx)
            *reinterpret_cast<uint32_t*>(dst + qa * ld) =
                pack_bf16(__fadd_rn(acc[4 * j], b0), __fadd_rn(acc[4 * j + 1], b1));
          if (rb < Mx)
            *reinterpret_cast<uint32_t*>(dst + qb * ld) =
                pack_bf16(__fadd_rn(acc[4 * j + 2], b0), __fadd_rn(acc[4 * j + 3], b1));
        }
      }
      cp_async_wait<0>();
      named_sync(1, kConsumers);  // the group's q, k, v and bias tables are complete
      const int items = G * hn * kt;
      for (int i = warp; i < items; i += kConsumers / 32) {
        const int gw = i / (hn * kt), hh = i / kt % hn, mt = i % kt;
        const long long b = win0 + gw;
        if (b >= B) continue;
        const __nv_bfloat16* qs = qkv + (hh * 3 * Mq + gw * Np) * ld;
        const float* bias_h = (staged ? bias_s : bias_g) + hh * N * N;
        __nv_bfloat16* out = ctx + b * N * Cp + (h0 + hh) * d;
        // FasterViT's tile counts (N 49-64 or 16, head_dim 48 or 128) exact
        if (KT == 4 && kt == 4 && dt == 3)
          attend<4, 3, true>(qs, Mq, ld, mt, kt, dt, bias_h, N, scale, out, Cp, d, pair);
        else if (KT == 4 && kt == 4 && dt == 8)
          attend<4, 8, true>(qs, Mq, ld, mt, kt, dt, bias_h, N, scale, out, Cp, d, pair);
        else if (kt == 1 && dt == 3)
          attend<1, 3, true>(qs, Mq, ld, mt, kt, dt, bias_h, N, scale, out, Cp, d, pair);
        else if (kt == 1 && dt == 8)
          attend<1, 8, true>(qs, Mq, ld, mt, kt, dt, bias_h, N, scale, out, Cp, d, pair);
        else
          attend<KT, DT, false>(qs, Mq, ld, mt, kt, dt, bias_h, N, scale, out, Cp, d, pair);
      }
      named_sync(1, kConsumers);  // the group's q, k, v and biases are free
    }
  }
  cluster_sync();  // no block leaves while its peer may still write to it
}

template <int NT, int KT>
cudaError_t launch_qkv(const CUtensorMap& wmap, const __nv_bfloat16* x, const float* bqkv,
                       const float* bias, __nv_bfloat16* ctx, int B, int N, int C, int heads,
                       float scale, const FwdPlan& p, int vec, cudaStream_t stream) {
  // each instance may take the 227 KB a block has: set once a device
  static unsigned sized = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && !(sized >> dev & 1u)) {
    e = cudaFuncSetAttribute(attn_qkv_kernel<NT, KT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
    if (e == cudaSuccess) sized |= 1u << dev;
  }
  if (e != cudaSuccess) return e;
  const int blocks = cdiv(cdiv(B, p.G), kCluster) * kCluster;
  attn_qkv_kernel<NT, KT><<<blocks, kThreads, p.smem, stream>>>(
      wmap, x, bqkv, bias, ctx, B, N, C, heads, scale, p.G, p.HG, p.KB, p.stages, p.staged,
      granule(p.NT, pad16(C / heads)), vec);
  return cudaGetLastError();
}

template <int KT>
cudaError_t launch_qkv(const CUtensorMap& wmap, const __nv_bfloat16* x, const float* bqkv,
                       const float* bias, __nv_bfloat16* ctx, int B, int N, int C, int heads,
                       float scale, const FwdPlan& p, int vec, cudaStream_t stream) {
#define DFD_LAUNCH(n)                                                                    \
  if (p.NT == n)                                                                         \
    return launch_qkv<n, KT>(wmap, x, bqkv, bias, ctx, B, N, C, heads, scale, p, vec, stream);
  DFD_LAUNCH(192)
  DFD_LAUNCH(144)
  DFD_LAUNCH(128)
  DFD_LAUNCH(64)
  DFD_LAUNCH(48)
  DFD_LAUNCH(32)
#undef DFD_LAUNCH
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The projection's epilogue: + bproj in f32, one rounding, out [M, C].
struct ProjEpi {
  const float* __restrict__ bproj;
  __nv_bfloat16* __restrict__ out;
  int M, C, pair;
  __device__ __forceinline__ void operator()(int, int row, int c, float v0, float v1) const {
    if (c >= C || row >= M) return;
    const float b0 = bproj[c], b1 = c + 1 < C ? bproj[c + 1] : 0.0f;
    const float lo = __fadd_rn(v0, b0), hi = __fadd_rn(v1, b1);
    __nv_bfloat16* dst = out + static_cast<long long>(row) * C + c;
    if (pair) {
      *reinterpret_cast<uint32_t*>(dst) = pack_bf16(lo, hi);
    } else {
      dst[0] = __float2bfloat16_rn(lo);
      if (c + 1 < C) dst[1] = __float2bfloat16_rn(hi);
    }
  }
  __device__ void rowsum(int, int, int, float) const {}
};

}  // namespace

// The forward's launch plan for a shape: {windows a block, heads a group,
// weight rows a chunk, 64-column tiles a ring stage, ring stages, bias tables
// staged, shared memory bytes, blocks}; all zero when the shape does not fit.
// Returns 0, or cudaErrorInvalidValue for a shape the kernel refuses.
extern "C" int dfd_attn_subblock_plan(int B, int N, int C, int heads, int* plan) {
  for (int i = 0; i < 8; ++i) plan[i] = 0;
  if (B < 1 || N < 1 || N > 128 || heads < 1 || C < heads || C % heads || C / heads > 128)
    return cudaErrorInvalidValue;
  const FwdPlan p = fwd_plan(B, N, C, heads);
  if (p.G == 0) return cudaErrorInvalidValue;
  const int out[8] = {p.G,      p.HG,     p.NT,   p.KB, p.stages,
                      p.staged, p.smem,  cdiv(cdiv(B, p.G), kCluster) * kCluster};
  for (int i = 0; i < 8; ++i) plan[i] = out[i];
  return 0;
}

// Returns a cudaError_t: 0 on success. vec = 1 promises C % 8 == 0 and a
// 16-byte aligned x, for 16-byte loads of its rows; out is stored in 4-byte
// pairs when C is even.
extern "C" int dfd_attn_subblock(const void* x, const void* wqkv, const void* bqkv,
                                 const void* bias, const void* wproj, const void* bproj, void* out,
                                 void* ctx, int B, int N, int C, int heads, float scale, int vec,
                                 void* stream) {
  int plan[8];
  if (dfd_attn_subblock_plan(B, N, C, heads, plan) != 0) return cudaErrorInvalidValue;
  if (!aligned16(wqkv) || !aligned16(wproj) || !aligned16(ctx)) return cudaErrorMisalignedAddress;
  const FwdPlan p = {plan[0], plan[1], plan[2], plan[3], plan[4], plan[5], plan[6]};
  const int Cp = pad16(C), Dp = pad16(C / heads);
  CUtensorMap wmap, amap, pmap;
  cudaError_t e =
      tensor_map(&wmap, wqkv, Cp, 3LL * heads * Dp, Cp * 2, kKTile, granule(p.NT, Dp) / kCluster);
  if (e == cudaSuccess)
    e = operand_map(&amap, ctx, C, static_cast<long long>(B) * N, Cp, false);
  if (e == cudaSuccess) e = operand_map(&pmap, wproj, Cp, Cp, Cp, false);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* bq = static_cast<const float*>(bqkv);
  const auto* bs = static_cast<const float*>(bias);
  auto* cp = static_cast<__nv_bfloat16*>(ctx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = N <= 64 ? launch_qkv<4>(wmap, xp, bq, bs, cp, B, N, C, heads, scale, p, vec, st)
             : launch_qkv<8>(wmap, xp, bq, bs, cp, B, N, C, heads, scale, p, vec, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int M = B * N;
  const GemmProblem proj = {cdiv(M, kGemmTile), cdiv(C, kGemmTile), C, C};
  return static_cast<int>(launch_gemm<false, false, false>(
      amap, pmap, amap, pmap, proj, GemmProblem{}, 1,
      ProjEpi{static_cast<const float*>(bproj), static_cast<__nv_bfloat16*>(out), M, C,
              C % 2 == 0},
      st));
}
