// K6 backward's window kernel (attn_block_bwd.cu's kernel 2, its design in
// that file's header): its shared memory, the attention backward's items and
// the kernel. Its instances for the six wgmma widths are compiled in
// attn_block_bwd_w*.cu, two widths a file, so that the build's parallel nvcc
// processes share the work; attn_block_bwd.cu launches them through
// k6_bwd::launch_window.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attn_block_common.cuh"
#include "gemm_tma.cuh"
#include "hopper.cuh"

namespace k6_bwd {

// A launch plan (bwd_plan in attn_block_bwd.cu); G == 0: the shape does not fit.
struct Plan {
  int G, HG, NT, stages, staged, smem;
};

// The window kernel's operands (attn_block_bwd.cu's contract).
struct Window {
  const __nv_bfloat16* x;
  int ldx;
  const float *bqkv, *bias;
  const __nv_bfloat16* dctx;
  __nv_bfloat16 *ctx, *dqkv;
  float* dbias_part;
  int B, N, C, heads;
  float scale;
};

// Launches the window kernel of the plan's width NT on `stream`.
template <int NT>
cudaError_t launch_window(const CUtensorMap& wmap, const Window& w, const Plan& p,
                          cudaStream_t stream);

}  // namespace k6_bwd

namespace {

// The window kernel's threads: two consumer warpgroups and a producer
// warpgroup (one warp of it loads), so that setmaxnreg can move registers
// from the producer to the consumers: 8 x 232 + 4 x 40 warps' registers fill
// the SM's 64K, where 9 warps of one count each could have 168.
constexpr int kWindowThreads = kConsumers + 128;
constexpr int kConsumerRegs = 232, kProducerRegs = 40;

// What the ring's and x's shared memory holds after the products: bf16 p and
// ds of each (window, head) (Np rows of Np + 8), the group's dctx columns (G
// Np rows of Dp + 8 a head) and, when staged, its f32 bias tables.
__host__ __device__ constexpr int bwd_after_bytes(int N, int Dp, int G, int HG, int staged) {
  return G * HG * 2 * pad16(N) * (pad16(N) + 8) * 2 + HG * G * pad16(N) * (Dp + 8) * 2 +
         (staged ? cdiv(HG * N * N, 4) * 16 : 0);
}

// The ring (one 64-column tile of each slot's NT weight rows a stage) and
// x, or what replaces them after the products: the larger.
__host__ __device__ constexpr int bwd_region_bytes(int N, int Cp, int Dp, int G, int HG, int NT,
                                                   int stages, int staged) {
  return stages * stage_slots(G * N) * NT * kRowBytes + x_smem_bytes(G * N, Cp) >
                 bwd_after_bytes(N, Dp, G, HG, staged)
             ? stages * stage_slots(G * N) * NT * kRowBytes + x_smem_bytes(G * N, Cp)
             : bwd_after_bytes(N, Dp, G, HG, staged);
}

// Alignment slack, that region, the group's q, k and v (G Np rows of Dp + 8
// a head and part), its f32 qkv bias and the ring's full and empty barriers.
__host__ __device__ constexpr int bwd_smem_bytes(int N, int Cp, int Dp, int G, int HG, int NT,
                                                 int stages, int staged) {
  return kAlign + bwd_region_bytes(N, Cp, Dp, G, HG, NT, stages, staged) +
         HG * 3 * G * pad16(N) * (Dp + 8) * 2 + cdiv(3 * HG * Dp, 4) * 16 + 2 * stages * 8;
}

// One warp's row-pass item, query rows [16 mt, 16 mt + 16) of one window and
// head: p (head_probs), ctx = bf16(p) v (probs_times_v, stored at cx), then
// K5's row pass (head_bwd_rows): dq stored at dq, bf16 p and ds into ps and
// gs, each f32 ds element into the window's dbias partial (part).
struct RowItem {
  const __nv_bfloat16 *qs, *dos;  // q (k and v Mq ld after it), dctx
  __nv_bfloat16 *ps, *gs, *cx, *dq;
  const float* bias_h;
  float* part;
  int Mq, ld, ldp, mt, kt, dt, N, d;
  long long cx_sr, dq_sr;
  float scale;
  bool pair;
  // With EXACT the tile counts are the template's (KT = kt, DT = dt), so that
  // the loops unroll without a branch an iteration; else KT and DT bound them.
  template <int KT, int DT, bool EXACT>
  __device__ __forceinline__ void run() const {
    const int k = EXACT ? KT : kt, t = EXACT ? DT : dt;
    const __nv_bfloat16 *ks = qs + Mq * ld, *vs = qs + 2 * Mq * ld;
    float* const pt = part;
    const int n = N;
    float p[2 * KT][4];
    head_probs<KT, DT>(p, qs, ks, ld, mt, k, t, bias_h, N, scale);
    probs_times_v<KT, DT>(p, vs, ld, mt, k, t, cx, cx_sr, N, d, pair);
    head_bwd_rows<KT, DT>(p, dos, vs, ks, ld, ps, gs, ldp, mt, k, t, N, d, scale, dq, dq_sr, pair,
                          [pt, n](int r, int c, float v) {
                            if (r < n && c < n) pt[r * n + c] = v;
                          });
  }
};

// One warp's column-pass item: 16 key rows from j0 of dv = bf16(p)^T do
// (lhs ps, rhs dctx) or dk = bf16(ds)^T q * scale (lhs gs, rhs q).
struct ColItem {
  const __nv_bfloat16 *lhs, *rhs;
  __nv_bfloat16* out;
  int ldp, ld, j0, kt, dt, N, d;
  long long sr;
  float mult;
  bool pair;
  template <int KT, int DT, bool EXACT>
  __device__ __forceinline__ void run() const {
    head_bwd_cols<KT, DT>(lhs, ldp, rhs, ld, j0, EXACT ? KT : kt, EXACT ? DT : dt, out, sr, N, d,
                          mult, pair);
  }
};

// item.run<KT, DT, EXACT>() with FasterViT's tile counts (N 49-64 or 16,
// head_dim 48 or 128) exact, else with bounds.
template <int KT, class Item>
__device__ __forceinline__ void dispatch_tiles(int kt, int dt, const Item& item) {
  if constexpr (KT == 4) {
    if (kt == 4 && dt == 3) return item.template run<4, 3, true>();
    if (kt == 4 && dt == 8) return item.template run<4, 8, true>();
    if (kt == 1 && dt == 3) return item.template run<1, 3, true>();
    if (kt == 1 && dt == 8) return item.template run<1, 8, true>();
  }
  item.template run<KT, 8, false>();
}

// NT is the unit of weight rows a wgmma takes; KT bounds the 16-token tiles
// (N <= 16 KT), for the attention's register arrays (head_dim <= 128).
template <int NT, int KT>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kWindowThreads, 1)
    window_bwd_kernel(const __grid_constant__ CUtensorMap wmap, const __nv_bfloat16* __restrict__ x,
                      int ldx, const float* __restrict__ bqkv, const float* __restrict__ bias,
                      const __nv_bfloat16* __restrict__ dctx, __nv_bfloat16* __restrict__ ctx,
                      __nv_bfloat16* __restrict__ dqkv, float* __restrict__ dbias_part, int B,
                      int N, int C, int heads, float scale, int G, int HG, int stages,
                      int staged, int gran) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = aligned_smem(smem_raw);
  const int d = C / heads, Np = pad16(N), Cp = pad16(C), Dp = pad16(d);
  const int kt = Np / 16, dt = Dp / 16, Mx = G * N, Mq = G * Np, slots = stage_slots(Mx);
  const int stage_bytes = slots * NT * kRowBytes;  // one 64-column tile of each slot's rows
  const int ld = Dp + 8, ldp = Np + 8;
  const int nkb = cdiv(Cp, kKTile);
  const int Mr = pad8(Mx), x_block = Mr * kRowBytes;  // one 64-column block of x
  const int h0 = blockIdx.y * HG, hn = min(HG, heads - h0);
  const int units = cdiv(3 * hn * Dp, NT), gcols = 3 * hn * Dp;
  unsigned char* xs = ring + stages * stage_bytes;
  // after the products, in the ring's and x's place
  __nv_bfloat16* pds = reinterpret_cast<__nv_bfloat16*>(ring);  // [G][HG][p, ds][Np][ldp]
  __nv_bfloat16* dos = pds + G * HG * 2 * Np * ldp;               // [HG][G Np][ld]
  float* bias_s = reinterpret_cast<float*>(dos + HG * Mq * ld);   // [HG][N][N]
  __nv_bfloat16* qkv = reinterpret_cast<__nv_bfloat16*>(
      ring + bwd_region_bytes(N, Cp, Dp, G, HG, NT, stages, staged));  // [HG][q, k, v][G Np][ld]
  float* bq_s = reinterpret_cast<float*>(qkv + HG * 3 * Mq * ld);         // the group's bqkv
  uint64_t* full = reinterpret_cast<uint64_t*>(bq_s + cdiv(3 * HG * Dp, 4) * 4);
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

  if (warp >= kConsumers / 32) {  // the producer warpgroup: the group's Wqkv rows, once
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumers / 32 && lane == 0) {
      tma_prefetch_map(&wmap);
      const int rank = static_cast<int>(cluster_rank());
      int s = 0;
      uint32_t phase = 0;
      for (int u = 0; u < cdiv(units, slots); ++u) {
        for (int kb = 0; kb < nkb; ++kb) {
          mbar_wait(&empty[s], phase ^ 1);
          mbar_arrive_expect_tx(&full[s], stage_bytes);
          for (int w = 0; w < slots; ++w) {
            const int unit = min(u * slots + w, units - 1);  // a missing unit repeats the last
            // granules of gran rows, which never straddle two parts: this
            // block loads the first or second half of each, for both blocks
            for (int g0 = 0; g0 < NT; g0 += gran) {
              const int row = group_row(unit * NT + g0, hn, heads, h0, Dp);
              const int half = gran / kCluster * rank;
              tma_load_multicast(ring + s * stage_bytes + (w * NT + g0 + half) * kRowBytes, &wmap,
                                 &full[s], kb * kKTile, row + half, (1 << kCluster) - 1);
            }
          }
          if (++s == stages) s = 0, phase ^= 1;
        }
      }
    }
    __syncwarp();
    cluster_sync();  // no block leaves while its peer may still write to it
    return;
  } else {  // the consumers: two warpgroups
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = warp / 4, g = lane >> 2, t4 = lane & 3;
    // x: the block's windows' rows, packed (row r = token r % N of window
    // r / N), zero past C and past the last window, by 16-byte cp.async (the
    // contract's row stride); q, k, v zeroed, so rows past N stay zero
    const long long x0 = win0 * N, x_end = static_cast<long long>(B) * N;
    const int cols = nkb * kKTile;
    for (int i = threadIdx.x; i < Mr * cols / 8; i += kConsumers) {
      const int row = i / (cols / 8), ch = i % (cols / 8);
      unsigned char* dst = xs + ch / 8 * x_block + row * kRowBytes + ((ch % 8 ^ row % 8) << 4);
      if (row < Mx && x0 + row < x_end && ch * 8 < C)
        cp_async16(dst, x + (x0 + row) * ldx + ch * 8);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    cp_async_commit();
    for (int i = threadIdx.x; i < HG * 3 * Mq * ld / 8; i += kConsumers)
      reinterpret_cast<uint4*>(qkv)[i] = make_uint4(0, 0, 0, 0);
    // the group's qkv bias (part-major, as its product columns), while the
    // products run
    for (int i = threadIdx.x; i < gcols; i += kConsumers)
      cp_async4(bq_s + i, bqkv + group_row(i, hn, heads, h0, Dp));
    cp_async_commit();
    cp_async_wait<1>();   // this thread's x has landed
    fence_proxy_async();  // for the wgmma, which read it through the async proxy
    named_sync(1, kConsumers);

    const int m0 = slots == 1 ? 64 * wg : 0, slot = slots == 1 ? 0 : wg;
    const int r0 = m0 + 16 * (warp % 4);  // this warp's 16 rows of the product
    const bool pair = d % 2 == 0;         // 4-byte stores of column pairs
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
    // No exit between wgmma instructions depends on the data (ptxas would
    // serialise them): every stage runs its four 16-deep steps (past Cp, x
    // is staged zero and the weights are TMA's zero fill), and a warpgroup
    // whose unit is missing (an odd count of units, two slots a stage)
    // multiplies the repeated last unit and drops the result.
    for (int u = 0; u < cdiv(units, slots); ++u) {
      const bool live = u * slots + slot < units;
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) acc[j] = 0.0f;
      // the stages whose products may still be running, older first: two
      // groups of products stay in flight where the ring has three stages
      int held0 = -1, held1 = -1;
      for (int kb = 0; kb < nkb; ++kb) {
        mbar_wait(&full[s], phase);
        wgmma_fence();
        // this warpgroup's 64 rows of x and the stage's tile, 64 columns
        const uint64_t da = wgmma_desc(xs + kb * x_block + m0 * kRowBytes);
        const uint64_t db = wgmma_desc(ring + s * stage_bytes + slot * NT * kRowBytes);
#pragma unroll
        for (int ks = 0; ks < kKTile / 16; ++ks) wgmma_ss<NT>(acc, da + 2 * ks, db + 2 * ks);
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
        if (++s == stages) s = 0, phase ^= 1;
      }
      if (u == 0) {  // the group's qkv bias has landed, every thread's part
        cp_async_wait<0>();
        named_sync(1, kConsumers);
      }
      wgmma_wait<0>();
      if (held0 >= 0) release(held0);
      release(held1);
      if (!live) continue;
      // epilogue: + bqkv in f32, one rounding, into the group's q, k or v;
      // column col of the group is part `part`, head hh, feature dc, each
      // stepped by 8 a tile
      int col = (u * slots + slot) * NT + 2 * t4, part = col / (hn * Dp), hh = col % (hn * Dp) / Dp;
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
    named_sync(1, kConsumers);  // every product is done: the ring and x are free

    // the group's dctx columns of the block's windows, zero past N and d
    // (16-byte cp.async where d % 8 == 0), and its bias tables where staged
    const bool vec = d % 8 == 0;
    const int chunks = Dp / 8;
    for (int i = threadIdx.x; i < hn * Mq * chunks; i += kConsumers) {
      const int c = i % chunks * 8, rr = i / chunks % Mq, hh = i / (chunks * Mq);
      const int gw = rr / Np, r = rr % Np;
      const long long b = win0 + gw;
      __nv_bfloat16* dst = dos + (hh * Mq + rr) * ld + c;
      if (b < B && r < N && c < d) {
        const __nv_bfloat16* src = dctx + (b * N + r) * Cp + (h0 + hh) * d + c;
        if (vec) {
          cp_async16(dst, src);
        } else {
          for (int e = 0; e < 8; ++e) dst[e] = c + e < d ? src[e] : __float2bfloat16(0.0f);
        }
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    }
    const float* bias_g = bias + static_cast<long long>(h0) * N * N;
    if (staged)
      for (int i = threadIdx.x; i < hn * N * N; i += kConsumers) cp_async4(bias_s + i, bias_g + i);
    cp_async_commit();
    cp_async_wait<0>();
    named_sync(1, kConsumers);

    // row pass: (window, head, 16-row query tile) items over the 8 warps
    const long long ldq = 3LL * heads * Dp;  // dqkv's row stride: [3, heads, Dp]
    const float* bias_t = staged ? bias_s : bias_g;
    for (int i = warp; i < G * hn * kt; i += kConsumers / 32) {
      const int gw = i / (hn * kt), hh = i / kt % hn, mt = i % kt;
      const long long b = win0 + gw;
      if (b >= B) continue;
      __nv_bfloat16* ps = pds + (gw * HG + hh) * 2 * Np * ldp;
      dispatch_tiles<KT>(
          kt, dt,
          RowItem{qkv + (hh * 3 * Mq + gw * Np) * ld, dos + (hh * Mq + gw * Np) * ld, ps,
                  ps + Np * ldp, ctx + b * N * Cp + (h0 + hh) * d,
                  dqkv + b * N * ldq + (h0 + hh) * Dp, bias_t + hh * N * N,
                  dbias_part + (b * heads + h0 + hh) * N * N, Mq, ld, ldp, mt, kt, dt, N, d, Cp,
                  ldq, scale, pair});
    }
    named_sync(1, kConsumers);  // every window's bf16 p and ds are in place

    // column pass: (window, head, 16-key tile, dv or dk) items
    for (int i = warp; i < G * hn * kt * 2; i += kConsumers / 32) {
      const int gw = i / (hn * kt * 2), hh = i / (kt * 2) % hn, which = i / kt % 2, j = i % kt;
      const long long b = win0 + gw;
      if (b >= B) continue;
      const __nv_bfloat16* ps = pds + (gw * HG + hh) * 2 * Np * ldp;
      dispatch_tiles<KT>(
          kt, dt,
          ColItem{ps + which * Np * ldp,
                  which ? qkv + (hh * 3 * Mq + gw * Np) * ld : dos + (hh * Mq + gw * Np) * ld,
                  dqkv + b * N * ldq + ((which ? 1 : 2) * heads + h0 + hh) * Dp, ldp, ld, j * 16,
                  kt, dt, N, d, ldq, which ? scale : 1.0f, pair});
    }
    cluster_sync();
  }
}

}  // namespace

namespace k6_bwd {

template <int NT, int KT>
cudaError_t launch_window_kt(const CUtensorMap& wmap, const Window& w, const Plan& p,
                             cudaStream_t stream) {
  // each instance may take the 227 KB a block has: set once a device
  static unsigned sized = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && !(sized >> dev & 1u)) {
    e = cudaFuncSetAttribute(window_bwd_kernel<NT, KT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
    if (e == cudaSuccess) sized |= 1u << dev;
  }
  if (e != cudaSuccess) return e;
  const dim3 grid(cdiv(cdiv(w.B, p.G), kCluster) * kCluster, cdiv(w.heads, p.HG));
  window_bwd_kernel<NT, KT><<<grid, kWindowThreads, p.smem, stream>>>(
      wmap, w.x, w.ldx, w.bqkv, w.bias, w.dctx, w.ctx, w.dqkv, w.dbias_part, w.B, w.N, w.C,
      w.heads, w.scale, p.G, p.HG, p.stages, p.staged, granule(NT, pad16(w.C / w.heads)));
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_window(const CUtensorMap& wmap, const Window& w, const Plan& p,
                          cudaStream_t stream) {
  return w.N <= 64 ? launch_window_kt<NT, 4>(wmap, w, p, stream)
                   : launch_window_kt<NT, 8>(wmap, w, p, stream);
}

}  // namespace k6_bwd
