// K3: the whole stride-1, in == out MBConv+SE block for inference: expand
// 1x1 + SiLU -> depthwise k x k + SiLU -> SE (pool, FC + SiLU, FC + sigmoid)
// -> gate -> project 1x1 + bias + residual.
//
// Replaces: deepfakedetection_tpu/ops/pallas/fused_mbconv.py,
//   fused_mbconv_se (_block_kernel), the TPU kernel for EfficientNet's
//   residual blocks with an expansion.
// Contract: x [B,H,W,C] bf16; w_exp [C,Cmid], w_dw [k,k,Cmid], w_se_r
//   [Cmid,Cse], w_se_e [Cse,Cmid], w_proj [Cmid,C] and the biases f32 (BN
//   folded) -> out [B,H,W,C] bf16. dw, mean = K2's y and pool; se =
//   silu(mean @ bf16(w_se_r) + b_se_r), gate = bf16(sigmoid(se @
//   bf16(w_se_e) + b_se_e)) in f32; out = bf16(sum_k bf16(dw * gate) *
//   bf16(w_proj) + b_proj + x), f32 accumulation, one rounding.
// Bound on the H100: operations. x is read once and out written once (4C
//   bytes a pixel) against 4*C*Cmid tensor-core operations in the two 1x1
//   products and 2*k^2*Cmid f32 operations in the taps, at B3's Cmid = 6C.
// Design: four launches. K2's kernel (expand_dw.cuh, with the weights packed
//   beforehand) writes the bf16 depthwise map and the f32 pool;
//   se_reduce_kernel and se_expand_kernel compute the gate (each issuing a
//   batch of weight loads before summing them in order); gated_proj_kernel
//   projects the map over all B*H*W rows with wgmma: a producer warp feeds a
//   ring of three stages by TMA (128 map rows x 64 channels, 128-byte
//   swizzled, and the same 64 channels of BN rows of w_proj^T), and each of
//   two consumer warpgroups gates its 64 rows of the stage in shared memory
//   (bf16x2 multiplies, the swizzle undone to find each 16-byte unit's
//   channels, the gates loaded a stage ahead), fences them for the async
//   proxy and issues four m64nBNk16 products (the first with scale-d 0: no
//   zeroed accumulators) while the next stage lands; the epilogue stages the
//   sums through shared memory and adds b_proj and the residual in f32 with
//   one rounding, 16-byte loads of x and stores of out. BN is fitted to C
//   (choose_plan). Where Cmid % 8 != 0 (no EfficientNet width: TMA needs
//   16-byte rows) the projection is gated_proj_mma_kernel (mma.sync, operands
//   read one element at a time). The weights are packed once (pack_kernel:
//   wexp as K2's bf16 pairs, w_proj^T and w_se_e in bf16), which MBConv
//   caches: a forward launches no packing kernel. No float atomics: a run
//   repeats bit for bit, and the output is bit-identical to the mma.sync
//   design's before it.
// Measured on an H100 80GB HBM3 at 700 W (profile_k3 --tree against the
//   mma.sync design, B3's six shapes at batch 128, device time in turns):
//   3.084 ms a B3 forward against 3.771 (0.82); K2's kernel is ~70% of it.
//   Keeping the depthwise map on chip in a thread-block cluster, as the TPU
//   kernel keeps it in VMEM, was built and lost to these launches at every
//   B3 @ 224 block (1.08-3.88x their device time): the map's HBM round trip
//   is only ~5% of K3 (PERF.md section 6).
// Plan table (choose_plan: projection, BN, column tiles, shared bytes), B3 @ 224:
//   56 x 56 x  32 k3: wgmma 32 1 62512
//   28 x 28 x  48 k5: wgmma 48 1 68656
//   14 x 14 x  96 k3: wgmma 48 2 68656
//   14 x 14 x 136 k5: wgmma 144 1 105520
//    7 x  7 x 232 k5: wgmma 128 2 99376
//    7 x  7 x 384 k3: wgmma 192 2 123952
#include "dw_common.cuh"
#include "expand_dw.cuh"
#include "gemm_tma.cuh"
#include "hopper.cuh"

namespace {

using dfd::mma_bf16_16816;
using dfd::pack_bf16;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// bf16(a * g) for two bf16 pairs packed in 32-bit words, one bf16x2
// multiply: the exact product rounded once, as bf16(f32(a) * f32(g)).
__device__ __forceinline__ uint32_t gated_pair(uint32_t a, uint32_t g) {
  const __nv_bfloat162 r = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&g));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// ---------------------------------------------------------------- packing

// Every weight layout the kernels take, in one launch over a flat index:
// wexp [Cep][Kp/2] words (K2's: wexp[n][kp] = {bf16(w[2kp][n]),
// bf16(w[2kp+1][n])}, Kp = C rounded to 16, Cep = Cmid rounded to 64), wpt
// [C][Kq] = bf16(w_proj^T) (Kq = Cmid rounded to 64) and see [Cse][Cmid] =
// bf16(w_se_e); zero past C, Cmid.
__global__ void pack_kernel(const float* __restrict__ we, const float* __restrict__ wse,
                            const float* __restrict__ wp, uint32_t* __restrict__ wexp,
                            __nv_bfloat16* __restrict__ see, __nv_bfloat16* __restrict__ wpt,
                            int C, int Cmid, int Cse) {
  const int rows = cdiv(C, 16) * 8, Cep = cdiv(Cmid, 64) * 64, Kq = cdiv(Cmid, 64) * 64;
  const long long n1 = static_cast<long long>(rows) * Cep, n2 = n1 + static_cast<long long>(Kq) * C;
  const long long n3 = n2 + static_cast<long long>(Cse) * Cmid;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n1) {  // consecutive threads read consecutive n
    const int kp = static_cast<int>(i / Cep), n = static_cast<int>(i % Cep), k = 2 * kp;
    const bool in = n < Cmid;
    wexp[static_cast<size_t>(n) * rows + kp] =
        pack_bf16(in && k < C ? we[static_cast<size_t>(k) * Cmid + n] : 0.0f,
                  in && k + 1 < C ? we[static_cast<size_t>(k + 1) * Cmid + n] : 0.0f);
  } else if (i < n2) {
    i -= n1;
    const int k = static_cast<int>(i / C), n = static_cast<int>(i % C);
    wpt[static_cast<size_t>(n) * Kq + k] =
        __float2bfloat16_rn(k < Cmid ? wp[static_cast<size_t>(k) * C + n] : 0.0f);
  } else if (i < n3) {
    i -= n2;
    see[i] = __float2bfloat16_rn(wse[i]);
  }
}

// ---------------------------------------------------------------- SE

constexpr int kSeThreads = 256;
constexpr int kSeImages = 8;          // images a se_reduce_kernel block takes
constexpr int kSeChunk = kSeThreads;  // Cmid channels a se_reduce_kernel block takes
constexpr int kGateImages = 4;        // images a se_expand_kernel block takes
constexpr int kSeBatch = 16;          // weight loads the SE kernels issue before summing them

// Partial SE sums: part[kc][b][j] = sum over channel chunk kc (kSeChunk
// channels) of mean[b, c] * bf16(wr[c, j]), for kSeImages images and 32 SE
// channels a block: 8 row groups x 32 channels (coalesced reads of w_se_r's
// rows), the groups summed in a fixed order. The chunk's means sit
// channel-major in shared memory, so a channel's kSeImages values are two
// 16-byte loads.
__global__ void __launch_bounds__(kSeThreads) se_reduce_kernel(
    const float* __restrict__ pool, const float* __restrict__ wr, float* __restrict__ part, int B,
    int Cmid, int Cse) {
  __shared__ __align__(16) float mean[kSeChunk * kSeImages];
  __shared__ float red[8 * kSeImages * 32];
  const int tid = threadIdx.x, lane = tid & 31, r = tid >> 5;
  const int j = blockIdx.x * 32 + lane, b0 = blockIdx.y * kSeImages, c0 = blockIdx.z * kSeChunk;
  const int nb = min(kSeImages, B - b0), nc = min(kSeChunk, Cmid - c0);
  for (int b = 0; b < kSeImages; ++b)
    mean[tid * kSeImages + b] =
        b < nb && tid < nc ? pool[static_cast<size_t>(b0 + b) * Cmid + c0 + tid] : 0.0f;
  __syncthreads();
  float acc[kSeImages] = {};
  if (j < Cse) {
    for (int c0r = r; c0r < nc; c0r += 8 * kSeBatch) {
      float w[kSeBatch];  // a batch of independent loads, then the sums in order
#pragma unroll
      for (int u = 0; u < kSeBatch; ++u) {
        const int c = c0r + 8 * u;
        w[u] = c < nc ? bf16_round(wr[static_cast<size_t>(c0 + c) * Cse + j]) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kSeBatch; ++u) {
        const int c = c0r + 8 * u;
        if (c >= nc) break;
        const float4* mv = reinterpret_cast<const float4*>(mean + c * kSeImages);
#pragma unroll
        for (int q = 0; q < kSeImages / 4; ++q) {
          const float4 v = mv[q];
          acc[4 * q] = fmaf(v.x, w[u], acc[4 * q]);
          acc[4 * q + 1] = fmaf(v.y, w[u], acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(v.z, w[u], acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(v.w, w[u], acc[4 * q + 3]);
        }
      }
    }
  }
#pragma unroll
  for (int b = 0; b < kSeImages; ++b) red[(r * kSeImages + b) * 32 + lane] = acc[b];
  __syncthreads();
  const int b = tid >> 5;  // 256 threads: one (image, SE channel) each
  if (b < nb && j < Cse) {
    float t = 0.0f;
#pragma unroll
    for (int q = 0; q < 8; ++q) t += red[(q * kSeImages + b) * 32 + lane];
    part[(static_cast<size_t>(blockIdx.z) * B + b0 + b) * Cse + j] = t;
  }
}

// se[b, j] = silu(sum over the chunks of part[kc][b][j], in order, + br[j]),
// then gate[b, c] = bf16(sigmoid(sum_j se[b, j] * see[j, c] + be[c])) (see
// = bf16(w_se_e), packed) for kGateImages images and 256 channels a block,
// one channel a thread; se sits channel-major in shared memory (16-byte loads
// of kGateImages values).
__global__ void __launch_bounds__(kSeThreads) se_expand_kernel(
    const float* __restrict__ part, const float* __restrict__ br, const __nv_bfloat16* __restrict__ see,
    const float* __restrict__ be, __nv_bfloat16* __restrict__ gate, int B, int Cmid, int Cse,
    int chunks) {
  extern __shared__ __align__(16) float ses[];  // [Cse][kGateImages]
  const int tid = threadIdx.x, c = blockIdx.x * kSeThreads + tid, b0 = blockIdx.y * kGateImages;
  const int nb = min(kGateImages, B - b0);
  for (int i = tid; i < kGateImages * Cse; i += kSeThreads) {
    const int jj = i / kGateImages, b = i % kGateImages;
    float t = 0.0f;
    for (int kc = 0; kc < chunks && b < nb; ++kc)
      t += part[(static_cast<size_t>(kc) * B + b0 + b) * Cse + jj];
    ses[i] = b < nb ? dfd::silu(t + br[jj]) : 0.0f;
  }
  __syncthreads();
  if (c >= Cmid) return;
  float acc[kGateImages] = {};
  for (int j0 = 0; j0 < Cse; j0 += kSeBatch) {
    float w[kSeBatch];  // a batch of independent loads, then the sums in order
#pragma unroll
    for (int u = 0; u < kSeBatch; ++u)
      w[u] = j0 + u < Cse ? dfd::bf2f(see[static_cast<size_t>(j0 + u) * Cmid + c]) : 0.0f;
#pragma unroll
    for (int u = 0; u < kSeBatch; ++u) {
      if (j0 + u >= Cse) break;
      const float4* sv = reinterpret_cast<const float4*>(ses + (j0 + u) * kGateImages);
#pragma unroll
      for (int q = 0; q < kGateImages / 4; ++q) {
        const float4 v = sv[q];
        acc[4 * q] = fmaf(v.x, w[u], acc[4 * q]);
        acc[4 * q + 1] = fmaf(v.y, w[u], acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(v.z, w[u], acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(v.w, w[u], acc[4 * q + 3]);
      }
    }
  }
  const float bias = be[c];
#pragma unroll
  for (int b = 0; b < kGateImages; ++b)
    if (b < nb)
      gate[static_cast<size_t>(b0 + b) * Cmid + c] =
          __float2bfloat16_rn(1.0f / (1.0f + expf(-(acc[b] + bias))));
}

// ---------------------------------------------------------------- projection

constexpr int kProjConsumers = 256;                  // two warpgroups, 64 rows each
constexpr int kProjThreads = kProjConsumers + 32;    // and the producer warp
constexpr int kProjRows = 128;                       // output rows a block
constexpr int kProjStages = 3;                       // TMA ring depth
constexpr int kProjWidths[6] = {32, 48, 64, 128, 144, 192};  // BN: one wgmma's N
constexpr int kProjMma = 0, kProjWgmma = 1;          // the projection kernels, as the plan names them
constexpr int kMmaRows = 128, kMmaCols = 64;         // gated_proj_mma_kernel's tile

__host__ __device__ constexpr int proj_stage_bytes(int BN) {
  return kProjRows * kRowBytes + BN * kRowBytes;
}

__host__ __device__ constexpr int proj_smem(int BN) {
  return kAlign + kProjStages * proj_stage_bytes(BN) + 2 * kProjStages * 8;
}

struct Plan {
  int proj, BN, tiles, smem;
};

// The projection's launch plan, from C and Cmid alone. wgmma where Cmid % 8
// == 0 (TMA's 16-byte rows: every EfficientNet width), with the output tile
// BN of kProjWidths that wastes the fewest columns, counting 32 more for
// each column tile (each tile reads and gates the map again), the narrower
// on a tie: at B3's six shapes the fastest of every BN by device time on an
// H100 (at 14 x 14 x 96, 48 x 2 tiles 0.022 ms against 128 x 1's 0.029);
// else the mma.sync kernel.
inline Plan choose_plan(int C, int Cmid) {
  if (Cmid % 8 != 0) return Plan{kProjMma, kMmaCols, cdiv(C, kMmaCols), 0};
  int best = kProjWidths[0];
  for (int w : kProjWidths)
    if (cdiv(C, w) * (w + 32) < cdiv(C, best) * (best + 32)) best = w;
  return Plan{kProjWgmma, best, cdiv(C, best), proj_smem(best)};
}

// out = bf16(gated(dw) @ w_proj + bp + x) over M = B*H*W rows: a block
// takes 128 rows and BN output columns. The producer warp loads each 64
// channels of the map's 128 rows (K-major, 128-byte swizzle) and of w_proj^T's
// BN rows into a ring stage by TMA (zeros past M, Cmid and C); each consumer
// warpgroup gates its 64 rows in place (16-byte units: 4 a thread), fences
// them for the async proxy, syncs its 128 threads and issues four m64nBNk16
// wgmma, then releases the previous stage once its products are done.
template <int BN>
__global__ void __launch_bounds__(kProjThreads, BN <= 48 ? 3 : BN <= 64 ? 2 : 1)
    gated_proj_kernel(const __grid_constant__ CUtensorMap amap,
                      const __grid_constant__ CUtensorMap bmap,
                      const __nv_bfloat16* __restrict__ gate, const float* __restrict__ bp,
                      const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out, int M,
                      int HW, int Cmid, int C, bool vec) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = aligned_smem(smem_raw);
  constexpr int a_bytes = kProjRows * kRowBytes, stage_bytes = proj_stage_bytes(BN);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kProjStages * stage_bytes);
  uint64_t* empty = full + kProjStages;
  const int m0 = blockIdx.x * kProjRows, n0 = blockIdx.y * BN, nkb = cdiv(Cmid, kKTile);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kProjStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kProjConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (warp == kProjConsumers / 32) {  // the producer
    if (lane == 0) {
      tma_prefetch_map(&amap);
      tma_prefetch_map(&bmap);
      for (int kb = 0; kb < nkb; ++kb) {
        const int s = kb % kProjStages;
        unsigned char* st = ring + s * stage_bytes;
        mbar_wait(&empty[s], ((kb / kProjStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], stage_bytes);
        tma_load(st, &amap, &full[s], kb * kKTile, m0);
        tma_load(st + a_bytes, &bmap, &full[s], kb * kKTile, n0);
      }
    }
    __syncwarp();
    return;
  }
  const int wg = warp / 4, t = threadIdx.x % 128, g = lane >> 2, t4 = lane & 3;
  // this thread's gating units: rows t / 8 + 16 q (q < 4) of the warpgroup's
  // 64, physical 16-byte unit t % 8, which holds channels 8 ((t % 8) ^ (row %
  // 8)) on of the stage's 64; the gate row of each row's image
  const int unit = t % 8;
  const __nv_bfloat16* grow[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int m = min(m0 + 64 * wg + t / 8 + 16 * q, M - 1);  // past M: TMA's zeros
    grow[q] = gate + static_cast<size_t>(m / HW) * Cmid;
  }
  // the gates of stage kb's units, loaded a stage ahead of their use
  auto gates = [&](int kb, uint4 (&gv)[4]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = kb * kKTile + 8 * (unit ^ ((t / 8 + 16 * q) & 7));
      gv[q] = c < Cmid ? __ldg(reinterpret_cast<const uint4*>(grow[q] + c)) : make_uint4(0, 0, 0, 0);
    }
  };
  float acc[BN / 2];  // the first product's scale-d is 0: nothing zeroes it
  uint4 gv[4], gnext[4];
  gates(0, gv);
  for (int kb = 0; kb < nkb; ++kb) {
    const int s = kb % kProjStages;
    unsigned char* a = ring + s * stage_bytes + wg * 64 * kRowBytes;
    if (kb + 1 < nkb) gates(kb + 1, gnext);
    mbar_wait(&full[s], (kb / kProjStages) & 1);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint4* pa = reinterpret_cast<uint4*>(a + (t / 8 + 16 * q) * kRowBytes + unit * 16);
      uint4 v = *pa;  // past Cmid: TMA's zeros times a zero gate
      v.x = gated_pair(v.x, gv[q].x);
      v.y = gated_pair(v.y, gv[q].y);
      v.z = gated_pair(v.z, gv[q].z);
      v.w = gated_pair(v.w, gv[q].w);
      *pa = v;
      gv[q] = gnext[q];
    }
    fence_proxy_async();
    named_sync(1 + wg, 128);  // the warpgroup's 64 rows are gated
    const uint64_t da = wgmma_desc(a), db = wgmma_desc(ring + s * stage_bytes + a_bytes);
    // all four 16-deep steps: past Cmid the operands are zeros
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kKTile / 16; ++ks) wgmma_ss<BN>(acc, da + 2 * ks, db + 2 * ks, kb > 0 || ks > 0);
    wgmma_commit();
    if (kb > 0) {  // the previous stage's products are done: release it
      wgmma_wait<1>();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(kb - 1) % kProjStages]);
    }
  }
  wgmma_wait<0>();
  // The epilogue through shared memory: once every product has read its
  // stage, each warpgroup's 64 x BN sums go to the ring (f32 rows of BN + 8
  // words: conflict-free pairs), then + b_proj + x in f32 (that order, as the
  // TPU kernel) and one rounding, 8 output channels a thread: 16-byte loads
  // of x and stores of out where vec (C % 8 == 0, x 16-byte aligned), else
  // one channel at a time.
  constexpr int SW = BN + 8;
  float* sums = reinterpret_cast<float*>(ring) + wg * 64 * SW;
  named_sync(3, kProjConsumers);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(sums + (16 * (warp % 4) + g + 8 * h) * SW + 8 * j + 2 * t4) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  named_sync(1 + wg, 128);
  const int cols = min(BN, C - n0);
  for (int i = t; i < 64 * (BN / 8); i += 128) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8, m = m0 + 64 * wg + r;
    if (m >= M || c >= cols) continue;
    const float* s = sums + r * SW + c;
    const float* b = bp + n0 + c;
    const size_t o = static_cast<size_t>(m) * C + n0 + c;
    if (vec) {
      const uint4 xv = *reinterpret_cast<const uint4*>(x + o);
      const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w};
      uint32_t ow[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xw[e]));
        ow[e] = pack_bf16(s[2 * e] + __ldg(b + 2 * e) + xf.x, s[2 * e + 1] + __ldg(b + 2 * e + 1) + xf.y);
      }
      *reinterpret_cast<uint4*>(out + o) = make_uint4(ow[0], ow[1], ow[2], ow[3]);
    } else {
      for (int e = 0; e < 8 && c + e < cols; ++e)
        out[o + e] = __float2bfloat16_rn(s[e] + b[e] + dfd::bf2f(x[o + e]));
    }
  }
}

template <int BN>
cudaError_t launch_proj(const void* dw, const void* gate, const void* wpt, const void* bp,
                        const void* x, void* out, int M, int HW, int Cmid, int C,
                        cudaStream_t stream) {
  CUtensorMap amap, bmap;
  const int Kq = cdiv(Cmid, kKTile) * kKTile;
  cudaError_t err = tensor_map(&amap, dw, Cmid, M, 2ll * Cmid, kKTile, kProjRows);
  if (err == cudaSuccess) err = tensor_map(&bmap, wpt, Kq, C, 2ll * Kq, kKTile, BN);
  if (err == cudaSuccess) err = dfd::allow_smem(gated_proj_kernel<BN>, proj_smem(BN));
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(M, kProjRows), cdiv(C, BN));
  gated_proj_kernel<BN><<<grid, kProjThreads, proj_smem(BN), stream>>>(
      amap, bmap, static_cast<const __nv_bfloat16*>(gate), static_cast<const float*>(bp),
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), M, HW, Cmid, C,
      C % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0);
  return cudaGetLastError();
}

// The projection where Cmid % 8 != 0: a block of 8 warps computes 128 rows x
// 64 output channels, each warp 32 x 32 (4 x 2 warps), kBK channels of Cmid a
// step, the map, gates and w_proj^T read one element at a time into shared
// memory (A rows of kAWords, conflict-free), the mma.sync products on bf16
// pairs.
constexpr int kMmaThreads = 256;
constexpr int kBK = 32;               // Cmid channels a step
constexpr int kAWords = kBK / 2 + 4;  // A row stride in 32-bit words: 4 mod 8, conflict-free
constexpr int kGWords = kBK / 2;      // gate row stride in 32-bit words
constexpr int kBWords = kMmaCols + 8;  // B row stride in words: 8 mod 32, conflict-free

__host__ __device__ constexpr int mma_smem_words(int nimg) {
  return kMmaRows * kAWords + (kBK / 2) * kBWords + nimg * kGWords;
}

__global__ void __launch_bounds__(kMmaThreads) gated_proj_mma_kernel(
    const __nv_bfloat16* __restrict__ dw, const __nv_bfloat16* __restrict__ gate,
    const __nv_bfloat16* __restrict__ wpt, const float* __restrict__ bp,
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out, int M, int HW, int Cmid,
    int C, int Kq) {
  extern __shared__ __align__(16) uint32_t tile[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q4 = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int m0 = blockIdx.x * kMmaRows, n0 = blockIdx.y * kMmaCols;
  const int b0 = m0 / HW, nb = (min(m0 + kMmaRows, M) - 1) / HW - b0 + 1;  // images in the rows
  uint32_t* Bs = tile + kMmaRows * kAWords;
  uint32_t* Gs = Bs + (kBK / 2) * kBWords;
  __nv_bfloat16* A16 = reinterpret_cast<__nv_bfloat16*>(tile);
  __nv_bfloat16* G16 = reinterpret_cast<__nv_bfloat16*>(Gs);
  int grow[2][2];  // gate row offset (words) of each of this thread's fragment rows
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      grow[mt][h] = (min(m0 + wm * 32 + mt * 16 + g + 8 * h, M - 1) / HW - b0) * kGWords;
  float acc[2][4][4] = {};
  for (int k0 = 0; k0 < Cmid; k0 += kBK) {
    for (int i = tid; i < kMmaRows * kBK; i += kMmaThreads) {
      const int row = i / kBK, kc = i % kBK, m = m0 + row, k = k0 + kc;
      A16[row * 2 * kAWords + kc] =
          m < M && k < Cmid ? dw[static_cast<size_t>(m) * Cmid + k] : __float2bfloat16(0.0f);
    }
    for (int i = tid; i < nb * kBK; i += kMmaThreads) {
      const int img = i / kBK, k = k0 + i % kBK;
      G16[img * 2 * kGWords + i % kBK] =
          k < Cmid ? gate[static_cast<size_t>(b0 + img) * Cmid + k] : __float2bfloat16(0.0f);
    }
    for (int i = tid; i < (kBK / 2) * kMmaCols; i += kMmaThreads) {  // zeros past Cmid (Kq)
      const int kp = i / kMmaCols, n = n0 + i % kMmaCols;
      const __nv_bfloat16* w = wpt + static_cast<size_t>(n) * Kq + k0 + 2 * kp;
      Bs[kp * kBWords + i % kMmaCols] =
          n < C ? static_cast<uint32_t>(__bfloat16_as_ushort(w[0])) |
                      static_cast<uint32_t>(__bfloat16_as_ushort(w[1])) << 16
                : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int kp = 0; kp < kBK / 2; kp += 8) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint32_t* pa = tile + (wm * 32 + mt * 16 + g) * kAWords + kp + q4;
        const uint32_t* ga = Gs + grow[mt][0] + kp + q4;
        const uint32_t* gb = Gs + grow[mt][1] + kp + q4;
        a[mt][0] = gated_pair(pa[0], ga[0]);
        a[mt][1] = gated_pair(pa[8 * kAWords], gb[0]);
        a[mt][2] = gated_pair(pa[4], ga[4]);
        a[mt][3] = gated_pair(pa[8 * kAWords + 4], gb[4]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint32_t* pb = Bs + (kp + q4) * kBWords + wn * 32 + nt * 8 + g;
        const uint32_t b0w = pb[0], b1w = pb[4 * kBWords];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16_16816(acc[mt][nt], a[mt], b0w, b1w);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 32 + mt * 16 + g + 8 * h;
      if (m >= M) continue;
      const size_t row = static_cast<size_t>(m) * C;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + wn * 32 + nt * 8 + 2 * q4;
        if (n < C)
          out[row + n] = __float2bfloat16_rn(acc[mt][nt][2 * h] + bp[n] + dfd::bf2f(x[row + n]));
        if (n + 1 < C)
          out[row + n + 1] =
              __float2bfloat16_rn(acc[mt][nt][2 * h + 1] + bp[n + 1] + dfd::bf2f(x[row + n + 1]));
      }
    }
  }
}

}  // namespace

// Returns a cudaError_t: 0 on success. Packs the f32 weights into the
// layouts the kernels take (pack_kernel): wexp [ceil(Cmid/64)*64][ceil(C/16)*8]
// 32-bit words, see [Cse][Cmid] and wpt [C][ceil(Cmid/64)*64] bf16
// (ops/fused_mbconv.py:pack allocates them).
extern "C" int dfd_fused_mbconv_pack(const void* w_exp, const void* w_se_e, const void* w_proj,
                                     void* wexp, void* see, void* wpt, int C, int Cmid, int Cse,
                                     void* stream) {
  if (C < 1 || Cmid < 1 || Cse < 1) return cudaErrorInvalidValue;
  const long long n = static_cast<long long>(cdiv(C, 16)) * 8 * cdiv(Cmid, 64) * 64 +
                      static_cast<long long>(cdiv(Cmid, 64)) * 64 * C +
                      static_cast<long long>(Cse) * Cmid;
  pack_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w_exp), static_cast<const float*>(w_se_e),
      static_cast<const float*>(w_proj), static_cast<uint32_t*>(wexp),
      static_cast<__nv_bfloat16*>(see), static_cast<__nv_bfloat16*>(wpt), C, Cmid, Cse);
  return cudaGetLastError();
}

// Returns a cudaError_t: 0 on success. x and out [B,H,W,C] bf16; the packed
// weights (dfd_fused_mbconv_pack), w_se_r and the biases and taps f32. CB and
// RB are K2's plan, proj and BN the projection's (ops/fused_mbconv.py:plan);
// a plan other than choose_plan's is refused, never replaced. Scratch: dw
// [B,H,W,Cmid] bf16, pool [B,Cmid] f32, se_part [ceil(Cmid/256)][B][Cse] f32,
// gate [B,Cmid] bf16.
extern "C" int dfd_fused_mbconv_se(const void* x, const void* wexp, const void* b_exp,
                                   const void* w_dw, const void* b_dw, const void* w_se_r,
                                   const void* b_se_r, const void* see, const void* b_se_e,
                                   const void* wpt, const void* b_proj, void* dw, void* pool,
                                   void* se_part, void* gate, void* out, int B, int H, int W,
                                   int C, int Cmid, int Cse, int k, int CB, int RB, int proj,
                                   int BN, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(B) * H * W;
  if (B < 1 || H < 1 || W < 1 || C < 1 || Cmid < 1 || Cse < 1 || (k != 3 && k != 5) ||
      rows > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const Plan pl = choose_plan(C, Cmid);
  if (proj != pl.proj || BN != pl.BN) return cudaErrorInvalidValue;
  cudaError_t err = dfd::launch_expand_dw_silu_pool(x, nullptr, b_exp, w_dw, b_dw, dw, pool,
                                                    const_cast<void*>(wexp), B, H, W, C, Cmid, k,
                                                    CB, RB, s);
  if (err != cudaSuccess) return err;
  const int chunks = (Cmid + kSeChunk - 1) / kSeChunk;
  const dim3 red_grid((Cse + 31) / 32, (B + kSeImages - 1) / kSeImages, chunks);
  se_reduce_kernel<<<red_grid, kSeThreads, 0, s>>>(static_cast<const float*>(pool),
                                                    static_cast<const float*>(w_se_r),
                                                    static_cast<float*>(se_part), B, Cmid, Cse);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t exp_smem = sizeof(float) * kGateImages * Cse;
  err = dfd::allow_smem(se_expand_kernel, exp_smem);
  if (err != cudaSuccess) return err;
  const dim3 exp_grid((Cmid + kSeThreads - 1) / kSeThreads, (B + kGateImages - 1) / kGateImages);
  se_expand_kernel<<<exp_grid, kSeThreads, exp_smem, s>>>(
      static_cast<const float*>(se_part), static_cast<const float*>(b_se_r),
      static_cast<const __nv_bfloat16*>(see), static_cast<const float*>(b_se_e),
      static_cast<__nv_bfloat16*>(gate), B, Cmid, Cse, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int M = static_cast<int>(rows), HW = H * W;
  if (pl.proj == kProjMma) {
    const int span = (kMmaRows - 1 + HW - 1) / HW + 1, nimg = span < kMmaRows ? span : kMmaRows;
    const size_t smem = sizeof(uint32_t) * mma_smem_words(nimg);
    err = dfd::allow_smem(gated_proj_mma_kernel, smem);
    if (err != cudaSuccess) return err;
    gated_proj_mma_kernel<<<dim3(cdiv(M, kMmaRows), cdiv(C, kMmaCols)), kMmaThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(dw), static_cast<const __nv_bfloat16*>(gate),
        static_cast<const __nv_bfloat16*>(wpt), static_cast<const float*>(b_proj),
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), M, HW, Cmid, C,
        cdiv(Cmid, kKTile) * kKTile);
    return cudaGetLastError();
  }
  switch (pl.BN) {
    case 32: return launch_proj<32>(dw, gate, wpt, b_proj, x, out, M, HW, Cmid, C, s);
    case 48: return launch_proj<48>(dw, gate, wpt, b_proj, x, out, M, HW, Cmid, C, s);
    case 64: return launch_proj<64>(dw, gate, wpt, b_proj, x, out, M, HW, Cmid, C, s);
    case 128: return launch_proj<128>(dw, gate, wpt, b_proj, x, out, M, HW, Cmid, C, s);
    case 144: return launch_proj<144>(dw, gate, wpt, b_proj, x, out, M, HW, Cmid, C, s);
    default: return launch_proj<192>(dw, gate, wpt, b_proj, x, out, M, HW, Cmid, C, s);
  }
}

// The projection plan choose_plan picks: out = {proj (0 mma.sync, 1
// wgmma), BN, column tiles, shared bytes}. Returns a cudaError_t.
extern "C" int dfd_fused_mbconv_plan(int C, int Cmid, int* out) {
  if (C < 1 || Cmid < 1) return cudaErrorInvalidValue;
  const Plan pl = choose_plan(C, Cmid);
  const int v[4] = {pl.proj, pl.BN, pl.tiles, pl.smem};
  for (int i = 0; i < 4; ++i) out[i] = v[i];
  return cudaSuccess;
}
