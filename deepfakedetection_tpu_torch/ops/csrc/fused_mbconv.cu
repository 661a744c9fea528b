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
// Design: the TPU kernel keeps one image's expanded map in VMEM (1.2 MB at
//   B3's 56 x 56 x 192), and the SE gate needs the whole image's pool before
//   any row can be projected; a Hopper block has 227 KB. So the stages run
//   as kernels on the caller's stream: (a) K2's kernel unchanged
//   (expand_dw.cuh), which writes the bf16 depthwise map and the f32 pool;
//   (b) the SE gate as two small batched products, se_reduce_kernel (partial
//   sums over chunks of 256 channels) and se_expand_kernel (the chunks summed
//   in order, SiLU, the expand FC, sigmoid), each block taking a slice of
//   channels for several images, so that a weight is read once per image
//   group and not per image (one block per image read w_se_r and w_se_e from
//   L2 128 times at batch 128: 48 us a launch at 7 x 7 x 2304); then
//   pack_pairs_kernel, w_proj as bf16 pairs in the mma B layout; (c)
//   gated_proj_kernel, a GEMM over rows B*H*W on mma.sync (m16n8k16, bf16
//   in, f32 accumulate) fed by cp.async through a ring of kStages tiles (the
//   map, the gates of the images the block's rows fall in, w_proj's pairs),
//   which multiplies each A fragment by its row's gate in bf16 and adds
//   b_proj and the residual in its epilogue. The depthwise map goes through
//   HBM once each way (4*Cmid bytes a pixel), which the bound does not
//   count. No float atomics: a run repeats bit for bit.
#include "dw_common.cuh"
#include "expand_dw.cuh"

namespace {

using dfd::mma_bf16_16816;
using dfd::pack_bf16;

constexpr int kThreads = 256;
constexpr int kBK = 32;               // Cmid channels a stage
constexpr int kAWords = kBK / 2 + 4;  // A row stride in 32-bit words: 4 mod 8, conflict-free
constexpr int kGWords = kBK / 2;      // gate row stride in 32-bit words
constexpr int kStages = 4;            // cp.async ring depth
constexpr int kSeImages = 8;          // images a se_reduce_kernel block takes
constexpr int kSeChunk = kThreads;    // Cmid channels a se_reduce_kernel block takes
constexpr int kGateImages = 16;       // images a se_expand_kernel block takes

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Partial SE sums: part[kc][b][j] = sum over channel chunk kc (kSeChunk
// channels) of mean[b, c] * bf16(wr[c, j]), for kSeImages images and 32 SE
// channels a block: 8 row groups x 32 channels (coalesced reads of w_se_r's
// rows), the groups summed in a fixed order. The chunk's means sit
// channel-major in shared memory, so a channel's kSeImages values are two
// 16-byte loads.
__global__ void __launch_bounds__(kThreads) se_reduce_kernel(
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
#pragma unroll 4
    for (int c = r; c < nc; c += 8) {
      const float w = bf16_round(wr[static_cast<size_t>(c0 + c) * Cse + j]);
      const float4* mv = reinterpret_cast<const float4*>(mean + c * kSeImages);
#pragma unroll
      for (int q = 0; q < kSeImages / 4; ++q) {
        const float4 v = mv[q];
        acc[4 * q] = fmaf(v.x, w, acc[4 * q]);
        acc[4 * q + 1] = fmaf(v.y, w, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(v.z, w, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(v.w, w, acc[4 * q + 3]);
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
// then gate[b, c] = bf16(sigmoid(sum_j se[b, j] * bf16(we[j, c]) + be[c]))
// for kGateImages images and 256 channels a block, one channel a thread; se
// sits channel-major in shared memory (16-byte loads of kGateImages values).
__global__ void __launch_bounds__(kThreads) se_expand_kernel(
    const float* __restrict__ part, const float* __restrict__ br, const float* __restrict__ we,
    const float* __restrict__ be, __nv_bfloat16* __restrict__ gate, int B, int Cmid, int Cse,
    int chunks) {
  extern __shared__ __align__(16) float ses[];  // [Cse][kGateImages]
  const int tid = threadIdx.x, c = blockIdx.x * kThreads + tid, b0 = blockIdx.y * kGateImages;
  const int nb = min(kGateImages, B - b0);
  for (int i = tid; i < kGateImages * Cse; i += kThreads) {
    const int jj = i / kGateImages, b = i % kGateImages;
    float t = 0.0f;
    for (int kc = 0; kc < chunks && b < nb; ++kc)
      t += part[(static_cast<size_t>(kc) * B + b0 + b) * Cse + jj];
    ses[i] = b < nb ? dfd::silu(t + br[jj]) : 0.0f;
  }
  __syncthreads();
  if (c >= Cmid) return;
  float acc[kGateImages] = {};
#pragma unroll 4
  for (int j = 0; j < Cse; ++j) {
    const float w = bf16_round(we[static_cast<size_t>(j) * Cmid + c]);
    const float4* sv = reinterpret_cast<const float4*>(ses + j * kGateImages);
#pragma unroll
    for (int q = 0; q < kGateImages / 4; ++q) {
      const float4 v = sv[q];
      acc[4 * q] = fmaf(v.x, w, acc[4 * q]);
      acc[4 * q + 1] = fmaf(v.y, w, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(v.z, w, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(v.w, w, acc[4 * q + 3]);
    }
  }
  const float bias = be[c];
#pragma unroll
  for (int b = 0; b < kGateImages; ++b)
    if (b < nb)
      gate[static_cast<size_t>(b0 + b) * Cmid + c] =
          __float2bfloat16_rn(1.0f / (1.0f + expf(-(acc[b] + bias))));
}

// pairs[kp][n] = {bf16(wp[2kp][n]), bf16(wp[2kp+1][n])}, zero past Cmid or C:
// the col-major mma B operand, [Kp/2][Np] words with Kp = Cmid rounded up to
// kBK and Np = C rounded up to 64 (ops/fused_mbconv.py allocates it).
__global__ void pack_pairs_kernel(const float* __restrict__ wp, uint32_t* __restrict__ pairs,
                                  int Cmid, int C, int rows, int Np) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * Np) return;
  const int kp = i / Np, n = i % Np, k = 2 * kp;
  const bool in = n < C;
  pairs[i] = pack_bf16(in && k < Cmid ? wp[static_cast<size_t>(k) * C + n] : 0.0f,
                       in && k + 1 < Cmid ? wp[static_cast<size_t>(k + 1) * C + n] : 0.0f);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 16 : 0));  // a source size of 0 fills the 16 bytes with zeros
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// bf16(a * g) for two bf16 pairs packed in 32-bit words: the f32 product of
// two bf16 values is exact, so this is the bf16 product rounded once.
__device__ __forceinline__ uint32_t gated_pair(uint32_t a, uint32_t g) {
  const float2 av = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a));
  const float2 gv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&g));
  return pack_bf16(av.x * gv.x, av.y * gv.y);
}

// Shared memory of one ring stage, mirrored by the launcher: the A tile
// [64*MT rows][kAWords], the B tile [kBK/2][16*NT + 8] (row stride 8 mod 32:
// conflict-free fragment loads), the gates of up to `nimg` images [nimg][kGWords].
template <int MT, int NT>
__host__ __device__ constexpr int stage_words(int nimg) {
  return 64 * MT * kAWords + (kBK / 2) * (16 * NT + 8) + nimg * kGWords;
}

// out = bf16(gated(dw) @ pairs + bp + x) over M = B*H*W rows. A block of 8
// warps computes BM = 64*MT rows x 16*NT output channels, each warp 16*MT
// rows x 8*NT (4 x 2 warps), kBK channels of Cmid a stage. VEC (Cmid % 8 == 0, every
// EfficientNet width): each stage's map rows, gate rows and B pairs arrive
// by cp.async, kStages - 1 stages ahead of the mma; otherwise the map and
// gates are read one element at a time, with no overlap.
template <int MT, int NT, bool VEC>
__global__ void __launch_bounds__(kThreads) gated_proj_kernel(
    const __nv_bfloat16* __restrict__ dw, const __nv_bfloat16* __restrict__ gate,
    const uint32_t* __restrict__ pairs, const float* __restrict__ bp,
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out, int M, int HW, int Cmid,
    int C, int Np, int nimg) {
  constexpr int BM = 64 * MT, BN = 16 * NT, BWords = BN + 8;
  extern __shared__ __align__(16) uint32_t ring[];
  const int words = stage_words<MT, NT>(nimg);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q4 = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int KT = (Cmid + kBK - 1) / kBK;
  const int b0 = m0 / HW, nb = (min(m0 + BM, M) - 1) / HW - b0 + 1;  // images in the rows

  // gate row offset (words) of each of this thread's 2 * MT fragment rows
  int grow[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = min(m0 + wm * 16 * MT + mt * 16 + g + 8 * h, M - 1);
      grow[mt][h] = (m / HW - b0) * kGWords;
    }

  float acc[MT][NT][4] = {};

  auto compute = [&](const uint32_t* A, const uint32_t* Bt, const uint32_t* G) {
#pragma unroll
    for (int kp = 0; kp < kBK / 2; kp += 8) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint32_t* pa = A + (wm * 16 * MT + mt * 16 + g) * kAWords + kp + q4;
        const uint32_t* ga = G + grow[mt][0] + kp + q4;
        const uint32_t* gb = G + grow[mt][1] + kp + q4;
        a[mt][0] = gated_pair(pa[0], ga[0]);
        a[mt][1] = gated_pair(pa[8 * kAWords], gb[0]);
        a[mt][2] = gated_pair(pa[4], ga[4]);
        a[mt][3] = gated_pair(pa[8 * kAWords + 4], gb[4]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint32_t* pb = Bt + (kp + q4) * BWords + wn * 8 * NT + nt * 8 + g;
        const uint32_t b0w = pb[0], b1w = pb[4 * BWords];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16_16816(acc[mt][nt], a[mt], b0w, b1w);
      }
    }
  };

  if constexpr (VEC) {
    // one stage: A BM x 4 chunks of 8 channels (MT a thread), B (kBK/2) x
    // BN/4 chunks of 4 pairs, the gates nb x 4 chunks
    auto fetch = [&](int t) {
      uint32_t* st = ring + (t % kStages) * words;
      uint32_t* Bs = st + BM * kAWords;
      uint32_t* Gs = Bs + (kBK / 2) * BWords;
      const int k0 = t * kBK;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int c = tid + i * kThreads, row = c >> 2, kc = (c & 3) * 8, m = m0 + row;
        const bool full = m < M && k0 + kc < Cmid;
        cp_async16(st + row * kAWords + kc / 2,
                   dw + static_cast<size_t>(full ? m : 0) * Cmid + (full ? k0 + kc : 0), full);
      }
      if (tid < (kBK / 2) * (BN / 4)) {
        const int kp = tid / (BN / 4), j = (tid % (BN / 4)) * 4;
        cp_async16(Bs + kp * BWords + j,
                   pairs + static_cast<size_t>(k0 / 2 + kp) * Np + n0 + j, true);
      }
      for (int c = tid; c < nb * 4; c += kThreads) {
        const int img = c >> 2, kc = (c & 3) * 8;
        const bool full = k0 + kc < Cmid;
        cp_async16(Gs + img * kGWords + kc / 2,
                   gate + static_cast<size_t>(b0 + img) * Cmid + (full ? k0 + kc : 0), full);
      }
    };
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < KT) fetch(t);
      cp_async_commit();
    }
    for (int t = 0; t < KT; ++t) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // stage t landed for every thread; stage t - 1's slot is free
      if (t + kStages - 1 < KT) fetch(t + kStages - 1);
      cp_async_commit();
      const uint32_t* st = ring + (t % kStages) * words;
      compute(st, st + BM * kAWords, st + BM * kAWords + (kBK / 2) * BWords);
    }
  } else {
    uint32_t* Bs = ring + BM * kAWords;
    uint32_t* Gs = Bs + (kBK / 2) * BWords;
    __nv_bfloat16* A16 = reinterpret_cast<__nv_bfloat16*>(ring);
    __nv_bfloat16* G16 = reinterpret_cast<__nv_bfloat16*>(Gs);
    for (int t = 0; t < KT; ++t) {
      const int k0 = t * kBK;
      for (int i = tid; i < BM * kBK; i += kThreads) {
        const int row = i / kBK, kc = i % kBK, m = m0 + row, k = k0 + kc;
        A16[row * 2 * kAWords + kc] =
            m < M && k < Cmid ? dw[static_cast<size_t>(m) * Cmid + k] : __float2bfloat16(0.0f);
      }
      for (int i = tid; i < nb * kBK; i += kThreads) {
        const int img = i / kBK, k = k0 + i % kBK;
        G16[img * 2 * kGWords + i % kBK] =
            k < Cmid ? gate[static_cast<size_t>(b0 + img) * Cmid + k] : __float2bfloat16(0.0f);
      }
      for (int i = tid; i < (kBK / 2) * BN; i += kThreads) {
        const int kp = i / BN, j = i % BN;
        Bs[kp * BWords + j] = pairs[static_cast<size_t>(k0 / 2 + kp) * Np + n0 + j];
      }
      __syncthreads();
      compute(ring, Bs, Gs);
      __syncthreads();
    }
  }

  // Epilogue: + b_proj + x in f32 (that order, as the TPU kernel), one rounding.
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 16 * MT + mt * 16 + g + 8 * h;
      if (m >= M) continue;
      const size_t row = static_cast<size_t>(m) * C;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = n0 + wn * 8 * NT + nt * 8 + 2 * q4;
        const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if ((C & 1) == 0 && n + 1 < C) {  // C even: the pair is 4-byte aligned
          const float2 xr =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + row + n));
          *reinterpret_cast<__nv_bfloat162*>(out + row + n) =
              __floats2bfloat162_rn(v0 + bp[n] + xr.x, v1 + bp[n + 1] + xr.y);
        } else {
          if (n < C) out[row + n] = __float2bfloat16_rn(v0 + bp[n] + dfd::bf2f(x[row + n]));
          if (n + 1 < C)
            out[row + n + 1] =
                __float2bfloat16_rn(v1 + bp[n + 1] + dfd::bf2f(x[row + n + 1]));
        }
      }
    }
  }
}

template <int MT, int NT, bool VEC>
cudaError_t launch_proj(const void* dw, const void* gate, const uint32_t* pairs, const void* bp,
                        const void* x, void* out, int M, int HW, int Cmid, int C, int Np,
                        cudaStream_t stream) {
  constexpr int BM = 64 * MT;
  // the images one block's BM rows can fall in
  const int span = (BM - 1 + HW - 1) / HW + 1, nimg = span < BM ? span : BM;
  const size_t smem = sizeof(uint32_t) * stage_words<MT, NT>(nimg) * (VEC ? kStages : 1);
  cudaError_t err = dfd::allow_smem(gated_proj_kernel<MT, NT, VEC>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BM - 1) / BM, (C + 16 * NT - 1) / (16 * NT));
  gated_proj_kernel<MT, NT, VEC><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(dw), static_cast<const __nv_bfloat16*>(gate), pairs,
      static_cast<const float*>(bp), static_cast<const __nv_bfloat16*>(x),
      static_cast<__nv_bfloat16*>(out), M, HW, Cmid, C, Np, nimg);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: 0 on success. dw [B,H,W,Cmid] bf16, partial
// [B,tiles,Cmid] f32, pool [B,Cmid] f32, se_part [ceil(Cmid/256)][B][Cse]
// f32, gate [B,Cmid] bf16 and pairs [ceil(Cmid/32)*16][ceil(C/64)*64] 32-bit
// words are the caller's scratch; TH, TW, CB are K2's plan
// (ops/expand_dw.py:plan).
extern "C" int dfd_fused_mbconv_se(const void* x, const void* w_exp, const void* b_exp,
                                   const void* w_dw, const void* b_dw, const void* w_se_r,
                                   const void* b_se_r, const void* w_se_e, const void* b_se_e,
                                   const void* w_proj, const void* b_proj, void* dw, void* partial,
                                   void* pool, void* se_part, void* gate, void* pairs, void* out,
                                   int B, int H, int W, int C, int Cmid, int Cse, int k, int TH,
                                   int TW, int CB, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(B) * H * W;
  if (B < 1 || C < 1 || Cmid < 1 || Cse < 1 || rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = dfd::launch_expand_dw_silu_pool(x, w_exp, b_exp, w_dw, b_dw, dw, partial, pool,
                                                    B, H, W, C, Cmid, k, TH, TW, CB, s);
  if (err != cudaSuccess) return err;
  const int chunks = (Cmid + kSeChunk - 1) / kSeChunk;
  const dim3 red_grid((Cse + 31) / 32, (B + kSeImages - 1) / kSeImages, chunks);
  se_reduce_kernel<<<red_grid, kThreads, 0, s>>>(static_cast<const float*>(pool),
                                                  static_cast<const float*>(w_se_r),
                                                  static_cast<float*>(se_part), B, Cmid, Cse);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t exp_smem = sizeof(float) * kGateImages * Cse;
  err = dfd::allow_smem(se_expand_kernel, exp_smem);
  if (err != cudaSuccess) return err;
  const dim3 exp_grid((Cmid + kThreads - 1) / kThreads, (B + kGateImages - 1) / kGateImages);
  se_expand_kernel<<<exp_grid, kThreads, exp_smem, s>>>(
      static_cast<const float*>(se_part), static_cast<const float*>(b_se_r),
      static_cast<const float*>(w_se_e), static_cast<const float*>(b_se_e),
      static_cast<__nv_bfloat16*>(gate), B, Cmid, Cse, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int prows = (Cmid + kBK - 1) / kBK * (kBK / 2), Np = (C + 63) / 64 * 64;
  pack_pairs_kernel<<<(prows * Np + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(w_proj), static_cast<uint32_t*>(pairs), Cmid, C, prows, Np);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int M = static_cast<int>(rows), HW = H * W;
  const uint32_t* pp = static_cast<const uint32_t*>(pairs);
  // 32 output channels a block when C <= 32, else 64; 128 rows a block, or 64
  // where 128 would give fewer than 4 blocks an SM (the 7 x 7 and 14 x 14 x
  // 96 shapes of B3: the last wave would run mostly empty)
  const int nt = C <= 32 ? 2 : 4, cols = (C + 16 * nt - 1) / (16 * nt);
  const bool tall = static_cast<long long>((M + 127) / 128) * cols >= 4 * 132;
  const bool vec = (Cmid & 7) == 0;
  if (!vec)  // widths off the 16-byte loads (none of EfficientNet's): one path
    return launch_proj<2, 4, false>(dw, gate, pp, b_proj, x, out, M, HW, Cmid, C, Np, s);
  if (nt == 2)
    return tall ? launch_proj<2, 2, true>(dw, gate, pp, b_proj, x, out, M, HW, Cmid, C, Np, s)
                : launch_proj<1, 2, true>(dw, gate, pp, b_proj, x, out, M, HW, Cmid, C, Np, s);
  return tall ? launch_proj<2, 4, true>(dw, gate, pp, b_proj, x, out, M, HW, Cmid, C, Np, s)
              : launch_proj<1, 4, true>(dw, gate, pp, b_proj, x, out, M, HW, Cmid, C, Np, s);
}
