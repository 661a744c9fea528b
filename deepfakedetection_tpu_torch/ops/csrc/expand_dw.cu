// K2: fused MBConv expand 1x1 + BN + SiLU -> depthwise k x k + BN + SiLU
// (+ SE spatial mean), stride 1.
//
// Replaces: deepfakedetection_tpu/ops/pallas/expand_dw.py,
//   expand_dw_silu_pool (_kernel), the TPU kernel for every stride-1 MBConv
//   with an expansion.
// Contract: x [B,H,W,Cin] bf16; wexp [Cin,Ce], bexp [Ce], wdw [k,k,Ce],
//   bdw [Ce] f32 (BN folded) -> y [B,H,W,Ce] bf16 =
//   silu(dw(pad0(bf16(silu(x @ bf16(wexp) + bexp)))) + bdw), pool [B,Ce] f32
//   = mean over H,W of y BEFORE its bf16 rounding. The expand accumulates in
//   f32 and its output is rounded to bf16 before the taps; the zero padding
//   is of the EXPANDED map (silu(0 @ w + b) is not 0).
// Bound on the H100: HBM bytes. Unfused, the 6x-expanded map is written and
//   read back (12 bytes per input channel of x per pixel); the expand is
//   2*Cin flops per expanded element and the taps 2k^2, so over the bytes
//   that must move the work stays below the ~295 flop/byte bf16 line.
// Design: the expanded map never reaches HBM. A block stages the in-image
//   part of its haloed x tile and its slice of wexp (as bf16) in shared
//   memory, computes the expanded tile on the tensor cores (mma.sync
//   m16n8k16, bf16 in, f32 accumulate) into shared memory, applies the taps
//   from there and writes only y and the pool partials. Shared memory rows
//   are padded so the fragment loads hit 32 distinct banks. The wrapper
//   sizes the tile so the worst EfficientNet-B3 case fits in 227 KB.
#include "dw_common.cuh"
#include "expand_dw.cuh"

namespace {

using dfd::mma_bf16_16816;
using dfd::pack_bf16;

struct Smem {
  int xs_words, ws_words, es_stride;  // row strides: x pixel, w pair-row (32-bit), e pixel (bf16)
  size_t xs, ws, es, red, total;
};

// A row stride in 32-bit words that is 4 mod 8, so the 8 rows x 4 columns of
// an mma fragment load fall in 32 distinct banks.
__host__ __device__ inline int conflict_free(int words) { return words + ((12 - words % 8) % 8); }

// Shared memory layout, mirrored by ops/expand_dw.py:_smem_bytes. xs holds
// only the in-image part of the haloed x tile, with Cin padded to 16 (one
// mma k-step).
__host__ __device__ inline Smem smem_layout(int TH, int TW, int H, int W, int Cin, int CB, int K) {
  const int Kp = (Cin + 15) / 16 * 16;
  const int HH = TH + K - 1, WW = TW + K - 1;
  const int NPmax = (HH < H ? HH : H) * (WW < W ? WW : W);
  Smem s;
  s.xs_words = conflict_free(Kp / 2);
  s.ws_words = CB + 8;
  s.es_stride = CB + 8;
  s.xs = 0;
  s.ws = s.xs + dfd::align16(sizeof(uint32_t) * NPmax * s.xs_words);
  s.es = s.ws + dfd::align16(sizeof(uint32_t) * (Kp / 2) * s.ws_words);
  s.red = s.es + dfd::align16(sizeof(__nv_bfloat16) * HH * WW * s.es_stride);
  s.total = s.red + sizeof(float) * (256 / CB) * CB;
  return s;
}

// grid (tiles, Ce blocks, B); block (CB channels, 256/CB pixel lanes); CB is
// 32 or 64 (a multiple of the 4 x 8 channels one warp's mma group covers).
template <int K>
__global__ void expand_dw_silu_pool_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ wexp,
    const float* __restrict__ bexp, const float* __restrict__ wdw, const float* __restrict__ bdw,
    __nv_bfloat16* __restrict__ y, float* __restrict__ partial, int H, int W, int Cin, int Ce,
    int TH, int TW, int tiles_w, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int R = K / 2;
  const int CB = blockDim.x, ny = blockDim.y;
  const int lane = threadIdx.x;
  const int tid = threadIdx.y * CB + lane, nthreads = CB * ny;
  const int tile = blockIdx.x, c0 = blockIdx.y * CB, b = blockIdx.z;
  const dfd::Tile t = dfd::tile_of(tile, tiles_w, TH, TW, H, W);
  const int HH = TH + K - 1, WW = TW + K - 1;
  const int Kp = (Cin + 15) / 16 * 16;
  const Smem L = smem_layout(TH, TW, H, W, Cin, CB, K);
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem + L.xs);  // [NP][xs_words] bf16 pairs
  uint32_t* ws = reinterpret_cast<uint32_t*>(smem + L.ws);  // [Kp/2][ws_words] bf16 pairs
  __nv_bfloat16* es = reinterpret_cast<__nv_bfloat16*>(smem + L.es);  // [HH*WW][es_stride]
  float* red = reinterpret_cast<float*>(smem + L.red);

  // The in-image part of the halo: rows [ry0, ry1) x cols [rx0, rx1).
  const int ry0 = max(t.oy0 - R, 0), ry1 = min(t.oy0 + t.th + R, H);
  const int rx0 = max(t.ox0 - R, 0), rx1 = min(t.ox0 + t.tw + R, W);
  const int nrx = rx1 - rx0, NP = (ry1 - ry0) * nrx;

  // x tile, Cin zero-padded to Kp: 16-byte loads (8 channels) when Cin % 8
  // == 0, as for every EfficientNet width; one channel at a time otherwise.
  if ((Cin & 7) == 0) {
    const int chunks = Kp / 8;
#pragma unroll 4
    for (int i = tid; i < NP * chunks; i += nthreads) {
      const int ch = i % chunks, p = i / chunks;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (ch * 8 < Cin)
        v = *reinterpret_cast<const uint4*>(
            x + ((static_cast<size_t>(b) * H + ry0 + p / nrx) * W + rx0 + p % nrx) * Cin + ch * 8);
      *reinterpret_cast<uint4*>(xs + p * L.xs_words + ch * 4) = v;
    }
  } else {
    __nv_bfloat16* xs16 = reinterpret_cast<__nv_bfloat16*>(xs);
    for (int i = tid; i < NP * Kp; i += nthreads) {
      const int cc = i % Kp, p = i / Kp;
      __nv_bfloat16 v = __float2bfloat16(0.0f);
      if (cc < Cin)
        v = x[((static_cast<size_t>(b) * H + ry0 + p / nrx) * W + rx0 + p % nrx) * Cin + cc];
      xs16[p * 2 * L.xs_words + cc] = v;
    }
  }
  // wexp slice as bf16 pairs: word (kp, j) = {w[2kp][c0+j], w[2kp+1][c0+j]},
  // the B fragment layout of mma (k-major pairs per output channel). Four
  // channels a thread with 16-byte loads when Ce % 4 == 0.
  if ((Ce & 3) == 0) {
    const int quads = CB / 4;
#pragma unroll 2
    for (int i = tid; i < (Kp / 2) * quads; i += nthreads) {
      const int j = (i % quads) * 4, kp = i / quads, ce = c0 + j;
      float4 r0 = make_float4(0.f, 0.f, 0.f, 0.f), r1 = r0;
      if (ce < Ce && 2 * kp < Cin)
        r0 = *reinterpret_cast<const float4*>(wexp + static_cast<size_t>(2 * kp) * Ce + ce);
      if (ce < Ce && 2 * kp + 1 < Cin)
        r1 = *reinterpret_cast<const float4*>(wexp + static_cast<size_t>(2 * kp + 1) * Ce + ce);
      *reinterpret_cast<uint4*>(ws + kp * L.ws_words + j) =
          make_uint4(pack_bf16(r0.x, r1.x), pack_bf16(r0.y, r1.y), pack_bf16(r0.z, r1.z),
                     pack_bf16(r0.w, r1.w));
    }
  } else {
    __nv_bfloat16* ws16 = reinterpret_cast<__nv_bfloat16*>(ws);
    for (int i = tid; i < Kp * CB; i += nthreads) {
      const int j = i % CB, cc = i / CB, ce = c0 + j;
      float v = 0.0f;
      if (cc < Cin && ce < Ce) v = wexp[static_cast<size_t>(cc) * Ce + ce];
      ws16[((cc >> 1) * L.ws_words + j) * 2 + (cc & 1)] = __float2bfloat16_rn(v);
    }
  }
  // Expanded halo, zero where it lies outside the image (the dw padding).
  uint4* es4 = reinterpret_cast<uint4*>(es);
  for (int i = tid; i < HH * WW * L.es_stride / 8; i += nthreads) es4[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // Expand on the tensor cores: warp items are (16 pixels) x (32 channels).
  const int warp = tid / 32, nwarps = nthreads / 32;
  const int g = (tid % 32) >> 2, q4 = tid & 3;
  const int MT = (NP + 15) / 16, NCH = CB / 32;
  uint32_t* es32 = reinterpret_cast<uint32_t*>(es);
  for (int item = warp; item < MT * NCH; item += nwarps) {
    const int m0 = (item / NCH) * 16, n0 = (item % NCH) * 32;
    const uint32_t* xa = xs + min(m0 + g, NP - 1) * L.xs_words + q4;
    const uint32_t* xb = xs + min(m0 + g + 8, NP - 1) * L.xs_words + q4;
    float acc[4][4] = {};
    for (int kp = 0; kp < Kp / 2; kp += 8) {
      const uint32_t a[4] = {xa[kp], xb[kp], xa[kp + 4], xb[kp + 4]};
      const uint32_t* wb = ws + (kp + q4) * L.ws_words + n0 + g;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_bf16_16816(acc[nt], a, wb[nt * 8], wb[4 * L.ws_words + nt * 8]);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = m0 + g + 8 * half;
      if (p >= NP) continue;
      const int hy = ry0 + p / nrx - (t.oy0 - R), hx = rx0 + p % nrx - (t.ox0 - R);
      uint32_t* row = es32 + (hy * WW + hx) * (L.es_stride / 2);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + nt * 8 + 2 * q4, ce = c0 + col;
        const float e0 = ce < Ce ? dfd::silu(acc[nt][2 * half] + bexp[ce]) : 0.0f;
        const float e1 = ce + 1 < Ce ? dfd::silu(acc[nt][2 * half + 1] + bexp[ce + 1]) : 0.0f;
        row[col / 2] = pack_bf16(e0, e1);
      }
    }
  }
  __syncthreads();

  const int ce = c0 + lane;
  float psum = 0.0f;
  if (ce < Ce) {
    float wr[K * K];
#pragma unroll
    for (int tap = 0; tap < K * K; ++tap) wr[tap] = wdw[static_cast<size_t>(tap) * Ce + ce];
    const float bv = bdw[ce];
    for (int p = threadIdx.y; p < t.th * t.tw; p += ny) {
      const int py = p / t.tw, px = p % t.tw;
      const float yv = dfd::silu(dfd::dw_taps<K>(es, WW, L.es_stride, lane, py, px, wr) + bv);
      y[((static_cast<size_t>(b) * H + t.oy0 + py) * W + t.ox0 + px) * Ce + ce] =
          __float2bfloat16_rn(yv);
      psum += yv;  // the pool is the mean of the activation before rounding
    }
  }
  dfd::write_tile_sum(red, psum, partial, b, tiles, tile, Ce, ce);
}

template <int K>
cudaError_t launch(const void* x, const void* wexp, const void* bexp, const void* wdw,
                   const void* bdw, void* y, void* partial, void* pool, int B, int H, int W,
                   int Cin, int Ce, int TH, int TW, int CB, cudaStream_t stream) {
  const int tiles_h = (H + TH - 1) / TH, tiles_w = (W + TW - 1) / TW;
  const int tiles = tiles_h * tiles_w;
  const size_t smem = smem_layout(TH, TW, H, W, Cin, CB, K).total;
  cudaError_t err = dfd::allow_smem(expand_dw_silu_pool_kernel<K>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles, (Ce + CB - 1) / CB, B), block(CB, 256 / CB);
  expand_dw_silu_pool_kernel<K><<<grid, block, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(wexp),
      static_cast<const float*>(bexp), static_cast<const float*>(wdw),
      static_cast<const float*>(bdw), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(partial), H, W, Cin, Ce, TH, TW, tiles_w, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return dfd::launch_pool_finalize(static_cast<const float*>(partial), static_cast<float*>(pool),
                                   B, tiles, Ce, H * W, stream);
}

}  // namespace

cudaError_t dfd::launch_expand_dw_silu_pool(const void* x, const void* wexp, const void* bexp,
                                            const void* wdw, const void* bdw, void* y,
                                            void* partial, void* pool, int B, int H, int W,
                                            int Cin, int Ce, int k, int TH, int TW, int CB,
                                            cudaStream_t s) {
  if ((CB != 32 && CB != 64) || TH < 1 || TW < 1) return cudaErrorInvalidValue;
  switch (k) {
    case 3:
      return launch<3>(x, wexp, bexp, wdw, bdw, y, partial, pool, B, H, W, Cin, Ce, TH, TW, CB, s);
    case 5:
      return launch<5>(x, wexp, bexp, wdw, bdw, y, partial, pool, B, H, W, Cin, Ce, TH, TW, CB, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Returns a cudaError_t: 0 on success. CB (Ce channels per block) is 32 or 64.
extern "C" int dfd_expand_dw_silu_pool(const void* x, const void* wexp, const void* bexp,
                                       const void* wdw, const void* bdw, void* y, void* partial,
                                       void* pool, int B, int H, int W, int Cin, int Ce, int k,
                                       int TH, int TW, int CB, void* stream) {
  return dfd::launch_expand_dw_silu_pool(x, wexp, bexp, wdw, bdw, y, partial, pool, B, H, W, Cin,
                                         Ce, k, TH, TW, CB, static_cast<cudaStream_t>(stream));
}
