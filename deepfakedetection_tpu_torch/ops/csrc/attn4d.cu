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
//   N <= 128, h <= 8, d % 16 == 0, dv % 8 == 0.
// Bound on the H100: HBM bytes. At EfficientFormerV2-S1's shapes (N 49, h 8,
//   d 32, dv 128) an image reads q, k (25 KB) and v (100 KB) and writes 100 KB
//   for 3.2 MFLOP on the tensor cores and 0.3 MFLOP of f32 head mixing: ~14
//   flops per byte, far below the ~295 flop/byte bf16 line. One launch at
//   batch 256 moves 64 MB (~19 us at 3.35 TB/s).
// Design: the talking-head mixes combine every head at each (query, key)
//   pair, so a block cannot own one head as K5's does: it owns one image and a
//   tile of 16 query rows (query rows are independent: softmax runs over keys
//   and the mixes are per element), with four warps.
//   A: the block stages its q tile and the image's k rows in shared memory
//      (16-byte loads when the strides allow, zero rows past N); each warp
//      takes every fourth head and computes s_h = q_h k_h^T on the tensor cores
//      (mma.sync m16n8k16, contracting over d per head), scales it, adds the
//      bias and writes the f32 scores of all heads to shared memory.
//   B: each warp takes every fourth query row; a lane holds key columns lane
//      and lane + 32 (and + 64, + 96 for N > 64). It mixes th1 across heads in
//      f32 FMAs, masks columns >= N (after the mix: a -inf mixed across heads
//      with signed weights would corrupt the valid ones), takes the row
//      softmax with the max and sum reduced across the warp, mixes th2 and
//      writes bf16 p2, zero on columns >= N: there th2_b would otherwise add
//      th2_b[g] * v past the last token (the TPU kernel relies on zero padded
//      v rows instead; here nothing is padded).
//   C: per output head, the block stages v_g [N, dv] (zero rows past N) over
//      the q/k buffer, and each warp computes a quarter of p2_g . v_g's
//      8-column tiles on the tensor cores, rounding once to bf16.
//   The TPU kernel's lane-masked full-width contraction and its padding of N
//   to 64 exist for the TPU's lanes and are not carried over. Scale and bias
//   use exactly rounded f32 operations, the softmax a division, as the plain
//   version; the head mixes use FMAs (within f32 rounding of it).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "window_attn_common.cuh"

namespace {

constexpr int kRows = 16;      // query rows per block
constexpr int kMaxHeads = 8;

struct Src {
  const __nv_bfloat16* p;
  long long sb, sr;  // batch and row strides, in elements
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// Shared-memory layout of one block (bytes): a region that holds q and k in
// phase A and p2 and one head of v in phases B and C, then the f32 scores,
// then the head-mixing tables.
struct Layout {
  int Np, ldq, lds, ldp, ldv;
  size_t scores, tables, total;
  __host__ __device__ Layout(int N, int heads, int Cq, int dv) {
    Np = (N + 15) / 16 * 16;
    ldq = Cq + 8;
    lds = Np + 4;
    ldp = Np + 8;
    ldv = dv + 8;
    const size_t qk = static_cast<size_t>(kRows + Np) * ldq * 2;
    const size_t pv = static_cast<size_t>(heads) * kRows * ldp * 2 + static_cast<size_t>(Np) * ldv * 2;
    scores = align16(qk > pv ? qk : pv);
    tables = scores + align16(static_cast<size_t>(heads) * kRows * lds * 4);
    total = tables + static_cast<size_t>(2 * heads * heads + 2 * heads) * 4;
  }
};

// KT bounds the 16-key tiles (N <= 16 KT); the loops run over the actual kt.
template <int KT>
__global__ void __launch_bounds__(kWarps * 32)
    attn4d_kernel(Src q, Src k, Src v, const float* __restrict__ bias,
                  const float* __restrict__ th1, const float* __restrict__ th1_b,
                  const float* __restrict__ th2, const float* __restrict__ th2_b,
                  __nv_bfloat16* __restrict__ out, int N, int heads, int d, int dv, float scale,
                  int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Cq = heads * d, Cv = heads * dv;
  const Layout L(N, heads, Cq, dv);
  const int Np = L.Np, kt = Np / 16;
  const int tiles = (N + kRows - 1) / kRows;
  const int b = blockIdx.x / tiles, q0 = (blockIdx.x % tiles) * kRows;
  const int rows = min(kRows, N - q0);  // valid query rows of this tile
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + kRows * L.ldq;
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem);  // over q, k after phase A
  __nv_bfloat16* vs = ps + heads * kRows * L.ldp;
  float* S = reinterpret_cast<float*>(smem + L.scores);
  float* t1 = reinterpret_cast<float*>(smem + L.tables);
  float* t1b = t1 + heads * heads;
  float* t2 = t1b + heads;
  float* t2b = t2 + heads * heads;

  for (int i = threadIdx.x; i < heads * heads; i += blockDim.x) {
    t1[i] = th1[i];
    t2[i] = th2[i];
  }
  for (int i = threadIdx.x; i < heads; i += blockDim.x) {
    t1b[i] = th1_b[i];
    t2b[i] = th2_b[i];
  }
  stage(qs, q.p + b * q.sb + q0 * q.sr, q.sr, rows, Cq, kRows, Cq, L.ldq, vec);
  stage(ks, k.p + b * k.sb, k.sr, N, Cq, Np, Cq, L.ldq, vec);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;  // mma group (row) and thread in group

  // Phase A: the scaled, biased scores of every head, f32, into S[h][row][key].
  {
    const int ldw = L.ldq / 2;
    const uint32_t* qs32 = reinterpret_cast<const uint32_t*>(qs);
    const uint32_t* ks32 = reinterpret_cast<const uint32_t*>(ks);
    for (int h = warp; h < heads; h += kWarps) {
      float s[2 * KT][4];
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
      const uint32_t* qa = qs32 + g * ldw + h * d / 2 + t4;
      const uint32_t* qb = qa + 8 * ldw;
      for (int kk = 0; kk < d / 16; ++kk) {
        const uint32_t a[4] = {qa[kk * 8], qb[kk * 8], qa[kk * 8 + 4], qb[kk * 8 + 4]};
#pragma unroll
        for (int nt = 0; nt < 2 * KT; ++nt) {
          if (nt >= 2 * kt) continue;
          const uint32_t* kb = ks32 + (nt * 8 + g) * ldw + h * d / 2 + kk * 8 + t4;
          mma_bf16_16816(s[nt], a, kb[0], kb[4]);
        }
      }
      const float* bias_h = bias + static_cast<long long>(h) * N * N;
      const int r0 = q0 + g, r1 = r0 + 8;
      float* S0 = S + (h * kRows + g) * L.lds;
      float* S1 = S0 + 8 * L.lds;
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt) {
        if (nt >= 2 * kt) continue;
        const int c = nt * 8 + 2 * t4;
        float v0[2], v1[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool col = c + e < N;
          v0[e] = col && r0 < N
                      ? __fadd_rn(__fmul_rn(s[nt][e], scale), bias_h[r0 * N + c + e]) : 0.0f;
          v1[e] = col && r1 < N
                      ? __fadd_rn(__fmul_rn(s[nt][2 + e], scale), bias_h[r1 * N + c + e]) : 0.0f;
        }
        *reinterpret_cast<float2*>(S0 + c) = make_float2(v0[0], v0[1]);
        *reinterpret_cast<float2*>(S1 + c) = make_float2(v1[0], v1[1]);
      }
    }
  }
  __syncthreads();

  // Phase B: th1 mix, mask, row softmax, th2 mix; bf16 p2 into ps[g][row][key]
  // (over the q and k rows, which phase A has finished with).
  constexpr int CPL = KT / 2;  // key columns per lane
  for (int r = warp; r < kRows; r += kWarps) {
    const bool live = r < rows;
    float x[kMaxHeads][CPL];
#pragma unroll
    for (int gg = 0; gg < kMaxHeads; ++gg)
#pragma unroll
      for (int j = 0; j < CPL; ++j) x[gg][j] = 0.0f;
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      if (h >= heads) continue;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = lane + 32 * j;
        const float sv = c < Np ? S[(h * kRows + r) * L.lds + c] : 0.0f;
#pragma unroll
        for (int gg = 0; gg < kMaxHeads; ++gg)
          if (gg < heads) x[gg][j] = fmaf(t1[h * heads + gg], sv, x[gg][j]);
      }
    }
#pragma unroll
    for (int gg = 0; gg < kMaxHeads; ++gg) {
      if (gg >= heads) continue;
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = lane + 32 * j;
        x[gg][j] = c < N ? __fadd_rn(x[gg][j], t1b[gg]) : -INFINITY;
        m = fmaxf(m, x[gg][j]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      float l = 0.0f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = lane + 32 * j;
        x[gg][j] = c < N ? expf(__fsub_rn(x[gg][j], m)) : 0.0f;
        l += x[gg][j];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
      for (int j = 0; j < CPL; ++j) x[gg][j] = __fdiv_rn(x[gg][j], l);
    }
#pragma unroll
    for (int go = 0; go < kMaxHeads; ++go) {
      if (go >= heads) continue;
      __nv_bfloat16* prow = ps + (go * kRows + r) * L.ldp;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = lane + 32 * j;
        if (c >= Np) continue;
        float acc = 0.0f;
#pragma unroll
        for (int gg = 0; gg < kMaxHeads; ++gg)
          if (gg < heads) acc = fmaf(t2[gg * heads + go], x[gg][j], acc);
        prow[c] = __float2bfloat16_rn(live && c < N ? __fadd_rn(acc, t2b[go]) : 0.0f);
      }
    }
  }

  // Phase C: out_g = p2_g . v_g, one head of v staged at a time.
  const int ldpw = L.ldp / 2;
  const uint32_t* ps32 = reinterpret_cast<const uint32_t*>(ps);
  __nv_bfloat16* out_tile = out + (static_cast<long long>(b) * N + q0) * Cv;
  for (int go = 0; go < heads; ++go) {
    __syncthreads();  // p2 written (first head), or the previous head's v read
    stage(vs, v.p + b * v.sb + go * dv, v.sr, N, dv, Np, dv, L.ldv, vec);
    __syncthreads();
    uint32_t a[KT][4];
    const uint32_t* pa = ps32 + (go * kRows + g) * ldpw + t4;
    const uint32_t* pb = pa + 8 * ldpw;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      if (j >= kt) continue;
      a[j][0] = pa[j * 8];
      a[j][1] = pb[j * 8];
      a[j][2] = pa[j * 8 + 4];
      a[j][3] = pb[j * 8 + 4];
    }
    for (int nt = warp; nt < dv / 8; nt += kWarps) {
      float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        if (j >= kt) continue;
        const __nv_bfloat16* vp = vs + (j * 16 + 2 * t4) * L.ldv + nt * 8 + g;
        mma_bf16_16816(o, a[j], pack_raw(vp[0], vp[L.ldv]), pack_raw(vp[8 * L.ldv], vp[9 * L.ldv]));
      }
      store_pair_rows(out_tile + go * dv, Cv, o, g, nt * 8 + 2 * t4, rows, dv, 1.0f, vec);
    }
  }
}

template <int KT>
cudaError_t launch(Src q, Src k, Src v, const float* bias, const float* th1, const float* th1_b,
                   const float* th2, const float* th2_b, __nv_bfloat16* out, int B, int N,
                   int heads, int d, int dv, float scale, int vec, cudaStream_t stream) {
  const size_t smem = Layout(N, heads, heads * d, dv).total;
  if (smem > static_cast<size_t>(kMaxSmemBytes)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn4d_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int tiles = (N + kRows - 1) / kRows;
  attn4d_kernel<KT><<<B * tiles, kWarps * 32, smem, stream>>>(
      q, k, v, bias, th1, th1_b, th2, th2_b, out, N, heads, d, dv, scale, vec);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: 0 on success. Strides are in elements; vec = 1
// promises h*d, dv and every stride % 8 == 0 and 16-byte aligned q, k, v and
// out, for 16-byte loads and 4-byte stores.
extern "C" int dfd_attn4d(const void* q, const void* k, const void* v, const void* bias,
                          const void* th1, const void* th1_b, const void* th2, const void* th2_b,
                          void* out, int B, int N, int heads, int d, int dv, long long q_sb,
                          long long q_sr, long long k_sb, long long k_sr, long long v_sb,
                          long long v_sr, float scale, int vec, void* stream) {
  if (B < 1 || N < 1 || N > 128 || heads < 1 || heads > kMaxHeads || d < 16 || d % 16 ||
      dv < 8 || dv % 8 || static_cast<long long>(B) * ((N + kRows - 1) / kRows) > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const Src qv{static_cast<const __nv_bfloat16*>(q), q_sb, q_sr};
  const Src kv{static_cast<const __nv_bfloat16*>(k), k_sb, k_sr};
  const Src vv{static_cast<const __nv_bfloat16*>(v), v_sb, v_sr};
  const float *bs = static_cast<const float*>(bias), *t1 = static_cast<const float*>(th1),
              *t1b = static_cast<const float*>(th1_b), *t2 = static_cast<const float*>(th2),
              *t2b = static_cast<const float*>(th2_b);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 64)
    return static_cast<int>(
        launch<4>(qv, kv, vv, bs, t1, t1b, t2, t2b, o, B, N, heads, d, dv, scale, vec, st));
  return static_cast<int>(
      launch<8>(qv, kv, vv, bs, t1, t1b, t2, t2b, o, B, N, heads, d, dv, scale, vec, st));
}
