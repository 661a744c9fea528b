// K5 past 128 tokens: the forward and the backward of multi-head attention
// with a per-head additive bias over windows of 129 to 256 tokens (FasterViT's
// stage 4 at 448 px: 196 tokens; at 512 px: 256). window_attn.cu and
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
//     p   = exp(s - max s) / sum exp(s - max s), in f32, rounded to bf16
//     out = p . v_h accumulated in f32, rounded to bf16.
//   Backward: qkv [B, N, 3C], dout [B, N, C] -> dqkv [B, N, 3C] bf16 and
//   dbias [h, N, N] f32 summed over windows, as window_attn_bwd.cu: the f32
//   p recomputed, dv = bf16(bf16(p)^T do), dp = do v^T, ds = p (dp -
//   rowsum(dp p)), dq = bf16(bf16(ds) k * scale), dk = bf16(bf16(ds)^T q *
//   scale). 128 < N <= 256 and d <= 128; a block's shared memory must fit
//   (the forward's always does; the backward's at d 128 up to N 208).
// Bound on the H100: HBM bytes at FasterViT-2's official stage 4 (N 196,
//   d 48): a window and head read 3 N d 2 bytes and write N d 2 for 4 N^2 d
//   flops, ~98 flops per byte, below the ~295 flop/byte bf16 line.
//
// Design: simple and right first. The score row of a query tile does not
//   fit in registers at 256 keys (128 f32 a thread), so each warp walks its
//   16-row query tile over 16-key tiles several times, recomputing q k^T
//   each time: once for the row max, once for the row sum, once for the
//   probabilities and p v. Every pass computes a score with the same
//   instructions in the same order, so the passes agree bit for bit, and
//   the max, sum, quotient and products are those of window_attn.cu (its
//   order over key columns), so the two kernels compute one function.
//   Forward: one block of 8 warps a (window, head), q, k and v of the window
//   staged in shared memory by 16-byte cp.async (element copies where a
//   stride or d does not allow), the bias read from L2; a warp a query tile.
//   Backward: persistent blocks of 8 warps, H x P of them (P = SMs / heads,
//   at most the windows), block (h, i) owning head h's windows [i B / P,
//   (i + 1) B / P) in order. For each window, q, k, v and do are staged;
//   a row phase (a warp a query tile) finds each row's max, sum and row term
//   rowsum(dp p) by three walks over the key tiles, keeps them in shared
//   memory and computes dq on a fourth; a column phase (a warp a key tile)
//   walks the query tiles twice, recomputing p (and dp and ds) from the
//   kept row statistics: dv = bf16(p)^T do on the first, dk = bf16(ds)^T q
//   and the dbias partial on the second, the transposed operands of p and
//   ds formed in registers by movmatrix. Each block adds ds into its own
//   f32 partial plane in device memory, each element by one thread, windows
//   in order; a second kernel sums each head's P planes in order. No float
//   atomics: two runs give bit-identical dqkv and dbias.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"
#include "window_attn_common.cuh"
#include "window_attn_pipe.cuh"

namespace {

constexpr int kLongMin = 129, kLongMax = 256;  // N the kernels take
constexpr int kLongWarps = 8;
constexpr int kLongThreads = 32 * kLongWarps;

__host__ __device__ constexpr int long_fwd_smem(int N, int d) {
  return 3 * pad16(N) * (pad16(d) + 8) * 2;
}

// q, k, v and do, then the row max, sum and row term of every row (f32).
__host__ __device__ constexpr int long_bwd_smem(int N, int d) {
  return 4 * pad16(N) * (pad16(d) + 8) * 2 + 3 * pad16(N) * 4;
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Transposes an 8x8 bf16 tile held as an mma fragment across the warp.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

// The block's copy of window b's rows < N of head h of T tensors into T
// [Np][ld] tiles (columns < d), then a block barrier. Rows past N and
// columns past d are not written.
template <int T>
__device__ __forceinline__ void load_block(__nv_bfloat16* dst, const View (&src)[T], int b, int h,
                                           int N, int d, int Np, int ld, bool vec) {
#pragma unroll
  for (int i = 0; i < T; ++i) {
    const __nv_bfloat16* base = src[i].p + b * src[i].sb + h * src[i].sh;
    __nv_bfloat16* out = dst + i * Np * ld;
    if (vec) {
      const int chunks = d / 8;
      for (int e = threadIdx.x; e < N * chunks; e += kLongThreads) {
        const int r = e / chunks, c = e - r * chunks;
        cp_async16(out + r * ld + 8 * c, base + r * src[i].sr + 8 * c);
      }
    } else {
      for (int e = threadIdx.x; e < N * d; e += kLongThreads) {
        const int r = e / d, c = e - r * d;
        out[r * ld + c] = base[r * src[i].sr + c];
      }
    }
  }
  if (vec) cp_async_wait_all();
  __syncthreads();
}

// s = a_rows(i) . b_rows(j)^T for a 16-row tile i of A and a 16-row tile j
// of B ([*][ld] bf16 in shared memory), summed over the dt 16-wide column
// tiles in order: s[t] holds columns 8 t .. 8 t + 7 of the 16x16 tile.
__device__ __forceinline__ void tile_product(float (&s)[2][4], const __nv_bfloat16* A,
                                             const __nv_bfloat16* Bm, int i, int j, int dt,
                                             int ld, int lane) {
  const int tile_row = lane & 15, tile_col = (lane >> 4) * 8;
  const int key_row = (lane & 7) + ((lane >> 4) << 3), key_col = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int t = 0; t < 2; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.0f;
#pragma unroll 1
  for (int kk = 0; kk < dt; ++kk) {
    uint32_t a[4], b[4];
    ldmatrix_x4(a, A + (i * 16 + tile_row) * ld + kk * 16 + tile_col);
    ldmatrix_x4(b, Bm + (j * 16 + key_row) * ld + kk * 16 + key_col);
    mma_bf16_16816(s[0], a, b[0], b[1]);
    mma_bf16_16816(s[1], a, b[2], b[3]);
  }
}

// The scores of query tile i against key tile j, scaled, biased and masked
// as window_attn.cu: -inf on columns past N, 0 on rows past N (whose q rows
// are zero). v[t][e] is row r0 (e < 2) or r1 (e >= 2), column 8 t + 2 t4 + e % 2.
__device__ __forceinline__ void scores(float (&v)[2][4], const __nv_bfloat16* qs,
                                       const __nv_bfloat16* ks, const float* __restrict__ bias_h,
                                       int i, int j, int N, int dt, int ld, float scale,
                                       int lane) {
  tile_product(v, qs, ks, i, j, dt, ld, lane);
  const int g = lane >> 2, t4 = lane & 3, r0 = i * 16 + g, r1 = r0 + 8;
  const float* brow0 = bias_h + static_cast<long long>(min(r0, N - 1)) * N;
  const float* brow1 = bias_h + static_cast<long long>(min(r1, N - 1)) * N;
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = j * 16 + t * 8 + 2 * t4 + e;
      float v0 = -INFINITY, v1 = -INFINITY;
      if (c < N) {
        v0 = r0 < N ? __fadd_rn(__fmul_rn(v[t][e], scale), brow0[c]) : 0.0f;
        v1 = r1 < N ? __fadd_rn(__fmul_rn(v[t][2 + e], scale), brow1[c]) : 0.0f;
      }
      v[t][e] = v0;
      v[t][2 + e] = v1;
    }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The row max and sum of query tile i's two rows held by this thread (its
// quad's), over every key tile: two walks.
__device__ __forceinline__ void row_stats(float (&m)[2], float (&l)[2], const __nv_bfloat16* qs,
                                          const __nv_bfloat16* ks, const float* bias_h, int i,
                                          int N, int kt, int dt, int ld, float scale, int lane) {
  m[0] = m[1] = -INFINITY;
#pragma unroll 1
  for (int j = 0; j < kt; ++j) {
    float v[2][4];
    scores(v, qs, ks, bias_h, i, j, N, dt, ld, scale, lane);
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        m[0] = fmaxf(m[0], v[t][e]);
        m[1] = fmaxf(m[1], v[t][2 + e]);
      }
  }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
  l[0] = l[1] = 0.0f;
#pragma unroll 1
  for (int j = 0; j < kt; ++j) {
    float v[2][4];
    scores(v, qs, ks, bias_h, i, j, N, dt, ld, scale, lane);
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        l[0] += expf(__fsub_rn(v[t][e], m[0]));
        l[1] += expf(__fsub_rn(v[t][2 + e], m[1]));
      }
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
}

// The f32 probabilities of tile (i, j) from the scores and the row stats.
__device__ __forceinline__ void probs(float (&p)[2][4], const float (&m)[2], const float (&l)[2],
                                      const float (&inv)[2]) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      p[t][e] = quotient(expf(__fsub_rn(p[t][e], m[0])), l[0], inv[0]);
      p[t][2 + e] = quotient(expf(__fsub_rn(p[t][2 + e], m[1])), l[1], inv[1]);
    }
}

// A 16x16 accumulator tile (rows x columns) as the bf16 A fragment of the
// same tile, and of its transpose.
__device__ __forceinline__ void as_a(uint32_t (&a)[4], const float (&x)[2][4]) {
  a[0] = pack_bf16(x[0][0], x[0][1]);
  a[1] = pack_bf16(x[0][2], x[0][3]);
  a[2] = pack_bf16(x[1][0], x[1][1]);
  a[3] = pack_bf16(x[1][2], x[1][3]);
}

__device__ __forceinline__ void as_a_trans(uint32_t (&a)[4], const float (&x)[2][4]) {
  uint32_t r[4];
  as_a(r, x);
  a[0] = movmatrix_trans(r[0]);
  a[1] = movmatrix_trans(r[2]);
  a[2] = movmatrix_trans(r[1]);
  a[3] = movmatrix_trans(r[3]);
}

// o[2 DT] += a . rows j*16.. of B ([*][ld], B's columns < 16 dt) through
// ldmatrix.trans: the A fragment times a [16 x d] tile.
template <int DT>
__device__ __forceinline__ void mma_rows(float (&o)[2 * DT][4], const uint32_t (&a)[4],
                                         const __nv_bfloat16* Bm, int j, int dt, int ld,
                                         int lane) {
  const int tile_row = lane & 15, tile_col = (lane >> 4) * 8;
#pragma unroll
  for (int nd = 0; nd < DT; ++nd) {
    if (nd >= dt) continue;
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

template <int DT>
__device__ __forceinline__ void store_tile(__nv_bfloat16* base, long long sr,
                                           const float (&o)[2 * DT][4], int i, int N, int d,
                                           int dt, float mult, bool vec, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < 2 * DT; ++n)
    if (n < 2 * dt) store_pair_rows(base, sr, o[n], i * 16 + g, n * 8 + 2 * t4, N, d, mult, vec);
}

// The zeroed [Np][ld] tiles: rows past N and columns past d stay zero.
__device__ __forceinline__ void zero_smem(unsigned char* smem, int bytes) {
  uint4* z = reinterpret_cast<uint4*>(smem);
  for (int i = threadIdx.x; i < bytes / 16; i += kLongThreads) z[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
}

// DT bounds the 16-wide d tiles (d <= 16 DT); the loops run over dt.
template <int DT>
__global__ void __launch_bounds__(kLongThreads, 1)
    window_attention_long_kernel(View q, View k, View v, const float* __restrict__ bias,
                                 __nv_bfloat16* __restrict__ out, long long o_sb, long long o_sr,
                                 long long o_sh, int N, int heads, int d, float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kt = (N + 15) / 16, dt = (d + 15) / 16, Np = kt * 16, ld = dt * 16 + 8;
  const int tile = Np * ld;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  zero_smem(smem, 3 * tile * 2);
  const View src[3] = {q, k, v};
  load_block(qs, src, b, h, N, d, Np, ld, vec);
  const __nv_bfloat16 *ks = qs + tile, *vs = qs + 2 * tile;
  const float* bias_h = bias + static_cast<long long>(h) * N * N;
  __nv_bfloat16* out_bh = out + b * o_sb + h * o_sh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

#pragma unroll 1
  for (int i = warp; i < kt; i += kLongWarps) {
    float m[2], l[2];
    row_stats(m, l, qs, ks, bias_h, i, N, kt, dt, ld, scale, lane);
    const float inv[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
    float o[2 * DT][4];
    zero<DT>(o);
#pragma unroll 1
    for (int j = 0; j < kt; ++j) {
      float p[2][4];
      scores(p, qs, ks, bias_h, i, j, N, dt, ld, scale, lane);
      probs(p, m, l, inv);
      uint32_t a[4];
      as_a(a, p);
      mma_rows<DT>(o, a, vs, j, dt, ld, lane);
    }
    store_tile<DT>(out_bh, o_sr, o, i, N, d, dt, 1.0f, vec, lane);
  }
}

template <int DT>
__global__ void __launch_bounds__(kLongThreads, 1)
    window_attention_long_bwd_kernel(View q, View k, View v, View dout,
                                     const float* __restrict__ bias,
                                     __nv_bfloat16* __restrict__ dqkv,
                                     long long g_sb, long long g_sr, float* __restrict__ partial,
                                     int B, int N, int heads, int d, int per_head, float scale,
                                     int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kt = (N + 15) / 16, dt = (d + 15) / 16, Np = kt * 16, ld = dt * 16 + 8;
  const int tile = Np * ld;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  const __nv_bfloat16 *ks = qs + tile, *vs = qs + 2 * tile, *dos = qs + 3 * tile;
  float* row_m = reinterpret_cast<float*>(smem + 4 * tile * 2);
  float* row_l = row_m + Np;
  float* row_d = row_l + Np;
  const int h = blockIdx.x / per_head, part = blockIdx.x % per_head;
  const int first = static_cast<int>(static_cast<long long>(part) * B / per_head);
  const int end = static_cast<int>(static_cast<long long>(part + 1) * B / per_head);
  const float* bias_h = bias + static_cast<long long>(h) * N * N;
  float* plane = partial + static_cast<long long>(blockIdx.x) * N * N;
  const long long C = static_cast<long long>(heads) * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const View src[4] = {q, k, v, dout};
  zero_smem(smem, 4 * tile * 2);

#pragma unroll 1
  for (int b = first; b < end; ++b) {
    load_block(qs, src, b, h, N, d, Np, ld, vec);
    __nv_bfloat16* dq = dqkv + b * g_sb + h * d;

    // Row phase: a warp a query tile.
#pragma unroll 1
    for (int i = warp; i < kt; i += kLongWarps) {
      float m[2], l[2];
      row_stats(m, l, qs, ks, bias_h, i, N, kt, dt, ld, scale, lane);
      const float inv[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
      float D[2] = {0.0f, 0.0f};
#pragma unroll 1
      for (int j = 0; j < kt; ++j) {
        float p[2][4], dp[2][4];
        scores(p, qs, ks, bias_h, i, j, N, dt, ld, scale, lane);
        probs(p, m, l, inv);
        tile_product(dp, dos, vs, i, j, dt, ld, lane);
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            D[0] = fmaf(dp[t][e], p[t][e], D[0]);
            D[1] = fmaf(dp[t][2 + e], p[t][2 + e], D[1]);
          }
      }
      D[0] = quad_sum(D[0]);
      D[1] = quad_sum(D[1]);
      if (t4 == 0) {
        row_m[i * 16 + g] = m[0];
        row_m[i * 16 + g + 8] = m[1];
        row_l[i * 16 + g] = l[0];
        row_l[i * 16 + g + 8] = l[1];
        row_d[i * 16 + g] = D[0];
        row_d[i * 16 + g + 8] = D[1];
      }
      float acc[2 * DT][4];
      zero<DT>(acc);
#pragma unroll 1
      for (int j = 0; j < kt; ++j) {
        float p[2][4], dp[2][4];
        scores(p, qs, ks, bias_h, i, j, N, dt, ld, scale, lane);
        probs(p, m, l, inv);
        tile_product(dp, dos, vs, i, j, dt, ld, lane);
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[t][e] = __fmul_rn(p[t][e], __fsub_rn(dp[t][e], D[e / 2]));
        uint32_t a[4];
        as_a(a, p);
        mma_rows<DT>(acc, a, ks, j, dt, ld, lane);
      }
      store_tile<DT>(dq, g_sr, acc, i, N, d, dt, scale, vec, lane);
    }
    __syncthreads();  // the row statistics are in shared memory

    // Column phase: a warp a key tile j, over the query tiles i.
#pragma unroll 1
    for (int j = warp; j < kt; j += kLongWarps) {
      float acc[2 * DT][4];
      for (int pass = 0; pass < 2; ++pass) {  // dv, then dk and dbias
        zero<DT>(acc);
#pragma unroll 1
        for (int i = 0; i < kt; ++i) {
          const int r0 = i * 16 + g, r1 = r0 + 8;
          const float m[2] = {row_m[r0], row_m[r1]}, l[2] = {row_l[r0], row_l[r1]};
          const float inv[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
          float p[2][4];
          scores(p, qs, ks, bias_h, i, j, N, dt, ld, scale, lane);
          probs(p, m, l, inv);
          uint32_t a[4];
          if (pass == 0) {
            as_a_trans(a, p);
            mma_rows<DT>(acc, a, dos, i, dt, ld, lane);
            continue;
          }
          float dp[2][4];
          tile_product(dp, dos, vs, i, j, dt, ld, lane);
          const float D[2] = {row_d[r0], row_d[r1]};
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) p[t][e] = __fmul_rn(p[t][e], __fsub_rn(dp[t][e], D[e / 2]));
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e < 2 ? r0 : r1, c = j * 16 + t * 8 + 2 * t4 + (e & 1);
              if (r >= N || c >= N) continue;
              float* cell = plane + r * N + c;
              *cell = b == first ? p[t][e] : __fadd_rn(*cell, p[t][e]);
            }
          as_a_trans(a, p);
          mma_rows<DT>(acc, a, qs, i, dt, ld, lane);
        }
        if (pass == 0)
          store_tile<DT>(dqkv + b * g_sb + 2 * C + h * d, g_sr, acc, j, N, d, dt, 1.0f, vec, lane);
        else
          store_tile<DT>(dqkv + b * g_sb + C + h * d, g_sr, acc, j, N, d, dt, scale, vec, lane);
      }
    }
    __syncthreads();  // the window's tiles are free for the next
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

bool long_sizes(int N, int heads, int d) {
  return N >= kLongMin && N <= kLongMax && heads >= 1 && d >= 1 && d <= 128;
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// The forward's launch plan: {blocks, threads a block, shared memory bytes}.
// Returns a cudaError_t: 0, or cudaErrorInvalidValue (and zeros) when the
// shape is out of range or the window does not fit a block.
extern "C" int dfd_window_attention_long_plan(int B, int N, int heads, int d, int* plan) {
  for (int i = 0; i < 3; ++i) plan[i] = 0;
  if (B < 1 || !long_sizes(N, heads, d) || long_fwd_smem(N, d) > kMaxSmemBytes ||
      static_cast<long long>(B) * heads > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  plan[0] = B * heads;
  plan[1] = kLongThreads;
  plan[2] = long_fwd_smem(N, d);
  return cudaSuccess;
}

// The backward's launch plan on a card of `sms` SMs: {blocks a head, threads
// a block, shared memory bytes}; as dfd_window_attention_long_plan.
extern "C" int dfd_window_attention_long_bwd_plan(int B, int N, int heads, int d, int sms,
                                                  int* plan) {
  for (int i = 0; i < 3; ++i) plan[i] = 0;
  if (B < 1 || sms < 1 || !long_sizes(N, heads, d) || long_bwd_smem(N, d) > kMaxSmemBytes)
    return cudaErrorInvalidValue;
  const int fill = sms / heads;
  plan[0] = fill < 1 ? 1 : (fill < B ? fill : B);
  plan[1] = kLongThreads;
  plan[2] = long_bwd_smem(N, d);
  return cudaSuccess;
}

// The forward: arguments as dfd_window_attention's (less the SM count).
extern "C" int dfd_window_attention_long(const void* q, const void* k, const void* v,
                                         const void* bias, void* out, int B, int N, int heads,
                                         int d, long long q_sb, long long q_sr, long long q_sh,
                                         long long k_sb, long long k_sr, long long k_sh,
                                         long long v_sb, long long v_sr, long long v_sh,
                                         long long o_sb, long long o_sr, long long o_sh,
                                         float scale, int vec, void* stream) {
  int plan[3];
  if (dfd_window_attention_long_plan(B, N, heads, d, plan) != 0) return cudaErrorInvalidValue;
  const View qv{static_cast<const __nv_bfloat16*>(q), q_sb, q_sr, q_sh};
  const View kv{static_cast<const __nv_bfloat16*>(k), k_sb, k_sr, k_sh};
  const View vv{static_cast<const __nv_bfloat16*>(v), v_sb, v_sr, v_sh};
  const float* bs = static_cast<const float*>(bias);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = window_attention_long_kernel<8>;
  if (d <= 64) kernel = window_attention_long_kernel<4>;
  cudaError_t e = set_smem(kernel, plan[2]);
  if (e != cudaSuccess) return e;
  kernel<<<plan[0], plan[1], plan[2], st>>>(qv, kv, vv, bs, o, o_sb, o_sr, o_sh, N, heads, d,
                                            scale, vec);
  return static_cast<int>(cudaGetLastError());
}

// The backward: arguments as dfd_window_attention_bwd's.
extern "C" int dfd_window_attention_long_bwd(const void* qkv, const void* dout, const void* bias,
                                             void* dqkv, void* partial, long long planes,
                                             void* dbias, int B, int N, int heads, int d,
                                             long long qkv_sb, long long qkv_sr, long long do_sb,
                                             long long do_sr, int sms, float scale, int vec,
                                             void* stream) {
  int plan[3];
  if (dfd_window_attention_long_bwd_plan(B, N, heads, d, sms, plan) != 0 ||
      static_cast<long long>(heads) * plan[0] > planes)
    return cudaErrorInvalidValue;
  const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(qkv);
  const long long C = static_cast<long long>(heads) * d;
  const View qv{base, qkv_sb, qkv_sr, d};
  const View kv{base + C, qkv_sb, qkv_sr, d};
  const View vv{base + 2 * C, qkv_sb, qkv_sr, d};
  const View dv{static_cast<const __nv_bfloat16*>(dout), do_sb, do_sr, d};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = window_attention_long_bwd_kernel<8>;
  if (d <= 64) kernel = window_attention_long_bwd_kernel<4>;
  cudaError_t e = set_smem(kernel, plan[2]);
  if (e != cudaSuccess) return e;
  float* part = static_cast<float*>(partial);
  kernel<<<heads * plan[0], plan[1], plan[2], st>>>(
      qv, kv, vv, dv, static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(dqkv),
      N * 3 * C, 3 * C, part, B, N, heads, d, plan[0], scale, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long plane = static_cast<long long>(N) * N, total = heads * plane;
  const int threads = 256;
  long_dbias_reduce_kernel<<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0,
                             st>>>(part, static_cast<float*>(dbias), plan[0], plane, total);
  return static_cast<int>(cudaGetLastError());
}
