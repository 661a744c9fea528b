// K6 backward: the gradients of FasterViT's fused attention sub-block
// (attn_block.cu) with respect to x, both Linears' weights and biases, and
// the per-head bias.
//
// Replaces: deepfakedetection_tpu/ops/pallas/attn_block.py, _bwd_call
//   (:202, kernel _bwd_kernel :78), the backward of the attn_subblock
//   custom_vjp.
// Contract: as the forward (attn_block.cu) plus dout [B, N, C] bf16, wprojT
//   = Wproj^T and wqkvT = Wqkv^T as contiguous bf16 [C, C] and [C, 3C].
//   Outputs, as _bwd_kernel computes them:
//     dctx   = bf16(dout . Wproj, f32 sums)
//     qkv, p = recomputed as the forward does; ctx = bf16(bf16(p) . v)
//     dqkv   = the attention backward of sliced_head_attention_bwd
//              (window_attn.py:179; the K5 backward's arithmetic, with dbias
//              the sum over windows of the f32 ds)
//     dx     = bf16(dqkv . Wqkv, f32 sums), skipped when dx is null
//     dWqkv  = dqkv^T . x, dbqkv = column sums of dqkv,
//     dWproj = dout^T . ctx, dbproj = column sums of dout, all f32 over
//              every row of every window, in the Linears' [out, in] layout.
// Bound on the H100: HBM bytes at the FasterViT-2 fine-tune shapes, if
//   barely: per window row x, dout and dx move 6 C bytes for ~2 (3C + C) C
//   flops of the three weight-sized products, the attention's and the qkv
//   recompute's; the bound counts each input and output once.
// Design. The TPU kernel keeps dW, db and dbias in VMEM across a sequential
//   grid; Hopper's blocks run in no order, so the backward is five launches
//   on one stream, and every sum across blocks is written as per-block
//   partials that a last kernel adds in a fixed order: no float atomics, so
//   two runs give bit-identical gradients.
//   1. dctx = dout . Wproj (gemm_nt_kernel: 64x64 output tiles, 4 warps of
//      mma.sync m16n8k16, 32-deep k steps staged through shared memory).
//   2. window_bwd_kernel: one block of 8 warps per group of windows. Per
//      window it stages x in shared memory; per head it recomputes q, k, v
//      into shared memory (qkv_head, as the forward), stages the head's dctx
//      columns, and runs K5's backward on them (attn_block_common.cuh): a
//      row pass (each warp on 16-query-row tiles: scores, softmax, ctx = p v,
//      dp = do v^T, the row term, ds, dq = ds k) and a column pass
//      (dv = p^T do, dk = ds^T q from bf16 p and ds in shared memory). qkv
//      and p never reach device memory; dqkv and ctx do (bf16), for the
//      weight gradients. Each thread adds its ds elements into the group's
//      dbias partial in device memory, window by window: it alone owns them.
//   3. dx = dqkv . Wqkv (gemm_nt_kernel), when x needs a gradient.
//   4. wgrad_kernel, for (dqkv, x) and (dout, ctx): 64x64 tiles of G^T X over
//      a fixed chunk of rows, G and X staged 32 rows at a time, the mma
//      operands read transposed from shared memory; the blocks of the first
//      column tile also sum G's columns over their rows, in row order.
//   5. sum_partials_kernel, per gradient: the partials summed in order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attn_block_common.cuh"

namespace {

constexpr int kTile = 64;   // output tile of the two GEMM kernels
constexpr int kSteps = 32;  // rows (wgrad) or k columns (gemm_nt) staged at a time
constexpr int kGemmThreads = 128;

__host__ __device__ constexpr size_t bwd_smem_bytes(int Np, int Cp, int Dp) {
  // x (row stride Cp + 8); q, k, v, do of one head (row stride Dp + 8);
  // bf16 p and ds (row stride Np + 8)
  return (static_cast<size_t>(Np) * (Cp + 8) + 4 * static_cast<size_t>(Np) * (Dp + 8) +
          2 * static_cast<size_t>(Np) * (Np + 8)) *
         sizeof(__nv_bfloat16);
}

// Stages a rows x 32 block of a row-major bf16 matrix (row stride lds) into
// dst (row stride kSteps + 8 or kTile + 8 = ldd), zero outside [0, rows_valid)
// x [0, cols_valid). vec promises 16-byte aligned rows and 8-element chunks.
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, int ldd, const __nv_bfloat16* src,
                                           long long lds, int rows, int cols, int rows_valid,
                                           int cols_valid, bool vec) {
  if (vec) {
    const int chunks = cols / 8;
    for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
      const int r = i / chunks, c = i % chunks * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < rows_valid && c < cols_valid)
        v = *reinterpret_cast<const uint4*>(src + r * lds + c);
      *reinterpret_cast<uint4*>(dst + r * ldd + c) = v;
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const int r = i / cols, c = i % cols;
      dst[r * ldd + c] = r < rows_valid && c < cols_valid ? src[r * lds + c]
                                                            : __float2bfloat16(0.0f);
    }
  }
}

// out [M, Nn] = bf16(A [M, K] . Bt [Nn, K]^T, f32 sums): one 64x64 tile a
// block, warps in 2x2 of 32x32. vec promises K % 8 == 0, lda and ldb % 8 ==
// 0 and 16-byte aligned A and Bt; pair promises Nn even and out 4-byte
// aligned.
__global__ void __launch_bounds__(kGemmThreads)
    gemm_nt_kernel(const __nv_bfloat16* __restrict__ A, long long lda,
                   const __nv_bfloat16* __restrict__ Bt, long long ldb,
                   __nv_bfloat16* __restrict__ out, int M, int Nn, int K, int vec, int pair) {
  constexpr int ld = kSteps + 8, ldw = ld / 2;
  __shared__ __align__(16) __nv_bfloat16 as[kTile * ld];
  __shared__ __align__(16) __nv_bfloat16 bs[kTile * ld];
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int wm = warp / 2 * 32, wn = warp % 2 * 32;
  float acc[2][4][4] = {};
  const uint32_t* as32 = reinterpret_cast<const uint32_t*>(as);
  const uint32_t* bs32 = reinterpret_cast<const uint32_t*>(bs);
  for (int k0 = 0; k0 < K; k0 += kSteps) {
    __syncthreads();
    stage_tile(as, ld, A + m0 * lda + k0, lda, kTile, kSteps, M - m0, K - k0, vec);
    stage_tile(bs, ld, Bt + n0 * ldb + k0, ldb, kTile, kSteps, Nn - n0, K - k0, vec);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSteps / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t* ap = as32 + (wm + i * 16 + g) * ldw + kk * 8 + t4;
        a[i][0] = ap[0];
        a[i][1] = ap[8 * ldw];
        a[i][2] = ap[4];
        a[i][3] = ap[8 * ldw + 4];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t* bp = bs32 + (wn + j * 8 + g) * ldw + kk * 8 + t4;
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_bf16_16816(acc[i][j], a[i], bp[0], bp[4]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + wm + i * 16 + g + 8 * half, c = n0 + wn + j * 8 + 2 * t4;
        if (r >= M || c >= Nn) continue;
        __nv_bfloat16* dst = out + static_cast<long long>(r) * Nn + c;
        if (pair) {
          *reinterpret_cast<uint32_t*>(dst) = pack_bf16(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
        } else {
          dst[0] = __float2bfloat16_rn(acc[i][j][2 * half]);
          if (c + 1 < Nn) dst[1] = __float2bfloat16_rn(acc[i][j][2 * half + 1]);
        }
      }
}

// partial[s] = (G^T X [F, K] row-major, then the column sums of G [F]) over
// rows [s * chunk, min(M, (s + 1) * chunk)) of G [M, F] and X [M, K] (row
// strides ldg, ldx): one 64x64 tile of G^T X a block, warps in 2x2 of 32x32;
// the blocks of column tile 0 also sum G's 64 columns, each thread one
// column, row by row. vec promises 8-element chunks and 16-byte aligned rows
// of both.
__global__ void __launch_bounds__(kGemmThreads)
    wgrad_kernel(const __nv_bfloat16* __restrict__ G, long long ldg,
                 const __nv_bfloat16* __restrict__ X, long long ldx, float* __restrict__ partial,
                 int M, int F, int K, int chunk, int vec) {
  constexpr int ld = kTile + 8;
  __shared__ __align__(16) __nv_bfloat16 gs[kSteps * ld];
  __shared__ __align__(16) __nv_bfloat16 xs[kSteps * ld];
  const int ktiles = (K + kTile - 1) / kTile;
  const int f0 = blockIdx.x / ktiles * kTile, k0 = blockIdx.x % ktiles * kTile;
  const int split = blockIdx.y, m_begin = split * chunk, m_end = min(M, m_begin + chunk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int wf = warp / 2 * 32, wk = warp % 2 * 32;
  const bool sums = k0 == 0 && threadIdx.x < kTile;
  float acc[2][4][4] = {};
  float colsum = 0.0f;
  for (int m0 = m_begin; m0 < m_end; m0 += kSteps) {
    __syncthreads();
    stage_tile(gs, ld, G + m0 * ldg + f0, ldg, kSteps, kTile, m_end - m0, F - f0, vec);
    stage_tile(xs, ld, X + m0 * ldx + k0, ldx, kSteps, kTile, m_end - m0, K - k0, vec);
    __syncthreads();
    if (sums)
      for (int r = 0; r < kSteps; ++r)
        colsum = __fadd_rn(colsum, __bfloat162float(gs[r * ld + threadIdx.x]));
#pragma unroll
    for (int kk = 0; kk < kSteps / 16; ++kk) {
      const int r = kk * 16 + 2 * t4;  // this lane's first row of the 16
      // A[f][m] = G[m][f]: pairs along m, read down the staged columns
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const __nv_bfloat16* gp = gs + r * ld + wf + i * 16 + g;
        a[i][0] = pack_raw(gp[0], gp[ld]);
        a[i][1] = pack_raw(gp[8], gp[ld + 8]);
        a[i][2] = pack_raw(gp[8 * ld], gp[9 * ld]);
        a[i][3] = pack_raw(gp[8 * ld + 8], gp[9 * ld + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // B[m][k] = X[m][k]
        const __nv_bfloat16* xp = xs + r * ld + wk + j * 8 + g;
        const uint32_t b0 = pack_raw(xp[0], xp[ld]), b1 = pack_raw(xp[8 * ld], xp[9 * ld]);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_bf16_16816(acc[i][j], a[i], b0, b1);
      }
    }
  }
  float* part = partial + static_cast<long long>(split) * (static_cast<long long>(F) * K + F);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = f0 + wf + i * 16 + g + 8 * (e / 2), k = k0 + wk + j * 8 + 2 * t4 + e % 2;
        if (f < F && k < K) part[static_cast<long long>(f) * K + k] = acc[i][j][e];
      }
  if (sums && f0 + static_cast<int>(threadIdx.x) < F)
    part[static_cast<long long>(F) * K + f0 + threadIdx.x] = colsum;
}

// out[i] = the sum over s = 0, 1, ... of partial[s * plane + i], in order.
__global__ void sum_partials_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                    int parts, long long plane) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= plane) return;
  float sum = 0.0f;
  for (int s = 0; s < parts; ++s) sum = __fadd_rn(sum, partial[s * plane + i]);
  out[i] = sum;
}

// KT bounds the 16-token tiles (N <= 16 KT), DT the 16-wide head tiles
// (d <= 16 DT); the loops run over the actual counts, kt and dt.
template <int KT, int DT>
__global__ void __launch_bounds__(kBlockWarps * 32)
    window_bwd_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wqkv,
                      const float* __restrict__ bqkv, const float* __restrict__ bias,
                      const __nv_bfloat16* __restrict__ dctx, __nv_bfloat16* __restrict__ ctx,
                      __nv_bfloat16* __restrict__ dqkv, float* __restrict__ partial, int B, int N,
                      int C, int heads, int per_block, float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = C / heads, kt = (N + 15) / 16, dt = (d + 15) / 16;
  const int Np = kt * 16, Dp = dt * 16, Cp = pad16(C), ldx = Cp + 8, ld = Dp + 8, ldp = Np + 8;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* qs = xs + Np * ldx;
  __nv_bfloat16* ks = qs + Np * ld;
  __nv_bfloat16* vs = ks + Np * ld;
  __nv_bfloat16* dos = vs + Np * ld;  // the head's dctx columns
  __nv_bfloat16* ps = dos + Np * ld;  // bf16(p)
  __nv_bfloat16* gs = ps + Np * ldp;  // bf16(ds)
  const int grp = blockIdx.x, b_first = grp * per_block, b_end = min(B, b_first + per_block);
  const bool pair = C % 2 == 0 && d % 2 == 0;
  const bool vec_d = vec && d % 8 == 0;  // 16-byte loads of one head's dctx columns
  const int warp = threadIdx.x / 32;

  for (int b = b_first; b < b_end; ++b) {
    const long long row0 = static_cast<long long>(b) * N;
    __syncthreads();  // the previous window's column pass is done with the buffers
    stage(xs, x + row0 * C, C, N, C, Np, Cp, ldx, vec);
    for (int hh = 0; hh < heads; ++hh) {
      __syncthreads();  // x staged; the previous head's column pass is done
      qkv_head<KT>(qs, ks, vs, ld, xs, ldx, wqkv, bqkv, hh, heads, N, kt, Dp, Cp);
      stage(dos, dctx + row0 * C + hh * d, C, N, d, Np, Dp, ld, vec_d);
      __syncthreads();
      const float* bias_h = bias + static_cast<long long>(hh) * N * N;
      float* part = partial + (static_cast<long long>(grp) * heads + hh) * N * N;
      __nv_bfloat16* dq = dqkv + row0 * 3 * C + hh * d;
      const auto add_dbias = [part, N, first = b == b_first](int r, int c, float v) {
        if (r < N && c < N) {
          float* q = part + r * N + c;
          *q = first ? v : __fadd_rn(*q, v);
        }
      };

      // row pass: 16 query rows per warp and tile (ctx, then K5's row pass)
      for (int mt = warp; mt < kt; mt += kBlockWarps) {
        float p[2 * KT][4];
        head_probs<KT, DT>(p, qs, ks, ld, mt, kt, dt, bias_h, N, scale);
        probs_times_v<KT, DT>(p, vs, ld, mt, kt, dt, ctx + row0 * C + hh * d, C, N, d, pair);
        head_bwd_rows<KT, DT>(p, dos, vs, ks, ld, ps, gs, ldp, mt, kt, dt, N, d, scale, dq,
                              3 * C, pair, add_dbias);
      }
      __syncthreads();

      // column pass: dv = bf16(p)^T do and dk = bf16(ds)^T q * scale, one
      // 16-key-row tile of one of them per warp
      for (int item = warp; item < 2 * kt; item += kBlockWarps) {
        const int which = item / kt;
        head_bwd_cols<KT, DT>(which ? gs : ps, ldp, which ? qs : dos, ld, item % kt * 16, kt,
                              dt, dq + (which ? C : 2 * C), 3 * C, N, d, which ? scale : 1.0f,
                              pair);
      }
    }
  }
}

cudaError_t gemm_nt(const __nv_bfloat16* A, long long lda, const __nv_bfloat16* Bt, long long ldb,
                    __nv_bfloat16* out, int M, int Nn, int K, cudaStream_t stream) {
  const bool vec = K % 8 == 0 && lda % 8 == 0 && ldb % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(Bt) % 16 == 0;
  const bool pair = Nn % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
  const dim3 grid((Nn + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  gemm_nt_kernel<<<grid, kGemmThreads, 0, stream>>>(A, lda, Bt, ldb, out, M, Nn, K, vec, pair);
  return cudaGetLastError();
}

// The weight gradient of one Linear: G^T X and G's column sums over M rows
// into out [F * K + F], through `splits` partials (out itself when 1).
cudaError_t wgrad(const __nv_bfloat16* G, long long ldg, const __nv_bfloat16* X, long long ldx,
                  float* partial, float* out, int M, int F, int K, int splits,
                  cudaStream_t stream) {
  const bool vec = F % 8 == 0 && K % 8 == 0 && ldg % 8 == 0 && ldx % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(G) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(X) % 16 == 0;
  const int chunk = ((M + splits - 1) / splits + kSteps - 1) / kSteps * kSteps;
  const int tiles = ((F + kTile - 1) / kTile) * ((K + kTile - 1) / kTile);
  float* dst = splits == 1 ? out : partial;
  wgrad_kernel<<<dim3(tiles, splits), kGemmThreads, 0, stream>>>(G, ldg, X, ldx, dst, M, F, K,
                                                                 chunk, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const long long plane = static_cast<long long>(F) * K + F;
  sum_partials_kernel<<<static_cast<unsigned>((plane + 255) / 256), 256, 0, stream>>>(
      partial, out, splits, plane);
  return cudaGetLastError();
}

template <int KT, int DT>
cudaError_t launch_window(const __nv_bfloat16* x, const __nv_bfloat16* wqkv, const float* bqkv,
                          const float* bias, const __nv_bfloat16* dctx, __nv_bfloat16* ctx,
                          __nv_bfloat16* dqkv, float* partial, int B, int N, int C, int heads,
                          int per_block, float scale, int vec, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(pad16(N), pad16(C), pad16(C / heads));
  if (smem > static_cast<size_t>(kMaxSmemBytes)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(window_bwd_kernel<KT, DT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int groups = (B + per_block - 1) / per_block;
  window_bwd_kernel<KT, DT><<<groups, kBlockWarps * 32, smem, stream>>>(
      x, wqkv, bqkv, bias, dctx, ctx, dqkv, partial, B, N, C, heads, per_block, scale, vec);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: 0 on success. x, wqkv, bqkv, bias as the forward
// takes them (dfd_attn_subblock); wprojT [C, C] and wqkvT [C, 3C] bf16; dout
// [B, N, C] bf16. Scratch: dctx and ctx [B, N, C] bf16, dqkv [B, N, 3C] bf16,
// dbias_part [ceil(B / per_block), heads, N, N] f32, wpart_qkv [splits_qkv,
// 3C * C + 3C] and wpart_proj [splits_proj, C * C + C] f32 (unused when the
// split is 1). Outputs: dx [B, N, C] bf16 (null: skipped), dbias [heads, N,
// N], gqkv [3C * C + 3C] (dWqkv then dbqkv) and gproj [C * C + C] (dWproj
// then dbproj), f32. vec = 1 promises C % 8 == 0 and 16-byte aligned x,
// dout and the bf16 scratch.
extern "C" int dfd_attn_subblock_bwd(
    const void* x, const void* wqkv, const void* bqkv, const void* bias, const void* wprojT,
    const void* wqkvT, const void* dout, void* dctx, void* ctx, void* dqkv, void* dbias_part,
    void* wpart_qkv, void* wpart_proj, void* dx, void* dbias, void* gqkv, void* gproj, int B,
    int N, int C, int heads, int per_block, int splits_qkv, int splits_proj, float scale, int vec,
    void* stream) {
  if (B < 1 || N < 1 || N > 128 || heads < 1 || C < heads || C % heads || C / heads > 128 ||
      per_block < 1 || splits_qkv < 1 || splits_proj < 1 ||
      static_cast<long long>(B) * N * 3 * C > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  const auto* xp = static_cast<const bf*>(x);
  const auto* dop = static_cast<const bf*>(dout);
  auto* dctxp = static_cast<bf*>(dctx);
  auto* ctxp = static_cast<bf*>(ctx);
  auto* dqkvp = static_cast<bf*>(dqkv);
  auto* part = static_cast<float*>(dbias_part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * N;

  cudaError_t e = gemm_nt(dop, C, static_cast<const bf*>(wprojT), C, dctxp, M, C, C, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  const auto* wq = static_cast<const bf*>(wqkv);
  const auto* bq = static_cast<const float*>(bqkv);
  const auto* bs = static_cast<const float*>(bias);
  const bool small_n = N <= 64, small_d = C / heads <= 64;
  if (small_n && small_d)
    e = launch_window<4, 4>(xp, wq, bq, bs, dctxp, ctxp, dqkvp, part, B, N, C, heads, per_block,
                            scale, vec, st);
  else if (small_n)
    e = launch_window<4, 8>(xp, wq, bq, bs, dctxp, ctxp, dqkvp, part, B, N, C, heads, per_block,
                            scale, vec, st);
  else if (small_d)
    e = launch_window<8, 4>(xp, wq, bq, bs, dctxp, ctxp, dqkvp, part, B, N, C, heads, per_block,
                            scale, vec, st);
  else
    e = launch_window<8, 8>(xp, wq, bq, bs, dctxp, ctxp, dqkvp, part, B, N, C, heads, per_block,
                            scale, vec, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long plane = static_cast<long long>(heads) * N * N;
  sum_partials_kernel<<<static_cast<unsigned>((plane + 255) / 256), 256, 0, st>>>(
      part, static_cast<float*>(dbias), (B + per_block - 1) / per_block, plane);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);

  if (dx != nullptr) {
    e = gemm_nt(dqkvp, 3 * C, static_cast<const bf*>(wqkvT), 3 * C, static_cast<bf*>(dx), M, C,
                3 * C, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  e = wgrad(dqkvp, 3 * C, xp, C, static_cast<float*>(wpart_qkv), static_cast<float*>(gqkv), M,
            3 * C, C, splits_qkv, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(wgrad(dop, C, ctxp, C, static_cast<float*>(wpart_proj),
                                static_cast<float*>(gproj), M, C, C, splits_proj, st));
}
