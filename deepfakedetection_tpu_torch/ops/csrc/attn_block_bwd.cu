// K6 backward: the gradients of FasterViT's fused attention sub-block
// (attn_block.cu) with respect to x, both Linears' weights and biases, and
// the per-head bias.
//
// Replaces: deepfakedetection_tpu/ops/pallas/attn_block.py, _bwd_call
//   (:202, kernel _bwd_kernel :78), the backward of the attn_subblock
//   custom_vjp.
// Contract: x [B, N, C] and dout [B, N, C] bf16, rows ldx and ldo elements
//   apart (multiples of 8, 16-byte aligned: the wrapper pads x and dout to
//   C rounded up to 16 where C % 8 != 0); wqkv, bqkv, bias and wproj as the
//   forward takes them (wqkv [3, heads, Dp, Cp], bqkv [3, heads, Dp], wproj
//   [Cp, Cp]). Outputs, as _bwd_kernel computes them:
//     dctx   = bf16(dout . Wproj, f32 sums)
//     qkv, p = recomputed as the forward does; ctx = bf16(bf16(p) . v)
//     dqkv   = the attention backward of sliced_head_attention_bwd
//              (window_attn.py:179; the K5 backward's arithmetic, with dbias
//              the sum over windows of the f32 ds)
//     dx     = bf16(dqkv . Wqkv, f32 sums), skipped when dx is null
//     dWqkv  = dqkv^T . x, dbqkv = column sums of dqkv,
//     dWproj = dout^T . ctx, dbproj = column sums of dout, all f32 over
//              every row of every window, in the Linears' [out, in] layout.
//   N <= 128, d = C / heads <= 128, and the plan below within a block's
//   227 KB.
// Bound on the H100: tensor-core operations at the FasterViT-2 fine-tune
//   shapes: per window row, 22 C^2 flops of the five weight-sized products
//   (the qkv recompute 6, dctx 2, dx 6, dWqkv 6, dWproj 2) and 12 N C of the
//   attention's six products, for 6 C bytes of x, dout and dx.
//
// Design (one launch of the C entry point is five kernels on one stream;
// no float atomics, every sum across blocks in a fixed order, so two runs
// give bit-identical gradients):
//  1. dctx = dout . Wproj: gemm_tma.cuh's TMA-ring wgmma GEMM, Wproj read in
//     its stored [out, in] layout as an MN-major B operand.
//  2. window_bwd_kernel (attn_block_bwd.cuh): clusters of 2 blocks of two
//     consumer warpgroups and a producer warpgroup (its registers moved to
//     the consumers by setmaxnreg: 232 a consumer thread, where nine warps
//     could have 168 and the attention spilled). The grid runs over (window
//     group, head group): a block takes G whole windows (their G N token rows
//     packed as the M rows of the qkv product, as the forward) and one group
//     of HG heads, so that stage 4's 128 windows still fill the card. It
//     stages x once (swizzled for wgmma) and recomputes the group's q, k and
//     v as the forward does: one producer warp streams the group's Wqkv rows
//     through an mbarrier ring of
//     TMA loads, each block loading half of every granule multicast to both,
//     so each tile read from L2 serves both blocks' rows; wgmma m64nNTk16
//     with both operands in shared memory; + bqkv in f32, one rounding. Then
//     the ring's and x's shared memory take the group's dctx columns
//     (cp.async), its bias tables where the plan has room, and bf16 p and ds.
//     The 8 consumer warps run K5's backward over (window, head, 16-row query
//     tile) items (head_probs, probs_times_v for ctx, head_bwd_rows: dp, the
//     row term, ds, dq), then over (window, head, 16-key tile, dv or dk)
//     items (head_bwd_cols). ctx and dqkv go out in bf16; each window's f32
//     ds goes out as its dbias partial (plain stores, one owner an element).
//  3. dx = dqkv . Wqkv: the GEMM, Wqkv as an MN-major B (dqkv in the padded
//     [3, heads, Dp] column layout of wqkv's rows).
//  4. dWqkv and dWproj: one GEMM launch over both problems, A = dqkv^T or
//     dout^T read MN-major (transposed by the wgmma, not in memory), B = x or
//     ctx read MN-major; the rows split into fixed chunks of a multiple of
//     64; the first column tile's blocks also sum A's rows (dbqkv, dbproj).
//  5. sum_partials_kernel: dbias over the windows' partials and, where the
//     rows were split, the weight gradients over the chunks, in order.
// Plan (bwd_plan below; ops/attn_block.py bwd_plan mirrors it): G the most
//   windows whose rows fill one 64-row warpgroup tile at a 16-row stride (1
//   at N 49-64, 4 at N 16), at most 128 / N; HG the least that gives each of
//   the 8 consumer warps a row-pass item (G HG kt >= 8), else fewer; then the
//   first that fits 227 KB with a ring of three stages, else two: HG from
//   that target down to 1, NT the widest of 192, 144, 128, 64, 48 that cuts
//   the group's 3 HG Dp product columns into whole units (an even count
//   where a stage holds two; 32 last, wasting), bias tables staged, else
//   not, and the most stages up to 8 (a stage is one 64-column tile of each
//   slot's NT weight rows). FasterViT-2, fine-tune batch 128:
//     shape (N, C, heads)       G  HG  NT stages staged rows/read (real) shared memory
//     official (53, 384, 8)    1   2 144      3      1    128 (106)  199,856
//     official (16, 384, 8)    4   2 144      3      1    128 (128)  204,976
//     official (49, 768, 16)   1   2  48      8      1    128 ( 98)  230,656
//     tpu (53, 384, 3)         1   2  64      4      1    128 (106)  218,176
//     tpu (16, 384, 3)         4   2  64      4      1    128 (128)  223,296
//     tpu (49, 768, 6)         1   2  32      4      1    128 ( 98)  228,416
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attn_block_bwd.cuh"
#include "attn_block_common.cuh"
#include "gemm_tma.cuh"
#include "hopper.cuh"

// The window kernel's instances live in attn_block_bwd_w*.cu.
#define DFD_WIDTH(n)                                                                 \
  extern template cudaError_t k6_bwd::launch_window<n>(const CUtensorMap&,           \
                                                       const k6_bwd::Window&,        \
                                                       const k6_bwd::Plan&, cudaStream_t);
DFD_WIDTH(192)
DFD_WIDTH(144)
DFD_WIDTH(128)
DFD_WIDTH(64)
DFD_WIDTH(48)
DFD_WIDTH(32)
#undef DFD_WIDTH

namespace {

using k6_bwd::Plan;

Plan bwd_plan(int B, int N, int C, int heads) {
  const int Cp = pad16(C), Dp = pad16(C / heads), kt = pad16(N) / 16;
  int G = cdiv(64, pad16(N));
  if (kMaxRows / N < G) G = kMaxRows / N;
  if (B < G) G = B;
  for (; G >= 1; --G) {
    const int target = cdiv(8, G * kt) < heads ? cdiv(8, G * kt) : heads;
    for (int need = 3; need >= 2; --need) {
      for (int HG = target; HG >= 1; --HG) {
        for (int NT : kUnits) {
          const int units = 3 * HG * Dp / NT;  // NT 32 may waste, as the last resort
          if (NT != 32 && (units * NT != 3 * HG * Dp || (stage_slots(G * N) == 2 && units % 2)))
            continue;  // whole units, and an even count where a stage holds two
          for (int staged = 1; staged >= 0; --staged) {
            for (int stages = kMaxStages; stages >= need; --stages) {
              const int smem = bwd_smem_bytes(N, Cp, Dp, G, HG, NT, stages, staged);
              if (smem <= kMaxSmemBytes) return {G, HG, NT, stages, staged, smem};
            }
          }
        }
      }
    }
  }
  return {0, 0, 0, 0, 0, 0};
}

// out [M, N] (row stride ld) = bf16 of the GEMM's f32 sums.
struct StoreEpi {
  __nv_bfloat16* __restrict__ out;
  int M, N, ld, pair;
  __device__ __forceinline__ void operator()(int, int row, int c, float v0, float v1) const {
    if (row >= M || c >= N) return;
    __nv_bfloat16* dst = out + static_cast<long long>(row) * ld + c;
    if (pair) {
      *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
    } else {
      dst[0] = __float2bfloat16_rn(v0);
      if (c + 1 < N) dst[1] = __float2bfloat16_rn(v1);
    }
  }
  __device__ void rowsum(int, int, int, float) const {}
};

// The two weight gradients of a row chunk (blockIdx.y) into out + chunk *
// plane: problem 0, dqkv^T x, whose rows are wqkv's padded [3, heads, Dp]
// rows, into the Linear's [3C, C] rows (padding dropped) and its row sums
// into dbqkv after them; problem 1, dout^T ctx [C, C], then dbproj.
struct WgradEpi {
  float* __restrict__ out;
  long long plane;
  int C, heads, d, Dp;
  __device__ __forceinline__ float* base(int prob, int chunk) const {
    return out + chunk * plane + (prob ? 3LL * C * C + 3 * C : 0);
  }
  // the Linear's row of product row f, or -1 for a padding row
  __device__ __forceinline__ int linear_row(int prob, int f) const {
    if (prob) return f < C ? f : -1;
    const int part = f / (heads * Dp), rem = f % (heads * Dp), dc = rem % Dp;
    return part < 3 && dc < d ? part * C + rem / Dp * d + dc : -1;
  }
  __device__ __forceinline__ void operator()(int prob, int f, int c, float v0, float v1) const {
    const int row = linear_row(prob, f);
    if (row < 0 || c >= C) return;
    float* dst = base(prob, blockIdx.y) + static_cast<long long>(row) * C + c;
    if (C % 2 == 0) {
      *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
    } else {
      dst[0] = v0;
      if (c + 1 < C) dst[1] = v1;
    }
  }
  __device__ __forceinline__ void rowsum(int prob, int chunk, int f, float v) const {
    const int row = linear_row(prob, f);
    if (row >= 0) base(prob, chunk)[(prob ? 1LL : 3LL) * C * C + row] = v;
  }
};

// A fixed-order sum: dst[i] = the sum over s of src[s * plane + i].
struct SumJob {
  const float* src;
  float* dst;
  int parts, blocks;  // blocks: of 32 columns
  long long plane;
};

// Each block 32 columns of one job: its 8 warps sum 8 consecutive slices of
// the parts, each in order, then warp 0 adds the 8 slice sums in order.
__global__ void __launch_bounds__(256) sum_partials_kernel(SumJob j0, SumJob j1) {
  __shared__ float slice_sums[8][32];
  const bool second = static_cast<int>(blockIdx.x) >= j0.blocks;
  const SumJob j = second ? j1 : j0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long i = static_cast<long long>(blockIdx.x - (second ? j0.blocks : 0)) * 32 + lane;
  const int per = cdiv(j.parts, 8), s0 = min(j.parts, warp * per), s1 = min(j.parts, s0 + per);
  float sum = 0.0f;
  if (i < j.plane) {
#pragma unroll 4
    for (int s = s0; s < s1; ++s) sum = __fadd_rn(sum, j.src[s * j.plane + i]);
  }
  slice_sums[warp][lane] = sum;
  __syncthreads();
  if (warp == 0 && i < j.plane) {
    for (int w = 1; w < 8; ++w) sum = __fadd_rn(sum, slice_sums[w][lane]);
    j.dst[i] = sum;
  }
}

SumJob sum_job(const float* src, float* dst, int parts, long long plane) {
  return {src, dst, parts, static_cast<int>((plane + 31) / 32), plane};
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// The backward's launch plan for a shape: {windows a block, heads a group,
// weight rows a chunk, ring stages, bias tables staged, shared memory bytes,
// window blocks (whole clusters), head groups}; all zero when the shape does
// not fit. Returns 0, or cudaErrorInvalidValue for a shape the kernel
// refuses.
extern "C" int dfd_attn_subblock_bwd_plan(int B, int N, int C, int heads, int* plan) {
  for (int i = 0; i < 8; ++i) plan[i] = 0;
  if (B < 1 || N < 1 || N > 128 || heads < 1 || C < heads || C % heads || C / heads > 128)
    return cudaErrorInvalidValue;
  const Plan p = bwd_plan(B, N, C, heads);
  if (p.G == 0) return cudaErrorInvalidValue;
  const int out[8] = {p.G,      p.HG,   p.NT, p.stages, p.staged,
                      p.smem,  cdiv(cdiv(B, p.G), kCluster) * kCluster, cdiv(heads, p.HG)};
  for (int i = 0; i < 8; ++i) plan[i] = out[i];
  return 0;
}

// Returns a cudaError_t: 0 on success. x, dout as the contract says; wqkv,
// bqkv, bias and wproj as the forward takes them (dfd_attn_subblock).
// Scratch: dctx and ctx [B N, Cp] bf16, dqkv [B N, 3 heads Dp] bf16 (zero
// where Dp > d, for dx), dbias_part [B, heads, N, N] f32, wpart [splits,
// plane] f32 (unused when splits is 1). Outputs: dx [B, N, C] bf16 (null:
// skipped), dbias [heads, N, N] f32 and grads [plane] f32, plane = 3C C + 3C
// + C C + C: dWqkv, dbqkv, dWproj, dbproj. Every pointer 16-byte aligned.
extern "C" int dfd_attn_subblock_bwd(const void* x, int ldx, const void* wqkv, const void* bqkv,
                                     const void* bias, const void* wproj, const void* dout,
                                     int ldo, void* dctx, void* ctx, void* dqkv, void* dbias_part,
                                     void* wpart, void* dx, void* dbias, void* grads, int B, int N,
                                     int C, int heads, int splits, float scale, void* stream) {
  int plan[8];
  if (dfd_attn_subblock_bwd_plan(B, N, C, heads, plan) != 0 || splits < 1 || ldx < C ||
      ldo < C || ldx % 8 || ldo % 8 || static_cast<long long>(B) * N * 3 * pad16(C) > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const void* const operands[] = {x, wqkv, wproj, dout, dctx, ctx, dqkv};
  for (const void* ptr : operands)
    if (!aligned16(ptr)) return cudaErrorMisalignedAddress;
  const Plan p = {plan[0], plan[1], plan[2], plan[3], plan[4], plan[5]};
  using bf = __nv_bfloat16;
  const int Cp = pad16(C), Dp = pad16(C / heads), F = 3 * heads * Dp, M = B * N;
  const long long plane = 4LL * C * C + 4LL * C;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // K-major operands (x rows, dqkv rows as A; none as B) and MN-major ones
  // (the weights as B in their stored layout; dqkv, dout as A^T; x, ctx as B)
  CUtensorMap wmap, dout_k, wproj_mn, dqkv_k, wqkv_mn, dqkv_mn, x_mn, dout_mn, ctx_mn;
  cudaError_t e = tensor_map(&wmap, wqkv, Cp, F, Cp * 2, kKTile, granule(p.NT, Dp) / kCluster);
  if (e == cudaSuccess) e = operand_map(&dout_k, dout, C, M, ldo, false);
  if (e == cudaSuccess) e = operand_map(&wproj_mn, wproj, C, C, Cp, true);
  if (e == cudaSuccess) e = operand_map(&dqkv_k, dqkv, F, M, F, false);
  if (e == cudaSuccess) e = operand_map(&wqkv_mn, wqkv, C, F, Cp, true);
  if (e == cudaSuccess) e = operand_map(&dqkv_mn, dqkv, F, M, F, true);
  if (e == cudaSuccess) e = operand_map(&x_mn, x, C, M, ldx, true);
  if (e == cudaSuccess) e = operand_map(&dout_mn, dout, C, M, ldo, true);
  if (e == cudaSuccess) e = operand_map(&ctx_mn, ctx, C, M, Cp, true);
  if (e != cudaSuccess) return static_cast<int>(e);

  // 1. dctx = dout . Wproj
  const GemmProblem rows_by_c = {cdiv(M, kGemmTile), cdiv(C, kGemmTile), C, C};
  e = launch_gemm<false, true, false>(dout_k, wproj_mn, dout_k, wproj_mn, rows_by_c, GemmProblem{},
                                      1, StoreEpi{static_cast<bf*>(dctx), M, C, Cp, C % 2 == 0},
                                      st);
  if (e != cudaSuccess) return static_cast<int>(e);

  // 2. the window kernel
  const k6_bwd::Window w = {static_cast<const bf*>(x), ldx, static_cast<const float*>(bqkv),
                            static_cast<const float*>(bias), static_cast<const bf*>(dctx),
                            static_cast<bf*>(ctx), static_cast<bf*>(dqkv),
                            static_cast<float*>(dbias_part), B, N, C, heads, scale};
  switch (p.NT) {
#define DFD_WIDTH(n) \
  case n:            \
    e = k6_bwd::launch_window<n>(wmap, w, p, st); \
    break;
    DFD_WIDTH(192)
    DFD_WIDTH(144)
    DFD_WIDTH(128)
    DFD_WIDTH(64)
    DFD_WIDTH(48)
    DFD_WIDTH(32)
#undef DFD_WIDTH
    default:
      e = cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return static_cast<int>(e);

  // 3. dx = dqkv . Wqkv
  if (dx != nullptr) {
    const GemmProblem rows_by_c_f = {cdiv(M, kGemmTile), cdiv(C, kGemmTile), F, F};
    e = launch_gemm<false, true, false>(dqkv_k, wqkv_mn, dqkv_k, wqkv_mn, rows_by_c_f,
                                        GemmProblem{}, 1,
                                        StoreEpi{static_cast<bf*>(dx), M, C, C, C % 2 == 0}, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }

  // 4. dWqkv, dbqkv, dWproj, dbproj over `splits` chunks of the rows
  const int chunk = cdiv(cdiv(M, splits), kKTile) * kKTile;
  const GemmProblem gq = {cdiv(F, kGemmTile), cdiv(C, kGemmTile), M, chunk};
  const GemmProblem gp = {cdiv(C, kGemmTile), cdiv(C, kGemmTile), M, chunk};
  auto* gout = static_cast<float*>(splits == 1 ? grads : wpart);
  e = launch_gemm<true, true, true>(dqkv_mn, x_mn, dout_mn, ctx_mn, gq, gp, cdiv(M, chunk),
                                    WgradEpi{gout, plane, C, heads, C / heads, Dp}, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  // 5. the fixed-order sums
  const SumJob jb = sum_job(static_cast<const float*>(dbias_part), static_cast<float*>(dbias), B,
                            static_cast<long long>(heads) * N * N);
  const SumJob jw = splits == 1 ? SumJob{nullptr, nullptr, 0, 0, 0}
                                : sum_job(static_cast<const float*>(wpart),
                                          static_cast<float*>(grads), cdiv(M, chunk), plane);
  sum_partials_kernel<<<jb.blocks + jw.blocks, 256, 0, st>>>(jb, jw);
  return static_cast<int>(cudaGetLastError());
}
