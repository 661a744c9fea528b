// K6's GEMM (attn_block.cu's output projection; attn_block_bwd.cu's dctx,
// dx and weight gradients): D = A . B over 128 x 128 output tiles, A [M, K]
// and B [K, N] bf16 in device memory, read by TMA through a 3-stage ring of
// 64-deep tiles, f32 sums in registers, and an epilogue that the caller
// supplies.
//
// A block is two consumer warpgroups (64 output rows each) and a producer
// warp; two blocks fit a SM. Each operand is K-major (K contiguous in memory:
// x or ctx rows, a Linear's [out, in] weight read as B^T) or MN-major (M or N
// contiguous: a weight read in its stored [out, in] layout as B, or an
// activation read as A^T for a weight gradient), which the wgmma transpose
// immediates take as they are: nothing is transposed in memory or by scalar
// loads. K-major tiles are TMA boxes of 64 columns by 128 rows; MN-major
// tiles two boxes of 64 columns (the M or N band) by 64 K rows.
//
// One launch may hold two problems (the two weight gradients): blockIdx.x
// runs over problem 0's tiles, then problem 1's. blockIdx.y splits K into
// chunks of a multiple of 64 (each block sums its chunk; the caller adds the
// chunks' partials in a fixed order), and with SUMS the blocks of the first
// column tile also sum A's rows over their chunk (A^T's columns: a bias
// gradient), in row order. No atomics: two runs give bit-identical results.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kGemmTile = 128;             // output tile rows and columns
constexpr int kGemmStages = 3;             // two blocks a SM
constexpr int kGemmTileBytes = kGemmTile * kRowBytes;  // one operand of a stage
constexpr int kGemmSmem = kAlign + kGemmStages * 2 * kGemmTileBytes + 2 * kGemmStages * 8 +
                          kGemmTile * 4;  // + the row sums' exchange

// One problem of a launch: its output tiles (m_tiles x n_tiles, row-major),
// its contraction length K and the K chunk of a blockIdx.y.
struct GemmProblem {
  int m_tiles, n_tiles, K, chunk;
};

// TA: A is MN-major (A^T's rows in memory); TB: B is MN-major ([K, N] rows).
// Epi: __device__ void operator()(int problem, int row, int col, float v0,
// float v1) for output columns col and col + 1 of a row (an even col), and,
// with SUMS, rowsum(int problem, int split, int row, float sum) for each of
// the first column tile's 128 rows.
template <bool TA, bool TB, bool SUMS, class Epi>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_kernel(const __grid_constant__ CUtensorMap a0, const __grid_constant__ CUtensorMap b0,
                const __grid_constant__ CUtensorMap a1, const __grid_constant__ CUtensorMap b1,
                GemmProblem p0, GemmProblem p1, Epi epi) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = aligned_smem(smem_raw);
  constexpr int stage_bytes = 2 * kGemmTileBytes, band = kGemmTileBytes / 2;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kGemmStages * stage_bytes);
  uint64_t* empty = full + kGemmStages;
  float* sums = reinterpret_cast<float*>(empty + kGemmStages);
  const int prob = blockIdx.x >= p0.m_tiles * p0.n_tiles;
  const GemmProblem p = prob ? p1 : p0;
  const CUtensorMap* am = prob ? &a1 : &a0;
  const CUtensorMap* bm = prob ? &b1 : &b0;
  const int tile = blockIdx.x - (prob ? p0.m_tiles * p0.n_tiles : 0);
  const int m0 = tile / p.n_tiles * kGemmTile, n0 = tile % p.n_tiles * kGemmTile;
  const int k_begin = blockIdx.y * p.chunk, k_end = min(p.K, k_begin + p.chunk);
  const int nkb = cdiv(k_end - k_begin, kKTile);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kGemmStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (warp == kConsumers / 32) {  // the producer
    if (lane == 0) {
      tma_prefetch_map(am);
      tma_prefetch_map(bm);
      for (int kb = 0; kb < nkb; ++kb) {
        const int s = kb % kGemmStages, k = k_begin + kb * kKTile;
        unsigned char* st = ring + s * stage_bytes;
        mbar_wait(&empty[s], ((kb / kGemmStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], stage_bytes);
        if (TA) {
          tma_load(st, am, &full[s], m0, k);
          tma_load(st + band, am, &full[s], m0 + 64, k);
        } else {
          tma_load(st, am, &full[s], k, m0);
        }
        if (TB) {
          tma_load(st + kGemmTileBytes, bm, &full[s], n0, k);
          tma_load(st + kGemmTileBytes + band, bm, &full[s], n0 + 64, k);
        } else {
          tma_load(st + kGemmTileBytes, bm, &full[s], k, n0);
        }
      }
    }
    __syncwarp();
    return;
  }
  const int wg = warp / 4, g = lane >> 2, t4 = lane & 3;
  // SUMS: thread t sums row t % 128 of the tile (A^T's column) over half the
  // chunk's rows of each stage (t / 128: the first or last 32)
  const bool sums_here = SUMS && n0 == 0;
  const int srow = threadIdx.x % kGemmTile, shalf = threadIdx.x / kGemmTile;
  float rsum = 0.0f;
  float acc[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0.0f;
  for (int kb = 0; kb < nkb; ++kb) {
    const int s = kb % kGemmStages;
    const unsigned char* st = ring + s * stage_bytes;
    mbar_wait(&full[s], (kb / kGemmStages) & 1);
    // this warpgroup's 64 rows of A, all 128 columns of B; a step of 16 K is
    // 32 bytes along a K-major row or 16 rows (2048 bytes) of an MN-major tile
    const uint64_t da = TA ? wgmma_desc_mn(st + wg * band, band)
                           : wgmma_desc(st + wg * 64 * kRowBytes);
    const uint64_t db = TB ? wgmma_desc_mn(st + kGemmTileBytes, band)
                           : wgmma_desc(st + kGemmTileBytes);
    // all four 16-deep steps of every stage: past K the operands are TMA's
    // zero fill, so the extra products add exact zeros, and an exit between
    // wgmma instructions that depends on the data makes ptxas serialise them
    constexpr int sa = TA ? 128 : 2, sb = TB ? 128 : 2;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kKTile / 16; ++ks)
      wgmma_ss_n128<TA, TB>(acc, da + sa * ks, db + sb * ks);
    wgmma_commit();
    if (sums_here) {  // A^T's column srow: K rows [32 shalf, 32 shalf + 32) of the stage
      const unsigned char* col = st + srow / 64 * band + (srow % 64 % 8) * 2;
      const int chunk16 = srow % 64 / 8;
      for (int r = 32 * shalf; r < 32 * shalf + 32; ++r)
        rsum = __fadd_rn(rsum, __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                                   col + r * kRowBytes + ((chunk16 ^ r % 8) << 4))));
    }
    if (kb > 0) {  // the previous stage's products are done: release it
      wgmma_wait<1>();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(kb - 1) % kGemmStages]);
    }
  }
  wgmma_wait<0>();
  if (sums_here) {  // the two halves' sums, first then last, in that order
    if (shalf == 1) sums[srow] = rsum;
    named_sync(1, kConsumers);
    if (shalf == 0) epi.rowsum(prob, blockIdx.y, m0 + srow, __fadd_rn(rsum, sums[srow]));
  }
  const int row0 = m0 + 64 * wg + 16 * (warp % 4) + g;
#pragma unroll
  for (int j = 0; j < kGemmTile / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      epi(prob, row0 + 8 * half, n0 + j * 8 + 2 * t4, acc[4 * j + 2 * half],
          acc[4 * j + 2 * half + 1]);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in the libcuda the CUDA runtime loaded.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D bf16 tensor map (rows of `cols` elements, `row_bytes` apart) with
// boxes of box_cols x box_rows and 128-byte swizzling; reads past the
// tensor's edge fill zeros.
cudaError_t tensor_map(CUtensorMap* map, const void* base, int cols, long long rows,
                       long long row_bytes, int box_cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                        strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A tensor map of a [rows, cols] bf16 operand (row stride ld elements) for
// gemm_kernel: K-major boxes of 64 x 128 or MN-major boxes of 64 x 64.
cudaError_t operand_map(CUtensorMap* map, const void* base, int cols, long long rows,
                        long long ld, bool mn_major) {
  return tensor_map(map, base, cols, rows, ld * 2, kKTile, mn_major ? 64 : kGemmTile);
}

// Launches gemm_kernel over problems p0 and p1 (p1 with no tiles: one
// problem) and `splits` K chunks on `stream`.
template <bool TA, bool TB, bool SUMS, class Epi>
cudaError_t launch_gemm(const CUtensorMap& a0, const CUtensorMap& b0, const CUtensorMap& a1,
                        const CUtensorMap& b1, GemmProblem p0, GemmProblem p1, int splits, Epi epi,
                        cudaStream_t stream) {
  static unsigned sized = 0;  // the dynamic shared memory attribute, set once a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && !(sized >> dev & 1u)) {
    e = cudaFuncSetAttribute(gemm_kernel<TA, TB, SUMS, Epi>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
    if (e == cudaSuccess) sized |= 1u << dev;
  }
  if (e != cudaSuccess) return e;
  const dim3 grid(p0.m_tiles * p0.n_tiles + p1.m_tiles * p1.n_tiles, splits);
  gemm_kernel<TA, TB, SUMS, Epi><<<grid, kThreads, kGemmSmem, stream>>>(a0, b0, a1, b1, p0, p1,
                                                                        epi);
  return cudaGetLastError();
}

}  // namespace
