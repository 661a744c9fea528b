// K4: one pass of the Paeth three-shear rotation (x-shear, y-shear, x-shear).
//
// Replaces: deepfakedetection_tpu/ops/pallas/shear_rotate.py, _shear_pass
//   (_shear_kernel), which rotate_batch calls three times to rotate the
//   training augmentation canvas.
// Contract, per pass: x [B,H,W,C] bf16 NHWC, coef [B] f32 ->
//   y[b, r, l] = sum_{k<taps} max(0, 1 - |frac - k|) * x[b, r, l + m0 + k]
//   (per channel, blended in f32, zero outside [0, n_l), one bf16 rounding),
//   where r is the row that sets the shift and l the axis shifted along:
//   r = y, l = x for an x-shear; r = x, l = y for a y-shear. The shift of row
//   r is s = coef * (r - center); m0 is the floor of the smallest shift of
//   the R-row block that holds r (R = 32, the TPU kernel's row block, rows
//   past the image included); frac = s - m0. At most two taps are nonzero,
//   floor(frac) and floor(frac) + 1; this kernel computes those two directly
//   and adds them in the TPU kernel's order with exactly rounded f32
//   operations (no contraction into FMA), so it reproduces the plain version
//   bit for bit.
// Bound on the H100: latency, not HBM bytes. Per output element a pass
//   reads two bf16 taps (neighbours along x or along y, mostly served from
//   L1/L2) and writes one bf16, with ~20 flops of index and weight
//   arithmetic and a division by C. At the B3 fine-tune canvas
//   [128, 257, 257, 3] a pass moves ~51 MB, ~15 us at 3.35 TB/s; measured,
//   the three passes take 0.533 ms (H100 80GB HBM3, 700 W), ~285 GB/s: the
//   scalar 2-byte loads and stores leave each thread waiting on memory
//   latency. The remedy (ROADMAP.md, Queue 2) is 16-byte vectors along the row,
//   or the three passes fused through shared memory per image tile.
// Design: one block row per image row (grid (x, H, B)), one thread per
//   output element of the row in NHWC memory order, so stores and the
//   x-shear's loads coalesce and no thread divides a 64-bit index. The
//   y-shear reads columns by stepping its taps with the row stride W*C
//   instead of C, so the TPU kernel's transposes, lane padding and rolls are
//   never materialised. The rotation angles live in coef; the kernel draws
//   no random numbers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

__global__ void shear_pass_kernel(const __nv_bfloat16* __restrict__ x,
                                  __nv_bfloat16* __restrict__ y,
                                  const float* __restrict__ coef, int H, int W, int C,
                                  float center, int rows_per_block, int taps, int along_h) {
  const int py = blockIdx.y, b = blockIdx.z;
  const int row_elems = W * C;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= row_elems) return;
  const int px = e / C;
  const int64_t i = (static_cast<int64_t>(b) * H + py) * row_elems + e;
  const int r = along_h ? px : py;  // the row that sets the shift
  const int l = along_h ? py : px;  // the position along the shifted axis
  const int n_l = along_h ? H : W;
  const int64_t lane_stride = along_h ? static_cast<int64_t>(row_elems) : C;

  const float k = coef[b];
  const int r0 = (r / rows_per_block) * rows_per_block;
  const float s_first = __fmul_rn(k, static_cast<float>(r0) - center);
  const float s_last = __fmul_rn(k, static_cast<float>(r0 + rows_per_block - 1) - center);
  const int m0 = static_cast<int>(floorf(fminf(s_first, s_last)));
  const float s = __fmul_rn(k, static_cast<float>(r) - center);
  const float frac = __fsub_rn(s, static_cast<float>(m0));
  const int ka = static_cast<int>(floorf(frac));

  float acc = 0.0f;
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const int j = ka + d;
    if (j < 0 || j >= taps) continue;
    const float w = fmaxf(0.0f, 1.0f - fabsf(__fsub_rn(frac, static_cast<float>(j))));
    const int src = l + m0 + j;
    float v = 0.0f;
    if (src >= 0 && src < n_l) v = __bfloat162float(x[i + (src - l) * lane_stride]);
    acc = __fadd_rn(acc, __fmul_rn(w, v));
  }
  y[i] = __float2bfloat16_rn(acc);
}

}  // namespace

// Returns a cudaError_t: 0 on success. along_h = 0 for an x-shear, 1 for a
// y-shear. x and y must not overlap. H and B are grid dimensions (<= 65535).
extern "C" int dfd_shear_pass(const void* x, void* y, const void* coef, int B, int H, int W,
                              int C, float center, int rows_per_block, int taps, int along_h,
                              void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || rows_per_block < 1 || taps < 1 || H > 65535 ||
      B > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((W * C + kThreads - 1) / kThreads, H, B);
  shear_pass_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
      static_cast<const float*>(coef), H, W, C, center, rows_per_block, taps, along_h);
  return static_cast<int>(cudaGetLastError());
}
