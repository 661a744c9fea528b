// K4: the Paeth three-shear rotation (x-shear, y-shear, x-shear), the three
// passes fused into one launch.
//
// Replaces: deepfakedetection_tpu/ops/pallas/shear_rotate.py, rotate_batch
//   over three _shear_pass (_shear_kernel) calls, which rotate the training
//   augmentation canvas.
// Contract, per pass: x [B,H,W,C] bf16 NHWC, coef [B] f32 ->
//   y[b, r, l] = sum_{k<taps} max(0, 1 - |frac - k|) * x[b, r, l + m0 + k]
//   (per channel, blended in f32, zero outside [0, n_l), one bf16 rounding),
//   where r is the row that sets the shift and l the axis shifted along:
//   r = y, l = x for an x-shear; r = x, l = y for a y-shear. The shift of row
//   r is s = coef * (r - center); m0 is the floor of the smallest shift of
//   the R-row block that holds r (R = 32, the TPU kernel's row block, rows
//   past the image included); frac = s - m0. At most two taps are nonzero,
//   floor(frac) and floor(frac) + 1; the kernel computes those two directly
//   and adds them in the TPU kernel's order with exactly rounded f32
//   operations (no contraction into FMA). Pass 1 and 3 are x-shears by
//   a = -tan(theta/2) about cy, pass 2 a y-shear by b = sin(theta) about cx.
//   The output is the plain version's bit for bit: every pass rounds to bf16
//   and fills zeros outside the image, as there.
// Bound on the H100: HBM bytes, the canvas read once and written once (at
//   [128, 257, 257, 3] 0.030 ms; a 16-byte copy of it takes 0.036). The
//   three-launch design it replaces read and wrote the canvas three times,
//   one thread a bf16 element, and took 0.550 ms of device time (each pass
//   ~0.18, latency-bound; H100 80GB HBM3, 700 W, profile_k4 --ablate).
// Design: one block an output tile of one image, all channels: rows
//   [y0, y0 + 32) (one row block, so pass 3 has one base tap m3) x columns
//   [x0, x0 + TW). The tile needs pass 2's values at the W2 = TW + taps_x - 1
//   columns from x0 + m3 on; pass 2's base tap m2 changes only every 32
//   columns, so the region splits into up to nb column segments, one per
//   32-column block of the image, and a segment needs pass 1's values at
//   H1 = th + taps_y - 1 rows from y0 + m2 on; each of those rows needs the
//   input at the segment's columns + 1, shifted by that row's own pass-1 tap
//   m1 + ka1. So every buffer's size depends on TW, taps_x and taps_y alone,
//   never on the angle. A block computes the tables of taps and weights of
//   its rows, columns and (segment, row) pieces; stages each piece of the
//   input with 16-byte copies of the aligned chunks that cover it (the canvas
//   row is 1,542 bytes, so each piece starts at its own offset in the chunk;
//   cp.async where the chunk lies inside the image row, else through
//   registers with the rest zeroed); computes pass 1 into shared memory
//   (bf16, rows outside the image zero), pass 2 over it (columns outside the
//   image zero) into the space the input used, and pass 3 into the output.
//   The passes run a thread on one pixel column (its C channels, compiled in
//   at 3) and a group of rows, consecutive threads on consecutive columns;
//   pass 1's and 2's outputs are kept as C planes a row. Rotation angles live
//   in the coefficients; the kernel draws no random numbers. The launch plan
//   (make_plan below, mirrored by ops/shear_rotate.py:plan, read back by
//   dfd_shear_plan) picks the widest balanced TW whose region has at most
//   kMaxThreads element columns:
//     [128, 257, 257, 3] at 10 degrees (taps 5, 8): TW 86, 3 x 9 tiles an
//       image, W2 90, H1 39, nb 4, 288 threads, 56,096 bytes.
//   Device time there (H100 80GB HBM3, 700 W, profile_k4 --ablate): ~0.108
//   ms, 3.6x the bound: the tables take ~11% of it, the staging ~18%, each
//   pass about a quarter (a persistent grid, two pixels a thread, more or
//   fewer threads a tile were each slower).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 32;           // the TPU kernel's row block: one base tap m0 per block
constexpr int kMaxThreads = 384;  // the widest region a tile may have, in element columns
constexpr int kMaxSmem = 232448;    // shared memory one block may use on sm_90

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// The launch plan for a [*, H, W, C] canvas and the passes' tap counts.
struct Plan {
  int TW, tiles_x, tiles_y, W2, H1, nb, row0, NE, threads;
  int t1, t1s, t2, t3, s1, smem;  // byte offsets of the tables and buffers; S0 (and S2) at 0
};

__host__ __device__ inline Plan make_plan(int H, int W, int C, int taps_x, int taps_y) {
  Plan p;
  int twmax = kMaxThreads / C - (taps_x - 1);  // the widest tile whose region fits the threads
  twmax = twmax < 1 ? 1 : twmax;
  p.tiles_x = cdiv(W, twmax);
  p.TW = cdiv(W, p.tiles_x);  // balanced: ragged tiles differ by one column at most
  p.tiles_x = cdiv(W, p.TW);
  p.tiles_y = cdiv(H, kRows);
  p.W2 = p.TW + taps_x - 1;
  p.H1 = kRows + taps_y - 1;
  p.nb = (p.W2 + 30) / kRows + 1;  // 32-column blocks W2 columns can touch
  p.row0 = cdiv((p.W2 + p.nb) * C + 14 * p.nb, 8) * 8;  // staged elements of one row
  p.NE = p.W2 * C;
  p.threads = cdiv(p.NE < kMaxThreads ? p.NE : kMaxThreads, 32) * 32;
  const int s0 = 2 * p.H1 * p.row0;  // >= pass 2's 2 * kRows * NE, which reuses it
  p.t1 = s0;
  p.t1s = p.t1 + 16 * p.nb * p.H1;
  p.t2 = p.t1s + cdiv(24 * p.nb * p.H1, 16) * 16;
  p.t3 = p.t2 + 16 * p.W2;
  p.s1 = p.t3 + 16 * kRows;
  p.smem = p.s1 + cdiv(2 * p.H1 * p.NE, 16) * 16;
  return p;
}

// One row's (or column's) shear: the base tap m0 of its 32-row block, the
// first nonzero tap ka and the weights of taps ka and ka + 1, each used only
// when its tap lies in [0, taps) (bits 0 and 1 of use). The same operations
// in the same order as the TPU kernel's and the plain version's.
struct Shear {
  int m0, ka, use;
  float w0, w1;
};

__device__ __forceinline__ Shear shear_of(float k, float center, int r, int taps) {
  const int r0 = (r / kRows) * kRows;
  const float s_first = __fmul_rn(k, static_cast<float>(r0) - center);
  const float s_last = __fmul_rn(k, static_cast<float>(r0 + kRows - 1) - center);
  Shear s;
  // Past 2^20 every tap lies outside any canvas this kernel takes; the bound
  // keeps the index arithmetic in range for absurd coefficients.
  s.m0 = max(-(1 << 20), min(1 << 20, static_cast<int>(floorf(fminf(s_first, s_last)))));
  const float sh = __fmul_rn(k, static_cast<float>(r) - center);
  const float frac = __fsub_rn(sh, static_cast<float>(s.m0));
  s.ka = static_cast<int>(floorf(frac));
  s.use = (s.ka >= 0 && s.ka < taps ? 1 : 0) | (s.ka >= -1 && s.ka < taps - 1 ? 2 : 0);
  s.w0 = fmaxf(0.0f, 1.0f - fabsf(__fsub_rn(frac, static_cast<float>(s.ka))));
  s.w1 = fmaxf(0.0f, 1.0f - fabsf(__fsub_rn(frac, static_cast<float>(s.ka + 1))));
  return s;
}

// 16-byte asynchronous copy from global to shared memory (cp.async, L2 only).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// The two-tap blend of one element: 0 + w0 v0, then + w1 v1, each tap only
// when it is in range; rounded once to bf16.
__device__ __forceinline__ __nv_bfloat16 blend(int use, float w0, float w1, __nv_bfloat16 v0,
                                               __nv_bfloat16 v1) {
  float acc = 0.0f;
  if (use & 1) acc = __fadd_rn(acc, __fmul_rn(w0, __bfloat162float(v0)));
  if (use & 2) acc = __fadd_rn(acc, __fmul_rn(w1, __bfloat162float(v1)));
  return __float2bfloat16_rn(acc);
}

struct Taps {  // a table entry: a row's or column's taps; base: pass 1's S0 element index
  int ka_or_base, use;  // use bit 2: the row or column lies inside the image
  float w0, w1;
};

struct Stage {  // how pass 1's input piece of one (segment, row) is staged
  long long chunk0, lo;  // element index of its first 16-byte chunk; of its image row
  int slot, nch;         // S0 element index of that chunk; chunks (0: nothing to stage)
};

struct Params {
  const __nv_bfloat16* xa;  // x rounded down to 16 bytes; x's element e is xa's e + shift
  __nv_bfloat16* y;
  const float *a, *b;  // [B] coefficients: the x-shears' and the y-shear's
  int H, W, C, taps_x, taps_y, shift;
  float cy, cx;
  Plan p;
};

// CT: the channel count compiled in (3, an RGB canvas), or 0 to read it from q.
template <int CT>
__global__ void __launch_bounds__(kMaxThreads, 3)
    shear_rotate_kernel(const __grid_constant__ Params q) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan& p = q.p;
  const int H = q.H, W = q.W, C = CT > 0 ? CT : q.C, tid = threadIdx.x, NT = blockDim.x;
  const int b = blockIdx.z, y0 = blockIdx.y * kRows, x0 = blockIdx.x * p.TW;
  const int th = min(kRows, H - y0), tw = min(p.TW, W - x0);
  const int W2 = tw + q.taps_x - 1, NE = W2 * C, H1 = th + q.taps_y - 1;
  const float a = q.a[b], bb = q.b[b];
  const long long WC = static_cast<long long>(W) * C;

  __nv_bfloat16* s0 = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s2 = s0;  // pass 2 writes over the staged input, which pass 1 has read
  __nv_bfloat16* s1 = reinterpret_cast<__nv_bfloat16*>(smem + p.s1);
  Taps* t1 = reinterpret_cast<Taps*>(smem + p.t1);    // [nb][H1]: pass 1 of each (segment, row)
  Stage* t1s = reinterpret_cast<Stage*>(smem + p.t1s);  // [nb][H1]
  Taps* t2 = reinterpret_cast<Taps*>(smem + p.t2);    // [W2]: pass 2 of each region column
  Taps* t3 = reinterpret_cast<Taps*>(smem + p.t3);    // [32]: pass 3 of each tile row

  // The region: pass 2's columns [x2lo, x2lo + W2) of the image, of which
  // [clo, chi) (local) lie inside it, in segments of the 32-column blocks
  // kb0, kb0 + 1, ...: segment i holds local columns [cs(i), ce(i)).
  const int x2lo = x0 + shear_of(a, q.cy, y0, q.taps_x).m0;
  const int clo = max(0, -x2lo), chi = min(W2, W - x2lo);
  const int kb0 = clo < chi ? (x2lo + clo) / kRows : 0;
  const int nseg = clo < chi ? (x2lo + chi - 1) / kRows - kb0 + 1 : 0;
  auto cs = [&](int i) { return max(clo, (kb0 + i) * kRows - x2lo); };
  auto ce = [&](int i) { return min(chi, (kb0 + i + 1) * kRows - x2lo); };
  auto slot_len = [&](int i) { return cdiv(7 + (ce(i) - cs(i) + 1) * C, 8) * 8; };

  // Tables: pass 3's rows, pass 2's columns, pass 1's (segment, row) pieces.
  for (int j = tid; j < th + W2 + nseg * H1; j += NT) {
    if (j < th) {
      const Shear s = shear_of(a, q.cy, y0 + j, q.taps_x);
      t3[j] = {s.ka, s.use, s.w0, s.w1};
    } else if (j < th + W2) {
      const int c = j - th, xi = x2lo + c;
      Taps t = {0, 0, 0.0f, 0.0f};
      if (xi >= 0 && xi < W) {
        const Shear s = shear_of(bb, q.cx, xi, q.taps_y);
        t = {s.ka, s.use | 4, s.w0, s.w1};
      }
      t2[c] = t;
    } else {
      const int i = (j - th - W2) / H1, r = (j - th - W2) % H1;
      int so = 0;
      for (int k = 0; k < i; ++k) so += slot_len(k);
      const int m2 = shear_of(bb, q.cx, (kb0 + i) * kRows, q.taps_y).m0;
      const int yy = y0 + m2 + r;
      Taps t = {0, 0, 0.0f, 0.0f};
      Stage st = {0, 0, 0, 0};
      if (yy >= 0 && yy < H) {
        const Shear s = shear_of(a, q.cy, yy, q.taps_x);
        if (s.use) {
          const long long lo = (static_cast<long long>(b) * H + yy) * WC + q.shift;
          const long long g = lo + static_cast<long long>(x2lo + cs(i) + s.m0 + s.ka) * C;
          const long long g8 = g >> 3;  // floor: g may be negative
          const int delta = static_cast<int>(g - 8 * g8);
          st = {8 * g8, lo, r * p.row0 + so, cdiv(delta + (ce(i) - cs(i) + 1) * C, 8)};
          t = {r * p.row0 + so + delta - cs(i) * C, s.use | 4, s.w0, s.w1};
        }
      }
      t1[i * H1 + r] = t;
      t1s[i * H1 + r] = st;
    }
  }
  __syncthreads();

  // Stage pass 1's input: 16-byte chunks, by cp.async where the chunk lies
  // inside the image row, else through registers with the other rows' part
  // zeroed.
  {
    const int maxch = cdiv(7 + (kRows + 1) * C, 8);
    const uint4* xv = reinterpret_cast<const uint4*>(q.xa);
    for (int it = tid; it < nseg * H1 * maxch; it += NT) {
      const int piece = it / maxch, ch = it % maxch;
      const Stage st = t1s[piece];
      if (ch >= st.nch) continue;
      const long long g = st.chunk0 + 8 * ch, lo = st.lo, hi = lo + WC;
      uint4* dst = reinterpret_cast<uint4*>(s0 + st.slot + 8 * ch);
      if (g >= lo && g + 8 <= hi) {
        cp_async16(dst, xv + (g >> 3));
        continue;
      }
      uint4 v = make_uint4(0, 0, 0, 0);
      if (g + 8 > lo && g < hi) {
        v = xv[g >> 3];
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (g + k < lo || g + k >= hi) e[k] = __float2bfloat16_rn(0.0f);
      }
      *dst = v;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncthreads();

  // The passes run a thread on one pixel column of the region (its C
  // channels) and a group of consecutive rows, consecutive threads on
  // consecutive columns. S1 and S2 hold each row as C planes of W2 columns,
  // so a warp's accesses to them fall in distinct banks.
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

  // Pass 1 (x-shear by a) into S1 [H1][C][W2]: the rows y0 + m2 + r of the
  // column's segment; rows outside the image are zero. A row's input piece
  // starts at its own first tap, so tap ka is element e and ka + 1 e + C.
  const int G1 = max(1, NT / W2);
  for (int it = tid; it < W2 * G1; it += NT) {
    const int c = it % W2, g = it / W2;
    if (c < clo || c >= chi) continue;  // outside the image: pass 2 writes zeros there
    const Taps* tr = t1 + ((x2lo + c) / kRows - kb0) * H1;
    for (int r = g * H1 / G1; r < (g + 1) * H1 / G1; ++r) {
      const Taps t = tr[r];
      __nv_bfloat16* dst = s1 + r * NE + c;
      if (!t.use) {
        for (int ch = 0; ch < C; ++ch) dst[ch * W2] = zero;
        continue;
      }
      const __nv_bfloat16* src = s0 + t.ka_or_base + c * C;
      for (int ch = 0; ch < C; ++ch)
        dst[ch * W2] = blend(t.use, t.w0, t.w1, src[ch], src[C + ch]);
    }
  }
  __syncthreads();

  // Pass 2 (y-shear by b) into S2 [th][C][W2]: a thread walks down its column;
  // row y's taps are S1 rows y + ka and y + ka + 1, so each row read feeds
  // two outputs.
  const int G2 = max(1, NT / W2);
  for (int it = tid; it < W2 * G2; it += NT) {
    const int c = it % W2, g = it / W2;
    const Taps t = t2[c];
    const int ylo = g * th / G2, yhi = (g + 1) * th / G2;
    if (!(t.use & 4) || !(t.use & 3)) {  // outside the image, or no tap in range
      for (int yy = ylo; yy < yhi; ++yy)
        for (int ch = 0; ch < C; ++ch) s2[yy * NE + ch * W2 + c] = zero;
      continue;
    }
    // -1 <= ka < taps_y; the clamped reads (row -1, row H1) belong to taps
    // out of range, which blend never uses.
    const int ka = t.ka_or_base;
    for (int ch = 0; ch < C; ++ch) {
      const __nv_bfloat16* col = s1 + ch * W2 + c;
      __nv_bfloat16 v0 = col[max(ylo + ka, 0) * NE];
      for (int yy = ylo; yy < yhi; ++yy) {
        const __nv_bfloat16 v1 = col[min(yy + ka + 1, H1 - 1) * NE];
        s2[yy * NE + ch * W2 + c] = blend(t.use, t.w0, t.w1, v0, v1);
        v0 = v1;
      }
    }
  }
  __syncthreads();

  // Pass 3 (x-shear by a) into the output tile.
  const int G3 = max(1, NT / tw);
  for (int it = tid; it < tw * G3; it += NT) {
    const int xo = it % tw, g = it / tw;
    __nv_bfloat16* out = q.y + (static_cast<long long>(b) * H + y0) * WC +
                         static_cast<long long>(x0 + xo) * C;
    for (int yy = g * th / G3; yy < (g + 1) * th / G3; ++yy) {
      const Taps t = t3[yy];
      const __nv_bfloat16* src = s2 + yy * NE + xo + t.ka_or_base;
      for (int ch = 0; ch < C; ++ch)
        out[yy * WC + ch] = blend(t.use, t.w0, t.w1, (t.use & 1) ? src[ch * W2] : zero,
                                  (t.use & 2) ? src[ch * W2 + 1] : zero);
    }
  }
}

}  // namespace

// Returns a cudaError_t: 0 on success. a and b are the [B] f32 coefficients
// (a = -tan(theta/2) for the two x-shears, b = sin(theta) for the y-shear),
// taps_x and taps_y their passes' tap counts (ops/shear_rotate.py:_passes).
// x and y must not overlap; B and the row tiles are grid dimensions (<= 65535).
extern "C" int dfd_shear_rotate(const void* x, void* y, const void* a, const void* b, int B, int H,
                                int W, int C, float cy, float cx, int taps_x, int taps_y,
                                void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || taps_x < 1 || taps_y < 1 || B > 65535 ||
      H >= (1 << 19) || W >= (1 << 19) || taps_x > 64 || taps_y > 64)
    return cudaErrorInvalidValue;
  const Plan p = make_plan(H, W, C, taps_x, taps_y);
  if (p.smem > kMaxSmem || p.tiles_y > 65535) return cudaErrorInvalidValue;
  auto kernel = C == 3 ? shear_rotate_kernel<3> : shear_rotate_kernel<0>;
  if (p.smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
  }
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  Params q;
  q.xa = reinterpret_cast<const __nv_bfloat16*>(addr & ~uintptr_t(15));
  q.shift = static_cast<int>((addr & 15) / 2);
  q.y = static_cast<__nv_bfloat16*>(y);
  q.a = static_cast<const float*>(a);
  q.b = static_cast<const float*>(b);
  q.H = H;
  q.W = W;
  q.C = C;
  q.taps_x = taps_x;
  q.taps_y = taps_y;
  q.cy = cy;
  q.cx = cx;
  q.p = p;
  const dim3 grid(p.tiles_x, p.tiles_y, B);
  kernel<<<grid, p.threads, p.smem, static_cast<cudaStream_t>(stream)>>>(q);
  return static_cast<int>(cudaGetLastError());
}

// The launch plan for a [*, H, W, C] canvas: out = {TW, tiles_x, tiles_y, W2,
// H1, nb, row0, NE, threads, smem bytes}. Returns a cudaError_t.
extern "C" int dfd_shear_plan(int H, int W, int C, int taps_x, int taps_y, int* out) {
  if (H < 1 || W < 1 || C < 1 || taps_x < 1 || taps_y < 1) return cudaErrorInvalidValue;
  const Plan p = make_plan(H, W, C, taps_x, taps_y);
  const int v[10] = {p.TW, p.tiles_x, p.tiles_y, p.W2, p.H1, p.nb, p.row0, p.NE, p.threads, p.smem};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return cudaSuccess;
}
