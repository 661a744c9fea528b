// K1: fused stride-1 depthwise conv + folded-BN bias + SiLU + SE spatial mean.
//
// Replaces: deepfakedetection_tpu/ops/pallas/depthwise_se.py,
//   depthwise_silu_pool (_dw_kernel), the TPU kernel for the expand-free
//   MBConv depthwise (EfficientNet stage 0).
// Contract: x [B,H,W,C] bf16, w [k,k,C] f32, b [C] f32, zero padding k//2 ->
//   y [B,H,W,C] bf16 = silu(dw(x) + b), pool [B,C] f32 = mean over H,W of the
//   bf16-ROUNDED y. Taps dy-major as fmaf from 0, then + b; y is the bf16
//   rounding of the precise v / (1 + expf(-v)), bit for bit the earlier tiled
//   kernel's (see silu_fast).
// Bound on the H100: HBM bytes. Per output element it reads one bf16 and
//   writes one bf16 (4 bytes) for 2k^2 flops: 4.5 flop/byte at k=3 and 12.5
//   at k=5, far below the ~295 flop/byte where bf16 compute would bind. At
//   B3's two stage-0 shapes, batch 128, the bound is 0.123 ms and a 16-byte
//   copy of x takes 0.147 (H100 80GB HBM3, 700 W). In practice the CUDA
//   cores' instruction rate binds: per output element 9 FMAs, the bf16
//   unpacks, and the SiLU, whose precise form (expf, IEEE division) made up
//   a quarter of the tiled kernel's time; keeping its bits from the fast
//   form (silu_fast) costs an eighth of this one's.
// Design: K2's persistent row walk (expand_dw.cu) without the expand. A
//   persistent grid, one block an SM, walks items of one image x one block
//   of CB channels (CB = C up to 64, else 64), a contiguous run of items a
//   block. An item walks the image in bands of RB rows through a circular
//   buffer of 2 RB + k - 1 rows: a band's rows arrive by cp.async while the
//   block runs the previous band's taps, into the rows that band no longer
//   needs; the buffer's k/2 columns each side and one spare all-zero row give
//   the zero padding. A thread owns one 4-channel group of the block (its
//   taps' weights and its pool sums stay the group's) and computes kNPX = 4
//   pixels of one output row a unit: it reads each input pixel of its window
//   once (8 bytes) and feeds it to up to k outputs from registers, and stores
//   8 bytes an output pixel. The pool is summed in registers, then over the
//   group's threads in a fixed order, and written by the item: no partial-sum
//   scratch, no second launch, no atomics, so a run repeats bit for bit. The
//   launch plan (make_plan below, mirrored by ops/depthwise_se.py:plan, read
//   back by dfd_depthwise_plan) gives each thread the same number of units a
//   band:
//     [128, 112, 112, 40] k3: RB 8, 75 threads a group, 750 threads, 128 items
//     [128, 112, 112, 24] k3: RB 8, 112 threads a group, 672 threads, 128 items
//   Device time there (H100 80GB HBM3, 700 W, profile_k1 --ablate): ~0.168
//   and ~0.116 ms; with the SiLU's fast form unguarded ~0.146 and ~0.100,
//   the copies alone (no taps) ~0.067 and ~0.050. Wider units (8 channels)
//   spilled; the taps' weights in registers were no faster.
#include "dw_common.cuh"
#include "hopper.cuh"

namespace {

using dfd::bf2f;
using dfd::pack_bf16;

constexpr int kNPX = 4;            // output pixels of one unit (a row segment)
constexpr int kMaxRB = 8;          // rows of a band
constexpr int kMaxThreads = 768;   // at most 85 registers a thread

// The launch plan, mirrored by ops/depthwise_se.py:plan.
struct Plan {
  int CB, G, RB, NR, bands, T, threads, items, grid, smem;
};

// Shared memory: the ring of NR rows plus the zero row, CBp = 8 ceil(CB / 8)
// channels a pixel (so 16-byte copies fill it), the taps' weights [K*K][4 G],
// the bias [4 G] and the pool's per-thread sums [threads][4].
struct Layout {
  int RW, CBp, ring_px;  // pixels of a ring row (the k/2 zero columns included); of the ring
  size_t w, bias, red, total;  // byte offsets; the ring at 0
};

__host__ __device__ inline Layout layout(int W, int K, int CB, int NR, int threads) {
  Layout L;
  L.RW = cdiv(W, kNPX) * kNPX + K - 1;
  L.CBp = cdiv(CB, 8) * 8;
  L.ring_px = (NR + 1) * L.RW;
  L.w = dfd::align16(2ull * L.ring_px * L.CBp);
  L.bias = L.w + 4ull * K * K * L.CBp;
  L.red = L.bias + 4ull * L.CBp;
  L.total = L.red + 4ull * threads * 4;
  return L;
}

__host__ __device__ inline Plan make_plan(int B, int H, int W, int C, int K, int sms) {
  Plan p;
  p.CB = C <= 64 ? C : 64;
  p.G = cdiv(p.CB, 8) * 2;  // 4-channel groups of the padded block
  p.items = cdiv(C, p.CB) * B;
  p.RB = H < kMaxRB ? H : kMaxRB;
  for (;; --p.RB) {  // the widest band whose buffer fits
    p.NR = 2 * p.RB + K - 1;
    p.bands = cdiv(H, p.RB);
    const int units = p.RB * cdiv(W, kNPX);  // a band's units of one group
    int rounds = cdiv(units * p.G, kMaxThreads);
    while (cdiv(units, rounds) * p.G > kMaxThreads) ++rounds;
    p.T = cdiv(units, rounds);
    p.threads = p.T * p.G;
    p.smem = static_cast<int>(layout(W, K, p.CB, p.NR, p.threads).total);
    if (p.smem <= dfd::kMaxSmemBytes || p.RB == 1) break;
  }
  p.grid = p.items < sms ? p.items : sms;  // one block an SM: its registers fill it
  return p;
}

struct Params {
  const __nv_bfloat16* x;
  const float *w, *b;
  __nv_bfloat16* y;
  float* pool;
  int B, H, W, C, vec;
  Plan p;
  Layout L;
};

// SiLU for a bf16 output: the approximate exponential and reciprocal (one
// MUFU instruction each) where their quotient rounds to the same bf16 as the
// precise v / (1 + expf(-v)) (dfd::silu), else that one. For |v| <= 17 the
// two quotients differ by at most ~60 ulp of f32 (expf 2 ulp, the
// approximate exponential 2 + 1.173 |v| ulp, each sum 0.5, the division 0.5
// against the reciprocal's and product's 2, each relative error at most 2
// ulp of the result's binade); for v > 17 both denominators round to 1 and
// both quotients are v. So where the fast one lies more than kMargin ulp
// from a bf16 rounding midpoint (low 16 bits 0x8000) and v >= -16, both round
// alike; elsewhere (about 0.2% of the elements) the precise one is computed.
// silu_check_kernel holds this to every f32 the fast path may keep.
constexpr uint32_t kMargin = 64;

__device__ __forceinline__ float silu_fast(float v, bool& exact) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(__fmul_rn(v, -1.44269504f)));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f + e));
  const float f = __fmul_rn(v, r);
  exact = exact && v >= -16.0f &&
          ((__float_as_uint(f) + (kMargin - 0x8000u)) & 0xffffu) > 2 * kMargin;
  return f;
}

// Kept out of line: inlined, the precise division's slow path and calls
// would weigh on the unrolled epilogue's registers and schedule.
__device__ __noinline__ float silu_precise(float v) { return dfd::silu(v); }

__device__ __forceinline__ float lo16(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi16(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

template <int K>
__global__ void __launch_bounds__(kMaxThreads, 1)
    depthwise_silu_pool_kernel(const __grid_constant__ Params q) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int R = K / 2;
  const Plan& p = q.p;
  const Layout& L = q.L;
  const int H = q.H, W = q.W, C = q.C, tid = threadIdx.x, NT = blockDim.x;
  const int G = p.G, G8 = G / 2, S = L.CBp;  // 4- and 8-channel groups, channels a pixel
  const int g = tid % G, pos = tid / G;  // this thread's 4 channels and unit slot
  uint4* ring16 = reinterpret_cast<uint4*>(smem);  // [ring_px][G8]: the copies' view
  const uint2* ring = reinterpret_cast<const uint2*>(smem);  // [ring_px][G]: the taps' view
  const uint2* zero_row = ring + static_cast<size_t>(p.NR) * L.RW * G;
  float* ws = reinterpret_cast<float*>(smem + L.w);     // [K*K][S]
  float* bs = reinterpret_cast<float*>(smem + L.bias);  // [S]
  float* red = reinterpret_cast<float*>(smem + L.red);  // [threads][4]
  const int runs = cdiv(W, kNPX);

  const int first = static_cast<int>(static_cast<long long>(blockIdx.x) * p.items / gridDim.x);
  const int last = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * p.items / gridDim.x);
  const int T = (last - first) * p.bands;  // steps: every band of every item

  // Input rows step t adds: [0, RB + R) at band 0, then [s RB + R, (s + 1) RB
  // + R) at band s. Row r of the n-th item of this block sits in ring row
  // (n H + r) % NR; the rows a step touches span fewer than NR, so a row's
  // slot is found from the first one's (one 64-bit division a step).
  auto rows_of = [&](int t, int& lo, int& hi) {
    const int s = t % p.bands;
    hi = min(H, (s + 1) * p.RB + R);
    lo = min(s == 0 ? 0 : s * p.RB + R, hi);
  };
  auto slot_of = [&](int n, int r0) {
    return static_cast<int>(((static_cast<long long>(n) * H + r0) % p.NR + p.NR) % p.NR);
  };
  auto row_index = [&](int r, int r0, int s0) {
    const int i = s0 + r - r0;
    return (i >= p.NR ? i - p.NR : i) * L.RW;
  };
  const int dgg = NT % G8, dpx = NT / G8 % W, drr = NT / G8 / W;  // a thread's copy stride
  auto load = [&](int t) {
    int lo, hi;
    rows_of(t, lo, hi);
    const int n = t / p.bands, item = first + n, s0 = slot_of(n, lo);
    const int b = item % q.B, c0 = (item / q.B) * p.CB;
    int gg = tid % G8, px = tid / G8 % W, r = lo + tid / G8 / W;
    for (; r < hi; gg += dgg, px += dpx, r += drr) {
      if (gg >= G8) {
        gg -= G8;
        ++px;
      }
      if (px >= W) {
        px -= W;
        if (++r >= hi) break;
      }
      uint4* dst = ring16 + static_cast<size_t>(row_index(r, lo, s0) + px + R) * G8 + gg;
      const int c = c0 + 8 * gg;
      const __nv_bfloat16* src = q.x + ((static_cast<size_t>(b) * H + r) * W + px) * C + c;
      if (q.vec) {  // C % 8 == 0 and x 16-byte aligned: whole groups or none
        if (c < C && c < c0 + p.CB)
          cp_async16(dst, src);
        else
          *dst = make_uint4(0, 0, 0, 0);
      } else {
        uint32_t v[4];
#pragma unroll
        for (int k = 0; k < 8; k += 2) {
          const bool in0 = c + k < C && 8 * gg + k < p.CB;
          const bool in1 = c + k + 1 < C && 8 * gg + k + 1 < p.CB;
          v[k / 2] = pack_bf16(in0 ? bf2f(src[k]) : 0.0f, in1 ? bf2f(src[k + 1]) : 0.0f);
        }
        *dst = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  };

  // The ring's padding columns and the zero row stay zero: loads write only
  // columns [R, W + R).
  for (int i = tid; i < L.ring_px * G8; i += NT) ring16[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  if (T > 0) load(0);
  cp_async_commit();

  float psum[4];
  int cur_cb = -1;
  for (int t = 0; t < T; ++t) {
    const int n = t / p.bands, s = t % p.bands, item = first + n;
    const int b = item % q.B, c0 = (item / q.B) * p.CB;
    cp_async_wait<0>();  // step t's rows, sent during step t - 1
    if (s == 0)
#pragma unroll
      for (int k = 0; k < 4; ++k) psum[k] = 0.0f;
    __syncthreads();  // step t's rows visible; step t - 1's taps are done
    if (c0 != cur_cb) {  // a new channel block (the same for the whole block): its taps
      cur_cb = c0;
      for (int i = tid; i < K * K * S; i += NT) {
        const int j = i % S;
        ws[i] = c0 + j < C && j < p.CB ? q.w[static_cast<size_t>(i / S) * C + c0 + j] : 0.0f;
      }
      for (int j = tid; j < S; j += NT) bs[j] = c0 + j < C && j < p.CB ? q.b[c0 + j] : 0.0f;
      __syncthreads();
    }
    if (t + 1 < T) load(t + 1);  // into rows step t no longer reads
    cp_async_commit();

    // Taps: units of one output row x kNPX pixels for this thread's 4
    // channels, dy-major in f32 as the TPU kernel; rows outside the image
    // read the zero row. Each input pixel is read once and feeds up to K
    // outputs, each output's taps in dx order.
    const int olo = s * p.RB, ohi = min(H, olo + p.RB);
    const int c = c0 + 4 * g;
    const int r0 = olo - R, s0 = slot_of(n, r0);
    const int drow = p.T / runs, drun = p.T % runs;  // a thread's unit stride
    int yy = olo + pos / runs, run = pos % runs;
    for (; c < C && 4 * g < p.CB && yy < ohi; yy += drow, run += drun) {
      if (run >= runs) {
        run -= runs;
        if (++yy >= ohi) break;
      }
      const int x0 = run * kNPX;
      float acc[kNPX][4];
#pragma unroll
      for (int j = 0; j < kNPX; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[j][k] = 0.0f;
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
        const int r = yy + dy - R;
        const uint2* row = (r < 0 || r >= H ? zero_row : ring + row_index(r, r0, s0) * G) +
                           x0 * G + g;
        float4 wv[K];  // this row's K taps of the 4 channels
#pragma unroll
        for (int dx = 0; dx < K; ++dx)
          wv[dx] = reinterpret_cast<const float4*>(ws + (dy * K + dx) * S)[g];
#pragma unroll
        for (int jj = 0; jj < kNPX + K - 1; ++jj) {  // input pixel x0 - R + jj
          const uint2 raw = row[jj * G];
          const float v[4] = {lo16(raw.x), hi16(raw.x), lo16(raw.y), hi16(raw.y)};
#pragma unroll
          for (int dx = 0; dx < K; ++dx) {
            const int o = jj - dx;
            if (o < 0 || o >= kNPX) continue;
            acc[o][0] = fmaf(v[0], wv[dx].x, acc[o][0]);
            acc[o][1] = fmaf(v[1], wv[dx].y, acc[o][1]);
            acc[o][2] = fmaf(v[2], wv[dx].z, acc[o][2]);
            acc[o][3] = fmaf(v[3], wv[dx].w, acc[o][3]);
          }
        }
      }
      const float4 bv = reinterpret_cast<const float4*>(bs)[g];
      __nv_bfloat16* yrow = q.y + ((static_cast<size_t>(b) * H + yy) * W + x0) * C + c;
#pragma unroll
      for (int j = 0; j < kNPX; ++j) {
        if (x0 + j >= W) break;
        // y rounded to bf16, two channels a word; the pool sums the rounded y
        const float v[4] = {acc[j][0] + bv.x, acc[j][1] + bv.y, acc[j][2] + bv.z,
                            acc[j][3] + bv.w};
        float f[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          bool exact = true;
          f[k] = silu_fast(v[k], exact);
          if (!exact) f[k] = silu_precise(v[k]);
        }
        const uint32_t w0 = pack_bf16(f[0], f[1]), w1 = pack_bf16(f[2], f[3]);
        psum[0] += lo16(w0);
        psum[1] += hi16(w0);
        psum[2] += lo16(w1);
        psum[3] += hi16(w1);
        __nv_bfloat16* dst = yrow + static_cast<size_t>(j) * C;
        if (q.vec) {
          *reinterpret_cast<uint2*>(dst) = make_uint2(w0, w1);
        } else {
          const float out[4] = {lo16(w0), hi16(w0), lo16(w1), hi16(w1)};
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (c + k < C && 4 * g + k < p.CB) dst[k] = __float2bfloat16_rn(out[k]);
        }
      }
    }

    if (s == p.bands - 1) {  // the item's last band: its pool, the group's threads in order
#pragma unroll
      for (int k = 0; k < 4; ++k) red[tid * 4 + k] = psum[k];
      __syncthreads();
      for (int j = tid; j < p.CB; j += NT) {
        if (c0 + j >= C) continue;
        float tot = 0.0f;
        for (int l = 0; l < p.T; ++l) tot += red[(l * G + j / 4) * 4 + j % 4];
        q.pool[static_cast<size_t>(b) * C + c0 + j] = tot / static_cast<float>(H * W);
      }
    }
  }
  cp_async_wait<0>();
}

// Every f32 v >= -16, +inf included (the inputs silu_fast may keep):
// counts[0] gets those whose fast quotient it keeps yet rounds to another
// bf16 than dfd::silu's, counts[1] those it hands to dfd::silu.
__global__ void silu_check_kernel(unsigned long long* counts) {
  constexpr uint64_t pos = 0x7f800001ull, neg = 0x41800001ull;  // [+0, +inf], [-16, -0]
  unsigned long long bad = 0, slow = 0;
  for (uint64_t i = blockIdx.x * static_cast<uint64_t>(blockDim.x) + threadIdx.x; i < pos + neg;
       i += static_cast<uint64_t>(gridDim.x) * blockDim.x) {
    const float v = __uint_as_float(i < pos ? static_cast<uint32_t>(i)
                                            : 0x80000000u | static_cast<uint32_t>(i - pos));
    bool exact = true;
    const float f = silu_fast(v, exact);
    if (!exact)
      ++slow;
    else if (__bfloat16_as_ushort(__float2bfloat16_rn(f)) !=
             __bfloat16_as_ushort(__float2bfloat16_rn(dfd::silu(v))))
      ++bad;
  }
  if (bad) atomicAdd(counts, bad);
  if (slow) atomicAdd(counts + 1, slow);
}

}  // namespace

// Runs silu_check_kernel on `stream` into counts (device, 2 zeroed words).
extern "C" int dfd_silu_check(void* counts, void* stream) {
  silu_check_kernel<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dfd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns a cudaError_t: 0 on success. x [B,H,W,C] bf16, w [k,k,C] and b [C]
// f32, y [B,H,W,C] bf16, pool [B,C] f32; k is 3 or 5.
extern "C" int dfd_depthwise_silu_pool(const void* x, const void* w, const void* b, void* y,
                                       void* pool, int B, int H, int W, int C, int k,
                                       void* stream) {
  if ((k != 3 && k != 5) || B < 1 || H < 1 || W < 1 || C < 1 ||
      static_cast<long long>(B) * H * W > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  Params q;
  q.p = make_plan(B, H, W, C, k, sms);
  if (q.p.smem > dfd::kMaxSmemBytes) return cudaErrorInvalidValue;
  q.L = layout(W, k, q.p.CB, q.p.NR, q.p.threads);
  q.x = static_cast<const __nv_bfloat16*>(x);
  q.w = static_cast<const float*>(w);
  q.b = static_cast<const float*>(b);
  q.y = static_cast<__nv_bfloat16*>(y);
  q.pool = static_cast<float*>(pool);
  q.B = B;
  q.H = H;
  q.W = W;
  q.C = C;
  q.vec = C % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(y) % 8 == 0;
  auto kernel = k == 3 ? depthwise_silu_pool_kernel<3> : depthwise_silu_pool_kernel<5>;
  err = dfd::allow_smem(kernel, q.L.total);
  if (err != cudaSuccess) return err;
  kernel<<<q.p.grid, q.p.threads, q.L.total, static_cast<cudaStream_t>(stream)>>>(q);
  return static_cast<int>(cudaGetLastError());
}

// The launch plan make_plan picks for a card of `sms` SMs: out = {CB, G, RB,
// NR, bands, T, threads, items, grid, smem bytes}. Returns a cudaError_t.
extern "C" int dfd_depthwise_plan(int B, int H, int W, int C, int k, int sms, int* out) {
  if ((k != 3 && k != 5) || B < 1 || H < 1 || W < 1 || C < 1 || sms < 1)
    return cudaErrorInvalidValue;
  const Plan p = make_plan(B, H, W, C, k, sms);
  const int v[10] = {p.CB, p.G, p.RB, p.NR, p.bands, p.T, p.threads, p.items, p.grid, p.smem};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return cudaSuccess;
}
