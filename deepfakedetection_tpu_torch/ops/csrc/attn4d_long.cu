// K7 past 128 tokens: EfficientFormerV2's talking-head attention
// (Attention4D), inference, over 129 to 256 tokens (EfficientFormerV2-S1 at
// 384 px: 144 tokens in stages 3 and 4; at 512 px: 256). attn4d.cu keeps
// N <= 128; ops/attn4d.py chooses by N.
//
// Replaces: deepfakedetection_tpu/ops/pallas/attn4d.py, fused_attn4d
//   (_attn4d_kernel, :92; wrapper attn4d_pallas, :149) at these sizes, where
//   it pads N to a multiple of 16.
// Contract: as attn4d.cu. q, k [B, N, h*d], v [B, N, h*dv] bf16 through
//   (batch, row) strides, bias [h, N, N], th1, th2 [h, h] (flax [h_in,
//   g_out]), th1_b, th2_b [h] f32 -> out [B, N, h*dv] bf16, contiguous; per
//   image and output head g, for key columns m < N:
//     s_h  = (q_h . k_h^T accumulated in f32) * scale + bias[h]
//     p_g  = softmax_m(sum_h th1[h, g] * s_h + th1_b[g])
//     p2_g = sum_h th2[h, g] * p_h + th2_b[g], rounded to bf16
//     out_g = p2_g . v_g accumulated in f32, rounded to bf16.
//   128 < N <= 256, h <= 8 (every registry model has 8), d % 16 == 0,
//   dv % 8 == 0, and a block's shared memory within 227 KB (at h 8, d 32:
//   every dv <= 128 fits).
// Bound on the H100: HBM bytes at S1's shapes (N 144, h 8, d 32, dv 128): an
//   image reads q, k (147 KB) and v (295 KB) and writes 295 KB for 2 N^2 h
//   (d + dv) = 53 MFLOP: ~72 flops per byte, below the ~295 flop/byte line.
//
// Design: simple and right first. The talking heads mix every head's score
//   at each (query, key) pair, so a block needs all the heads' scores of its
//   rows: at 256 keys, 16 rows of 8 heads are 133 KB of f32, so a block owns
//   one image's 16-row query tile (a grid of B x ceil(N / 16) blocks of 8
//   warps) and neither k nor all of v fits beside them.
//   A: items (head, 16-key tile) over the warps: s_h on the tensor cores
//      (mma.sync m16n8k16; q by ldmatrix from shared memory, the k operand
//      read from device memory straight into its fragment), the raw f32
//      scores of the tile's rows into S [h][16][lds].
//   B: a warp a row, a lane key columns lane + 32 j, 128 columns at a time:
//      scale, bias and the th1 mix written back over the row's scores (each
//      lane reads and writes only its own columns), the row max; exp and the
//      row sum; the quotient and the th2 mix, p2 written in bf16 over the
//      row's first Np / 2 floats once the chunk's values are in registers.
//   C: head by head, v_g staged in shared memory (16-byte cp.async, rows
//      past N zero), then items (16 output columns) over the warps: p2_g v_g
//      (p2 by ldmatrix, v by ldmatrix.trans), stored from the accumulators.
//   Every step, its rounding and its order over heads and keys are those of
//   attn4d.cu's (its three phases), so the two kernels compute one function.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"
#include "window_attn_common.cuh"
#include "window_attn_pipe.cuh"

namespace {

constexpr int kMinN = 129, kMaxN = 256;
constexpr int kHeads = 8;  // the most heads; the tables take this many
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kHead = 1024;  // bytes of the tables ahead of the operands
constexpr int kCols = 128;   // key columns a warp's lanes hold at once in phase B
constexpr int kCpl = kCols / 32;

struct Src {
  const __nv_bfloat16* p;
  long long sb, sr;  // batch and row strides, in elements
};

// Shared memory (byte offsets): the tables, q's 16 rows [16][ldq], the
// scores S [h][16][lds] f32 (p2 in bf16 over each row's first Np / 2 floats
// after phase B), and one head of v [Np][ldv].
struct LongLayout {
  int Np, kt, ldq, lds, ldv, q, s, v, total;
  __host__ __device__ LongLayout(int N, int heads, int d, int dv) {
    Np = pad16(N);
    kt = Np / 16;
    ldq = heads * d + 8;
    lds = (N + 3) / 4 * 4;
    if (lds % 8 == 0) lds += 4;  // conflict-free ldmatrix rows of p2
    ldv = dv + ((dv / 8) % 2 == 0 ? 8 : 16);
    q = kHead;
    s = q + 16 * ldq * 2;
    v = s + heads * 16 * lds * 4;
    total = v + Np * ldv * 2;
  }
};

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Two consecutive bf16 of device memory as one mma operand register; zero
// for no row.
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p, bool live, bool vec) {
  if (!live) return 0u;
  if (vec) return __ldg(reinterpret_cast<const unsigned int*>(p));
  return pack_raw(p[0], p[1]);
}

// Copies `rows` rows of `width` columns into [*][ld] shared memory: 16-byte
// cp.async where vec allows, else element by element; then a block barrier.
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src,
                                          long long sr, int rows, int width, bool vec) {
  if (vec) {
    const int chunks = width / 8;
    for (int e = threadIdx.x; e < rows * chunks; e += kThreads) {
      const int r = e / chunks, c = e - r * chunks;
      cp_async16(dst + r * ld + 8 * c, src + r * sr + 8 * c);
    }
    cp_async_wait_all();
  } else {
    for (int e = threadIdx.x; e < rows * width; e += kThreads) {
      const int r = e / width, c = e - r * width;
      dst[r * ld + c] = src[r * sr + c];
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
    attn4d_long_kernel(Src q, Src k, Src v, const float* __restrict__ bias,
                       const float* __restrict__ th1, const float* __restrict__ th1_b,
                       const float* __restrict__ th2, const float* __restrict__ th2_b,
                       __nv_bfloat16* __restrict__ out, int N, int heads, int d, int dv,
                       float scale, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const LongLayout L(N, heads, d, dv);
  const int kt = L.kt, Np = L.Np, lds = L.lds, ldp = 2 * lds, Cv = heads * dv;
  const long long b = blockIdx.x / kt;
  const int mt = blockIdx.x % kt, r0 = mt * 16, rows = min(16, N - r0);
  float* t1 = reinterpret_cast<float*>(smem);
  float* t1b = t1 + kHeads * kHeads;
  float* t2 = t1b + kHeads;
  float* t2b = t2 + kHeads * kHeads;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L.q);
  float* S = reinterpret_cast<float*>(smem + L.s);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + L.v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g8 = lane >> 2, t4 = lane & 3;
  const bool bvec = vec != 0;

  for (int i = threadIdx.x; i < heads * heads; i += kThreads) {
    t1[i] = th1[i];
    t2[i] = th2[i];
  }
  for (int i = threadIdx.x; i < heads; i += kThreads) {
    t1b[i] = th1_b[i];
    t2b[i] = th2_b[i];
  }
  // q rows past `rows` and v rows past N stay zero.
  for (int i = threadIdx.x; i < 16 * L.ldq / 8; i += kThreads)
    reinterpret_cast<uint4*>(qs)[i] = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < (Np - N) * L.ldv / 8; i += kThreads)
    reinterpret_cast<uint4*>(vs + N * L.ldv)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  copy_rows(qs, L.ldq, q.p + b * q.sb + r0 * q.sr, q.sr, rows, heads * d, bvec);

  // Phase A: raw f32 scores S[h][row][key], rows < rows and keys < N.
  const int tile_row = lane & 15, tile_col = (lane >> 4) * 8;
#pragma unroll 1
  for (int it = warp; it < heads * kt; it += kWarps) {
    const int h = it / kt, np = it % kt;
    float s[2][4] = {};
    const __nv_bfloat16* krow[2];
    bool live[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int key = np * 16 + t * 8 + g8;
      live[t] = key < N;
      krow[t] = k.p + b * k.sb + static_cast<long long>(min(key, N - 1)) * k.sr + h * d + 2 * t4;
    }
#pragma unroll 1
    for (int kk = 0; kk < d / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, qs + tile_row * L.ldq + h * d + kk * 16 + tile_col);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const uint32_t b0 = load_pair(krow[t] + kk * 16, live[t], bvec);
        const uint32_t b1 = load_pair(krow[t] + kk * 16 + 8, live[t], bvec);
        mma_bf16_16816(s[t], a, b0, b1);
      }
    }
    float* S0 = S + (h * 16 + g8) * lds;
    float* S1 = S0 + 8 * lds;
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = np * 16 + t * 8 + 2 * t4 + e;
        if (c >= N) continue;
        if (g8 < rows) S0[c] = s[t][e];
        if (g8 + 8 < rows) S1[c] = s[t][2 + e];
      }
  }
  __syncthreads();

  // Phase B: a warp a row.
  const int chunks = (N + kCols - 1) / kCols;
#pragma unroll 1
  for (int rr = warp; rr < rows; rr += kWarps) {
    const float* brow = bias + static_cast<long long>(r0 + rr) * N;
    float m[kHeads], l[kHeads];
#pragma unroll
    for (int gg = 0; gg < kHeads; ++gg) m[gg] = -INFINITY;
#pragma unroll 1
    for (int ch = 0; ch < chunks; ++ch) {
      float x[kHeads][kCpl] = {};
#pragma unroll
      for (int h = 0; h < kHeads; ++h) {
        if (h >= heads) continue;
        const float* srow = S + (h * 16 + rr) * lds;
#pragma unroll
        for (int j = 0; j < kCpl; ++j) {
          const int c = ch * kCols + lane + 32 * j;
          const float sv =
              c < N ? __fadd_rn(__fmul_rn(srow[c], scale), brow[h * N * N + c]) : 0.0f;
#pragma unroll
          for (int gg = 0; gg < kHeads; ++gg)
            if (gg < heads) x[gg][j] = fmaf(t1[h * heads + gg], sv, x[gg][j]);
        }
      }
#pragma unroll
      for (int gg = 0; gg < kHeads; ++gg) {
        if (gg >= heads) continue;
        float* xrow = S + (gg * 16 + rr) * lds;
#pragma unroll
        for (int j = 0; j < kCpl; ++j) {
          const int c = ch * kCols + lane + 32 * j;
          if (c >= N) continue;
          const float xv = __fadd_rn(x[gg][j], t1b[gg]);
          m[gg] = fmaxf(m[gg], xv);
          xrow[c] = xv;  // this lane's own column: read above by this lane only
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int gg = 0; gg < kHeads; ++gg)
        if (gg < heads) m[gg] = fmaxf(m[gg], __shfl_xor_sync(0xffffffffu, m[gg], off));
#pragma unroll
    for (int gg = 0; gg < kHeads; ++gg) l[gg] = 0.0f;
#pragma unroll 1
    for (int ch = 0; ch < chunks; ++ch)
#pragma unroll
      for (int gg = 0; gg < kHeads; ++gg) {
        if (gg >= heads) continue;
        float* xrow = S + (gg * 16 + rr) * lds;
#pragma unroll
        for (int j = 0; j < kCpl; ++j) {
          const int c = ch * kCols + lane + 32 * j;
          if (c >= N) continue;
          const float ev = expf(__fsub_rn(xrow[c], m[gg]));
          l[gg] += ev;
          xrow[c] = ev;
        }
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int gg = 0; gg < kHeads; ++gg)
        if (gg < heads) l[gg] += __shfl_xor_sync(0xffffffffu, l[gg], off);
#pragma unroll 1
    for (int ch = 0; ch < chunks; ++ch) {
      float p[kHeads][kCpl];
#pragma unroll
      for (int gg = 0; gg < kHeads; ++gg)
#pragma unroll
        for (int j = 0; j < kCpl; ++j) {
          const int c = ch * kCols + lane + 32 * j;
          p[gg][j] = gg < heads && c < N
                         ? __fdiv_rn(S[(gg * 16 + rr) * lds + c], l[gg])
                         : 0.0f;
        }
      // p2 of chunk ch lands on the floats of columns [ch * kCols / 2, (ch + 1) *
      // kCols / 2): read in this chunk or an earlier one, by every lane.
      __syncwarp();
#pragma unroll
      for (int go = 0; go < kHeads; ++go) {
        if (go >= heads) continue;
        __nv_bfloat16* prow = reinterpret_cast<__nv_bfloat16*>(S + (go * 16 + rr) * lds);
#pragma unroll
        for (int j = 0; j < kCpl; ++j) {
          const int c = ch * kCols + lane + 32 * j;
          if (c >= Np) continue;
          float acc = 0.0f;
#pragma unroll
          for (int gg = 0; gg < kHeads; ++gg)
            if (gg < heads) acc = fmaf(t2[gg * heads + go], p[gg][j], acc);
          prow[c] = __float2bfloat16_rn(c < N ? __fadd_rn(acc, t2b[go]) : 0.0f);
        }
      }
      __syncwarp();
    }
  }

  // Phase C: out_g = p2_g . v_g, head by head.
  const int pairs = (dv + 15) / 16;
#pragma unroll 1
  for (int go = 0; go < heads; ++go) {
    __syncthreads();  // phase B done (go 0), or every warp done with v_{go-1}
    copy_rows(vs, L.ldv, v.p + b * v.sb + go * dv, v.sr, N, dv, bvec);
    const __nv_bfloat16* p2 = reinterpret_cast<const __nv_bfloat16*>(S + go * 16 * lds);
#pragma unroll 1
    for (int pr = warp; pr < pairs; pr += kWarps) {
      float o[2][4] = {};
#pragma unroll 1
      for (int j = 0; j < kt; ++j) {
        uint32_t a[4], bv[4];
        ldmatrix_x4(a, p2 + tile_row * ldp + j * 16 + tile_col);
        ldmatrix_x4_trans(bv, vs + (j * 16 + tile_row) * L.ldv + pr * 16 + tile_col);
        mma_bf16_16816(o[0], a, bv[0], bv[1]);
        mma_bf16_16816(o[1], a, bv[2], bv[3]);
      }
      __nv_bfloat16* obase = out + (b * N + r0) * Cv + go * dv;
#pragma unroll
      for (int t = 0; t < 2; ++t)
        store_pair_rows(obase, Cv, o[t], g8, pr * 16 + t * 8 + 2 * t4, rows, dv, 1.0f, bvec);
    }
  }
}

}  // namespace

// The launch plan: {blocks, threads a block, shared memory bytes}. Returns a
// cudaError_t: 0, or cudaErrorInvalidValue (and zeros) when the shape is out
// of range or a block's shared memory would not fit.
extern "C" int dfd_attn4d_long_plan(int B, int N, int heads, int d, int dv, int* plan) {
  for (int i = 0; i < 3; ++i) plan[i] = 0;
  if (B < 1 || N < kMinN || N > kMaxN || heads < 1 || heads > kHeads || d < 16 || d % 16 ||
      dv < 8 || dv % 8)
    return cudaErrorInvalidValue;
  const LongLayout L(N, heads, d, dv);
  if (L.total > kMaxSmemBytes || static_cast<long long>(B) * L.kt > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  plan[0] = B * L.kt;
  plan[1] = kThreads;
  plan[2] = L.total;
  return cudaSuccess;
}

// Returns a cudaError_t: 0 on success. Arguments as dfd_attn4d's (less the
// SM count).
extern "C" int dfd_attn4d_long(const void* q, const void* k, const void* v, const void* bias,
                               const void* th1, const void* th1_b, const void* th2,
                               const void* th2_b, void* out, int B, int N, int heads, int d,
                               int dv, long long q_sb, long long q_sr, long long k_sb,
                               long long k_sr, long long v_sb, long long v_sr, float scale,
                               int vec, void* stream) {
  int plan[3];
  if (dfd_attn4d_long_plan(B, N, heads, d, dv, plan) != 0) return cudaErrorInvalidValue;
  if (plan[2] > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn4d_long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan[2]);
    if (e != cudaSuccess) return e;
  }
  attn4d_long_kernel<<<plan[0], plan[1], plan[2], static_cast<cudaStream_t>(stream)>>>(
      Src{static_cast<const __nv_bfloat16*>(q), q_sb, q_sr},
      Src{static_cast<const __nv_bfloat16*>(k), k_sb, k_sr},
      Src{static_cast<const __nv_bfloat16*>(v), v_sb, v_sr}, static_cast<const float*>(bias),
      static_cast<const float*>(th1), static_cast<const float*>(th1_b),
      static_cast<const float*>(th2), static_cast<const float*>(th2_b),
      static_cast<__nv_bfloat16*>(out), N, heads, d, dv, scale, vec);
  return static_cast<int>(cudaGetLastError());
}
