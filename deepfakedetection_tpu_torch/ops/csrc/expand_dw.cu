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
// Bound on the H100 (chip_smoke.kernel_bound: x read once, y and the pool
//   written once, the expand on the tensor cores, the taps on the CUDA cores
//   in f32): at B3's shapes the HBM bytes at 56 x 56 and at the k3 14 x 14
//   and 7 x 7 x 1392 blocks, the f32 taps at the four k5 shapes, and the
//   operations (the expand's tensor-core work with the taps) at 7 x 7 x 2304.
//   What holds the kernel back in practice is the CUDA cores' issue and
//   latency: per output element k^2 FMAs, its share of the shared loads and
//   bf16 unpacks, and two SiLUs (expand and depthwise), each an exp2 and a
//   reciprocal on the special-function unit, which runs at 1/8 of the FMA
//   rate. Moving the bytes takes a fifth to a tenth of its time.
// Design: the expanded map never reaches HBM, and no expanded element is
//   computed twice. A packing kernel converts wexp to bf16 once a call, [Ce]
//   rows of Cin (the mma B operand with k contiguous). Then a persistent grid
//   (one or two blocks an SM, 7 warps each) walks work items of one whole
//   image x one block of CB channels, a contiguous run of items a block,
//   ordered channel block first, so a block restages its wexp slice, bexp and
//   its taps only when its channel block changes (once or twice a call). An
//   item walks the image in bands of RB rows; a map of at most RB rows is one
//   band. A band's x rows arrive by cp.async while the block runs the
//   previous band's taps (into the buffer that band's expand has read: on
//   the H100 a second buffer was no faster and cost the shared memory of
//   larger bands); the block expands them on the tensor cores (mma.sync
//   m16n8k16, bf16 in, f32 accumulate, fragments by ldmatrix, two m16 tiles
//   a warp sharing each B fragment where that leaves every warp work) into a
//   circular buffer of RB + k - 1 expanded rows, whose columns past the image
//   and one spare all-zero row give the depthwise padding. The bands are
//   shifted by k/2 rows (a first step expands k/2 rows only), so every later
//   step writes RB output rows. A tap item is one output row x 7 columns x 2
//   channels: the thread reads each expanded row of its window once as bf16
//   pairs (one 4-byte shared load for 2 channels) and each value feeds up to
//   k outputs from registers; the taps' weights stay in registers for the
//   channel block. Both SiLUs use the fast exp2 and division (a few ulp of
//   f32, under the sums' own rounding differences). The pool is summed in
//   registers per thread, then over the lanes of the block in a fixed order,
//   and written by the item itself: no partial-sum scratch, no second pass,
//   no atomics, so a run repeats bit for bit. A warp's 4-byte y stores cover
//   128 contiguous bytes (one line) at CB 64. The launch plan (CB, RB;
//   choose_plan below, mirrored by ops/expand_dw.py:plan) weighs the tap and
//   expand rounds of each step, a step's fixed cost, the waves of items over
//   the grid and whether two blocks share an SM; on the H100 it picks the
//   fastest or near-fastest plan at every B3 shape (profile_k2 --plans).
#include "dw_common.cuh"
#include "expand_dw.cuh"
#include "hopper.cuh"

namespace {

using dfd::mma_bf16_16816;
using dfd::pack_bf16;

constexpr int kTW = 7;                 // output columns of one tap item
constexpr int kWarps = 7;              // B3's maps are multiples of 7 wide and high
constexpr int kThreads = 32 * kWarps;  // 224
constexpr int kTwoBlocks = 113 * 1024;  // shared memory under which two blocks share an SM

template <int N>
struct Int {
  static constexpr int value = N;
};

// A row stride in 32-bit words that is 4 mod 8: the 8 rows x 4 columns of an
// mma fragment access, or the 8 16-byte rows of an ldmatrix, fall in distinct
// banks.
__host__ __device__ constexpr int conflict_free(int words) {
  return words + ((12 - words % 8) % 8);
}

// Shared memory layout and step geometry, mirrored by ops/expand_dw.py: the
// band's x (the next band's arrives during this band's taps, into the
// buffer the expand has read), the wexp slice [CB][Kp] bf16, the circular
// buffer plus the zero row, bexp and the pool's lane sums.
struct Layout {
  int Kp, xs_words, wk_words, S, segs, RW, nb, NR, steps, M;
  size_t ws, ring, bex, red, total;  // offsets in bytes; x at 0
};

__host__ __device__ inline Layout layout(int H, int W, int Cin, int CB, int RB, int K) {
  Layout L;
  const int R = K / 2;
  L.Kp = cdiv(Cin, 16) * 16;        // Cin padded to one mma k-step
  L.xs_words = conflict_free(L.Kp / 2);  // x pixel stride (words)
  L.wk_words = L.Kp / 2 + 4;        // wexp row stride (words): an odd number of 16 bytes
  L.S = conflict_free(CB / 2);      // expanded pixel stride (words)
  L.segs = cdiv(W, kTW);
  L.RW = L.segs * kTW + 2 * R;      // expanded row: R zero columns each side, W padded to kTW
  L.nb = cdiv(H, RB);
  L.NR = L.nb == 1 ? H : RB + 2 * R;  // rows of the circular buffer
  L.steps = L.nb == 1 ? 1 : L.nb + 1;
  L.M = (L.nb == 1 ? H : RB) * W;   // pixels of the largest band
  L.ws = dfd::align16(4ull * L.M * L.xs_words);
  L.ring = L.ws + dfd::align16(4ull * CB * L.wk_words);
  L.bex = L.ring + dfd::align16(4ull * (L.NR + 1) * L.RW * L.S);  // + the zero row
  L.red = L.bex + dfd::align16(4ull * CB);
  L.total = L.red + 4ull * (kThreads / (CB / 2)) * CB;
  return L;
}

// Step s of an item: expand rows [lo, hi), then write output rows [olo, ohi).
// One band: everything in one step. Else step 0 expands the first R rows and
// step s >= 1 the rows [(s-1)RB + R, sRB + R) and writes [(s-1)RB, sRB).
struct Band {
  int lo, hi, olo, ohi;
};

__host__ __device__ inline Band band_of(int s, int H, int RB, int R, int nb) {
  Band b;
  if (nb == 1) {
    b.lo = b.olo = 0;
    b.hi = b.ohi = H;
    return b;
  }
  const int lo = s == 0 ? 0 : (s - 1) * RB + R, hi = s * RB + R;
  b.lo = lo < H ? lo : H;
  b.hi = hi < H ? hi : H;
  b.olo = s == 0 ? 0 : (s - 1) * RB;
  b.ohi = s == 0 ? 0 : (s * RB < H ? s * RB : H);
  return b;
}

struct Plan {
  int CB, RB, NR, steps, items, grid, blocks_per_sm, smem;
  long long cost;
};

// The plan for channel block CB and band RB, with a cost in arbitrary units:
// per step the expand's warp rounds and the taps' lane rounds, the waves of
// items over the grid, and two blocks an SM (each at half the SM, hiding
// each other's latency) against one. Integer arithmetic only, so the Python
// mirror picks the same plan.
__host__ __device__ inline Plan make_plan(int B, int H, int W, int Cin, int Ce, int K, int CB,
                                          int RB, int sms) {
  Plan pl;
  RB = RB < H ? RB : H;
  const Layout L = layout(H, W, Cin, CB, RB, K);
  pl.CB = CB;
  pl.RB = RB;
  pl.NR = L.NR;
  pl.steps = L.steps;
  pl.smem = static_cast<int>(L.total);
  pl.blocks_per_sm = L.total <= static_cast<size_t>(kTwoBlocks) ? 2 : 1;
  pl.items = cdiv(Ce, CB) * B;
  pl.grid = pl.items < pl.blocks_per_sm * sms ? pl.items : pl.blocks_per_sm * sms;
  const int R = K / 2, lanes = kThreads / (CB / 2);
  const long long tap_round = 2 * kTW * K * K + 3 * K * (kTW + K - 1) + 308;
  const long long exp_round = 384 + L.Kp;
  long long item = 400;
  for (int s = 0; s < L.steps; ++s) {
    const Band b = band_of(s, H, RB, R, L.nb);
    item += cdiv(cdiv((b.hi - b.lo) * W, 16) * (CB / 32), kWarps) * exp_round;
    item += cdiv((b.ohi - b.olo) * L.segs, lanes) * tap_round;
    item += 800;
  }
  pl.cost = static_cast<long long>(cdiv(pl.items, pl.grid)) * item *
            (pl.blocks_per_sm == 2 ? 47 : 43);
  return pl;
}

// The cheapest plan that fits: CB 64 then 32 (32 only when Ce <= 32), RB from
// H down to max(k/2, 1) (a band has at least the k/2 rows step 0 expands,
// unless the map is one band); the first of equal costs wins.
inline Plan choose_plan(int B, int H, int W, int Cin, int Ce, int K, int sms) {
  Plan best{};
  best.cost = -1;
  const int least = K / 2 > 1 ? K / 2 : 1;
  for (int CB = 64; CB >= 32; CB -= 32) {
    if (CB == 64 && Ce <= 32) continue;
    for (int RB = H; RB >= (least < H ? least : H); --RB) {
      const Plan pl = make_plan(B, H, W, Cin, Ce, K, CB, RB, sms);
      if (pl.smem <= dfd::kMaxSmemBytes && (best.cost < 0 || pl.cost < best.cost)) best = pl;
    }
  }
  return best;
}

struct Params {
  const __nv_bfloat16* x;
  const uint32_t* wpack;
  const float *bexp, *wdw, *bdw;
  __nv_bfloat16* y;
  float* pool;
  int B, H, W, Cin, Ce, Cep, RB, items, vec;
  Layout L;
};

// 16-byte cp.async; a source size of 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}

// SiLU with the fast exponential and division. Against builds with the
// precise expf and IEEE division (profile_k2 --silu, B3's eight shapes at
// batch 128, H100 at 700 W): it changes 0.0013-0.0035% of y's bf16 elements,
// leaves y's largest error from the f32 plain version (12-25 bf16 steps of
// each element) and the pool's unchanged, and K2 takes 2.64 ms a B3 forward
// against 4.26. Phase 3's 16 images read 2.60e-2 / 4.24e-2 of the logit
// scale (against the bf16 / f32 CPU) with it, 3.96e-2 / 2.45e-2 with the
// precise one and 2.03e-2 / 3.25e-2 with only the exponential fast: the
// same bf16 rounding noise drawn three ways, not a bias of the fast SiLU.
__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

// wpack[n][kp] = {bf16(w[2kp][n]), bf16(w[2kp+1][n])}, zero past Cin or Ce:
// [Cep][Kp/2] words, the mma B operand with k contiguous (ldmatrix rows).
__global__ void pack_wexp_kernel(const float* __restrict__ w, uint32_t* __restrict__ out, int Cin,
                                 int Ce, int rows, int Cep) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * Cep) return;
  const int kp = i / Cep, n = i % Cep, k = 2 * kp;  // consecutive threads read consecutive n
  const bool in = n < Ce;
  out[static_cast<size_t>(n) * rows + kp] =
      pack_bf16(in && k < Cin ? w[static_cast<size_t>(k) * Ce + n] : 0.0f,
                in && k + 1 < Cin ? w[static_cast<size_t>(k + 1) * Ce + n] : 0.0f);
}

// Four 8 x 8 b16 matrices from shared memory, one row address a lane.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

template <int K, int CB>
__global__ void __launch_bounds__(kThreads, 2) expand_dw_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int R = K / 2, PAIRS = CB / 2, LANES = kThreads / PAIRS, NG = CB / 32;
  constexpr int S = conflict_free(PAIRS);
  const Layout& L = p.L;
  const int H = p.H, W = p.W, Ce = p.Ce;
  const int tid = threadIdx.x, warp = tid >> 5, lane32 = tid & 31, g = lane32 >> 2, q4 = tid & 3;
  const int pair = tid % PAIRS, lane = tid / PAIRS;
  uint32_t* ws = reinterpret_cast<uint32_t*>(smem + L.ws);
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem + L.ring);
  const int row_words = L.RW * S;
  const uint32_t* zero_row = ring + L.NR * row_words;
  float* bex = reinterpret_cast<float*>(smem + L.bex);
  float* red = reinterpret_cast<float*>(smem + L.red);
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem);  // the band's x [M][xs_words]
  // Row r of the map sits in slot r % NR of the buffer (r itself for one
  // band). Rows are looked up from a step's first row r0 and its slot s0
  // (s0 = r0 % NR, one division a step): r0 <= r < r0 + NR.
  auto slot = [&](int r, int r0, int s0) {
    int i = s0 + r - r0;
    i -= i >= L.NR ? L.NR : 0;
    return ring + i * row_words;
  };
  auto slot_of = [&](int r0) { return L.nb == 1 ? r0 : ((r0 % L.NR) + L.NR) % L.NR; };
  const float inv_w = 1.0f / static_cast<float>(W);  // pixel -> row: exact below 2^22 pixels
  const int drow = LANES / L.segs, dseg = LANES % L.segs;  // a lane's stride over tap items

  const int first = static_cast<int>(static_cast<long long>(blockIdx.x) * p.items / gridDim.x);
  const int last = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * p.items / gridDim.x);
  const int T = (last - first) * L.steps;

  // x rows [lo, hi) of step t's image, Cin zero-padded to Kp:
  // cp.async of 8 channels when Cin % 8 == 0 and x is 16-byte aligned (every
  // EfficientNet width), else one channel at a time, synchronously.
  auto load_x = [&](int t) {
    const int b = (first + t / L.steps) % p.B;
    const Band bd = band_of(t % L.steps, H, p.RB, R, L.nb);
    const int np = (bd.hi - bd.lo) * W;
    const __nv_bfloat16* src = p.x + (static_cast<size_t>(b) * H + bd.lo) * W * p.Cin;
    if (p.vec) {
      const int chunks = L.Kp / 8, dpx = kThreads / chunks, dch = kThreads % chunks;
      int px = tid / chunks, ch = tid % chunks;  // chunk i = px * chunks + ch, stepped by kThreads
      for (int i = tid; i < np * chunks; i += kThreads) {
        const bool in = ch * 8 < p.Cin;
        cp_async16_zfill(xs + px * L.xs_words + ch * 4,
                         in ? src + static_cast<size_t>(px) * p.Cin + ch * 8 : src, in);
        px += dpx;
        ch += dch;
        if (ch >= chunks) {
          ch -= chunks;
          ++px;
        }
      }
    } else {
      __nv_bfloat16* d16 = reinterpret_cast<__nv_bfloat16*>(xs);
      for (int i = tid; i < np * L.Kp; i += kThreads) {
        const int cc = i % L.Kp, px = i / L.Kp;
        d16[px * 2 * L.xs_words + cc] =
            cc < p.Cin ? src[static_cast<size_t>(px) * p.Cin + cc] : __float2bfloat16(0.0f);
      }
    }
  };

  // The circular buffer's padding columns and the zero row stay zero: the
  // expand writes only columns [R, W + R) of the buffer's rows.
  for (int i = tid; i < (L.NR + 1) * row_words; i += kThreads) ring[i] = 0u;

  float2 wr[K * K];  // this thread's taps
  float2 bd = make_float2(0.0f, 0.0f), psum = make_float2(0.0f, 0.0f);
  int cur_cb = -1;
  if (p.vec && T > 0) load_x(0);
  cp_async_commit();
  for (int t = 0; t < T; ++t) {
    const int item = first + t / L.steps, s = t % L.steps;
    const int b = item % p.B, c0 = (item / p.B) * CB, c = c0 + 2 * pair;
    if (c0 != cur_cb) {
      // a new channel block: wexp's pairs, bexp, this thread's taps and bias
      cur_cb = c0;
      for (int i = tid; i < CB * (L.Kp / 8); i += kThreads) {
        const int n = i / (L.Kp / 8), j = (i % (L.Kp / 8)) * 4;
        cp_async16_zfill(ws + n * L.wk_words + j,
                         p.wpack + static_cast<size_t>(c0 + n) * (L.Kp / 2) + j, true);
      }
      for (int j = tid; j < CB; j += kThreads) bex[j] = c0 + j < Ce ? p.bexp[c0 + j] : 0.0f;
#pragma unroll
      for (int tap = 0; tap < K * K; ++tap)
        wr[tap] = make_float2(c < Ce ? p.wdw[static_cast<size_t>(tap) * Ce + c] : 0.0f,
                              c + 1 < Ce ? p.wdw[static_cast<size_t>(tap) * Ce + c + 1] : 0.0f);
      bd = make_float2(c < Ce ? p.bdw[c] : 0.0f, c + 1 < Ce ? p.bdw[c + 1] : 0.0f);
    }
    cp_async_commit();  // the channel block's group (empty when it did not change)
    if (!p.vec) load_x(t);
    cp_async_wait<0>();  // step t's x (sent after step t - 1's expand) and the channel block
    if (s == 0) psum = make_float2(0.0f, 0.0f);
    const Band bnd = band_of(s, H, p.RB, R, L.nb);
    __syncthreads();  // x, ws, bex visible; step t - 1's taps are done with the buffer

    // Expand on the tensor cores: warp items are (16 TILES pixels) x (32
    // channels), TILES m16 tiles sharing each B fragment: two where that
    // leaves every warp an item, else one.
    {
      const int M = (bnd.hi - bnd.lo) * W, s_lo = slot_of(bnd.lo);
      auto expand = [&](auto tiles) {
        constexpr int TILES = decltype(tiles)::value;
        for (int wi = warp; wi < cdiv(M, 16 * TILES) * NG; wi += kWarps) {
          const int m0 = (wi / NG) * 16 * TILES, n0 = (wi % NG) * 32;
          // ldmatrix rows: A lane l reads pixel (l & 7) + 8 ((l >> 3) & 1) at
          // k + 8 (l >> 4); B lane l channel (l & 7) + 8 (l >> 4) at k + 8 ((l >> 3) & 1)
          const int lr = (lane32 & 7) + 8 * ((lane32 >> 3) & 1), lk = 4 * (lane32 >> 4);
          const uint32_t* xa[TILES];
#pragma unroll
          for (int i = 0; i < TILES; ++i)
            xa[i] = xs + min(m0 + 16 * i + lr, M - 1) * L.xs_words + lk;
          const uint32_t* wb =
              ws + (n0 + (lane32 & 7) + 8 * (lane32 >> 4)) * L.wk_words + 4 * ((lane32 >> 3) & 1);
          float acc[TILES][4][4] = {};
          for (int kp = 0; kp < L.Kp / 2; kp += 8) {
            uint32_t a[TILES][4];
#pragma unroll
            for (int i = 0; i < TILES; ++i) ldmatrix_x4(a[i], xa[i] + kp);
#pragma unroll
            for (int np = 0; np < 2; ++np) {  // n tiles 2 np and 2 np + 1
              uint32_t b[4];
              ldmatrix_x4(b, wb + np * 16 * L.wk_words + kp);
#pragma unroll
              for (int i = 0; i < TILES; ++i) {
                mma_bf16_16816(acc[i][2 * np], a[i], b[0], b[1]);
                mma_bf16_16816(acc[i][2 * np + 1], a[i], b[2], b[3]);
              }
            }
          }
#pragma unroll
          for (int r = 0; r < 2 * TILES; ++r) {  // fragment rows g, g + 8 of each tile
            const int m = m0 + g + 8 * r;
            if (m >= M) continue;
            const int row = static_cast<int>((static_cast<float>(m) + 0.5f) * inv_w);
            uint32_t* dst = slot(bnd.lo + row, bnd.lo, s_lo) + (m - row * W + R) * S;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const int cw = n0 + nt * 8 + 2 * q4;  // past Ce: wpack and bex are 0, so e is 0
              const float2 bb = *reinterpret_cast<const float2*>(bex + cw);
              dst[cw / 2] = pack_bf16(silu(acc[r >> 1][nt][2 * (r & 1)] + bb.x),
                                      silu(acc[r >> 1][nt][2 * (r & 1) + 1] + bb.y));
            }
          }
        }
      };
      if (cdiv(M, 32) * NG >= kWarps)
        expand(Int<2>{});
      else
        expand(Int<1>{});
    }
    __syncthreads();  // the band's expanded rows are in the buffer; x is read
    if (p.vec) {  // the next band's x arrives during the taps
      if (t + 1 < T) load_x(t + 1);
      cp_async_commit();
    }

    // Taps: items of one output row x kTW columns for this thread's 2
    // channels, dy-major in f32 as the TPU kernel; rows outside the image
    // read the zero row.
    const int r0 = bnd.olo - R, s0 = slot_of(r0);
    int yy = bnd.olo + lane / L.segs, seg = lane % L.segs;
    for (; yy < bnd.ohi; yy += drow, seg += dseg) {
      if (seg >= L.segs) {
        seg -= L.segs;
        if (++yy >= bnd.ohi) break;
      }
      const int x0 = seg * kTW;
      float2 acc[kTW];
#pragma unroll
      for (int j = 0; j < kTW; ++j) acc[j] = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
        const int r = yy + dy - R;
        const uint32_t* src = (r < 0 || r >= H ? zero_row : slot(r, r0, s0)) + x0 * S + pair;
        float2 v[kTW + K - 1];
#pragma unroll
        for (int j = 0; j < kTW + K - 1; ++j) v[j] = unpack_bf16x2(src[j * S]);
#pragma unroll
        for (int j = 0; j < kTW; ++j) {
#pragma unroll
          for (int dx = 0; dx < K; ++dx) {
            acc[j].x = fmaf(v[j + dx].x, wr[dy * K + dx].x, acc[j].x);
            acc[j].y = fmaf(v[j + dx].y, wr[dy * K + dx].y, acc[j].y);
          }
        }
      }
      __nv_bfloat16* yrow = p.y + ((static_cast<size_t>(b) * H + yy) * W + x0) * Ce + c;
#pragma unroll
      for (int j = 0; j < kTW; ++j) {
        if (x0 + j >= W) break;
        const float v0 = silu(acc[j].x + bd.x), v1 = silu(acc[j].y + bd.y);
        __nv_bfloat16* dst = yrow + static_cast<size_t>(j) * Ce;
        if ((Ce & 1) == 0) {  // c even: the pair is 4-byte aligned
          if (c < Ce) *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (c < Ce) dst[0] = __float2bfloat16_rn(v0);
          if (c + 1 < Ce) dst[1] = __float2bfloat16_rn(v1);
        }
        psum.x += v0;  // the pool is the mean of the activation before rounding
        psum.y += v1;
      }
    }

    if (s == L.steps - 1) {  // the item's last step: its pool, lanes summed in order
      red[lane * CB + 2 * pair] = psum.x;
      red[lane * CB + 2 * pair + 1] = psum.y;
      __syncthreads();
      if (tid < CB && c0 + tid < Ce) {
        float tot = 0.0f;
        for (int l = 0; l < LANES; ++l) tot += red[l * CB + tid];
        p.pool[static_cast<size_t>(b) * Ce + c0 + tid] = tot / static_cast<float>(H * W);
      }
    }
  }
  cp_async_wait<0>();
}

template <int K, int CB>
cudaError_t launch(const Params& prm, int grid, cudaStream_t stream) {
  cudaError_t err = dfd::allow_smem(expand_dw_kernel<K, CB>, prm.L.total);
  if (err != cudaSuccess) return err;
  expand_dw_kernel<K, CB><<<grid, kThreads, prm.L.total, stream>>>(prm);
  return cudaGetLastError();
}

}  // namespace

cudaError_t dfd::launch_expand_dw_silu_pool(const void* x, const void* wexp, const void* bexp,
                                            const void* wdw, const void* bdw, void* y, void* pool,
                                            void* wpack, int B, int H, int W, int Cin, int Ce,
                                            int k, int CB, int RB, cudaStream_t s) {
  if ((CB != 32 && CB != 64) || (k != 3 && k != 5) || B < 1 || H < 1 || W < 1 || Cin < 1 ||
      Ce < 1 || RB < 1 || (RB < k / 2 && RB < H) ||
      static_cast<long long>(B) * H * W > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const Plan pl = make_plan(B, H, W, Cin, Ce, k, CB, RB, sms);
  if (pl.smem > dfd::kMaxSmemBytes) return cudaErrorInvalidValue;
  const int rows = cdiv(Cin, 16) * 8, Cep = cdiv(Ce, 64) * 64;
  if (wexp != nullptr) {  // null: wpack already holds the packed weights
    pack_wexp_kernel<<<cdiv(rows * Cep, 256), 256, 0, s>>>(
        static_cast<const float*>(wexp), static_cast<uint32_t*>(wpack), Cin, Ce, rows, Cep);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  Params prm;
  prm.x = static_cast<const __nv_bfloat16*>(x);
  prm.wpack = static_cast<const uint32_t*>(wpack);
  prm.bexp = static_cast<const float*>(bexp);
  prm.wdw = static_cast<const float*>(wdw);
  prm.bdw = static_cast<const float*>(bdw);
  prm.y = static_cast<__nv_bfloat16*>(y);
  prm.pool = static_cast<float*>(pool);
  prm.B = B;
  prm.H = H;
  prm.W = W;
  prm.Cin = Cin;
  prm.Ce = Ce;
  prm.Cep = Cep;
  prm.RB = pl.RB;
  prm.items = pl.items;
  prm.vec = (Cin % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  prm.L = layout(H, W, Cin, CB, pl.RB, k);
  if (k == 3) return CB == 64 ? launch<3, 64>(prm, pl.grid, s) : launch<3, 32>(prm, pl.grid, s);
  return CB == 64 ? launch<5, 64>(prm, pl.grid, s) : launch<5, 32>(prm, pl.grid, s);
}

// Returns a cudaError_t: 0 on success. wpack is the caller's scratch of
// [ceil(Ce/64)*64][ceil(Cin/16)*8] 32-bit words (ops/expand_dw.py:wpack_words);
// CB and RB are the launch plan (ops/expand_dw.py:plan, dfd_expand_dw_plan).
extern "C" int dfd_expand_dw_silu_pool(const void* x, const void* wexp, const void* bexp,
                                       const void* wdw, const void* bdw, void* y, void* pool,
                                       void* wpack, int B, int H, int W, int Cin, int Ce, int k,
                                       int CB, int RB, void* stream) {
  return dfd::launch_expand_dw_silu_pool(x, wexp, bexp, wdw, bdw, y, pool, wpack, B, H, W, Cin,
                                         Ce, k, CB, RB, static_cast<cudaStream_t>(stream));
}

// The launch plan choose_plan picks for a card of `sms` SMs: out = {CB, RB,
// NR, steps, items, grid, blocks_per_sm, smem bytes}. Returns a cudaError_t.
extern "C" int dfd_expand_dw_plan(int B, int H, int W, int Cin, int Ce, int k, int sms, int* out) {
  if ((k != 3 && k != 5) || B < 1 || H < 1 || W < 1 || Cin < 1 || Ce < 1 || sms < 1)
    return cudaErrorInvalidValue;
  const Plan pl = choose_plan(B, H, W, Cin, Ce, k, sms);
  if (pl.cost < 0) return cudaErrorInvalidValue;
  const int v[8] = {pl.CB, pl.RB, pl.NR, pl.steps, pl.items, pl.grid, pl.blocks_per_sm, pl.smem};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return cudaSuccess;
}
