// Building blocks of the backward kernels K1b-K4b and K12b (see bwd_blocks.cuh).
//
// The TPU backward kernels (`_head_pallas_bwd`, `_tail_pallas_bwd`,
// `_ohead_pallas_bwd`, `_ofc_pallas_bwd`) recompute their forward per tile
// and accumulate weight gradients in output blocks that stay resident
// across a sequential grid. CUDA blocks run in no order, so here each
// backward is a short pipeline of launches on one stream, and every
// reduction over (batch, time, vertex) is done by a block that owns its
// outputs (weight gradients: partials per slice of the reduction on the
// register tile of f32_tile.cuh, then a fixed-order sum; LayerNorm
// statistics one block per (b, t); the (V, C) affine gradients one thread
// per (c, v)). No float atomics.
//
// K1b-K4b and K12b recompute their gated conv (K4b: fc1), run its gate
// backward and take its data gradient in fused passes (gate_pass_kernel,
// gate_dx_kernel, K2b's and K12b's tail_dr_kernel below) on the tile that
// also carries the forward gate GEMM of K1f-K4f (gate_gemm.cu), so the
// pre-activations never reach device memory.
//
// What bounds them on the H100: the channel contractions and the weight
// gradients are float32 FMA issue, the elementwise passes are bytes.
#include "bwd_blocks.cuh"

#include "f32_tile.cuh"

namespace stgcn {

namespace {

constexpr int kEwThreads = 256;

int ew_blocks(size_t n) {
  const size_t b = (n + kEwThreads - 1) / kEwThreads;
  return (int)(b < 8192 ? (b > 0 ? b : 1) : 8192);
}

__global__ void ln_drop_kernel(const float* __restrict__ x, const float* __restrict__ mu,
                               const float* __restrict__ rstd, const float* __restrict__ lng,
                               const float* __restrict__ lnb, Drop drop, float* __restrict__ y,
                               int t, int c, int vp, size_t n) {
  const uint32_t key = drop_key(drop.seed, drop.site);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t row = i / vp;
    const int v = (int)(i % vp), ch = (int)(row % c);
    const size_t bt = row / c;
    float val = (x[i] - mu[bt]) * rstd[bt] * lng[(size_t)ch * vp + v] + lnb[(size_t)ch * vp + v];
    if (drop.threshold) val *= drop_mask(drop, key, row, v);
    y[i] = val;
  }
}

// ---- weight gradients on the shared float32 tile (f32_tile.cuh) ----------
//
// out[(k, c), o] = sum over (b, t, v) of X[b, t + k, c, v] * D[b, t, o, v] is
// a product whose reduction axis (b, t, v) is contiguous along v in both
// operands: A(m, r) / B(n, r) with rows m = (k, c) of X (and a row of ones,
// whose sums are the bias gradient) and n = o of D. The reduction
// r = (b*T + t)*Vp + v is cut into slices of at most kChainMax terms (so no
// f32 chain runs longer; a serial sum over 1M lanes left weight gradients
// about 1e-3 off, relative to their largest entry) and at least kSliceMin,
// as many as fill the card; each block sums one slice of one output tile
// and writes its partial, and a second pass adds the partials of each
// output in slice order. The tile (128 x 128, 128 x 64, 128 x 16 or
// 32 x 16) and which operand is A are picked to waste the fewest FMAs on
// padding rows, so a 3-row product does not run on a 128-row tile and a
// 192-row one runs on three 64-row tiles, and a smaller tile is taken
// where a small product would leave SMs idle (PeMSD7(M)'s batch).

constexpr int kChainMax = 4096;   // terms a float32 chain sums before it is banked
constexpr int kSliceMin = 64;     // least terms of a slice
constexpr int kSMs = 132;         // SMs of an H100 SXM

// the 128-thread and 64-thread tiles get 168 registers a thread (at 128 they spilled)
using WgWide = f32tile::Cfg<128, 128, 16, 8, 8>;
using WgMid = f32tile::Cfg<128, 64, 16, 8, 8, 3>;
using WgNarrow = f32tile::Cfg<128, 16, 16, 8, 4, 6>;
using WgSmall = f32tile::Cfg<32, 16, 16, 4, 4>;

// One side of a weight gradient: rows (k, c) of a cv tensor read at step
// (b, s) as p[b, s + k, c, :] (k < taps, c < c), then `ones` rows of ones.
struct WgSide {
  const float* p;
  int t, c, taps, ones;
  __host__ __device__ int data_rows() const { return p ? taps * c : 0; }
  __host__ __device__ int rows() const { return data_rows() + ones; }
};

// Where row `row` = k C + c of a side lies from the side's lane 0 of a step:
// row Vp, the same at every step (time is the outer axis of [B, T, C, Vp]);
// -1 for the ones row, -2 past the side's rows.
__device__ __forceinline__ int wg_offset(const WgSide& sd, int row, int vp) {
  return row < sd.data_rows() ? row * vp : (row < sd.rows() ? -1 : -2);
}

// A side's lane 0 at step (b, s): p[b, s, 0, 0]; row (k, c) lies wg_offset past it.
__device__ __forceinline__ const float* wg_base(const WgSide& sd, int b, int s, int vp) {
  return sd.p ? sd.p + (size_t)(b * sd.t + s) * sd.c * vp : nullptr;
}

// grid (slices, tiles of A, tiles of B): one slice [x * len, x * len + len)
// of the reduction for one output tile; the partial goes to part[slice]
// laid out as out, [X rows][D rows] (swap: A is the D side).
template <class C>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks)
wgrad_kernel(WgSide sa, WgSide sb, float* __restrict__ part, int swap, int steps_t, int vp,
             long long total, int len) {
  __shared__ __align__(16) f32tile::Smem<C> sm;
  using SA = f32tile::KSlots<C, C::BM>;
  using SB = f32tile::KSlots<C, C::BN>;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.z * C::BN;
  const long long r_lo = (long long)blockIdx.x * len;
  const long long r_hi = r_lo + len < total ? r_lo + len : total;
  const f32tile::Pos<C> pos;
  float acc[C::TM][C::TN];
  f32tile::zero<C>(acc);

  // each slot's row offset, then the loading cursor: step bt = b * steps_t + s, lane v
  int oa[SA::kSlots], ob[SB::kSlots];
#pragma unroll
  for (int p = 0; p < SA::kSlots; ++p) oa[p] = wg_offset(sa, m0 + SA::row(p), vp);
#pragma unroll
  for (int p = 0; p < SB::kSlots; ++p) ob[p] = wg_offset(sb, n0 + SB::row(p), vp);
  int bt = (int)(r_lo / vp), v = (int)(r_lo % vp);
  const float *base_a, *base_b;
  auto point = [&]() {
    const int b = bt / steps_t, st = bt - b * steps_t;
    base_a = wg_base(sa, b, st, vp);
    base_b = wg_base(sb, b, st, vp);
  };
  point();
  float4 va[SA::kSlots], vb[SB::kSlots];
  const float4 one4 = make_float4(1.0f, 1.0f, 1.0f, 1.0f), zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  auto load = [&](int) {
#pragma unroll
    for (int p = 0; p < SA::kSlots; ++p)
      va[p] = oa[p] >= 0
                  ? __ldg(reinterpret_cast<const float4*>(base_a + oa[p] + v + SA::koff(p)))
                  : (oa[p] == -1 ? one4 : zero4);
#pragma unroll
    for (int p = 0; p < SB::kSlots; ++p)
      vb[p] = ob[p] >= 0
                  ? __ldg(reinterpret_cast<const float4*>(base_b + ob[p] + v + SB::koff(p)))
                  : (ob[p] == -1 ? one4 : zero4);
    v += C::BK;
    if (v == vp) {   // the next (b, t) step
      v = 0;
      ++bt;
      point();
    }
  };
  auto store = [&](int buf) {
    SA::store(sm.a[buf], va);
    SB::store(sm.b[buf], vb);
  };
  f32tile::stage_loop<C>(sm, pos, (int)((r_hi - r_lo) / C::BK), acc, load, store);

  const int ma = sa.rows(), nb = sb.rows();
  float* dst = part + (size_t)blockIdx.x * ma * nb;
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int m = m0 + pos.row(i);
    if (m >= ma) continue;
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      const int n = n0 + pos.col(j);
      if (n < nb) dst[swap ? (size_t)n * ma + m : (size_t)m * nb + n] = acc[i][j];
    }
  }
}

// grid ceil(n / 32), block 256: 32 consecutive outputs x 8 groups of slices;
// a group sums its slices in order (banking every kChainMax), then the
// groups' sums are added in order. Outputs i < n_out go to out, the rest
// (the ones row: the bias gradient) to tail.
__global__ void __launch_bounds__(256)
sum_slices_kernel(const float* __restrict__ part, float* __restrict__ out,
                  float* __restrict__ tail, size_t n_out, size_t n, int slices) {
  __shared__ float red[8][32];
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const size_t i = (size_t)blockIdx.x * 32 + lane;
  float bank = 0.0f, acc = 0.0f;
  if (i < n) {
    const int lo = (int)((long long)slices * grp / 8);
    const int hi = (int)((long long)slices * (grp + 1) / 8);
    int run = 0;
    for (int sl = lo; sl < hi; ++sl) {
      acc += part[(size_t)sl * n + i];
      if (++run == kChainMax) {
        bank += acc;
        acc = 0.0f;
        run = 0;
      }
    }
  }
  red[grp][lane] = bank + acc;
  __syncthreads();
  if (grp == 0 && i < n) {
    float total = 0.0f;
    for (int g = 0; g < 8; ++g) total += red[g][lane];
    if (i < n_out) out[i] = total;
    else tail[i - n_out] = total;
  }
}

enum WgShape : int { kWgWide, kWgMid, kWgNarrow, kWgSmall };

struct WgPlan {
  int shape, swap, tiles_a, tiles_b, per_sm, slices, len;
};

// The tile, orientation and slicing of an out [m, n] weight gradient over
// `total` reduction terms: fixed by the shapes alone.
// The block tile of each shape: rows of A, rows of B, and the blocks a SM holds.
template <class C>
void tile_of(int& bm, int& bn, int& per_sm) {
  bm = C::BM, bn = C::BN, per_sm = C::kMinBlocks;
}
void wgrad_tile(int shape, int& bm, int& bn, int& per_sm) {
  switch (shape) {
    case kWgWide: tile_of<WgWide>(bm, bn, per_sm); break;
    case kWgMid: tile_of<WgMid>(bm, bn, per_sm); break;
    case kWgNarrow: tile_of<WgNarrow>(bm, bn, per_sm); break;
    default: tile_of<WgSmall>(bm, bn, per_sm); break;
  }
}

// The share of a shape's FMAs that fall on real outputs, times its FMAs per
// shared load relative to 8 x 8 (8 x 4: 0.5, 4 x 4: 0.25 by this measure),
// for the better of the two orientations (swap: A is the D side).
double wgrad_score(int shape, int m, int n, int& swap) {
  int bm, bn, per_sm;
  wgrad_tile(shape, bm, bn, per_sm);
  const double weight = shape == kWgNarrow ? 0.5 : shape == kWgSmall ? 0.25 : 1.0;
  double best = -1.0;
  for (int sw = 0; sw < 2; ++sw) {
    const int a = sw ? n : m, b = sw ? m : n;
    const double padded = (double)((a + bm - 1) / bm * bm) * ((b + bn - 1) / bn * bn);
    const double score = weight * m * n / padded;
    if (score > best) best = score, swap = sw;
  }
  return best;
}

WgPlan wgrad_plan_for(int shape, int swap, int m, int n, long long total) {
  WgPlan p{};
  p.shape = shape;
  p.swap = swap;
  int bm, bn;
  wgrad_tile(shape, bm, bn, p.per_sm);
  p.tiles_a = ((swap ? n : m) + bm - 1) / bm;
  p.tiles_b = ((swap ? m : n) + bn - 1) / bn;
  const long long tiles = (long long)p.tiles_a * p.tiles_b;
  // four waves of resident blocks, unless the partials would move more than
  // half the operands' bytes; never a slice over kChainMax terms
  const long long fill = (4LL * kSMs * p.per_sm + tiles - 1) / tiles;
  long long cap = (long long)(m + n) * total / (2LL * m * n);
  cap = cap > 1 ? cap : 1;
  const long long chain = (total + kChainMax - 1) / kChainMax;
  long long slices = fill < cap ? fill : cap;
  slices = slices > chain ? slices : chain;
  long long len = (total + slices - 1) / slices;
  len = (len + 15) / 16 * 16;
  len = len < kSliceMin ? kSliceMin : (len > kChainMax ? kChainMax : len);
  p.len = (int)len;
  p.slices = (int)((total + len - 1) / len);
  return p;
}

// The tile, orientation and slicing of an out [m, n] weight gradient over
// `total` reduction terms, fixed by the shapes alone: the shape and
// orientation that waste the fewest FMAs on padding (the larger tile on a
// tie), then a smaller shape while the blocks would not fill the card once.
WgPlan wgrad_plan(int m, int n, long long total) {
  int shape = kWgWide, swap = 0, sw;
  double best = -1.0;
  for (int sh = kWgWide; sh <= kWgSmall; ++sh) {
    const double score = wgrad_score(sh, m, n, sw);
    if (score > best) best = score, shape = sh, swap = sw;
  }
  WgPlan p = wgrad_plan_for(shape, swap, m, n, total);
  while (p.shape != kWgSmall &&
         (long long)p.slices * p.tiles_a * p.tiles_b < (long long)kSMs * p.per_sm) {
    wgrad_score(p.shape + 1, m, n, sw);
    p = wgrad_plan_for(p.shape + 1, sw, m, n, total);
  }
  return p;
}

template <class C>
cudaError_t wgrad_launch(const WgPlan& p, WgSide sa, WgSide sb, float* part, int steps_t, int vp,
                         long long total, cudaStream_t stream) {
  wgrad_kernel<C><<<dim3(p.slices, p.tiles_a, p.tiles_b), C::kThreads, 0, stream>>>(
      sa, sb, part, p.swap, steps_t, vp, total, p.len);
  return cudaGetLastError();
}

// grid (splits, B * T), block kLanes: dx, and per (b, t) row the partial sums
// of the statistics gradients over one slice of `len` (c, v) elements, so a
// thread adds a few hundred terms (one block per row left each thread 1e5
// serial adds at 100k vertices, and 8-96 blocks on 132 SMs). With one slice
// (rows of up to 32768 elements, every row at Vp = 256) the block writes
// dmu and drstd itself and `part` is not read.
__global__ void __launch_bounds__(kLanes)
ln_bwd_stats_kernel(const float* __restrict__ x, const float* __restrict__ mu,
                    const float* __restrict__ rstd, const float* __restrict__ lng, Drop drop,
                    const float* __restrict__ dy, float* __restrict__ dx,
                    float* __restrict__ part, float* __restrict__ dmu,
                    float* __restrict__ drstd, int c, int vp, int len) {
  __shared__ float red[kLanes / 32];
  const uint32_t key = drop_key(drop.seed, drop.site);
  const size_t bt = blockIdx.y;
  const float m = mu[bt], r = rstd[bt];
  const int n = c * vp;
  const int i0 = blockIdx.x * len, i1 = i0 + len < n ? i0 + len : n;
  float s1 = 0.0f, s2 = 0.0f;
  // vp and len are multiples of kLanes: step v by kLanes and wrap into ch
  int ch = (i0 + threadIdx.x) / vp, v = (i0 + threadIdx.x) % vp;
  for (int i = i0 + threadIdx.x; i < i1; i += kLanes, v += kLanes) {
    if (v >= vp) {
      v -= vp;
      ++ch;
    }
    const size_t row = bt * c + ch, idx = row * vp + v;
    float g = dy[idx];
    if (drop.threshold) g *= drop_mask(drop, key, row, v);
    const float dxn = g * lng[(size_t)ch * vp + v];
    dx[idx] = dxn * r;
    s1 += dxn;
    s2 += dxn * (x[idx] - m);
  }
  s1 = block_sum(s1, red);
  s2 = block_sum(s2, red);
  if (threadIdx.x == 0 && gridDim.x == 1) {
    dmu[bt] = -s1 * r;
    drstd[bt] = s2;
  } else if (threadIdx.x == 0) {
    const size_t o = (bt * gridDim.x + blockIdx.x) * 2;
    part[o] = s1;
    part[o + 1] = s2;
  }
}

// grid (B * T), block kLanes: a row's slice partials summed in a fixed
// order (strided per thread, then the block's tree), then dmu and drstd.
__global__ void __launch_bounds__(kLanes)
ln_bwd_stats_sum_kernel(const float* __restrict__ part, const float* __restrict__ rstd,
                        float* __restrict__ dmu, float* __restrict__ drstd, int splits) {
  __shared__ float red[kLanes / 32];
  const size_t bt = blockIdx.x;
  float s1 = 0.0f, s2 = 0.0f;
  for (int k = threadIdx.x; k < splits; k += kLanes) {
    s1 += part[(bt * splits + k) * 2];
    s2 += part[(bt * splits + k) * 2 + 1];
  }
  s1 = block_sum(s1, red);
  s2 = block_sum(s2, red);
  if (threadIdx.x == 0) {
    dmu[bt] = -s1 * rstd[bt];
    drstd[bt] = s2;
  }
}

// one thread per (c, v): the affine gradients, summed over (b, t) in order.
__global__ void ln_bwd_affine_kernel(const float* __restrict__ x, const float* __restrict__ mu,
                                     const float* __restrict__ rstd, Drop drop,
                                     const float* __restrict__ dy, float* __restrict__ dlng,
                                     float* __restrict__ dlnb, int bt_total, int c, int vp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= c * vp) return;
  const uint32_t key = drop_key(drop.seed, drop.site);
  const int ch = i / vp, v = i % vp;
  float sg = 0.0f, sb = 0.0f;
  for (int bt = 0; bt < bt_total; ++bt) {
    const size_t row = (size_t)bt * c + ch, idx = row * vp + v;
    float g = dy[idx];
    if (drop.threshold) g *= drop_mask(drop, key, row, v);
    sg += g * ((x[idx] - mu[bt]) * rstd[bt]);
    sb += g;
  }
  dlng[i] = sg;
  dlnb[i] = sb;
}

// grid (ceil(c * vp / 256), slices), block 256: the affine gradients of
// ln_bwd_affine_kernel over the rows [slice * len, slice * len + len) of
// (b, t), one thread per (c, v), into part[slice] = [dlng | dlnb] (c * vp
// floats each); sum_slices_kernel adds the slices in order. For many (b, t)
// rows over few (c, v): K12b's 4096 rows at PEMS-BAY batch 512, where one
// thread a (c, v) walking every row left 96 blocks on 132 SMs.
__global__ void ln_bwd_affine_part_kernel(const float* __restrict__ x,
                                          const float* __restrict__ mu,
                                          const float* __restrict__ rstd, Drop drop,
                                          const float* __restrict__ dy, float* __restrict__ part,
                                          int bt_total, int c, int vp, int len) {
  const int n = c * vp, i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t key = drop_key(drop.seed, drop.site);
  const int ch = i / vp, v = i % vp;
  const int bt0 = blockIdx.y * len, bt1 = bt0 + len < bt_total ? bt0 + len : bt_total;
  float sg = 0.0f, sb = 0.0f;
  for (int bt = bt0; bt < bt1; ++bt) {
    const size_t row = (size_t)bt * c + ch, idx = row * vp + v;
    float g = dy[idx];
    if (drop.threshold) g *= drop_mask(drop, key, row, v);
    sg += g * ((x[idx] - mu[bt]) * rstd[bt]);
    sb += g;
  }
  float* out = part + (size_t)blockIdx.y * 2 * n;
  out[i] = sg;
  out[n + i] = sb;
}

// The row slices of ln_bwd_affine_part_kernel: enough blocks for four waves
// of 8 blocks a SM's threads (about 1M), slices of at least 16 rows.
int ln_affine_slices(int bt_total, int c, int vp) {
  const long long cols = (long long)c * vp;
  long long s = ((1LL << 20) + cols - 1) / cols;
  const long long most = (bt_total + 15) / 16;
  s = s < most ? s : most;
  return (int)(s > 1 ? s : 1);
}

// ---- the fused backward passes on the shared float32 tile ----------------
//
// K1b, K2b and K3b each recompute a gated temporal conv's pre-activations
// and run the gate backward on them, then take the conv's data gradient.
// Both run here on the register tile of f32_tile.cuh; the gate pass is the
// first product of the forward gate GEMM (gate_gemm.cu, K1f and K4f) with
// the gate backward for its epilogue: the pre-activations live only in the
// tile's registers
// (they were 3.3 GB a K2b call at 100k when written out), the gate backward
// is the tile's epilogue, and the residual's gradient dxin, ds's linear half
// on the input channels, is read back from ds by the data gradient instead
// of being written apart.

constexpr int kGateLanes = 64;   // lanes of a gate-pass block

// the gate pass's tile: gate channels (p then q, 64 each) x 64 lanes, 8 x 8 a
// thread, 3 blocks a SM (168 registers a thread: at 128 it spilled and ran
// 8-12 % slower, as the data gradient's tile did)
template <bool GATED>
using GateCfg = f32tile::Cfg<GATED ? 128 : 64, kGateLanes, 16, GATED ? 8 : 4, 8, 3>;

// K4b's fc1 epilogue (gate_pass_kernel<false, true, true>): per
// channel row c of the thread, da = gy . gaw^T (o ascending, as the head
// policy), zd = relu(s) * mask and ds = da * mask * (s > 0) (s2, zd and
// dzd stay in registers), then the sums over the block's 64 lanes of zd *
// gy[o] for each o < c1 (dw2's) and of ds (db1's): the thread's 8 lanes in
// order, then the 8 threads of its row by xor shuffles (each step adds two
// equal-shape sums, so every thread of the row holds the same bits), written
// by the row's first thread to a_out = part[slice], [c0][c1] then [c0].
template <class C>
__device__ __forceinline__ void fc_epilogue(float (&acc)[C::TM][C::TN], const f32tile::Pos<C>& pos,
                                            const GateUp& up,
                                            const float (&gy_s)[kMaxOut][kGateLanes],
                                            const float (&gw_s)[kMaxOut][64],
                                            float* __restrict__ ds, float* __restrict__ part,
                                            size_t st, int s0, int v0, int b, int vp, int c0,
                                            int act) {
  static_assert(C::TM == 4 && C::TN == 8 && C::kWx == 8,
                "a row's 8 threads are 8 neighbouring lanes of a warp");
  const uint32_t key = drop_key(up.drop.seed, up.drop.site);
  const size_t slice = (size_t)b * (vp / kGateLanes) + blockIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = s0 + 4 * pos.ty + i;
    float da[8], gv[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) da[l] = 0.0f;
    for (int o = 0; o < up.c1; ++o) {   // da = gy . gaw^T, o ascending
      const float wo = gw_s[o][4 * pos.ty + i];
      f32tile::ld4(gv, &gy_s[o][4 * pos.tx]);
      f32tile::ld4(gv + 4, &gy_s[o][kGateLanes / 2 + 4 * pos.tx]);
#pragma unroll
      for (int l = 0; l < 8; ++l) da[l] = fmaf(gv[l], wo, da[l]);
    }
    const size_t row = st * c0 + c;   // fc1's output row, the mask's key (K4f's)
    float zd[8], sd = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = v0 + h * (kGateLanes / 2) + 4 * pos.tx;
      float dp[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float m = 1.0f, dq, av;
        if (up.drop.threshold) m = c < c0 ? drop_mask(up.drop, key, row, v + u) : 0.0f;
        gate_point_bwd(act, acc[i][4 * h + u], 0.0f, 0.0f, da[4 * h + u] * m, false, 0.0f,
                       0.0f, dp[u], dq, av);
        zd[4 * h + u] = c < c0 ? av * m : 0.0f;
      }
      if (c < c0)
        *reinterpret_cast<float4*>(ds + row * vp + v) = make_float4(dp[0], dp[1], dp[2], dp[3]);
      for (int u = 0; u < 4; ++u) sd += dp[u];
    }
    float* out = part + slice * (size_t)c0 * (up.c1 + 1);
    sd += __shfl_xor_sync(0xffffffffu, sd, 4);   // the block's partial of db1[c]
    sd += __shfl_xor_sync(0xffffffffu, sd, 2);
    sd += __shfl_xor_sync(0xffffffffu, sd, 1);
    if (pos.tx == 0 && c < c0) out[(size_t)c0 * up.c1 + c] = sd;
    for (int o = 0; o < up.c1; ++o) {   // the block's partial of dw2[c, o]
      f32tile::ld4(gv, &gy_s[o][4 * pos.tx]);
      f32tile::ld4(gv + 4, &gy_s[o][kGateLanes / 2 + 4 * pos.tx]);
      float p = 0.0f;
#pragma unroll
      for (int l = 0; l < 8; ++l) p = fmaf(zd[l], gv[l], p);
      p += __shfl_xor_sync(0xffffffffu, p, 4);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      if (pos.tx == 0 && c < c0) out[(size_t)c * up.c1 + o] = p;
    }
  }
}

// grid (Vp / 64, t_out * passes, B): for lanes v0 .. v0+63 of output step t
// and gate channels s0 .. s0+63 (pass s0 / 64, so a small batch still fills
// the card), s = bias + sum over rows (k, c) of w[k, c, :] x[b, t+k, c, :]
// (rows ascending, as the forward's tconv), then the upstream gradient da
// by the policy (HEAD: gy . gaw^T, o ascending; else ga, plus the
// LayerNorm-partial cotangents on true lanes inside gate_point_bwd), then
// the gate backward with the in-gate residual x[b, t + kt - 1, c] (c <
// c_in): ds [B, t_out, G, Vp] and, HEAD, a [B, t_out, c0, Vp]. FC (K4b's
// fc1: head policy, relu, no residual) masks da by fc1's dropout and
// writes, in a's place, the block's partial sums of relu(s) * mask * gy
// over its 64 lanes, [c0][c1] at slice b * (Vp / 64) + blockIdx.x of a_out.
// The policy and FC are template parameters: a runtime branch would cost
// the tile registers.
template <bool GATED, bool HEAD, bool FC = false>
__global__ void __launch_bounds__(GateCfg<GATED>::kThreads, GateCfg<GATED>::kMinBlocks)
gate_pass_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, GateUp up, float* __restrict__ ds,
                 float* __restrict__ a_out, int t_in, int c_in, int vp, int kt, int c0,
                 int act) {
  static_assert(!FC || (HEAD && !GATED), "the fc pass: head policy, relu, no residual");
  using C = GateCfg<GATED>;
  using SX = f32tile::RSlots<C, kGateLanes>;
  constexpr int kWPer = C::BK * C::BM / C::kThreads;   // weight values a thread stages
  constexpr int kUp = HEAD ? kMaxOut : 1;              // the head policy's staged rows
  __shared__ __align__(16) f32tile::Smem<C> sm;
  __shared__ __align__(16) float gy_s[kUp][kGateLanes];   // gy[b, t, o, v0 + l]
  __shared__ __align__(16) float gw_s[kUp][64];           // gaw[s0 + c, o] as [o][c]
  const int t_out = t_in - kt + 1;
  const int v0 = blockIdx.x * kGateLanes, t = blockIdx.y % t_out, b = blockIdx.z;
  const int s0 = blockIdx.y / t_out * 64, g = GATED ? 2 * c0 : c0, rows = kt * c_in;
  const size_t st = (size_t)b * t_out + t;   // the output step
  const f32tile::Pos<C> pos;

  if constexpr (HEAD) {   // published by the stage loop's first barrier
    for (int i = threadIdx.x; i < kMaxOut * kGateLanes; i += C::kThreads) {
      const int o = i / kGateLanes, l = i % kGateLanes;
      gy_s[o][l] = o < up.c1 ? up.gy[(st * up.c1 + o) * vp + v0 + l] : 0.0f;
    }
    for (int i = threadIdx.x; i < kMaxOut * 64; i += C::kThreads) {
      const int c = i / kMaxOut, o = i % kMaxOut;
      gw_s[o][c] = (s0 + c < c0 && o < up.c1) ? up.gaw[(size_t)(s0 + c) * up.c1 + o] : 0.0f;
    }
  }

  // the weight column a thread stages: tile row wj (p rows, then q rows)
  const int wj = threadIdx.x % C::BM, wk0 = (threadIdx.x / C::BM) * kWPer;
  float acc[C::TM][C::TN];
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int j = pos.row(i), c = s0 + (j & 63);
    const float bv = c < c0 ? bias[j < 64 ? c : c0 + c] : 0.0f;
#pragma unroll
    for (int l = 0; l < C::TN; ++l) acc[i][l] = bv;
  }
  const int wc = s0 + (wj & 63);
  const float* wcol = wc < c0 ? w + (wj < 64 ? wc : c0 + wc) : nullptr;
  float wv[kWPer];
  float4 xv[SX::kSlots];
  auto load = [&](int step) {
    const int r0 = step * C::BK;
#pragma unroll
    for (int q = 0; q < kWPer; ++q) {
      const int r = r0 + wk0 + q;
      wv[q] = wcol && r < rows ? __ldg(wcol + (size_t)r * g) : 0.0f;
    }
#pragma unroll
    for (int p = 0; p < SX::kSlots; ++p) {
      const int r = r0 + SX::k(p);
      xv[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < rows) {
        const int k = r / c_in, c = r - k * c_in;
        xv[p] = __ldg(reinterpret_cast<const float4*>(
            x + ((size_t)(b * t_in + t + k) * c_in + c) * vp + v0 + SX::roff(p)));
      }
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < kWPer; ++q) sm.a[buf][wk0 + q][wj] = wv[q];
    SX::store(sm.b[buf], xv);
  };
  const int steps = (rows + C::BK - 1) / C::BK;
  f32tile::stage_loop<C>(sm, pos, steps, acc, load, store, rows - (steps - 1) * C::BK);

  float gp = 0.0f, gq = 0.0f;   // the cotangent policy's LayerNorm-partial cotangents
  if constexpr (!HEAD) {
    gp = up.gps[st];
    gq = up.gpss[st];
  }
  if constexpr (FC) {
    fc_epilogue<C>(acc, pos, up, gy_s, gw_s, ds, a_out, st, s0, v0, b, vp, c0, act);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = s0 + 4 * pos.ty + i;
    float da[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) da[l] = 0.0f;
    if constexpr (HEAD) {
      for (int o = 0; o < up.c1; ++o) {   // da = gy . gaw^T, o ascending
        const float wo = gw_s[o][4 * pos.ty + i];
        float gv[8];
        f32tile::ld4(gv, &gy_s[o][4 * pos.tx]);
        f32tile::ld4(gv + 4, &gy_s[o][kGateLanes / 2 + 4 * pos.tx]);
#pragma unroll
        for (int l = 0; l < 8; ++l) da[l] = fmaf(gv[l], wo, da[l]);
      }
    }
    if (c >= c0) continue;
    const size_t srow = st * g + c, arow = st * c0 + c;
    const float* xr = x + ((size_t)(b * t_in + t + kt - 1) * c_in + c) * vp;
#pragma unroll
    for (int h = 0; h < 2; ++h) {   // lanes 4 tx .. and 32 + 4 tx ..
      const int v = v0 + h * (kGateLanes / 2) + 4 * pos.tx;
      float xin[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (c < c_in) f32tile::ld4(xin, xr + v);
      if constexpr (!HEAD) f32tile::ld4(da + 4 * h, up.gy + arow * vp + v);
      float dp[4], dq[4], av[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        gate_point_bwd(act, acc[i][4 * h + u], GATED ? acc[C::TM - 4 + i][4 * h + u] : 0.0f,
                       xin[u], da[4 * h + u], !HEAD && v + u < up.v_true, gp, gq, dp[u],
                       dq[u], av[u]);
      *reinterpret_cast<float4*>(ds + srow * vp + v) = make_float4(dp[0], dp[1], dp[2], dp[3]);
      if (GATED)
        *reinterpret_cast<float4*>(ds + (srow + c0) * vp + v) =
            make_float4(dq[0], dq[1], dq[2], dq[3]);
      if constexpr (HEAD)
        *reinterpret_cast<float4*>(a_out + arow * vp + v) =
            make_float4(av[0], av[1], av[2], av[3]);
    }
  }
}

// the data gradient's tile: 64 output channels x 128 lanes, 8 x 8 a thread,
// 3 blocks a SM
using DxWide = f32tile::Cfg<64, 128, 16, 8, 8, 3>;
// K2b's: its c1 = 16 output channels x 128 lanes, 4 x 8 a thread (DxWide's
// 64 rows would waste three quarters of its FMAs), 6 blocks a SM (at 128
// registers a thread its epilogue spilled)
using DxNarrow = f32tile::Cfg<kMaxOut, 128, 16, 4, 8, 6>;

// The data gradient's product for one block tile: acc[o, l] = sum over taps
// k = k_lo .. k_hi, then g < G, of w[k, o0 + o, g] ds[b, t - k, g, v0 + l]
// (rows o0 + o < c_out of w [kt, c_out, G]; ds [B, t_out, G, Vp]).
template <class C>
__device__ __forceinline__ void dx_product(f32tile::Smem<C>& sm, const f32tile::Pos<C>& pos,
                                           float (&acc)[C::TM][C::TN],
                                           const float* __restrict__ ds,
                                           const float* __restrict__ w, int b, int t, int o0,
                                           int v0, int c_out, int vp, int t_out, int g_n,
                                           int k_lo, int k_hi) {
  using SX = f32tile::RSlots<C, C::BN>;
  constexpr int kWPer = C::BK * C::BM / C::kThreads;
  static_assert(kWPer >= 1 && C::BK * C::BM % C::kThreads == 0, "weight staging divides");
  const int per_tap = (g_n + C::BK - 1) / C::BK;
  const int steps = k_hi >= k_lo ? (k_hi - k_lo + 1) * per_tap : 0;
  float wv[kWPer];
  float4 xv[SX::kSlots];
  auto load = [&](int st) {
    const int k = k_lo + st / per_tap, g0 = (st % per_tap) * C::BK;
#pragma unroll
    for (int q = 0; q < kWPer; ++q) {
      const int e = threadIdx.x + q * C::kThreads, kk = e % C::BK, o = o0 + e / C::BK;
      wv[q] = o < c_out && g0 + kk < g_n ? __ldg(w + ((size_t)k * c_out + o) * g_n + g0 + kk)
                                         : 0.0f;
    }
    const float* xs = ds + ((size_t)(b * t_out + t - k) * g_n + g0) * vp + v0;
#pragma unroll
    for (int p = 0; p < SX::kSlots; ++p)
      xv[p] = g0 + SX::k(p) < g_n
                  ? __ldg(reinterpret_cast<const float4*>(xs + (size_t)SX::k(p) * vp +
                                                          SX::roff(p)))
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < kWPer; ++q) {
      const int e = threadIdx.x + q * C::kThreads;
      sm.a[buf][e % C::BK][e / C::BK] = wv[q];
    }
    SX::store(sm.b[buf], xv);
  };
  f32tile::stage_loop<C>(sm, pos, steps, acc, load, store);
}

// grid (t_in, Vp / BN, B), t fastest so the kt output steps that read one
// step of ds run together:
//   dx[b, t, o, :] = sum over taps k with 0 <= t - k < t_out, then g < G, of
//                    ds[b, t - k, g, :] w[k, o, g]  + ds[b, t - kt + 1, o, :]
// (the last term the residual's gradient dxin, where that step exists; none
// without RES).
template <class C, bool RES = true>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks)
gate_dx_kernel(const float* __restrict__ ds, const float* __restrict__ w,
               float* __restrict__ dx, int t_in, int c_in, int vp, int kt, int g_n) {
  __shared__ __align__(16) f32tile::Smem<C> sm;
  const int t = blockIdx.x, v0 = blockIdx.y * C::BN, b = blockIdx.z;
  const int t_out = t_in - kt + 1;
  const int k_lo = t - t_out + 1 > 0 ? t - t_out + 1 : 0, k_hi = t < kt - 1 ? t : kt - 1;
  const int ta = t - (kt - 1);   // the residual's step in ds
  const f32tile::Pos<C> pos;
  for (int o0 = 0; o0 < c_in; o0 += C::BM) {
    float acc[C::TM][C::TN];
    f32tile::zero<C>(acc);
    dx_product<C>(sm, pos, acc, ds, w, b, t, o0, v0, c_in, vp, t_out, g_n, k_lo, k_hi);
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
      const int o = o0 + pos.row(i);
      if (o >= c_in) continue;
      float* yr = dx + ((size_t)(b * t_in + t) * c_in + o) * vp + v0;
      const float* ar = RES && ta >= 0 && ta < t_out
                            ? ds + ((size_t)(b * t_out + ta) * g_n + o) * vp + v0
                            : nullptr;
#pragma unroll
      for (int j = 0; j < C::TN; j += 4) {
        const int l = pos.col(j);
        float y[4] = {acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]};
        if (ar) {
          float add[4];
          f32tile::ld4(add, ar + l);
#pragma unroll
          for (int u = 0; u < 4; ++u) y[u] += add[u];
        }
        *reinterpret_cast<float4*>(yr + l) = make_float4(y[0], y[1], y[2], y[3]);
      }
    }
  }
}

// A narrow input (K1b block 1: c_in = 1) leaves too few output channels for a
// tile; there one thread takes 4 lanes and walks the steps of ds once, in
// order, adding each step's taps into a window of the kt output steps it
// reaches (registers); the oldest is then complete and is written. ds is
// read once (it is 4.1 GB at 100k), where the tile reads it kt times.
constexpr int kDxNarrow = 4;      // most input channels of the lane kernel
constexpr int kDxTaps = 4;        // most taps of the lane kernel
constexpr int kDxThreads = 64;

// grid (ceil(Vp / (4 kDxThreads)), B, chunks), dynamic shared memory
// G * kt * c_in floats (the weights as [g][k][o]); block z writes the
// output steps [z t_chunk, z t_chunk + t_chunk), walking ds from kt - 1
// steps before them (a small problem, PeMSD7(M)'s, cuts the steps so that
// enough threads run); the sums of dx[b, t, o, :] as gate_dx_kernel's,
// the taps taken k = kt-1 .. 0 (steps t - k ascending); the residual's
// term only with RES.
template <bool RES = true>
__global__ void __launch_bounds__(kDxThreads)
gate_dx_lanes_kernel(const float* __restrict__ ds, const float* __restrict__ w,
                     float* __restrict__ dx, int t_in, int c_in, int vp, int kt, int g_n,
                     int t_chunk) {
  extern __shared__ float4 dx_smem4[];
  float* w_s = reinterpret_cast<float*>(dx_smem4);
  const int n = kt * c_in;
  for (int i = threadIdx.x; i < g_n * n; i += kDxThreads) {
    const int g = i / n, r = i % n, k = r / c_in, o = r % c_in;
    w_s[i] = w[((size_t)k * c_in + o) * g_n + g];
  }
  __syncthreads();
  const int v = (blockIdx.x * kDxThreads + threadIdx.x) * 4, b = blockIdx.y;
  if (v >= vp) return;
  const int t_out = t_in - kt + 1;
  float4 win[kDxTaps][kDxNarrow];   // win[k][o]: output step tp + k
#pragma unroll
  for (int k = 0; k < kDxTaps; ++k)
#pragma unroll
    for (int o = 0; o < kDxNarrow; ++o) win[k][o] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int t0 = blockIdx.z * t_chunk, t_end = t0 + t_chunk < t_in ? t0 + t_chunk : t_in;
  for (int tp = t0 - (kt - 1) > 0 ? t0 - (kt - 1) : 0; tp < t_end; ++tp) {
    if (tp < t_out) {   // ds step tp reaches output steps tp .. tp + kt - 1
      const float* xs = ds + (size_t)(b * t_out + tp) * g_n * vp + v;
#pragma unroll 4
      for (int g = 0; g < g_n; ++g) {
        const float4 xq = __ldg(reinterpret_cast<const float4*>(xs + (size_t)g * vp));
        const float* wg = w_s + g * n;
#pragma unroll
        for (int k = 0; k < kDxTaps; ++k) {
          if (k >= kt) break;
#pragma unroll
          for (int o = 0; o < kDxNarrow; ++o) {
            if (o >= c_in) break;
            const float wk = wg[k * c_in + o];
            win[k][o].x = fmaf(xq.x, wk, win[k][o].x);
            win[k][o].y = fmaf(xq.y, wk, win[k][o].y);
            win[k][o].z = fmaf(xq.z, wk, win[k][o].z);
            win[k][o].w = fmaf(xq.w, wk, win[k][o].w);
          }
        }
      }
    }
    const int ta = tp - (kt - 1);   // the residual's step in ds
#pragma unroll
    for (int o = 0; o < kDxNarrow; ++o) {
      if (o >= c_in || tp < t0) break;
      float4 y = win[0][o];
      if (RES && ta >= 0 && ta < t_out) {
        const float4 r = __ldg(reinterpret_cast<const float4*>(
            ds + ((size_t)(b * t_out + ta) * g_n + o) * vp + v));
        y = make_float4(y.x + r.x, y.y + r.y, y.z + r.z, y.w + r.w);
      }
      *reinterpret_cast<float4*>(dx + ((size_t)(b * t_in + tp) * c_in + o) * vp + v) = y;
    }
#pragma unroll
    for (int k = 0; k + 1 < kDxTaps; ++k)
#pragma unroll
      for (int o = 0; o < kDxNarrow; ++o) win[k][o] = win[k + 1][o];
#pragma unroll
    for (int o = 0; o < kDxNarrow; ++o) win[kDxTaps - 1][o] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// K2b's data gradient on the DxNarrow tile. The staging buffers of the
// product are free once it ends; the dr tile takes their place.
union TailDrSmem {
  f32tile::Smem<DxNarrow> tile;
  float dr[kMaxOut][DxNarrow::BN + 4];
};

// grid (t1, Vp / 128, B), t fastest:
//   dr[b, t, o, :] = (sum over taps k with 0 <= t - k < t2, then g < g2, of
//                     ds2[b, t - k, g, :] c2k[k, o, g] + ds2[b, t - kt + 1, o, :])
//                    * (h[b, t, o, :] > 0)                                    (o < c1)
// then, from the dr tile staged in shared memory, the graph terms'
// gradients, each sum o ascending from 0:
//   dxg[c] = (sum over o of gcw[0][c, o] dr[o], Chebyshev only: xg is the
//            term T_0) + dr[c],     dt_i[c] = sum over o of gcw[i + cheb][c, o] dr[o].
// dr is written for the graph weights' gradients; the three products on it
// cost an eighth of the tile's FMAs and no second read of dr.
__global__ void __launch_bounds__(DxNarrow::kThreads, DxNarrow::kMinBlocks)
tail_dr_kernel(const float* __restrict__ ds2, const float* __restrict__ c2k,
               const float* __restrict__ h, const float* __restrict__ gcw,
               float* __restrict__ dr, float* __restrict__ dxg, float* __restrict__ dt_a,
               float* __restrict__ dt_b, int t1, int c1, int vp, int kt, int g2, int n_terms,
               int cheb) {
  using C = DxNarrow;
  __shared__ __align__(16) TailDrSmem sm;
  __shared__ __align__(16) float gw_s[3][kMaxOut][kMaxOut];   // gcw[m][c][o] as [m][o][c]
  const int t = blockIdx.x, v0 = blockIdx.y * C::BN, b = blockIdx.z;
  const int t2 = t1 - kt + 1, n_c = n_terms + cheb;
  const int k_lo = t - t2 + 1 > 0 ? t - t2 + 1 : 0, k_hi = t < kt - 1 ? t : kt - 1;
  const int ta = t - (kt - 1);   // the residual's step in ds2
  const f32tile::Pos<C> pos;
  for (int i = threadIdx.x; i < 3 * kMaxOut * kMaxOut; i += C::kThreads) {
    const int m = i / (kMaxOut * kMaxOut), o = i / kMaxOut % kMaxOut, c = i % kMaxOut;
    gw_s[m][o][c] = m < n_c && o < c1 && c < c1 ? gcw[((size_t)m * c1 + c) * c1 + o] : 0.0f;
  }
  float acc[C::TM][C::TN];
  f32tile::zero<C>(acc);
  dx_product<C>(sm.tile, pos, acc, ds2, c2k, b, t, 0, v0, c1, vp, t2, g2, k_lo, k_hi);

  const size_t row0 = (size_t)(b * t1 + t) * c1;
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int o = pos.row(i);
#pragma unroll
    for (int j = 0; j < C::TN; j += 4) {
      const int l = pos.col(j);
      float y[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (o < c1) {
        const size_t at = (row0 + o) * vp + v0 + l;
        float add[4] = {0.0f, 0.0f, 0.0f, 0.0f}, hv[4];
        if (ta >= 0 && ta < t2)
          f32tile::ld4(add, ds2 + ((size_t)(b * t2 + ta) * g2 + o) * vp + v0 + l);
        f32tile::ld4(hv, h + at);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          y[u] = acc[i][j + u];
          if (ta >= 0 && ta < t2) y[u] += add[u];
          if (!(hv[u] > 0.0f)) y[u] = 0.0f;
        }
        *reinterpret_cast<float4*>(dr + at) = make_float4(y[0], y[1], y[2], y[3]);
      }
      *reinterpret_cast<float4*>(&sm.dr[o][l]) = make_float4(y[0], y[1], y[2], y[3]);
    }
  }
  __syncthreads();
  for (int q = 0; q <= n_terms; ++q) {   // dxg, then each term's gradient
    const int m = q == 0 ? 0 : q - 1 + cheb;
    float* out = q == 0 ? dxg : (q == 1 ? dt_a : dt_b);
    f32tile::zero<C>(acc);
    if (q > 0 || cheb) {
#pragma unroll
      for (int o = 0; o < kMaxOut; ++o) {
        float wv[4], dv[8];
        f32tile::ld4(wv, &gw_s[m][o][4 * pos.ty]);
        f32tile::ld4(dv, &sm.dr[o][4 * pos.tx]);
        f32tile::ld4(dv + 4, &sm.dr[o][C::BN / 2 + 4 * pos.tx]);
#pragma unroll
        for (int i = 0; i < C::TM; ++i)
#pragma unroll
          for (int j = 0; j < C::TN; ++j) acc[i][j] = fmaf(dv[j], wv[i], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
      const int c = pos.row(i);
      if (c >= c1) continue;
#pragma unroll
      for (int j = 0; j < C::TN; j += 4) {
        const int l = pos.col(j);
        float y[4] = {acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]};
        if (q == 0) {
          float self[4];
          f32tile::ld4(self, &sm.dr[c][l]);
#pragma unroll
          for (int u = 0; u < 4; ++u) y[u] += self[u];
        }
        *reinterpret_cast<float4*>(out + (row0 + c) * vp + v0 + l) =
            make_float4(y[0], y[1], y[2], y[3]);
      }
    }
  }
}

// grid (Vp / kLanes, B * t1), kLanes threads, one lane each: dr's c1 values
// at the lane in registers, then for each term m the outputs
// dt_m[c] = sum over o ascending from 0 of gcw[m][c, o] dr[o].
__global__ void __launch_bounds__(kLanes)
term_grads_kernel(const float* __restrict__ dr, const float* __restrict__ gcw,
                  float* __restrict__ dt, int n_terms, int c1, int vp, size_t term) {
  __shared__ float w_s[kMaxOut * kMaxOut];   // one term's gcw [c][o]
  const int v = blockIdx.x * kLanes + threadIdx.x;
  const size_t row0 = (size_t)blockIdx.y * c1;
  float d[kMaxOut];
#pragma unroll
  for (int o = 0; o < kMaxOut; ++o) d[o] = o < c1 ? dr[(row0 + o) * vp + v] : 0.0f;
  for (int m = 0; m < n_terms; ++m) {
    __syncthreads();
    for (int i = threadIdx.x; i < c1 * c1; i += kLanes) w_s[i] = gcw[(size_t)m * c1 * c1 + i];
    __syncthreads();
    for (int c = 0; c < c1; ++c) {
      float acc = 0.0f;
#pragma unroll
      for (int o = 0; o < kMaxOut; ++o)
        if (o < c1) acc = fmaf(d[o], w_s[c * c1 + o], acc);
      dt[m * term + (row0 + c) * vp + v] = acc;
    }
  }
}

}  // namespace

cudaError_t launch_ln_drop(const float* x, const float* mu, const float* rstd, const float* lng,
                           const float* lnb, Drop drop, float* y, int batch, int t, int c,
                           int vp, cudaStream_t stream) {
  const size_t n = (size_t)batch * t * c * vp;
  ln_drop_kernel<<<ew_blocks(n), kEwThreads, 0, stream>>>(x, mu, rstd, lng, lnb, drop, y, t, c,
                                                          vp, n);
  return cudaGetLastError();
}

size_t wgrad_part_floats(std::initializer_list<WgradShape> calls) {
  size_t most = 0;
  for (const WgradShape& c : calls) {
    if (c.terms <= 0) continue;
    const size_t n = (size_t)wgrad_plan(c.m, c.n, c.terms).slices * c.m * c.n;
    most = n > most ? n : most;
  }
  return most;
}

cudaError_t launch_wgrad_bias(Cv x, int k, Cv d, float* out, float* bias, float* part, int batch,
                              int vp, cudaStream_t stream) {
  if (vp % 16 != 0) return cudaErrorInvalidValue;
  const long long total = (long long)batch * d.t * vp;
  if (batch <= 0 || d.t <= 0) return cudaErrorInvalidConfiguration;
  const WgSide xs{x.p, x.t, x.c, k, bias ? 1 : 0};
  const WgSide ds{d.p, d.t, d.c, 1, 0};
  const int m = xs.rows(), n = d.c;
  const WgPlan p = wgrad_plan(m, n, total);
  if (p.tiles_a > 65535 || p.tiles_b > 65535) return cudaErrorInvalidConfiguration;
  // row offsets within a step are int: (K X.c + D.c) Vp < 2^31 floats
  if ((long long)(xs.data_rows() + n) * vp >= (1LL << 31)) return cudaErrorInvalidValue;
  const WgSide sa = p.swap ? ds : xs, sb = p.swap ? xs : ds;
  auto run = [&](auto cfg) {
    return wgrad_launch<decltype(cfg)>(p, sa, sb, part, d.t, vp, total, stream);
  };
  const cudaError_t err = p.shape == kWgWide ? run(WgWide{})
                          : p.shape == kWgMid ? run(WgMid{})
                          : p.shape == kWgNarrow ? run(WgNarrow{}) : run(WgSmall{});
  if (err != cudaSuccess) return err;
  const size_t n_all = (size_t)m * n, n_out = (size_t)xs.data_rows() * n;
  sum_slices_kernel<<<(unsigned)((n_all + 31) / 32), 256, 0, stream>>>(part, out, bias, n_out,
                                                                       n_all, p.slices);
  return cudaGetLastError();
}

cudaError_t launch_wgrad(Cv x, int k, Cv d, float* out, float* part, int batch, int vp,
                         cudaStream_t stream) {
  // X.p null: the bias gradient alone, a single row of ones
  return x.p ? launch_wgrad_bias(x, k, d, out, nullptr, part, batch, vp, stream)
             : launch_wgrad_bias(x, 1, d, nullptr, out, part, batch, vp, stream);
}

size_t ln_affine_part_floats(int batch, int t, int c, int vp) {
  return (size_t)ln_affine_slices(batch * t, c, vp) * 2 * c * vp;
}

cudaError_t launch_ln_bwd(const float* x, const float* mu, const float* rstd, const float* lng,
                          Drop drop, const float* dy, float* dx, float* dmu, float* drstd,
                          float* dlng, float* dlnb, float* part, int batch, int t, int c, int vp,
                          cudaStream_t stream, float* affine_part) {
  const int n = c * vp;
  int splits = (n + kLanes * 256 - 1) / (kLanes * 256);   // about 256 terms a thread
  splits = splits < 1 ? 1 : (splits > kLnSplits ? kLnSplits : splits);
  const int len = ((n + splits - 1) / splits + kLanes - 1) / kLanes * kLanes;
  ln_bwd_stats_kernel<<<dim3(splits, batch * t), kLanes, 0, stream>>>(
      x, mu, rstd, lng, drop, dy, dx, part, dmu, drstd, c, vp, len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    ln_bwd_stats_sum_kernel<<<batch * t, kLanes, 0, stream>>>(part, rstd, dmu, drstd, splits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (!affine_part) {
    ln_bwd_affine_kernel<<<(c * vp + 255) / 256, 256, 0, stream>>>(x, mu, rstd, drop, dy, dlng,
                                                                   dlnb, batch * t, c, vp);
    return cudaGetLastError();
  }
  const int bt_total = batch * t, slices = ln_affine_slices(bt_total, c, vp);
  const int rows = (bt_total + slices - 1) / slices;   // (b, t) rows a slice
  ln_bwd_affine_part_kernel<<<dim3((unsigned)((n + 255) / 256), slices), 256, 0, stream>>>(
      x, mu, rstd, drop, dy, affine_part, bt_total, c, vp, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_slices_kernel<<<(unsigned)((2 * (size_t)n + 31) / 32), 256, 0, stream>>>(
      affine_part, dlng, dlnb, (size_t)n, 2 * (size_t)n, slices);
  return cudaGetLastError();
}

cudaError_t launch_gate_pass(const float* x, const float* w, const float* bias, GateUp up,
                             float* ds, float* a_out, int batch, int t_in, int c_in, int vp,
                             int kt, int c0, int act, cudaStream_t stream) {
  const bool head = up.gaw != nullptr;
  if (vp % kGateLanes != 0 || (head && up.c1 > kMaxOut) || t_in < kt) return cudaErrorInvalidValue;
  const dim3 grid(vp / kGateLanes, (t_in - kt + 1) * ((c0 + 63) / 64), batch);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  auto run = [&](auto kernel, int threads) {
    kernel<<<grid, threads, 0, stream>>>(x, w, bias, up, ds, a_out, t_in, c_in, vp, kt, c0, act);
  };
  const int gated = GateCfg<true>::kThreads, plain = GateCfg<false>::kThreads;
  if (act == kGlu || act == kGtu)
    head ? run(gate_pass_kernel<true, true>, gated) : run(gate_pass_kernel<true, false>, gated);
  else
    head ? run(gate_pass_kernel<false, true>, plain) : run(gate_pass_kernel<false, false>, plain);
  return cudaGetLastError();
}

cudaError_t launch_gate_dx(const float* ds, const float* w, float* dx, int batch, int t_in,
                           int c_in, int vp, int kt, int g, cudaStream_t stream, bool residual) {
  if (vp % DxWide::BN != 0 || t_in < kt) return cudaErrorInvalidValue;
  if (c_in <= kDxNarrow && kt <= kDxTaps) {
    const size_t smem = sizeof(float) * (size_t)g * kt * c_in;
    auto lanes = residual ? gate_dx_lanes_kernel<true> : gate_dx_lanes_kernel<false>;
    const cudaError_t err = set_smem(lanes, smem);
    if (err != cudaSuccess) return err;
    // steps a block: all of them where the lanes alone give 8 threads per
    // FP32 lane of the card (2^17), fewer below that
    const long long threads = (long long)(vp / 4) * batch;
    long long chunks = ((1LL << 17) + threads - 1) / threads;
    chunks = chunks < 1 ? 1 : (chunks > t_in ? t_in : chunks);
    const int t_chunk = (int)((t_in + chunks - 1) / chunks);
    lanes<<<dim3((vp + 4 * kDxThreads - 1) / (4 * kDxThreads), batch,
                 (t_in + t_chunk - 1) / t_chunk),
            kDxThreads, smem, stream>>>(ds, w, dx, t_in, c_in, vp, kt, g, t_chunk);
  } else {
    auto tile = residual ? gate_dx_kernel<DxWide, true> : gate_dx_kernel<DxWide, false>;
    tile<<<dim3(t_in, vp / DxWide::BN, batch), DxWide::kThreads, 0, stream>>>(ds, w, dx, t_in,
                                                                             c_in, vp, kt, g);
  }
  return cudaGetLastError();
}

namespace {

// The fixed-order sum of K4b's dw2 and db1 partials, slices = B * Vp / 64 of
// n = c1 * (ce + 1) floats: slices s = j * groups + g, padded with zero slices to
// per_group * groups; pass 1 sums each group g over j (sum_slices_kernel
// on groups * n outputs, enough threads to fill the card), pass 2 the
// groups in order.
struct FcReduce {
  int n, slices, groups, per_group;
};

FcReduce fc_reduce(int batch, int vp, int c1, int ce) {
  FcReduce r;
  r.n = c1 * (ce + 1);
  r.slices = batch * (vp / kGateLanes);
  const int want = (32768 + r.n - 1) / r.n;   // about 32k outputs in pass 1
  r.groups = want < r.slices ? want : r.slices;
  r.groups = r.groups > 0 ? r.groups : 1;
  r.per_group = (r.slices + r.groups - 1) / r.groups;
  return r;
}

}  // namespace

size_t fc_pass_part_floats(int batch, int vp, int c1, int ce) {
  const FcReduce r = fc_reduce(batch, vp, c1, ce);
  return ((size_t)r.per_group + 1) * r.groups * r.n;
}

cudaError_t launch_fc_pass(const float* h, const float* w1, const float* b1, const float* gout,
                           const float* w2, Drop drop, float* ds2, float* dw2, float* db1,
                           float* part, int batch, int c_in, int vp, int c1, int ce,
                           cudaStream_t stream) {
  if (vp % kGateLanes != 0 || ce > kMaxOut || ce < 1) return cudaErrorInvalidValue;
  const dim3 grid(vp / kGateLanes, (c1 + 63) / 64, batch);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  const FcReduce r = fc_reduce(batch, vp, c1, ce);
  float* q = part + (size_t)r.per_group * r.groups * r.n;   // pass 1's group sums
  const size_t pad = ((size_t)r.per_group * r.groups - r.slices) * r.n;
  if (pad) STGCN_TRY(cudaMemsetAsync(part + (size_t)r.slices * r.n, 0, pad * sizeof(float),
                                     stream));
  GateUp up{gout, w2, ce, nullptr, nullptr, 0, drop};
  gate_pass_kernel<false, true, true><<<grid, GateCfg<false>::kThreads, 0, stream>>>(
      h, w1, b1, up, ds2, part, 1, c_in, vp, 1, c1, kRelu);
  STGCN_TRY(cudaGetLastError());
  const size_t n1 = (size_t)r.groups * r.n;
  sum_slices_kernel<<<(unsigned)((n1 + 31) / 32), 256, 0, stream>>>(part, q, nullptr, n1, n1,
                                                                     r.per_group);
  STGCN_TRY(cudaGetLastError());
  sum_slices_kernel<<<(unsigned)((r.n + 31) / 32), 256, 0, stream>>>(
      q, dw2, db1, (size_t)c1 * ce, r.n, r.groups);
  return cudaGetLastError();
}

cudaError_t launch_tail_dr(const float* ds2, const float* c2k, const float* h, const float* gcw,
                           float* dr, float* dxg, float* dt_a, float* dt_b, int batch, int t1,
                           int c1, int vp, int kt, int g2, int n_terms, int cheb,
                           cudaStream_t stream) {
  if (vp % DxNarrow::BN != 0 || c1 > kMaxOut || t1 < kt || n_terms < 0 || n_terms > 2 ||
      n_terms + cheb < 1 || n_terms + cheb > 3)
    return cudaErrorInvalidValue;
  tail_dr_kernel<<<dim3(t1, vp / DxNarrow::BN, batch), DxNarrow::kThreads, 0, stream>>>(
      ds2, c2k, h, gcw, dr, dxg, dt_a, dt_b, t1, c1, vp, kt, g2, n_terms, cheb);
  return cudaGetLastError();
}

cudaError_t launch_term_grads(const float* dr, const float* gcw, float* dt, int n_terms,
                              int batch, int t1, int c1, int vp, cudaStream_t stream) {
  if (vp % kLanes != 0 || c1 > kMaxOut || n_terms < 1) return cudaErrorInvalidValue;
  term_grads_kernel<<<dim3(vp / kLanes, batch * t1), kLanes, 0, stream>>>(
      dr, gcw, dt, n_terms, c1, vp, (size_t)batch * t1 * c1 * vp);
  return cudaGetLastError();
}

}  // namespace stgcn
