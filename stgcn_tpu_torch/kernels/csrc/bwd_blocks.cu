// Building blocks of the backward kernels K1b-K4b and K12b (see bwd_blocks.cuh).
//
// The TPU backward kernels (`_head_pallas_bwd`, `_tail_pallas_bwd`,
// `_ohead_pallas_bwd`, `_ofc_pallas_bwd`) recompute their forward per tile
// and accumulate weight gradients in output blocks that stay resident
// across a sequential grid. CUDA blocks run in no order, so here each
// backward is a short pipeline of launches on one stream: K2b-K4b run the
// recompute and the data gradients one thread per vertex lane (contract,
// gate_bwd) with the block's intermediates in a workspace in device memory
// (K1b runs its own fused pair on the register tile, vertex_fused_bwd.cu),
// and every reduction over (batch, time, vertex) is done by a block that
// owns its outputs (weight gradients: partials per slice of the reduction
// on the register tile of f32_tile.cuh, then a fixed-order sum; LayerNorm
// statistics one block per (b, t); the (V, C) affine gradients one thread
// per (c, v)). No float atomics.
//
// What bounds them on the H100: the channel contractions and the weight
// gradients are float32 FMA issue, the elementwise passes are bytes.
// K2b-K4b keep their intermediates in device memory instead of on chip;
// fusing them back is later work (PERF.md).
#include "bwd_blocks.cuh"

#include "f32_tile.cuh"

namespace stgcn {

namespace {

constexpr int kEwThreads = 256;

int ew_blocks(size_t n) {
  const size_t b = (n + kEwThreads - 1) / kEwThreads;
  return (int)(b < 8192 ? (b > 0 ? b : 1) : 8192);
}

// out[i] += a * w[i] for i < kChunk, w 16-byte aligned in shared memory.
__device__ __forceinline__ void fma16(float (&out)[kChunk], float a, const float* w) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int i = 0; i < kChunk / 4; ++i) {
    const float4 q = w4[i];
    out[4 * i + 0] = fmaf(a, q.x, out[4 * i + 0]);
    out[4 * i + 1] = fmaf(a, q.y, out[4 * i + 1]);
    out[4 * i + 2] = fmaf(a, q.z, out[4 * i + 2]);
    out[4 * i + 3] = fmaf(a, q.w, out[4 * i + 3]);
  }
}

// grid (Vp / kLanes * n_chunks, ty, B): one thread per lane, kChunk outputs.
__global__ void __launch_bounds__(kLanes) contract_kernel(ContractArgs a) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // [K * C][kChunk]
  const int n_vt = a.vp / kLanes;
  const int chunk = blockIdx.x / n_vt;
  const int o0 = chunk * kChunk;
  const int v = (blockIdx.x % n_vt) * kLanes + threadIdx.x;
  const int t = blockIdx.y, b = blockIdx.z;
  const int rows = a.k * a.c;
  for (int i = threadIdx.x; i < rows * kChunk; i += blockDim.x) {
    const int r = i / kChunk, oo = i % kChunk, o = o0 + oo;
    const int k = r / a.c, c = r % a.c;
    float val = 0.0f;
    if (o < a.o)
      val = a.back ? a.w[((size_t)k * a.o + o) * a.c + c] : a.w[((size_t)k * a.c + c) * a.o + o];
    w_s[i] = val;
  }
  __syncthreads();

  float acc[kChunk];
#pragma unroll
  for (int i = 0; i < kChunk; ++i) acc[i] = (a.bias && o0 + i < a.o) ? a.bias[o0 + i] : 0.0f;
  for (int k = 0; k < a.k; ++k) {
    const int tx = a.back ? t - k * a.tstep : t + k * a.tstep;
    if (tx < 0 || tx >= a.x_t) continue;
    const float* x = (k < 3 && a.xs[k]) ? a.xs[k] : a.xs[0];
    const float* xr = x + ((size_t)(b * a.x_t + tx) * a.c) * a.vp + v;
    for (int c = 0; c < a.c; ++c) fma16(acc, xr[(size_t)c * a.vp], w_s + (k * a.c + c) * kChunk);
  }
  const int ta = t - a.add_shift;
  const bool add_t = a.add.p && ta >= 0 && ta < a.add.t;
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    const int o = o0 + i;
    if (o >= a.o) break;
    float y = acc[i];
    if (add_t && o < a.add.c) y += a.add.p[((size_t)(b * a.add.t + ta) * a.add.c + o) * a.vp + v];
    if (a.relu_out) y = fmaxf(y, 0.0f);
    const size_t yi = ((size_t)(b * a.ty + t) * a.o + o) * a.vp + v;
    if (a.pos && !(a.pos[yi] > 0.0f)) y = 0.0f;
    a.y[yi] = y;
  }
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

__global__ void gate_bwd_kernel(const float* __restrict__ s, Cv res, int res_shift,
                                const float* __restrict__ da, const float* __restrict__ gps,
                                const float* __restrict__ gpss, int v_true, int act, int c_out,
                                float* __restrict__ ds, float* __restrict__ dxin,
                                float* __restrict__ a_out, int t_len, int vp, size_t n) {
  const bool gated = act == kGlu || act == kGtu;
  const int g = gated ? 2 * c_out : c_out;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int v = (int)(i % vp);
    const size_t row = i / vp;             // (b, t, c) over c_out channels
    const int c = (int)(row % c_out);
    const size_t bt = row / c_out;
    const int t = (int)(bt % t_len), b = (int)(bt / t_len);
    const size_t si = (bt * g + c) * vp + v;
    const float xin = c < res.c
        ? res.p[((size_t)(b * res.t + t + res_shift) * res.c + c) * vp + v] : 0.0f;
    const bool add = gps && v < v_true;
    float dp, dq, av;
    gate_point_bwd(act, s[si], gated ? s[si + (size_t)c_out * vp] : 0.0f, xin, da[i], add,
                   add ? gps[bt] : 0.0f, add ? gpss[bt] : 0.0f, dp, dq, av);
    if (gated) ds[si + (size_t)c_out * vp] = dq;
    ds[si] = dp;
    dxin[i] = dp;
    if (a_out) a_out[i] = av;
  }
}

__global__ void relu_drop_kernel(const float* __restrict__ s, Drop drop,
                                 const float* __restrict__ dzd, float* __restrict__ zd,
                                 float* __restrict__ ds, int vp, size_t n) {
  const uint32_t key = drop_key(drop.seed, drop.site);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int v = (int)(i % vp);
    const float m = drop.threshold ? drop_mask(drop, key, i / vp, v) : 1.0f;
    const float sv = s[i];
    zd[i] = fmaxf(sv, 0.0f) * m;
    ds[i] = sv > 0.0f ? dzd[i] * m : 0.0f;
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

}  // namespace

cudaError_t launch_contract(const ContractArgs& a, cudaStream_t stream) {
  if (a.vp % kLanes != 0) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)a.k * a.c * kChunk;
  cudaError_t err = set_smem(contract_kernel, smem);
  if (err != cudaSuccess) return err;
  const int n_chunks = (a.o + kChunk - 1) / kChunk;
  const dim3 grid((a.vp / kLanes) * n_chunks, a.ty, a.batch);
  contract_kernel<<<grid, kLanes, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_ln_drop(const float* x, const float* mu, const float* rstd, const float* lng,
                           const float* lnb, Drop drop, float* y, int batch, int t, int c,
                           int vp, cudaStream_t stream) {
  const size_t n = (size_t)batch * t * c * vp;
  ln_drop_kernel<<<ew_blocks(n), kEwThreads, 0, stream>>>(x, mu, rstd, lng, lnb, drop, y, t, c,
                                                          vp, n);
  return cudaGetLastError();
}

cudaError_t launch_gate_bwd(const float* s, Cv res, int res_shift, const float* da,
                            const float* gps, const float* gpss, int v_true, int act, int c_out,
                            float* ds, float* dxin, float* a_out, int batch, int t, int vp,
                            cudaStream_t stream) {
  const size_t n = (size_t)batch * t * c_out * vp;
  gate_bwd_kernel<<<ew_blocks(n), kEwThreads, 0, stream>>>(
      s, res, res_shift, da, gps, gpss, v_true, act, c_out, ds, dxin, a_out, t, vp, n);
  return cudaGetLastError();
}

cudaError_t launch_relu_drop(const float* s, Drop drop, const float* dzd, float* zd, float* ds,
                             int batch, int t, int c, int vp, cudaStream_t stream) {
  const size_t n = (size_t)batch * t * c * vp;
  relu_drop_kernel<<<ew_blocks(n), kEwThreads, 0, stream>>>(s, drop, dzd, zd, ds, vp, n);
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

cudaError_t launch_ln_bwd(const float* x, const float* mu, const float* rstd, const float* lng,
                          Drop drop, const float* dy, float* dx, float* dmu, float* drstd,
                          float* dlng, float* dlnb, float* part, int batch, int t, int c, int vp,
                          cudaStream_t stream) {
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
  ln_bwd_affine_kernel<<<(c * vp + 255) / 256, 256, 0, stream>>>(x, mu, rstd, drop, dy, dlng,
                                                                 dlnb, batch * t, c, vp);
  return cudaGetLastError();
}

}  // namespace stgcn
