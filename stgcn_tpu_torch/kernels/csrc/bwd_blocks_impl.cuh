// The kernels of the backward building blocks (bwd_blocks.cuh), templated on
// the operand type T: float, or bf16 for K1b-K4b's bf16 variants (the TPU
// kernels' precision="bfloat16" build). bwd_blocks.cu instantiates the
// float32 launchers, bwd_blocks_bf16.cu the bf16 ones, so the two compile in
// parallel and the float32 kernels keep their code (kernels/sass_ab.py).
// bwd_blocks.cu says what each kernel computes and how it is laid out; the
// bf16 rounding points are listed in bwd_blocks.cuh.
//
// A bf16 operand is read as 8 bytes of four lanes (or one element) and
// widened exactly into the float32 tile and sums, so only the order of the
// sums can differ from the TPU's; values are rounded where the TPU's bf16
// kernels round them (`if constexpr` on T: the float32 instantiations
// compile the float32 kernels' statements unchanged).
#pragma once

#include <type_traits>

#include "bwd_blocks.cuh"
#include "f32_tile.cuh"

namespace stgcn {

namespace {

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, bf16>::value;

constexpr int kEwThreads = 256;

int ew_blocks(size_t n) {
  const size_t b = (n + kEwThreads - 1) / kEwThreads;
  return (int)(b < 8192 ? (b > 0 ? b : 1) : 8192);
}

template <typename T>
__global__ void ln_drop_kernel(const T* __restrict__ x, const float* __restrict__ mu,
                               const float* __restrict__ rstd, const T* __restrict__ lng,
                               const T* __restrict__ lnb, Drop drop, T* __restrict__ y, int t,
                               int c, int vp, size_t n) {
  const uint32_t key = drop_key(drop.seed, drop.site);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t row = i / vp;
    const int v = (int)(i % vp), ch = (int)(row % c);
    const size_t bt = row / c;
    float val = (widen(x[i]) - mu[bt]) * rstd[bt] * widen(lng[(size_t)ch * vp + v]) +
                widen(lnb[(size_t)ch * vp + v]);
    if constexpr (kIsBf16<T>) {   // the normalized value, then the mask's product, rounded
      val = bf16r(val);
      if (drop.threshold) val = bf16r(val * drop_mask(drop, key, row, v));
    } else {
      if (drop.threshold) val *= drop_mask(drop, key, row, v);
    }
    st1(y + i, val);
  }
}

// ---- weight gradients on the shared float32 tile (f32_tile.cuh) ----------

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
template <typename T>
struct WgSide {
  const T* p;
  int t, c, taps, ones;
  __host__ __device__ int data_rows() const { return p ? taps * c : 0; }
  __host__ __device__ int rows() const { return data_rows() + ones; }
};

// Where row `row` = k C + c of a side lies from the side's lane 0 of a step:
// row Vp, the same at every step (time is the outer axis of [B, T, C, Vp]);
// -1 for the ones row, -2 past the side's rows.
template <typename T>
__device__ __forceinline__ int wg_offset(const WgSide<T>& sd, int row, int vp) {
  return row < sd.data_rows() ? row * vp : (row < sd.rows() ? -1 : -2);
}

// A side's lane 0 at step (b, s): p[b, s, 0, 0]; row (k, c) lies wg_offset past it.
template <typename T>
__device__ __forceinline__ const T* wg_base(const WgSide<T>& sd, int b, int s, int vp) {
  return sd.p ? sd.p + (size_t)(b * sd.t + s) * sd.c * vp : nullptr;
}

// grid (slices, tiles of A, tiles of B): one slice [x * len, x * len + len)
// of the reduction for one output tile; the partial goes to part[slice]
// laid out as out, [X rows][D rows] (swap: A is the D side).
template <class C, typename T>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks)
wgrad_kernel(WgSide<T> sa, WgSide<T> sb, float* __restrict__ part, int swap, int steps_t, int vp,
             long long total, int len) {
  __shared__ __align__(16) f32tile::Smem<C> sm;
  using SA = f32tile::KSlots<C, C::BM>;
  using SB = f32tile::KSlots<C, C::BN>;
  using L4 = Lanes4<T>;
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
  const T *base_a, *base_b;
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
      va[p] = oa[p] >= 0 ? L4::widen(L4::load(base_a + oa[p] + v + SA::koff(p)))
                         : (oa[p] == -1 ? one4 : zero4);
#pragma unroll
    for (int p = 0; p < SB::kSlots; ++p)
      vb[p] = ob[p] >= 0 ? L4::widen(L4::load(base_b + ob[p] + v + SB::koff(p)))
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

template <class C, typename T>
cudaError_t wgrad_launch(const WgPlan& p, WgSide<T> sa, WgSide<T> sb, float* part, int steps_t,
                         int vp, long long total, cudaStream_t stream) {
  wgrad_kernel<C, T><<<dim3(p.slices, p.tiles_a, p.tiles_b), C::kThreads, 0, stream>>>(
      sa, sb, part, p.swap, steps_t, vp, total, p.len);
  return cudaGetLastError();
}

// grid (splits, B * T), block kLanes: dx, and per (b, t) row the partial sums
// of the statistics gradients over one slice of `len` (c, v) elements, so a
// thread adds a few hundred terms (one block per row left each thread 1e5
// serial adds at 100k vertices, and 8-96 blocks on 132 SMs). With one slice
// (rows of up to 32768 elements, every row at Vp = 256) the block writes
// dmu and drstd itself and `part` is not read.
template <typename T>
__global__ void __launch_bounds__(kLanes)
ln_bwd_stats_kernel(const T* __restrict__ x, const float* __restrict__ mu,
                    const float* __restrict__ rstd, const T* __restrict__ lng, Drop drop,
                    const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
                    float* __restrict__ dmu, float* __restrict__ drstd, int c, int vp, int len) {
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
    float g = widen(dy[idx]);
    if (drop.threshold) {
      g *= drop_mask(drop, key, row, v);
      if constexpr (kIsBf16<T>) g = bf16r(g);   // dy * mask, a bf16 product
    }
    const float dxn = g * widen(lng[(size_t)ch * vp + v]);
    st1(dx + idx, dxn * r);
    s1 += dxn;
    s2 += dxn * (widen(x[idx]) - m);
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

// one thread per (c, v): the affine gradients, summed over (b, t) in order
// (bf16: in float32, rounded once at the store).
template <typename T>
__global__ void ln_bwd_affine_kernel(const T* __restrict__ x, const float* __restrict__ mu,
                                     const float* __restrict__ rstd, Drop drop,
                                     const T* __restrict__ dy, T* __restrict__ dlng,
                                     T* __restrict__ dlnb, int bt_total, int c, int vp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= c * vp) return;
  const uint32_t key = drop_key(drop.seed, drop.site);
  const int ch = i / vp, v = i % vp;
  float sg = 0.0f, sb = 0.0f;
  for (int bt = 0; bt < bt_total; ++bt) {
    const size_t row = (size_t)bt * c + ch, idx = row * vp + v;
    float g = widen(dy[idx]);
    if (drop.threshold) {
      g *= drop_mask(drop, key, row, v);
      if constexpr (kIsBf16<T>) g = bf16r(g);
    }
    sg += g * ((widen(x[idx]) - mu[bt]) * rstd[bt]);
    sb += g;
  }
  st1(dlng + i, sg);
  st1(dlnb + i, sb);
}

// The statistics gradients and dx of launch_ln_bwd (ln_bwd_stats_kernel,
// and the fixed-order sum of its slice partials where a row has several).
template <typename T>
cudaError_t ln_bwd_stats_run(const T* x, const float* mu, const float* rstd, const T* lng,
                             Drop drop, const T* dy, T* dx, float* dmu, float* drstd,
                             float* part, int batch, int t, int c, int vp, cudaStream_t stream) {
  const int n = c * vp;
  int splits = (n + kLanes * 256 - 1) / (kLanes * 256);   // about 256 terms a thread
  splits = splits < 1 ? 1 : (splits > kLnSplits ? kLnSplits : splits);
  const int len = ((n + splits - 1) / splits + kLanes - 1) / kLanes * kLanes;
  ln_bwd_stats_kernel<T><<<dim3(splits, batch * t), kLanes, 0, stream>>>(
      x, mu, rstd, lng, drop, dy, dx, part, dmu, drstd, c, vp, len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    ln_bwd_stats_sum_kernel<<<batch * t, kLanes, 0, stream>>>(part, rstd, dmu, drstd, splits);
    err = cudaGetLastError();
  }
  return err;
}

// ---- the fused backward passes on the shared float32 tile ----------------

constexpr int kGateLanes = 64;   // lanes of a gate-pass block

// the gate pass's tile: gate channels (p then q, 64 each) x 64 lanes, 8 x 8 a
// thread, 3 blocks a SM (168 registers a thread: at 128 it spilled and ran
// 8-12 % slower, as the data gradient's tile did)
template <bool GATED>
using GateCfg = f32tile::Cfg<GATED ? 128 : 64, kGateLanes, 16, GATED ? 8 : 4, 8, 3>;

// K4b's fc1 epilogue (gate_pass_kernel<T, false, true, true>): per
// channel row c of the thread, da = gy . gaw^T (o ascending, as the head
// policy), zd = relu(s) * mask and ds = da * mask * (s > 0) (s2, zd and
// dzd stay in registers), then the sums over the block's 64 lanes of zd *
// gy[o] for each o < c1 (dw2's) and of ds (db1's): the thread's 8 lanes in
// order, then the 8 threads of its row by xor shuffles (each step adds two
// equal-shape sums, so every thread of the row holds the same bits), written
// by the row's first thread to a_out = part[slice], [c0][c1] then [c0].
// bf16: dzd = da rounded, s2 rounded, dz = dzd * mask and zd = relu(s2) *
// mask each a bf16 product, ds2 = dz * (s2 > 0).
template <class C, typename T>
__device__ __forceinline__ void fc_epilogue(float (&acc)[C::TM][C::TN], const f32tile::Pos<C>& pos,
                                            const GateUpT<T>& up,
                                            const float (&gy_s)[kMaxOut][kGateLanes],
                                            const float (&gw_s)[kMaxOut][64],
                                            T* __restrict__ ds, float* __restrict__ part,
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
        float m = 1.0f;
        if (up.drop.threshold) m = c < c0 ? drop_mask(up.drop, key, row, v + u) : 0.0f;
        if constexpr (!kIsBf16<T>) {
          float dq, av;
          gate_point_bwd(act, acc[i][4 * h + u], 0.0f, 0.0f, da[4 * h + u] * m, false, 0.0f,
                         0.0f, dp[u], dq, av);
          zd[4 * h + u] = c < c0 ? av * m : 0.0f;
        } else {
          const float s2 = bf16r(acc[i][4 * h + u]);
          dp[u] = s2 > 0.0f ? bf16r(bf16r(da[4 * h + u]) * m) : 0.0f;
          zd[4 * h + u] = c < c0 ? bf16r(fmaxf(s2, 0.0f) * m) : 0.0f;
        }
      }
      if (c < c0) st4(ds + row * vp + v, dp);
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
// the tile registers. bf16 (T): s and the head policy's da rounded, the gate
// backward of gate_point_bwd_bf16, ds and a written in bf16.
template <typename T, bool GATED, bool HEAD, bool FC = false>
__global__ void __launch_bounds__(GateCfg<GATED>::kThreads, GateCfg<GATED>::kMinBlocks)
gate_pass_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const float* __restrict__ bias, GateUpT<T> up, T* __restrict__ ds,
                 std::conditional_t<FC, float, T>* __restrict__ a_out, int t_in, int c_in,
                 int vp, int kt, int c0, int act) {
  static_assert(!FC || (HEAD && !GATED), "the fc pass: head policy, relu, no residual");
  constexpr bool BF16 = kIsBf16<T>;
  using C = GateCfg<GATED>;
  using SX = f32tile::RSlots<C, kGateLanes>;
  using L4 = Lanes4<T>;
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
      gy_s[o][l] = o < up.c1 ? widen(up.gy[(st * up.c1 + o) * vp + v0 + l]) : 0.0f;
    }
    for (int i = threadIdx.x; i < kMaxOut * 64; i += C::kThreads) {
      const int c = i / kMaxOut, o = i % kMaxOut;
      gw_s[o][c] =
          (s0 + c < c0 && o < up.c1) ? widen(up.gaw[(size_t)(s0 + c) * up.c1 + o]) : 0.0f;
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
  const T* wcol = wc < c0 ? w + (wj < 64 ? wc : c0 + wc) : nullptr;
  float wv[kWPer];
  typename L4::V xv[SX::kSlots];
  auto load = [&](int step) {
    const int r0 = step * C::BK;
#pragma unroll
    for (int q = 0; q < kWPer; ++q) {
      const int r = r0 + wk0 + q;
      wv[q] = wcol && r < rows ? ldw(wcol + (size_t)r * g) : 0.0f;
    }
#pragma unroll
    for (int p = 0; p < SX::kSlots; ++p) {
      const int r = r0 + SX::k(p);
      if constexpr (BF16) xv[p] = make_uint2(0u, 0u);
      else xv[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < rows) {
        const int k = r / c_in, c = r - k * c_in;
        xv[p] = L4::load(x + ((size_t)(b * t_in + t + k) * c_in + c) * vp + v0 + SX::roff(p));
      }
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < kWPer; ++q) sm.a[buf][wk0 + q][wj] = wv[q];
    if constexpr (BF16) {   // widened into float32 slots
      float4 xf[SX::kSlots];
#pragma unroll
      for (int p = 0; p < SX::kSlots; ++p) xf[p] = L4::widen(xv[p]);
      SX::store(sm.b[buf], xf);
    } else {
      SX::store(sm.b[buf], xv);
    }
  };
  const int steps = (rows + C::BK - 1) / C::BK;
  f32tile::stage_loop<C>(sm, pos, steps, acc, load, store, rows - (steps - 1) * C::BK);

  float gp = 0.0f, gq = 0.0f;   // the cotangent policy's LayerNorm-partial cotangents
  if constexpr (!HEAD) {
    gp = up.gps[st];
    gq = up.gpss[st];
  }
  if constexpr (FC) {
    fc_epilogue<C, T>(acc, pos, up, gy_s, gw_s, ds, a_out, st, s0, v0, b, vp, c0, act);
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
      if constexpr (BF16) {   // da1, rounded
#pragma unroll
        for (int l = 0; l < 8; ++l) da[l] = bf16r(da[l]);
      }
    }
    if (c >= c0) continue;
    const size_t srow = st * g + c, arow = st * c0 + c;
    const T* xr = x + ((size_t)(b * t_in + t + kt - 1) * c_in + c) * vp;
#pragma unroll
    for (int h = 0; h < 2; ++h) {   // lanes 4 tx .. and 32 + 4 tx ..
      const int v = v0 + h * (kGateLanes / 2) + 4 * pos.tx;
      float xin[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (c < c_in) ld4w(xin, xr + v);
      if constexpr (!HEAD) ld4w(da + 4 * h, up.gy + arow * vp + v);
      float dp[4], dq[4], av[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if constexpr (!BF16)
          gate_point_bwd(act, acc[i][4 * h + u], GATED ? acc[C::TM - 4 + i][4 * h + u] : 0.0f,
                         xin[u], da[4 * h + u], !HEAD && v + u < up.v_true, gp, gq, dp[u],
                         dq[u], av[u]);
        else   // s rounded first
          gate_point_bwd_bf16(act, bf16r(acc[i][4 * h + u]),
                              GATED ? bf16r(acc[C::TM - 4 + i][4 * h + u]) : 0.0f, xin[u],
                              da[4 * h + u], !HEAD && v + u < up.v_true, gp, gq, dp[u], dq[u],
                              av[u]);
      }
      st4(ds + srow * vp + v, dp);
      if (GATED) st4(ds + (srow + c0) * vp + v, dq);
      if constexpr (HEAD) st4(a_out + arow * vp + v, av);
    }
  }
}

template <typename T>
cudaError_t gate_pass_run(const T* x, const T* w, const float* bias, GateUpT<T> up, T* ds,
                          T* a_out, int batch, int t_in, int c_in, int vp, int kt, int c0,
                          int act, cudaStream_t stream) {
  const bool head = up.gaw != nullptr;
  if (vp % kGateLanes != 0 || (head && up.c1 > kMaxOut) || t_in < kt) return cudaErrorInvalidValue;
  const dim3 grid(vp / kGateLanes, (t_in - kt + 1) * ((c0 + 63) / 64), batch);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  auto run = [&](auto kernel, int threads) {
    kernel<<<grid, threads, 0, stream>>>(x, w, bias, up, ds, a_out, t_in, c_in, vp, kt, c0, act);
  };
  const int gated = GateCfg<true>::kThreads, plain = GateCfg<false>::kThreads;
  if (act == kGlu || act == kGtu)
    head ? run(gate_pass_kernel<T, true, true>, gated)
         : run(gate_pass_kernel<T, true, false>, gated);
  else
    head ? run(gate_pass_kernel<T, false, true>, plain)
         : run(gate_pass_kernel<T, false, false>, plain);
  return cudaGetLastError();
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
template <class C, typename T>
__device__ __forceinline__ void dx_product(f32tile::Smem<C>& sm, const f32tile::Pos<C>& pos,
                                           float (&acc)[C::TM][C::TN],
                                           const T* __restrict__ ds,
                                           const T* __restrict__ w, int b, int t, int o0,
                                           int v0, int c_out, int vp, int t_out, int g_n,
                                           int k_lo, int k_hi) {
  using SX = f32tile::RSlots<C, C::BN>;
  using L4 = Lanes4<T>;
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
      wv[q] = o < c_out && g0 + kk < g_n ? ldw(w + ((size_t)k * c_out + o) * g_n + g0 + kk)
                                         : 0.0f;
    }
    const T* xs = ds + ((size_t)(b * t_out + t - k) * g_n + g0) * vp + v0;
#pragma unroll
    for (int p = 0; p < SX::kSlots; ++p)
      xv[p] = g0 + SX::k(p) < g_n ? L4::widen(L4::load(xs + (size_t)SX::k(p) * vp + SX::roff(p)))
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

// The bf16 data gradient's taps (gate_dx_bf16_kernel, tail_dr_kernel<bf16>):
// for k = k_lo .. k_hi, that tap's product alone, rounded to bf16, added in
// bf16 onto the taps before it (the TPU's `_tconv_bwd_cv` rounds each tap's
// dot and sums the taps in bf16 in this order). take(i, j, tap, first)
// folds one element of a tap into the caller's running sum.
template <class C, class Take>
__device__ __forceinline__ void dx_taps_bf16(f32tile::Smem<C>& sm, const f32tile::Pos<C>& pos,
                                             const bf16* __restrict__ ds,
                                             const bf16* __restrict__ w, int b, int t, int o0,
                                             int v0, int c_out, int vp, int t_out, int g_n,
                                             int k_lo, int k_hi, Take take) {
  for (int k = k_lo; k <= k_hi; ++k) {
    float acc[C::TM][C::TN];
    f32tile::zero<C>(acc);
    dx_product<C, bf16>(sm, pos, acc, ds, w, b, t, o0, v0, c_out, vp, t_out, g_n, k, k);
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j) take(i, j, bf16r(acc[i][j]), k == k_lo);
  }
}

// A narrow input (K1b block 1: c_in = 1) leaves too few output channels for a
// tile; there one thread takes 4 lanes and walks the steps of ds once (the
// lane kernels, gate_dx_lanes_kernel in bwd_blocks.cu and its bf16 variant).
constexpr int kDxNarrow = 4;      // most input channels of the lane kernel
constexpr int kDxTaps = 4;        // most taps of the lane kernel
constexpr int kDxThreads = 64;

// The lane kernels' cut of the steps: all of them where the lanes alone give
// 8 threads per FP32 lane of the card (2^17), fewer below that.
int dx_lanes_chunk(int batch, int t_in, int vp) {
  const long long threads = (long long)(vp / 4) * batch;
  long long chunks = ((1LL << 17) + threads - 1) / threads;
  chunks = chunks < 1 ? 1 : (chunks > t_in ? t_in : chunks);
  return (int)((t_in + chunks - 1) / chunks);
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
// cost an eighth of the tile's FMAs and no second read of dr. bf16: the taps
// of dx_taps_bf16 (in registers), the residual a bf16 add, each graph term's
// sum rounded, dxg = dr + dcterms_0 a bf16 add.
template <typename T>
__global__ void __launch_bounds__(DxNarrow::kThreads, DxNarrow::kMinBlocks)
tail_dr_kernel(const T* __restrict__ ds2, const T* __restrict__ c2k, const T* __restrict__ h,
               const T* __restrict__ gcw, T* __restrict__ dr, T* __restrict__ dxg,
               T* __restrict__ dt_a, T* __restrict__ dt_b, int t1, int c1, int vp, int kt, int g2,
               int n_terms, int cheb) {
  using C = DxNarrow;
  constexpr bool BF16 = kIsBf16<T>;
  __shared__ __align__(16) TailDrSmem sm;
  __shared__ __align__(16) float gw_s[3][kMaxOut][kMaxOut];   // gcw[m][c][o] as [m][o][c]
  const int t = blockIdx.x, v0 = blockIdx.y * C::BN, b = blockIdx.z;
  const int t2 = t1 - kt + 1, n_c = n_terms + cheb;
  const int k_lo = t - t2 + 1 > 0 ? t - t2 + 1 : 0, k_hi = t < kt - 1 ? t : kt - 1;
  const int ta = t - (kt - 1);   // the residual's step in ds2
  const f32tile::Pos<C> pos;
  for (int i = threadIdx.x; i < 3 * kMaxOut * kMaxOut; i += C::kThreads) {
    const int m = i / (kMaxOut * kMaxOut), o = i / kMaxOut % kMaxOut, c = i % kMaxOut;
    gw_s[m][o][c] =
        m < n_c && o < c1 && c < c1 ? widen(gcw[((size_t)m * c1 + c) * c1 + o]) : 0.0f;
  }
  float acc[C::TM][C::TN];
  if constexpr (!BF16) {
    f32tile::zero<C>(acc);
    dx_product<C, T>(sm.tile, pos, acc, ds2, c2k, b, t, 0, v0, c1, vp, t2, g2, k_lo, k_hi);
  } else {   // the taps rounded one by one, summed in bf16 into acc
    dx_taps_bf16<C>(sm.tile, pos, ds2, c2k, b, t, 0, v0, c1, vp, t2, g2, k_lo, k_hi,
                    [&](int i, int j, float tap, bool first) {
                      acc[i][j] = first ? tap : bf16r(acc[i][j] + tap);
                    });
  }

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
        if (ta >= 0 && ta < t2) ld4w(add, ds2 + ((size_t)(b * t2 + ta) * g2 + o) * vp + v0 + l);
        ld4w(hv, h + at);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          y[u] = acc[i][j + u];
          if (ta >= 0 && ta < t2) {
            if constexpr (BF16) y[u] = bf16r(y[u] + add[u]);
            else y[u] += add[u];
          }
          if (!(hv[u] > 0.0f)) y[u] = 0.0f;
        }
        st4(dr + at, y);
      }
      *reinterpret_cast<float4*>(&sm.dr[o][l]) = make_float4(y[0], y[1], y[2], y[3]);
    }
  }
  __syncthreads();
  for (int q = 0; q <= n_terms; ++q) {   // dxg, then each term's gradient
    const int m = q == 0 ? 0 : q - 1 + cheb;
    T* out = q == 0 ? dxg : (q == 1 ? dt_a : dt_b);
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
          for (int u = 0; u < 4; ++u) {
            if constexpr (BF16) y[u] = bf16r(y[u]);   // dcterms_0, then a bf16 add (st4 rounds)
            y[u] += self[u];
          }
        }
        st4(out + (row0 + c) * vp + v0 + l, y);   // bf16: each term's sum rounded
      }
    }
  }
}

template <typename T>
cudaError_t tail_dr_run(const T* ds2, const T* c2k, const T* h, const T* gcw, T* dr, T* dxg,
                        T* dt_a, T* dt_b, int batch, int t1, int c1, int vp, int kt, int g2,
                        int n_terms, int cheb, cudaStream_t stream) {
  if (vp % DxNarrow::BN != 0 || c1 > kMaxOut || t1 < kt || n_terms < 0 || n_terms > 2 ||
      n_terms + cheb < 1 || n_terms + cheb > 3)
    return cudaErrorInvalidValue;
  tail_dr_kernel<T><<<dim3(t1, vp / DxNarrow::BN, batch), DxNarrow::kThreads, 0, stream>>>(
      ds2, c2k, h, gcw, dr, dxg, dt_a, dt_b, t1, c1, vp, kt, g2, n_terms, cheb);
  return cudaGetLastError();
}

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

template <typename T>
cudaError_t fc_pass_run(const T* h, const T* w1, const float* b1, const T* gout, const T* w2,
                        Drop drop, T* ds2, float* dw2, float* db1, float* part, int batch,
                        int c_in, int vp, int c1, int ce, cudaStream_t stream) {
  if (vp % kGateLanes != 0 || ce > kMaxOut || ce < 1) return cudaErrorInvalidValue;
  const dim3 grid(vp / kGateLanes, (c1 + 63) / 64, batch);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  const FcReduce r = fc_reduce(batch, vp, c1, ce);
  float* q = part + (size_t)r.per_group * r.groups * r.n;   // pass 1's group sums
  const size_t pad = ((size_t)r.per_group * r.groups - r.slices) * r.n;
  if (pad) STGCN_TRY(cudaMemsetAsync(part + (size_t)r.slices * r.n, 0, pad * sizeof(float),
                                     stream));
  GateUpT<T> up{gout, w2, ce, nullptr, nullptr, 0, drop};
  gate_pass_kernel<T, false, true, true><<<grid, GateCfg<false>::kThreads, 0, stream>>>(
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

template <typename T>
cudaError_t ln_drop_run(const T* x, const float* mu, const float* rstd, const T* lng,
                        const T* lnb, Drop drop, T* y, int batch, int t, int c, int vp,
                        cudaStream_t stream) {
  const size_t n = (size_t)batch * t * c * vp;
  ln_drop_kernel<T><<<ew_blocks(n), kEwThreads, 0, stream>>>(x, mu, rstd, lng, lnb, drop, y, t,
                                                             c, vp, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t wgrad_bias_run(CvT<T> x, int k, CvT<T> d, float* out, float* bias, float* part,
                           int batch, int vp, cudaStream_t stream) {
  if (vp % 16 != 0) return cudaErrorInvalidValue;
  const long long total = (long long)batch * d.t * vp;
  if (batch <= 0 || d.t <= 0) return cudaErrorInvalidConfiguration;
  const WgSide<T> xs{x.p, x.t, x.c, k, bias ? 1 : 0};
  const WgSide<T> ds{d.p, d.t, d.c, 1, 0};
  const int m = xs.rows(), n = d.c;
  const WgPlan p = wgrad_plan(m, n, total);
  if (p.tiles_a > 65535 || p.tiles_b > 65535) return cudaErrorInvalidConfiguration;
  // row offsets within a step are int: (K X.c + D.c) Vp < 2^31 floats
  if ((long long)(xs.data_rows() + n) * vp >= (1LL << 31)) return cudaErrorInvalidValue;
  const WgSide<T> sa = p.swap ? ds : xs, sb = p.swap ? xs : ds;
  auto run = [&](auto cfg) {
    return wgrad_launch<decltype(cfg), T>(p, sa, sb, part, d.t, vp, total, stream);
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

template <typename T>
cudaError_t wgrad_run(CvT<T> x, int k, CvT<T> d, float* out, float* part, int batch, int vp,
                      cudaStream_t stream) {
  // X.p null: the bias gradient alone, a single row of ones
  return x.p ? wgrad_bias_run<T>(x, k, d, out, nullptr, part, batch, vp, stream)
             : wgrad_bias_run<T>(x, 1, d, nullptr, out, part, batch, vp, stream);
}

}  // namespace

}  // namespace stgcn
