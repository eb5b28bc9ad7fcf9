// K12f: one whole ST block on a dense GSO, forward, and the forward
// recompute that K12b shares.
//
// Replaces the TPU kernel stgcn_tpu/kernels/fused_stblock.py `_fwd_pallas`
// (:590, body `_make_fwd_kernel` :509 / `_forward_pieces` :333): temporal
// gated conv 1 -> bottleneck align -> Chebyshev chain T_1 = G.xg,
// T_k = 2 G.T_{k-1} - T_{k-2} (or G.xg for graph_conv) -> sum_k T_k W_k +
// gcb + xg -> ReLU -> temporal gated conv 2 -> LayerNorm over (V, C), eps
// 1e-12 -> dropout.
//
// The TPU kernel holds a batch tile and the whole [Vp, Vp] GSO in VMEM and
// runs its grid in order. On the H100 the GSO does not fit in one block's
// 227 KB of shared memory at road-graph sizes (451 KB at V = 325 in f32),
// each Chebyshev order needs all of the previous one, and the LayerNorm
// spans every vertex, so the block runs as a fixed sequence of launches on
// the caller's stream, each a grid-wide step, with the intermediates in a
// workspace in device memory (L2 holds the GSO, 50 MB). Every product runs
// on the register tile of f32_tile.cuh, as K1f-K4f's do:
//   1. nm -> cv: the input; the GSO padded to [Vp, Vp], zero past V (a
//      0.6 MB copy at V = 325, left in the caller's scratch);
//   2. head: conv 1, gate, align in one pass (the gate GEMM of gate_gemm.cu,
//      as K1f) -> xg;
//   3. the graph chain: one launch per order of graph_mm_kernel below, the
//      product [B*t1*c1, V] x [V, Vp] on the tile;
//   4. tail, as K2f's: h = relu(sum_k T_k W_k + gcb + xg) one thread a lane
//      (tail_h_kernel of vertex_fused.cu, three terms a launch, a later
//      launch adding onto h); then conv 2 and gate 2 on the gate GEMM with
//      K2f's LayerNorm-partial epilogue (x = h, in-gate residual h's newest
//      step zero-padded to c2) -> a2; s2 never reaches device memory;
//   5. LayerNorm statistics: one block per (b, t), the mean and then the
//      mean square deviation from it over the true vertices, each in a fixed
//      order (two passes over a2, as the JAX _ln_fwd; the epilogue's sums
//      are not used: a sum of squares less the squared mean loses the
//      variance in f32 where |mean| >> std);
//   6. (K12f) the output stage, cv_to_nm_kernel<true>: normalize, affine
//      and the keyed dropout at the block's site inside cv -> nm's
//      transposing tile, a2 read once and y [B, t2, V, c2] written once.
// K12b runs 1-5 (st_forward) as its recompute, and the adjoint chain on the
// same graph product with G read transposed in place.
//
// What bounds it on the H100 (PEMS-BAY, V 325, batch 512, c1 16): the
// graph products' FMAs (2 B t1 c1 V^2 a product, 1.73 GFLOP at block 1) and
// the gate GEMMs', then the bytes of the lane and layout passes (a2 and y
// at block 1 are 402 and 341 MB).
//
// The graph product: rows r = (b, t, c) of x [rows, Vp] against G, out[r,
// u] = alpha sum_{v < V} x[r, v] G(u, v) + beta y[r, u] for every u < Vp.
// A block owns 128 rows x 128 output vertices, 8 x 8 sums a thread (64 x
// 64 and 4 x 4 where the wide grid would not fill the card: PeMSD7(M)'s
// batch); the blocks of one row tile are neighbours in the grid, so x is
// read from HBM about once, and G stays in L2. The contraction walks v 16
// at a time, two buffers deep, one barrier a step (f32tile::stage_loop):
// x's rows load as float4 (zero past V) and are transposed at the store;
// G's come from the padded copy, whose rows of Vp floats load as float4
// without a bound check (the raw GSO's rows of V floats are not 16-byte
// aligned), transposed where G(u, v) is contiguous along v (the forward)
// and stored as they are where it is contiguous along u (Gᵀ, the
// adjoint's). Offsets inside a tile are int: with scalar, bound-checked G
// loads and size_t offsets the wide tile spilled 112-132 bytes a thread at
// its cap of 128 registers (2 blocks a SM); now it takes 127, no spill.
// Pieces past V are zero, so each sum is one fmaf chain over v ascending
// from 0, and alpha and beta are applied after it, as the 64 x 64 kernel
// before this one did: T_k equal that kernel's bit for bit.
// No atomics: a repeated launch is bit-identical. No tensor cores: the
// results are held to float32 accuracy.
#include "fused_stblock.cuh"

#include "f32_tile.cuh"

namespace stgcn {
namespace {

constexpr int kT = 32;          // layout-change tile
constexpr int kPassMin = 64;    // the gate GEMM's narrowest pass and its lane tile

// The graph product's tiles: 256 threads, 8 x 8 and 4 x 4 sums a thread.
using MmWide = f32tile::Cfg<128, 128, 16, 8, 8>;
using MmSmall = f32tile::Cfg<64, 64, 16, 4, 4>;
constexpr long long kMmWideBlocks = 2 * 132;   // a full wave of wide blocks on 132 SMs

template <class C, bool TRANS>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks)
graph_mm_kernel(const float* __restrict__ x, const float* __restrict__ gp, const float* y,
                float* out, float alpha, float beta, long long rows, int vp, int V) {
  __shared__ __align__(16) f32tile::Smem<C> sm;
  using SX = f32tile::KSlots<C, C::BM>;    // x: rows contiguous along v
  using SG = f32tile::KSlots<C, C::BN>;    // G(u, v) = gp[u vp + v]: contiguous along v
  using SGt = f32tile::RSlots<C, C::BN>;   // G(u, v) = gp[v vp + u]: contiguous along u
  constexpr int kG = TRANS ? SGt::kSlots : SG::kSlots;
  const int ncol = vp / C::BN;
  const long long r0 = (long long)(blockIdx.x / ncol) * C::BM;
  const int u0 = (int)(blockIdx.x % ncol) * C::BN;
  const int nrows = rows - r0 < C::BM ? (int)(rows - r0) : C::BM;   // the tile's rows
  const size_t base = (size_t)r0 * vp;   // offsets inside the tile are int
  const float* xb = x + base;
  const f32tile::Pos<C> pos;
  float acc[C::TM][C::TN];
  f32tile::zero<C>(acc);

  float4 xv[SX::kSlots], gv[kG];
  auto load = [&](int step) {
    const int k0 = step * C::BK;
#pragma unroll
    for (int p = 0; p < SX::kSlots; ++p) {
      const int row = SX::row(p), v = k0 + SX::koff(p);
      const float* xr = xb + row * vp + v;
      if (row >= nrows) {
        xv[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      } else if (v + 3 < V) {
        xv[p] = __ldg(reinterpret_cast<const float4*>(xr));
      } else {
        xv[p] = make_float4(v < V ? __ldg(xr) : 0.0f, v + 1 < V ? __ldg(xr + 1) : 0.0f,
                            v + 2 < V ? __ldg(xr + 2) : 0.0f, 0.0f);
      }
    }
    // the padded GSO: every piece lies inside [vp, vp] (16 ceil(V / 16) <= vp)
#pragma unroll
    for (int p = 0; p < kG; ++p) {
      const int at = TRANS ? (k0 + SGt::k(p)) * vp + u0 + SGt::roff(p)
                           : (u0 + SG::row(p)) * vp + k0 + SG::koff(p);
      gv[p] = __ldg(reinterpret_cast<const float4*>(gp + at));
    }
  };
  auto store = [&](int buf) {
    SX::store(sm.a[buf], xv);
    if constexpr (TRANS) SGt::store(sm.b[buf], gv);
    else SG::store(sm.b[buf], gv);
  };
  f32tile::stage_loop<C>(sm, pos, (V + C::BK - 1) / C::BK, acc, load, store);

  float* ob = out + base;
  const float* yb = y ? y + base : nullptr;
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int row = pos.row(i);
    if (row >= nrows) continue;
#pragma unroll
    for (int j = 0; j < C::TN; j += 4) {
      const int idx = row * vp + u0 + pos.col(j);
      float yv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (yb) {
        const float4 q = *reinterpret_cast<const float4*>(yb + idx);
        yv[0] = q.x;
        yv[1] = q.y;
        yv[2] = q.z;
        yv[3] = q.w;
      }
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = alpha * acc[i][j + e] + (yb ? beta * yv[e] : 0.0f);
      *reinterpret_cast<float4*>(ob + idx) = make_float4(o[0], o[1], o[2], o[3]);
    }
  }
}

// gp [vp, vp] = g [V, V], zero past V
__global__ void pad_gso_kernel(const float* __restrict__ g, float* __restrict__ gp, int V,
                               int vp) {
  const size_t n = (size_t)vp * vp;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int u = (int)(i / vp), v = (int)(i % vp);
    gp[i] = u < V && v < V ? g[(size_t)u * V + v] : 0.0f;
  }
}

template <class C>
cudaError_t graph_mm_launch(const float* x, const float* gp, const float* y, float* out,
                            float alpha, float beta, long long rows, int vp, int V,
                            int transpose, cudaStream_t s) {
  const long long blocks = (rows + C::BM - 1) / C::BM * (vp / C::BN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (transpose)
    graph_mm_kernel<C, true><<<(unsigned)blocks, C::kThreads, 0, s>>>(x, gp, y, out, alpha,
                                                                      beta, rows, vp, V);
  else
    graph_mm_kernel<C, false><<<(unsigned)blocks, C::kThreads, 0, s>>>(x, gp, y, out, alpha,
                                                                       beta, rows, vp, V);
  return cudaGetLastError();
}

// grid (n * vtiles, ceil(C / 32)), block (32, 8): one 32 x 32 tile of one matrix
__global__ void nm_to_cv_kernel(const float* __restrict__ src, float* __restrict__ dst, int V,
                                int C, int vp, int vtiles) {
  __shared__ float tile[kT][kT + 1];   // [v][c]
  const size_t n = blockIdx.x / vtiles;
  const int v0 = (blockIdx.x % vtiles) * kT, c0 = blockIdx.y * kT;
  const float* s = src + n * V * C;
  float* d = dst + n * C * vp;
  for (int j = threadIdx.y; j < kT; j += blockDim.y) {
    const int v = v0 + j, c = c0 + threadIdx.x;
    tile[j][threadIdx.x] = (v < V && c < C) ? s[(size_t)v * C + c] : 0.0f;
  }
  __syncthreads();
  for (int j = threadIdx.y; j < kT; j += blockDim.y) {
    const int c = c0 + j, v = v0 + threadIdx.x;
    if (c < C && v < vp) d[(size_t)c * vp + v] = tile[threadIdx.x][j];
  }
}

// grid (n * vtiles, ceil(C / kTC)), block (32, 8): cv [n, C, vp] -> nm [n, V,
// C] through one 32 (v) x kTC (c) tile of one matrix. With LN (K12f's output
// stage) each element is also normalized with its row's statistics (mu,
// rstd [n]), the affine lng/lnb [V, C] applied and the keyed dropout (rows
// n*C + c of [n, C, V_true]) at the store; its tile is 64 channels wide, so
// a thread moves 8 elements and a warp writes a whole 256-byte row of y at
// c2 = 64.
template <bool LN>
__global__ void cv_to_nm_kernel(const float* __restrict__ src, float* __restrict__ dst, int V,
                                int C, int vp, int vtiles, const float* __restrict__ mu,
                                const float* __restrict__ rstd, const float* __restrict__ lng,
                                const float* __restrict__ lnb, Drop drop) {
  constexpr int kTC = LN ? 2 * kT : kT;
  __shared__ float tile[kTC][kT + 1];   // [c][v]
  const size_t n = blockIdx.x / vtiles;
  const int v0 = (blockIdx.x % vtiles) * kT, c0 = blockIdx.y * kTC;
  const float* s = src + n * C * vp;
  float* d = dst + n * V * C;
#pragma unroll
  for (int j = threadIdx.y; j < kTC; j += 8) {
    const int c = c0 + j, v = v0 + threadIdx.x;
    tile[j][threadIdx.x] = (c < C && v < V) ? s[(size_t)c * vp + v] : 0.0f;
  }
  __syncthreads();
  float m = 0.0f, r = 0.0f;
  uint32_t key = 0;
  if constexpr (LN) {
    m = mu[n];
    r = rstd[n];
    key = drop_key(drop.seed, drop.site);
  }
#pragma unroll
  for (int j = threadIdx.y; j < kT; j += 8) {
    const int v = v0 + j;
#pragma unroll
    for (int h = 0; h < kTC / kT; ++h) {
      const int cc = h * kT + threadIdx.x, c = c0 + cc;
      if (v >= V || c >= C) continue;
      float val = tile[cc][j];
      const size_t i = (size_t)v * C + c;
      if constexpr (LN) {
        val = (val - m) * r * lng[i] + lnb[i];
        if (drop.threshold) val *= drop_mask(drop, key, n * C + c, v);
      }
      d[i] = val;
    }
  }
}

// one block of kLanes threads per (b, t) row of a [rows, c, vp]: the mean
// over (c, v < V), then the mean square deviation from it, each summed in a
// fixed order (block_sum); rstd = rsqrt(var + 1e-12).
__global__ void __launch_bounds__(kLanes)
ln_stats_kernel(const float* __restrict__ a, float* __restrict__ mu, float* __restrict__ rstd,
                int c, int vp, int V) {
  __shared__ float red[kLanes / 32];
  __shared__ float mean;
  const size_t bt = blockIdx.x;
  const float* row = a + bt * c * vp;
  const int n = c * vp;
  const float count = (float)c * (float)V;
  float s = 0.0f;
  for (int i = threadIdx.x; i < n; i += kLanes)
    if (i % vp < V) s += row[i];
  s = block_sum(s, red);
  if (threadIdx.x == 0) mean = s / count;
  __syncthreads();
  const float m = mean;
  float q = 0.0f;
  for (int i = threadIdx.x; i < n; i += kLanes)
    if (i % vp < V) {
      const float d = row[i] - m;
      q = fmaf(d, d, q);
    }
  q = block_sum(q, red);
  if (threadIdx.x == 0) {
    mu[bt] = m;
    rstd[bt] = rsqrtf(q / count + 1e-12f);
  }
}

}  // namespace

StDims st_dims(int B, int t_in, int V, int c_in, int kt, int ks, int c0, int c1, int c2,
               int act, int graph_conv) {
  StDims d{B, t_in, V, c_in, kt, ks, c0, c1, c2, act, graph_conv};
  const bool gated = act == kGlu || act == kGtu;
  d.vp = (V + kLanes - 1) / kLanes * kLanes;
  d.t1 = t_in - kt + 1;
  d.t2 = d.t1 - kt + 1;
  d.g1 = gated ? 2 * c0 : c0;
  d.g2 = gated ? 2 * c2 : c2;
  d.n_w = graph_conv ? 1 : ks;
  d.n_prod = graph_conv ? 1 : ks - 1;
  d.lane = (size_t)B * d.vp;
  return d;
}

bool st_dims_valid(const StDims& d) {
  return d.B > 0 && d.V > 0 && d.kt > 0 && d.ks > 0 && d.t2 > 0 && d.c_in > 0 &&
         d.c_in <= d.c0 && d.c1 > 0 && d.c1 <= kMaxOut && d.c1 <= d.c2 && d.act >= kGlu &&
         d.act <= kSilu && (d.graph_conv == 0 || d.graph_conv == 1);
}

StFwdBufs carve_fwd(Carver& w, const StDims& d) {
  StFwdBufs f;
  const size_t act1 = d.lane * d.t1 * d.c1;
  f.x_cv = w.take(d.lane * d.t_in * d.c_in);
  f.xg = w.take(act1);
  f.prod = w.take(act1 * (d.n_prod > 0 ? d.n_prod : 1));
  f.h = w.take(act1);
  f.a2 = w.take(d.lane * d.t2 * d.c2);
  f.mu = w.take((size_t)d.B * d.t2);
  f.rstd = w.take((size_t)d.B * d.t2);
  return f;
}

size_t st_scratch_floats(const StDims& d) {
  const size_t rows = (size_t)d.B * d.t2;
  return (size_t)d.vp * d.vp +
         rows * ((d.c2 + kPassMin - 1) / kPassMin) * (d.vp / kPassMin) * 2 + 2 * rows;
}

cudaError_t launch_graph_mm(const float* x, const float* gp, const float* y, float* out,
                            float alpha, float beta, long long rows, int vp, int V,
                            int transpose, cudaStream_t s) {
  if (vp % MmWide::BN != 0 || V > vp || rows <= 0) return cudaErrorInvalidValue;
  const long long wide = (rows + MmWide::BM - 1) / MmWide::BM * (vp / MmWide::BN);
  if (wide >= kMmWideBlocks)
    return graph_mm_launch<MmWide>(x, gp, y, out, alpha, beta, rows, vp, V, transpose, s);
  return graph_mm_launch<MmSmall>(x, gp, y, out, alpha, beta, rows, vp, V, transpose, s);
}

cudaError_t launch_pad_gso(const float* g, float* gp, int V, int vp, cudaStream_t s) {
  const size_t n = (size_t)vp * vp;
  const size_t blocks = (n + 255) / 256;
  pad_gso_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(g, gp, V, vp);
  return cudaGetLastError();
}

cudaError_t launch_nm_to_cv(const float* src, float* dst, int n, int V, int C, int vp,
                            cudaStream_t s) {
  const int vtiles = vp / kT;
  nm_to_cv_kernel<<<dim3(n * vtiles, (C + kT - 1) / kT), dim3(kT, 8), 0, s>>>(src, dst, V, C,
                                                                            vp, vtiles);
  return cudaGetLastError();
}

cudaError_t launch_cv_to_nm(const float* src, float* dst, int n, int V, int C, int vp,
                            cudaStream_t s) {
  const int vtiles = (V + kT - 1) / kT;
  cv_to_nm_kernel<false><<<dim3(n * vtiles, (C + kT - 1) / kT), dim3(kT, 8), 0, s>>>(
      src, dst, V, C, vp, vtiles, nullptr, nullptr, nullptr, nullptr, Drop{});
  return cudaGetLastError();
}

cudaError_t st_forward(const StDims& d, const float* x, const float* gso, const StWeights& w,
                       const StFwdBufs& f, float* scratch, cudaStream_t s) {
  float* gp = scratch;   // the padded GSO, kept for the caller
  STGCN_TRY(launch_nm_to_cv(x, f.x_cv, d.B * d.t_in, d.V, d.c_in, d.vp, s));
  STGCN_TRY(launch_pad_gso(gso, gp, d.V, d.vp, s));
  // head: xg = align(gate(conv1(x))), padded lanes of x zero
  const Drop off = make_drop(0, 0, 0, 1.0f, d.V);
  const GateGemmArgs head{f.x_cv, nullptr, nullptr, nullptr, nullptr, w.c1k, w.c1b, w.gaw,
                          w.gab, f.xg, d.B, d.t_in, d.c_in, d.vp, d.kt, d.c0, d.c1, d.act,
                          0, 1, off, off};
  STGCN_TRY(launch_gate_gemm(head, s));
  // the graph chain on rows (b, t, c)
  const long long rows = (long long)d.B * d.t1 * d.c1;
  if (d.graph_conv) {
    STGCN_TRY(launch_graph_mm(f.xg, gp, nullptr, f.prod, 1.0f, 0.0f, rows, d.vp, d.V, 0, s));
  } else {
    for (int k = 1; k < d.ks; ++k) {
      float* tk = const_cast<float*>(f.term(d, k));
      if (k == 1)
        STGCN_TRY(launch_graph_mm(f.xg, gp, nullptr, tk, 1.0f, 0.0f, rows, d.vp, d.V, 0, s));
      else
        STGCN_TRY(launch_graph_mm(f.term(d, k - 1), gp, f.term(d, k - 2), tk, 2.0f, -1.0f,
                                  rows, d.vp, d.V, 0, s));
    }
  }
  // h = relu(sum_k T_k W_k + gcb + xg), three terms a launch: the first adds
  // the bias and xg, a later one adds onto h, the last applies the ReLU
  for (int k0 = 0; k0 < d.n_w; k0 += 3) {
    const int kn = d.n_w - k0 < 3 ? d.n_w - k0 : 3;
    const bool first = k0 == 0;
    const float* ct[3] = {f.term(d, k0), kn > 1 ? f.term(d, k0 + 1) : nullptr,
                          kn > 2 ? f.term(d, k0 + 2) : nullptr};
    STGCN_TRY(launch_tail_h(ct, kn, w.gcw + (size_t)k0 * d.c1 * d.c1, first ? w.gcb : nullptr,
                            first ? f.xg : f.h, f.h, d.B, d.t1, d.c1, d.vp, s,
                            k0 + kn == d.n_w));
  }
  // conv 2 and gate 2 (residual: h's newest window step, channels zero-padded)
  // on the gate GEMM with the LayerNorm-partial epilogue, as K2f's
  float* part = scratch + (size_t)d.vp * d.vp;
  float* ps = scratch + (st_scratch_floats(d) - 2 * (size_t)d.B * d.t2);
  const GateGemmArgs conv2{f.h, nullptr, nullptr, nullptr, nullptr, w.c2k, w.c2b, nullptr,
                           nullptr, f.a2, d.B, d.t1, d.c1, d.vp, d.kt, d.c2, 0, d.act, 0, 1,
                           off, off, part, ps, ps + (size_t)d.B * d.t2, d.V};
  STGCN_TRY(launch_gate_gemm(conv2, s));
  ln_stats_kernel<<<d.B * d.t2, kLanes, 0, s>>>(f.a2, f.mu, f.rstd, d.c2, d.vp, d.V);
  return cudaGetLastError();
}

namespace {

// With work == nullptr it only sizes the workspace (returned through floats).
cudaError_t stblock_fwd(const StDims& d, const float* x, const float* gso, const StWeights& w,
                        float* y, float* relu_out, float* work, size_t* floats, Drop drop,
                        cudaStream_t s) {
  Carver c{work};
  const StFwdBufs f = carve_fwd(c, d);
  float* scratch = c.take(st_scratch_floats(d));
  if (floats) *floats = c.used;
  if (!work) return cudaSuccess;
  if (!st_dims_valid(d)) return cudaErrorInvalidValue;
  STGCN_TRY(st_forward(d, x, gso, w, f, scratch, s));
  if (relu_out) STGCN_TRY(launch_cv_to_nm(f.h, relu_out, d.B * d.t1, d.V, d.c1, d.vp, s));
  // normalize, affine and dropout inside the transposing tile: a2 -> y
  const int vtiles = (d.V + kT - 1) / kT, n = d.B * d.t2;
  const dim3 grid(n * vtiles, (d.c2 + 2 * kT - 1) / (2 * kT));
  cv_to_nm_kernel<true><<<grid, dim3(kT, 8), 0, s>>>(f.a2, y, d.V, d.c2, d.vp, vtiles, f.mu,
                                                     f.rstd, w.lng, w.lnb, drop);
  return cudaGetLastError();
}

}  // namespace
}  // namespace stgcn

using namespace stgcn;

extern "C" {

// K12f. x [B, t_in, V, c_in], gso [V, V], weights as StWeights; y [B, t2, V,
// c2]; relu_out [B, t1, V, c1] (may be null) receives h, whose signs are the
// kernel's ReLU decisions. The dropout site (seed, site, threshold, scale)
// masks y; threshold 0 turns it off. work: stgcn_stblock_fwd_work(...) floats.
int stgcn_stblock_fwd(const float* x, const float* gso, const float* c1k, const float* c1b,
                      const float* gaw, const float* gab, const float* gcw, const float* gcb,
                      const float* c2k, const float* c2b, const float* lng, const float* lnb,
                      float* y, float* relu_out, float* work, int B, int t_in, int V, int c_in,
                      int kt, int ks, int c0, int c1, int c2, int act, int graph_conv,
                      unsigned seed, int site, unsigned threshold, float scale, void* stream) {
  const StWeights w{c1k, c1b, gaw, gab, gcw, gcb, c2k, c2b, lng, lnb};
  return stblock_fwd(st_dims(B, t_in, V, c_in, kt, ks, c0, c1, c2, act, graph_conv), x, gso, w,
                     y, relu_out, work, nullptr, make_drop(seed, site, threshold, scale, V),
                     static_cast<cudaStream_t>(stream));
}

long long stgcn_stblock_fwd_work(int B, int t_in, int V, int c_in, int kt, int ks, int c0,
                                 int c1, int c2, int act, int graph_conv) {
  size_t n = 0;
  const StWeights w{};
  stblock_fwd(st_dims(B, t_in, V, c_in, kt, ks, c0, c1, c2, act, graph_conv), nullptr, nullptr,
              w, nullptr, nullptr, nullptr, &n, make_drop(0, 0, 0, 1.0f, V), nullptr);
  return (long long)n;
}

}  // extern "C"
