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
// workspace in device memory (L2 holds the GSO, 50 MB):
//   1. nm -> cv: the input, and the LayerNorm affine (zero past V);
//   2. head: conv 1, gate, align in one pass (the gate GEMM of gate_gemm.cu,
//      weights staged in shared memory as K1f stages them) -> xg;
//   3. the graph chain: one launch per order of a shared-memory-tiled f32
//      GEMM over [B*t1*c1, Vp] x [Vp, Vp] with G streamed through shared
//      memory in 64 x 16 tiles, a 4 x 4 register tile per thread;
//   4. tail: the weight contraction with bias, residual and ReLU (contract
//      of bwd_blocks.cu, three terms a launch) -> h; conv 2 (contract) ->
//      s2; gate 2 -> a2;
//   5. LayerNorm statistics: one block per (b, t), mean and then variance
//      over the true vertices in a fixed order (two passes, as the JAX
//      _ln_fwd); then normalize, affine and the keyed dropout at the block's
//      site (ln_drop of bwd_blocks.cu), and cv -> nm.
// No atomics: a repeated launch is bit-identical. No tensor cores: the
// results are held to float32 accuracy.
#include "fused_stblock.cuh"

namespace stgcn {
namespace {

constexpr int kEw = 256;          // threads of the elementwise kernels
constexpr int kMmTile = 64;       // graph product: 64 rows x 64 vertices a block
constexpr int kMmK = 16;          // contraction vertices staged per step
constexpr int kMmThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kT = 32;            // layout-change tile

int ew_grid(size_t n) {
  const size_t b = (n + kEw - 1) / kEw;
  return (int)(b < 8192 ? (b > 0 ? b : 1) : 8192);
}

template <bool TRANS>
__global__ void __launch_bounds__(kMmThreads)
graph_mm_kernel(const float* __restrict__ x, const float* __restrict__ g, const float* y,
                float* out, float alpha, float beta, long long rows, int vp, int V) {
  __shared__ __align__(16) float xs[kMmK][kMmTile + 4];   // [v][r]
  __shared__ __align__(16) float gs[kMmK][kMmTile + 4];   // [v][u]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long r0 = (long long)blockIdx.x * kMmTile;
  const int u0 = blockIdx.y * kMmTile;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < V; k0 += kMmK) {
    for (int i = tid; i < kMmTile * kMmK; i += kMmThreads) {
      const int r = i / kMmK, kk = i % kMmK, v = k0 + kk;
      const long long row = r0 + r;
      xs[kk][r] = (row < rows && v < V) ? x[row * vp + v] : 0.0f;
      // G read along its contiguous axis: v for G[u][v], u for Gᵀ = G[v][u]
      const int u = TRANS ? i % kMmTile : i / kMmK, gk = TRANS ? i / kMmTile : i % kMmK;
      const int uu = u0 + u, gv = k0 + gk;
      float gval = 0.0f;
      if (uu < V && gv < V) gval = TRANS ? g[(size_t)gv * V + uu] : g[(size_t)uu * V + gv];
      gs[gk][u] = gval;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kMmK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&gs[kk][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = r0 + 4 * ty + i;
    if (row >= rows) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const size_t idx = (size_t)row * vp + u0 + 4 * tx + j;
      out[idx] = alpha * acc[i][j] + (y ? beta * y[idx] : 0.0f);
    }
  }
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

__global__ void cv_to_nm_kernel(const float* __restrict__ src, float* __restrict__ dst, int V,
                                int C, int vp, int vtiles) {
  __shared__ float tile[kT][kT + 1];   // [c][v]
  const size_t n = blockIdx.x / vtiles;
  const int v0 = (blockIdx.x % vtiles) * kT, c0 = blockIdx.y * kT;
  const float* s = src + n * C * vp;
  float* d = dst + n * V * C;
  for (int j = threadIdx.y; j < kT; j += blockDim.y) {
    const int c = c0 + j, v = v0 + threadIdx.x;
    tile[j][threadIdx.x] = (c < C && v < V) ? s[(size_t)c * vp + v] : 0.0f;
  }
  __syncthreads();
  for (int j = threadIdx.y; j < kT; j += blockDim.y) {
    const int v = v0 + j, c = c0 + threadIdx.x;
    if (v < V && c < C) d[(size_t)v * C + c] = tile[threadIdx.x][j];
  }
}

// a [B, T, c_out, vp] = gate(s [B, T, G, vp]) with the in-gate residual
// xin = res[b, t + res_shift, c, v] for c < res.c, else 0.
__global__ void gate_fwd_kernel(const float* __restrict__ s, Cv res, int res_shift, int act,
                                int c_out, float* __restrict__ a, int t_len, int vp, size_t n) {
  const bool gated = act == kGlu || act == kGtu;
  const int g = gated ? 2 * c_out : c_out;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int v = (int)(i % vp);
    const size_t row = i / vp;
    const int c = (int)(row % c_out);
    const size_t bt = row / c_out;
    const int t = (int)(bt % t_len), b = (int)(bt / t_len);
    const size_t si = (bt * g + c) * vp + v;
    const float q = gated ? s[si + (size_t)c_out * vp] : 0.0f;
    const float xin = c < res.c
        ? res.p[((size_t)(b * res.t + t + res_shift) * res.c + c) * vp + v] : 0.0f;
    a[i] = gate(act, s[si], q, xin);
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
  f.s2 = w.take(d.lane * d.t2 * d.g2);
  f.a2 = w.take(d.lane * d.t2 * d.c2);
  f.mu = w.take((size_t)d.B * d.t2);
  f.rstd = w.take((size_t)d.B * d.t2);
  f.lng_cv = w.take((size_t)d.c2 * d.vp);
  f.lnb_cv = w.take((size_t)d.c2 * d.vp);
  return f;
}

cudaError_t launch_graph_mm(const float* x, const float* g, const float* y, float* out,
                            float alpha, float beta, long long rows, int vp, int V,
                            int transpose, cudaStream_t s) {
  if (vp % kMmTile != 0 || V > vp || rows <= 0) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((rows + kMmTile - 1) / kMmTile), vp / kMmTile);
  if (transpose)
    graph_mm_kernel<true><<<grid, kMmThreads, 0, s>>>(x, g, y, out, alpha, beta, rows, vp, V);
  else
    graph_mm_kernel<false><<<grid, kMmThreads, 0, s>>>(x, g, y, out, alpha, beta, rows, vp, V);
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
  cv_to_nm_kernel<<<dim3(n * vtiles, (C + kT - 1) / kT), dim3(kT, 8), 0, s>>>(src, dst, V, C,
                                                                            vp, vtiles);
  return cudaGetLastError();
}

cudaError_t st_forward(const StDims& d, const float* x, const float* gso, const StWeights& w,
                       const StFwdBufs& f, cudaStream_t s) {
  STGCN_TRY(launch_nm_to_cv(x, f.x_cv, d.B * d.t_in, d.V, d.c_in, d.vp, s));
  STGCN_TRY(launch_nm_to_cv(w.lng, f.lng_cv, 1, d.V, d.c2, d.vp, s));
  STGCN_TRY(launch_nm_to_cv(w.lnb, f.lnb_cv, 1, d.V, d.c2, d.vp, s));
  // head: xg = align(gate(conv1(x))), padded lanes of x zero
  const Drop off = make_drop(0, 0, 0, 1.0f, d.V);
  const GateGemmArgs head{f.x_cv, nullptr, nullptr, nullptr, nullptr, w.c1k, w.c1b, w.gaw,
                          w.gab, f.xg, d.B, d.t_in, d.c_in, d.vp, d.kt, d.c0, d.c1, d.act,
                          0, 1, off, off};
  STGCN_TRY(launch_gate_gemm(head, s));
  // the graph chain on rows (b, t, c)
  const long long rows = (long long)d.B * d.t1 * d.c1;
  if (d.graph_conv) {
    STGCN_TRY(launch_graph_mm(f.xg, gso, nullptr, f.prod, 1.0f, 0.0f, rows, d.vp, d.V, 0, s));
  } else {
    for (int k = 1; k < d.ks; ++k) {
      float* tk = const_cast<float*>(f.term(d, k));
      if (k == 1)
        STGCN_TRY(launch_graph_mm(f.xg, gso, nullptr, tk, 1.0f, 0.0f, rows, d.vp, d.V, 0, s));
      else
        STGCN_TRY(launch_graph_mm(f.term(d, k - 1), gso, f.term(d, k - 2), tk, 2.0f, -1.0f,
                                  rows, d.vp, d.V, 0, s));
    }
  }
  // h = relu(sum_k T_k W_k + gcb + xg), up to three terms a launch
  for (int k0 = 0; k0 < d.n_w; k0 += 3) {
    const int kn = d.n_w - k0 < 3 ? d.n_w - k0 : 3;
    const bool first = k0 == 0, last = k0 + kn == d.n_w;
    ContractArgs ca{{f.term(d, k0), kn > 1 ? f.term(d, k0 + 1) : nullptr,
                     kn > 2 ? f.term(d, k0 + 2) : nullptr},
                    d.t1, d.c1, w.gcw + (size_t)k0 * d.c1 * d.c1, kn, 0, 0,
                    first ? w.gcb : nullptr, Cv{first ? f.xg : f.h, d.t1, d.c1}, 0,
                    last ? 1 : 0, nullptr, f.h, d.B, d.t1, d.c1, d.vp};
    STGCN_TRY(launch_contract(ca, s));
  }
  // conv 2, gate 2 (residual: h's last window step, channels zero-padded)
  const Cv none{nullptr, 0, 0};
  STGCN_TRY(launch_contract({{f.h, nullptr, nullptr}, d.t1, d.c1, w.c2k, d.kt, 1, 0, w.c2b, none,
                             0, 0, nullptr, f.s2, d.B, d.t2, d.g2, d.vp}, s));
  const size_t n2 = d.lane * d.t2 * d.c2;
  gate_fwd_kernel<<<ew_grid(n2), kEw, 0, s>>>(f.s2, Cv{f.h, d.t1, d.c1}, d.kt - 1, d.act, d.c2,
                                              f.a2, d.t2, d.vp, n2);
  STGCN_TRY(cudaGetLastError());
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
  if (floats) *floats = c.used;
  if (!work) return cudaSuccess;
  if (!st_dims_valid(d)) return cudaErrorInvalidValue;
  STGCN_TRY(st_forward(d, x, gso, w, f, s));
  if (relu_out) STGCN_TRY(launch_cv_to_nm(f.h, relu_out, d.B * d.t1, d.V, d.c1, d.vp, s));
  // normalize, affine, dropout; s2 is free by now and holds y in cv layout
  STGCN_TRY(launch_ln_drop(f.a2, f.mu, f.rstd, f.lng_cv, f.lnb_cv, drop, f.s2, d.B, d.t2, d.c2,
                           d.vp, s));
  return launch_cv_to_nm(f.s2, y, d.B * d.t2, d.V, d.c2, d.vp, s);
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
