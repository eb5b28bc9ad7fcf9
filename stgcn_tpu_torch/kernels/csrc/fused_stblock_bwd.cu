// K12b: one whole ST block on a dense GSO, backward.
//
// Replaces the TPU kernel stgcn_tpu/kernels/fused_stblock.py `_bwd_pallas`
// (:626, body `_make_bwd_kernel` :522 / `_backward_pieces` :394). Like the
// TPU kernel it recomputes the forward from the block's inputs (st_forward
// of fused_stblock.cu: the same launches as K12f, so the same ReLU
// decisions), then applies the chain rule, a fixed sequence of launches on
// the caller's stream over the building blocks of bwd_blocks.cu:
//   1. LayerNorm and dropout backward: ln_bwd gives rstd * lng * mask * gy
//      and the per-(b, t) gradients of mu and rstd (partials over slices of
//      the row, then a fixed-order sum); ln_stats_bwd adds their chain
//      through the statistics, (dmu - drstd * rstd^3 * (a2 - mu)) / (V c2)
//      on the true vertices, which equals rstd (gd - m1 - xhat m2) of the JAX
//      backward; the affine gradients sum over (b, t) per (c, v);
//   2. gate 2 and conv 2 backward, then the ReLU mask (h > 0) on
//      conv2ᵀ(ds2) plus the gate's residual -> dr;
//   3. the weight contraction backward: dgcw[k] = T_kᵀ dr, dT_k = dr W_kᵀ;
//   4. the adjoint recurrence with Gᵀ (`:440-458`), on the graph product of
//      fused_stblock.cu reading G transposed in place: dT_{k-1} += 2 Gᵀ dT_k,
//      dT_{k-2} -= dT_k for k = Ks-1 .. 2, then dxg = dr + dT_0 + Gᵀ dT_1;
//   5. align, gate 1 and conv 1 backward -> dx.
// The TPU sums the weight gradients across its sequential grid with +=; a
// CUDA grid runs in no order, so each weight gradient goes through per-slice
// partials over slices of at most 4096 (b, t, v) terms (wgrad of
// bwd_blocks.cu, on the tile of f32_tile.cuh) and a second pass in slice
// order. No float atomics: a repeated launch is
// bit-identical.
#include "fused_stblock.cuh"

namespace stgcn {
namespace {

constexpr int kEw = 256;

int ew_grid(size_t n) {
  const size_t b = (n + kEw - 1) / kEw;
  return (int)(b < 8192 ? (b > 0 ? b : 1) : 8192);
}

// da[i] += (dmu - drstd * rstd^3 * (a - mu)) / count on lanes v < V: the
// chain of the LayerNorm statistics, over a [rows, c, vp].
__global__ void ln_stats_bwd_kernel(const float* __restrict__ a, const float* __restrict__ mu,
                                    const float* __restrict__ rstd,
                                    const float* __restrict__ dmu,
                                    const float* __restrict__ drstd, float* __restrict__ da,
                                    int c, int vp, int V, size_t n) {
  const float inv_count = 1.0f / ((float)c * (float)V);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    if ((int)(i % vp) >= V) continue;
    const size_t bt = i / ((size_t)c * vp);
    const float r = rstd[bt];
    da[i] += (dmu[bt] - drstd[bt] * r * r * r * (a[i] - mu[bt])) * inv_count;
  }
}

// y = alpha * x + beta * y over n floats
__global__ void axpby_kernel(float alpha, const float* __restrict__ x, float beta,
                             float* __restrict__ y, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    y[i] = alpha * x[i] + beta * y[i];
}

cudaError_t axpby(float alpha, const float* x, float beta, float* y, size_t n, cudaStream_t s) {
  axpby_kernel<<<ew_grid(n), kEw, 0, s>>>(alpha, x, beta, y, n);
  return cudaGetLastError();
}

struct StGrads {
  float *dx, *dc1k, *dc1b, *dgaw, *dgab, *dgcw, *dgcb, *dc2k, *dc2b, *dlng, *dlnb;
};

// With work == nullptr it only sizes the workspace (returned through floats).
cudaError_t stblock_bwd(const StDims& d, const float* x, const float* gso, const StWeights& w,
                        const float* gy, const StGrads& g, float* work, size_t* floats,
                        Drop drop, cudaStream_t s) {
  Carver c{work};
  const StFwdBufs f = carve_fwd(c, d);
  const size_t act1 = d.lane * d.t1 * d.c1, act2 = d.lane * d.t2 * d.c2;
  const size_t head = d.lane * d.t1 * d.c0;
  float* gy_cv = c.take(act2);
  float* da2 = c.take(act2);
  float* dmu = c.take((size_t)d.B * d.t2);
  float* drstd = c.take((size_t)d.B * d.t2);
  float* dlng_cv = c.take((size_t)d.c2 * d.vp);
  float* dlnb_cv = c.take((size_t)d.c2 * d.vp);
  float* lnpart = c.take(ln_bwd_part_floats(d.B, d.t2));
  float* ds2 = c.take(d.lane * d.t2 * d.g2);
  float* dxin2 = c.take(act2);
  float* dr = c.take(act1);
  float* dts = c.take(act1 * d.n_w);
  float* dxg = c.take(act1);
  float* s1 = c.take(d.lane * d.t1 * d.g1);
  float* ds1 = c.take(d.lane * d.t1 * d.g1);
  float* a1 = c.take(head);
  float* da1 = c.take(head);
  float* dxin1 = c.take(head);
  float* dx_cv = c.take(d.lane * d.t_in * d.c_in);
  const long long r1 = (long long)d.B * d.t1 * d.vp, r2 = (long long)d.B * d.t2 * d.vp;
  float* part = c.take(wgrad_part_floats(
      {{d.kt * d.c1, d.g2, r2}, {1, d.g2, r2}, {d.c1, d.c1, r1}, {1, d.c1, r1},
       {d.c0, d.c1, r1}, {d.kt * d.c_in, d.g1, r1}, {1, d.g1, r1}}));
  if (floats) *floats = c.used;
  if (!work) return cudaSuccess;
  if (!st_dims_valid(d)) return cudaErrorInvalidValue;

  const int B = d.B, vp = d.vp, t1 = d.t1, t2 = d.t2, c1 = d.c1;
  const Cv none{nullptr, 0, 0}, ones{nullptr, 0, 1};
  STGCN_TRY(st_forward(d, x, gso, w, f, s));

  // 1. LayerNorm (+ dropout) backward
  STGCN_TRY(launch_nm_to_cv(gy, gy_cv, B * t2, d.V, d.c2, vp, s));
  STGCN_TRY(launch_ln_bwd(f.a2, f.mu, f.rstd, f.lng_cv, drop, gy_cv, da2, dmu, drstd, dlng_cv,
                          dlnb_cv, lnpart, B, t2, d.c2, vp, s));
  ln_stats_bwd_kernel<<<ew_grid(act2), kEw, 0, s>>>(f.a2, f.mu, f.rstd, dmu, drstd, da2, d.c2,
                                                   vp, d.V, act2);
  STGCN_TRY(cudaGetLastError());

  // 2. gate 2, conv 2, ReLU
  STGCN_TRY(launch_gate_bwd(f.s2, Cv{f.h, t1, c1}, d.kt - 1, da2, d.act, d.c2, ds2, dxin2,
                            nullptr, B, t2, vp, s));
  STGCN_TRY(launch_wgrad(Cv{f.h, t1, c1}, d.kt, Cv{ds2, t2, d.g2}, g.dc2k, part, B, vp, s));
  STGCN_TRY(launch_wgrad(ones, 1, Cv{ds2, t2, d.g2}, g.dc2b, part, B, vp, s));
  // dr = (conv2ᵀ(ds2) + dxin2 at the window's last step) * (h > 0)
  STGCN_TRY(launch_contract({{ds2, nullptr, nullptr}, t2, d.g2, w.c2k, d.kt, 1, 1, nullptr,
                             Cv{dxin2, t2, d.c2}, d.kt - 1, 0, f.h, dr, B, t1, c1, vp}, s));

  // 3. weight contraction: dgcw[k] = T_kᵀ dr, dT_k = dr W_kᵀ
  for (int k = 0; k < d.n_w; ++k) {
    const float* wk = w.gcw + (size_t)k * c1 * c1;
    STGCN_TRY(launch_wgrad(Cv{f.term(d, k), t1, c1}, 1, Cv{dr, t1, c1},
                           g.dgcw + (size_t)k * c1 * c1, part, B, vp, s));
    STGCN_TRY(launch_contract({{dr, nullptr, nullptr}, t1, c1, wk, 1, 0, 1, nullptr, none, 0, 0,
                               nullptr, dts + k * act1, B, t1, c1, vp}, s));
  }
  STGCN_TRY(launch_wgrad(ones, 1, Cv{dr, t1, c1}, g.dgcb, part, B, vp, s));

  // 4. the adjoint of the graph chain with Gᵀ; dxg = dr + (its share through T_0)
  const long long rows = (long long)B * t1 * c1;
  auto dt = [&](int k) { return dts + k * act1; };
  if (d.graph_conv) {
    STGCN_TRY(launch_graph_mm(dt(0), gso, dr, dxg, 1.0f, 1.0f, rows, vp, d.V, 1, s));
  } else if (d.ks == 1) {
    STGCN_TRY(axpby(1.0f, dr, 1.0f, dt(0), act1, s));
    STGCN_TRY(cudaMemcpyAsync(dxg, dt(0), act1 * sizeof(float), cudaMemcpyDeviceToDevice, s));
  } else {
    for (int k = d.ks - 1; k >= 2; --k) {
      STGCN_TRY(launch_graph_mm(dt(k), gso, dt(k - 1), dt(k - 1), 2.0f, 1.0f, rows, vp, d.V, 1,
                                s));
      STGCN_TRY(axpby(-1.0f, dt(k), 1.0f, dt(k - 2), act1, s));
    }
    STGCN_TRY(axpby(1.0f, dr, 1.0f, dt(0), act1, s));
    STGCN_TRY(launch_graph_mm(dt(1), gso, dt(0), dxg, 1.0f, 1.0f, rows, vp, d.V, 1, s));
  }

  // 5. align, gate 1, conv 1
  STGCN_TRY(launch_contract({{f.x_cv, nullptr, nullptr}, d.t_in, d.c_in, w.c1k, d.kt, 1, 0,
                             w.c1b, none, 0, 0, nullptr, s1, B, t1, d.g1, vp}, s));
  STGCN_TRY(launch_contract({{dxg, nullptr, nullptr}, t1, c1, w.gaw, 1, 0, 1, nullptr, none, 0,
                             0, nullptr, da1, B, t1, d.c0, vp}, s));
  STGCN_TRY(launch_gate_bwd(s1, Cv{f.x_cv, d.t_in, d.c_in}, d.kt - 1, da1, d.act, d.c0, ds1,
                            dxin1, a1, B, t1, vp, s));
  STGCN_TRY(launch_wgrad(Cv{a1, t1, d.c0}, 1, Cv{dxg, t1, c1}, g.dgaw, part, B, vp, s));
  STGCN_TRY(launch_wgrad(ones, 1, Cv{dxg, t1, c1}, g.dgab, part, B, vp, s));
  STGCN_TRY(launch_wgrad(Cv{f.x_cv, d.t_in, d.c_in}, d.kt, Cv{ds1, t1, d.g1}, g.dc1k, part, B,
                         vp, s));
  STGCN_TRY(launch_wgrad(ones, 1, Cv{ds1, t1, d.g1}, g.dc1b, part, B, vp, s));
  // dx = conv1ᵀ(ds1) + dxin1 at the window's last step (its first c_in channels)
  STGCN_TRY(launch_contract({{ds1, nullptr, nullptr}, t1, d.g1, w.c1k, d.kt, 1, 1, nullptr,
                             Cv{dxin1, t1, d.c0}, d.kt - 1, 0, nullptr, dx_cv, B, d.t_in,
                             d.c_in, vp}, s));
  STGCN_TRY(launch_cv_to_nm(dx_cv, g.dx, B * d.t_in, d.V, d.c_in, vp, s));
  STGCN_TRY(launch_cv_to_nm(dlng_cv, g.dlng, 1, d.V, d.c2, vp, s));
  return launch_cv_to_nm(dlnb_cv, g.dlnb, 1, d.V, d.c2, vp, s);
}

}  // namespace
}  // namespace stgcn

using namespace stgcn;

extern "C" {

// K12b. The inputs of stgcn_stblock_fwd (lnb is not read) and gy [B, t2, V,
// c2]; outputs shaped as the inputs: dx [B, t_in, V, c_in] and the weight
// gradients, each summed over the batch. work: stgcn_stblock_bwd_work(...).
int stgcn_stblock_bwd(const float* x, const float* gso, const float* c1k, const float* c1b,
                      const float* gaw, const float* gab, const float* gcw, const float* gcb,
                      const float* c2k, const float* c2b, const float* lng, const float* lnb,
                      const float* gy, float* dx, float* dc1k, float* dc1b, float* dgaw,
                      float* dgab, float* dgcw, float* dgcb, float* dc2k, float* dc2b,
                      float* dlng, float* dlnb, float* work, int B, int t_in, int V, int c_in,
                      int kt, int ks, int c0, int c1, int c2, int act, int graph_conv,
                      unsigned seed, int site, unsigned threshold, float scale, void* stream) {
  const StWeights w{c1k, c1b, gaw, gab, gcw, gcb, c2k, c2b, lng, lnb};
  const StGrads g{dx, dc1k, dc1b, dgaw, dgab, dgcw, dgcb, dc2k, dc2b, dlng, dlnb};
  return stblock_bwd(st_dims(B, t_in, V, c_in, kt, ks, c0, c1, c2, act, graph_conv), x, gso, w,
                     gy, g, work, nullptr, make_drop(seed, site, threshold, scale, V),
                     static_cast<cudaStream_t>(stream));
}

long long stgcn_stblock_bwd_work(int B, int t_in, int V, int c_in, int kt, int ks, int c0,
                                 int c1, int c2, int act, int graph_conv) {
  size_t n = 0;
  const StWeights w{};
  const StGrads g{};
  stblock_bwd(st_dims(B, t_in, V, c_in, kt, ks, c0, c1, c2, act, graph_conv), nullptr, nullptr,
              w, nullptr, g, nullptr, &n, make_drop(0, 0, 0, 1.0f, V), nullptr);
  return (long long)n;
}

}  // extern "C"
