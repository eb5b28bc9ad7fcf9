// K12b: one whole ST block on a dense GSO, backward.
//
// Replaces the TPU kernel stgcn_tpu/kernels/fused_stblock.py `_bwd_pallas`
// (:626, body `_make_bwd_kernel` :522 / `_backward_pieces` :394). Like the
// TPU kernel it recomputes the forward from the block's inputs (st_forward
// of fused_stblock.cu: the same launches as K12f, so the same ReLU
// decisions), then applies the chain rule as K2b's tail and K1b's head
// around the dense adjoint chain, a fixed sequence of launches on the
// caller's stream over the building blocks of bwd_blocks.cu, every product
// on the register tile of f32_tile.cuh:
//   1. LayerNorm and dropout backward: ln_bwd gives da2 = rstd * lng * mask
//      * gy and the per-(b, t) gradients of mu and rstd (partials over
//      slices of the row, then a fixed-order sum); their chain through the
//      statistics, (dmu - drstd * rstd^3 * (a2 - mu)) / (V c2) on the true
//      vertices (rstd (gd - m1 - xhat m2) of the JAX backward), is
//      gps + 2 gpss a2 with gps = (dmu + drstd rstd^3 mu) / (V c2) and
//      gpss = -drstd rstd^3 / (2 V c2) per (b, t) (ln_cotangents_kernel),
//      which the gate pass adds as it adds K2b's LayerNorm-partial
//      cotangents; the affine gradients sum over slices of the (b, t) rows
//      per (c, v), then the slices in order (a batch of 512 has 4096 rows);
//   2. conv 2 and gate 2 backward: the gate pass (cotangent policy) on h
//      recomputes s2 on the tile and writes only ds2 (in s2's place) ->
//      dc2k with dc2b (a ones row);
//   3. dr = (conv2^T(ds2) + ds2's linear half) * (h > 0) on K2b's dr tile
//      (launch_tail_dr), whose epilogue also forms dxg = dr + dr W_0^T
//      (Chebyshev: T_0 is xg) and dT_1, dT_2 from dr in shared memory (a
//      lane kernel the terms past T_2, Ks >= 4) -> dgcw[k] = T_k^T dr, with
//      dgcb as the first one's ones row;
//   4. the adjoint recurrence with G^T (`:440-458`), on the graph product of
//      fused_stblock.cu reading G transposed in place: dT_{k-1} += 2 G^T
//      dT_k, dT_{k-2} -= dT_k for k = Ks-1 .. 2 (dT_0 is folded into dxg),
//      then dxg += G^T dT_1;
//   5. K1b's head: the gate pass (head policy: da1 = dxg . gaw^T) on x
//      recomputes s1 on the tile and writes ds1 and a1 -> dgaw with dgab,
//      dc1k with dc1b -> dx = conv1^T(ds1) + ds1's linear half
//      (launch_gate_dx).
// The TPU sums the weight gradients across its sequential grid with +=; a
// CUDA grid runs in no order, so each weight gradient goes through per-slice
// partials over slices of at most 4096 (b, t, v) terms (wgrad of
// bwd_blocks.cu) and a second pass in slice order. No float atomics: a
// repeated launch is bit-identical.
#include "fused_stblock.cuh"

namespace stgcn {
namespace {

constexpr int kEw = 256;

int ew_grid(size_t n) {
  const size_t b = (n + kEw - 1) / kEw;
  return (int)(b < 8192 ? (b > 0 ? b : 1) : 8192);
}

// gps = (dmu + drstd rstd^3 mu) / count, gpss = -drstd rstd^3 / (2 count)
// per (b, t) row: the LayerNorm statistics' chain as the gate pass's
// LayerNorm-partial cotangents (kernels/fused_stblock.py
// `ln_stats_cotangents` is its plain version).
__global__ void ln_cotangents_kernel(const float* __restrict__ mu, const float* __restrict__ rstd,
                                     const float* __restrict__ dmu,
                                     const float* __restrict__ drstd, float* __restrict__ gps,
                                     float* __restrict__ gpss, float inv_count, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float r = rstd[i], k = drstd[i] * r * r * r;
  gps[i] = (dmu[i] + k * mu[i]) * inv_count;
  gpss[i] = -0.5f * k * inv_count;
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
  const int cheb = d.graph_conv ? 0 : 1;
  const int n_terms = d.n_w - cheb;   // graph terms besides T_0: T_1 .. T_{Ks-1}, or G.xg
  float* gy_cv = c.take(act2);
  float* da2 = c.take(act2);
  float* dmu = c.take((size_t)d.B * d.t2);
  float* drstd = c.take((size_t)d.B * d.t2);
  float* gps = c.take((size_t)d.B * d.t2);
  float* gpss = c.take((size_t)d.B * d.t2);
  float* dlng_cv = c.take((size_t)d.c2 * d.vp);
  float* dlnb_cv = c.take((size_t)d.c2 * d.vp);
  float* lnpart = c.take(ln_bwd_part_floats(d.B, d.t2));
  float* affpart = c.take(ln_affine_part_floats(d.B, d.t2, d.c2, d.vp));
  float* ds2 = f.s2;   // s2 is not read after the recompute: the gate pass recomputes it
  float* dr = c.take(act1);
  float* dts = c.take(act1 * (n_terms > 0 ? n_terms : 1));
  float* dxg = c.take(act1);
  float* ds1 = c.take(d.lane * d.t1 * d.g1);
  float* a1 = c.take(d.lane * d.t1 * d.c0);
  float* dx_cv = c.take(d.lane * d.t_in * d.c_in);
  const long long r1 = (long long)d.B * d.t1 * d.vp, r2 = (long long)d.B * d.t2 * d.vp;
  float* part = c.take(wgrad_part_floats(
      {{d.kt * d.c1 + 1, d.g2, r2}, {d.c1 + 1, d.c1, r1}, {d.c1, d.c1, r1},
       {d.c0 + 1, d.c1, r1}, {d.kt * d.c_in + 1, d.g1, r1}}));
  if (floats) *floats = c.used;
  if (!work) return cudaSuccess;
  if (!st_dims_valid(d)) return cudaErrorInvalidValue;

  const int B = d.B, vp = d.vp, t1 = d.t1, t2 = d.t2, c1 = d.c1;
  STGCN_TRY(st_forward(d, x, gso, w, f, s));

  // 1. LayerNorm (+ dropout) backward; the statistics' chain as gps, gpss
  STGCN_TRY(launch_nm_to_cv(gy, gy_cv, B * t2, d.V, d.c2, vp, s));
  STGCN_TRY(launch_ln_bwd(f.a2, f.mu, f.rstd, f.lng_cv, drop, gy_cv, da2, dmu, drstd, dlng_cv,
                          dlnb_cv, lnpart, B, t2, d.c2, vp, s, affpart));
  const int rows_t2 = B * t2;
  ln_cotangents_kernel<<<(rows_t2 + kEw - 1) / kEw, kEw, 0, s>>>(
      f.mu, f.rstd, dmu, drstd, gps, gpss, 1.0f / ((float)d.c2 * (float)d.V), rows_t2);
  STGCN_TRY(cudaGetLastError());

  // 2. conv 2 and gate 2: s2 recomputed from h, the gate backward in one pass
  STGCN_TRY(launch_gate_pass(f.h, w.c2k, w.c2b, GateUp{da2, nullptr, 0, gps, gpss, d.V}, ds2,
                             nullptr, B, t1, c1, vp, d.kt, d.c2, d.act, s));
  STGCN_TRY(launch_wgrad_bias(Cv{f.h, t1, c1}, d.kt, Cv{ds2, t2, d.g2}, g.dc2k, g.dc2b, part, B,
                              vp, s));

  // 3. dr = (conv2^T(ds2) + dxin2 at the window's last step) * (h > 0), dxg
  //    = dr (+ dr W_0^T) and the graph terms' gradients dT_k = dr W_k^T
  auto dt = [&](int k) { return dts + (size_t)(k - cheb) * act1; };   // term k's gradient
  const int n_tail = n_terms < 2 ? n_terms : 2;
  STGCN_TRY(launch_tail_dr(ds2, w.c2k, f.h, w.gcw, dr, dxg, n_tail > 0 ? dt(cheb) : nullptr,
                           n_tail > 1 ? dt(cheb + 1) : nullptr, B, t1, c1, vp, d.kt, d.g2,
                           n_tail, cheb, s));
  if (n_terms > 2)
    STGCN_TRY(launch_term_grads(dr, w.gcw + (size_t)(cheb + 2) * c1 * c1, dt(cheb + 2),
                                n_terms - 2, B, t1, c1, vp, s));
  for (int k = 0; k < d.n_w; ++k)   // dgcw[k] = T_k^T dr, with dgcb as the first one's ones row
    STGCN_TRY(launch_wgrad_bias(Cv{f.term(d, k), t1, c1}, 1, Cv{dr, t1, c1},
                                g.dgcw + (size_t)k * c1 * c1, k == 0 ? g.dgcb : nullptr, part,
                                B, vp, s));

  // 4. the adjoint of the graph chain with G^T, into dxg (which holds dT_0's share)
  const long long rows = (long long)B * t1 * c1;
  if (d.graph_conv) {
    STGCN_TRY(launch_graph_mm(dt(0), gso, dxg, dxg, 1.0f, 1.0f, rows, vp, d.V, 1, s));
  } else if (d.ks >= 2) {
    for (int k = d.ks - 1; k >= 2; --k) {
      STGCN_TRY(launch_graph_mm(dt(k), gso, dt(k - 1), dt(k - 1), 2.0f, 1.0f, rows, vp, d.V, 1,
                                s));
      STGCN_TRY(axpby(-1.0f, dt(k), 1.0f, k == 2 ? dxg : dt(k - 2), act1, s));
    }
    STGCN_TRY(launch_graph_mm(dt(1), gso, dxg, dxg, 1.0f, 1.0f, rows, vp, d.V, 1, s));
  }

  // 5. K1b's head: s1 recomputed from x, da1 = dxg . gaw^T and gate 1's
  //    backward in one pass (ds1, a1), the weight gradients, dx
  STGCN_TRY(launch_gate_pass(f.x_cv, w.c1k, w.c1b, GateUp{dxg, w.gaw, c1, nullptr, nullptr, 0},
                             ds1, a1, B, d.t_in, d.c_in, vp, d.kt, d.c0, d.act, s));
  STGCN_TRY(launch_wgrad_bias(Cv{a1, t1, d.c0}, 1, Cv{dxg, t1, c1}, g.dgaw, g.dgab, part, B, vp,
                              s));
  STGCN_TRY(launch_wgrad_bias(Cv{f.x_cv, d.t_in, d.c_in}, d.kt, Cv{ds1, t1, d.g1}, g.dc1k,
                              g.dc1b, part, B, vp, s));
  // dx = conv1^T(ds1) + ds1's linear half at the window's last step
  STGCN_TRY(launch_gate_dx(ds1, w.c1k, dx_cv, B, d.t_in, d.c_in, vp, d.kt, d.g1, s));
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
