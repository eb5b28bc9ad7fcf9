// K1b (block head) and K2b (block tail) of one STGCN ST block, backward:
// the C entry points. Each runs as a pipeline of the building blocks in
// bwd_blocks.cu on the caller's stream, recomputing its forward from the
// saved inputs as the TPU kernels do.
//
// Replaces the TPU kernels stgcn_tpu/kernels/vertex_fused.py
// `_head_pallas_bwd` (:654, body `_make_head_bwd_kernel` :529 /
// `_head_core_bwd` :406 / `_ln_drop_bwd` :378) and `_tail_pallas_bwd` (:883,
// body `_make_tail_bwd_kernel` :791 / `_tail_core_bwd` :445).
//
// K1b: x4 = LN-normalize(x) * mask (regenerated from (seed, site, element),
//      so any tiling gives the forward's mask) -> s1 = tconv1(x4) -> a1, and
//      from gy: da1 = gy . gaw^T -> gate backward -> ds1, dxin -> weight
//      gradients dgaw, dgab, dc1k, dc1b -> dx4 = tconv1^T(ds1) + dxin ->
//      LayerNorm backward dx, dmu, drstd, dlng, dlnb.
// K2b: h = relu(sum_m cterm_m gcw[m] + gcb + xg) -> s2 = tconv2(h) -> gate
//      backward from ga2 plus the LayerNorm-partial cotangents (gps + 2 gpss
//      a2 on true lanes) -> dc2k, dc2b -> dr = (tconv2^T(ds2) + dxin2) *
//      (h > 0) -> dgcw, dgcb -> dxg and the graph terms' gradients.
#include "bwd_blocks.cuh"

namespace stgcn {
namespace {

// One pass over the head backward. With work == nullptr it only sizes the
// workspace (returned through `floats`).
cudaError_t head_bwd(const float* x, const float* mu, const float* rstd, const float* lng,
                     const float* lnb, const float* c1k, const float* c1b, const float* gaw,
                     const float* gy, float* dx, float* dmu, float* drstd, float* dlng,
                     float* dlnb, float* dc1k, float* dc1b, float* dgaw, float* dgab,
                     float* work, size_t* floats, int B, int t_in, int c_in, int vp, int kt,
                     int c0, int c1, int act, int apply_ln, Drop drop, cudaStream_t s) {
  const bool gated = act == kGlu || act == kGtu;
  const int g1 = gated ? 2 * c0 : c0, t1 = t_in - kt + 1;
  const size_t lane = (size_t)B * vp;
  Carver w{work};
  float* x4 = apply_ln ? w.take(lane * t_in * c_in) : nullptr;
  float* dx4 = apply_ln ? w.take(lane * t_in * c_in) : dx;
  float* s1 = w.take(lane * t1 * g1);
  float* ds1 = w.take(lane * t1 * g1);
  float* a1 = w.take(lane * t1 * c0);
  float* da1 = w.take(lane * t1 * c0);
  float* dxin = w.take(lane * t1 * c0);
  size_t wmax = (size_t)kt * c_in * g1;
  if ((size_t)c0 * c1 > wmax) wmax = (size_t)c0 * c1;
  float* part = w.take(kWgradSlices * wmax);
  float* lnpart = apply_ln ? w.take(ln_bwd_part_floats(B, t_in)) : nullptr;
  if (floats) *floats = w.used;
  if (!work) return cudaSuccess;
  if (t1 < 1 || c1 > kMaxOut) return cudaErrorInvalidValue;

  if (apply_ln) STGCN_TRY(launch_ln_drop(x, mu, rstd, lng, lnb, drop, x4, B, t_in, c_in, vp, s));
  const float* xin = apply_ln ? x4 : x;
  const Cv none{nullptr, 0, 0};
  // s1 = tconv1(x4) + c1b
  STGCN_TRY(launch_contract({{xin, nullptr, nullptr}, t_in, c_in, c1k, kt, 1, 0, c1b, none, 0,
                             0, nullptr, s1, B, t1, g1, vp}, s));
  // da1 = gy . gaw^T
  STGCN_TRY(launch_contract({{gy, nullptr, nullptr}, t1, c1, gaw, 1, 0, 1, nullptr, none, 0, 0,
                             nullptr, da1, B, t1, c0, vp}, s));
  STGCN_TRY(launch_gate_bwd(s1, Cv{xin, t_in, c_in}, kt - 1, da1, nullptr, nullptr, 0, act, c0,
                            ds1, dxin, a1, B, t1, vp, s));
  STGCN_TRY(launch_wgrad(Cv{a1, t1, c0}, 1, Cv{gy, t1, c1}, dgaw, part, B, vp, s));
  STGCN_TRY(launch_wgrad(Cv{nullptr, 0, 1}, 1, Cv{gy, t1, c1}, dgab, part, B, vp, s));
  STGCN_TRY(launch_wgrad(Cv{xin, t_in, c_in}, kt, Cv{ds1, t1, g1}, dc1k, part, B, vp, s));
  STGCN_TRY(launch_wgrad(Cv{nullptr, 0, 1}, 1, Cv{ds1, t1, g1}, dc1b, part, B, vp, s));
  // dx4 = tconv1^T(ds1) + dxin shifted to the window's last step
  STGCN_TRY(launch_contract({{ds1, nullptr, nullptr}, t1, g1, c1k, kt, 1, 1, nullptr,
                             Cv{dxin, t1, c0}, kt - 1, 0, nullptr, dx4, B, t_in, c_in, vp}, s));
  if (apply_ln)
    STGCN_TRY(launch_ln_bwd(x, mu, rstd, lng, drop, dx4, dx, dmu, drstd, dlng, dlnb, lnpart, B,
                            t_in, c_in, vp, s));
  return cudaSuccess;
}

cudaError_t tail_bwd(const float* xg, const float* t_a, const float* t_b, const float* gcw,
                     const float* gcb, const float* c2k, const float* c2b, const float* ga2,
                     const float* gps, const float* gpss, float* dxg, float* dt_a, float* dt_b,
                     float* dgcw, float* dgcb, float* dc2k, float* dc2b, float* work,
                     size_t* floats, int B, int t1, int c1, int vp, int kt, int n_terms,
                     int cheb, int c2, int act, int v_true, cudaStream_t s) {
  const bool gated = act == kGlu || act == kGtu;
  const int g2 = gated ? 2 * c2 : c2, t2 = t1 - kt + 1;
  const int n_c = n_terms + (cheb ? 1 : 0);
  const size_t lane = (size_t)B * vp;
  Carver w{work};
  float* h = w.take(lane * t1 * c1);
  float* dr = w.take(lane * t1 * c1);
  float* s2 = w.take(lane * t2 * g2);
  float* ds2 = w.take(lane * t2 * g2);
  float* dxin2 = w.take(lane * t2 * c2);
  size_t wmax = (size_t)kt * c1 * g2;
  if ((size_t)c1 * c1 > wmax) wmax = (size_t)c1 * c1;
  float* part = w.take(kWgradSlices * wmax);
  if (floats) *floats = w.used;
  if (!work) return cudaSuccess;
  if (t2 < 1 || n_c < 1 || n_c > 3 || n_terms > 2) return cudaErrorInvalidValue;

  const float* terms[2] = {t_a, t_b};
  float* dterms[2] = {dt_a, dt_b};
  const float* ct[3] = {nullptr, nullptr, nullptr};  // contraction operands
  int m = 0;
  if (cheb) ct[m++] = xg;
  for (int i = 0; i < n_terms; ++i) ct[m++] = terms[i];
  const Cv none{nullptr, 0, 0};
  // h = relu(sum_m ct_m gcw[m] + gcb + xg)
  STGCN_TRY(launch_contract({{ct[0], ct[1], ct[2]}, t1, c1, gcw, n_c, 0, 0, gcb,
                             Cv{xg, t1, c1}, 0, 1, nullptr, h, B, t1, c1, vp}, s));
  // s2 = tconv2(h) + c2b
  STGCN_TRY(launch_contract({{h, nullptr, nullptr}, t1, c1, c2k, kt, 1, 0, c2b, none, 0, 0,
                             nullptr, s2, B, t2, g2, vp}, s));
  STGCN_TRY(launch_gate_bwd(s2, Cv{h, t1, c1}, kt - 1, ga2, gps, gpss, v_true, act, c2, ds2,
                            dxin2, nullptr, B, t2, vp, s));
  STGCN_TRY(launch_wgrad(Cv{h, t1, c1}, kt, Cv{ds2, t2, g2}, dc2k, part, B, vp, s));
  STGCN_TRY(launch_wgrad(Cv{nullptr, 0, 1}, 1, Cv{ds2, t2, g2}, dc2b, part, B, vp, s));
  // dr = (tconv2^T(ds2) + dxin2 shifted) * (h > 0)
  STGCN_TRY(launch_contract({{ds2, nullptr, nullptr}, t2, g2, c2k, kt, 1, 1, nullptr,
                             Cv{dxin2, t2, c2}, kt - 1, 0, h, dr, B, t1, c1, vp}, s));
  for (int i = 0; i < n_c; ++i)
    STGCN_TRY(launch_wgrad(Cv{ct[i], t1, c1}, 1, Cv{dr, t1, c1}, dgcw + (size_t)i * c1 * c1,
                           part, B, vp, s));
  STGCN_TRY(launch_wgrad(Cv{nullptr, 0, 1}, 1, Cv{dr, t1, c1}, dgcb, part, B, vp, s));
  // dxg = dr (+ dr . gcw[0]^T for Chebyshev, where xg is the term T_0)
  STGCN_TRY(launch_contract({{dr, nullptr, nullptr}, t1, c1, gcw, cheb ? 1 : 0, 0, 1, nullptr,
                             Cv{dr, t1, c1}, 0, 0, nullptr, dxg, B, t1, c1, vp}, s));
  for (int i = 0; i < n_terms; ++i) {
    const float* wi = gcw + (size_t)(i + (cheb ? 1 : 0)) * c1 * c1;
    STGCN_TRY(launch_contract({{dr, nullptr, nullptr}, t1, c1, wi, 1, 0, 1, nullptr, none, 0, 0,
                               nullptr, dterms[i], B, t1, c1, vp}, s));
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace stgcn

using namespace stgcn;

extern "C" {

// K1b. Outputs: dx [B, t_in, c_in, Vp]; with apply_ln also dmu, drstd
// [B, t_in] and dlng, dlnb [c_in, Vp]; dc1k [kt, c_in, g1], dc1b [g1],
// dgaw [c0, c1], dgab [c1]. work: stgcn_head_bwd_work(...) floats.
int stgcn_head_bwd(const float* x, const float* mu, const float* rstd, const float* lng,
                   const float* lnb, const float* c1k, const float* c1b, const float* gaw,
                   const float* gy, float* dx, float* dmu, float* drstd, float* dlng,
                   float* dlnb, float* dc1k, float* dc1b, float* dgaw, float* dgab, float* work,
                   int B, int t_in, int c_in, int vp, int kt, int c0, int c1, int act,
                   int apply_ln, int v_true, unsigned seed, int site, unsigned threshold,
                   float scale, void* stream) {
  return head_bwd(x, mu, rstd, lng, lnb, c1k, c1b, gaw, gy, dx, dmu, drstd, dlng, dlnb, dc1k,
                  dc1b, dgaw, dgab, work, nullptr, B, t_in, c_in, vp, kt, c0, c1, act,
                  apply_ln, make_drop(seed, site, threshold, scale, v_true),
                  static_cast<cudaStream_t>(stream));
}

long long stgcn_head_bwd_work(int B, int t_in, int c_in, int vp, int kt, int c0, int c1,
                              int act, int apply_ln) {
  size_t n = 0;
  head_bwd(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
           nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
           nullptr, &n, B, t_in, c_in, vp, kt, c0, c1, act, apply_ln,
           make_drop(0, 0, 0, 1.0f, vp), nullptr);
  return (long long)n;
}

// K2b. ga2 [B, t2, c2, Vp], gps/gpss [B, t2]. Outputs: dxg and the gradient of
// each of the n_terms graph terms (t_a, t_b) [B, t1, c1, Vp]; dgcw [n_c, c1,
// c1] (n_c = n_terms + cheb), dgcb [c1], dc2k [kt, c1, g2], dc2b [g2].
int stgcn_tail_bwd(const float* xg, const float* t_a, const float* t_b, const float* gcw,
                   const float* gcb, const float* c2k, const float* c2b, const float* ga2,
                   const float* gps, const float* gpss, float* dxg, float* dt_a, float* dt_b,
                   float* dgcw, float* dgcb, float* dc2k, float* dc2b, float* work, int B,
                   int t1, int c1, int vp, int kt, int n_terms, int cheb, int c2, int act,
                   int v_true, void* stream) {
  return tail_bwd(xg, t_a, t_b, gcw, gcb, c2k, c2b, ga2, gps, gpss, dxg, dt_a, dt_b, dgcw, dgcb,
                  dc2k, dc2b, work, nullptr, B, t1, c1, vp, kt, n_terms, cheb, c2, act, v_true,
                  static_cast<cudaStream_t>(stream));
}

long long stgcn_tail_bwd_work(int B, int t1, int c1, int vp, int kt, int n_terms, int cheb,
                              int c2, int act) {
  size_t n = 0;
  tail_bwd(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
           nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, &n,
           B, t1, c1, vp, kt, n_terms, cheb, c2, act, 0, nullptr);
  return (long long)n;
}

}  // extern "C"
