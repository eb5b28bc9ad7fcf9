// K1b (block head) and K2b (block tail) of one STGCN ST block, backward:
// the C entry points. Each runs as a short pipeline of launches on the
// caller's stream, recomputing its forward from the saved inputs as the TPU
// kernels do.
//
// Replaces the TPU kernels stgcn_tpu/kernels/vertex_fused.py
// `_head_pallas_bwd` (:654, body `_make_head_bwd_kernel` :529 /
// `_head_core_bwd` :406 / `_ln_drop_bwd` :378) and `_tail_pallas_bwd` (:883,
// body `_make_tail_bwd_kernel` :791 / `_tail_core_bwd` :445).
//
// K1b: x4 = LN-normalize(x) * mask (regenerated from (seed, site, element),
//      so any tiling gives the forward's mask; block 1 reads x itself), then
//      one pass per lane tile (launch_gate_pass, head policy) that recomputes
//      s1 = tconv1(x4) + c1b on the register tile of f32_tile.cuh (gate
//      channels x lanes, as K1's gate GEMM), computes da1 = gy . gaw^T and
//      runs the gate backward in its epilogue, writing only ds1 and a1 (s1
//      never reaches device memory; the residual's gradient dxin is ds1's
//      linear half) -> weight gradients dgaw with dgab, dc1k with dc1b (the
//      bias as a ones row of the same product, so gy and ds1 are read once
//      each) -> dx4 = tconv1^T(ds1) + dxin on the same tile (launch_gate_dx;
//      block 1's narrow input: one pass over ds1 by lanes) -> LayerNorm
//      backward dx, dmu, drstd, dlng, dlnb.
//      What bounds it: at block 2's widths (c_in = c0 = 64) float32 FMA
//      issue, three products of kt*c_in*g1 per lane and step (recompute,
//      dc1k, dx4); at block 1's (c_in = 1) the bytes of ds1 and a1, which it
//      writes once and reads twice and once. x4 is kept in device memory
//      (block 2: 4 B a lane, step and channel) rather than recomputed in
//      the weight gradient's staging, where the LayerNorm and the mask's
//      hash would cost more issue slots than its FMAs.
// K2b: h = relu(sum_m cterm_m gcw[m] + gcb + xg), one thread per lane
//      (tail_h_kernel, vertex_fused.cu, as K2's forward forms it; h is
//      written once: the conv's weight gradient and the ReLU mask read it)
//      -> the gate pass of K1b on h (cotangent policy: ga2 plus the
//      LayerNorm-partial cotangents gps + 2 gpss a2 on true lanes), writing
//      only ds2 (s2 and the residual's gradient dxin2, 3.3 and 1.7 GB at
//      100k block 1, never reach device memory) -> dc2k with
//      dc2b (a ones row) -> dr = (tconv2^T(ds2) + ds2's linear half) * (h > 0)
//      on a 16-row tile whose epilogue also writes dxg and the graph terms'
//      gradients from dr in shared memory (launch_tail_dr) -> dgcw, with dgcb
//      as the ones row of the first.
//      What bounds it: neither FMAs nor bytes alone. Its three products
//      (gate pass, dc2k, dr) are kt*c1*g2 = 6144 FMAs per lane and step, and
//      ds2 is written once and read twice; at 100k the gate pass runs at a
//      quarter and the dr pass at a third of the f32 peak, each about 3x its
//      bytes' time: short products (48 rows in the gate pass, 16 output
//      channels in dr) leave the tile little work per block to hide its
//      loads behind (PERF.md: a cp.async prefetch, streaming stores
//      and a two-step dr tile did not help).
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
  const long long r1 = (long long)B * t1 * vp;
  Carver w{work};
  float* x4 = apply_ln ? w.take(lane * t_in * c_in) : nullptr;
  float* dx4 = apply_ln ? w.take(lane * t_in * c_in) : dx;
  float* ds1 = w.take(lane * t1 * g1);
  float* a1 = w.take(lane * t1 * c0);
  float* part = w.take(wgrad_part_floats({{c0 + 1, c1, r1}, {kt * c_in + 1, g1, r1}}));
  float* lnpart = apply_ln ? w.take(ln_bwd_part_floats(B, t_in)) : nullptr;
  if (floats) *floats = w.used;
  if (!work) return cudaSuccess;
  if (t1 < 1 || c1 > kMaxOut) return cudaErrorInvalidValue;

  if (apply_ln) STGCN_TRY(launch_ln_drop(x, mu, rstd, lng, lnb, drop, x4, B, t_in, c_in, vp, s));
  const float* xin = apply_ln ? x4 : x;
  // s1, da1 and the gate backward in one pass: ds1, a1
  STGCN_TRY(launch_gate_pass(xin, c1k, c1b, GateUp{gy, gaw, c1, nullptr, nullptr, 0}, ds1, a1, B,
                             t_in, c_in, vp, kt, c0, act, s));
  STGCN_TRY(launch_wgrad_bias(Cv{a1, t1, c0}, 1, Cv{gy, t1, c1}, dgaw, dgab, part, B, vp, s));
  STGCN_TRY(launch_wgrad_bias(Cv{xin, t_in, c_in}, kt, Cv{ds1, t1, g1}, dc1k, dc1b, part, B, vp,
                              s));
  // dx4 = tconv1^T(ds1) + dxin shifted to the window's last step
  STGCN_TRY(launch_gate_dx(ds1, c1k, dx4, B, t_in, c_in, vp, kt, g1, s));
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
  float* ds2 = w.take(lane * t2 * g2);
  const long long r1 = (long long)B * t1 * vp, r2 = (long long)B * t2 * vp;
  float* part = w.take(wgrad_part_floats({{kt * c1 + 1, g2, r2}, {c1 + 1, c1, r1},
                                          {c1, c1, r1}}));
  if (floats) *floats = w.used;
  if (!work) return cudaSuccess;
  if (t2 < 1 || n_c < 1 || n_c > 3 || n_terms > 2) return cudaErrorInvalidValue;

  const float* terms[2] = {t_a, t_b};
  const float* ct[3] = {nullptr, nullptr, nullptr};  // contraction operands
  int m = 0;
  if (cheb) ct[m++] = xg;
  for (int i = 0; i < n_terms; ++i) ct[m++] = terms[i];
  // h = relu(sum_m ct_m gcw[m] + gcb + xg)
  STGCN_TRY(launch_tail_h(ct, n_c, gcw, gcb, xg, h, B, t1, c1, vp, s));
  // s2 = tconv2(h) + c2b and the gate backward from ga2, gps, gpss in one pass: ds2
  STGCN_TRY(launch_gate_pass(h, c2k, c2b, GateUp{ga2, nullptr, 0, gps, gpss, v_true}, ds2,
                             nullptr, B, t1, c1, vp, kt, c2, act, s));
  STGCN_TRY(launch_wgrad_bias(Cv{h, t1, c1}, kt, Cv{ds2, t2, g2}, dc2k, dc2b, part, B, vp, s));
  // dr = (tconv2^T(ds2) + dxin2 shifted) * (h > 0), then dxg and the terms' gradients
  STGCN_TRY(launch_tail_dr(ds2, c2k, h, gcw, dr, dxg, dt_a, dt_b, B, t1, c1, vp, kt, g2,
                           n_terms, cheb ? 1 : 0, s));
  for (int i = 0; i < n_c; ++i)   // dgcw[i], with dgcb as the first one's ones row
    STGCN_TRY(launch_wgrad_bias(Cv{ct[i], t1, c1}, 1, Cv{dr, t1, c1}, dgcw + (size_t)i * c1 * c1,
                                i == 0 ? dgcb : nullptr, part, B, vp, s));
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
