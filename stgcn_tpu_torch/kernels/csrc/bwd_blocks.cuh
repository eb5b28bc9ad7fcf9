// Building blocks of the backward kernels K1b-K4b and K12b (vertex_fused_bwd.cu,
// output_head_bwd.cu, fused_stblock_bwd.cu). Every operand is a cv tensor
// [B, T, C, Vp] float32 with Vp a multiple of kLanes; the bf16 overloads
// (bwd_blocks_bf16.cu: K1b-K4b's bf16 variants, the TPU kernels'
// precision="bfloat16" build) take bf16 activations and weights, float32
// biases, statistics and weight gradients, and round where the TPU kernels
// round (see each launcher). Each launcher returns
// the cudaError_t of its launch. No block adds into memory another block
// writes: weight gradients go through per-slice partials and a fixed-order
// second pass, so a repeated backward is bit-identical. Every product of
// the backward kernels runs on the register tile of f32_tile.cuh (the gate
// pass, the data gradients, tail_dr, wgrad).
#pragma once

#include <initializer_list>

#include "common.cuh"

namespace stgcn {

// Carves float buffers out of one workspace, in call order; with a null
// base it only counts (the entry points size their workspace this way).
struct Carver {
  float* base;
  size_t used = 0;
  float* take(size_t n) {
    float* p = base ? base + used : nullptr;
    used += (n + 63) / 64 * 64;  // keep every buffer 256-byte aligned
    return p;
  }
  // n elements of T (a bf16 buffer takes half the floats)
  template <typename T>
  T* take_as(size_t n) {
    return reinterpret_cast<T*>(take((n * sizeof(T) + sizeof(float) - 1) / sizeof(float)));
  }
};

// Return the error of a launch that failed.
#define STGCN_TRY(...)                          \
  do {                                          \
    const cudaError_t err_ = (__VA_ARGS__);     \
    if (err_ != cudaSuccess) return err_;       \
  } while (0)

// A cv operand: data pointer and its time / channel extents.
template <typename T>
struct CvT {
  const T* p;
  int t, c;
};
using Cv = CvT<float>;

// y = ((x - mu[b, t]) * rstd[b, t] * lng[c, v] + lnb[c, v]) * mask, over
// x [B, T, C, Vp]; mask as `drop` gives it (none when threshold is 0).
cudaError_t launch_ln_drop(const float* x, const float* mu, const float* rstd, const float* lng,
                           const float* lnb, Drop drop, float* y, int batch, int t, int c,
                           int vp, cudaStream_t stream);

// The gate backward at one point: the gate value av of the pre-activations
// p (and, gated, q) with the residual xin, and the gradients dp, dq for the
// upstream gradient d, plus gp + 2 gpss av when `add` (the LayerNorm-partial
// cotangents). dq is 0 for relu and silu.
__device__ __forceinline__ void gate_point_bwd(int act, float p, float q, float xin, float d,
                                               bool add, float gp, float gpss, float& dp,
                                               float& dq, float& av) {
  dq = 0.0f;
  if (act == kGlu || act == kGtu) {
    const float lin = p + xin;
    const float sq = sigmoid(q);
    if (act == kGlu) {
      av = lin * sq;
      if (add) d += gp + 2.0f * gpss * av;
      dp = d * sq;
      dq = d * lin * sq * (1.0f - sq);
    } else {
      const float th = tanhf(lin);
      av = th * sq;
      if (add) d += gp + 2.0f * gpss * av;
      dp = d * sq * (1.0f - th * th);
      dq = d * th * sq * (1.0f - sq);
    }
  } else {
    const float z = p + xin;
    if (act == kRelu) {
      av = fmaxf(z, 0.0f);
      if (add) d += gp + 2.0f * gpss * av;
      dp = z > 0.0f ? d : 0.0f;
    } else {
      const float sz = sigmoid(z);
      av = z * sz;
      if (add) d += gp + 2.0f * gpss * av;
      dp = d * sz * (1.0f + z * (1.0f - sz));
    }
  }
}

// The upstream gradient of a fused gate pass (launch_gate_pass), one of two
// policies, fixed at compile time inside the kernel:
//  - head (K1b, K12b's head, K4b's fc1; gaw given): da = gy . gaw^T over
//    o < c1, gy [B, t_out, c1, Vp], gaw [c0, c1]; the pass also writes the
//    gate value a (K4b's fc1, launch_fc_pass: its dw2 partials instead, and
//    da masked by `drop`, fc1's dropout);
//  - cotangent (K2b, K3b, K12b's conv 2; gaw null): da = ga [B, t_out, c0,
//    Vp] (in gy), plus gps[b, t] + 2 gpss[b, t] a on lanes v < v_true (the
//    LayerNorm-partial cotangents, gps/gpss [B, t_out]).
template <typename T>
struct GateUpT {
  const T* gy;
  const T* gaw;
  int c1;
  const float* gps;
  const float* gpss;
  int v_true;
  Drop drop;   // K4b's fc1 dropout (launch_fc_pass); unread by the other passes
};
using GateUp = GateUpT<float>;

// The gated conv's recompute and gate backward in one pass on the register
// tile of f32_tile.cuh (64 gate channels x 64 lanes a block): s = bias +
// sum over rows (k, c) of w[k, c, :] x[b, t + k, c, :] (w [kt, c_in, G],
// G = 2 c0 gated, c0 otherwise; rows ascending), then gate_point_bwd with
// the in-gate residual x[b, t + kt - 1, c] (c < c_in <= c0). Writes ds
// [B, t_out, G, Vp] (t_out = t_in - kt + 1) and, for the head policy, a_out
// [B, t_out, c0, Vp]; s never reaches device memory. The residual's gradient
// is ds's linear half on c < c_in (launch_gate_dx reads it there).
cudaError_t launch_gate_pass(const float* x, const float* w, const float* bias, GateUp up,
                             float* ds, float* a_out, int batch, int t_in, int c_in, int vp,
                             int kt, int c0, int act, cudaStream_t stream);

// The gated conv's data gradient with its residual's: for t < t_in, o < c_in,
//   dx[b, t, o, :] = sum over taps k with 0 <= t - k < t_out, then g < G, of
//                    ds[b, t - k, g, :] w[k, o, g]  + ds[b, t - kt + 1, o, :]
// (the last term where that step exists; none without `residual`), on the
// tile (a lane kernel that reads ds once where c_in <= 4). K1b's and K12b's
// dx4, K3b's with t_out = 1, K4b's dh with kt = 1 and no residual (the
// residual is a template parameter of both kernels).
cudaError_t launch_gate_dx(const float* ds, const float* w, float* dx, int batch, int t_in,
                           int c_in, int vp, int kt, int g, cudaStream_t stream,
                           bool residual = true);

// K4b's fc1 pass: the gate pass of K1b (head policy, kt = 1, relu, no
// in-gate residual) on the normalized input h [B, 1, c_in, Vp] with w1
// [c_in, c1], b1 [c1]: s2 = h . w1 + b1 recomputed on the tile, dzd = gout
// . w2^T (gout [B, 1, ce, Vp], w2 [c1, ce], ce <= kMaxOut), times fc1's
// dropout mask (`drop`, keyed [B, 1, c1, V_true] as K4f's), then ds2 = dzd
// * mask * (s2 > 0), the only tensor written; and in the same epilogue dw2
// [c1, ce] = sum over (b, v) of relu(s2) * mask * gout and db1 [c1] = sum
// over (b, v) of ds2, as per-block partials (a block's 64 lanes) summed in
// a fixed order by two passes: s2, zd and dzd never reach device memory.
// part: fc_pass_part_floats(...) floats.
cudaError_t launch_fc_pass(const float* h, const float* w1, const float* b1, const float* gout,
                           const float* w2, Drop drop, float* ds2, float* dw2, float* db1,
                           float* part, int batch, int c_in, int vp, int c1, int ce,
                           cudaStream_t stream);
size_t fc_pass_part_floats(int batch, int vp, int c1, int ce);

// K2b's data gradient on a 16-row tile: dr = (tconv2^T(ds2) + ds2's linear
// half at step t - kt + 1) * (h > 0), dr [B, t1, c1, Vp] (c1 <= kMaxOut),
// then in the same block, from dr in shared memory, dxg = dr (+ dr . gcw[0]^T
// when cheb) and each graph term's gradient dt_i = dr . gcw[i + cheb]^T
// (n_terms of them; dt_b untouched when n_terms is 1). gcw [n_terms + cheb,
// c1, c1], c2k [kt, c1, g2], ds2 [B, t1 - kt + 1, g2, Vp].
// (K2b, and K12b's graph terms T_0 .. T_2.)
cudaError_t launch_tail_dr(const float* ds2, const float* c2k, const float* h, const float* gcw,
                           float* dr, float* dxg, float* dt_a, float* dt_b, int batch, int t1,
                           int c1, int vp, int kt, int g2, int n_terms, int cheb,
                           cudaStream_t stream);

// The graph terms' gradients past tail_dr's (K12b at Ks >= 4): for m <
// n_terms, dt_m = dr . gcw[m]^T (o ascending from 0, as tail_dr sums), dr
// [B, t1, c1, Vp], gcw [n_terms, c1, c1], dt_m at dt + m * B t1 c1 Vp; one
// thread a lane, dr read once.
cudaError_t launch_term_grads(const float* dr, const float* gcw, float* dt, int n_terms,
                              int batch, int t1, int c1, int vp, cudaStream_t stream);

// Weight gradient out[k, c, o] = sum over b, t < D.t, v of X[b, t + k, c, v]
// * D[b, t, o, v] for k < K, c < X.c, o < D.c; X.p null stands for ones
// (X.c = 1, K = 1: the bias gradient). It runs on the register tile of
// f32_tile.cuh: the reduction (b, t, v) is cut into slices of at most 4096
// terms, as many as fill the card, all fixed by the shapes (so also the
// lanes of each step when B * D.t is small: batch 1 at 1M vertices); each
// slice's partial goes to `part` (wgrad_part_floats of the call's shape)
// and a second pass sums them in slice order. No f32 chain sums more than
// 4096 terms before it is banked.
cudaError_t launch_wgrad(Cv x, int k, Cv d, float* out, float* part, int batch, int vp,
                         cudaStream_t stream);

// The same with a row of ones after X's rows, in the same pass: out as
// above and bias[o] = sum over b, t, v of D[b, t, o, v], so D is read once
// for both (K1b's dc1k with dc1b, dgaw with dgab).
cudaError_t launch_wgrad_bias(Cv x, int k, Cv d, float* out, float* bias, float* part, int batch,
                              int vp, cudaStream_t stream);

// The shape of one weight-gradient call: m rows of X (K * X.c, plus 1 for
// launch_wgrad_bias's ones row; 1 for a bias alone), n = D.c, terms =
// B * D.t * Vp.
struct WgradShape {
  int m, n;
  long long terms;
};
// Floats of `part` enough for every one of `calls`.
size_t wgrad_part_floats(std::initializer_list<WgradShape> calls);

// LayerNorm backward with given statistics, for dy = the gradient of
// y = ((x - mu) * rstd * lng + lnb) * mask over x [B, T, C, Vp]:
//   dx = dy * mask * lng * rstd, dmu[b, t] = -rstd * sum_{c,v} dy * mask * lng,
//   drstd[b, t] = sum_{c,v} dy * mask * lng * (x - mu)   (per (b, t) row, up to
//   kLnSplits slice partials in `part`, ln_bwd_part_floats(B, T) floats, then
//   a fixed-order sum of them; a row of at most 32768 elements is one slice,
//   one block per row, and its block writes dmu and drstd at once);
//   dlng[c, v] = sum_{b,t} dy * mask * xn, dlnb[c, v] = sum_{b,t} dy * mask
//   (one thread per (c, v) over every (b, t) in order; with affine_part,
//   ln_affine_part_floats(B, T, C, Vp) floats, slices of the (b, t) rows
//   each summed so, then the slices in order: K12b's many rows).
constexpr int kLnSplits = 256;
inline size_t ln_bwd_part_floats(int batch, int t) { return (size_t)batch * t * kLnSplits * 2; }
size_t ln_affine_part_floats(int batch, int t, int c, int vp);
cudaError_t launch_ln_bwd(const float* x, const float* mu, const float* rstd, const float* lng,
                          Drop drop, const float* dy, float* dx, float* dmu, float* drstd,
                          float* dlng, float* dlnb, float* part, int batch, int t, int c, int vp,
                          cudaStream_t stream, float* affine_part = nullptr);

// ---- the bf16 overloads (bwd_blocks_bf16.cu) -----------------------------
//
// Each computes what its float32 launcher above does, on bf16 operands
// widened exactly into the same float32 tile and sums, and rounds to bf16
// where the TPU's bf16 backward kernels round (stgcn_tpu/kernels/
// vertex_fused.py `_gate_bwd_cv` :306, `_tconv_bwd_cv` :348, `_ln_drop_bwd`
// :378, `_head_core_bwd` :407, `_tail_core_bwd` :445; output_head.py
// `_make_ohead_bwd_kernel` :160, `_make_ofc_bwd_kernel` :349). The dropout
// scale is the caller's, rounded to bf16 (the TPU's bf16 mask).
//  - ln_drop: the normalized value rounded, then its bf16 product with the mask.
//  - gate_pass: s rounded, the upstream gradient rounded (the head policy's
//    gy . gaw^T; the cotangent policy's ga + gps + 2 gpss a once), the gate
//    backward each op rounded (gate_point_bwd_bf16); ds and a in bf16.
//  - fc_pass: dzd = gout . w2^T rounded, dz = dzd * mask and zd = relu(s2) *
//    mask bf16 products; ds2 in bf16; the dw2 / db1 partials float32.
//  - gate_dx / tail_dr: each tap's float32 sum rounded, the taps added in
//    bf16 in ascending order (k = 0 .. kt-1), then the residual's gradient a
//    bf16 add; tail_dr's dr = dh * (h > 0), the graph terms' gradients each
//    rounded, dxg = dr + dcterms_0 a bf16 add.
//  - wgrad: float32 sums and outputs (the weights' gradients).
//  - ln_bwd: the statistics in float32; dy * mask a bf16 product; dx =
//    dxn * rstd rounded; dlng, dlnb summed over every (b, t) in float32 and
//    rounded once (no affine_part).
cudaError_t launch_ln_drop(const bf16* x, const float* mu, const float* rstd, const bf16* lng,
                           const bf16* lnb, Drop drop, bf16* y, int batch, int t, int c, int vp,
                           cudaStream_t stream);
cudaError_t launch_gate_pass(const bf16* x, const bf16* w, const float* bias, GateUpT<bf16> up,
                             bf16* ds, bf16* a_out, int batch, int t_in, int c_in, int vp,
                             int kt, int c0, int act, cudaStream_t stream);
cudaError_t launch_gate_dx(const bf16* ds, const bf16* w, bf16* dx, int batch, int t_in,
                           int c_in, int vp, int kt, int g, cudaStream_t stream,
                           bool residual = true);
cudaError_t launch_fc_pass(const bf16* h, const bf16* w1, const float* b1, const bf16* gout,
                           const bf16* w2, Drop drop, bf16* ds2, float* dw2, float* db1,
                           float* part, int batch, int c_in, int vp, int c1, int ce,
                           cudaStream_t stream);
cudaError_t launch_tail_dr(const bf16* ds2, const bf16* c2k, const bf16* h, const bf16* gcw,
                           bf16* dr, bf16* dxg, bf16* dt_a, bf16* dt_b, int batch, int t1,
                           int c1, int vp, int kt, int g2, int n_terms, int cheb,
                           cudaStream_t stream);
cudaError_t launch_wgrad(CvT<bf16> x, int k, CvT<bf16> d, float* out, float* part, int batch,
                         int vp, cudaStream_t stream);
cudaError_t launch_wgrad_bias(CvT<bf16> x, int k, CvT<bf16> d, float* out, float* bias,
                              float* part, int batch, int vp, cudaStream_t stream);
cudaError_t launch_ln_bwd(const bf16* x, const float* mu, const float* rstd, const bf16* lng,
                          Drop drop, const bf16* dy, bf16* dx, float* dmu, float* drstd,
                          bf16* dlng, bf16* dlnb, float* part, int batch, int t, int c, int vp,
                          cudaStream_t stream);
// y = x rounded to bf16, n elements (K4b's float32 output cotangent)
cudaError_t launch_to_bf16(const float* x, bf16* y, size_t n, cudaStream_t stream);

}  // namespace stgcn
