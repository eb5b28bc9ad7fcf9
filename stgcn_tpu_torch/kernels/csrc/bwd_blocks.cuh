// Building blocks of the backward kernels K1b-K4b and K12b (vertex_fused_bwd.cu,
// output_head_bwd.cu, fused_stblock_bwd.cu). Every operand is a cv tensor
// [B, T, C, Vp] float32 with Vp a multiple of kLanes. Each launcher returns
// the cudaError_t of its launch. No block adds into memory another block
// writes: weight gradients go through per-slice partials and a fixed-order
// second pass, so a repeated backward is bit-identical.
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
};

// Return the error of a launch that failed.
#define STGCN_TRY(...)                          \
  do {                                          \
    const cudaError_t err_ = (__VA_ARGS__);     \
    if (err_ != cudaSuccess) return err_;       \
  } while (0)

// A cv operand: data pointer and its time / channel extents.
struct Cv {
  const float* p;
  int t, c;
};

// Y[b, t, o, v] (t < ty, o < O) = bias[o] + sum over taps k < K and channels
// c < C of X_k[b, tx, c, v] * W(k, c, o), where tx = t + k*tstep (forward)
// or t - k*tstep (back: taps that fall outside [0, X.t) are skipped), and
// X_k is xs[k] for k < 3 when given, else xs[0] (taps may name separate
// operands: the Chebyshev terms).
// W(k, c, o) is w[(k*C + c)*O + o] forward and w[(k*O + o)*C + c] back (the
// transposed weight). Then, in this order: + add[b, t - add_shift, o, v]
// where that lies inside add (o < add.c); relu when relu_out; times
// (pos[b, t, o, v] > 0) when pos is given. K may be 0 (Y = add).
struct ContractArgs {
  const float* xs[3];
  int x_t, c;          // time length and channels of every X_k
  const float* w;
  int k, tstep, back;
  const float* bias;   // [O] or null
  Cv add;              // add.p may be null
  int add_shift, relu_out;
  const float* pos;    // same shape as y, or null
  float* y;
  int batch, ty, o, vp;
};
cudaError_t launch_contract(const ContractArgs& a, cudaStream_t stream);

// y = ((x - mu[b, t]) * rstd[b, t] * lng[c, v] + lnb[c, v]) * mask, over
// x [B, T, C, Vp]; mask as `drop` gives it (none when threshold is 0).
cudaError_t launch_ln_drop(const float* x, const float* mu, const float* rstd, const float* lng,
                           const float* lnb, Drop drop, float* y, int batch, int t, int c,
                           int vp, cudaStream_t stream);

// Backward of the gate with its in-gate residual, elementwise over
// s [B, T, G, Vp] (G = 2*c_out gated, c_out otherwise). xin = res[b, t +
// res_shift, c, v] for c < res.c, else 0. The upstream gradient is da
// [B, T, c_out, Vp]. Writes ds [B, T, G, Vp], dxin [B, T, c_out, Vp] and,
// when given, a_out (the forward gate value). (K12b; K1b-K3b run the gate
// backward in their gate pass, launch_gate_pass.)
cudaError_t launch_gate_bwd(const float* s, Cv res, int res_shift, const float* da, int act,
                            int c_out, float* ds, float* dxin, float* a_out, int batch, int t,
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
//  - head (K1b; gaw given): da = gy . gaw^T over o < c1, gy [B, t_out, c1,
//    Vp], gaw [c0, c1]; the pass also writes the gate value a;
//  - cotangent (K2b, K3b; gaw null): da = ga [B, t_out, c0, Vp] (in gy),
//    plus gps[b, t] + 2 gpss[b, t] a on lanes v < v_true (the
//    LayerNorm-partial cotangents, gps/gpss [B, t_out]).
struct GateUp {
  const float* gy;
  const float* gaw;
  int c1;
  const float* gps;
  const float* gpss;
  int v_true;
};

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
// (the last term where that step exists), on the tile (a lane kernel that
// reads ds once where c_in <= 4). K1b's dx4, and K3b's with t_out = 1.
cudaError_t launch_gate_dx(const float* ds, const float* w, float* dx, int batch, int t_in,
                           int c_in, int vp, int kt, int g, cudaStream_t stream);

// K2b's data gradient on a 16-row tile: dr = (tconv2^T(ds2) + ds2's linear
// half at step t - kt + 1) * (h > 0), dr [B, t1, c1, Vp] (c1 <= kMaxOut),
// then in the same block, from dr in shared memory, dxg = dr (+ dr . gcw[0]^T
// when cheb) and each graph term's gradient dt_i = dr . gcw[i + cheb]^T
// (n_terms of them; dt_b untouched when n_terms is 1). gcw [n_terms + cheb,
// c1, c1], c2k [kt, c1, g2], ds2 [B, t1 - kt + 1, g2, Vp].
cudaError_t launch_tail_dr(const float* ds2, const float* c2k, const float* h, const float* gcw,
                           float* dr, float* dxg, float* dt_a, float* dt_b, int batch, int t1,
                           int c1, int vp, int kt, int g2, int n_terms, int cheb,
                           cudaStream_t stream);

// K4b's fc1 epilogue over s [B, T, C, Vp]: zd = relu(s) * mask and
// ds = dzd * mask * (s > 0).
cudaError_t launch_relu_drop(const float* s, Drop drop, const float* dzd, float* zd, float* ds,
                             int batch, int t, int c, int vp, cudaStream_t stream);

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
//   dlng[c, v] = sum_{b,t} dy * mask * xn, dlnb[c, v] = sum_{b,t} dy * mask.
constexpr int kLnSplits = 256;
inline size_t ln_bwd_part_floats(int batch, int t) { return (size_t)batch * t * kLnSplits * 2; }
cudaError_t launch_ln_bwd(const float* x, const float* mu, const float* rstd, const float* lng,
                          Drop drop, const float* dy, float* dx, float* dmu, float* drstd,
                          float* dlng, float* dlnb, float* part, int batch, int t, int c, int vp,
                          cudaStream_t stream);

}  // namespace stgcn
