// K12, one whole ST block on a dense GSO: what the forward entry point
// (fused_stblock.cu) and the backward one (fused_stblock_bwd.cu) share.
//
// The entry points take the model's channels-last operands, [B, T, V, C]
// float32 with the true vertex count V, and turn them into the cv layout
// [B, T, C, Vp] (Vp = V rounded up to kLanes, zero past V) of the building
// blocks in bwd_blocks.cuh, tail_h_kernel of vertex_fused.cu and the gate
// GEMM of gate_gemm.cu. Every intermediate of the block lives in a
// workspace in device memory.
#pragma once

#include "bwd_blocks.cuh"

namespace stgcn {

// The sizes of one ST block and what follows from them.
struct StDims {
  int B, t_in, V, c_in, kt, ks, c0, c1, c2, act, graph_conv;
  int vp, t1, t2, g1, g2;
  int n_w;       // terms of the graph-conv weight contraction: ks, or 1 (graph_conv)
  int n_prod;    // graph-product outputs kept: T_1 .. T_{ks-1}, or G.xg (graph_conv)
  size_t lane;   // B * vp
};
StDims st_dims(int B, int t_in, int V, int c_in, int kt, int ks, int c0, int c1, int c2,
               int act, int graph_conv);
bool st_dims_valid(const StDims& d);

// The block's weights in the kernels' layouts (kernels/fused_stblock.py,
// block_weights): c1k [kt, c_in, g1], c1b [g1], gaw [c0, c1], gab [c1],
// gcw [n_w, c1, c1], gcb [c1], c2k [kt, c1, g2], c2b [g2], lng/lnb [V, c2].
struct StWeights {
  const float *c1k, *c1b, *gaw, *gab, *gcw, *gcb, *c2k, *c2b, *lng, *lnb;
};

// The forward's intermediates, cv layout.
struct StFwdBufs {
  float* x_cv;            // [B, t_in, c_in, vp] the block input
  float* xg;              // [B, t1, c1, vp] the graph operand, T_0
  float* prod;            // n_prod x [B, t1, c1, vp]: T_1 .. T_{ks-1}, or G.xg
  float* h;               // [B, t1, c1, vp] relu(sum_k T_k W_k + gcb + xg)
  float* a2;              // [B, t2, c2, vp] gate 2, the LayerNorm input
  float *mu, *rstd;       // [B * t2] LayerNorm statistics over (c < c2, v < V)
  // the k-th operand of the weight contraction
  const float* term(const StDims& d, int k) const {
    if (d.graph_conv) return prod;
    return k == 0 ? xg : prod + (size_t)(k - 1) * d.lane * d.t1 * d.c1;
  }
};
StFwdBufs carve_fwd(Carver& w, const StDims& d);

// Floats of the scratch st_forward needs besides f: the GSO padded to
// [vp, vp] (first, 16-byte aligned), then the conv-2 gate GEMM's LayerNorm
// partials and their sums. K12f carves it; K12b lends it a buffer that it
// writes only after its adjoint chain, which reads the padded GSO.
size_t st_scratch_floats(const StDims& d);

// The forward up to the LayerNorm statistics, into f: the input's layout,
// the GSO padded into the start of scratch (left there for the caller),
// the head (conv 1, gate, align), the graph chain, the weight contraction
// with residual and ReLU, conv 2 and gate 2, mu and rstd. K12b runs the
// same launches, so its recompute equals K12f's forward bit for bit.
cudaError_t st_forward(const StDims& d, const float* x, const float* gso, const StWeights& w,
                       const StFwdBufs& f, float* scratch, cudaStream_t s);

// The dense graph product of the Chebyshev chain and its adjoint, on cv rows:
// out[r, u] = alpha * sum_{v < V} x[r, v] * G(u, v) + beta * y[r, u] for
// r < rows, u < vp, with G(u, v) = gp[u * vp + v], or gp[v * vp + u] when
// transpose (the adjoint's Gᵀ read in place); gp is the GSO padded to
// [vp, vp], zero past V (launch_pad_gso); y may be null or out itself, x
// neither; vp a multiple of 128. On the register tile (fused_stblock.cu).
cudaError_t launch_graph_mm(const float* x, const float* gp, const float* y, float* out,
                            float alpha, float beta, long long rows, int vp, int V,
                            int transpose, cudaStream_t s);
// gp [vp, vp] = the GSO g [V, V], zero past V.
cudaError_t launch_pad_gso(const float* g, float* gp, int V, int vp, cudaStream_t s);

// Layout changes over n matrices: nm [n, V, C] <-> cv [n, C, vp] (cv zero past V).
cudaError_t launch_nm_to_cv(const float* src, float* dst, int n, int V, int C, int vp,
                            cudaStream_t s);
cudaError_t launch_cv_to_nm(const float* src, float* dst, int n, int V, int C, int vp,
                            cudaStream_t s);

}  // namespace stgcn
