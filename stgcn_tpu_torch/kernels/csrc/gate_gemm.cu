// The gate GEMM: the body of K1 (block head), K3 (output-head conv) and K4
// (output fc head), K2's (block tail) conv 2, and K12's (dense whole block,
// fused_stblock.cu) head and conv 2.
//
// Each is, per batch row b and output step t, a small matrix product
// followed by a pointwise gate and an epilogue:
//
//   s[g, v]  = sum_r W[r, g] * xn[r, v] + wb[g]     r = (k, c): kt taps x c_in
//   a[c, v]  = gate(s[c, v], s[c0 + c, v], xin[c, v])   c < c0
//   y[o, v]  = sum_c a[c, v] * ow[c, o] + ob[o]      o < n_out   (K1, K4)
//   y = a, and ps, pss = sum, sum of squares of a over c and v < v_true (K2, K3)
//
// where xn is the input window, normalized with the previous LayerNorm's
// per-(b, t) statistics and (V, C) affine when apply_ln is set, then
// dropped out (drop_in: K1 and K3 in training); drop_out drops the gated a
// (K4's dropout after fc1 -> ReLU). Both masks are keyed by element
// (dropout.cuh).
//   K1 (stgcn_tpu/kernels/vertex_fused.py `_head_pallas` :610): W = the conv-1
//      taps [kt*c_in, 2*c0], gate GLU/GTU/relu/silu with the in-gate
//      residual xin = the window's last step, ow = the bottleneck align.
//   K3 (stgcn_tpu/kernels/output_head.py `_ohead_pallas` :214): kt = t_in =
//      ko (one output step), W = the head conv [ko*c_in, 2*c0], the in-gate
//      residual as K1's; the LayerNorm-partial epilogue.
//   K4 (stgcn_tpu/kernels/output_head.py `_ofc_pallas` :407): kt = 1,
//      W = fc1 [c0, c1], gate = relu without residual, ow = fc2.
//   K2 (stgcn_tpu/kernels/vertex_fused.py `_tail_pallas` :839): x = h, formed
//      once by tail_h_kernel (vertex_fused.cu), kt*c1 rows, W = conv 2's taps,
//      the in-gate residual h's newest step; the LayerNorm-partial epilogue.
//   K12 (stgcn_tpu/kernels/fused_stblock.py `_fwd_pallas` :590): its head as
//      K1 without the LayerNorm, its conv 2 and gate 2 as K2's (the
//      partials unused: K12's statistics take two passes over a2).
//
// What bounds it on the H100: at the STGCN widths the first product does
// 50-130 float32 FMAs per byte it must move, above the card's float32
// balance point (67 TFLOP/s over 3.35 TB/s, ~20 FLOP/byte), so it is bound
// by FMA issue, and in training by the input mask's hash (integer ops at
// half the FMA rate, one hash per staged element: each input step is staged
// by the kt blocks whose window holds it, and once a pass); K1 on the first
// block (3 contraction rows) is bound by its gate and its second product.
//
// Design: the first product runs on the register tile of f32_tile.cuh, as
// the backward gate pass (bwd_blocks.cu) does. A block of 128 threads owns
// 64 vertex lanes of one (b, t) and 128 tile rows: gated, 64 gate channels
// (p) and their 64 partners (q); plain, 128 channels; 8 x 8 sums a thread.
// The grid runs (t, b) fastest, so the blocks that read one input step and
// one lane tile of the LayerNorm affine run together. Rows are staged 16 at
// a time, two buffers deep: the load step reads x as float4 lane slots
// (with apply_ln also the step's statistics and the float4 affine), the
// store step normalizes, drops out and writes them into shared memory, so
// the global loads of the next piece overlap the FMAs of this one; the last
// tap's rows are also stashed as the in-gate residual. The epilogue (a
// template parameter, as the gate is) either applies the gate and K4's
// output mask, writes the gated tile over the stashed residual, and every
// thread takes two outputs at 4 lanes of the narrow second product; or
// (K2, K3) writes the gated tile to y and sums it over the true lanes, one
// partial per (b, t, pass, lane tile), which launch_reduce_partials sums in
// a fixed order. Where c0 is wider than the tile, the block loops over
// passes (the second product carries its sums in y); with the LayerNorm-
// partial epilogue the passes are a grid axis, so that PeMSD7(M)'s batch
// still fills the card. Only y (and the partials) reach device memory.
//
// Arithmetic: full float32 fmaf, no TF32, no atomics. Every sum keeps the
// chain of the lane kernels this one replaced (a thread a lane): the bias,
// then rows (k, c) ascending; the gate as gate() (common.cuh); ob, then c
// ascending. So y is bit-identical to theirs, and a repeat launch is
// bit-identical; K2's and K3's partial sums run in another order than the
// lane kernels' (within the kernel tolerance of their plain versions).
//
// The kernel is a template on the operand and output types (gate_gemm.cuh);
// this file instantiates its float32 kernels, gate_gemm_bf16.cu its bf16
// ones (the TPU kernels' precision="bfloat16" build).
#include "gate_gemm.cuh"

namespace stgcn {

cudaError_t launch_gate_gemm(const GateGemmArgs& a, cudaStream_t stream) {
  bool one;
  if (!gate_gemm_args_ok(a, &one)) return cudaErrorInvalidValue;
  if (a.part != nullptr)
    return one ? gate_gemm_act<float, float, true, true>(a, stream)
               : gate_gemm_act<float, float, false, true>(a, stream);
  return one ? gate_gemm_act<float, float, true, false>(a, stream)
             : gate_gemm_act<float, float, false, false>(a, stream);
}

}  // namespace stgcn
