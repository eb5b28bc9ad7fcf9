// The bf16 variant of the gate GEMM (gate_gemm.cuh): bf16 operands, float32
// sums, the TPU's bf16 rounding points; the body of K1f, K3f and K4f's bf16
// variants and of K2f's conv 2 (stgcn_tpu/kernels/vertex_fused.py
// `_head_pallas` :610 and `_tail_pallas` :839, output_head.py
// `_ohead_pallas` :214 and `_ofc_pallas` :407, each with precision=
// "bfloat16"). Instantiated here, apart from the float32 kernels
// (gate_gemm.cu), so that the two compile in parallel.
#include "gate_gemm.cuh"

namespace stgcn {

// y_f32: y is float32 (K4: the TPU keeps its output in float32); only with
// the second product and the relu gate. The dropout scales are rounded to
// bf16, as the TPU's bf16 mask stores them.
cudaError_t launch_gate_gemm_bf16(const GateGemmArgs& args, bool y_f32, cudaStream_t stream) {
  bool one;
  const bool ln = args.part != nullptr;
  if (!gate_gemm_args_ok(args, &one) || (y_f32 && (ln || args.act != kRelu)))
    return cudaErrorInvalidValue;
  GateGemmArgs a = args;
  a.drop_in.scale = bf16r(a.drop_in.scale);
  a.drop_out.scale = bf16r(a.drop_out.scale);
  if (ln)
    return one ? gate_gemm_act<bf16, bf16, true, true>(a, stream)
               : gate_gemm_act<bf16, bf16, false, true>(a, stream);
  if (y_f32)
    return one ? gate_gemm_launch<bf16, float, kRelu, true, false>(a, stream)
               : gate_gemm_launch<bf16, float, kRelu, false, false>(a, stream);
  return one ? gate_gemm_act<bf16, bf16, true, false>(a, stream)
             : gate_gemm_act<bf16, bf16, false, false>(a, stream);
}

}  // namespace stgcn
