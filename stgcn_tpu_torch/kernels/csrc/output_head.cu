// K3 and K4 of the STGCN output head ('TNFF'), forward: the C entry points.
// Both bodies are the gate GEMM (gate_gemm.cu, on the register tile of
// f32_tile.cuh), K3 with its LayerNorm-partial epilogue, K4 with its second
// product.
//
// Replaces the TPU kernels stgcn_tpu/kernels/output_head.py `_ohead_pallas`
// (:214, body `_make_ohead_fwd_kernel` :137 / `_ohead_core` :127) and
// `_ofc_pallas` (:407, body `_make_ofc_fwd_kernel` :335 / `_ofc_core` :327).
//
// K3: the final ST block's LayerNorm normalize -> a ko-tap temporal conv that
//     collapses time to one step -> gate with the in-gate residual -> the
//     head LayerNorm's partial sums over channels and true vertex lanes.
// K4: LayerNorm normalize + (V, C) affine -> fc1 -> ReLU -> fc2.
//
// What bounds K3 on the H100: at the STGCN widths (c_in 64, ko 4, gate
// width 256) it does about 80 float32 FMAs per byte it must move, so FMA
// issue, and in training the input mask's hash (integer work at half the
// FMA rate). Its weight [ko*c_in, 2*c0] (256 KB) does not fit a block's
// shared memory, so the gate GEMM stages it 16 rows at a time with the
// normalized, dropped-out input, 64 gate channels and their partners a pass:
// each input element is normalized and hashed once a pass (c0 128: twice),
// where the lane kernel it replaced (a thread a lane, 16 channels a block)
// did so eight times. The LayerNorm partials go out per (b, pass, 64-lane
// tile) and a second pass sums them in a fixed order: no atomics.
#include "common.cuh"

using namespace stgcn;

extern "C" {

// K3: a [B, 1, c0, Vp]; ps, pss: [B]; part: scratch of B * ceil(c0 / 64) *
// (Vp / 64) * 2 floats. The dropout site masks the normalized input
// (threshold 0 turns it off).
int stgcn_ohead_fwd(const float* x, const float* mu, const float* rstd, const float* lng,
                    const float* lnb, const float* ck, const float* cb, float* a, float* part,
                    float* ps, float* pss, int B, int ko, int c_in, int vp, int c0, int act,
                    int v_true, unsigned seed, int site, unsigned threshold, float scale,
                    void* stream) {
  const GateGemmArgs args{x, mu, rstd, lng, lnb, ck, cb, nullptr, nullptr, a,
                          B, ko, c_in, vp, ko, c0, 0, act, 1, 1,
                          make_drop(seed, site, threshold, scale, v_true),
                          make_drop(0, 0, 0, 1.0f, v_true), part, ps, pss, v_true};
  return launch_gate_gemm(args, static_cast<cudaStream_t>(stream));
}

// K4: out [B, 1, ce, Vp] (gate_gemm.cu: kt = 1, relu without residual).
// ce (fc2 outputs) must be at most 16. The dropout site masks the fc1 ->
// ReLU output (threshold 0 turns it off).
int stgcn_ofc_fwd(const float* a, const float* mu, const float* rstd, const float* lnw,
                  const float* lnb, const float* w1, const float* b1, const float* w2,
                  const float* b2, float* out, int B, int c0, int c1, int ce, int vp,
                  int v_true, unsigned seed, int site, unsigned threshold, float scale,
                  void* stream) {
  const GateGemmArgs args{a, mu, rstd, lnw, lnb, w1, b1, w2,    b2, out,
                          B, 1,  c0,   vp,  1,   c1, ce, kRelu, 1,  0,
                          make_drop(0, 0, 0, 1.0f, v_true),
                          make_drop(seed, site, threshold, scale, v_true)};
  return launch_gate_gemm(args, static_cast<cudaStream_t>(stream));
}

// The bf16 variants (the TPU kernels' precision="bfloat16" build): x, a,
// the LayerNorm affine (lng, lnb; lnw, lnb) and the weights ck, w1, w2 are
// bf16, K3's a is written in bf16; mu, rstd, the biases, the partials and
// K4's out stay float32. The dropout scale is rounded to bf16.
int stgcn_ohead_fwd_bf16(const void* x, const float* mu, const float* rstd, const void* lng,
                         const void* lnb, const void* ck, const float* cb, void* a, float* part,
                         float* ps, float* pss, int B, int ko, int c_in, int vp, int c0, int act,
                         int v_true, unsigned seed, int site, unsigned threshold, float scale,
                         void* stream) {
  const GateGemmArgs args{x, mu, rstd, lng, lnb, ck, cb, nullptr, nullptr, a,
                          B, ko, c_in, vp, ko, c0, 0, act, 1, 1,
                          make_drop(seed, site, threshold, scale, v_true),
                          make_drop(0, 0, 0, 1.0f, v_true), part, ps, pss, v_true};
  return launch_gate_gemm_bf16(args, false, static_cast<cudaStream_t>(stream));
}

int stgcn_ofc_fwd_bf16(const void* a, const float* mu, const float* rstd, const void* lnw,
                       const void* lnb, const void* w1, const float* b1, const void* w2,
                       const float* b2, float* out, int B, int c0, int c1, int ce, int vp,
                       int v_true, unsigned seed, int site, unsigned threshold, float scale,
                       void* stream) {
  const GateGemmArgs args{a, mu, rstd, lnw, lnb, w1, b1, w2,    b2, out,
                          B, 1,  c0,   vp,  1,   c1, ce, kRelu, 1,  0,
                          make_drop(0, 0, 0, 1.0f, v_true),
                          make_drop(seed, site, threshold, scale, v_true)};
  return launch_gate_gemm_bf16(args, true, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
