// K3 and K4 of the STGCN output head ('TNFF'), forward: the C entry points,
// and K3's kernel. K4's body is the gate GEMM (gate_gemm.cu).
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
// width 256) it does about 80 float32 FMAs per byte it must move, so it is
// bound by FMA issue. Its weight [ko, c_in, 2*c0] is 256 KB at those widths,
// more than a block's 227 KB of shared memory, so each block takes one chunk
// of 16 gate channels (grid axis y) and stages only that slice (32 KB); a
// thread per vertex lane keeps the chunk's 32 sums in registers. Its
// LayerNorm partials go out per (b, chunk, vertex tile) and a second pass
// sums them in index order, as K2's do.
#include "common.cuh"

namespace stgcn {

// grid (Vp / kLanes, nch, B); x [B, ko, c_in, Vp] -> a [B, 1, c0, Vp],
// part [B, nch, nvt, 2].
__global__ void __launch_bounds__(kLanes)
ohead_fwd_kernel(const float* __restrict__ x, const float* __restrict__ mu,
                 const float* __restrict__ rstd, const float* __restrict__ lng,
                 const float* __restrict__ lnb, const float* __restrict__ ck,
                 const float* __restrict__ cb, float* __restrict__ a, float* __restrict__ part,
                 int ko, int c_in, int vp, int c0, int act, int v_true, Drop drop) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const bool gated = act == kGlu || act == kGtu;
  const int rows = ko * c_in;
  const int j = blockIdx.y;
  float* w_s = smem;                    // [rows][2 * kChunk] this block's chunk
  float* b_s = w_s + rows * 2 * kChunk;  // [2 * kChunk]
  float* red = b_s + 2 * kChunk;         // [kLanes / 32]
  stage_gate_weight(w_s, b_s, ck, cb, rows, c0, gated, j, 1);
  __syncthreads();

  const int v = blockIdx.x * kLanes + threadIdx.x;
  const int b = blockIdx.z;
  const float* xb = x + (size_t)b * ko * c_in * vp + v;
  const uint32_t key = drop_key(drop.seed, drop.site);
  auto load = [&](int t, int c) {
    const float xv = xb[((size_t)t * c_in + c) * vp];
    float y = (xv - mu[b * ko + t]) * rstd[b * ko + t] * lng[(size_t)c * vp + v] +
              lnb[(size_t)c * vp + v];
    if (drop.threshold) y *= drop_mask(drop, key, ((size_t)b * ko + t) * c_in + c, v);
    return y;
  };

  float p[kChunk], q[kChunk];
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    p[i] = b_s[i];
    q[i] = b_s[kChunk + i];
  }
  for (int t = 0; t < ko; ++t)
    for (int c = 0; c < c_in; ++c) fma_chunk(p, q, load(t, c), w_s + (t * c_in + c) * 2 * kChunk);

  const bool live = v < v_true;
  float s = 0.0f, ss = 0.0f;
  float* yb = a + (size_t)b * c0 * vp + v;
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    const int c = j * kChunk + i;
    if (c < c0) {
      const float xin = c < c_in ? load(ko - 1, c) : 0.0f;  // channels zero-padded to c0
      const float av = gate(act, p[i], q[i], xin);
      yb[(size_t)c * vp] = av;
      if (live) {
        s += av;
        ss += av * av;
      }
    }
  }
  s = block_sum(s, red);
  ss = block_sum(ss, red);
  if (threadIdx.x == 0) {
    const size_t idx = (((size_t)b * gridDim.y + j) * gridDim.x + blockIdx.x) * 2;
    part[idx] = s;
    part[idx + 1] = ss;
  }
}

}  // namespace stgcn

using namespace stgcn;

extern "C" {

// part: scratch [B, ceil(c0 / 16), Vp / 128, 2]; ps, pss: [B]. The dropout
// site masks the normalized input (threshold 0 turns it off).
int stgcn_ohead_fwd(const float* x, const float* mu, const float* rstd, const float* lng,
                    const float* lnb, const float* ck, const float* cb, float* a, float* part,
                    float* ps, float* pss, int B, int ko, int c_in, int vp, int c0, int act,
                    int v_true, unsigned seed, int site, unsigned threshold, float scale,
                    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * ((size_t)ko * c_in * 2 * kChunk + 2 * kChunk + kLanes / 32);
  cudaError_t err = set_smem(ohead_fwd_kernel, smem);
  if (err != cudaSuccess) return err;
  const int nch = (c0 + kChunk - 1) / kChunk;
  const dim3 grid(vp / kLanes, nch, B);
  ohead_fwd_kernel<<<grid, kLanes, smem, s>>>(x, mu, rstd, lng, lnb, ck, cb, a, part, ko, c_in,
                                             vp, c0, act, v_true,
                                             make_drop(seed, site, threshold, scale, v_true));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce_partials(part, ps, pss, B, nch * (vp / kLanes), s);
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

}  // extern "C"
