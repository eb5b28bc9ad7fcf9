// The gate GEMM: the body of K1 (block head) and K4 (output fc head).
//
// Both kernels are, per batch row b and output step t, a small matrix
// product followed by a pointwise gate and a second, narrow product:
//
//   s[g, v]  = sum_r W[r, g] * xn[r, v] + wb[g]     r = (k, c): kt taps x c_in
//   a[c, v]  = gate(s[c, v], s[c0 + c, v], xin[c, v])   c < c0
//   y[o, v]  = sum_c a[c, v] * ow[c, o] + ob[o]      o < n_out
//
// where xn is the input window, normalized with the previous LayerNorm's
// per-(b, t) statistics and (V, C) affine when apply_ln is set, then
// dropped out (drop_in: K1 in training); drop_out drops the gated a (K4's
// dropout after fc1 -> ReLU). Both masks are keyed by element (dropout.cuh).
//   K1 (stgcn_tpu/kernels/vertex_fused.py `_head_pallas` :610): W = the conv-1
//      taps [kt*c_in, 2*c0], gate GLU/GTU/relu/silu with the in-gate
//      residual xin = the window's last step, ow = the bottleneck align.
//   K4 (stgcn_tpu/kernels/output_head.py `_ofc_pallas` :407): kt = 1,
//      W = fc1 [c0, c1], gate = relu without residual, ow = fc2.
//
// What bounds it on the H100: at the STGCN widths the first product does
// 50-130 float32 FMAs per byte it must move, above the card's float32
// balance point (67 TFLOP/s over 3.35 TB/s, ~20 FLOP/byte), so it is bound
// by FMA issue. The design is a register-tiled SGEMM: a block of 128
// threads owns 64 gate channels (and their 64 gate partners) x 64 vertex
// lanes of one (b, t); each thread keeps a 4-channel x 8-lane tile of both
// halves in registers (64 sums), and per contraction row loads 4 float4
// from shared memory for 64 FMAs. Rows are staged 16 at a time (weights and
// the normalized input, LayerNorm applied once per staged value). The gated
// tile goes to shared memory and the narrow second product reads it there,
// so nothing but y is written to device memory. No tensor cores: the
// results are held to float32 accuracy.
#include "common.cuh"

namespace stgcn {

constexpr int kGemmLanes = 64;  // vertex lanes per block
constexpr int kGemmCols = 64;   // gate channels per pass (plus as many partners when gated)
constexpr int kGemmRows = 16;   // contraction rows staged per step
constexpr int kGemmThreads = 128;  // 16 channel groups x 8 lane groups

template <bool GATED>
__global__ void __launch_bounds__(kGemmThreads)
gate_gemm_kernel(const float* __restrict__ x, const float* __restrict__ mu,
                 const float* __restrict__ rstd, const float* __restrict__ lng,
                 const float* __restrict__ lnb, const float* __restrict__ w,
                 const float* __restrict__ wb, const float* __restrict__ ow,
                 const float* __restrict__ ob, float* __restrict__ y, int t_in, int c_in,
                 int vp, int kt, int c0, int n_out, int act, int apply_ln, int residual,
                 Drop drop_in, Drop drop_out) {
  constexpr int NC = GATED ? 2 * kGemmCols : kGemmCols;  // staged weight columns
  __shared__ float4 w_s[kGemmRows][NC / 4];
  __shared__ float4 x_s[kGemmRows][kGemmLanes / 4];
  __shared__ float4 a_s[kGemmCols][kGemmLanes / 4];
  __shared__ float ow_s[kGemmCols][kMaxOut];

  const int tid = threadIdx.x;
  const int cg = tid >> 3;  // channel group: channels 4*cg .. 4*cg+3 of the pass
  const int lg = tid & 7;   // lane group: lanes 4*lg .. +3 and 32 + 4*lg .. +3
  const int v0 = blockIdx.x * kGemmLanes, t = blockIdx.y, b = blockIdx.z;
  const int t_out = t_in - kt + 1;
  const int rows = kt * c_in;
  const int g = GATED ? 2 * c0 : c0;

  const uint32_t key_in = drop_key(drop_in.seed, drop_in.site);
  const uint32_t key_out = drop_key(drop_out.seed, drop_out.site);

  // normalized (and dropped) input at step tt, channel c, lane v
  auto xn = [&](int tt, int c, int v) {
    const size_t row = (size_t)(b * t_in + tt) * c_in + c;
    float val = x[row * vp + v];
    if (apply_ln)
      val = (val - mu[b * t_in + tt]) * rstd[b * t_in + tt] * lng[(size_t)c * vp + v] +
            lnb[(size_t)c * vp + v];
    if (drop_in.threshold) val *= drop_mask(drop_in, key_in, row, v);
    return val;
  };

  float out[8];  // output channel o = cg at the thread's 8 lanes
#pragma unroll
  for (int l = 0; l < 8; ++l) out[l] = cg < n_out ? ob[cg] : 0.0f;

  for (int s = 0; s < c0; s += kGemmCols) {
    float p[4][8], q[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = s + 4 * cg + i;
      const float bp = c < c0 ? wb[c] : 0.0f;
      const float bq = (GATED && c < c0) ? wb[c0 + c] : 0.0f;
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        p[i][l] = bp;
        q[i][l] = bq;
      }
    }
    for (int r0 = 0; r0 < rows; r0 += kGemmRows) {
      __syncthreads();  // the previous tile has been consumed
      float* wf = reinterpret_cast<float*>(w_s);
      for (int i = tid; i < kGemmRows * NC; i += kGemmThreads) {
        const int kk = i / NC, j = i % NC;
        const int r = r0 + kk, c = s + j % kGemmCols;
        const bool is_q = j >= kGemmCols;
        wf[i] = (r < rows && c < c0) ? w[(size_t)r * g + (is_q ? c0 + c : c)] : 0.0f;
      }
      float* xf = reinterpret_cast<float*>(x_s);
      for (int i = tid; i < kGemmRows * kGemmLanes; i += kGemmThreads) {
        const int kk = i / kGemmLanes, l = i % kGemmLanes;
        const int r = r0 + kk;
        xf[i] = r < rows ? xn(t + r / c_in, r % c_in, v0 + l) : 0.0f;
      }
      __syncthreads();
      const int n_rows = min(kGemmRows, rows - r0);  // staged rows past `rows` are zero
#pragma unroll 4
      for (int kk = 0; kk < n_rows; ++kk) {
        const float4 xa = x_s[kk][lg], xb = x_s[kk][lg + 8];
        const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
        const float4 wp4 = w_s[kk][cg];
        const float wp[4] = {wp4.x, wp4.y, wp4.z, wp4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int l = 0; l < 8; ++l) p[i][l] = fmaf(wp[i], xv[l], p[i][l]);
        if constexpr (GATED) {
          const float4 wq4 = w_s[kk][kGemmCols / 4 + cg];
          const float wq[4] = {wq4.x, wq4.y, wq4.z, wq4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int l = 0; l < 8; ++l) q[i][l] = fmaf(wq[i], xv[l], q[i][l]);
        }
      }
    }

    // gate (in-gate residual: the window's last step, channels zero-padded)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = s + 4 * cg + i;
      float a[8];
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        const int v = v0 + (l < 4 ? 4 * lg + l : 32 + 4 * lg + l - 4);
        const float xin = (residual && c < c_in) ? xn(t + kt - 1, c, v) : 0.0f;
        a[l] = c < c0 ? gate(act, p[i][l], q[i][l], xin) : 0.0f;
        if (drop_out.threshold && c < c0)
          a[l] *= drop_mask(drop_out, key_out, (size_t)(b * t_out + t) * c0 + c, v);
      }
      a_s[4 * cg + i][lg] = make_float4(a[0], a[1], a[2], a[3]);
      a_s[4 * cg + i][lg + 8] = make_float4(a[4], a[5], a[6], a[7]);
    }
    for (int i = tid; i < kGemmCols * kMaxOut; i += kGemmThreads) {
      const int c = i / kMaxOut, o = i % kMaxOut;
      ow_s[c][o] = (s + c < c0 && o < n_out) ? ow[(size_t)(s + c) * n_out + o] : 0.0f;
    }
    __syncthreads();

    // second product: thread (o = cg, its 8 lanes)
    for (int c = 0; c < kGemmCols; ++c) {
      const float4 aa = a_s[c][lg], ab = a_s[c][lg + 8];
      const float av[8] = {aa.x, aa.y, aa.z, aa.w, ab.x, ab.y, ab.z, ab.w};
      const float wv = ow_s[c][cg];
#pragma unroll
      for (int l = 0; l < 8; ++l) out[l] = fmaf(av[l], wv, out[l]);
    }
    __syncthreads();  // a_s and ow_s are rewritten by the next pass
  }

  if (cg < n_out) {
    float* yr = y + ((size_t)(b * t_out + t) * n_out + cg) * vp + v0;
    *reinterpret_cast<float4*>(yr + 4 * lg) = make_float4(out[0], out[1], out[2], out[3]);
    *reinterpret_cast<float4*>(yr + 32 + 4 * lg) = make_float4(out[4], out[5], out[6], out[7]);
  }
}

template <bool GATED>
cudaError_t gate_gemm_launch(const GateGemmArgs& a, cudaStream_t stream) {
  const dim3 grid(a.vp / kGemmLanes, a.t_in - a.kt + 1, a.batch);
  gate_gemm_kernel<GATED><<<grid, kGemmThreads, 0, stream>>>(
      a.x, a.mu, a.rstd, a.lng, a.lnb, a.w, a.wb, a.ow, a.ob, a.y, a.t_in, a.c_in, a.vp, a.kt,
      a.c0, a.n_out, a.act, a.apply_ln, a.residual, a.drop_in, a.drop_out);
  return cudaGetLastError();
}

cudaError_t launch_gate_gemm(const GateGemmArgs& a, cudaStream_t stream) {
  if (a.vp % kGemmLanes != 0 || a.n_out > kMaxOut || a.t_in < a.kt) return cudaErrorInvalidValue;
  return (a.act == kGlu || a.act == kGtu) ? gate_gemm_launch<true>(a, stream)
                                          : gate_gemm_launch<false>(a, stream);
}

}  // namespace stgcn
