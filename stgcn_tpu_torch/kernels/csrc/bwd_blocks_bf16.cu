// The bf16 backward building blocks (bwd_blocks.cuh's bf16 overloads): the
// bodies of K1b-K4b's bf16 variants, the TPU kernels `_head_pallas_bwd`
// (stgcn_tpu/kernels/vertex_fused.py:654), `_tail_pallas_bwd` (:883),
// `_ohead_pallas_bwd` (output_head.py:253) and `_ofc_pallas_bwd` (:440) with
// precision="bfloat16". The passes are bwd_blocks_impl.cuh's, instantiated
// on bf16 here, apart from the float32 ones (bwd_blocks.cu), so that the two
// compile in parallel.
//
// The one structural change is the data gradient: the TPU rounds each tap's
// dot to bf16 and adds the taps in bf16, k = 0 .. kt-1, then the residual's
// gradient, where the float32 kernels sum every tap in one chain. The tile
// (gate_dx_bf16_kernel, and tail_dr_kernel<bf16>) walks one tap at a time
// and folds each rounded tap into a running bf16 sum: in shared memory here
// (the thread's 64 sums as 16-bit patterns, 16 KB a block beside the 25 KB
// of staging; in registers they would push the 168-register tile into
// spills), in registers in tail_dr's 32-sum tile. The lane kernel for a narrow input
// (K1b block 1) walks the steps of ds once, as the float32 one does, but a
// step's taps reach their output steps before the taps that must be added
// first: it keeps each tap's rounded value until its output step's tap 0
// arrives, kt (kt - 1) / 2 values a channel and lane.
//
// What bounds them on the H100: as the float32 kernels, the float32 FMA rate
// for the products (the bf16 operands are widened into the same float32
// tile) and bytes for the elementwise passes, at half the activation bytes.
#include "bwd_blocks_impl.cuh"

namespace stgcn {

namespace {

// grid (t_in, Vp / BN, B), t fastest: dx as gate_dx_kernel (bwd_blocks.cu)
// on bf16, each tap's sum rounded and the taps added in bf16 in ascending
// order (dx_taps_bf16), then (RES) the residual's gradient a bf16 add.
template <class C, bool RES>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks)
gate_dx_bf16_kernel(const bf16* __restrict__ ds, const bf16* __restrict__ w,
                    bf16* __restrict__ dx, int t_in, int c_in, int vp, int kt, int g_n) {
  __shared__ __align__(16) f32tile::Smem<C> sm;
  // each thread's running tap sums, bf16 values kept as their 16 high bits
  __shared__ unsigned short sum_s[C::TM * C::TN][C::kThreads];
  const int t = blockIdx.x, v0 = blockIdx.y * C::BN, b = blockIdx.z;
  const int t_out = t_in - kt + 1;
  const int k_lo = t - t_out + 1 > 0 ? t - t_out + 1 : 0, k_hi = t < kt - 1 ? t : kt - 1;
  const int ta = t - (kt - 1);   // the residual's step in ds
  const f32tile::Pos<C> pos;
  for (int o0 = 0; o0 < c_in; o0 += C::BM) {
    dx_taps_bf16<C>(sm, pos, ds, w, b, t, o0, v0, c_in, vp, t_out, g_n, k_lo, k_hi,
                    [&](int i, int j, float tap, bool first) {
                      unsigned short& s = sum_s[i * C::TN + j][threadIdx.x];
                      const float prev = __uint_as_float((unsigned)s << 16);
                      const float sum = first ? tap : bf16r(prev + tap);
                      s = (unsigned short)(__float_as_uint(sum) >> 16);
                    });
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
      const int o = o0 + pos.row(i);
      if (o >= c_in) continue;
      bf16* yr = dx + ((size_t)(b * t_in + t) * c_in + o) * vp + v0;
      const bf16* ar = RES && ta >= 0 && ta < t_out
                           ? ds + ((size_t)(b * t_out + ta) * g_n + o) * vp + v0
                           : nullptr;
#pragma unroll
      for (int j = 0; j < C::TN; j += 4) {
        const int l = pos.col(j);
        float y[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          y[u] = __uint_as_float((unsigned)sum_s[i * C::TN + j + u][threadIdx.x] << 16);
        if (ar) {
          float add[4];
          ld4w(add, ar + l);
#pragma unroll
          for (int u = 0; u < 4; ++u) y[u] += add[u];   // rounded by st4
        }
        st4(yr + l, y);
      }
    }
  }
}

// grid (ceil(Vp / (4 kDxThreads)), B, chunks), dynamic shared memory
// G * KT * c_in floats (the weights as [g][k][o]): the lane kernel of
// gate_dx_lanes_kernel (bwd_blocks.cu) on bf16. At ds step tp, tap k's sum
// over g, c[k] (rounded), belongs to output step tp + k; output step tp is
// complete once c[0] is in: its sum is c[0] + the taps 1 .. KT-1 kept from
// the steps before, added in bf16 in that order, then (res) the residual's
// gradient. pend[(j, k)], j < k: tap k's rounded value for output step
// tp + j, taken at ds step tp + j - k.
template <int KT>
__global__ void __launch_bounds__(kDxThreads)
gate_dx_lanes_bf16_kernel(const bf16* __restrict__ ds, const bf16* __restrict__ w,
                          bf16* __restrict__ dx, int t_in, int c_in, int vp, int g_n,
                          int t_chunk, int res) {
  extern __shared__ float4 dx16_smem4[];
  float* w_s = reinterpret_cast<float*>(dx16_smem4);
  constexpr int kPend = KT * (KT - 1) / 2 > 0 ? KT * (KT - 1) / 2 : 1;
  // the slot of (j, k), j < k < KT: rows j' < j hold KT - 1 - j' slots each
  auto slot = [](int j, int k) { return j * (2 * KT - j - 1) / 2 + (k - j - 1); };
  const int n = KT * c_in;
  for (int i = threadIdx.x; i < g_n * n; i += kDxThreads) {
    const int g = i / n, r = i % n, k = r / c_in, o = r % c_in;
    w_s[i] = widen(w[((size_t)k * c_in + o) * g_n + g]);
  }
  __syncthreads();
  const int v = (blockIdx.x * kDxThreads + threadIdx.x) * 4, b = blockIdx.y;
  if (v >= vp) return;
  const int t_out = t_in - KT + 1;
  float4 pend[kPend][kDxNarrow];
#pragma unroll
  for (int q = 0; q < kPend; ++q)
#pragma unroll
    for (int o = 0; o < kDxNarrow; ++o) pend[q][o] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int t0 = blockIdx.z * t_chunk, t_end = t0 + t_chunk < t_in ? t0 + t_chunk : t_in;
  for (int tp = t0 - (KT - 1) > 0 ? t0 - (KT - 1) : 0; tp < t_end; ++tp) {
    float4 c[KT][kDxNarrow];   // this step's taps
#pragma unroll
    for (int k = 0; k < KT; ++k)
#pragma unroll
      for (int o = 0; o < kDxNarrow; ++o) c[k][o] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (tp < t_out) {
      const bf16* xs = ds + (size_t)(b * t_out + tp) * g_n * vp + v;
#pragma unroll 4
      for (int g = 0; g < g_n; ++g) {
        const float4 xq = Lanes4<bf16>::widen(Lanes4<bf16>::load(xs + (size_t)g * vp));
        const float* wg = w_s + g * n;
#pragma unroll
        for (int k = 0; k < KT; ++k)
#pragma unroll
          for (int o = 0; o < kDxNarrow; ++o) {
            if (o >= c_in) break;
            const float wk = wg[k * c_in + o];
            c[k][o].x = fmaf(xq.x, wk, c[k][o].x);
            c[k][o].y = fmaf(xq.y, wk, c[k][o].y);
            c[k][o].z = fmaf(xq.z, wk, c[k][o].z);
            c[k][o].w = fmaf(xq.w, wk, c[k][o].w);
          }
      }
#pragma unroll
      for (int k = 0; k < KT; ++k)
#pragma unroll
        for (int o = 0; o < kDxNarrow; ++o)
          c[k][o] = make_float4(bf16r(c[k][o].x), bf16r(c[k][o].y), bf16r(c[k][o].z),
                                bf16r(c[k][o].w));
    }
    const int ta = tp - (KT - 1);   // the residual's step in ds
#pragma unroll
    for (int o = 0; o < kDxNarrow; ++o) {
      if (o >= c_in || tp < t0) break;
      float y[4] = {c[0][o].x, c[0][o].y, c[0][o].z, c[0][o].w};
#pragma unroll
      for (int k = 1; k < KT; ++k) {
        const float4 p = pend[slot(0, k)][o];
        y[0] = bf16r(y[0] + p.x);
        y[1] = bf16r(y[1] + p.y);
        y[2] = bf16r(y[2] + p.z);
        y[3] = bf16r(y[3] + p.w);
      }
      if (res && ta >= 0 && ta < t_out) {
        float r[4];
        ld4w(r, ds + ((size_t)(b * t_out + ta) * g_n + o) * vp + v);
#pragma unroll
        for (int u = 0; u < 4; ++u) y[u] += r[u];   // rounded by st4
      }
      st4(dx + ((size_t)(b * t_in + tp) * c_in + o) * vp + v, y);
    }
    // output step tp + 1 + j' takes this step's tap j' + 1 and keeps the rest
#pragma unroll
    for (int j = 0; j + 1 < KT; ++j)
#pragma unroll
      for (int k = j + 1; k < KT; ++k)
#pragma unroll
        for (int o = 0; o < kDxNarrow; ++o)
          pend[slot(j, k)][o] = k == j + 1 ? c[k][o] : pend[slot(j + 1, k)][o];
  }
}

template <int KT>
cudaError_t gate_dx_lanes_bf16(const bf16* ds, const bf16* w, bf16* dx, int batch, int t_in,
                               int c_in, int vp, int g, bool residual, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)g * KT * c_in;
  STGCN_TRY(set_smem(gate_dx_lanes_bf16_kernel<KT>, smem));
  const int t_chunk = dx_lanes_chunk(batch, t_in, vp);
  gate_dx_lanes_bf16_kernel<KT><<<dim3((vp + 4 * kDxThreads - 1) / (4 * kDxThreads), batch,
                                       (t_in + t_chunk - 1) / t_chunk),
                                  kDxThreads, smem, stream>>>(ds, w, dx, t_in, c_in, vp, g,
                                                              t_chunk, residual ? 1 : 0);
  return cudaGetLastError();
}

__global__ void to_bf16_kernel(const float* __restrict__ x, bf16* __restrict__ y, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    y[i] = __float2bfloat16_rn(x[i]);
}

}  // namespace

cudaError_t launch_ln_drop(const bf16* x, const float* mu, const float* rstd, const bf16* lng,
                           const bf16* lnb, Drop drop, bf16* y, int batch, int t, int c, int vp,
                           cudaStream_t stream) {
  return ln_drop_run<bf16>(x, mu, rstd, lng, lnb, drop, y, batch, t, c, vp, stream);
}

cudaError_t launch_wgrad_bias(CvT<bf16> x, int k, CvT<bf16> d, float* out, float* bias,
                              float* part, int batch, int vp, cudaStream_t stream) {
  return wgrad_bias_run<bf16>(x, k, d, out, bias, part, batch, vp, stream);
}

cudaError_t launch_wgrad(CvT<bf16> x, int k, CvT<bf16> d, float* out, float* part, int batch,
                         int vp, cudaStream_t stream) {
  return wgrad_run<bf16>(x, k, d, out, part, batch, vp, stream);
}

cudaError_t launch_ln_bwd(const bf16* x, const float* mu, const float* rstd, const bf16* lng,
                          Drop drop, const bf16* dy, bf16* dx, float* dmu, float* drstd,
                          bf16* dlng, bf16* dlnb, float* part, int batch, int t, int c, int vp,
                          cudaStream_t stream) {
  STGCN_TRY(ln_bwd_stats_run<bf16>(x, mu, rstd, lng, drop, dy, dx, dmu, drstd, part, batch, t, c,
                                   vp, stream));
  ln_bwd_affine_kernel<bf16><<<(c * vp + 255) / 256, 256, 0, stream>>>(
      x, mu, rstd, drop, dy, dlng, dlnb, batch * t, c, vp);
  return cudaGetLastError();
}

cudaError_t launch_gate_pass(const bf16* x, const bf16* w, const float* bias, GateUpT<bf16> up,
                             bf16* ds, bf16* a_out, int batch, int t_in, int c_in, int vp,
                             int kt, int c0, int act, cudaStream_t stream) {
  return gate_pass_run<bf16>(x, w, bias, up, ds, a_out, batch, t_in, c_in, vp, kt, c0, act,
                             stream);
}

cudaError_t launch_gate_dx(const bf16* ds, const bf16* w, bf16* dx, int batch, int t_in,
                           int c_in, int vp, int kt, int g, cudaStream_t stream, bool residual) {
  if (vp % DxWide::BN != 0 || t_in < kt || kt < 1) return cudaErrorInvalidValue;
  if (c_in <= kDxNarrow && kt <= kDxTaps) {
    switch (kt) {
      case 1: return gate_dx_lanes_bf16<1>(ds, w, dx, batch, t_in, c_in, vp, g, residual, stream);
      case 2: return gate_dx_lanes_bf16<2>(ds, w, dx, batch, t_in, c_in, vp, g, residual, stream);
      case 3: return gate_dx_lanes_bf16<3>(ds, w, dx, batch, t_in, c_in, vp, g, residual, stream);
      default:
        return gate_dx_lanes_bf16<4>(ds, w, dx, batch, t_in, c_in, vp, g, residual, stream);
    }
  }
  auto tile = residual ? gate_dx_bf16_kernel<DxWide, true> : gate_dx_bf16_kernel<DxWide, false>;
  tile<<<dim3(t_in, vp / DxWide::BN, batch), DxWide::kThreads, 0, stream>>>(ds, w, dx, t_in, c_in,
                                                                           vp, kt, g);
  return cudaGetLastError();
}

cudaError_t launch_fc_pass(const bf16* h, const bf16* w1, const float* b1, const bf16* gout,
                           const bf16* w2, Drop drop, bf16* ds2, float* dw2, float* db1,
                           float* part, int batch, int c_in, int vp, int c1, int ce,
                           cudaStream_t stream) {
  return fc_pass_run<bf16>(h, w1, b1, gout, w2, drop, ds2, dw2, db1, part, batch, c_in, vp, c1,
                           ce, stream);
}

cudaError_t launch_tail_dr(const bf16* ds2, const bf16* c2k, const bf16* h, const bf16* gcw,
                           bf16* dr, bf16* dxg, bf16* dt_a, bf16* dt_b, int batch, int t1,
                           int c1, int vp, int kt, int g2, int n_terms, int cheb,
                           cudaStream_t stream) {
  return tail_dr_run<bf16>(ds2, c2k, h, gcw, dr, dxg, dt_a, dt_b, batch, t1, c1, vp, kt, g2,
                           n_terms, cheb, stream);
}

cudaError_t launch_to_bf16(const float* x, bf16* y, size_t n, cudaStream_t stream) {
  to_bf16_kernel<<<ew_blocks(n), kEwThreads, 0, stream>>>(x, y, n);
  return cudaGetLastError();
}

}  // namespace stgcn
