// Building blocks of the backward kernels K1b-K4b and K12b (see bwd_blocks.cuh).
//
// The TPU backward kernels (`_head_pallas_bwd`, `_tail_pallas_bwd`,
// `_ohead_pallas_bwd`, `_ofc_pallas_bwd`) recompute their forward per tile
// and accumulate weight gradients in output blocks that stay resident
// across a sequential grid. CUDA blocks run in no order, so here each
// backward is a short pipeline of launches on one stream, and every
// reduction over (batch, time, vertex) is done by a block that owns its
// outputs (weight gradients: partials per slice of the reduction on the
// register tile of f32_tile.cuh, then a fixed-order sum; LayerNorm
// statistics one block per (b, t); the (V, C) affine gradients one thread
// per (c, v)). No float atomics.
//
// K1b-K4b and K12b recompute their gated conv (K4b: fc1), run its gate
// backward and take its data gradient in fused passes (gate_pass_kernel,
// gate_dx_kernel, K2b's and K12b's tail_dr_kernel below) on the tile that
// also carries the forward gate GEMM of K1f-K4f (gate_gemm.cu), so the
// pre-activations never reach device memory.
//
// What bounds them on the H100: the channel contractions and the weight
// gradients are float32 FMA issue, the elementwise passes are bytes.
//
// The kernels shared with the bf16 variants (bwd_blocks_bf16.cu) are
// templates on the operand type in bwd_blocks_impl.cuh; this file
// instantiates their float32 launchers and holds the float32-only kernels
// (the data gradient's tile and lane kernels, K12b's sliced affine
// gradients and later graph terms).
#include "bwd_blocks_impl.cuh"

namespace stgcn {

namespace {

// grid (ceil(c * vp / 256), slices), block 256: the affine gradients of
// ln_bwd_affine_kernel over the rows [slice * len, slice * len + len) of
// (b, t), one thread per (c, v), into part[slice] = [dlng | dlnb] (c * vp
// floats each); sum_slices_kernel adds the slices in order. For many (b, t)
// rows over few (c, v): K12b's 4096 rows at PEMS-BAY batch 512, where one
// thread a (c, v) walking every row left 96 blocks on 132 SMs.
__global__ void ln_bwd_affine_part_kernel(const float* __restrict__ x,
                                          const float* __restrict__ mu,
                                          const float* __restrict__ rstd, Drop drop,
                                          const float* __restrict__ dy, float* __restrict__ part,
                                          int bt_total, int c, int vp, int len) {
  const int n = c * vp, i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t key = drop_key(drop.seed, drop.site);
  const int ch = i / vp, v = i % vp;
  const int bt0 = blockIdx.y * len, bt1 = bt0 + len < bt_total ? bt0 + len : bt_total;
  float sg = 0.0f, sb = 0.0f;
  for (int bt = bt0; bt < bt1; ++bt) {
    const size_t row = (size_t)bt * c + ch, idx = row * vp + v;
    float g = dy[idx];
    if (drop.threshold) g *= drop_mask(drop, key, row, v);
    sg += g * ((x[idx] - mu[bt]) * rstd[bt]);
    sb += g;
  }
  float* out = part + (size_t)blockIdx.y * 2 * n;
  out[i] = sg;
  out[n + i] = sb;
}

// The row slices of ln_bwd_affine_part_kernel: enough blocks for four waves
// of 8 blocks a SM's threads (about 1M), slices of at least 16 rows.
int ln_affine_slices(int bt_total, int c, int vp) {
  const long long cols = (long long)c * vp;
  long long s = ((1LL << 20) + cols - 1) / cols;
  const long long most = (bt_total + 15) / 16;
  s = s < most ? s : most;
  return (int)(s > 1 ? s : 1);
}

// grid (t_in, Vp / BN, B), t fastest so the kt output steps that read one
// step of ds run together:
//   dx[b, t, o, :] = sum over taps k with 0 <= t - k < t_out, then g < G, of
//                    ds[b, t - k, g, :] w[k, o, g]  + ds[b, t - kt + 1, o, :]
// (the last term the residual's gradient dxin, where that step exists; none
// without RES).
template <class C, bool RES = true>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks)
gate_dx_kernel(const float* __restrict__ ds, const float* __restrict__ w,
               float* __restrict__ dx, int t_in, int c_in, int vp, int kt, int g_n) {
  __shared__ __align__(16) f32tile::Smem<C> sm;
  const int t = blockIdx.x, v0 = blockIdx.y * C::BN, b = blockIdx.z;
  const int t_out = t_in - kt + 1;
  const int k_lo = t - t_out + 1 > 0 ? t - t_out + 1 : 0, k_hi = t < kt - 1 ? t : kt - 1;
  const int ta = t - (kt - 1);   // the residual's step in ds
  const f32tile::Pos<C> pos;
  for (int o0 = 0; o0 < c_in; o0 += C::BM) {
    float acc[C::TM][C::TN];
    f32tile::zero<C>(acc);
    dx_product<C>(sm, pos, acc, ds, w, b, t, o0, v0, c_in, vp, t_out, g_n, k_lo, k_hi);
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
      const int o = o0 + pos.row(i);
      if (o >= c_in) continue;
      float* yr = dx + ((size_t)(b * t_in + t) * c_in + o) * vp + v0;
      const float* ar = RES && ta >= 0 && ta < t_out
                            ? ds + ((size_t)(b * t_out + ta) * g_n + o) * vp + v0
                            : nullptr;
#pragma unroll
      for (int j = 0; j < C::TN; j += 4) {
        const int l = pos.col(j);
        float y[4] = {acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]};
        if (ar) {
          float add[4];
          f32tile::ld4(add, ar + l);
#pragma unroll
          for (int u = 0; u < 4; ++u) y[u] += add[u];
        }
        *reinterpret_cast<float4*>(yr + l) = make_float4(y[0], y[1], y[2], y[3]);
      }
    }
  }
}

// A narrow input (K1b block 1: c_in = 1) leaves too few output channels for a
// tile; there one thread takes 4 lanes and walks the steps of ds once, in
// order, adding each step's taps into a window of the kt output steps it
// reaches (registers); the oldest is then complete and is written. ds is
// read once (it is 4.1 GB at 100k), where the tile reads it kt times.
// grid (ceil(Vp / (4 kDxThreads)), B, chunks), dynamic shared memory
// G * kt * c_in floats (the weights as [g][k][o]); block z writes the
// output steps [z t_chunk, z t_chunk + t_chunk), walking ds from kt - 1
// steps before them (a small problem, PeMSD7(M)'s, cuts the steps so that
// enough threads run); the sums of dx[b, t, o, :] as gate_dx_kernel's,
// the taps taken k = kt-1 .. 0 (steps t - k ascending); the residual's
// term only with RES.
template <bool RES = true>
__global__ void __launch_bounds__(kDxThreads)
gate_dx_lanes_kernel(const float* __restrict__ ds, const float* __restrict__ w,
                     float* __restrict__ dx, int t_in, int c_in, int vp, int kt, int g_n,
                     int t_chunk) {
  extern __shared__ float4 dx_smem4[];
  float* w_s = reinterpret_cast<float*>(dx_smem4);
  const int n = kt * c_in;
  for (int i = threadIdx.x; i < g_n * n; i += kDxThreads) {
    const int g = i / n, r = i % n, k = r / c_in, o = r % c_in;
    w_s[i] = w[((size_t)k * c_in + o) * g_n + g];
  }
  __syncthreads();
  const int v = (blockIdx.x * kDxThreads + threadIdx.x) * 4, b = blockIdx.y;
  if (v >= vp) return;
  const int t_out = t_in - kt + 1;
  float4 win[kDxTaps][kDxNarrow];   // win[k][o]: output step tp + k
#pragma unroll
  for (int k = 0; k < kDxTaps; ++k)
#pragma unroll
    for (int o = 0; o < kDxNarrow; ++o) win[k][o] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int t0 = blockIdx.z * t_chunk, t_end = t0 + t_chunk < t_in ? t0 + t_chunk : t_in;
  for (int tp = t0 - (kt - 1) > 0 ? t0 - (kt - 1) : 0; tp < t_end; ++tp) {
    if (tp < t_out) {   // ds step tp reaches output steps tp .. tp + kt - 1
      const float* xs = ds + (size_t)(b * t_out + tp) * g_n * vp + v;
#pragma unroll 4
      for (int g = 0; g < g_n; ++g) {
        const float4 xq = __ldg(reinterpret_cast<const float4*>(xs + (size_t)g * vp));
        const float* wg = w_s + g * n;
#pragma unroll
        for (int k = 0; k < kDxTaps; ++k) {
          if (k >= kt) break;
#pragma unroll
          for (int o = 0; o < kDxNarrow; ++o) {
            if (o >= c_in) break;
            const float wk = wg[k * c_in + o];
            win[k][o].x = fmaf(xq.x, wk, win[k][o].x);
            win[k][o].y = fmaf(xq.y, wk, win[k][o].y);
            win[k][o].z = fmaf(xq.z, wk, win[k][o].z);
            win[k][o].w = fmaf(xq.w, wk, win[k][o].w);
          }
        }
      }
    }
    const int ta = tp - (kt - 1);   // the residual's step in ds
#pragma unroll
    for (int o = 0; o < kDxNarrow; ++o) {
      if (o >= c_in || tp < t0) break;
      float4 y = win[0][o];
      if (RES && ta >= 0 && ta < t_out) {
        const float4 r = __ldg(reinterpret_cast<const float4*>(
            ds + ((size_t)(b * t_out + ta) * g_n + o) * vp + v));
        y = make_float4(y.x + r.x, y.y + r.y, y.z + r.z, y.w + r.w);
      }
      *reinterpret_cast<float4*>(dx + ((size_t)(b * t_in + tp) * c_in + o) * vp + v) = y;
    }
#pragma unroll
    for (int k = 0; k + 1 < kDxTaps; ++k)
#pragma unroll
      for (int o = 0; o < kDxNarrow; ++o) win[k][o] = win[k + 1][o];
#pragma unroll
    for (int o = 0; o < kDxNarrow; ++o) win[kDxTaps - 1][o] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// grid (Vp / kLanes, B * t1), kLanes threads, one lane each: dr's c1 values
// at the lane in registers, then for each term m the outputs
// dt_m[c] = sum over o ascending from 0 of gcw[m][c, o] dr[o].
__global__ void __launch_bounds__(kLanes)
term_grads_kernel(const float* __restrict__ dr, const float* __restrict__ gcw,
                  float* __restrict__ dt, int n_terms, int c1, int vp, size_t term) {
  __shared__ float w_s[kMaxOut * kMaxOut];   // one term's gcw [c][o]
  const int v = blockIdx.x * kLanes + threadIdx.x;
  const size_t row0 = (size_t)blockIdx.y * c1;
  float d[kMaxOut];
#pragma unroll
  for (int o = 0; o < kMaxOut; ++o) d[o] = o < c1 ? dr[(row0 + o) * vp + v] : 0.0f;
  for (int m = 0; m < n_terms; ++m) {
    __syncthreads();
    for (int i = threadIdx.x; i < c1 * c1; i += kLanes) w_s[i] = gcw[(size_t)m * c1 * c1 + i];
    __syncthreads();
    for (int c = 0; c < c1; ++c) {
      float acc = 0.0f;
#pragma unroll
      for (int o = 0; o < kMaxOut; ++o)
        if (o < c1) acc = fmaf(d[o], w_s[c * c1 + o], acc);
      dt[m * term + (row0 + c) * vp + v] = acc;
    }
  }
}

}  // namespace

cudaError_t launch_ln_drop(const float* x, const float* mu, const float* rstd, const float* lng,
                           const float* lnb, Drop drop, float* y, int batch, int t, int c,
                           int vp, cudaStream_t stream) {
  return ln_drop_run<float>(x, mu, rstd, lng, lnb, drop, y, batch, t, c, vp, stream);
}

size_t wgrad_part_floats(std::initializer_list<WgradShape> calls) {
  size_t most = 0;
  for (const WgradShape& c : calls) {
    if (c.terms <= 0) continue;
    const size_t n = (size_t)wgrad_plan(c.m, c.n, c.terms).slices * c.m * c.n;
    most = n > most ? n : most;
  }
  return most;
}

cudaError_t launch_wgrad_bias(Cv x, int k, Cv d, float* out, float* bias, float* part, int batch,
                              int vp, cudaStream_t stream) {
  return wgrad_bias_run<float>(x, k, d, out, bias, part, batch, vp, stream);
}

cudaError_t launch_wgrad(Cv x, int k, Cv d, float* out, float* part, int batch, int vp,
                         cudaStream_t stream) {
  return wgrad_run<float>(x, k, d, out, part, batch, vp, stream);
}

size_t ln_affine_part_floats(int batch, int t, int c, int vp) {
  return (size_t)ln_affine_slices(batch * t, c, vp) * 2 * c * vp;
}

cudaError_t launch_ln_bwd(const float* x, const float* mu, const float* rstd, const float* lng,
                          Drop drop, const float* dy, float* dx, float* dmu, float* drstd,
                          float* dlng, float* dlnb, float* part, int batch, int t, int c, int vp,
                          cudaStream_t stream, float* affine_part) {
  STGCN_TRY(ln_bwd_stats_run<float>(x, mu, rstd, lng, drop, dy, dx, dmu, drstd, part, batch, t,
                                    c, vp, stream));
  const int n = c * vp;
  if (!affine_part) {
    ln_bwd_affine_kernel<float><<<(c * vp + 255) / 256, 256, 0, stream>>>(
        x, mu, rstd, drop, dy, dlng, dlnb, batch * t, c, vp);
    return cudaGetLastError();
  }
  const int bt_total = batch * t, slices = ln_affine_slices(bt_total, c, vp);
  const int rows = (bt_total + slices - 1) / slices;   // (b, t) rows a slice
  ln_bwd_affine_part_kernel<<<dim3((unsigned)((n + 255) / 256), slices), 256, 0, stream>>>(
      x, mu, rstd, drop, dy, affine_part, bt_total, c, vp, rows);
  STGCN_TRY(cudaGetLastError());
  sum_slices_kernel<<<(unsigned)((2 * (size_t)n + 31) / 32), 256, 0, stream>>>(
      affine_part, dlng, dlnb, (size_t)n, 2 * (size_t)n, slices);
  return cudaGetLastError();
}

cudaError_t launch_gate_pass(const float* x, const float* w, const float* bias, GateUp up,
                             float* ds, float* a_out, int batch, int t_in, int c_in, int vp,
                             int kt, int c0, int act, cudaStream_t stream) {
  return gate_pass_run<float>(x, w, bias, up, ds, a_out, batch, t_in, c_in, vp, kt, c0, act,
                              stream);
}

cudaError_t launch_gate_dx(const float* ds, const float* w, float* dx, int batch, int t_in,
                           int c_in, int vp, int kt, int g, cudaStream_t stream, bool residual) {
  if (vp % DxWide::BN != 0 || t_in < kt) return cudaErrorInvalidValue;
  if (c_in <= kDxNarrow && kt <= kDxTaps) {
    const size_t smem = sizeof(float) * (size_t)g * kt * c_in;
    auto lanes = residual ? gate_dx_lanes_kernel<true> : gate_dx_lanes_kernel<false>;
    STGCN_TRY(set_smem(lanes, smem));
    const int t_chunk = dx_lanes_chunk(batch, t_in, vp);
    lanes<<<dim3((vp + 4 * kDxThreads - 1) / (4 * kDxThreads), batch,
                 (t_in + t_chunk - 1) / t_chunk),
            kDxThreads, smem, stream>>>(ds, w, dx, t_in, c_in, vp, kt, g, t_chunk);
  } else {
    auto tile = residual ? gate_dx_kernel<DxWide, true> : gate_dx_kernel<DxWide, false>;
    tile<<<dim3(t_in, vp / DxWide::BN, batch), DxWide::kThreads, 0, stream>>>(ds, w, dx, t_in,
                                                                             c_in, vp, kt, g);
  }
  return cudaGetLastError();
}

size_t fc_pass_part_floats(int batch, int vp, int c1, int ce) {
  const FcReduce r = fc_reduce(batch, vp, c1, ce);
  return ((size_t)r.per_group + 1) * r.groups * r.n;
}

cudaError_t launch_fc_pass(const float* h, const float* w1, const float* b1, const float* gout,
                           const float* w2, Drop drop, float* ds2, float* dw2, float* db1,
                           float* part, int batch, int c_in, int vp, int c1, int ce,
                           cudaStream_t stream) {
  return fc_pass_run<float>(h, w1, b1, gout, w2, drop, ds2, dw2, db1, part, batch, c_in, vp, c1,
                            ce, stream);
}

cudaError_t launch_tail_dr(const float* ds2, const float* c2k, const float* h, const float* gcw,
                           float* dr, float* dxg, float* dt_a, float* dt_b, int batch, int t1,
                           int c1, int vp, int kt, int g2, int n_terms, int cheb,
                           cudaStream_t stream) {
  return tail_dr_run<float>(ds2, c2k, h, gcw, dr, dxg, dt_a, dt_b, batch, t1, c1, vp, kt, g2,
                            n_terms, cheb, stream);
}

cudaError_t launch_term_grads(const float* dr, const float* gcw, float* dt, int n_terms,
                              int batch, int t1, int c1, int vp, cudaStream_t stream) {
  if (vp % kLanes != 0 || c1 > kMaxOut || n_terms < 1) return cudaErrorInvalidValue;
  term_grads_kernel<<<dim3(vp / kLanes, batch * t1), kLanes, 0, stream>>>(
      dr, gcw, dt, n_terms, c1, vp, (size_t)batch * t1 * c1 * vp);
  return cudaGetLastError();
}

}  // namespace stgcn
