// Building blocks of the backward kernels K1b-K4b (see bwd_blocks.cuh).
//
// The TPU backward kernels (`_head_pallas_bwd`, `_tail_pallas_bwd`,
// `_ohead_pallas_bwd`, `_ofc_pallas_bwd`) recompute their forward per tile
// and accumulate weight gradients in output blocks that stay resident
// across a sequential grid. CUDA blocks run in no order, so here each
// backward is a short pipeline of these kernels on one stream: the
// recompute and the data gradients run one thread per vertex lane
// (contract, gate_bwd), intermediates of the block live in a workspace in
// device memory, and every reduction over (batch, time, vertex) is done by
// a block that owns its outputs (wgrad partials per slice of (b, t) steps,
// then a fixed-order sum; LayerNorm statistics one block per (b, t); the (V, C)
// affine gradients one thread per (c, v)). No float atomics.
//
// What bounds them on the H100: the channel contractions are float32 FMA
// issue (K1b block 1 alone is about 1.2 GFLOP of recompute and 3.6 GFLOP
// in all), the elementwise passes are bytes. This first version keeps the
// intermediates in device memory instead of on chip; fusing them back is
// later work (PERF.md).
#include "bwd_blocks.cuh"

namespace stgcn {

namespace {

constexpr int kEwThreads = 256;

int ew_blocks(size_t n) {
  const size_t b = (n + kEwThreads - 1) / kEwThreads;
  return (int)(b < 8192 ? (b > 0 ? b : 1) : 8192);
}

// out[i] += a * w[i] for i < kChunk, w 16-byte aligned in shared memory.
__device__ __forceinline__ void fma16(float (&out)[kChunk], float a, const float* w) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int i = 0; i < kChunk / 4; ++i) {
    const float4 q = w4[i];
    out[4 * i + 0] = fmaf(a, q.x, out[4 * i + 0]);
    out[4 * i + 1] = fmaf(a, q.y, out[4 * i + 1]);
    out[4 * i + 2] = fmaf(a, q.z, out[4 * i + 2]);
    out[4 * i + 3] = fmaf(a, q.w, out[4 * i + 3]);
  }
}

// grid (Vp / kLanes * n_chunks, ty, B): one thread per lane, kChunk outputs.
__global__ void __launch_bounds__(kLanes) contract_kernel(ContractArgs a) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // [K * C][kChunk]
  const int n_vt = a.vp / kLanes;
  const int chunk = blockIdx.x / n_vt;
  const int o0 = chunk * kChunk;
  const int v = (blockIdx.x % n_vt) * kLanes + threadIdx.x;
  const int t = blockIdx.y, b = blockIdx.z;
  const int rows = a.k * a.c;
  for (int i = threadIdx.x; i < rows * kChunk; i += blockDim.x) {
    const int r = i / kChunk, oo = i % kChunk, o = o0 + oo;
    const int k = r / a.c, c = r % a.c;
    float val = 0.0f;
    if (o < a.o)
      val = a.back ? a.w[((size_t)k * a.o + o) * a.c + c] : a.w[((size_t)k * a.c + c) * a.o + o];
    w_s[i] = val;
  }
  __syncthreads();

  float acc[kChunk];
#pragma unroll
  for (int i = 0; i < kChunk; ++i) acc[i] = (a.bias && o0 + i < a.o) ? a.bias[o0 + i] : 0.0f;
  for (int k = 0; k < a.k; ++k) {
    const int tx = a.back ? t - k * a.tstep : t + k * a.tstep;
    if (tx < 0 || tx >= a.x_t) continue;
    const float* x = (k < 3 && a.xs[k]) ? a.xs[k] : a.xs[0];
    const float* xr = x + ((size_t)(b * a.x_t + tx) * a.c) * a.vp + v;
    for (int c = 0; c < a.c; ++c) fma16(acc, xr[(size_t)c * a.vp], w_s + (k * a.c + c) * kChunk);
  }
  const int ta = t - a.add_shift;
  const bool add_t = a.add.p && ta >= 0 && ta < a.add.t;
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    const int o = o0 + i;
    if (o >= a.o) break;
    float y = acc[i];
    if (add_t && o < a.add.c) y += a.add.p[((size_t)(b * a.add.t + ta) * a.add.c + o) * a.vp + v];
    if (a.relu_out) y = fmaxf(y, 0.0f);
    const size_t yi = ((size_t)(b * a.ty + t) * a.o + o) * a.vp + v;
    if (a.pos && !(a.pos[yi] > 0.0f)) y = 0.0f;
    a.y[yi] = y;
  }
}

__global__ void ln_drop_kernel(const float* __restrict__ x, const float* __restrict__ mu,
                               const float* __restrict__ rstd, const float* __restrict__ lng,
                               const float* __restrict__ lnb, Drop drop, float* __restrict__ y,
                               int t, int c, int vp, size_t n) {
  const uint32_t key = drop_key(drop.seed, drop.site);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t row = i / vp;
    const int v = (int)(i % vp), ch = (int)(row % c);
    const size_t bt = row / c;
    float val = (x[i] - mu[bt]) * rstd[bt] * lng[(size_t)ch * vp + v] + lnb[(size_t)ch * vp + v];
    if (drop.threshold) val *= drop_mask(drop, key, row, v);
    y[i] = val;
  }
}

__global__ void gate_bwd_kernel(const float* __restrict__ s, Cv res, int res_shift,
                                const float* __restrict__ da, const float* __restrict__ gps,
                                const float* __restrict__ gpss, int v_true, int act, int c_out,
                                float* __restrict__ ds, float* __restrict__ dxin,
                                float* __restrict__ a_out, int t_len, int vp, size_t n) {
  const bool gated = act == kGlu || act == kGtu;
  const int g = gated ? 2 * c_out : c_out;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int v = (int)(i % vp);
    const size_t row = i / vp;             // (b, t, c) over c_out channels
    const int c = (int)(row % c_out);
    const size_t bt = row / c_out;
    const int t = (int)(bt % t_len), b = (int)(bt / t_len);
    const size_t si = (bt * g + c) * vp + v;
    const float p = s[si];
    const float xin = c < res.c
        ? res.p[((size_t)(b * res.t + t + res_shift) * res.c + c) * vp + v] : 0.0f;
    float dp, dq = 0.0f, av;
    float d = da[i];
    if (gated) {
      const float lin = p + xin;
      const float sq = sigmoid(s[si + (size_t)c_out * vp]);
      if (act == kGlu) {
        av = lin * sq;
        if (gps && v < v_true) d += gps[bt] + 2.0f * gpss[bt] * av;
        dp = d * sq;
        dq = d * lin * sq * (1.0f - sq);
      } else {
        const float th = tanhf(lin);
        av = th * sq;
        if (gps && v < v_true) d += gps[bt] + 2.0f * gpss[bt] * av;
        dp = d * sq * (1.0f - th * th);
        dq = d * th * sq * (1.0f - sq);
      }
      ds[si + (size_t)c_out * vp] = dq;
    } else {
      const float z = p + xin;
      if (act == kRelu) {
        av = fmaxf(z, 0.0f);
        if (gps && v < v_true) d += gps[bt] + 2.0f * gpss[bt] * av;
        dp = z > 0.0f ? d : 0.0f;
      } else {
        const float sz = sigmoid(z);
        av = z * sz;
        if (gps && v < v_true) d += gps[bt] + 2.0f * gpss[bt] * av;
        dp = d * sz * (1.0f + z * (1.0f - sz));
      }
    }
    ds[si] = dp;
    dxin[i] = dp;
    if (a_out) a_out[i] = av;
  }
}

__global__ void relu_drop_kernel(const float* __restrict__ s, Drop drop,
                                 const float* __restrict__ dzd, float* __restrict__ zd,
                                 float* __restrict__ ds, int vp, size_t n) {
  const uint32_t key = drop_key(drop.seed, drop.site);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int v = (int)(i % vp);
    const float m = drop.threshold ? drop_mask(drop, key, i / vp, v) : 1.0f;
    const float sv = s[i];
    zd[i] = fmaxf(sv, 0.0f) * m;
    ds[i] = sv > 0.0f ? dzd[i] * m : 0.0f;
  }
}

constexpr int kTile = 32;          // wgrad output tile: 32 rows x 32 columns
constexpr int kWgradThreads = 256;  // each thread 4 rows of one column
constexpr int kFlushSteps = 128;    // lane tiles a thread sums before it banks the sum

// grid (ceil(M / 32), ceil(O / 32), slices); M = K * X.c rows. The slices
// are bt_slices x lane_splits: slice s sums the (b, t) steps
// [q * B*T / bt_slices, (q + 1) * B*T / bt_slices), q = s / lane_splits, over
// lane chunk s % lane_splits of each, in order. A thread banks its running
// sum every kFlushSteps lane tiles (4096 lanes) and adds the banks, so no
// f32 chain runs longer than that (a serial sum over 1M lanes left weight
// gradients about 1e-3 off, relative to their largest entry).
__global__ void __launch_bounds__(kWgradThreads)
wgrad_kernel(Cv x, int k_taps, Cv d, float* __restrict__ part, int batch, int vp,
             int lane_splits) {
  __shared__ float xs[kTile][kTile + 1];
  __shared__ float dsh[kTile][kTile + 1];  // [v][o]
  const int m_total = k_taps * x.c, o_total = d.c;
  const int m0 = blockIdx.x * kTile, o0 = blockIdx.y * kTile, slice = blockIdx.z;
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
  const long long bt_total = (long long)batch * d.t;
  const int bt_slices = gridDim.z / lane_splits, q = slice / lane_splits;
  const int bt_lo = (int)(bt_total * q / bt_slices);
  const int bt_hi = (int)(bt_total * (q + 1) / bt_slices);
  const int v_tiles = vp / kTile, chunk = slice % lane_splits;
  const int v_lo = (int)((long long)v_tiles * chunk / lane_splits) * kTile;
  const int v_hi = (int)((long long)v_tiles * (chunk + 1) / lane_splits) * kTile;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float bank[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int steps = 0;
  for (int bt = bt_lo; bt < bt_hi; ++bt) {
    const int b = bt / d.t, t = bt % d.t;
    for (int v0 = v_lo; v0 < v_hi; v0 += kTile) {
        __syncthreads();
        for (int i = threadIdx.x; i < kTile * kTile; i += kWgradThreads) {
          const int r = i / kTile, vv = i % kTile;
          const int m = m0 + r, o = o0 + r;
          float xv = 0.0f;
          if (m < m_total) {
            if (x.p == nullptr) {
              xv = 1.0f;
            } else {
              const int k = m / x.c, c = m % x.c;
              xv = x.p[((size_t)(b * x.t + t + k) * x.c + c) * vp + v0 + vv];
            }
          }
          xs[r][vv] = xv;
          dsh[vv][r] = o < o_total ? d.p[((size_t)(b * d.t + t) * d.c + o) * vp + v0 + vv] : 0.0f;
        }
        __syncthreads();
#pragma unroll 8
        for (int vv = 0; vv < kTile; ++vv) {
          const float dv = dsh[vv][tx];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j] = fmaf(xs[ty + 8 * j][vv], dv, acc[j]);
        }
        if (++steps == kFlushSteps) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            bank[j] += acc[j];
            acc[j] = 0.0f;
          }
          steps = 0;
        }
    }
  }
  const size_t per_slice = (size_t)m_total * o_total;
  const int o = o0 + tx;
  if (o < o_total)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 8 * j;
      if (m < m_total) part[slice * per_slice + (size_t)m * o_total + o] = bank[j] + acc[j];
    }
}

__global__ void sum_slices_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  size_t n, int slices) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int sl = 0; sl < slices; ++sl) s += part[sl * n + i];
    out[i] = s;
  }
}

// grid (splits, B * T), block kLanes: dx, and per (b, t) row the partial sums
// of the statistics gradients over one slice of `len` (c, v) elements, so a
// thread adds a few hundred terms (one block per row left each thread 1e5
// serial adds at 100k vertices, and 8-96 blocks on 132 SMs). With one slice
// (rows of up to 32768 elements, every row at Vp = 256) the block writes
// dmu and drstd itself and `part` is not read.
__global__ void __launch_bounds__(kLanes)
ln_bwd_stats_kernel(const float* __restrict__ x, const float* __restrict__ mu,
                    const float* __restrict__ rstd, const float* __restrict__ lng, Drop drop,
                    const float* __restrict__ dy, float* __restrict__ dx,
                    float* __restrict__ part, float* __restrict__ dmu,
                    float* __restrict__ drstd, int c, int vp, int len) {
  __shared__ float red[kLanes / 32];
  const uint32_t key = drop_key(drop.seed, drop.site);
  const size_t bt = blockIdx.y;
  const float m = mu[bt], r = rstd[bt];
  const int n = c * vp;
  const int i0 = blockIdx.x * len, i1 = i0 + len < n ? i0 + len : n;
  float s1 = 0.0f, s2 = 0.0f;
  // vp and len are multiples of kLanes: step v by kLanes and wrap into ch
  int ch = (i0 + threadIdx.x) / vp, v = (i0 + threadIdx.x) % vp;
  for (int i = i0 + threadIdx.x; i < i1; i += kLanes, v += kLanes) {
    if (v >= vp) {
      v -= vp;
      ++ch;
    }
    const size_t row = bt * c + ch, idx = row * vp + v;
    float g = dy[idx];
    if (drop.threshold) g *= drop_mask(drop, key, row, v);
    const float dxn = g * lng[(size_t)ch * vp + v];
    dx[idx] = dxn * r;
    s1 += dxn;
    s2 += dxn * (x[idx] - m);
  }
  s1 = block_sum(s1, red);
  s2 = block_sum(s2, red);
  if (threadIdx.x == 0 && gridDim.x == 1) {
    dmu[bt] = -s1 * r;
    drstd[bt] = s2;
  } else if (threadIdx.x == 0) {
    const size_t o = (bt * gridDim.x + blockIdx.x) * 2;
    part[o] = s1;
    part[o + 1] = s2;
  }
}

// grid (B * T), block kLanes: a row's slice partials summed in a fixed
// order (strided per thread, then the block's tree), then dmu and drstd.
__global__ void __launch_bounds__(kLanes)
ln_bwd_stats_sum_kernel(const float* __restrict__ part, const float* __restrict__ rstd,
                        float* __restrict__ dmu, float* __restrict__ drstd, int splits) {
  __shared__ float red[kLanes / 32];
  const size_t bt = blockIdx.x;
  float s1 = 0.0f, s2 = 0.0f;
  for (int k = threadIdx.x; k < splits; k += kLanes) {
    s1 += part[(bt * splits + k) * 2];
    s2 += part[(bt * splits + k) * 2 + 1];
  }
  s1 = block_sum(s1, red);
  s2 = block_sum(s2, red);
  if (threadIdx.x == 0) {
    dmu[bt] = -s1 * rstd[bt];
    drstd[bt] = s2;
  }
}

// one thread per (c, v): the affine gradients, summed over (b, t) in order.
__global__ void ln_bwd_affine_kernel(const float* __restrict__ x, const float* __restrict__ mu,
                                     const float* __restrict__ rstd, Drop drop,
                                     const float* __restrict__ dy, float* __restrict__ dlng,
                                     float* __restrict__ dlnb, int bt_total, int c, int vp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= c * vp) return;
  const uint32_t key = drop_key(drop.seed, drop.site);
  const int ch = i / vp, v = i % vp;
  float sg = 0.0f, sb = 0.0f;
  for (int bt = 0; bt < bt_total; ++bt) {
    const size_t row = (size_t)bt * c + ch, idx = row * vp + v;
    float g = dy[idx];
    if (drop.threshold) g *= drop_mask(drop, key, row, v);
    sg += g * ((x[idx] - mu[bt]) * rstd[bt]);
    sb += g;
  }
  dlng[i] = sg;
  dlnb[i] = sb;
}

}  // namespace

cudaError_t launch_contract(const ContractArgs& a, cudaStream_t stream) {
  if (a.vp % kLanes != 0) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)a.k * a.c * kChunk;
  cudaError_t err = set_smem(contract_kernel, smem);
  if (err != cudaSuccess) return err;
  const int n_chunks = (a.o + kChunk - 1) / kChunk;
  const dim3 grid((a.vp / kLanes) * n_chunks, a.ty, a.batch);
  contract_kernel<<<grid, kLanes, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_ln_drop(const float* x, const float* mu, const float* rstd, const float* lng,
                           const float* lnb, Drop drop, float* y, int batch, int t, int c,
                           int vp, cudaStream_t stream) {
  const size_t n = (size_t)batch * t * c * vp;
  ln_drop_kernel<<<ew_blocks(n), kEwThreads, 0, stream>>>(x, mu, rstd, lng, lnb, drop, y, t, c,
                                                          vp, n);
  return cudaGetLastError();
}

cudaError_t launch_gate_bwd(const float* s, Cv res, int res_shift, const float* da,
                            const float* gps, const float* gpss, int v_true, int act, int c_out,
                            float* ds, float* dxin, float* a_out, int batch, int t, int vp,
                            cudaStream_t stream) {
  const size_t n = (size_t)batch * t * c_out * vp;
  gate_bwd_kernel<<<ew_blocks(n), kEwThreads, 0, stream>>>(
      s, res, res_shift, da, gps, gpss, v_true, act, c_out, ds, dxin, a_out, t, vp, n);
  return cudaGetLastError();
}

cudaError_t launch_relu_drop(const float* s, Drop drop, const float* dzd, float* zd, float* ds,
                             int batch, int t, int c, int vp, cudaStream_t stream) {
  const size_t n = (size_t)batch * t * c * vp;
  relu_drop_kernel<<<ew_blocks(n), kEwThreads, 0, stream>>>(s, drop, dzd, zd, ds, vp, n);
  return cudaGetLastError();
}

cudaError_t launch_wgrad(Cv x, int k, Cv d, float* out, float* part, int batch, int vp,
                         cudaStream_t stream) {
  if (vp % kTile != 0) return cudaErrorInvalidValue;
  const int m_total = k * x.c;
  // (b, t) steps first; with fewer than kWgradSlices of them (batch 1 at 1M
  // vertices: 4-10 steps of 1M lanes each), each step's lanes are cut too
  const int bt_total = batch * d.t;
  if (bt_total <= 0) return cudaErrorInvalidConfiguration;
  const int bt_slices = bt_total < kWgradSlices ? bt_total : kWgradSlices;
  int lane_splits = kWgradSlices / bt_slices;
  lane_splits = lane_splits < vp / kTile ? lane_splits : vp / kTile;
  const int slices = bt_slices * lane_splits;
  const dim3 grid((m_total + kTile - 1) / kTile, (d.c + kTile - 1) / kTile, slices);
  wgrad_kernel<<<grid, kWgradThreads, 0, stream>>>(x, k, d, part, batch, vp, lane_splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)m_total * d.c;
  sum_slices_kernel<<<ew_blocks(n), kEwThreads, 0, stream>>>(part, out, n, slices);
  return cudaGetLastError();
}

cudaError_t launch_ln_bwd(const float* x, const float* mu, const float* rstd, const float* lng,
                          Drop drop, const float* dy, float* dx, float* dmu, float* drstd,
                          float* dlng, float* dlnb, float* part, int batch, int t, int c, int vp,
                          cudaStream_t stream) {
  const int n = c * vp;
  int splits = (n + kLanes * 256 - 1) / (kLanes * 256);   // about 256 terms a thread
  splits = splits < 1 ? 1 : (splits > kLnSplits ? kLnSplits : splits);
  const int len = ((n + splits - 1) / splits + kLanes - 1) / kLanes * kLanes;
  ln_bwd_stats_kernel<<<dim3(splits, batch * t), kLanes, 0, stream>>>(
      x, mu, rstd, lng, drop, dy, dx, part, dmu, drstd, c, vp, len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    ln_bwd_stats_sum_kernel<<<batch * t, kLanes, 0, stream>>>(part, rstd, dmu, drstd, splits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  ln_bwd_affine_kernel<<<(c * vp + 255) / 256, 256, 0, stream>>>(x, mu, rstd, drop, dy, dlng,
                                                                 dlnb, batch * t, c, vp);
  return cudaGetLastError();
}

}  // namespace stgcn
