// K1b (block head) and K2b (block tail) of one STGCN ST block, backward:
// the C entry points. Each runs as a short pipeline of launches on the
// caller's stream, recomputing its forward from the saved inputs as the TPU
// kernels do.
//
// Replaces the TPU kernels stgcn_tpu/kernels/vertex_fused.py
// `_head_pallas_bwd` (:654, body `_make_head_bwd_kernel` :529 /
// `_head_core_bwd` :406 / `_ln_drop_bwd` :378) and `_tail_pallas_bwd` (:883,
// body `_make_tail_bwd_kernel` :791 / `_tail_core_bwd` :445).
//
// K1b: x4 = LN-normalize(x) * mask (regenerated from (seed, site, element),
//      so any tiling gives the forward's mask; block 1 reads x itself), then
//      one pass per lane tile (head_gate_bwd_kernel) that recomputes
//      s1 = tconv1(x4) + c1b on the register tile of f32_tile.cuh (gate
//      channels x lanes, as K1's gate GEMM), computes da1 = gy . gaw^T and
//      runs the gate backward in its epilogue, writing only ds1 and a1 (s1
//      never reaches device memory; the residual's gradient dxin is ds1's
//      linear half) -> weight gradients dgaw with dgab, dc1k with dc1b (the
//      bias as a ones row of the same product, so gy and ds1 are read once
//      each) -> dx4 = tconv1^T(ds1) + dxin on the same tile (head_dx_kernel)
//      (block 1's narrow input: one pass over ds1, head_dx_lanes_kernel)
//      -> LayerNorm backward dx, dmu, drstd, dlng, dlnb.
//      What bounds it: at block 2's widths (c_in = c0 = 64) float32 FMA
//      issue, three products of kt*c_in*g1 per lane and step (recompute,
//      dc1k, dx4); at block 1's (c_in = 1) the bytes of ds1 and a1, which it
//      writes once and reads twice and once. x4 is kept in device memory
//      (block 2: 4 B a lane, step and channel) rather than recomputed in
//      the weight gradient's staging, where the LayerNorm and the mask's
//      hash would cost more issue slots than its FMAs.
// K2b: h = relu(sum_m cterm_m gcw[m] + gcb + xg) -> s2 = tconv2(h) -> gate
//      backward from ga2 plus the LayerNorm-partial cotangents (gps + 2 gpss
//      a2 on true lanes) -> dc2k, dc2b -> dr = (tconv2^T(ds2) + dxin2) *
//      (h > 0) -> dgcw, dgcb -> dxg and the graph terms' gradients, on the
//      building blocks of bwd_blocks.cu.
#include "bwd_blocks.cuh"

#include "f32_tile.cuh"

namespace stgcn {
namespace {

constexpr int kHeadLanes = 64;   // lanes of a head_gate_bwd_kernel block

// the recompute's tile: gate channels (p then q, 64 each) x 64 lanes, 8 x 8 a
// thread, 3 blocks a SM (168 registers a thread: at 128 it spilled and ran
// 8-12 % slower, as the data gradient's tile did)
template <bool GATED>
using GateCfg = f32tile::Cfg<GATED ? 128 : 64, kHeadLanes, 16, GATED ? 8 : 4, 8, 3>;

// grid (Vp / 64, t1, B): for lanes v0 .. v0+63 of step t, per pass of 64
// gate channels, s1 = c1b + sum over rows (k, c) of c1k[k, c, :] x4[b, t+k, c, :]
// (rows ascending, as tconv1), da1 = sum over o of gy[b, t, o, :] gaw[:, o],
// then the gate backward with the in-gate residual x4[b, t + kt - 1]:
// ds1 [B, t1, g1, Vp] and a1 [B, t1, c0, Vp].
template <bool GATED>
__global__ void __launch_bounds__(GateCfg<GATED>::kThreads, GateCfg<GATED>::kMinBlocks)
head_gate_bwd_kernel(const float* __restrict__ x4, const float* __restrict__ c1k,
                     const float* __restrict__ c1b, const float* __restrict__ gaw,
                     const float* __restrict__ gy, float* __restrict__ ds1,
                     float* __restrict__ a1, int t_in, int c_in, int vp, int kt, int c0, int c1,
                     int act) {
  using C = GateCfg<GATED>;
  using SX = f32tile::RSlots<C, kHeadLanes>;
  constexpr int kWPer = C::BK * C::BM / C::kThreads;   // weight values a thread stages
  __shared__ __align__(16) f32tile::Smem<C> sm;
  __shared__ __align__(16) float gy_s[kMaxOut][kHeadLanes];   // gy[b, t, o, v0 + l]
  __shared__ __align__(16) float gw_s[kMaxOut][64];           // gaw[s0 + c, o] as [o][c]
  const int v0 = blockIdx.x * kHeadLanes, t = blockIdx.y, b = blockIdx.z;
  const int t1 = t_in - kt + 1, g1 = GATED ? 2 * c0 : c0, rows = kt * c_in;
  const f32tile::Pos<C> pos;

  for (int i = threadIdx.x; i < kMaxOut * kHeadLanes; i += C::kThreads) {
    const int o = i / kHeadLanes, l = i % kHeadLanes;
    gy_s[o][l] = o < c1 ? gy[((size_t)(b * t1 + t) * c1 + o) * vp + v0 + l] : 0.0f;
  }

  // the weight column a thread stages: tile row wj (p rows, then q rows)
  const int wj = threadIdx.x % C::BM, wk0 = (threadIdx.x / C::BM) * kWPer;
  for (int s0 = 0; s0 < c0; s0 += 64) {
    float acc[C::TM][C::TN];
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
      const int j = pos.row(i), c = s0 + (j & 63);
      const float bias = c < c0 ? c1b[j < 64 ? c : c0 + c] : 0.0f;
#pragma unroll
      for (int l = 0; l < C::TN; ++l) acc[i][l] = bias;
    }
    const int wc = s0 + (wj & 63);
    const float* wcol = wc < c0 ? c1k + (wj < 64 ? wc : c0 + wc) : nullptr;
    float wv[kWPer];
    float4 xv[SX::kSlots];
    auto load = [&](int st) {
      const int r0 = st * C::BK;
#pragma unroll
      for (int q = 0; q < kWPer; ++q) {
        const int r = r0 + wk0 + q;
        wv[q] = wcol && r < rows ? __ldg(wcol + (size_t)r * g1) : 0.0f;
      }
#pragma unroll
      for (int p = 0; p < SX::kSlots; ++p) {
        const int r = r0 + SX::k(p);
        xv[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (r < rows) {
          const int k = r / c_in, c = r - k * c_in;
          xv[p] = __ldg(reinterpret_cast<const float4*>(
              x4 + ((size_t)(b * t_in + t + k) * c_in + c) * vp + v0 + SX::roff(p)));
        }
      }
    };
    auto store = [&](int buf) {
#pragma unroll
      for (int q = 0; q < kWPer; ++q) sm.a[buf][wk0 + q][wj] = wv[q];
      SX::store(sm.b[buf], xv);
    };
    // gaw's columns of this pass, for the epilogue (the loop's first barrier publishes them)
    for (int i = threadIdx.x; i < kMaxOut * 64; i += C::kThreads) {
      const int c = i / kMaxOut, o = i % kMaxOut;
      gw_s[o][c] = (s0 + c < c0 && o < c1) ? gaw[(size_t)(s0 + c) * c1 + o] : 0.0f;
    }
    const int steps = (rows + C::BK - 1) / C::BK;
    f32tile::stage_loop<C>(sm, pos, steps, acc, load, store, rows - (steps - 1) * C::BK);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = s0 + 4 * pos.ty + i;
      float da[8];
#pragma unroll
      for (int l = 0; l < 8; ++l) da[l] = 0.0f;
      for (int o = 0; o < c1; ++o) {   // da1 = gy . gaw^T, o ascending
        const float wo = gw_s[o][4 * pos.ty + i];
        float gv[8];
        f32tile::ld4(gv, &gy_s[o][4 * pos.tx]);
        f32tile::ld4(gv + 4, &gy_s[o][kHeadLanes / 2 + 4 * pos.tx]);
#pragma unroll
        for (int l = 0; l < 8; ++l) da[l] = fmaf(gv[l], wo, da[l]);
      }
      if (c >= c0) continue;
      const size_t srow = (size_t)(b * t1 + t) * g1 + c, arow = (size_t)(b * t1 + t) * c0 + c;
      const float* xr = x4 + ((size_t)(b * t_in + t + kt - 1) * c_in + c) * vp;
#pragma unroll
      for (int h = 0; h < 2; ++h) {   // lanes 4 tx .. and 32 + 4 tx ..
        const int v = v0 + h * (kHeadLanes / 2) + 4 * pos.tx;
        float xin[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (c < c_in) f32tile::ld4(xin, xr + v);
        float dp[4], dq[4], av[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          gate_point_bwd(act, acc[i][4 * h + u], GATED ? acc[C::TM - 4 + i][4 * h + u] : 0.0f,
                         xin[u], da[4 * h + u], false, 0.0f, 0.0f, dp[u], dq[u], av[u]);
        *reinterpret_cast<float4*>(ds1 + srow * vp + v) = make_float4(dp[0], dp[1], dp[2], dp[3]);
        if (GATED)
          *reinterpret_cast<float4*>(ds1 + (srow + c0) * vp + v) =
              make_float4(dq[0], dq[1], dq[2], dq[3]);
        *reinterpret_cast<float4*>(a1 + arow * vp + v) = make_float4(av[0], av[1], av[2], av[3]);
      }
    }
    __syncthreads();   // gw_s and the staging buffers are rewritten by the next pass
  }
}

cudaError_t launch_head_gate_bwd(const float* x4, const float* c1k, const float* c1b,
                                 const float* gaw, const float* gy, float* ds1, float* a1,
                                 int batch, int t_in, int c_in, int vp, int kt, int c0, int c1,
                                 int act, cudaStream_t stream) {
  if (vp % kHeadLanes != 0 || c1 > kMaxOut) return cudaErrorInvalidValue;
  const dim3 grid(vp / kHeadLanes, t_in - kt + 1, batch);
  if (act == kGlu || act == kGtu)
    head_gate_bwd_kernel<true><<<grid, GateCfg<true>::kThreads, 0, stream>>>(
        x4, c1k, c1b, gaw, gy, ds1, a1, t_in, c_in, vp, kt, c0, c1, act);
  else
    head_gate_bwd_kernel<false><<<grid, GateCfg<false>::kThreads, 0, stream>>>(
        x4, c1k, c1b, gaw, gy, ds1, a1, t_in, c_in, vp, kt, c0, c1, act);
  return cudaGetLastError();
}

// the data gradient's tile: 64 output channels x 128 lanes, 8 x 8 a thread,
// 3 blocks a SM
using DxWide = f32tile::Cfg<64, 128, 16, 8, 8, 3>;

// A narrow input (block 1: c_in = 1) leaves too few output channels for a
// tile; there one thread takes 4 lanes and walks the steps of ds1 once, in
// order, adding each step's taps into a window of the kt output steps it
// reaches (registers); the oldest is then complete and is written. ds1 is
// read once (it is 4.1 GB at 100k), where the tile reads it kt times.
constexpr int kDxNarrow = 4;      // most input channels of the lane kernel
constexpr int kDxTaps = 4;        // most taps of the lane kernel
constexpr int kDxThreads = 64;

// grid (ceil(Vp / (4 kDxThreads)), B, chunks), dynamic shared memory
// g1 * kt * c_in floats (the weights as [g][k][o]); block z writes the
// output steps [z t_chunk, z t_chunk + t_chunk), walking ds1 from kt - 1
// steps before them (a small problem, PeMSD7(M)'s, cuts the steps so that
// enough threads run); the sums of dx4[b, t, o, :] as head_dx_kernel's,
// the taps taken k = kt-1 .. 0 (steps t - k ascending).
__global__ void __launch_bounds__(kDxThreads)
head_dx_lanes_kernel(const float* __restrict__ ds1, const float* __restrict__ c1k,
                     float* __restrict__ dx4, int t_in, int c_in, int vp, int kt, int g1,
                     int t_chunk) {
  extern __shared__ float4 dx_smem4[];
  float* w_s = reinterpret_cast<float*>(dx_smem4);
  const int n = kt * c_in;
  for (int i = threadIdx.x; i < g1 * n; i += kDxThreads) {
    const int g = i / n, r = i % n, k = r / c_in, o = r % c_in;
    w_s[i] = c1k[((size_t)k * c_in + o) * g1 + g];
  }
  __syncthreads();
  const int v = (blockIdx.x * kDxThreads + threadIdx.x) * 4, b = blockIdx.y;
  if (v >= vp) return;
  const int t1 = t_in - kt + 1;
  float4 win[kDxTaps][kDxNarrow];   // win[k][o]: output step tp + k
#pragma unroll
  for (int k = 0; k < kDxTaps; ++k)
#pragma unroll
    for (int o = 0; o < kDxNarrow; ++o) win[k][o] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int t0 = blockIdx.z * t_chunk, t_end = t0 + t_chunk < t_in ? t0 + t_chunk : t_in;
  for (int tp = t0 - (kt - 1) > 0 ? t0 - (kt - 1) : 0; tp < t_end; ++tp) {
    if (tp < t1) {   // ds1 step tp reaches output steps tp .. tp + kt - 1
      const float* xs = ds1 + (size_t)(b * t1 + tp) * g1 * vp + v;
#pragma unroll 4
      for (int g = 0; g < g1; ++g) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(xs + (size_t)g * vp));
        const float* wg = w_s + g * n;
#pragma unroll
        for (int k = 0; k < kDxTaps; ++k) {
          if (k >= kt) break;
#pragma unroll
          for (int o = 0; o < kDxNarrow; ++o) {
            if (o >= c_in) break;
            const float w = wg[k * c_in + o];
            win[k][o].x = fmaf(x.x, w, win[k][o].x);
            win[k][o].y = fmaf(x.y, w, win[k][o].y);
            win[k][o].z = fmaf(x.z, w, win[k][o].z);
            win[k][o].w = fmaf(x.w, w, win[k][o].w);
          }
        }
      }
    }
    const int ta = tp - (kt - 1);   // the residual's step in ds1
#pragma unroll
    for (int o = 0; o < kDxNarrow; ++o) {
      if (o >= c_in || tp < t0) break;
      float4 y = win[0][o];
      if (ta >= 0 && ta < t1) {
        const float4 r = __ldg(reinterpret_cast<const float4*>(
            ds1 + ((size_t)(b * t1 + ta) * g1 + o) * vp + v));
        y = make_float4(y.x + r.x, y.y + r.y, y.z + r.z, y.w + r.w);
      }
      *reinterpret_cast<float4*>(dx4 + ((size_t)(b * t_in + tp) * c_in + o) * vp + v) = y;
    }
#pragma unroll
    for (int k = 0; k + 1 < kDxTaps; ++k)
#pragma unroll
      for (int o = 0; o < kDxNarrow; ++o) win[k][o] = win[k + 1][o];
#pragma unroll
    for (int o = 0; o < kDxNarrow; ++o) win[kDxTaps - 1][o] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// grid (t_in, Vp / BN, B), t fastest so the kt output steps that read one
// step of ds1 run together:
//   dx4[b, t, o, :] = sum over taps k with 0 <= t - k < t1, then g < g1, of
//                     ds1[b, t - k, g, :] c1k[k, o, g]  + ds1[b, t - kt + 1, o, :]
// (the last term the residual's gradient dxin, where that step exists).
template <class C>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks)
head_dx_kernel(const float* __restrict__ ds1, const float* __restrict__ c1k,
               float* __restrict__ dx4, int t_in, int c_in, int vp, int kt, int g1) {
  using SX = f32tile::RSlots<C, C::BN>;
  constexpr int kWPer = C::BK * C::BM / C::kThreads;
  static_assert(kWPer >= 1 && C::BK * C::BM % C::kThreads == 0, "weight staging divides");
  __shared__ __align__(16) f32tile::Smem<C> sm;
  const int t = blockIdx.x, v0 = blockIdx.y * C::BN, b = blockIdx.z;
  const int t1 = t_in - kt + 1;
  const int k_lo = t - t1 + 1 > 0 ? t - t1 + 1 : 0, k_hi = t < kt - 1 ? t : kt - 1;
  const int per_tap = (g1 + C::BK - 1) / C::BK;
  const int steps = k_hi >= k_lo ? (k_hi - k_lo + 1) * per_tap : 0;
  const int ta = t - (kt - 1);   // the residual's step in ds1
  const f32tile::Pos<C> pos;
  for (int o0 = 0; o0 < c_in; o0 += C::BM) {
    float acc[C::TM][C::TN];
    f32tile::zero<C>(acc);
    float wv[kWPer];
    float4 xv[SX::kSlots];
    auto load = [&](int st) {
      const int k = k_lo + st / per_tap, g0 = (st % per_tap) * C::BK;
#pragma unroll
      for (int q = 0; q < kWPer; ++q) {
        const int e = threadIdx.x + q * C::kThreads, kk = e % C::BK, o = o0 + e / C::BK;
        wv[q] = o < c_in && g0 + kk < g1 ? __ldg(c1k + ((size_t)k * c_in + o) * g1 + g0 + kk)
                                         : 0.0f;
      }
      const float* xs = ds1 + ((size_t)(b * t1 + t - k) * g1 + g0) * vp + v0;
#pragma unroll
      for (int p = 0; p < SX::kSlots; ++p)
        xv[p] = g0 + SX::k(p) < g1
                    ? __ldg(reinterpret_cast<const float4*>(xs + (size_t)SX::k(p) * vp +
                                                            SX::roff(p)))
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    };
    auto store = [&](int buf) {
#pragma unroll
      for (int q = 0; q < kWPer; ++q) {
        const int e = threadIdx.x + q * C::kThreads;
        sm.a[buf][e % C::BK][e / C::BK] = wv[q];
      }
      SX::store(sm.b[buf], xv);
    };
    f32tile::stage_loop<C>(sm, pos, steps, acc, load, store);
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
      const int o = o0 + pos.row(i);
      if (o >= c_in) continue;
      float* yr = dx4 + ((size_t)(b * t_in + t) * c_in + o) * vp + v0;
      const float* ar = ta >= 0 && ta < t1 ? ds1 + ((size_t)(b * t1 + ta) * g1 + o) * vp + v0
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

cudaError_t launch_head_dx(const float* ds1, const float* c1k, float* dx4, int batch, int t_in,
                           int c_in, int vp, int kt, int g1, cudaStream_t stream) {
  if (vp % DxWide::BN != 0) return cudaErrorInvalidValue;
  if (c_in <= kDxNarrow && kt <= kDxTaps) {
    const size_t smem = sizeof(float) * (size_t)g1 * kt * c_in;
    const cudaError_t err = set_smem(head_dx_lanes_kernel, smem);
    if (err != cudaSuccess) return err;
    // steps a block: all of them where the lanes alone give 8 threads per
    // FP32 lane of the card (2^17), fewer below that
    const long long threads = (long long)(vp / 4) * batch;
    long long chunks = ((1LL << 17) + threads - 1) / threads;
    chunks = chunks < 1 ? 1 : (chunks > t_in ? t_in : chunks);
    const int t_chunk = (int)((t_in + chunks - 1) / chunks);
    head_dx_lanes_kernel<<<dim3((vp + 4 * kDxThreads - 1) / (4 * kDxThreads), batch,
                                (t_in + t_chunk - 1) / t_chunk),
                           kDxThreads, smem, stream>>>(ds1, c1k, dx4, t_in, c_in, vp, kt, g1,
                                                       t_chunk);
  } else {
    head_dx_kernel<DxWide><<<dim3(t_in, vp / DxWide::BN, batch), DxWide::kThreads, 0, stream>>>(
        ds1, c1k, dx4, t_in, c_in, vp, kt, g1);
  }
  return cudaGetLastError();
}

// One pass over the head backward. With work == nullptr it only sizes the
// workspace (returned through `floats`).
cudaError_t head_bwd(const float* x, const float* mu, const float* rstd, const float* lng,
                     const float* lnb, const float* c1k, const float* c1b, const float* gaw,
                     const float* gy, float* dx, float* dmu, float* drstd, float* dlng,
                     float* dlnb, float* dc1k, float* dc1b, float* dgaw, float* dgab,
                     float* work, size_t* floats, int B, int t_in, int c_in, int vp, int kt,
                     int c0, int c1, int act, int apply_ln, Drop drop, cudaStream_t s) {
  const bool gated = act == kGlu || act == kGtu;
  const int g1 = gated ? 2 * c0 : c0, t1 = t_in - kt + 1;
  const size_t lane = (size_t)B * vp;
  const long long r1 = (long long)B * t1 * vp;
  Carver w{work};
  float* x4 = apply_ln ? w.take(lane * t_in * c_in) : nullptr;
  float* dx4 = apply_ln ? w.take(lane * t_in * c_in) : dx;
  float* ds1 = w.take(lane * t1 * g1);
  float* a1 = w.take(lane * t1 * c0);
  float* part = w.take(wgrad_part_floats({{c0 + 1, c1, r1}, {kt * c_in + 1, g1, r1}}));
  float* lnpart = apply_ln ? w.take(ln_bwd_part_floats(B, t_in)) : nullptr;
  if (floats) *floats = w.used;
  if (!work) return cudaSuccess;
  if (t1 < 1 || c1 > kMaxOut) return cudaErrorInvalidValue;

  if (apply_ln) STGCN_TRY(launch_ln_drop(x, mu, rstd, lng, lnb, drop, x4, B, t_in, c_in, vp, s));
  const float* xin = apply_ln ? x4 : x;
  // s1, da1 and the gate backward in one pass: ds1, a1
  STGCN_TRY(launch_head_gate_bwd(xin, c1k, c1b, gaw, gy, ds1, a1, B, t_in, c_in, vp, kt, c0, c1,
                                 act, s));
  STGCN_TRY(launch_wgrad_bias(Cv{a1, t1, c0}, 1, Cv{gy, t1, c1}, dgaw, dgab, part, B, vp, s));
  STGCN_TRY(launch_wgrad_bias(Cv{xin, t_in, c_in}, kt, Cv{ds1, t1, g1}, dc1k, dc1b, part, B, vp,
                              s));
  // dx4 = tconv1^T(ds1) + dxin shifted to the window's last step
  STGCN_TRY(launch_head_dx(ds1, c1k, dx4, B, t_in, c_in, vp, kt, g1, s));
  if (apply_ln)
    STGCN_TRY(launch_ln_bwd(x, mu, rstd, lng, drop, dx4, dx, dmu, drstd, dlng, dlnb, lnpart, B,
                            t_in, c_in, vp, s));
  return cudaSuccess;
}

cudaError_t tail_bwd(const float* xg, const float* t_a, const float* t_b, const float* gcw,
                     const float* gcb, const float* c2k, const float* c2b, const float* ga2,
                     const float* gps, const float* gpss, float* dxg, float* dt_a, float* dt_b,
                     float* dgcw, float* dgcb, float* dc2k, float* dc2b, float* work,
                     size_t* floats, int B, int t1, int c1, int vp, int kt, int n_terms,
                     int cheb, int c2, int act, int v_true, cudaStream_t s) {
  const bool gated = act == kGlu || act == kGtu;
  const int g2 = gated ? 2 * c2 : c2, t2 = t1 - kt + 1;
  const int n_c = n_terms + (cheb ? 1 : 0);
  const size_t lane = (size_t)B * vp;
  Carver w{work};
  float* h = w.take(lane * t1 * c1);
  float* dr = w.take(lane * t1 * c1);
  float* s2 = w.take(lane * t2 * g2);
  float* ds2 = w.take(lane * t2 * g2);
  float* dxin2 = w.take(lane * t2 * c2);
  const long long r1 = (long long)B * t1 * vp, r2 = (long long)B * t2 * vp;
  float* part = w.take(wgrad_part_floats({{kt * c1, g2, r2}, {1, g2, r2}, {c1, c1, r1},
                                          {1, c1, r1}}));
  if (floats) *floats = w.used;
  if (!work) return cudaSuccess;
  if (t2 < 1 || n_c < 1 || n_c > 3 || n_terms > 2) return cudaErrorInvalidValue;

  const float* terms[2] = {t_a, t_b};
  float* dterms[2] = {dt_a, dt_b};
  const float* ct[3] = {nullptr, nullptr, nullptr};  // contraction operands
  int m = 0;
  if (cheb) ct[m++] = xg;
  for (int i = 0; i < n_terms; ++i) ct[m++] = terms[i];
  const Cv none{nullptr, 0, 0};
  // h = relu(sum_m ct_m gcw[m] + gcb + xg)
  STGCN_TRY(launch_contract({{ct[0], ct[1], ct[2]}, t1, c1, gcw, n_c, 0, 0, gcb,
                             Cv{xg, t1, c1}, 0, 1, nullptr, h, B, t1, c1, vp}, s));
  // s2 = tconv2(h) + c2b
  STGCN_TRY(launch_contract({{h, nullptr, nullptr}, t1, c1, c2k, kt, 1, 0, c2b, none, 0, 0,
                             nullptr, s2, B, t2, g2, vp}, s));
  STGCN_TRY(launch_gate_bwd(s2, Cv{h, t1, c1}, kt - 1, ga2, gps, gpss, v_true, act, c2, ds2,
                            dxin2, nullptr, B, t2, vp, s));
  STGCN_TRY(launch_wgrad(Cv{h, t1, c1}, kt, Cv{ds2, t2, g2}, dc2k, part, B, vp, s));
  STGCN_TRY(launch_wgrad(Cv{nullptr, 0, 1}, 1, Cv{ds2, t2, g2}, dc2b, part, B, vp, s));
  // dr = (tconv2^T(ds2) + dxin2 shifted) * (h > 0)
  STGCN_TRY(launch_contract({{ds2, nullptr, nullptr}, t2, g2, c2k, kt, 1, 1, nullptr,
                             Cv{dxin2, t2, c2}, kt - 1, 0, h, dr, B, t1, c1, vp}, s));
  for (int i = 0; i < n_c; ++i)
    STGCN_TRY(launch_wgrad(Cv{ct[i], t1, c1}, 1, Cv{dr, t1, c1}, dgcw + (size_t)i * c1 * c1,
                           part, B, vp, s));
  STGCN_TRY(launch_wgrad(Cv{nullptr, 0, 1}, 1, Cv{dr, t1, c1}, dgcb, part, B, vp, s));
  // dxg = dr (+ dr . gcw[0]^T for Chebyshev, where xg is the term T_0)
  STGCN_TRY(launch_contract({{dr, nullptr, nullptr}, t1, c1, gcw, cheb ? 1 : 0, 0, 1, nullptr,
                             Cv{dr, t1, c1}, 0, 0, nullptr, dxg, B, t1, c1, vp}, s));
  for (int i = 0; i < n_terms; ++i) {
    const float* wi = gcw + (size_t)(i + (cheb ? 1 : 0)) * c1 * c1;
    STGCN_TRY(launch_contract({{dr, nullptr, nullptr}, t1, c1, wi, 1, 0, 1, nullptr, none, 0, 0,
                               nullptr, dterms[i], B, t1, c1, vp}, s));
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace stgcn

using namespace stgcn;

extern "C" {

// K1b. Outputs: dx [B, t_in, c_in, Vp]; with apply_ln also dmu, drstd
// [B, t_in] and dlng, dlnb [c_in, Vp]; dc1k [kt, c_in, g1], dc1b [g1],
// dgaw [c0, c1], dgab [c1]. work: stgcn_head_bwd_work(...) floats.
int stgcn_head_bwd(const float* x, const float* mu, const float* rstd, const float* lng,
                   const float* lnb, const float* c1k, const float* c1b, const float* gaw,
                   const float* gy, float* dx, float* dmu, float* drstd, float* dlng,
                   float* dlnb, float* dc1k, float* dc1b, float* dgaw, float* dgab, float* work,
                   int B, int t_in, int c_in, int vp, int kt, int c0, int c1, int act,
                   int apply_ln, int v_true, unsigned seed, int site, unsigned threshold,
                   float scale, void* stream) {
  return head_bwd(x, mu, rstd, lng, lnb, c1k, c1b, gaw, gy, dx, dmu, drstd, dlng, dlnb, dc1k,
                  dc1b, dgaw, dgab, work, nullptr, B, t_in, c_in, vp, kt, c0, c1, act,
                  apply_ln, make_drop(seed, site, threshold, scale, v_true),
                  static_cast<cudaStream_t>(stream));
}

long long stgcn_head_bwd_work(int B, int t_in, int c_in, int vp, int kt, int c0, int c1,
                              int act, int apply_ln) {
  size_t n = 0;
  head_bwd(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
           nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
           nullptr, &n, B, t_in, c_in, vp, kt, c0, c1, act, apply_ln,
           make_drop(0, 0, 0, 1.0f, vp), nullptr);
  return (long long)n;
}

// K2b. ga2 [B, t2, c2, Vp], gps/gpss [B, t2]. Outputs: dxg and the gradient of
// each of the n_terms graph terms (t_a, t_b) [B, t1, c1, Vp]; dgcw [n_c, c1,
// c1] (n_c = n_terms + cheb), dgcb [c1], dc2k [kt, c1, g2], dc2b [g2].
int stgcn_tail_bwd(const float* xg, const float* t_a, const float* t_b, const float* gcw,
                   const float* gcb, const float* c2k, const float* c2b, const float* ga2,
                   const float* gps, const float* gpss, float* dxg, float* dt_a, float* dt_b,
                   float* dgcw, float* dgcb, float* dc2k, float* dc2b, float* work, int B,
                   int t1, int c1, int vp, int kt, int n_terms, int cheb, int c2, int act,
                   int v_true, void* stream) {
  return tail_bwd(xg, t_a, t_b, gcw, gcb, c2k, c2b, ga2, gps, gpss, dxg, dt_a, dt_b, dgcw, dgcb,
                  dc2k, dc2b, work, nullptr, B, t1, c1, vp, kt, n_terms, cheb, c2, act, v_true,
                  static_cast<cudaStream_t>(stream));
}

long long stgcn_tail_bwd_work(int B, int t1, int c1, int vp, int kt, int n_terms, int cheb,
                              int c2, int act) {
  size_t n = 0;
  tail_bwd(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
           nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, &n,
           B, t1, c1, vp, kt, n_terms, cheb, c2, act, 0, nullptr);
  return (long long)n;
}

}  // extern "C"
