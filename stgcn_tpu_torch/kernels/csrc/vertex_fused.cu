// K1 (block head) and K2 (block tail) of one STGCN ST block, forward: the
// C entry points, K2's first stage (tail_h_kernel, which K2b's recompute
// and K12's forward, st_forward of fused_stblock.cu, share) and the second
// pass of the LayerNorm partials that K2, K3 and K12 write. K1's body and
// K2's conv 2 are the gate GEMM (gate_gemm.cu, on the register tile of
// f32_tile.cuh).
//
// Replaces the TPU kernels stgcn_tpu/kernels/vertex_fused.py `_head_pallas`
// (:610, body `_make_head_fwd_kernel` :505 / `_head_core` :393) and
// `_tail_pallas` (:839, body `_make_tail_fwd_kernel` :769 / `_tail_core` :423).
//
// K1: [previous block's LayerNorm normalize] -> kt-tap causal temporal conv
//     -> GLU/GTU/relu/silu gate with the in-gate residual -> align dot c0->c1.
// K2: Chebyshev weight contraction sum_k T_k gcw[k] + bias -> + xg residual
//     -> ReLU -> temporal conv 2 -> gate, plus the LayerNorm partial sums
//     (sum, sum of squares over channels and true vertex lanes) per (b, t).
//
// What bounds K2 on the H100: float32 FMA issue. At the STGCN widths (c1 16,
// c2 64 gated, kt 3, three graph terms) a lane costs 768 FMAs a step for h
// and 6144 for conv 2, about 30 FMAs per byte it must move, above the card's
// float32 balance point (67 TFLOP/s over 3.35 TB/s, about 20 FLOP/byte).
// The lane kernel this replaced formed h kt times (once for each output
// step whose window holds it) and ran conv 2 as 16-channel chunks from
// shared memory, at a sixth of the f32 peak. K2 now runs in two launches:
// tail_h_kernel forms h once, one thread a lane (its 2 GB round trip at
// 100k block 1 costs less than its FMAs would at the lane kernel's rate),
// then the gate GEMM runs conv 2 on the tile (kt*c1 = 48 rows staged in
// three pieces, 128 gate rows x 64 lanes a block) with the LayerNorm-
// partial epilogue: the gate with the in-gate residual (h's newest step,
// zero-padded to c2), a2, and one partial per (b, t, pass, 64-lane tile).
// A single kernel that walked each block's output steps over a ring of h
// in shared memory (conv 2's weights resident, h never in device memory)
// was slower at every shape (PERF.md §6): its steps serialize the h
// chain, conv 2 and the epilogue behind four barriers, and at PeMSD7(M)
// each block restaged the weights for one or two steps.
//
// The TPU tail accumulates the LayerNorm partials in an output block that
// stays resident across its sequential vertex grid. CUDA blocks run in no
// order, so K2 (and K3) write one partial per (b, t, lane tile) and a second
// small pass sums them in a fixed order: no atomics, bit-identical on
// repeat.
#include <type_traits>

#include "common.cuh"

namespace stgcn {

// grid (Vp / kLanes, t1, B), one thread per lane:
//   h[b, t, o, v] = relu(gcb[o] + sum over terms m, then c < c1, of
//                   ct_m[b, t, c, v] gcw[m, c, o] + xg[b, t, o, v])
// (bias first, then m and c ascending, the residual last). A term's c1
// loads, and the residual's, are issued before its FMAs. gcb may be null
// (no bias) and relu 0 (none): K12 at Ks >= 4 sums its terms three a launch,
// the later launches adding onto h (xg == h: each thread reads the residual
// it overwrites, and nothing else of h). T = bf16 (K2f's bf16 variant):
// bf16 operands and weights widened into the same float32 sums, then, as
// the TPU's `_tail_core` (vertex_fused.py:423-442), the contraction rounded
// to bf16 before the residual, the residual a bf16 add, h stored in bf16.
template <typename T>
__global__ void __launch_bounds__(kLanes)
tail_h_kernel(const T* __restrict__ ct0, const T* __restrict__ ct1, const T* __restrict__ ct2,
              const T* __restrict__ gcw, const float* __restrict__ gcb, const T* xg, T* h,
              int t1, int c1, int vp, int n_c, int relu) {
  __shared__ __align__(16) float w_s[3 * kMaxOut][kMaxOut];   // gcw[m, c, :], zero past c1
  __shared__ float b_s[kMaxOut];
  for (int i = threadIdx.x; i < 3 * kMaxOut * kMaxOut; i += kLanes) {
    const int m = i / (kMaxOut * kMaxOut), c = i / kMaxOut % kMaxOut, o = i % kMaxOut;
    w_s[m * kMaxOut + c][o] =
        m < n_c && c < c1 && o < c1 ? widen(gcw[((size_t)m * c1 + c) * c1 + o]) : 0.0f;
  }
  if (threadIdx.x < kMaxOut)
    b_s[threadIdx.x] = gcb && (int)threadIdx.x < c1 ? gcb[threadIdx.x] : 0.0f;
  __syncthreads();
  const int v = blockIdx.x * kLanes + threadIdx.x, t = blockIdx.y, b = blockIdx.z;
  const size_t row0 = (size_t)(b * t1 + t) * c1;
  float acc[kMaxOut], res[kMaxOut];
#pragma unroll
  for (int o = 0; o < kMaxOut; ++o) {
    acc[o] = b_s[o];
    res[o] = o < c1 ? widen(xg[(row0 + o) * vp + v]) : 0.0f;
  }
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    if (m >= n_c) break;
    const T* xr = (m == 0 ? ct0 : m == 1 ? ct1 : ct2) + row0 * vp + v;
    float xv[kMaxOut];
#pragma unroll
    for (int c = 0; c < kMaxOut; ++c) xv[c] = c < c1 ? widen(xr[(size_t)c * vp]) : 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxOut; ++c) {
      if (c >= c1) break;
      const float4* w4 = reinterpret_cast<const float4*>(w_s[m * kMaxOut + c]);
#pragma unroll
      for (int q = 0; q < kMaxOut / 4; ++q) {
        const float4 wq = w4[q];
        acc[4 * q + 0] = fmaf(xv[c], wq.x, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(xv[c], wq.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(xv[c], wq.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(xv[c], wq.w, acc[4 * q + 3]);
      }
    }
  }
#pragma unroll
  for (int o = 0; o < kMaxOut; ++o) {
    if (o >= c1) break;
    if constexpr (std::is_same<T, float>::value) {
      const float z = acc[o] + res[o];
      h[(row0 + o) * vp + v] = relu ? fmaxf(z, 0.0f) : z;
    } else {
      const float z = bf16r(bf16r(acc[o]) + res[o]);
      h[(row0 + o) * vp + v] = __float2bfloat16_rn(relu ? fmaxf(z, 0.0f) : z);
    }
  }
}

template <typename T>
cudaError_t tail_h_run(const T* const (&ct)[3], int n_c, const T* gcw, const float* gcb,
                       const T* xg, T* h, int batch, int t1, int c1, int vp,
                       cudaStream_t stream, bool relu) {
  if (vp % kLanes != 0 || c1 > kMaxOut || n_c < 1 || n_c > 3) return cudaErrorInvalidValue;
  tail_h_kernel<T><<<dim3(vp / kLanes, t1, batch), kLanes, 0, stream>>>(
      ct[0], ct[1], ct[2], gcw, gcb, xg, h, t1, c1, vp, n_c, relu ? 1 : 0);
  return cudaGetLastError();
}

cudaError_t launch_tail_h(const float* const (&ct)[3], int n_c, const float* gcw,
                          const float* gcb, const float* xg, float* h, int batch, int t1, int c1,
                          int vp, cudaStream_t stream, bool relu) {
  return tail_h_run<float>(ct, n_c, gcw, gcb, xg, h, batch, t1, c1, vp, stream, relu);
}

cudaError_t launch_tail_h_bf16(const bf16* const (&ct)[3], int n_c, const bf16* gcw,
                               const float* gcb, const bf16* xg, bf16* h, int batch, int t1,
                               int c1, int vp, cudaStream_t stream) {
  return tail_h_run<bf16>(ct, n_c, gcw, gcb, xg, h, batch, t1, c1, vp, stream, true);
}

// one block a row: thread i sums partials i, i + 256, .. in order, then a
// fixed tree over the threads
constexpr int kReduceThreads = 256;

__global__ void __launch_bounds__(kReduceThreads)
reduce_partials_kernel(const float* __restrict__ part, float* __restrict__ ps,
                       float* __restrict__ pss, int n) {
  __shared__ float2 sh[kReduceThreads];
  const int r = blockIdx.x;
  const float2* row = reinterpret_cast<const float2*>(part) + (size_t)r * n;
  float2 acc = make_float2(0.0f, 0.0f);
  for (int i = threadIdx.x; i < n; i += kReduceThreads) {
    const float2 p = row[i];
    acc.x += p.x;
    acc.y += p.y;
  }
  sh[threadIdx.x] = acc;
  __syncthreads();
  for (int half = kReduceThreads / 2; half > 0; half /= 2) {
    if ((int)threadIdx.x < half) {
      sh[threadIdx.x].x += sh[threadIdx.x + half].x;
      sh[threadIdx.x].y += sh[threadIdx.x + half].y;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    ps[r] = sh[0].x;
    pss[r] = sh[0].y;
  }
}

cudaError_t launch_reduce_partials(const float* part, float* ps, float* pss, int rows, int n,
                                   cudaStream_t stream) {
  reduce_partials_kernel<<<rows, kReduceThreads, 0, stream>>>(part, ps, pss, n);
  return cudaGetLastError();
}


}  // namespace stgcn

using namespace stgcn;

extern "C" {

const char* stgcn_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// K1: xg [B, t_in-kt+1, c1, Vp] (gate_gemm.cu). c1 must be at most 16. The
// dropout site (seed, site, threshold, scale) masks the normalized input;
// threshold 0 turns it off.
int stgcn_head_fwd(const float* x, const float* mu, const float* rstd, const float* lng,
                   const float* lnb, const float* c1k, const float* c1b, const float* gaw,
                   const float* gab, float* xg, int B, int t_in, int c_in, int vp, int kt,
                   int c0, int c1, int act, int apply_ln, int v_true, unsigned seed, int site,
                   unsigned threshold, float scale, void* stream) {
  const GateGemmArgs args{x,  mu, rstd, lng,  lnb, c1k, c1b, gaw, gab,      xg,
                          B,  t_in, c_in, vp, kt,  c0,  c1,  act, apply_ln, 1,
                          make_drop(seed, site, threshold, scale, v_true),
                          make_drop(0, 0, 0, 1.0f, v_true)};
  return launch_gate_gemm(args, static_cast<cudaStream_t>(stream));
}

// K2: h (tail_h_kernel), then conv 2 and the gate on the gate GEMM with the
// LayerNorm-partial epilogue. a2 [B, T2, c2, Vp]; ps, pss: [B, T2]; h:
// scratch [B, t1, c1, Vp]; part: scratch of B * T2 * ceil(c2 / 64) *
// (Vp / 64) * 2 floats. c1 must be at most 16; ct1, ct2 are read only when
// n_c > 1, > 2.
int stgcn_tail_fwd(const float* xg, const float* ct0, const float* ct1, const float* ct2,
                   const float* gcw, const float* gcb, const float* c2k, const float* c2b,
                   float* a2, float* h, float* part, float* ps, float* pss, int B, int t1,
                   int c1, int vp, int kt, int n_c, int c2, int act, int v_true, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const float* ct[3] = {ct0, ct1, ct2};
  const cudaError_t err = launch_tail_h(ct, n_c, gcw, gcb, xg, h, B, t1, c1, vp, s);
  if (err != cudaSuccess) return err;
  const Drop none = make_drop(0, 0, 0, 1.0f, v_true);
  const GateGemmArgs args{h, nullptr, nullptr, nullptr, nullptr, c2k, c2b, nullptr, nullptr, a2,
                          B, t1, c1, vp, kt, c2, 0, act, 0, 1, none, none, part, ps, pss, v_true};
  return launch_gate_gemm(args, s);
}

// The bf16 variants (the TPU kernels' precision="bfloat16" build): x, ct*,
// xg, the weights c1k, gaw, gcw, c2k, and the outputs xg, a2 and the h
// scratch are bf16; mu, rstd, the biases, the partials and ps, pss float32;
// lng, lnb bf16. Otherwise as above. The dropout scale is rounded to bf16.
int stgcn_head_fwd_bf16(const void* x, const float* mu, const float* rstd, const void* lng,
                        const void* lnb, const void* c1k, const float* c1b, const void* gaw,
                        const float* gab, void* xg, int B, int t_in, int c_in, int vp, int kt,
                        int c0, int c1, int act, int apply_ln, int v_true, unsigned seed,
                        int site, unsigned threshold, float scale, void* stream) {
  const GateGemmArgs args{x,  mu, rstd, lng,  lnb, c1k, c1b, gaw, gab,      xg,
                          B,  t_in, c_in, vp, kt,  c0,  c1,  act, apply_ln, 1,
                          make_drop(seed, site, threshold, scale, v_true),
                          make_drop(0, 0, 0, 1.0f, v_true)};
  return launch_gate_gemm_bf16(args, false, static_cast<cudaStream_t>(stream));
}

int stgcn_tail_fwd_bf16(const void* xg, const void* ct0, const void* ct1, const void* ct2,
                        const void* gcw, const float* gcb, const void* c2k, const float* c2b,
                        void* a2, void* h, float* part, float* ps, float* pss, int B, int t1,
                        int c1, int vp, int kt, int n_c, int c2, int act, int v_true,
                        void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const bf16* ct[3] = {static_cast<const bf16*>(ct0), static_cast<const bf16*>(ct1),
                       static_cast<const bf16*>(ct2)};
  const cudaError_t err =
      launch_tail_h_bf16(ct, n_c, static_cast<const bf16*>(gcw), gcb,
                         static_cast<const bf16*>(xg), static_cast<bf16*>(h), B, t1, c1, vp, s);
  if (err != cudaSuccess) return err;
  const Drop none = make_drop(0, 0, 0, 1.0f, v_true);
  const GateGemmArgs args{h, nullptr, nullptr, nullptr, nullptr, c2k, c2b, nullptr, nullptr, a2,
                          B, t1, c1, vp, kt, c2, 0, act, 0, 1, none, none, part, ps, pss, v_true};
  return launch_gate_gemm_bf16(args, false, s);
}

}  // extern "C"
