// K1 (block head) and K2 (block tail) of one STGCN ST block, forward: the
// C entry points, and K2's kernel. K1's body is the gate GEMM (gate_gemm.cu).
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
// What bounds K2 on the H100: at the STGCN widths (c1 16, gate width 128)
// it does some 30 float32 FMAs per byte it must move, above the card's
// float32 balance point (67 TFLOP/s over 3.35 TB/s, about 20 FLOP/byte), so
// it is bound by FMA issue. One thread per vertex lane first forms the
// ReLU'd graph-conv output h for the kt steps it needs (in shared memory,
// its own column), then holds 32 running sums (16 gate channels and their
// gate partners) in registers; every h value feeds 32 FMAs and the weights
// come from shared memory as float4 broadcasts.
//
// The TPU tail accumulates the LayerNorm partials in an output block that
// stays resident across its sequential vertex grid. CUDA blocks run in no
// order, so K2 writes one partial per (b, t, vertex tile) and a second small
// pass sums them in index order: no atomics, bit-identical on repeat.
#include "common.cuh"

namespace stgcn {

__global__ void reduce_partials_kernel(const float* __restrict__ part, float* __restrict__ ps,
                                       float* __restrict__ pss, int rows, int n) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float s = 0.0f, ss = 0.0f;
  for (int i = 0; i < n; ++i) {
    s += part[((size_t)r * n + i) * 2];
    ss += part[((size_t)r * n + i) * 2 + 1];
  }
  ps[r] = s;
  pss[r] = ss;
}

cudaError_t launch_reduce_partials(const float* part, float* ps, float* pss, int rows, int n,
                                   cudaStream_t stream) {
  reduce_partials_kernel<<<(rows + 127) / 128, 128, 0, stream>>>(part, ps, pss, rows, n);
  return cudaGetLastError();
}

// out[o] += a * row[o] for o < kMaxOut (row 16-byte aligned).
__device__ __forceinline__ void fma_row(float (&out)[kMaxOut], float a, const float* row) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int i = 0; i < kMaxOut / 4; ++i) {
    const float4 w = r4[i];
    out[4 * i + 0] = fmaf(a, w.x, out[4 * i + 0]);
    out[4 * i + 1] = fmaf(a, w.y, out[4 * i + 1]);
    out[4 * i + 2] = fmaf(a, w.z, out[4 * i + 2]);
    out[4 * i + 3] = fmaf(a, w.w, out[4 * i + 3]);
  }
}

// grid (Vp / kLanes, T2, B). cterms: n_c operands [B, T1, c1, Vp] of the
// weight contraction (xg, T1, T2 for Chebyshev order 3). Writes a2
// [B, T2, c2, Vp] and part [B, T2, nvt, 2].
__global__ void __launch_bounds__(kLanes)
tail_fwd_kernel(const float* __restrict__ xg, const float* __restrict__ ct0,
                const float* __restrict__ ct1, const float* __restrict__ ct2,
                const float* __restrict__ gcw, const float* __restrict__ gcb,
                const float* __restrict__ c2k, const float* __restrict__ c2b,
                float* __restrict__ a2, float* __restrict__ part, int t1, int c1, int vp,
                int kt, int n_c, int c2, int act, int v_true) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const bool gated = act == kGlu || act == kGtu;
  const int nch = (c2 + kChunk - 1) / kChunk;
  const int wcols = nch * 2 * kChunk;
  const int rows = kt * c1;
  float* w_s = smem;                     // [rows][wcols] conv-2 weight
  float* b_s = w_s + rows * wcols;       // [wcols]
  float* g_s = b_s + wcols;              // [n_c * c1][kMaxOut] contraction weight
  float* gb_s = g_s + n_c * c1 * kMaxOut;    // [kMaxOut]
  float* h_s = gb_s + kMaxOut;               // [kt * c1][kLanes] this thread's h column
  float* red = h_s + rows * kLanes;      // [kLanes / 32]
  stage_gate_weight(w_s, b_s, c2k, c2b, rows, c2, gated, 0, nch);
  for (int i = threadIdx.x; i < n_c * c1 * kMaxOut; i += blockDim.x) {
    const int row = i / kMaxOut, o = i % kMaxOut;
    g_s[i] = o < c1 ? gcw[row * c1 + o] : 0.0f;
  }
  for (int o = threadIdx.x; o < kMaxOut; o += blockDim.x) gb_s[o] = o < c1 ? gcb[o] : 0.0f;
  __syncthreads();

  const int v = blockIdx.x * kLanes + threadIdx.x;
  const int t = blockIdx.y, b = blockIdx.z;
  const int t2 = t1 - kt + 1;
  const float* cts[3] = {ct0, ct1, ct2};

  // h = relu(sum_m cterm_m gcw[m] + gcb + xg) at steps t .. t+kt-1
  for (int k = 0; k < kt; ++k) {
    const size_t base = (size_t)(b * t1 + t + k) * c1 * vp + v;
    float gc[kMaxOut];
#pragma unroll
    for (int o = 0; o < kMaxOut; ++o) gc[o] = gb_s[o];
    for (int m = 0; m < n_c; ++m)
      for (int c = 0; c < c1; ++c)
        fma_row(gc, cts[m][base + (size_t)c * vp], g_s + (m * c1 + c) * kMaxOut);
#pragma unroll
    for (int o = 0; o < kMaxOut; ++o)
      if (o < c1) h_s[(k * c1 + o) * kLanes + threadIdx.x] = fmaxf(gc[o] + xg[base + (size_t)o * vp], 0.0f);
  }

  const bool live = v < v_true;
  float s = 0.0f, ss = 0.0f;
  float* yb = a2 + (size_t)(b * t2 + t) * c2 * vp + v;
  for (int j = 0; j < nch; ++j) {
    float p[kChunk], q[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      p[i] = b_s[j * 2 * kChunk + i];
      q[i] = b_s[j * 2 * kChunk + kChunk + i];
    }
    for (int r = 0; r < rows; ++r)
      fma_chunk(p, q, h_s[r * kLanes + threadIdx.x], w_s + (size_t)r * wcols + j * 2 * kChunk);
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int c = j * kChunk + i;
      if (c < c2) {
        const float xin = c < c1 ? h_s[((kt - 1) * c1 + c) * kLanes + threadIdx.x] : 0.0f;
        const float a = gate(act, p[i], q[i], xin);
        yb[(size_t)c * vp] = a;
        if (live) {
          s += a;
          ss += a * a;
        }
      }
    }
  }
  s = block_sum(s, red);
  ss = block_sum(ss, red);
  if (threadIdx.x == 0) {
    const size_t idx = ((size_t)(b * t2 + t) * gridDim.x + blockIdx.x) * 2;
    part[idx] = s;
    part[idx + 1] = ss;
  }
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

// part: scratch [B, T2, Vp / 128, 2]; ps, pss: [B, T2]. c1 must be at most 16.
int stgcn_tail_fwd(const float* xg, const float* ct0, const float* ct1, const float* ct2,
                   const float* gcw, const float* gcb, const float* c2k, const float* c2b,
                   float* a2, float* part, float* ps, float* pss, int B, int t1, int c1, int vp,
                   int kt, int n_c, int c2, int act, int v_true, void* stream) {
  if (c1 > kMaxOut) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int nch = (c2 + kChunk - 1) / kChunk;
  const int wcols = nch * 2 * kChunk;
  const size_t smem = sizeof(float) * ((size_t)kt * c1 * wcols + wcols + n_c * c1 * kMaxOut +
                                       kMaxOut + (size_t)kt * c1 * kLanes + kLanes / 32);
  cudaError_t err = set_smem(tail_fwd_kernel, smem);
  if (err != cudaSuccess) return err;
  const int t2 = t1 - kt + 1;
  tail_fwd_kernel<<<dim3(vp / kLanes, t2, B), kLanes, smem, s>>>(
      xg, ct0, ct1, ct2, gcw, gcb, c2k, c2b, a2, part, t1, c1, vp, kt, n_c, c2, act, v_true);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce_partials(part, ps, pss, B * t2, vp / kLanes, s);
}

}  // extern "C"
