// Shared pieces of the port's hand-written Hopper kernels (sm_90a).
//
// Layout: every activation is channel-before-vertex ("cv"), [B, T, C, Vp],
// float32, with Vp a multiple of kLanes, so neighbouring threads take
// neighbouring vertex lanes and every activation load coalesces. K1-K4
// run their products on the gate GEMM (gate_gemm.cu), on the register tile
// of f32_tile.cuh as the backward passes do; the lane kernels (one thread
// per lane in blocks of kLanes: K2's and K12's h, K12b's later graph-term
// gradients) stage their weights in shared memory, read by the threads of a
// warp at one address (a broadcast, no bank conflict). Sums run in a fixed
// order: no atomics, so a launch repeated on the same inputs gives
// bit-identical output.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dropout.cuh"

namespace stgcn {

constexpr int kLanes = 128;          // vertex lanes (threads) per block
constexpr int kMaxOut = 16;          // narrow outputs (K1's c1, K2's c1, K4's fc2) a thread keeps
constexpr int kMaxSmem = 232448;     // shared memory a block may use on sm_90 (227 KB)

enum Act : int { kGlu = 0, kGtu = 1, kRelu = 2, kSilu = 3 };

// A dropout site as the C entry points receive it (four scalars) plus the
// true lane count of the dropped tensor.
inline Drop make_drop(unsigned seed, int site, unsigned threshold, float scale, int v_true) {
  return Drop{seed, site, threshold, scale, v_true};
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// Gate with the in-gate residual (`model/layers.py:105-115`): GLU/GTU take
// p (linear half) and q (gate half); relu/silu act on p + xin alone.
__device__ __forceinline__ float gate(int act, float p, float q, float xin) {
  const float z = p + xin;
  switch (act) {
    case kGlu: return z * sigmoid(q);
    case kGtu: return tanhf(z) * sigmoid(q);
    case kRelu: return fmaxf(z, 0.0f);
    default: return z * sigmoid(z);
  }
}

// The bf16 variants (precision="bfloat16" on the TPU: bf16 storage and
// operands, float32 sums, stgcn_tpu/kernels/vertex_fused.py:497-498): a
// bf16 value is widened exactly to float32, sums run in float32 as in the
// float32 kernels, and a value is rounded back to bf16 (to nearest even)
// wherever the TPU kernel rounds it.
using bf16 = __nv_bfloat16;

__host__ __device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }

// sigma(x) as the TPU's bf16 kernels compose it, tanh(x / 2) / 2 + 1 / 2
// (`_sigmoid`, stgcn_tpu/kernels/fused_stblock.py:182-189), each op rounded
__device__ __forceinline__ float sigmoid_bf16(float x) {
  return bf16r(bf16r(bf16r(tanhf(bf16r(x * 0.5f))) * 0.5f) + 0.5f);
}

// gate() of bf16 operands (p, q and xin bf16 values), rounding after each
// op as the TPU's bf16 gate does (`_gate_fwd_cv`, vertex_fused.py:280-303)
template <int ACT>
__device__ __forceinline__ float gate_bf16(float p, float q, float xin) {
  const float z = bf16r(p + xin);
  if constexpr (ACT == kGlu) return bf16r(z * sigmoid_bf16(q));
  if constexpr (ACT == kGtu) return bf16r(bf16r(tanhf(z)) * sigmoid_bf16(q));
  if constexpr (ACT == kRelu) return fmaxf(z, 0.0f);
  return bf16r(z * sigmoid_bf16(z));
}

// Sum over the block's threads in a fixed order; the result is valid in
// thread 0. `scratch` holds kLanes / 32 floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kLanes / 32; ++w) total += scratch[w];
  return total;
}

// Sums of s and of ss over the block's kLanes threads in a fixed order (each
// warp's by shuffles, then the warps in index order); the results are valid
// in thread 0. `scratch` holds 2 * kLanes / 32 floats of shared memory; the
// call's two barriers also end every read of shared memory made before it.
__device__ __forceinline__ void block_sum2(float& s, float& ss, float* scratch) {
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
    ss += __shfl_down_sync(0xffffffffu, ss, off);
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    scratch[2 * (threadIdx.x >> 5)] = s;
    scratch[2 * (threadIdx.x >> 5) + 1] = ss;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    s = ss = 0.0f;
    for (int w = 0; w < kLanes / 32; ++w) {
      s += scratch[2 * w];
      ss += scratch[2 * w + 1];
    }
  }
}

// Second pass of the LayerNorm partials: part is [rows][n][2] (sum, sum of
// squares) per block; ps[r], pss[r] are the sums over n, in a fixed order
// (one block a row: each thread sums a stride of n, then a tree).
cudaError_t launch_reduce_partials(const float* part, float* ps, float* pss, int rows, int n,
                                   cudaStream_t stream);

// The gate GEMM of K1-K4 (gate_gemm.cu; K2's conv 2): from x [B, t_in,
// c_in, Vp], conv weight w [kt*c_in, G] (G = 2*c0 gated, c0 otherwise) and
// bias wb [G], the gated a [B, t_out, c0, Vp] (t_out = t_in-kt+1), then
// either (part null) the second product y = a . ow + ob, ow [c0, n_out],
// ob [n_out], written to y [B, t_out, n_out, Vp]; or (part given: the
// LayerNorm-partial epilogue) a itself to y, with ps/pss [B, t_out] its sums
// and sums of squares over channels and the lanes v < v_true (part: scratch
// of B * t_out * ceil(c0 / 64) * (Vp / 64) * 2 floats).
// mu/rstd [B, t_in] and lng/lnb [c_in, Vp] are read only when apply_ln.
// drop_in masks the (normalized) input, keyed [B, t_in, c_in, V_true];
// drop_out masks the gated a before the second product, keyed
// [B, t_out, c0, V_true].
// The bf16 variant (launch_gate_gemm_bf16, gate_gemm_bf16.cu) takes bf16
// x, lng, lnb, w and ow (mu, rstd, wb, ob and the partials stay float32),
// and writes y in bf16, or (y_f32: K4's output) in float32.
struct GateGemmArgs {
  const void *x;
  const float *mu, *rstd;
  const void *lng, *lnb, *w;
  const float* wb;
  const void* ow;
  const float* ob;
  void* y;
  int batch, t_in, c_in, vp, kt, c0, n_out, act, apply_ln, residual;
  Drop drop_in, drop_out;
  float *part = nullptr, *ps = nullptr, *pss = nullptr;
  int v_true = 0;
};
cudaError_t launch_gate_gemm(const GateGemmArgs& args, cudaStream_t stream);
cudaError_t launch_gate_gemm_bf16(const GateGemmArgs& args, bool y_f32, cudaStream_t stream);

// h [B, t1, c1, Vp] = relu(gcb + sum over the n_c (1-3) graph-term
// operands ct[m] [B, t1, c1, Vp], then channels c, of ct[m][.., c, :]
// gcw[m, c, :] + xg), gcw [n_c, c1, c1], gcb [c1], c1 <= kMaxOut, one thread
// a lane (vertex_fused.cu): K2's first stage, K2b's recompute and K12's
// weight contraction. gcb null adds no bias; relu false leaves the sum as
// it is; xg may be h itself (K12 at Ks >= 4: a later launch of three terms
// adds onto the sum the first one left in h, the ReLU on the last launch).
cudaError_t launch_tail_h(const float* const (&ct)[3], int n_c, const float* gcw,
                          const float* gcb, const float* xg, float* h, int batch, int t1, int c1,
                          int vp, cudaStream_t stream, bool relu = true);

// Opt the kernel into `smem` bytes of dynamic shared memory, then check it fits.
template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace stgcn
