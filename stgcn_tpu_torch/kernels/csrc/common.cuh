// Shared pieces of the port's hand-written Hopper kernels (sm_90a).
//
// Layout: every activation is channel-before-vertex ("cv"), [B, T, C, Vp],
// float32, with Vp a multiple of kLanes, so neighbouring threads take
// neighbouring vertex lanes and every activation load coalesces. K2 and K3
// run one thread per lane in blocks of kLanes, their weights staged in
// shared memory and read by the threads of a warp at one address (a
// broadcast, no bank conflict); K1 and K4 share the gate GEMM (gate_gemm.cu)
// on the register tile of f32_tile.cuh, as the backward passes do. Sums run
// in a fixed order: no atomics, so a launch repeated on the same inputs
// gives bit-identical output.
#pragma once

#include <cuda_runtime.h>

#include "dropout.cuh"

namespace stgcn {

constexpr int kLanes = 128;          // vertex lanes (threads) per block
constexpr int kChunk = 16;           // gate channels whose sums a thread keeps in registers
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

// Stage chunks [j0, j0 + nch) of a gate conv weight w [rows, G] and its bias
// [G] (G = 2*c0 when gated, c0 otherwise) into shared memory as
// [rows][nch][2*kChunk]: per chunk, kChunk p-columns then kChunk q-columns,
// zero past c0 (and in the q half when not gated), so the inner loops need
// no bounds checks and padded channels come out of the gate as 0.
__device__ __forceinline__ void stage_gate_weight(float* w_s, float* b_s, const float* w,
                                                  const float* bias, int rows, int c0,
                                                  bool gated, int j0, int nch) {
  const int g = gated ? 2 * c0 : c0;
  const int wcols = nch * 2 * kChunk;
  for (int i = threadIdx.x; i < rows * wcols; i += blockDim.x) {
    const int row = i / wcols, col = i % wcols;
    const int c = (j0 + col / (2 * kChunk)) * kChunk + col % kChunk;
    const bool is_q = (col % (2 * kChunk)) >= kChunk;
    float val = 0.0f;
    if (c < c0 && (gated || !is_q)) val = w[(size_t)row * g + (is_q ? c0 + c : c)];
    w_s[i] = val;
  }
  for (int col = threadIdx.x; col < wcols; col += blockDim.x) {
    const int c = (j0 + col / (2 * kChunk)) * kChunk + col % kChunk;
    const bool is_q = (col % (2 * kChunk)) >= kChunk;
    b_s[col] = (c < c0 && (gated || !is_q)) ? bias[is_q ? c0 + c : c] : 0.0f;
  }
}

// p[i] += xv * w[i], q[i] += xv * w[kChunk + i] with w read as float4.
__device__ __forceinline__ void fma_chunk(float (&p)[kChunk], float (&q)[kChunk], float xv,
                                          const float* w) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int i = 0; i < kChunk / 4; ++i) {
    const float4 a = w4[i], b = w4[kChunk / 4 + i];
    p[4 * i + 0] = fmaf(xv, a.x, p[4 * i + 0]);
    p[4 * i + 1] = fmaf(xv, a.y, p[4 * i + 1]);
    p[4 * i + 2] = fmaf(xv, a.z, p[4 * i + 2]);
    p[4 * i + 3] = fmaf(xv, a.w, p[4 * i + 3]);
    q[4 * i + 0] = fmaf(xv, b.x, q[4 * i + 0]);
    q[4 * i + 1] = fmaf(xv, b.y, q[4 * i + 1]);
    q[4 * i + 2] = fmaf(xv, b.z, q[4 * i + 2]);
    q[4 * i + 3] = fmaf(xv, b.w, q[4 * i + 3]);
  }
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

// Second pass of the LayerNorm partials: part is [rows][n][2] (sum, sum of
// squares) per block; ps[r], pss[r] are the sums over n, in index order.
cudaError_t launch_reduce_partials(const float* part, float* ps, float* pss, int rows, int n,
                                   cudaStream_t stream);

// The gate GEMM shared by K1 and K4 (gate_gemm.cu): y [B, t_in-kt+1, n_out, Vp]
// from x [B, t_in, c_in, Vp], conv weight w [kt*c_in, G] (G = 2*c0 gated,
// c0 otherwise), bias wb [G], second product ow [c0, n_out], ob [n_out].
// mu/rstd [B, t_in] and lng/lnb [c_in, Vp] are read only when apply_ln.
// drop_in masks the (normalized) input, keyed [B, t_in, c_in, V_true];
// drop_out masks the gated a, keyed [B, t_out, c0, V_true].
struct GateGemmArgs {
  const float *x, *mu, *rstd, *lng, *lnb, *w, *wb, *ow, *ob;
  float* y;
  int batch, t_in, c_in, vp, kt, c0, n_out, act, apply_ln, residual;
  Drop drop_in, drop_out;
};
cudaError_t launch_gate_gemm(const GateGemmArgs& args, cudaStream_t stream);

// Opt the kernel into `smem` bytes of dynamic shared memory, then check it fits.
template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace stgcn
