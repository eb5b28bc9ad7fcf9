// The row walk over a pack's nonzero index (kernels/nnz_index.py) that K10
// (bcsr_spmm.cu) and K6 (ell_nv.cu) share.
//
// G lanes of a warp (G = 16 or 32) sum one output row over its nonzeros
// beg..end: the lanes load G (src, value) pairs at once, the value read
// from the tiles at its offset (int8 widened to float32), and broadcast
// them by shuffle; for each pair the group reads the operand row
// x[src, 0:n] coalesced, float4 steps where VEC, scalar ones otherwise.
// Each output column is one fmaf chain in the index's order (ascending
// source vertex), so a repeat launch is bit-identical; the caller applies
// its scale and epilogue after the sum.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace csr_rows {

template <bool VEC>
struct Cols;
template <>
struct Cols<true> {   // four columns a lane step
  using T = float4;
  static constexpr int kWidth = 4;
  __device__ static T zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
  __device__ static void fma(float v, const float* xr, int c, T& acc) {
    const float4 xv = *reinterpret_cast<const float4*>(xr + c);
    acc.x = fmaf(v, xv.x, acc.x);
    acc.y = fmaf(v, xv.y, acc.y);
    acc.z = fmaf(v, xv.z, acc.z);
    acc.w = fmaf(v, xv.w, acc.w);
  }
};
template <>
struct Cols<false> {  // one column a lane step
  using T = float;
  static constexpr int kWidth = 1;
  __device__ static T zero() { return 0.0f; }
  __device__ static void fma(float v, const float* xr, int c, T& acc) {
    acc = fmaf(v, xr[c], acc);
  }
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(int8_t v) { return (float)v; }

// acc[q] = sum_{e in beg..end} widen(vals[off[e]]) * x[src[e], c] for the
// lane's columns c = c0 + width * (lane + G * q) below n; x is [rows, n]
// row-major (16-byte aligned with n % 4 == 0 where VEC). Every lane of the
// group calls it with the same row.
template <int G, int CPL, bool VEC, typename V>
__device__ __forceinline__ void row_sums(const V* __restrict__ vals, const int* __restrict__ src,
                                         const int* __restrict__ off, int beg, int end,
                                         const float* __restrict__ x, int n, int c0, int lane,
                                         typename Cols<VEC>::T (&acc)[CPL]) {
  using C = Cols<VEC>;
  const unsigned mask = G == 32 ? 0xffffffffu : (0xffffu << (threadIdx.x & 16));
#pragma unroll
  for (int q = 0; q < CPL; ++q) acc[q] = C::zero();
  for (int e0 = beg; e0 < end; e0 += G) {
    int s = 0;
    float v = 0.0f;
    if (e0 + lane < end) {
      s = src[e0 + lane];
      v = widen(vals[off[e0 + lane]]);
    }
    const int cnt = min(G, end - e0);
    for (int t = 0; t < cnt; ++t) {
      const float* xr = x + (size_t)__shfl_sync(mask, s, t, G) * n;
      const float vt = __shfl_sync(mask, v, t, G);
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const int c = c0 + C::kWidth * (lane + G * q);
        if (c < n) C::fma(vt, xr, c, acc[q]);
      }
    }
  }
}

}  // namespace csr_rows
