// The row walk over a pack's nonzero index (kernels/nnz_index.py) that K10
// (bcsr_spmm.cu), the banded vn kernel of K7-K9 (banded_vn.cu), and through
// nv_rows.cuh K6 (ell_nv.cu) and K5 (banded_nv.cu) share.
//
// G lanes of a warp (G = 16 or 32) sum one output row over its nonzeros
// beg..end: the lanes load G (src, value) pairs at once, the value read
// from the pack at its offset (int8 and bf16 widened to float32, exactly),
// and broadcast them by shuffle; for each pair the group reads the operand
// row x[src, 0:n] coalesced, 16-byte vectors where VEC (four float32, or
// eight bf16 widened to float32), scalar steps otherwise. Each output
// column is one float32 fmaf chain in the index's order (ascending source
// vertex), so a repeat launch is bit-identical; the caller applies its
// scale and epilogue after the sum, in float32, and rounds once to the
// operand's type.
//
// vn_modes is the whole vn kernel (one application, or the Chebyshev pair
// and its VJP chain as two passes), on row-major [rows, n] operands of
// float32 or bf16 (X), over float32, int8 or bf16 values (T).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace csr_rows {

using bf16 = __nv_bfloat16;

// eight float32 sums: the columns of one 16-byte bf16 vector
struct F8 {
  float v[8];
};

template <bool VEC, typename X = float>
struct Cols;
template <>
struct Cols<true, float> {   // four columns a lane step
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
struct Cols<false, float> {  // one column a lane step
  using T = float;
  static constexpr int kWidth = 1;
  __device__ static T zero() { return 0.0f; }
  __device__ static void fma(float v, const float* xr, int c, T& acc) {
    acc = fmaf(v, xr[c], acc);
  }
};
template <>
struct Cols<true, bf16> {    // eight bf16 columns a lane step, one 16-byte load
  using T = F8;
  static constexpr int kWidth = 8;
  __device__ static T zero() {
    T z;
#pragma unroll
    for (int j = 0; j < 8; ++j) z.v[j] = 0.0f;
    return z;
  }
  __device__ static void fma(float v, const bf16* xr, int c, T& acc) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      acc.v[2 * j] = fmaf(v, f.x, acc.v[2 * j]);
      acc.v[2 * j + 1] = fmaf(v, f.y, acc.v[2 * j + 1]);
    }
  }
};
template <>
struct Cols<false, bf16> {   // one bf16 column a lane step
  using T = float;
  static constexpr int kWidth = 1;
  __device__ static T zero() { return 0.0f; }
  __device__ static void fma(float v, const bf16* xr, int c, T& acc) {
    acc = fmaf(v, __bfloat162float(xr[c]), acc);
  }
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(int8_t v) { return (float)v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }

// acc[q] = sum_{e in beg..end} widen(vals[off[e]]) * x[src[e], c] for the
// lane's columns c = c0 + width * (lane + G * q) below n; x is [rows, n]
// row-major (16-byte aligned with n % width == 0 where VEC). Every lane of
// the group calls it with the same row.
template <int G, int CPL, bool VEC, typename V, typename X>
__device__ __forceinline__ void row_sums(const V* __restrict__ vals, const int* __restrict__ src,
                                         const int* __restrict__ off, int beg, int end,
                                         const X* __restrict__ x, int n, int c0, int lane,
                                         typename Cols<VEC, X>::T (&acc)[CPL]) {
  using C = Cols<VEC, X>;
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
      const X* xr = x + (size_t)__shfl_sync(mask, s, t, G) * n;
      const float vt = __shfl_sync(mask, v, t, G);
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const int c = c0 + C::kWidth * (lane + G * q);
        if (c < n) C::fma(vt, xr, c, acc[q]);
      }
    }
  }
}

// One vn pass: out = round_X(alpha * (A x) * s + beta * add), every operand
// [rows, n] row-major in X (float32 or bf16), the epilogue in float32 and
// one rounding to X after it (none for float32). Block row i's values start
// at vals + i * row_stride (a BCSR block row's tiles, a slab); s the per-row
// dequant factor of an int8 pack (scales [live_rows], 1 for float32 and
// bf16 and for rows past live_rows, whose index rows are empty); add may be
// null (no term).
template <typename T, typename X = float>
struct VnPass {
  const T* vals;
  size_t row_stride;
  const int* row_ptr;   // [rows + 1]
  const int* src;       // [nnz], every src < the rows of x
  const int* off;       // [nnz]
  const float* scales;  // [live_rows] or null
  int live_rows;
  const X* x;
  const X* add;
  X* out;
  int rows, bs, n;
  float alpha, beta;
};

template <typename X>
__device__ __forceinline__ float finish(float acc, float s, bool scaled, float alpha, float beta,
                                        const X* add, size_t o) {
  const float v = alpha * (scaled ? acc * s : acc);
  return add != nullptr ? fmaf(beta, widen(add[o]), v) : v;
}
__device__ __forceinline__ void store(float* out, size_t o, float v) { out[o] = v; }
__device__ __forceinline__ void store(bf16* out, size_t o, float v) {
  out[o] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void finish_store(const float4& acc, float s, bool scaled,
                                             float alpha, float beta, const float* add,
                                             float* out, size_t o) {
  *reinterpret_cast<float4*>(out + o) =
      make_float4(finish(acc.x, s, scaled, alpha, beta, add, o),
                  finish(acc.y, s, scaled, alpha, beta, add, o + 1),
                  finish(acc.z, s, scaled, alpha, beta, add, o + 2),
                  finish(acc.w, s, scaled, alpha, beta, add, o + 3));
}
__device__ __forceinline__ void finish_store(const F8& acc, float s, bool scaled, float alpha,
                                             float beta, const bf16* add, bf16* out, size_t o) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    h[j] = __floats2bfloat162_rn(finish(acc.v[2 * j], s, scaled, alpha, beta, add, o + 2 * j),
                                 finish(acc.v[2 * j + 1], s, scaled, alpha, beta, add,
                                        o + 2 * j + 1));
  *reinterpret_cast<uint4*>(out + o) = raw;
}
template <typename X>
__device__ __forceinline__ void finish_store(float acc, float s, bool scaled, float alpha,
                                             float beta, const X* add, X* out, size_t o) {
  store(out, o, finish(acc, s, scaled, alpha, beta, add, o));
}

namespace {   // internal linkage: each source that includes this instantiates its own

constexpr int kVnThreads = 256;

// G lanes per output row; a lane owns CPL column steps of a chunk of
// G * CPL * width columns. A group's lanes share its row, so a group past
// `rows` returns whole.
template <int G, int CPL, bool VEC, typename T, typename X>
__global__ void __launch_bounds__(kVnThreads) vn_rows_kernel(VnPass<T, X> a) {
  using C = Cols<VEC, X>;
  const int row = blockIdx.x * (kVnThreads / G) + threadIdx.x / G;
  if (row >= a.rows) return;
  const int lane = threadIdx.x % G;
  const int beg = a.row_ptr[row], end = a.row_ptr[row + 1];
  const T* vals = a.vals + (size_t)(row / a.bs) * a.row_stride;
  const bool scaled = a.scales != nullptr;
  const float s = scaled && row < a.live_rows ? a.scales[row] : 1.0f;
  const size_t o = (size_t)row * a.n;
  constexpr int kChunk = G * CPL * C::kWidth;
  for (int c0 = 0; c0 < a.n; c0 += kChunk) {
    typename C::T acc[CPL];
    row_sums<G, CPL, VEC>(vals, a.src, a.off, beg, end, a.x, a.n, c0, lane, acc);
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      const int c = c0 + C::kWidth * (lane + G * q);
      if (c < a.n) finish_store(acc[q], s, scaled, a.alpha, a.beta, a.add, a.out, o + c);
    }
  }
}

template <int G, int CPL, bool VEC, typename T, typename X>
cudaError_t vn_launch(const VnPass<T, X>& a, cudaStream_t s) {
  const unsigned blocks = (unsigned)((a.rows + kVnThreads / G - 1) / (kVnThreads / G));
  vn_rows_kernel<G, CPL, VEC, T, X><<<blocks, kVnThreads, 0, s>>>(a);
  return cudaGetLastError();
}

// column steps a lane needs for `steps` steps of a row, 1, 2 or 4 (wider
// rows loop over chunks)
template <int G, bool VEC, typename T, typename X>
cudaError_t vn_dispatch(const VnPass<T, X>& a, cudaStream_t s) {
  const int steps = a.n / Cols<VEC, X>::kWidth;
  if (steps <= G) return vn_launch<G, 1, VEC>(a, s);
  if (steps <= 2 * G) return vn_launch<G, 2, VEC>(a, s);
  return vn_launch<G, 4, VEC>(a, s);
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// One pass at any n and alignment: 16-byte vector steps (four float32 or
// eight bf16 columns) where n is a multiple of the vector and x and out are
// 16-byte aligned; a half-warp a row where n <= 64.
template <typename T, typename X>
cudaError_t vn_pass(const VnPass<T, X>& a, cudaStream_t s) {
  if (a.rows == 0 || a.n == 0) return cudaSuccess;
  const bool vec = a.n % Cols<true, X>::kWidth == 0 && aligned16(a.x) && aligned16(a.out);
  if (a.n <= 64) return vec ? vn_dispatch<16, true>(a, s) : vn_dispatch<16, false>(a, s);
  return vec ? vn_dispatch<32, true>(a, s) : vn_dispatch<32, false>(a, s);
}

// The modes, one or two passes of one kernel (`a` carries the pack, its
// index and sizes):
//   0 single: out = scale * A x
//   1 pair:   mid = A x;            out = 2 A mid - x
//   2 chain:  mid = 2 A x + g;      out = A mid - x      (x = g2, g = g1)
// The row factor comes before the doubling and the + g. A CUDA grid runs
// in no order, so pass 2 reads pass 1's result from device memory: `mid`
// is stored in X (rounded to bf16 for a bf16 operand, as the TPU kernel
// rounds T1 before its stage 2), and pass 2 reads that.
template <typename T, typename X>
cudaError_t vn_modes(VnPass<T, X> a, const X* x, const X* g, X* mid, X* out, int mode,
                     float scale, cudaStream_t s) {
  a.x = x;
  if (mode == 0) {
    a.add = nullptr;
    a.out = out;
    a.alpha = scale;
    a.beta = 0.0f;
    return vn_pass(a, s);
  }
  const bool chain = mode == 2;
  // pass 1: mid = A x (pair) or 2 A x + g (chain)
  a.add = chain ? g : nullptr;
  a.out = mid;
  a.alpha = chain ? 2.0f : 1.0f;
  a.beta = 1.0f;
  cudaError_t err = vn_pass(a, s);
  if (err != cudaSuccess) return err;
  // pass 2: out = 2 A mid - x (pair) or A mid - x (chain)
  a.x = mid;
  a.add = x;
  a.out = out;
  a.alpha = chain ? 1.0f : 2.0f;
  a.beta = -1.0f;
  return vn_pass(a, s);
}

}  // namespace
}  // namespace csr_rows
