// The transposing walk of the nv kernels K6 (ell_nv.cu) and K5
// (banded_nv.cu): SpMM on the nv operand [n, vp] over a pack's nonzero
// index (kernels/nnz_index.py), one output row (vertex lane) at a time.
//
// In the nv layout a column x[:, u] is n values vp*4 bytes apart, a sector
// each, so the operand is turned to vn first: (1) a hand-written transpose
// of x into the workspace, [vp, n], float4 reads, through a padded shared
// tile; (2) a gather pass: a block per 32 output rows, a warp per row at a
// time, its lanes over the operand columns (float4 steps on wide operands,
// up to 256 columns a chunk), walking the row with csr_rows.cuh's row_sums
// as K10 does: the lanes load 32 (src, value) pairs at once and broadcast
// them by shuffle, and each pair adds value * x_vn[src, :] (one coalesced
// row read) into the row's sums; the 32 x chunk sums go out through shared
// memory, so the nv stores and the
// epilogue's reads of g or x are 128 contiguous bytes a warp. The pair's
// and chain's first pass also writes its result in vn for the second, so
// no transpose comes back. Each output element is one fmaf chain in
// ascending source vertex, the lane factor and alpha applied after the sum;
// no atomics: a repeat launch is bit-identical.
//
// The operand type X is float32 or bf16 (the values T float32, int8 or
// bf16, widened exactly): a bf16 operand is transposed as bf16, its rows
// read as 16-byte vectors of eight, each sum and epilogue run in float32
// and the result is rounded once to bf16 where it is stored (out, mid and
// mid's vn copy alike). With ROUND (K6's bf16 variant) the product alpha *
// (A x) * lane_scale is rounded to bf16 first where an add follows, as the
// JAX ELL path writes each application in x's type before 2y - x and
// g + 2y; K5 keeps the TPU kernel's one rounding.
//
// Modes (nv_modes: two or three launches):
//   0 single: out = scale * A x
//   1 pair:   mid = A x;            out = 2 A mid - x
//   2 chain:  mid = 2 A x + g;      out = A mid - x      (x = g2, g = g1)
// The second pass folds 2y - x into its epilogue (fma(-1, x, 2y) is 2y - x
// rounded once).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "csr_rows.cuh"

namespace nv_rows {
namespace {   // internal linkage: each source that includes this instantiates its own

constexpr int kRows = 32;   // output rows (vertices) a gather block, 4 a warp at a time

// in [n, vp] -> out [vp, n]; a block moves 32 operand rows x 128 vertices,
// four consecutive vertices a thread (a float4, or four bf16 in 8 bytes,
// moved as their bits)
template <typename X>
__global__ void __launch_bounds__(256)
    transpose_kernel(const X* __restrict__ in, X* __restrict__ out, int n, int vp) {
  using S = std::conditional_t<sizeof(X) == 4, float, unsigned short>;
  __shared__ S tile[32][129];
  const int c0 = blockIdx.x * 128, r0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  if (c0 + 4 * tx < vp)   // vp % 4 == 0: a vector of four is whole or out
    for (int j = ty; j < 32 && r0 + j < n; j += 8) {
      if constexpr (sizeof(X) == 4) {
        const float4 v =
            *reinterpret_cast<const float4*>(in + (size_t)(r0 + j) * vp + c0 + 4 * tx);
        tile[j][4 * tx + 0] = v.x;
        tile[j][4 * tx + 1] = v.y;
        tile[j][4 * tx + 2] = v.z;
        tile[j][4 * tx + 3] = v.w;
      } else {
        const uint2 raw =
            *reinterpret_cast<const uint2*>(in + (size_t)(r0 + j) * vp + c0 + 4 * tx);
        tile[j][4 * tx + 0] = (unsigned short)(raw.x & 0xffffu);
        tile[j][4 * tx + 1] = (unsigned short)(raw.x >> 16);
        tile[j][4 * tx + 2] = (unsigned short)(raw.y & 0xffffu);
        tile[j][4 * tx + 3] = (unsigned short)(raw.y >> 16);
      }
    }
  __syncthreads();
  if (r0 + tx < n)
    for (int c = ty; c < 128 && c0 + c < vp; c += 8)
      reinterpret_cast<S*>(out)[(size_t)(c0 + c) * n + r0 + tx] = tile[tx][c];
}

// out = alpha * (A x) * lane_scale + beta * add, with x given as xt [vp, n],
// every operand in X. Block row i's values start at vals + i * row_stride
// (an ELL block row's tiles, an nv slab); rows past live_rows have no lane
// factor (and an empty index row).
template <typename T, typename X = float>
struct PassArgs {
  const T* vals;
  size_t row_stride;
  const int* row_ptr;   // [vp + 1]
  const int* src;       // [nnz], every src < vp
  const int* off;       // [nnz]
  const float* scales;  // [live_rows] or null
  int live_rows;
  const X* xt;          // [vp, n]
  const X* add;         // [n, vp] or null
  X* out;               // [n, vp]
  X* out_t;             // [vp, n]: the result again in vn, or null
  int bs, n, vp;
  float alpha, beta;
};

// Q column steps a lane of width 4 (VEC, float32: float4 reads of xt, n % 4
// == 0), 8 (VEC, bf16: 16-byte reads, n % 8 == 0) or 1, 32 * Q * width
// columns a chunk
template <typename T, typename X, int Q, bool VEC, bool ROUND>
__global__ void __launch_bounds__(256) gather_kernel(PassArgs<T, X> a) {
  using C = csr_rows::Cols<VEC, X>;
  constexpr int kW = 32 * Q * C::kWidth;
  __shared__ float ys[kRows][kW + 1];
  const int r0 = blockIdx.x * kRows;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int c0 = 0; c0 < a.n; c0 += kW) {
    for (int q4 = 0; q4 < kRows / 8; ++q4) {
      const int rl = w * (kRows / 8) + q4, row = r0 + rl;
      const int beg = a.row_ptr[row], end = a.row_ptr[row + 1];
      const T* vals = a.vals + (size_t)(row / a.bs) * a.row_stride;
      typename C::T acc[Q];
      csr_rows::row_sums<32, Q, VEC>(vals, a.src, a.off, beg, end, a.xt, a.n, c0, lane, acc);
      const float sc = a.scales != nullptr && row < a.live_rows ? a.scales[row] : 1.0f;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        float* y = &ys[rl][C::kWidth * (lane + 32 * q)];
        const float* v = reinterpret_cast<const float*>(&acc[q]);
#pragma unroll
        for (int j = 0; j < C::kWidth; ++j) {
          if constexpr (ROUND) {   // the product in X before the add
            float p = a.scales != nullptr ? v[j] * sc : v[j];
            if (a.add != nullptr) p = __bfloat162float(__float2bfloat16_rn(p));
            y[j] = a.alpha * p;
          } else {
            y[j] = a.alpha * (a.scales != nullptr ? v[j] * sc : v[j]);
          }
        }
      }
    }
    __syncthreads();
    // nv: a warp writes 32 consecutive vertices of one operand row
    for (int cc = w; cc < kW && c0 + cc < a.n; cc += 8) {
      const size_t at = (size_t)(c0 + cc) * a.vp + r0 + lane;
      float v = ys[lane][cc];
      if (a.add != nullptr) v = fmaf(a.beta, csr_rows::widen(a.add[at]), v);
      if constexpr (sizeof(X) == 4)   // the f32 statements as they were: their SASS kept
        a.out[at] = v;
      else
        csr_rows::store(a.out, at, v);
      ys[lane][cc] = v;
    }
    if (a.out_t != nullptr) {   // vn: a warp writes one row's chunk
      __syncthreads();
      for (int rl = w; rl < kRows; rl += 8)
        for (int cc = lane; cc < kW && c0 + cc < a.n; cc += 32) {
          if constexpr (sizeof(X) == 4)
            a.out_t[(size_t)(r0 + rl) * a.n + c0 + cc] = ys[rl][cc];
          else
            csr_rows::store(a.out_t, (size_t)(r0 + rl) * a.n + c0 + cc, ys[rl][cc]);
        }
    }
    __syncthreads();
  }
}

template <typename T, typename X, int Q, bool VEC, bool ROUND>
cudaError_t gather_q(const PassArgs<T, X>& a, cudaStream_t s) {
  gather_kernel<T, X, Q, VEC, ROUND><<<a.vp / kRows, 256, 0, s>>>(a);
  return cudaGetLastError();
}

// Chunks of at most 256 columns: 16-byte steps on wide operands (n > 256,
// n a multiple of the vector: four float32 or eight bf16; xt and out_t are
// the workspace, 16-byte aligned rows then), where the chunks are full;
// scalar steps otherwise. On an H100 float4 took K5 at n = 1280 from 1.51
// to 1.23 ms but K6's chain at n = 160, a chunk 5/8 full, from 3.58 to
// 3.92 ms (PERF.md, sparse_ab.py).
template <typename T, typename X, bool ROUND>
cudaError_t gather(const PassArgs<T, X>& a, cudaStream_t s) {
  constexpr int kVec = csr_rows::Cols<true, X>::kWidth;
  if (a.n % kVec == 0 && a.n > 256) return gather_q<T, X, 256 / (32 * kVec), true, ROUND>(a, s);
  const int q = (a.n + 31) / 32;
  if (q <= 1) return gather_q<T, X, 1, false, ROUND>(a, s);
  if (q <= 2) return gather_q<T, X, 2, false, ROUND>(a, s);
  if (q <= 3) return gather_q<T, X, 3, false, ROUND>(a, s);
  if (q <= 4) return gather_q<T, X, 4, false, ROUND>(a, s);
  if (q <= 5) return gather_q<T, X, 5, false, ROUND>(a, s);
  if (q <= 6) return gather_q<T, X, 6, false, ROUND>(a, s);
  return gather_q<T, X, 8, false, ROUND>(a, s);
}

// The mode on x, g, mid, out [n, vp] in X (x 16-byte aligned, vp % 32 ==
// 0; work n * vp elements of X for single, twice that for pair and chain,
// 16-byte aligned); `a` carries the pack, its index and sizes. ROUND: see
// the top of this file.
template <typename T, typename X = float, bool ROUND = false>
cudaError_t nv_modes(PassArgs<T, X> a, const X* x, const X* g, X* mid, X* out, X* work,
                     int mode, float scale, cudaStream_t s) {
  if (a.n == 0) return cudaSuccess;
  if ((a.n + 31) / 32 > 65535) return cudaErrorInvalidConfiguration;
  X* xt = work;
  transpose_kernel<X><<<dim3((a.vp + 127) / 128, (a.n + 31) / 32), dim3(32, 8), 0, s>>>(
      x, xt, a.n, a.vp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  a.xt = xt;
  a.add = nullptr;
  a.out = out;
  a.out_t = nullptr;
  if (mode == 0) {
    a.alpha = scale;
    a.beta = 0.0f;
    return gather<T, X, ROUND>(a, s);
  }
  const bool chain = mode == 2;
  // pass 1: mid = A x (pair) or 2 A x + g (chain), also in vn for pass 2
  a.add = chain ? g : nullptr;
  a.out = mid;
  a.out_t = work + (size_t)a.vp * a.n;
  a.alpha = chain ? 2.0f : 1.0f;
  a.beta = 1.0f;
  err = gather<T, X, ROUND>(a, s);
  if (err != cudaSuccess) return err;
  // pass 2: out = 2 A mid - x (pair) or A mid - x (chain)
  a.xt = a.out_t;
  a.out_t = nullptr;
  a.add = x;
  a.out = out;
  a.alpha = chain ? 1.0f : 2.0f;
  a.beta = -1.0f;
  return gather<T, X, ROUND>(a, s);
}

}  // namespace
}  // namespace nv_rows
