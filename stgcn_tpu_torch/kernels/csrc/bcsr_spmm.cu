// K10: BCSR SpMM on the vn operand [Vp, N] (replaces both TPU kernels of
// stgcn_tpu/kernels/spmm.py: `_spmm_pallas_resident` :123, x resident in
// VMEM, and `_spmm_pallas` :166, x streamed by DMA; on Hopper x lies in
// device memory either way, so one kernel serves both), float32.
//
// With tiles[i, k] the row-major bs x bs tile of block row i at column
// block cols[i, k], for k < counts[i]:
//
//   y[i*bs + a, c] = alpha * sum_{k < counts[i]} sum_{b < bs}
//                    tiles[i, k][a, b] * x[cols[i, k]*bs + b, c]
//
// x and y are [nbr*bs, n] row-major, any n >= 0. A scalar scale (the
// Chebyshev 2G step) is alpha: the JAX operator multiplies the whole pack
// per call (ops/graph_op.py:172-173), a 13.3 GB copy at 1M vertices.
//
// What bounds it: bytes. A road graph fills a live tile to under 1 % (at
// 1M vertices, RCM, bs = 256: 10.2M nonzeros in 34,113 tiles), so every
// FLOP of a tile is 200x the work the function needs. This kernel touches
// only the nonzeros, through the pack's nonzero index (kernels/
// nnz_index.py: row_ptr, src, off in CSR order, by output row then
// ascending source vertex); the values stay in the tiles and are read at
// their offsets. What it must move is the index (8 B a nonzero), one value
// sector a nonzero, the gathered x rows and y once.
//
// Design: G lanes per output row (a warp; a half-warp where n <= 64) walk
// the row's nonzeros with csr_rows.cuh (shared with K6): the lanes load G
// (src, value) pairs at once and broadcast them by shuffle; for each pair
// the group reads the x row x[src, :] coalesced, float4 where n % 4 == 0
// and x, y are 16-byte aligned, scalar loads otherwise. Each output element
// is one fmaf chain in ascending src, alpha applied after the sum; padded
// rows write 0. Rows are in RCM order, so the groups in
// flight read neighbouring x rows, which the 50 MB L2 keeps (all of x is
// 640 MB at n = 160). No atomics: a repeat launch is bit-identical. A
// block row's tiles start at a size_t offset (the 1M pack holds 3.3e9
// floats); `off` inside one block row fits int32.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "csr_rows.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void store(float* yr, int c, const float4& acc, float alpha) {
  *reinterpret_cast<float4*>(yr + c) =
      make_float4(alpha * acc.x, alpha * acc.y, alpha * acc.z, alpha * acc.w);
}
__device__ __forceinline__ void store(float* yr, int c, float acc, float alpha) {
  yr[c] = alpha * acc;
}

// G lanes per output row; a lane owns CPL column steps of a chunk of
// G * CPL * width columns.
template <int G, int CPL, bool VEC>
__global__ void __launch_bounds__(kThreads)
    bcsr_rows_kernel(const float* __restrict__ tiles, const int* __restrict__ row_ptr,
                     const int* __restrict__ src, const int* __restrict__ off,
                     const float* __restrict__ x, float* __restrict__ y, int rows, int bs,
                     size_t row_tiles, int n, float alpha) {
  using C = csr_rows::Cols<VEC>;
  const int row = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  if (row >= rows) return;   // a whole group: rows is a multiple of kThreads / G
  const int lane = threadIdx.x % G;
  const int beg = row_ptr[row], end = row_ptr[row + 1];
  const float* vals = tiles + (size_t)(row / bs) * row_tiles;
  float* yr = y + (size_t)row * n;
  constexpr int kChunk = G * CPL * C::kWidth;
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    typename C::T acc[CPL];
    csr_rows::row_sums<G, CPL, VEC>(vals, src, off, beg, end, x, n, c0, lane, acc);
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      const int c = c0 + C::kWidth * (lane + G * q);
      if (c < n) store(yr, c, acc[q], alpha);
    }
  }
}

template <int G, int CPL, bool VEC>
cudaError_t launch(const float* tiles, const int* row_ptr, const int* src, const int* off,
                   const float* x, float* y, int rows, int bs, size_t row_tiles, int n,
                   float alpha, cudaStream_t s) {
  const unsigned blocks = (unsigned)((rows + kThreads / G - 1) / (kThreads / G));
  bcsr_rows_kernel<G, CPL, VEC>
      <<<blocks, kThreads, 0, s>>>(tiles, row_ptr, src, off, x, y, rows, bs, row_tiles, n, alpha);
  return cudaGetLastError();
}

// column steps a lane needs for `steps` steps of a row, 1, 2 or 4 (wider
// rows loop over chunks)
template <int G, bool VEC>
cudaError_t dispatch(int steps, const float* tiles, const int* row_ptr, const int* src,
                     const int* off, const float* x, float* y, int rows, int bs,
                     size_t row_tiles, int n, float alpha, cudaStream_t s) {
  if (steps <= G)
    return launch<G, 1, VEC>(tiles, row_ptr, src, off, x, y, rows, bs, row_tiles, n, alpha, s);
  if (steps <= 2 * G)
    return launch<G, 2, VEC>(tiles, row_ptr, src, off, x, y, rows, bs, row_tiles, n, alpha, s);
  return launch<G, 4, VEC>(tiles, row_ptr, src, off, x, y, rows, bs, row_tiles, n, alpha, s);
}

}  // namespace

extern "C" {

// K10. tiles [nbr, max_b, bs, bs] float32 row-major; the pack's nonzero
// index row_ptr [nbr*bs + 1], src and off [nnz] int32; x, y [nbr*bs, n]
// float32 row-major, any alignment (float4 only where both are 16-byte
// aligned and n % 4 == 0). Needs bs % 16 == 0, every src < nbr*bs and every
// off < max_b*bs*bs.
int stgcn_bcsr_spmm(const float* tiles, const int* row_ptr, const int* src, const int* off,
                    const float* x, float* y, int nbr, int max_b, int bs, int n, float alpha,
                    void* stream) {
  if (bs <= 0 || bs % 16 != 0 || nbr <= 0 || max_b <= 0 || n < 0 ||
      (size_t)nbr * bs >= 0x7fffffffu)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = nbr * bs;
  const size_t row_tiles = (size_t)max_b * bs * bs;
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int steps = vec ? n / 4 : n;
  if (n <= 64)
    return vec ? dispatch<16, true>(steps, tiles, row_ptr, src, off, x, y, rows, bs, row_tiles,
                                    n, alpha, s)
               : dispatch<16, false>(steps, tiles, row_ptr, src, off, x, y, rows, bs,
                                     row_tiles, n, alpha, s);
  return vec ? dispatch<32, true>(steps, tiles, row_ptr, src, off, x, y, rows, bs, row_tiles, n,
                                  alpha, s)
             : dispatch<32, false>(steps, tiles, row_ptr, src, off, x, y, rows, bs, row_tiles,
                                   n, alpha, s);
}

}  // extern "C"
