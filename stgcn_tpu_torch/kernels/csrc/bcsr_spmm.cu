// K10: BCSR SpMM on the vn operand [Vp, N] (replaces both TPU kernels of
// stgcn_tpu/kernels/spmm.py: `_spmm_pallas_resident` :123, x resident in
// VMEM, and `_spmm_pallas` :166, x streamed by DMA; on Hopper x lies in
// device memory either way and its tiles are staged in shared memory, so
// one kernel serves both), float32.
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
// Design: the register tiling of K5/K6 (nv_tile.cuh) with the operands'
// roles swapped. A block owns 64 output rows (inside one block row) x 64
// columns of N and walks its block row's counts[i] live tiles, each a
// bs-deep reduction in steps of 16: the 64 x 16 operator sub-tile is staged
// transposed (nvtile::stage_x, float4 reads) and the 16 x 64 x sub-tile
// row by row (one coalesced 256-byte row segment per 64 threads, columns
// past n read as 0); each thread keeps 4 x 4 sums in registers, float32
// FMA. No atomics: a repeat launch is bit-identical. Offsets are size_t:
// the 1M-vertex pack holds 3.3e9 floats.
//
// What bounds it: it does every FLOP of every live tile, and a road graph
// fills a live tile to under 1 %: at 1M vertices (RCM, bs = 256, 34,113
// live tiles) one application at N = 160 is 0.72 TFLOP of tile FLOPs (>= 11
// ms at 67 TFLOP/s) against 0.41 ms of the bytes the function needs (the
// nonzeros as CSR, x read and y written once, at 3.35 TB/s).
// Skipping all-zero sub-tiles, wgmma and TMA are later work.
#include "nv_tile.cuh"

namespace {

using nvtile::kThreads;
using nvtile::kTk;
using nvtile::kTm;
using nvtile::kTn;

__global__ void __launch_bounds__(kThreads)
    bcsr_spmm_kernel(const float* tiles, const int* cols, const int* counts, const float* x,
                     float* y, int max_b, int bs, int n, float alpha) {
  __shared__ nvtile::Smem sm;
  const int r0 = blockIdx.x * kTm;   // first output row
  const int c0 = blockIdx.y * kTn;   // first output column
  const int blk = r0 / bs;           // block row of the operator
  const int a0 = r0 - blk * bs;      // first tile row

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  const size_t tile_len = (size_t)bs * bs, rows = (size_t)gridDim.x * kTm;
  const float* row_tiles = tiles + (size_t)blk * max_b * tile_len;
  const int count = counts[blk];
  for (int k = 0; k < count; ++k) {
    const size_t xr = (size_t)cols[(size_t)blk * max_b + k] * bs;
    const float* tile = row_tiles + k * tile_len;
    for (int k0 = 0; k0 < bs; k0 += kTk) {
      nvtile::stage_x(sm, tile, bs, bs, a0, k0);   // tile[a0 + r, k0 + j] -> xs[j][r]
      nvtile::stage_x_rows(sm, x, n, rows, xr + k0, c0);   // x[xr + k0 + j, c0 + c] -> as[j][c]
      __syncthreads();
      nvtile::fma_tile(sm, acc);
      __syncthreads();
    }
  }
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t r = (size_t)r0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx * 4 + j;
      if (c < n) y[r * n + c] = alpha * acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// K10. tiles [nbr, max_b, bs, bs] float32 row-major, 16-byte aligned; cols
// [nbr, max_b] and counts [nbr] int32; x, y [nbr*bs, n] float32 row-major.
// Needs bs % 64 == 0 and every cols[i, k] < nbr.
int stgcn_bcsr_spmm(const float* tiles, const int* cols, const int* counts, const float* x,
                    float* y, int nbr, int max_b, int bs, int n, float alpha, void* stream) {
  if (bs <= 0 || bs % kTm != 0 || nbr <= 0 || max_b <= 0 || n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const dim3 grid((unsigned)((size_t)nbr * bs / kTm), (unsigned)((n + kTn - 1) / kTn));
  if ((size_t)nbr * bs / kTm > 0x7fffffffu || grid.y > 65535u)
    return cudaErrorInvalidConfiguration;
  bcsr_spmm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tiles, cols, counts, x, y, max_b, bs, n, alpha);
  return cudaGetLastError();
}

}  // extern "C"
