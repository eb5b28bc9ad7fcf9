// K11: blocked SDDMM at the live tiles of a BCSR pack (replaces the TPU
// kernel `_sddmm_pallas`, stgcn_tpu/kernels/sddmm.py:60), float32: the
// tile-value gradient of K10,
//
//   out[i, k][a, b] = alpha * sum_{c < n} g[i*bs + a, c] * x[cols[i, k]*bs + b, c]
//
// for k < counts[i], and zero in the padding slots k >= counts[i]
// (sddmm.py:104-109). g and x are [nbr*bs, n] row-major, any n >= 0.
//
// Design: the register tiling of nv_tile.cuh with both operands staged
// transposed. A block owns one 64 x 64 sub-tile of one slot's output and
// sums all of n in a fixed order, 16 columns a step: the 64 x 16 pieces of
// g and x are staged as [column][row] in shared memory (4 consecutive
// columns of a row per thread, columns past n read as 0), each thread keeps
// 4 x 4 sums in registers, float32 FMA. The TPU kernel carries its sum over
// N across a sequential grid axis; here the loop over n inside the block
// takes that axis' place, so there are no atomics and no second pass, and a
// repeat launch is bit-identical. A padding slot's blocks write zeros and
// read nothing. Offsets are size_t: the 1M-vertex output holds 3.3e9 floats.
//
// What bounds it: every FLOP of every live tile (2 bs^2 n a tile): at 1M
// vertices and n = 160, 0.72 TFLOP (>= 11 ms at 67 TFLOP/s) against 3.1 ms
// of bytes (g and x read once, the live tiles written once, at 3.35 TB/s).
#include "nv_tile.cuh"

namespace {

using nvtile::kThreads;
using nvtile::kTk;
using nvtile::kTm;
using nvtile::kTn;

static_assert(kTm == kTn, "both operands are staged as kTk x 64 pieces");

// src[r0 + r, c0 + j] for r < 64, j < kTk into dst[j][r]; columns >= n read 0.
__device__ __forceinline__ void stage_cols(float (&dst)[kTk][kTm], const float* src, int n,
                                           size_t r0, int c0) {
  const int r = threadIdx.x / 4, q = 4 * (threadIdx.x % 4);   // row, first of 4 columns
  const float* row = src + (r0 + r) * n;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + q + j;
    dst[q + j][r] = c < n ? row[c] : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
    bcsr_sddmm_kernel(const int* cols, const int* counts, const float* g, const float* x,
                      float* out, int max_b, int bs, int n, float alpha) {
  __shared__ nvtile::Smem sm;
  const size_t slot = blockIdx.x;   // i * max_b + k
  const int blk = (int)(slot / max_b), k = (int)(slot % max_b);
  const int per_row = bs / kTn;
  const int a0 = (blockIdx.y / per_row) * kTm, b0 = (blockIdx.y % per_row) * kTn;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  if (k < counts[blk]) {
    const size_t gr = (size_t)blk * bs + a0;
    const size_t xr = (size_t)cols[slot] * bs + b0;
    for (int c0 = 0; c0 < n; c0 += kTk) {
      stage_cols(sm.xs, g, n, gr, c0);   // g[gr + a, c0 + j] -> xs[j][a]
      stage_cols(sm.as, x, n, xr, c0);   // x[xr + b, c0 + j] -> as[j][b]
      __syncthreads();
      nvtile::fma_tile(sm, acc);
      __syncthreads();
    }
  }
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* o = out + slot * bs * bs + (size_t)(a0 + ty * 4) * bs + b0 + tx * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(o + (size_t)i * bs) =
        make_float4(alpha * acc[i][0], alpha * acc[i][1], alpha * acc[i][2], alpha * acc[i][3]);
}

}  // namespace

extern "C" {

// K11. cols [nbr, max_b] and counts [nbr] int32; g, x [nbr*bs, n] float32
// row-major; out [nbr, max_b, bs, bs] float32, 16-byte aligned, every slot
// written. Needs bs % 64 == 0 and every cols[i, k] < nbr.
int stgcn_bcsr_sddmm(const int* cols, const int* counts, const float* g, const float* x,
                     float* out, int nbr, int max_b, int bs, int n, float alpha, void* stream) {
  if (bs <= 0 || bs % kTm != 0 || nbr <= 0 || max_b <= 0 || n < 0) return cudaErrorInvalidValue;
  const size_t slots = (size_t)nbr * max_b, subtiles = (size_t)(bs / kTm) * (bs / kTn);
  if (slots > 0x7fffffffu || subtiles > 65535u) return cudaErrorInvalidConfiguration;
  bcsr_sddmm_kernel<<<dim3((unsigned)slots, (unsigned)subtiles), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(cols, counts, g, x, out, max_b, bs, n,
                                                           alpha);
  return cudaGetLastError();
}

}  // extern "C"
