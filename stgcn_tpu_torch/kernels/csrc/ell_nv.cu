// K6: blocked-ELL SpMM on the nv operand [N, V] (replaces the TPU kernel
// `_ell_nv_pallas`, stgcn_tpu/kernels/ell_nv.py:123), float32 or int8 tiles.
//
// One application, with tiles[i, k] the pre-transposed bs x bs tile of
// block row i at column block cols[i, k], for k < counts[i]:
//
//   y[r, i*bs + b] = scale_i[b] * sum_{k < counts[i]} sum_{j < bs}
//                    x[r, cols[i, k]*bs + j] * tiles[i, k][j, b]
//
// scale_i the per-output-lane dequant factors of an int8 pack (1 for f32),
// applied once to the float32 sum, as the TPU kernel does (:116-117).
// Every operand is [n, vp] row-major with vp = nbr*bs.
//
// Modes (one C entry point, one or two launches of one kernel), as K5's:
//   single: out = scale * A x
//   pair:   mid = A x;            out = 2 A mid - x
//   chain:  mid = 2 A x + g;      out = A mid - x      (x = g2, g = g1)
// The JAX package runs the pair as two applications and 2y - x outside the
// kernel; here the second pass folds it into its epilogue (the same
// function: fma(-1, x, 2y) is 2y - x rounded once).
//
// Design: K5's register tiling (nv_tile.cuh). A block owns a 64-row x
// 64-column output tile inside block column i; instead of one contiguous
// window it walks block row i's counts[i] tiles, each a 256-deep reduction
// whose x columns start at cols[i, k]*bs, read per tile. int8 tiles are read
// as int8 and widened to float32 in shared memory; the pack is never
// multiplied (a scalar folds into alpha). No atomics: a repeat launch is
// bit-identical. Offsets are size_t: nbr*max_b*bs*bs passes 2^31 at 1M
// vertices.
//
// What bounds it: it does every FLOP of every live tile, and a road graph
// fills a live tile to under 1 %. At 1M vertices (RCM, bs = 256, about 6
// tiles a block row) one application at N = 160 is about 0.5 TFLOP of tile
// FLOPs (>= 7 ms at 67 TFLOP/s) against under 1 ms of bytes. Skipping
// all-zero sub-tiles, wgmma and TMA are later work.
#include "nv_tile.cuh"

namespace {

using nvtile::kTk;
using nvtile::kTm;
using nvtile::kTn;
using nvtile::kThreads;

// out = alpha * (A x) * lane_scale + beta * add, every operand [n, vp]
template <typename T>
struct PassArgs {
  const T* tiles;       // [nbr, max_b, bs, bs]
  const int* cols;      // [nbr, max_b]
  const int* counts;    // [nbr]
  const float* scales;  // [nbr * bs] or null
  const float* x;
  const float* add;     // or null
  float* out;
  int max_b, bs, n, vp;
  float alpha, beta;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) ell_nv_kernel(PassArgs<T> a) {
  __shared__ nvtile::Smem sm;
  const int c0 = blockIdx.x * kTn;   // first output column of the tile
  const int r0 = blockIdx.y * kTm;   // first output row
  const int blk = c0 / a.bs;         // block row of the operator

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  const size_t tile_len = (size_t)a.bs * a.bs;
  const T* row_tiles = a.tiles + (size_t)blk * a.max_b * tile_len + (c0 - blk * a.bs);
  const int count = a.counts[blk];
  for (int k = 0; k < count; ++k) {
    const int xc = a.cols[(size_t)blk * a.max_b + k] * a.bs;
    const T* tile = row_tiles + k * tile_len;
    for (int k0 = 0; k0 < a.bs; k0 += kTk) {
      nvtile::stage_x(sm, a.x, a.n, a.vp, r0, xc + k0);
      nvtile::stage_a(sm, tile + (size_t)k0 * a.bs, a.bs);
      __syncthreads();
      nvtile::fma_tile(sm, acc);
      __syncthreads();
    }
  }
  nvtile::store(acc, a.scales, a.alpha, a.beta, a.add, a.out, a.n, a.vp, r0, c0);
}

template <typename T>
cudaError_t launch_pass(const PassArgs<T>& a, cudaStream_t stream) {
  if (a.n <= 0) return cudaSuccess;
  const dim3 grid(a.vp / kTn, (a.n + kTm - 1) / kTm);
  if (grid.y > 65535u) return cudaErrorInvalidConfiguration;
  ell_nv_kernel<T><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_mode(const T* tiles, const int* cols, const int* counts, const float* scales,
                     const float* x, const float* g, float* mid, float* out, int max_b, int bs,
                     int n, int vp, int mode, float scale, cudaStream_t s) {
  // PassArgs: tiles, cols, counts, scales, x, add, out, max_b, bs, n, vp, alpha, beta
  if (mode == 0)
    return launch_pass<T>({tiles, cols, counts, scales, x, nullptr, out, max_b, bs, n, vp,
                           scale, 0.0f}, s);
  if (mode != 1 && mode != 2) return cudaErrorInvalidValue;
  const bool chain = mode == 2;
  // pass 1: mid = A x (pair) or 2 A x + g (chain)
  cudaError_t err = launch_pass<T>({tiles, cols, counts, scales, x, chain ? g : nullptr, mid,
                                    max_b, bs, n, vp, chain ? 2.0f : 1.0f, 1.0f}, s);
  if (err != cudaSuccess) return err;
  // pass 2: out = 2 A mid - x (pair) or A mid - x (chain)
  return launch_pass<T>({tiles, cols, counts, scales, mid, x, out, max_b, bs, n, vp,
                         chain ? 1.0f : 2.0f, -1.0f}, s);
}

}  // namespace

extern "C" {

// K6. tiles [nbr, max_b, bs, bs] float32 (int8 when `int8`), cols [nbr,
// max_b] and counts [nbr] int32, scales [nbr, bs] float32 (int8 only, else
// null); x, g, mid, out [n, nbr*bs] with 16-byte-aligned rows; g only for
// chain, mid for pair and chain. mode 0 single, 1 pair, 2 chain. Needs
// bs % 64 == 0 and every cols[i, k] < nbr.
int stgcn_ell_nv(const void* tiles, const int* cols, const int* counts, const float* scales,
                 const float* x, const float* g, float* mid, float* out, int nbr, int max_b,
                 int bs, int n, int int8, int mode, float scale, void* stream) {
  if (bs % kTn != 0 || nbr <= 0 || max_b <= 0 || (int8 != 0) != (scales != nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vp = nbr * bs;
  if (int8)
    return run_mode(static_cast<const int8_t*>(tiles), cols, counts, scales, x, g, mid, out,
                    max_b, bs, n, vp, mode, scale, s);
  return run_mode(static_cast<const float*>(tiles), cols, counts, scales, x, g, mid, out, max_b,
                  bs, n, vp, mode, scale, s);
}

}  // extern "C"
