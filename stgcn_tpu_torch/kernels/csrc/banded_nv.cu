// K5: banded SpMM on the nv operand [N, V] (replaces the TPU kernel
// `_stream_nv_call`, stgcn_tpu/kernels/banded_nv.py:208), float32 or int8
// slabs.
//
// One application, with slab_i the pre-transposed [w, bs] dense slab of
// block row i over its column window starting at lo_i, and scale_i the
// per-output-lane dequant factors of an int8 pack (1 for float32):
//
//   y[r, i*bs + b] = scale_i[b] * sum_{k < w} x[r, lo_i + k] * slab_i[k, b]
//
// The factor multiplies the float32 sum, as the TPU kernel applies it
// (:151, :179). Every operand is [n, vp] row-major; a window reads columns
// >= vp as zero (the TPU pads x to x_cols = round_up(max(vp, nbr*bs), bs)
// with zeros) and output columns >= nbr*bs have no slab (A x is zero there).
//
// Modes (one C entry point, one or two launches of one kernel):
//   single: out = scale * A x
//   pair:   mid = A x;            out = 2 A mid - x
//   chain:  mid = 2 A x + g;      out = A mid - x      (x = g2, g = g1)
// On the TPU, stage 2 of block i reads stage-1 blocks that earlier steps of
// a sequential grid left in a VMEM ring (a wavefront). A CUDA grid runs in
// no order, so here the two stages are two passes over the whole operand:
// pass 1 writes `mid` to device memory, pass 2 reads it.
//
// Design: a block owns a 64-row x 64-column output tile inside one block
// column i and walks the w-long window in steps of 16 through the register
// tiling of nv_tile.cuh, float32 FMA (no TF32: the parity
// bound is 1e-4); int8 slabs are read as int8 and widened to float32 in
// shared memory. The epilogue alpha*acc*scale + beta*add is applied in
// registers. No atomics: a repeat launch is bit-identical. Offsets are
// size_t (N * vp is 130 M elements at 100k vertices).
//
// What bounds it: the pack is dense over the band, but a road graph fills
// 0.57 % of it (100k vertices, RCM, bs = 256: nnz 1.02 M in 391 slabs of
// 1792 x 256). One application at N = 1280 is 2*N*nbr*w*bs = 459 GFLOP of
// band FLOPs (>= 6.9 ms at 67 TFLOP/s) against 2.6 GFLOP of useful work
// and 1.75 GB of bytes (>= 0.5 ms). This first version does every band
// FLOP; skipping all-zero sub-tiles, wgmma and TMA are later work.
#include "nv_tile.cuh"

namespace {

using nvtile::kTk;
using nvtile::kTm;
using nvtile::kTn;
using nvtile::kThreads;

// out = alpha * (A x) * lane_scale + beta * add, every operand [n, vp]
template <typename T>
struct PassArgs {
  const T* slabs;       // [nbr, w, bs]
  const int* lo;        // [nbr]
  const float* scales;  // [nbr * bs] or null
  const float* x;
  const float* add;     // or null
  float* out;
  int nbr, w, bs, n, vp;
  float alpha, beta;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) banded_nv_kernel(PassArgs<T> a) {
  __shared__ nvtile::Smem sm;
  const int c0 = blockIdx.x * kTn;   // first output column of the tile
  const int r0 = blockIdx.y * kTm;   // first output row
  const int blk = c0 / a.bs;         // block row of the operator

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  if (blk < a.nbr) {  // output columns past nbr*bs have no slab: A x is 0 there
    const int lo = a.lo[blk];
    const T* slab = a.slabs + (size_t)blk * a.w * a.bs + (c0 - blk * a.bs);
    for (int k0 = 0; k0 < a.w; k0 += kTk) {
      nvtile::stage_x(sm, a.x, a.n, a.vp, r0, lo + k0);
      nvtile::stage_a(sm, slab + (size_t)k0 * a.bs, a.bs);
      __syncthreads();
      nvtile::fma_tile(sm, acc);
      __syncthreads();
    }
  }
  // past nbr*bs there is no slab and no scale: the sums are 0
  nvtile::store(acc, blk < a.nbr ? a.scales : nullptr, a.alpha, a.beta, a.add, a.out, a.n,
                a.vp, r0, c0);
}

template <typename T>
cudaError_t launch_pass(const PassArgs<T>& a, cudaStream_t stream) {
  if (a.n <= 0) return cudaSuccess;
  const dim3 grid(a.vp / kTn, (a.n + kTm - 1) / kTm);
  if (grid.y > 65535u) return cudaErrorInvalidConfiguration;
  banded_nv_kernel<T><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_mode(const T* slabs, const int* lo, const float* scales, const float* x,
                     const float* g, float* mid, float* out, int nbr, int w, int bs, int n,
                     int vp, int mode, float scale, cudaStream_t s) {
  // PassArgs: slabs, lo, scales, x, add, out, nbr, w, bs, n, vp, alpha, beta
  if (mode == 0)
    return launch_pass<T>({slabs, lo, scales, x, nullptr, out, nbr, w, bs, n, vp, scale, 0.0f},
                          s);
  if (mode != 1 && mode != 2) return cudaErrorInvalidValue;
  const bool chain = mode == 2;
  // pass 1: mid = A x (pair) or 2 A x + g (chain)
  cudaError_t err = launch_pass<T>({slabs, lo, scales, x, chain ? g : nullptr, mid, nbr, w, bs,
                                    n, vp, chain ? 2.0f : 1.0f, 1.0f}, s);
  if (err != cudaSuccess) return err;
  // pass 2: out = 2 A mid - x (pair) or A mid - x (chain)
  return launch_pass<T>({slabs, lo, scales, mid, x, out, nbr, w, bs, n, vp,
                         chain ? 1.0f : 2.0f, -1.0f}, s);
}

}  // namespace

extern "C" {

// K5. slabs [nbr, w, bs] float32 (int8 when `int8`), lo [nbr] int32, scales
// [nbr, bs] float32 (int8 only, else null); x, g, mid, out [n, vp] with
// 16-byte-aligned rows; g only for chain, mid for pair and chain. mode 0
// single, 1 pair, 2 chain. Needs bs % 64 == 0, w % 16 == 0, vp % 64 == 0.
int stgcn_banded_nv(const void* slabs, const int* lo, const float* scales, const float* x,
                    const float* g, float* mid, float* out, int nbr, int w, int bs, int n,
                    int vp, int int8, int mode, float scale, void* stream) {
  if (bs % kTn != 0 || w % kTk != 0 || vp % kTn != 0 || (int8 != 0) != (scales != nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int8)
    return run_mode(static_cast<const int8_t*>(slabs), lo, scales, x, g, mid, out, nbr, w, bs,
                    n, vp, mode, scale, s);
  return run_mode(static_cast<const float*>(slabs), lo, scales, x, g, mid, out, nbr, w, bs, n,
                  vp, mode, scale, s);
}

}  // extern "C"
