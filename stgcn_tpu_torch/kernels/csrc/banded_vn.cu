// K7-K9: banded SpMM on the vn operand [V, N] (replaces four TPU kernels of
// stgcn_tpu/kernels/banded_spmm.py: K7a `_banded_pallas_resident` :255 and
// K7b `_banded_pallas` :302, one application with x resident in VMEM or
// streamed by DMA; K8 `banded_cheb_pair` :519 and K9 `_pair_stream_call`
// :774, the Chebyshev pair and its VJP chain as wavefronts over a
// sequential grid), float32 or int8 slabs.
//
// One application, with slab_i the row-major bs x w dense slab of block row
// i over its column window starting at lo_i, and s the per-row dequant
// factors of an int8 pack (1 for float32):
//
//   y[i*bs + a, c] = alpha * s[i*bs + a] * sum_{k < w} slab_i[a, k] * x[lo_i + k, c]
//
// x, g, mid and out are [rows, n] row-major (rows = the pack's v_pad), any
// n; x rows >= rows read as zero; output rows >= nbr*bs have no slab (A x
// is zero there). The factor multiplies the float32 sum, as the TPU kernels
// apply it (:217-218, :715-716).
//
// Modes (one C entry point, one or two launches of one kernel), as K5's:
//   single: out = scale * A x
//   pair:   mid = A x;            out = 2 A mid - x
//   chain:  mid = 2 A x + g;      out = A mid - x      (x = g2, g = g1)
// In chain the factor comes before the doubling and the + g (:715-718).
// The TPU's K7a and K7b differ only in where x sits; on Hopper x lies in
// device memory either way. K8 and K9 run stage 2 of block i from T1 blocks
// that earlier steps of a sequential grid left in VMEM rings; a CUDA grid
// runs in no order, so here the two stages are two passes through device
// memory: pass 1 writes `mid`, pass 2 reads it. No VMEM limit, so no
// fallback: the kernel runs at every width.
//
// Design: K10's (bcsr_spmm.cu), a run of implicit consecutive column tiles
// from lo_i in place of a list of tiles. A block owns 64 output rows (inside
// one block row) x 64 columns of N and walks the w-long window in steps of
// 16: the 64 x 16 slab sub-tile is staged transposed (nvtile::stage_x, float4
// reads, or char4 widened to float32 for int8), the 16 x 64 x sub-tile row by
// row (nvtile::stage_x_rows); each thread keeps 4 x 4 sums in registers,
// float32 FMA (no TF32: the parity bound is 1e-4). The epilogue
// alpha * (acc * s) + beta * add is applied in registers. No atomics: a
// repeat launch is bit-identical. Offsets are size_t.
//
// What bounds it: the pack is dense over the band, but a road graph fills
// 0.57 % of it (100k vertices, RCM, bs = 256: nnz 1.02 M in 391 slabs of
// 256 x 1792). One application at N = 1280 is 2*N*nbr*bs*w = 459 GFLOP of
// band FLOPs (>= 6.9 ms at 67 TFLOP/s) against 2.6 GFLOP of useful work and
// about 1.1 GB of bytes the function needs (>= 0.3 ms). This first version
// does every band FLOP, as K5 does; skipping all-zero sub-tiles, wgmma and
// TMA are later work.
#include "nv_tile.cuh"

namespace {

using nvtile::kThreads;
using nvtile::kTk;
using nvtile::kTm;
using nvtile::kTn;

// out = alpha * (A x) * s + beta * add, every operand [rows, n]
template <typename T>
struct PassArgs {
  const T* slabs;       // [nbr, bs, w]
  const int* lo;        // [nbr]
  const float* scales;  // [nbr * bs] or null
  const float* x;
  const float* add;     // or null
  float* out;
  int nbr, bs, w, rows, n;
  float alpha, beta;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) banded_vn_kernel(PassArgs<T> a) {
  __shared__ nvtile::Smem sm;
  const int r0 = blockIdx.x * kTm;   // first output row
  const int c0 = blockIdx.y * kTn;   // first output column
  const int blk = r0 / a.bs;         // block row of the operator
  const bool live = blk < a.nbr;     // rows past nbr*bs have no slab

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  if (live) {
    const size_t lo = (size_t)a.lo[blk];
    const T* slab = a.slabs + (size_t)blk * a.bs * a.w;
    const int a0 = r0 - blk * a.bs;  // first slab row
    for (int k0 = 0; k0 < a.w; k0 += kTk) {
      nvtile::stage_x(sm, slab, a.bs, a.w, a0, k0);                // slab[a0 + r, k0 + j] -> xs[j][r]
      nvtile::stage_x_rows(sm, a.x, a.n, a.rows, lo + k0, c0);     // x[lo + k0 + j, c0 + c] -> as[j][c]
      __syncthreads();
      nvtile::fma_tile(sm, acc);
      __syncthreads();
    }
  }
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= a.rows) continue;
    const float s = live && a.scales != nullptr ? a.scales[r] : 1.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx * 4 + j;
      if (c >= a.n) continue;
      const size_t o = (size_t)r * a.n + c;
      float v = a.alpha * (a.scales != nullptr ? acc[i][j] * s : acc[i][j]);
      if (a.add != nullptr) v = fmaf(a.beta, a.add[o], v);
      a.out[o] = v;
    }
  }
}

template <typename T>
cudaError_t launch_pass(const PassArgs<T>& a, cudaStream_t stream) {
  const dim3 grid((unsigned)((a.rows + kTm - 1) / kTm), (unsigned)((a.n + kTn - 1) / kTn));
  if (grid.y > 65535u) return cudaErrorInvalidConfiguration;
  banded_vn_kernel<T><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_mode(const T* slabs, const int* lo, const float* scales, const float* x,
                     const float* g, float* mid, float* out, int nbr, int bs, int w, int rows,
                     int n, int mode, float scale, cudaStream_t s) {
  // PassArgs: slabs, lo, scales, x, add, out, nbr, bs, w, rows, n, alpha, beta
  if (mode == 0)
    return launch_pass<T>({slabs, lo, scales, x, nullptr, out, nbr, bs, w, rows, n, scale, 0.0f},
                          s);
  if (mode != 1 && mode != 2) return cudaErrorInvalidValue;
  const bool chain = mode == 2;
  // pass 1: mid = A x (pair) or 2 A x + g (chain)
  cudaError_t err = launch_pass<T>({slabs, lo, scales, x, chain ? g : nullptr, mid, nbr, bs, w,
                                    rows, n, chain ? 2.0f : 1.0f, 1.0f}, s);
  if (err != cudaSuccess) return err;
  // pass 2: out = 2 A mid - x (pair) or A mid - x (chain)
  return launch_pass<T>({slabs, lo, scales, mid, x, out, nbr, bs, w, rows, n,
                         chain ? 1.0f : 2.0f, -1.0f}, s);
}

}  // namespace

extern "C" {

// K7-K9. slabs [nbr, bs, w] float32 (int8 when `int8`), 16-byte aligned; lo
// [nbr] int32; scales [nbr, bs] float32 (int8 only, else null); x, g, mid,
// out [rows, n] float32; g only for chain, mid for pair and chain. mode 0
// single, 1 pair, 2 chain. Needs bs % 64 == 0 and w % 16 == 0.
int stgcn_banded_vn(const void* slabs, const int* lo, const float* scales, const float* x,
                    const float* g, float* mid, float* out, int nbr, int bs, int w, int rows,
                    int n, int int8, int mode, float scale, void* stream) {
  if (bs <= 0 || bs % kTm != 0 || w <= 0 || w % kTk != 0 || nbr <= 0 || rows < 0 || n < 0 ||
      (int8 != 0) != (scales != nullptr))
    return cudaErrorInvalidValue;
  if (rows == 0 || n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int8)
    return run_mode(static_cast<const int8_t*>(slabs), lo, scales, x, g, mid, out, nbr, bs, w,
                    rows, n, mode, scale, s);
  return run_mode(static_cast<const float*>(slabs), lo, scales, x, g, mid, out, nbr, bs, w, rows,
                  n, mode, scale, s);
}

}  // extern "C"
