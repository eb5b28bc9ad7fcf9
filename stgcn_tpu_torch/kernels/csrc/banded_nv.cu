// K5: banded SpMM on the nv operand [N, V] (replaces the TPU kernel
// `_stream_nv_call`, stgcn_tpu/kernels/banded_nv.py:208), float32.
//
// One application, with slab_i the pre-transposed [w, bs] dense slab of
// block row i over its column window starting at lo_i:
//
//   y[r, i*bs + b] = sum_{k < w} x[r, lo_i + k] * slab_i[k, b]
//
// Every operand is [n, vp] row-major; a window reads columns >= vp as zero
// (the TPU pads x to x_cols = round_up(max(vp, nbr*bs), bs) with zeros) and
// output columns >= nbr*bs have no slab (A x is zero there).
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
// column i; it walks the w-long window in steps of 16, staging the x tile
// (16 columns of 64 rows, read as float4) and the slab sub-tile (16 x 64,
// float4) in shared memory; each of 256 threads keeps a 4 x 4 accumulator
// in registers, float32 FMA (no TF32: the parity bound is 1e-4). The
// epilogue alpha*acc + beta*add is applied in registers. No atomics: a
// repeat launch is bit-identical. Offsets are size_t (N * vp is 130 M
// elements at 100k vertices).
//
// What bounds it: the pack is dense over the band, but a road graph fills
// 0.57 % of it (100k vertices, RCM, bs = 256: nnz 1.02 M in 391 slabs of
// 1792 x 256). One application at N = 1280 is 2*N*nbr*w*bs = 459 GFLOP of
// band FLOPs (>= 6.9 ms at 67 TFLOP/s) against 2.6 GFLOP of useful work
// and 1.75 GB of bytes (>= 0.5 ms). This first version does every band
// FLOP; skipping all-zero sub-tiles, wgmma and TMA are later work.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTm = 64;        // output rows per block
constexpr int kTn = 64;        // output columns per block (inside one slab block column)
constexpr int kTk = 16;        // window columns staged per step
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

// out = alpha * (A x) + beta * add, every operand [n, vp]
struct PassArgs {
  const float* slabs;  // [nbr, w, bs]
  const int* lo;       // [nbr]
  const float* x;
  const float* add;    // or null
  float* out;
  int nbr, w, bs, n, vp;
  float alpha, beta;
};

__global__ void __launch_bounds__(kThreads) banded_nv_kernel(PassArgs a) {
  __shared__ __align__(16) float xs[kTk][kTm];   // x tile, transposed: [k][row]
  __shared__ __align__(16) float as[kTk][kTn];   // slab sub-tile: [k][col]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
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
    const float* slab = a.slabs + (size_t)blk * a.w * a.bs + (c0 - blk * a.bs);
    const int xr = r0 + tid / 4, xq = 4 * (tid % 4);    // x load: row, first of 4 columns
    const int sk = tid / 16, sq = 4 * (tid % 16);       // slab load: row, first of 4 columns
    const float* xrow = a.x + (size_t)xr * a.vp;
    for (int k0 = 0; k0 < a.w; k0 += kTk) {
      const int xc = lo + k0 + xq;
      float4 xv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (xr < a.n && xc < a.vp) xv = *reinterpret_cast<const float4*>(xrow + xc);
      xs[xq + 0][tid / 4] = xv.x;
      xs[xq + 1][tid / 4] = xv.y;
      xs[xq + 2][tid / 4] = xv.z;
      xs[xq + 3][tid / 4] = xv.w;
      *reinterpret_cast<float4*>(&as[sk][sq]) =
          *reinterpret_cast<const float4*>(slab + (size_t)(k0 + sk) * a.bs + sq);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTk; ++kk) {
        const float4 xa = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
        const float4 sb = *reinterpret_cast<const float4*>(&as[kk][tx * 4]);
        const float xv4[4] = {xa.x, xa.y, xa.z, xa.w};
        const float sv4[4] = {sb.x, sb.y, sb.z, sb.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv4[i], sv4[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  const int c = c0 + tx * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= a.n) continue;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = a.alpha * acc[i][j];
      if (a.add != nullptr) v[j] = fmaf(a.beta, a.add[(size_t)r * a.vp + c + j], v[j]);
    }
    *reinterpret_cast<float4*>(a.out + (size_t)r * a.vp + c) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

cudaError_t launch_pass(const PassArgs& a, cudaStream_t stream) {
  if (a.n <= 0) return cudaSuccess;
  const dim3 grid(a.vp / kTn, (a.n + kTm - 1) / kTm);
  if (grid.y > 65535u) return cudaErrorInvalidConfiguration;
  banded_nv_kernel<<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K5. slabs [nbr, w, bs], lo [nbr] int32; x, g, mid, out [n, vp] with
// 16-byte-aligned rows; g only for chain, mid for pair and chain. mode 0
// single, 1 pair, 2 chain. Needs bs % 64 == 0, w % 16 == 0, vp % 64 == 0.
int stgcn_banded_nv(const float* slabs, const int* lo, const float* x, const float* g,
                    float* mid, float* out, int nbr, int w, int bs, int n, int vp, int mode,
                    float scale, void* stream) {
  if (bs % kTn != 0 || w % kTk != 0 || vp % kTn != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // PassArgs: slabs, lo, x, add, out, nbr, w, bs, n, vp, alpha, beta
  if (mode == 0) return launch_pass({slabs, lo, x, nullptr, out, nbr, w, bs, n, vp, scale, 0.0f}, s);
  if (mode != 1 && mode != 2) return cudaErrorInvalidValue;
  const bool chain = mode == 2;
  // pass 1: mid = A x (pair) or 2 A x + g (chain)
  cudaError_t err = launch_pass({slabs, lo, x, chain ? g : nullptr, mid, nbr, w, bs, n, vp,
                                 chain ? 2.0f : 1.0f, 1.0f}, s);
  if (err != cudaSuccess) return err;
  // pass 2: out = 2 A mid - x (pair) or A mid - x (chain)
  return launch_pass({slabs, lo, mid, x, out, nbr, w, bs, n, vp, chain ? 1.0f : 2.0f, -1.0f}, s);
}

}  // extern "C"
