// K10: BCSR SpMM on the vn operand [Vp, N] (replaces both TPU kernels of
// stgcn_tpu/kernels/spmm.py: `_spmm_pallas_resident` :123, x resident in
// VMEM, and `_spmm_pallas` :166, x streamed by DMA; on Hopper x lies in
// device memory either way, so one kernel serves both), float32 or bf16
// tiles under a float32 or bf16 operand.
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
// Design: the vn row walk of csr_rows.cuh (vn_pass, shared with K7-K9 of
// banded_vn.cu; the walk itself also with K6): G lanes per output row (a
// warp; a half-warp where n <= 64) walk the row's nonzeros: the lanes load
// G (src, value) pairs at once and broadcast them by shuffle; for each pair
// the group reads the x row x[src, :] coalesced, float4 where n % 4 == 0
// and x, y are 16-byte aligned, scalar loads otherwise. Each output element
// is one fmaf chain in ascending src, alpha applied after the sum; padded
// rows write 0. Rows are in RCM order, so the groups in flight read
// neighbouring x rows, which the 50 MB L2 keeps (all of x is 640 MB at
// n = 160). No atomics: a repeat launch is bit-identical. A block row's
// tiles start at a size_t offset (the 1M pack holds 3.3e9 floats); `off`
// inside one block row fits int32.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "csr_rows.cuh"

namespace {

template <typename T, typename X>
int run(const void* tiles, const int* row_ptr, const int* src, const int* off, const void* x,
        void* y, int nbr, int max_b, int bs, int n, float alpha, cudaStream_t s) {
  // VnPass: vals, row_stride, row_ptr, src, off, scales, live_rows, x, add, out, rows, bs,
  // n, alpha, beta
  return csr_rows::vn_pass<T, X>({static_cast<const T*>(tiles), (size_t)max_b * bs * bs,
                                  row_ptr, src, off, nullptr, 0, static_cast<const X*>(x),
                                  nullptr, static_cast<X*>(y), nbr * bs, bs, n, alpha, 0.0f},
                                 s);
}

}  // namespace

extern "C" {

// K10. tiles [nbr, max_b, bs, bs] row-major, float32 (tiles_bf16 0) or bf16
// (1); the pack's nonzero index row_ptr [nbr*bs + 1], src and off [nnz]
// int32; x, y [nbr*bs, n] row-major, float32 (x_bf16 0) or bf16 (1), any
// alignment (16-byte vectors only where both are 16-byte aligned and n is a
// multiple of the vector: 4 float32 or 8 bf16). Needs bs % 16 == 0, every
// src < nbr*bs and every off < max_b*bs*bs. A bf16 y is the float32 sum
// times alpha, rounded once.
int stgcn_bcsr_spmm(const void* tiles, const int* row_ptr, const int* src, const int* off,
                    const void* x, void* y, int nbr, int max_b, int bs, int n, int tiles_bf16,
                    int x_bf16, float alpha, void* stream) {
  if (bs <= 0 || bs % 16 != 0 || nbr <= 0 || max_b <= 0 || n < 0 ||
      (size_t)nbr * bs >= 0x7fffffffu || tiles_bf16 < 0 || tiles_bf16 > 1 || x_bf16 < 0 ||
      x_bf16 > 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using csr_rows::bf16;
  if (x_bf16)
    return tiles_bf16 ? run<bf16, bf16>(tiles, row_ptr, src, off, x, y, nbr, max_b, bs, n, alpha, s)
                      : run<float, bf16>(tiles, row_ptr, src, off, x, y, nbr, max_b, bs, n, alpha,
                                         s);
  return tiles_bf16 ? run<bf16, float>(tiles, row_ptr, src, off, x, y, nbr, max_b, bs, n, alpha, s)
                    : run<float, float>(tiles, row_ptr, src, off, x, y, nbr, max_b, bs, n, alpha,
                                        s);
}

}  // extern "C"
