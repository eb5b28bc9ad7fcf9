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
// What bounds it: bytes. The pack is dense over the band, but a road graph
// fills 0.57 % of it (100k vertices, RCM, bs = 256: nnz 1.02 M in 391 slabs
// of 256 x 1792): one application at N = 1280 is 459 GFLOP of band FLOPs
// against 2.6 GFLOP of useful work. So the kernel never walks the band: it
// walks the pack's nonzero index (kernels/nnz_index.py, index_from_slabs:
// row_ptr [rows + 1], src = lo_i + k and off = a*w + k in CSR order, by
// output row then ascending source vertex; rows past nbr*bs empty), reading
// each value from its slab at its offset, int8 widened to float32. What it
// moves is the index (8 B a nonzero), a value sector a nonzero, the
// gathered x rows (nnz * n * 4 bytes an application, which L2 must catch:
// the rows are in RCM order) and each output once.
//
// Design: K10's kernel (csr_rows.cuh vn_modes / vn_pass): G lanes per output
// row (a warp; a half-warp where n <= 64) load G (src, value) pairs at once,
// broadcast them by shuffle and add value * x[src, :] (one coalesced row
// read, float4 where n % 4 == 0 and the operands are 16-byte aligned) into
// the row's sums; the epilogue alpha * (acc * s) + beta * add follows the
// sum. Each output element is one fmaf chain in ascending source vertex,
// the order in which the band kernel summed it (its zero terms left out),
// so the outputs are the band kernel's bit for bit, up to the sign of an
// all-zero sum. No atomics: a repeat launch is bit-identical.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "csr_rows.cuh"

extern "C" {

// K7-K9. slabs [nbr, bs, w] float32 (int8 when `int8`); the pack's nonzero
// index for `rows` operand rows: row_ptr [rows + 1], src and off [nnz]
// int32, every src < rows and every off < bs*w; scales [nbr, bs] float32
// (int8 only, else null); x, g, mid, out [rows, n] float32, any alignment;
// g only for chain, mid for pair and chain. mode 0 single, 1 pair, 2 chain.
int stgcn_banded_vn(const void* slabs, const int* row_ptr, const int* src, const int* off,
                    const float* scales, const float* x, const float* g, float* mid, float* out,
                    int nbr, int bs, int w, int rows, int n, int int8, int mode, float scale,
                    void* stream) {
  if (bs <= 0 || w <= 0 || nbr <= 0 || rows < 0 || n < 0 || mode < 0 || mode > 2 ||
      (int8 != 0) != (scales != nullptr) || (mode == 2 && g == nullptr) ||
      (mode != 0 && mid == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t stride = (size_t)bs * w;
  const int live = nbr * bs;
  // VnPass: vals, row_stride, row_ptr, src, off, scales, live_rows, x, add, out, rows, bs,
  // n, alpha, beta (the modes set x, add, out, alpha, beta)
  if (int8)
    return csr_rows::vn_modes<int8_t>({static_cast<const int8_t*>(slabs), stride, row_ptr, src,
                                       off, scales, live, nullptr, nullptr, nullptr, rows, bs, n,
                                       1.0f, 0.0f},
                                      x, g, mid, out, mode, scale, s);
  return csr_rows::vn_modes<float>({static_cast<const float*>(slabs), stride, row_ptr, src, off,
                                    nullptr, live, nullptr, nullptr, nullptr, rows, bs, n, 1.0f,
                                    0.0f},
                                   x, g, mid, out, mode, scale, s);
}

}  // extern "C"
