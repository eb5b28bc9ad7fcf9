// K7-K9: banded SpMM on the vn operand [V, N] (replaces four TPU kernels of
// stgcn_tpu/kernels/banded_spmm.py: K7a `_banded_pallas_resident` :255 and
// K7b `_banded_pallas` :302, one application with x resident in VMEM or
// streamed by DMA; K8 `banded_cheb_pair` :519 and K9 `_pair_stream_call`
// :774, the Chebyshev pair and its VJP chain as wavefronts over a
// sequential grid), float32, bf16 or int8 slabs under a float32 or bf16
// operand.
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
// bf16 (the TPU's bf16 operands into an f32 accumulator, :214-219, :245-250):
// a bf16 operand row is read as 16-byte vectors of eight (scalar where n %
// 8 != 0 or an operand is not 16-byte aligned) and widened exactly; bf16
// slab values widen exactly too. The sum is the float32 fmaf chain of the
// float32 operand, the epilogue alpha * (acc * s) + beta * add runs in
// float32, and its result is rounded once to bf16 (round to nearest even).
// In pair and chain `mid` is stored in bf16, as the TPU kernel rounds T1
// (`t1c`, :719-721, in chain from 2 * acc + g in float32, :718) before
// stage 2 reads it; pass 2 reads that, and its out = round(y2 - x) from
// float32 (:744-748).
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

namespace {

template <typename T, typename X>
int run(const void* slabs, const int* row_ptr, const int* src, const int* off,
        const float* scales, const void* x, const void* g, void* mid, void* out, int nbr,
        int bs, int w, int rows, int n, int mode, float scale, cudaStream_t s) {
  // VnPass: vals, row_stride, row_ptr, src, off, scales, live_rows, x, add, out, rows, bs,
  // n, alpha, beta (the modes set x, add, out, alpha, beta)
  return csr_rows::vn_modes<T, X>({static_cast<const T*>(slabs), (size_t)bs * w, row_ptr, src,
                                   off, scales, nbr * bs, nullptr, nullptr, nullptr, rows, bs,
                                   n, 1.0f, 0.0f},
                                  static_cast<const X*>(x), static_cast<const X*>(g),
                                  static_cast<X*>(mid), static_cast<X*>(out), mode, scale, s);
}

template <typename X>
int run_x(int vals_type, const void* slabs, const int* row_ptr, const int* src, const int* off,
          const float* scales, const void* x, const void* g, void* mid, void* out, int nbr,
          int bs, int w, int rows, int n, int mode, float scale, cudaStream_t s) {
  if (vals_type == 1)
    return run<int8_t, X>(slabs, row_ptr, src, off, scales, x, g, mid, out, nbr, bs, w, rows,
                          n, mode, scale, s);
  if (vals_type == 2)
    return run<csr_rows::bf16, X>(slabs, row_ptr, src, off, scales, x, g, mid, out, nbr, bs,
                                  w, rows, n, mode, scale, s);
  return run<float, X>(slabs, row_ptr, src, off, scales, x, g, mid, out, nbr, bs, w, rows, n,
                       mode, scale, s);
}

}  // namespace

extern "C" {

// K7-K9. slabs [nbr, bs, w]: vals_type 0 float32, 1 int8, 2 bf16; the pack's
// nonzero index for `rows` operand rows: row_ptr [rows + 1], src and off
// [nnz] int32, every src < rows and every off < bs*w; scales [nbr, bs]
// float32 (int8 only, else null); x, g, mid, out [rows, n], float32
// (x_bf16 0) or bf16 (x_bf16 1), any alignment; g only for chain, mid for
// pair and chain. mode 0 single, 1 pair, 2 chain.
int stgcn_banded_vn(const void* slabs, const int* row_ptr, const int* src, const int* off,
                    const float* scales, const void* x, const void* g, void* mid, void* out,
                    int nbr, int bs, int w, int rows, int n, int vals_type, int x_bf16, int mode,
                    float scale, void* stream) {
  if (bs <= 0 || w <= 0 || nbr <= 0 || rows < 0 || n < 0 || mode < 0 || mode > 2 ||
      vals_type < 0 || vals_type > 2 || x_bf16 < 0 || x_bf16 > 1 ||
      (vals_type == 1) != (scales != nullptr) || (mode == 2 && g == nullptr) ||
      (mode != 0 && mid == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return run_x<csr_rows::bf16>(vals_type, slabs, row_ptr, src, off, scales, x, g, mid, out,
                                 nbr, bs, w, rows, n, mode, scale, s);
  return run_x<float>(vals_type, slabs, row_ptr, src, off, scales, x, g, mid, out, nbr, bs, w,
                      rows, n, mode, scale, s);
}

}  // extern "C"
