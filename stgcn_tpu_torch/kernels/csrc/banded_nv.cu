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
// Modes (one C entry point, two or three launches):
//   single: out = scale * A x
//   pair:   mid = A x;            out = 2 A mid - x
//   chain:  mid = 2 A x + g;      out = A mid - x      (x = g2, g = g1)
// On the TPU, stage 2 of block i reads stage-1 blocks that earlier steps of
// a sequential grid left in a VMEM ring (a wavefront). A CUDA grid runs in
// no order, so here the two stages are two passes over the whole operand:
// pass 1 writes `mid` to device memory (and in vn to the workspace), pass 2
// reads it.
//
// What bounds it: bytes. The pack is dense over the band, but a road graph
// fills 0.57 % of it (100k vertices, RCM, bs = 256: nnz 1.02 M in 391 slabs
// of 1792 x 256): one application at N = 1280 is 459 GFLOP of band FLOPs
// against 2.6 GFLOP of useful work. So the kernel never walks the band: it
// walks the pack's nonzero index (kernels/nnz_index.py, index_from_slabs:
// row_ptr [vp + 1], src = lo_i + k and off = k*bs + b in CSR order, by
// output lane then ascending source vertex; lanes past nbr*bs empty),
// reading each value from its slab at its offset, int8 widened to float32.
//
// Design: K6's transposing walk (nv_rows.cuh): x transposed by hand into the
// workspace, then a warp per output lane gathers the x rows of its
// nonzeros (csr_rows.cuh's row walk, K10's), the sums going out in nv
// through shared memory; the pair's first pass keeps its result in vn for
// the second. Each output element is one fmaf chain in ascending source
// vertex, the order in which the band kernel summed it (its zero terms left
// out), so the outputs are the band kernel's bit for bit, up to the sign of
// an all-zero sum. No atomics: a repeat launch is bit-identical.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "nv_rows.cuh"

extern "C" {

// K5. slabs [nbr, w, bs] float32 (int8 when `int8`); the pack's nonzero
// index for a vp-wide operand: row_ptr [vp + 1], src and off [nnz] int32,
// every src < vp and every off < w*bs; scales [nbr, bs] float32 (int8 only,
// else null); x, g, mid, out [n, vp], x 16-byte aligned; g only for chain,
// mid for pair and chain; work n * vp floats (single) or twice that (pair,
// chain). mode 0 single, 1 pair, 2 chain. Needs vp % 32 == 0.
int stgcn_banded_nv(const void* slabs, const int* row_ptr, const int* src, const int* off,
                    const float* scales, const float* x, const float* g, float* mid, float* out,
                    float* work, int nbr, int w, int bs, int n, int vp, int int8, int mode,
                    float scale, void* stream) {
  if (bs <= 0 || w <= 0 || nbr <= 0 || n < 0 || vp <= 0 || vp % nv_rows::kRows != 0 ||
      mode < 0 || mode > 2 || (int8 != 0) != (scales != nullptr) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || (mode == 2 && g == nullptr) ||
      (mode != 0 && mid == nullptr) || work == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t stride = (size_t)w * bs;
  const int live = nbr * bs;
  // PassArgs: vals, row_stride, row_ptr, src, off, scales, live_rows, xt, add, out, out_t,
  // bs, n, vp, alpha, beta (the modes set xt, add, out, out_t, alpha, beta)
  if (int8)
    return nv_rows::nv_modes<int8_t>({static_cast<const int8_t*>(slabs), stride, row_ptr, src,
                                      off, scales, live, nullptr, nullptr, nullptr, nullptr, bs,
                                      n, vp, 1.0f, 0.0f},
                                     x, g, mid, out, work, mode, scale, s);
  return nv_rows::nv_modes<float>({static_cast<const float*>(slabs), stride, row_ptr, src, off,
                                   nullptr, live, nullptr, nullptr, nullptr, nullptr, bs, n, vp,
                                   1.0f, 0.0f},
                                  x, g, mid, out, work, mode, scale, s);
}

}  // extern "C"
