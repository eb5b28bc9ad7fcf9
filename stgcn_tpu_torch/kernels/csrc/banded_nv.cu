// K5: banded SpMM on the nv operand [N, V] (replaces the TPU kernel
// `_stream_nv_call`, stgcn_tpu/kernels/banded_nv.py:208), float32 or int8
// slabs under a float32 operand, float32, bf16 or int8 slabs under a bf16
// one.
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
//
// bf16 (the TPU kernel's bf16 operand into an f32 accumulator, :141-183):
// the operand is transposed as bf16 and read as 16-byte vectors of eight,
// widened exactly, as are bf16 slab values. Stage 1 sums in float32, takes
// the int8 lane factor, for chain 2 * acc + g in float32, and rounds once
// to bf16 (`t1c`, :157-160): that value is both the output t1 / u and the
// operand of stage 2 (`mid` and its vn copy are bf16). Stage 2 sums over
// that bf16 t1 in float32, doubles (pair), takes the lane factor, subtracts
// x in float32 and rounds once (:179-183); single rounds once after alpha
// and the factor.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "nv_rows.cuh"

namespace {

template <typename T, typename X>
int run(const void* slabs, const int* row_ptr, const int* src, const int* off,
        const float* scales, const void* x, const void* g, void* mid, void* out, void* work,
        int nbr, int w, int bs, int n, int vp, int mode, float scale, cudaStream_t s) {
  // PassArgs: vals, row_stride, row_ptr, src, off, scales, live_rows, xt, add, out, out_t,
  // bs, n, vp, alpha, beta (the modes set xt, add, out, out_t, alpha, beta)
  return nv_rows::nv_modes<T, X>({static_cast<const T*>(slabs), (size_t)w * bs, row_ptr, src,
                                  off, scales, nbr * bs, nullptr, nullptr, nullptr, nullptr,
                                  bs, n, vp, 1.0f, 0.0f},
                                 static_cast<const X*>(x), static_cast<const X*>(g),
                                 static_cast<X*>(mid), static_cast<X*>(out),
                                 static_cast<X*>(work), mode, scale, s);
}

}  // namespace

extern "C" {

// K5. slabs [nbr, w, bs]: vals_type 0 float32, 1 int8, 2 bf16 (bf16 only
// under a bf16 operand); the pack's nonzero index for a vp-wide operand:
// row_ptr [vp + 1], src and off [nnz] int32, every src < vp and every off <
// w*bs; scales [nbr, bs] float32 (int8 only, else null); x, g, mid, out [n,
// vp], float32 (x_bf16 0) or bf16 (x_bf16 1), x 16-byte aligned; g only for
// chain, mid for pair and chain; work n * vp elements of x's type (single)
// or twice that (pair, chain), 16-byte aligned. mode 0 single, 1 pair, 2
// chain. Needs vp % 32 == 0.
int stgcn_banded_nv(const void* slabs, const int* row_ptr, const int* src, const int* off,
                    const float* scales, const void* x, const void* g, void* mid, void* out,
                    void* work, int nbr, int w, int bs, int n, int vp, int vals_type,
                    int x_bf16, int mode, float scale, void* stream) {
  if (bs <= 0 || w <= 0 || nbr <= 0 || n < 0 || vp <= 0 || vp % nv_rows::kRows != 0 ||
      mode < 0 || mode > 2 || vals_type < 0 || vals_type > 2 || x_bf16 < 0 || x_bf16 > 1 ||
      (vals_type == 2 && !x_bf16) || (vals_type == 1) != (scales != nullptr) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(work) % 16 != 0 ||
      (mode == 2 && g == nullptr) || (mode != 0 && mid == nullptr) || work == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (vals_type == 1)
      return run<int8_t, csr_rows::bf16>(slabs, row_ptr, src, off, scales, x, g, mid, out, work,
                                         nbr, w, bs, n, vp, mode, scale, s);
    if (vals_type == 2)
      return run<csr_rows::bf16, csr_rows::bf16>(slabs, row_ptr, src, off, scales, x, g, mid,
                                                 out, work, nbr, w, bs, n, vp, mode, scale, s);
    return run<float, csr_rows::bf16>(slabs, row_ptr, src, off, scales, x, g, mid, out, work,
                                      nbr, w, bs, n, vp, mode, scale, s);
  }
  if (vals_type == 1)
    return run<int8_t, float>(slabs, row_ptr, src, off, scales, x, g, mid, out, work, nbr, w,
                              bs, n, vp, mode, scale, s);
  return run<float, float>(slabs, row_ptr, src, off, scales, x, g, mid, out, work, nbr, w, bs,
                           n, vp, mode, scale, s);
}

}  // extern "C"
