// K6: blocked-ELL SpMM on the nv operand [N, V] (replaces the TPU kernel
// `_ell_nv_pallas`, stgcn_tpu/kernels/ell_nv.py:123), float32 or int8 tiles
// under a float32 operand, float32, int8 or bf16 tiles under a bf16 one.
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
// Modes (one C entry point, two or three launches), as K5's:
//   single: out = scale * A x
//   pair:   mid = A x;            out = 2 A mid - x
//   chain:  mid = 2 A x + g;      out = A mid - x      (x = g2, g = g1)
// The JAX package runs the pair as two applications and 2y - x outside the
// kernel; here the second pass folds it into its epilogue (the same
// function: fma(-1, x, 2y) is 2y - x rounded once).
//
// What bounds it: bytes. A road graph fills a live tile to under 1 % (at 1M
// vertices, RCM, bs = 256: 10.2M nonzeros in 34,113 tiles), so this kernel
// touches only the nonzeros, through the pack's nonzero index (kernels/
// nnz_index.py: row_ptr, src, off in CSR order by output lane, then
// ascending source vertex); the values stay in the tiles and are read at
// their offsets, int8 widened to float32. What the kernel moves is x read
// and written once more (the transpose), the index (8 B a nonzero) and a
// value sector a nonzero, the gathered x rows (nnz * n * 4 bytes an
// application, which L2 must catch: the rows are in RCM order), and each
// output written once (the pair's middle result twice, nv and vn).
//
// Design: the transposing walk of nv_rows.cuh (shared with K5, banded_nv.cu):
// a hand-written transpose of x into the workspace, then a gather pass a
// warp per output row over csr_rows.cuh's row walk (K10's), the sums going
// out in nv through shared memory. A block row's tiles start at a size_t
// offset (the f32 pack holds 3.3e9 elements at 1M). A window kernel that
// staged each live tile's x columns in shared memory instead was 5.3x
// slower on an H100 (int8 pair at N = 160 + 96; PERF.md).
//
// bf16: the operand is transposed as bf16 and read as 16-byte vectors of
// eight, widened exactly, as are bf16 tile values; each sum runs in
// float32. The JAX ELL path writes each application in x's type (:116-118)
// and combines the rounded products in float32 before rounding again
// (`ell_cheb_pair_nv` :274-285, `_pair_bwd` :302-313), so where an add
// follows (pair pass 2, both chain passes) this variant rounds the product
// alpha * (A x) * lane_scale to bf16 first (nv_rows.cuh's ROUND), then
// runs the add in float32 and rounds once more; single mode and pair pass
// 1 round once.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "nv_rows.cuh"

namespace {

template <typename T, typename X, bool ROUND>
int run(const void* tiles, const int* row_ptr, const int* src, const int* off,
        const float* scales, const void* x, const void* g, void* mid, void* out, void* work,
        int nbr, int max_b, int bs, int n, int mode, float scale, cudaStream_t s) {
  const int vp = nbr * bs;
  // PassArgs: vals, row_stride, row_ptr, src, off, scales, live_rows, xt, add, out, out_t,
  // bs, n, vp, alpha, beta (the modes set xt, add, out, out_t, alpha, beta)
  return nv_rows::nv_modes<T, X, ROUND>(
      {static_cast<const T*>(tiles), (size_t)max_b * bs * bs, row_ptr, src, off, scales, vp,
       nullptr, nullptr, nullptr, nullptr, bs, n, vp, 1.0f, 0.0f},
      static_cast<const X*>(x), static_cast<const X*>(g), static_cast<X*>(mid),
      static_cast<X*>(out), static_cast<X*>(work), mode, scale, s);
}

}  // namespace

extern "C" {

// K6. tiles [nbr, max_b, bs, bs]: vals_type 0 float32, 1 int8, 2 bf16 (bf16
// only under a bf16 operand); the pack's nonzero index row_ptr [nbr*bs + 1],
// src and off [nnz] int32, scales [nbr, bs] float32 (int8 only, else null);
// x, g, mid, out [n, nbr*bs], float32 (x_bf16 0) or bf16 (x_bf16 1), x
// 16-byte aligned; g only for chain, mid for pair and chain; work n * nbr*bs
// elements of x's type (single) or twice that (pair, chain), 16-byte
// aligned. mode 0 single, 1 pair, 2 chain. Needs bs % 64 == 0, every src <
// nbr*bs and every off < max_b*bs*bs.
int stgcn_ell_nv(const void* tiles, const int* row_ptr, const int* src, const int* off,
                 const float* scales, const void* x, const void* g, void* mid, void* out,
                 void* work, int nbr, int max_b, int bs, int n, int vals_type, int x_bf16,
                 int mode, float scale, void* stream) {
  if (bs <= 0 || bs % 64 != 0 || nbr <= 0 || max_b <= 0 || n < 0 || mode < 0 || mode > 2 ||
      vals_type < 0 || vals_type > 2 || x_bf16 < 0 || x_bf16 > 1 ||
      (vals_type == 2 && !x_bf16) || (vals_type == 1) != (scales != nullptr) ||
      (size_t)nbr * bs >= 0x7fffffffu || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(work) % 16 != 0 || (mode == 2 && g == nullptr) ||
      (mode != 0 && mid == nullptr) || work == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using csr_rows::bf16;
  if (x_bf16) {
    if (vals_type == 1)
      return run<int8_t, bf16, true>(tiles, row_ptr, src, off, scales, x, g, mid, out, work,
                                     nbr, max_b, bs, n, mode, scale, s);
    if (vals_type == 2)
      return run<bf16, bf16, true>(tiles, row_ptr, src, off, scales, x, g, mid, out, work,
                                   nbr, max_b, bs, n, mode, scale, s);
    return run<float, bf16, true>(tiles, row_ptr, src, off, scales, x, g, mid, out, work, nbr,
                                  max_b, bs, n, mode, scale, s);
  }
  if (vals_type == 1)
    return run<int8_t, float, false>(tiles, row_ptr, src, off, scales, x, g, mid, out, work,
                                     nbr, max_b, bs, n, mode, scale, s);
  return run<float, float, false>(tiles, row_ptr, src, off, scales, x, g, mid, out, work, nbr,
                                  max_b, bs, n, mode, scale, s);
}

}  // extern "C"
