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
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "nv_rows.cuh"

extern "C" {

// K6. tiles [nbr, max_b, bs, bs] float32 (int8 when `int8`), the pack's
// nonzero index row_ptr [nbr*bs + 1], src and off [nnz] int32, scales [nbr,
// bs] float32 (int8 only, else null); x, g, mid, out [n, nbr*bs], x 16-byte
// aligned; g only for chain, mid for pair and chain; work n * nbr*bs floats
// (single) or twice that (pair, chain). mode 0 single, 1 pair, 2 chain.
// Needs bs % 64 == 0, every src < nbr*bs and every off < max_b*bs*bs.
int stgcn_ell_nv(const void* tiles, const int* row_ptr, const int* src, const int* off,
                 const float* scales, const float* x, const float* g, float* mid, float* out,
                 float* work, int nbr, int max_b, int bs, int n, int int8, int mode, float scale,
                 void* stream) {
  if (bs <= 0 || bs % 64 != 0 || nbr <= 0 || max_b <= 0 || n < 0 || mode < 0 || mode > 2 ||
      (int8 != 0) != (scales != nullptr) || (size_t)nbr * bs >= 0x7fffffffu ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || (mode == 2 && g == nullptr) ||
      (mode != 0 && mid == nullptr) || work == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vp = nbr * bs;
  const size_t stride = (size_t)max_b * bs * bs;
  // PassArgs: vals, row_stride, row_ptr, src, off, scales, live_rows, xt, add, out, out_t,
  // bs, n, vp, alpha, beta (the modes set xt, add, out, out_t, alpha, beta)
  if (int8)
    return nv_rows::nv_modes<int8_t>({static_cast<const int8_t*>(tiles), stride, row_ptr, src,
                                      off, scales, vp, nullptr, nullptr, nullptr, nullptr, bs, n,
                                      vp, 1.0f, 0.0f},
                                     x, g, mid, out, work, mode, scale, s);
  return nv_rows::nv_modes<float>({static_cast<const float*>(tiles), stride, row_ptr, src, off,
                                   scales, vp, nullptr, nullptr, nullptr, nullptr, bs, n, vp,
                                   1.0f, 0.0f},
                                  x, g, mid, out, work, mode, scale, s);
}

}  // extern "C"
