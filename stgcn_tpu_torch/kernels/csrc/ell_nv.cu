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
// their offsets, int8 widened to float32. In the nv layout a column
// x[:, u] is n values vp*4 bytes apart, a sector each, so the operand is
// turned to vn first: what the kernel moves is x read and written once more
// (the transpose), the index (8 B a nonzero) and a value sector a nonzero,
// the gathered x rows (nnz * n * 4 bytes an application, which L2 must
// catch: the rows are in RCM order), and each output written once (the
// pair's middle result twice, nv and vn).
//
// Design: (1) a hand-written transpose of x into the workspace, [vp, n],
// float4 reads, through a padded shared tile; (2) a gather pass: a block
// per 32 output rows, a warp per row at a time, its lanes over 32 operand
// columns each (up to 256 a chunk), walking the row with csr_rows.cuh as
// K10 does: the lanes load 32 (src, value) pairs at once and broadcast them
// by shuffle, and each pair adds value * x_vn[src, :] (one coalesced row
// read) into the row's sums; the 32 x chunk sums go
// out through shared memory, so the nv stores and the epilogue's reads of
// g or x are 128 contiguous bytes a warp. The pair's and chain's first pass
// also writes its result in vn for the second, so no transpose comes back.
// Each output element is one fmaf chain in ascending source vertex, the lane
// factor and alpha applied after the sum; no atomics: a repeat launch is
// bit-identical. A block row's tiles start at a size_t offset (the f32
// pack holds 3.3e9 elements at 1M). A window kernel that staged each live
// tile's x columns in shared memory instead was 5.3x slower on an H100
// (int8 pair at N = 160 + 96; PERF.md, PR 12).
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "csr_rows.cuh"

namespace {

constexpr int kRows = 32;   // output rows (vertices) a gather block, 4 a warp at a time

// in [n, vp] -> out [vp, n]; a block moves 32 operand rows x 128 vertices
__global__ void __launch_bounds__(256)
    transpose_kernel(const float* __restrict__ in, float* __restrict__ out, int n, int vp) {
  __shared__ float tile[32][129];
  const int c0 = blockIdx.x * 128, r0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  if (c0 + 4 * tx < vp)   // vp % 4 == 0: a float4 is whole or out
    for (int j = ty; j < 32 && r0 + j < n; j += 8) {
      const float4 v =
          *reinterpret_cast<const float4*>(in + (size_t)(r0 + j) * vp + c0 + 4 * tx);
      tile[j][4 * tx + 0] = v.x;
      tile[j][4 * tx + 1] = v.y;
      tile[j][4 * tx + 2] = v.z;
      tile[j][4 * tx + 3] = v.w;
    }
  __syncthreads();
  if (r0 + tx < n)
    for (int c = ty; c < 128 && c0 + c < vp; c += 8)
      out[(size_t)(c0 + c) * n + r0 + tx] = tile[tx][c];
}

// out = alpha * (A x) * lane_scale + beta * add, with x given as xt [vp, n]
template <typename T>
struct PassArgs {
  const T* tiles;       // [nbr, max_b, bs, bs]
  const int* row_ptr;   // [vp + 1]
  const int* src;       // [nnz]
  const int* off;       // [nnz]
  const float* scales;  // [vp] or null
  const float* xt;      // [vp, n]
  const float* add;     // [n, vp] or null
  float* out;           // [n, vp]
  float* out_t;         // [vp, n]: the result again in vn, or null
  int max_b, bs, n, vp;
  float alpha, beta;
};

// Q operand columns a lane, 32 * Q a chunk
template <typename T, int Q>
__global__ void __launch_bounds__(256) ell_gather_kernel(PassArgs<T> a) {
  constexpr int kW = 32 * Q;
  __shared__ float ys[kRows][kW + 1];
  const int r0 = blockIdx.x * kRows;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int c0 = 0; c0 < a.n; c0 += kW) {
    for (int q4 = 0; q4 < kRows / 8; ++q4) {
      const int rl = w * (kRows / 8) + q4, row = r0 + rl;
      const int beg = a.row_ptr[row], end = a.row_ptr[row + 1];
      const T* vals = a.tiles + (size_t)(row / a.bs) * a.max_b * a.bs * a.bs;
      float acc[Q];
      csr_rows::row_sums<32, Q, false>(vals, a.src, a.off, beg, end, a.xt, a.n, c0, lane, acc);
      const float sc = a.scales != nullptr ? a.scales[row] : 1.0f;
#pragma unroll
      for (int q = 0; q < Q; ++q)
        ys[rl][lane + 32 * q] = a.alpha * (a.scales != nullptr ? acc[q] * sc : acc[q]);
    }
    __syncthreads();
    // nv: a warp writes 32 consecutive vertices of one operand row
    for (int cc = w; cc < kW && c0 + cc < a.n; cc += 8) {
      const size_t at = (size_t)(c0 + cc) * a.vp + r0 + lane;
      float v = ys[lane][cc];
      if (a.add != nullptr) v = fmaf(a.beta, a.add[at], v);
      a.out[at] = v;
      ys[lane][cc] = v;
    }
    if (a.out_t != nullptr) {   // vn: a warp writes one row's chunk
      __syncthreads();
      for (int rl = w; rl < kRows; rl += 8)
        for (int cc = lane; cc < kW && c0 + cc < a.n; cc += 32)
          a.out_t[(size_t)(r0 + rl) * a.n + c0 + cc] = ys[rl][cc];
    }
    __syncthreads();
  }
}

template <typename T, int Q>
cudaError_t gather_q(const PassArgs<T>& a, cudaStream_t s) {
  ell_gather_kernel<T, Q><<<a.vp / kRows, 256, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t gather(const PassArgs<T>& a, cudaStream_t s) {
  const int q = (a.n + 31) / 32;   // wider operands loop over chunks of 256
  if (q <= 1) return gather_q<T, 1>(a, s);
  if (q <= 2) return gather_q<T, 2>(a, s);
  if (q <= 3) return gather_q<T, 3>(a, s);
  if (q <= 4) return gather_q<T, 4>(a, s);
  if (q <= 5) return gather_q<T, 5>(a, s);
  if (q <= 6) return gather_q<T, 6>(a, s);
  return gather_q<T, 8>(a, s);
}

template <typename T>
cudaError_t run_mode(PassArgs<T> a, const float* x, const float* g, float* mid, float* work,
                     int mode, float scale, cudaStream_t s) {
  float* xt = work;
  transpose_kernel<<<dim3((a.vp + 127) / 128, (a.n + 31) / 32), dim3(32, 8), 0, s>>>(
      x, xt, a.n, a.vp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  a.xt = xt;
  if (mode == 0) {
    a.alpha = scale;
    return gather<T>(a, s);
  }
  const bool chain = mode == 2;
  float* out = a.out;
  // pass 1: mid = A x (pair) or 2 A x + g (chain), also in vn for pass 2
  a.add = chain ? g : nullptr;
  a.out = mid;
  a.out_t = work + (size_t)a.vp * a.n;
  a.alpha = chain ? 2.0f : 1.0f;
  a.beta = 1.0f;
  err = gather<T>(a, s);
  if (err != cudaSuccess) return err;
  // pass 2: out = 2 A mid - x (pair) or A mid - x (chain)
  a.xt = a.out_t;
  a.out_t = nullptr;
  a.add = x;
  a.out = out;
  a.alpha = chain ? 1.0f : 2.0f;
  a.beta = -1.0f;
  return gather<T>(a, s);
}

}  // namespace

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
  if (n == 0) return cudaSuccess;
  if ((n + 31) / 32 > 65535) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vp = nbr * bs;
  if (int8)
    return run_mode<int8_t>({static_cast<const int8_t*>(tiles), row_ptr, src, off, scales,
                             nullptr, nullptr, out, nullptr, max_b, bs, n, vp, 1.0f, 0.0f},
                            x, g, mid, work, mode, scale, s);
  return run_mode<float>({static_cast<const float*>(tiles), row_ptr, src, off, scales, nullptr,
                          nullptr, out, nullptr, max_b, bs, n, vp, 1.0f, 0.0f},
                         x, g, mid, work, mode, scale, s);
}

}  // extern "C"
