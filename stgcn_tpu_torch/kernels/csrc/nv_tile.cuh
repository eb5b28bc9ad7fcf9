// The register tiling of the banded nv SpMM kernel K5 (banded_nv.cu):
// y[:, block i] = sum of x column windows @ pre-transposed operator tiles,
// every operand [n, vp] row-major float32; with the operands' roles swapped
// (the row-major operator staged transposed by stage_x, the operand row by
// row by stage_x_rows), of the vn kernel of K7-K9 (banded_vn.cu); and of
// the SDDMM K11 (bcsr_sddmm.cu).
//
// A block of kThreads threads owns a kTm-row x kTn-column output tile and
// walks its reduction in steps of kTk: it stages the x tile (kTk columns of
// kTm rows, read as float4, transposed) and the operator sub-tile (kTk x kTn,
// float32 or int8 widened to float32) in shared memory; each thread keeps a
// 4 x 4 accumulator in registers, float32 FMA (no TF32: the parity bound is
// 1e-4). Sums run in a fixed order, no atomics: a repeat launch is
// bit-identical. Offsets are size_t.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace nvtile {

constexpr int kTm = 64;        // output rows per block
constexpr int kTn = 64;        // output columns per block
constexpr int kTk = 16;        // reduction columns staged per step
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

struct Smem {
  __align__(16) float xs[kTk][kTm];  // x tile, transposed: [k][row]
  __align__(16) float as[kTk][kTn];  // operator sub-tile: [k][col]
};

// x[r0 + row, c + k] for k < kTk into xs; rows >= n and columns >= vp read 0.
__device__ __forceinline__ void stage_x(Smem& s, const float* x, int n, int vp, int r0, int c) {
  const int tid = threadIdx.x;
  const int xr = r0 + tid / 4, xq = 4 * (tid % 4);   // row, first of 4 columns
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (xr < n && c + xq < vp) v = *reinterpret_cast<const float4*>(x + (size_t)xr * vp + c + xq);
  s.xs[xq + 0][tid / 4] = v.x;
  s.xs[xq + 1][tid / 4] = v.y;
  s.xs[xq + 2][tid / 4] = v.z;
  s.xs[xq + 3][tid / 4] = v.w;
}

// The same from int8 values (x 4-byte aligned, vp % 4 == 0), widened to float32.
__device__ __forceinline__ void stage_x(Smem& s, const int8_t* x, int n, int vp, int r0, int c) {
  const int tid = threadIdx.x;
  const int xr = r0 + tid / 4, xq = 4 * (tid % 4);
  char4 q = make_char4(0, 0, 0, 0);
  if (xr < n && c + xq < vp) q = *reinterpret_cast<const char4*>(x + (size_t)xr * vp + c + xq);
  s.xs[xq + 0][tid / 4] = (float)q.x;
  s.xs[xq + 1][tid / 4] = (float)q.y;
  s.xs[xq + 2][tid / 4] = (float)q.z;
  s.xs[xq + 3][tid / 4] = (float)q.w;
}

// x[row0 + k, c0 + c] for k < kTk, c < kTn into as[k][c], x [rows, n]
// row-major; rows >= rows and columns >= n read 0. One coalesced 256-byte
// row segment per 64 threads.
__device__ __forceinline__ void stage_x_rows(Smem& s, const float* x, int n, size_t rows,
                                             size_t row0, int c0) {
  constexpr int kRowsPerPass = kThreads / kTn;
  const int c = threadIdx.x % kTn;
  const bool live = c0 + c < n;
#pragma unroll
  for (int m = 0; m < kTk / kRowsPerPass; ++m) {
    const int k = threadIdx.x / kTn + m * kRowsPerPass;
    s.as[k][c] = live && row0 + k < rows ? x[(row0 + k) * n + c0 + c] : 0.0f;
  }
}

// a[k * ld + col] for k < kTk, col < kTn into as (a 16-byte aligned).
__device__ __forceinline__ void stage_a(Smem& s, const float* a, int ld) {
  const int sk = threadIdx.x / 16, sq = 4 * (threadIdx.x % 16);
  *reinterpret_cast<float4*>(&s.as[sk][sq]) =
      *reinterpret_cast<const float4*>(a + (size_t)sk * ld + sq);
}

// The same from int8 values (a 4-byte aligned), widened to float32.
__device__ __forceinline__ void stage_a(Smem& s, const int8_t* a, int ld) {
  const int sk = threadIdx.x / 16, sq = 4 * (threadIdx.x % 16);
  const char4 q = *reinterpret_cast<const char4*>(a + (size_t)sk * ld + sq);
  *reinterpret_cast<float4*>(&s.as[sk][sq]) =
      make_float4((float)q.x, (float)q.y, (float)q.z, (float)q.w);
}

// acc[i][j] += sum over k < kTk of xs[k][4 ty + i] * as[k][4 tx + j].
__device__ __forceinline__ void fma_tile(const Smem& s, float (&acc)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int kk = 0; kk < kTk; ++kk) {
    const float4 xa = *reinterpret_cast<const float4*>(&s.xs[kk][ty * 4]);
    const float4 sb = *reinterpret_cast<const float4*>(&s.as[kk][tx * 4]);
    const float xv4[4] = {xa.x, xa.y, xa.z, xa.w};
    const float sv4[4] = {sb.x, sb.y, sb.z, sb.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv4[i], sv4[j], acc[i][j]);
  }
}

// out[r, c] = alpha * (acc * lane_scale[c]) + beta * add[r, c] over the
// thread's 4 x 4 outputs of the tile at (r0, c0); lane_scale and add may be
// null (factor 1, no term); rows >= n are not written.
__device__ __forceinline__ void store(float (&acc)[4][4], const float* lane_scale,
                                      float alpha, float beta, const float* add, float* out,
                                      int n, int vp, int r0, int c0) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int c = c0 + tx * 4;
  float sc[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  if (lane_scale != nullptr) {
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[j] = lane_scale[c + j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= n) continue;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = alpha * (lane_scale != nullptr ? acc[i][j] * sc[j] : acc[i][j]);
      if (add != nullptr) v[j] = fmaf(beta, add[(size_t)r * vp + c + j], v[j]);
    }
    *reinterpret_cast<float4*>(out + (size_t)r * vp + c) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

}  // namespace nvtile
