// The register tiling of the SDDMM K11 (bcsr_sddmm.cu): a block of kThreads
// threads owns a kTm-row x kTn-column output tile and walks its reduction in
// steps of kTk, both operand pieces staged in shared memory as [k][row] and
// [k][col]; each thread keeps a 4 x 4 accumulator in registers, float32 FMA
// (no TF32: the parity bound is 1e-4). Sums run in a fixed order, no
// atomics: a repeat launch is bit-identical.
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
  __align__(16) float xs[kTk][kTm];  // first operand piece: [k][row]
  __align__(16) float as[kTk][kTn];  // second operand piece: [k][col]
};

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

}  // namespace nvtile
