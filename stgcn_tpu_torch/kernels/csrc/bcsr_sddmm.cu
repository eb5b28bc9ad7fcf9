// K11: blocked SDDMM at the live tiles of a BCSR pack (replaces the TPU
// kernel `_sddmm_pallas`, stgcn_tpu/kernels/sddmm.py:60), float32: the
// tile-value gradient of K10,
//
//   out[i, k][a, b] = alpha * sum_{c < n} g[i*bs + a, c] * x[cols[i, k]*bs + b, c]
//
// for k < counts[i], and zero in the padding slots k >= counts[i]
// (sddmm.py:104-109). g and x are [nbr*bs, n] row-major, any n >= 0.
//
// Design: the register tile of f32_tile.cuh with A = the slot's g rows and
// B = its x rows, both contiguous along c. A block owns one 128 x 128
// sub-tile of one slot (64 x 64 where bs is not a multiple of 128), 8 x 8
// (4 x 4) sums a thread; the grid runs slot by slot, a slot's sub-tiles
// together, so a block row's g rows and the x rows of nearby columns are
// read from HBM about once. A block sums all of n in a fixed order, 16 columns a
// step, staged two buffers deep: the next 16 columns load as float4 (where
// n % 4 == 0 and the operands are 16-byte aligned; scalar otherwise,
// columns past n read as 0) while the current ones multiply; the output is
// written with streaming stores (it is 3.3e9 floats at 1M vertices and
// would only push g and x out of L2). The TPU kernel
// carries its sum over N across a sequential grid axis; here the loop over n
// inside the block takes that axis' place, so there are no atomics and no
// second pass, and a repeat launch is bit-identical. A padding slot's blocks
// write zeros and read nothing. Offsets are size_t: the 1M-vertex output
// holds 3.3e9 floats.
//
// What bounds it: every FLOP of every live tile (2 bs^2 n a tile): at 1M
// vertices and n = 160, 0.72 TFLOP (>= 10.7 ms at 67 TFLOP/s) against about
// 4 ms of bytes (g and x read once, every slot written once, at 3.35 TB/s).
#include "f32_tile.cuh"

namespace {

using f32tile::Cfg;

using Wide = Cfg<128, 128, 16, 8, 8>;   // bs % 128 == 0 (the 256-row packs)
using Small = Cfg<64, 64, 16, 4, 4>;    // bs % 64 == 0

template <class C, bool VEC>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks)
    bcsr_sddmm_kernel(const int* __restrict__ cols, const int* __restrict__ counts,
                      const float* __restrict__ g, const float* __restrict__ x,
                      float* __restrict__ out, int max_b, int bs, int n, float alpha) {
  __shared__ __align__(16) f32tile::Smem<C> sm;
  using SA = f32tile::KSlots<C, C::BM>;
  using SB = f32tile::KSlots<C, C::BN>;
  // a slot's sub-tiles are neighbours in the grid, and a block row's slots
  // too, so the g and x rows a block row reads are in L2 for all of them
  const int subtiles = (bs / C::BM) * (bs / C::BN), sub = (int)(blockIdx.x % subtiles);
  const size_t slot = blockIdx.x / subtiles;   // i * max_b + k
  const int blk = (int)(slot / max_b), k = (int)(slot % max_b);
  const int per_row = bs / C::BN;
  const int a0 = (sub / per_row) * C::BM, b0 = (sub % per_row) * C::BN;
  const f32tile::Pos<C> pos;

  float acc[C::TM][C::TN];
  f32tile::zero<C>(acc);
  if (k < counts[blk]) {
    const float* ga = g + ((size_t)blk * bs + a0) * n;           // row r at ga + r * n
    const float* xb = x + ((size_t)cols[slot] * bs + b0) * n;
    float4 va[SA::kSlots], vb[SB::kSlots];
    auto fetch = [&](const float* row, int c) -> float4 {
      if constexpr (VEC) {
        return c < n ? __ldg(reinterpret_cast<const float4*>(row + c))
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      } else {
        return make_float4(c < n ? __ldg(row + c) : 0.0f, c + 1 < n ? __ldg(row + c + 1) : 0.0f,
                           c + 2 < n ? __ldg(row + c + 2) : 0.0f,
                           c + 3 < n ? __ldg(row + c + 3) : 0.0f);
      }
    };
    auto load = [&](int s) {
      const int c0 = s * C::BK;
#pragma unroll
      for (int p = 0; p < SA::kSlots; ++p)
        va[p] = fetch(ga + (size_t)SA::row(p) * n, c0 + SA::koff(p));
#pragma unroll
      for (int p = 0; p < SB::kSlots; ++p)
        vb[p] = fetch(xb + (size_t)SB::row(p) * n, c0 + SB::koff(p));
    };
    auto store = [&](int buf) {
      SA::store(sm.a[buf], va);
      SB::store(sm.b[buf], vb);
    };
    const int steps = (n + C::BK - 1) / C::BK;
    f32tile::stage_loop<C>(sm, pos, steps, acc, load, store, n - (steps - 1) * C::BK);
  }
  float* o = out + slot * bs * bs + (size_t)a0 * bs + b0;
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    float* orow = o + (size_t)pos.row(i) * bs;
#pragma unroll
    for (int j = 0; j < C::TN; j += 4)   // streamed: nothing reads the output back here
      __stcs(reinterpret_cast<float4*>(orow + pos.col(j)),
             make_float4(alpha * acc[i][j], alpha * acc[i][j + 1], alpha * acc[i][j + 2],
                         alpha * acc[i][j + 3]));
  }
}

template <class C, bool VEC>
cudaError_t launch(const int* cols, const int* counts, const float* g, const float* x, float* out,
                   size_t slots, int max_b, int bs, int n, float alpha, cudaStream_t stream) {
  const size_t blocks = slots * (size_t)(bs / C::BM) * (bs / C::BN);
  if (blocks > 0x7fffffffu) return cudaErrorInvalidConfiguration;
  bcsr_sddmm_kernel<C, VEC><<<(unsigned)blocks, C::kThreads, 0, stream>>>(cols, counts, g, x, out,
                                                                          max_b, bs, n, alpha);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K11. cols [nbr, max_b] and counts [nbr] int32; g, x [nbr*bs, n] float32
// row-major; out [nbr, max_b, bs, bs] float32, 16-byte aligned, every slot
// written. Needs bs % 64 == 0 and every cols[i, k] < nbr.
int stgcn_bcsr_sddmm(const int* cols, const int* counts, const float* g, const float* x,
                     float* out, int nbr, int max_b, int bs, int n, float alpha, void* stream) {
  if (bs <= 0 || bs % 64 != 0 || nbr <= 0 || max_b <= 0 || n < 0) return cudaErrorInvalidValue;
  const size_t slots = (size_t)nbr * max_b;
  const bool vec = n % 4 == 0 && ((uintptr_t)g | (uintptr_t)x) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bs % 128 == 0)
    return vec ? launch<Wide, true>(cols, counts, g, x, out, slots, max_b, bs, n, alpha, s)
               : launch<Wide, false>(cols, counts, g, x, out, slots, max_b, bs, n, alpha, s);
  return vec ? launch<Small, true>(cols, counts, g, x, out, slots, max_b, bs, n, alpha, s)
             : launch<Small, false>(cols, counts, g, x, out, slots, max_b, bs, n, alpha, s);
}

}  // extern "C"
