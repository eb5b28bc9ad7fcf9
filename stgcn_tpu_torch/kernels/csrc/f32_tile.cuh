// The register-tiled float32 product tile of the port's Hopper kernels:
//
//   acc[m, n] += sum over k of A(m, k) * B(n, k)
//
// used by K11 (bcsr_sddmm.cu), by the gate GEMM of K1f-K4f and of K12f's
// head and conv 2 (gate_gemm.cu), by K12's dense graph product and its
// adjoint (fused_stblock.cu `launch_graph_mm`), by every weight gradient of
// K1b-K4b and K12b (bwd_blocks.cu `launch_wgrad`) and by the recompute and
// data gradient of K1b-K4b and K12b (bwd_blocks.cu). A block of
// Cfg::kThreads threads owns a BM x BN output tile and keeps it in
// registers, TM x TN sums a thread: with 8, rows
// 4ty..4ty+3 and BM/2+4ty..BM/2+4ty+3 (columns likewise), so the 16-byte
// shared loads of a warp fall on distinct banks. The reduction is walked BK
// at a time. Both operand pieces are staged in shared memory k-major
// ([k][m] and [k][n], rows padded by 4 floats), two buffers deep: a kernel
// loads the next piece from device memory into registers (float4 where it
// can), multiplies the current one, then stores the next one into the other
// buffer, transposing it at the store where the operand is contiguous along
// k; one barrier a step (`stage_loop`). At 8 x 8 a k costs 4 shared loads
// (LDS.128) for 64 FMAs.
//
// Arithmetic: full float32 fmaf, no TF32, no atomics. Each sum is one fmaf
// chain in ascending k, so a repeat launch is bit-identical; callers bound
// the chain length where the reduction is long (wgrad slices <= 4096 terms).
//
// What bounds it on the H100: FMA issue (67 TFLOP/s f32). The shared loads,
// the staging and the barrier take about a tenth of the issue slots at
// 8 x 8 and BK 16. Registers are the scarce resource: __launch_bounds__
// keeps a thread at <= 128 (512 threads a SM resident) unless a Cfg asks
// for fewer blocks a SM, where 128 would spill.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace f32tile {

// MINB_: blocks a SM the compiler must leave room for (its register cap);
// 0 takes 512 threads a SM (<= 128 registers a thread).
template <int BM_, int BN_, int BK_, int TM_, int TN_, int MINB_ = 0>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static_assert(TM == 4 || TM == 8, "TM is 4 or 8");
  static_assert(TN == 4 || TN == 8, "TN is 4 or 8");
  static_assert(BK % 4 == 0, "BK is a multiple of 4");
  static constexpr int kRows = BM / TM, kCols = BN / TN;  // the thread grid
  static constexpr int kThreads = kRows * kCols;
  // a warp spans kWy x kWx threads of the grid
  static constexpr int kWx = kCols < 8 ? kCols : (kRows < 4 ? 32 / kRows : 8);
  static constexpr int kWy = 32 / kWx;
  static_assert(kThreads % 32 == 0 && kCols % kWx == 0 && kRows % kWy == 0,
                "the thread grid is whole warps");
  static constexpr int PA = BM + 4, PB = BN + 4;  // pitch of a staged k row (floats)
  static constexpr int kMinBlocks = MINB_ ? MINB_ : (512 / kThreads > 0 ? 512 / kThreads : 1);
};

// Staged operand pieces, two buffers deep.
template <class C>
struct Smem {
  float a[2][C::BK][C::PA];
  float b[2][C::BK][C::PB];
};

// The thread's place in the tile's thread grid.
template <class C>
struct Pos {
  int ty, tx;
  __device__ __forceinline__ Pos() {
    const int w = threadIdx.x / 32, l = threadIdx.x % 32;
    constexpr int wpr = C::kCols / C::kWx;  // warps along a band of kWy thread rows
    ty = (w / wpr) * C::kWy + l / C::kWx;
    tx = (w % wpr) * C::kWx + l % C::kWx;
  }
  // tile row of the thread's sum i (i < TM), and tile column of sum j (j < TN)
  __device__ __forceinline__ int row(int i) const {
    return C::TM == 8 && i >= 4 ? C::BM / 2 + 4 * ty + i - 4 : 4 * ty + i;
  }
  __device__ __forceinline__ int col(int j) const {
    return C::TN == 8 && j >= 4 ? C::BN / 2 + 4 * tx + j - 4 : 4 * tx + j;
  }
};

__device__ __forceinline__ void ld4(float* d, const float* s) {
  const float4 q = *reinterpret_cast<const float4*>(s);
  d[0] = q.x;
  d[1] = q.y;
  d[2] = q.z;
  d[3] = q.w;
}

template <class C>
__device__ __forceinline__ void zero(float (&acc)[C::TM][C::TN]) {
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j) acc[i][j] = 0.0f;
}

// acc[i][j] += sum over kk < BK (kk < kmax when PARTIAL) of a[kk][row(i)] *
// b[kk][col(j)], kk ascending.
template <class C, bool PARTIAL = false>
__device__ __forceinline__ void fma_piece(const float (&a)[C::BK][C::PA],
                                          const float (&b)[C::BK][C::PB], const Pos<C>& p,
                                          float (&acc)[C::TM][C::TN], int kmax = C::BK) {
#pragma unroll
  for (int kk = 0; kk < C::BK; ++kk) {
    if (PARTIAL && kk >= kmax) break;
    float av[C::TM], bv[C::TN];
    ld4(av, &a[kk][4 * p.ty]);
    if constexpr (C::TM == 8) ld4(av + 4, &a[kk][C::BM / 2 + 4 * p.ty]);
    ld4(bv, &b[kk][4 * p.tx]);
    if constexpr (C::TN == 8) ld4(bv + 4, &b[kk][C::BN / 2 + 4 * p.tx]);
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// An operand contiguous along k, R rows: its R x BK piece as float4 slots
// (row s / (BK/4), k offset 4 (s % (BK/4))), kSlots(R) of them a thread.
template <class C, int R>
struct KSlots {
  static constexpr int kPerRow = C::BK / 4;
  static constexpr int kTotal = R * kPerRow;
  static_assert(kTotal % C::kThreads == 0, "the piece's slots divide among the threads");
  static constexpr int kSlots = kTotal / C::kThreads;
  __device__ __forceinline__ static int row(int p) {
    return (int)(threadIdx.x + p * C::kThreads) / kPerRow;
  }
  __device__ __forceinline__ static int koff(int p) {
    return 4 * ((int)(threadIdx.x + p * C::kThreads) % kPerRow);
  }
  // the loaded slots into piece[k][row], transposed
  template <int P>
  __device__ __forceinline__ static void store(float (&piece)[C::BK][P],
                                               const float4 (&v)[kSlots]) {
#pragma unroll
    for (int p = 0; p < kSlots; ++p) {
      const int r = row(p), k = koff(p);
      piece[k + 0][r] = v[p].x;
      piece[k + 1][r] = v[p].y;
      piece[k + 2][r] = v[p].z;
      piece[k + 3][r] = v[p].w;
    }
  }
};

// An operand contiguous along its rows (a [k][R] piece): float4 slots
// (k row s / (R/4), row offset 4 (s % (R/4))), stored as they are.
template <class C, int R>
struct RSlots {
  static constexpr int kPerK = R / 4;
  static constexpr int kTotal = C::BK * kPerK;
  static_assert(R % 4 == 0 && kTotal % C::kThreads == 0, "the piece's slots divide");
  static constexpr int kSlots = kTotal / C::kThreads;
  __device__ __forceinline__ static int k(int p) {
    return (int)(threadIdx.x + p * C::kThreads) / kPerK;
  }
  __device__ __forceinline__ static int roff(int p) {
    return 4 * ((int)(threadIdx.x + p * C::kThreads) % kPerK);
  }
  template <int P>
  __device__ __forceinline__ static void store(float (&piece)[C::BK][P],
                                               const float4 (&v)[kSlots]) {
#pragma unroll
    for (int p = 0; p < kSlots; ++p)
      *reinterpret_cast<float4*>(&piece[k(p)][roff(p)]) = v[p];
  }
};

// The double-buffered walk over `steps` k pieces: load(s) brings piece s
// into the caller's registers, store(buf) puts them into sm.a[buf] /
// sm.b[buf], and the tile multiplies piece s while piece s + 1 loads. The
// last piece holds last_k rows (its rows past them are not multiplied).
template <class C, class Load, class Store>
__device__ __forceinline__ void stage_loop(Smem<C>& sm, const Pos<C>& pos, int steps,
                                           float (&acc)[C::TM][C::TN], Load load, Store store,
                                           int last_k = C::BK) {
  if (steps <= 0) return;
  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const bool more = s + 1 < steps;
    if (more) load(s + 1);
    if (more || last_k >= C::BK) fma_piece<C>(sm.a[s & 1], sm.b[s & 1], pos, acc);
    else fma_piece<C, true>(sm.a[s & 1], sm.b[s & 1], pos, acc, last_k);
    if (more) store((s + 1) & 1);
    __syncthreads();
  }
}

}  // namespace f32tile
