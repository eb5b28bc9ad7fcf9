// The gate GEMM's kernel, templated on the operand type T (float, or bf16
// for the TPU kernels' precision="bfloat16" build) and the output type TY
// (T, or float for K4's bf16 variant, whose output the TPU keeps in
// float32). gate_gemm.cu instantiates the float32 kernels
// (launch_gate_gemm), gate_gemm_bf16.cu the bf16 ones
// (launch_gate_gemm_bf16), so the two compile in parallel. gate_gemm.cu
// says what the kernel computes and how it is laid out.
//
// The bf16 variant keeps the float32 kernel's tile, staging and sums (bf16
// x bf16 products are exact in float32, so only the order of the sums can
// differ from the TPU's) and rounds where the TPU kernel rounds
// (stgcn_tpu/kernels/vertex_fused.py `_ln_drop_fwd` :363, `_head_core` :393,
// `_tconv_fwd_cv` :338; output_head.py `_ofc_core` :327): the load step
// reads x and the LayerNorm affine as 8-byte vectors of four bf16; the store
// step normalizes in float32, rounds, applies the bf16 mask (the scale
// rounded to bf16) with one more rounding, and widens into the same float32
// tile; weights are widened as they are staged; the epilogue rounds s before
// the bf16 gate (gate_bf16, common.cuh), the second product sums the bf16 a
// in float32 and rounds y once (K1) or not at all (K4); the LayerNorm-partial
// epilogue writes a in bf16 and sums its rounded values in float32.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "f32_tile.cuh"

namespace stgcn {

namespace {

constexpr int kGemmLanes = 64;   // vertex lanes per block

// The tile: 128 rows x 64 lanes, 8 x 8 sums a thread; 3 blocks a SM (168
// registers a thread: at 128 the 128-thread tiles spill), 4 where the rows
// fit one staged piece (K1 on the first block: nothing is staged ahead, and
// the epilogue's latency wants the blocks).
template <bool ONE_PIECE>
using GemmCfg = f32tile::Cfg<128, kGemmLanes, 16, 8, 8, ONE_PIECE ? 4 : 3>;

// Dynamic shared memory of a block (46 KB gated, 66 KB plain; 42 and 58 KB
// with the LayerNorm-partial epilogue): the staged pieces; the pass's in-gate
// residual, stashed as it is staged (and, for the second product,
// overwritten in place by the gated tile); the second product's weights.
// The bf16 variant stages widened values: the same bytes.
template <class C, int CP, bool LN>
struct GemmSmem {
  f32tile::Smem<C> st;
  float a[CP][kGemmLanes];
  float ow[LN ? 1 : CP][kMaxOut];
};

template <int ACT>
struct GateShape {
  static constexpr bool kGated = ACT == kGlu || ACT == kGtu;
  static constexpr int kPass = kGated ? 64 : 128;   // channels a pass: with their partners, 128 rows
};

// The gate and the epilogue are template parameters: as a runtime switch,
// each of the epilogue's 64 unrolled gates carried every activation's code,
// which cost K4 more than its FMAs. LN: the LayerNorm-partial epilogue (K2's
// conv 2, K3), else the second product.
template <typename T, typename TY, int ACT, bool ONE_PIECE, bool LN>
__global__ void __launch_bounds__(GemmCfg<ONE_PIECE>::kThreads, GemmCfg<ONE_PIECE>::kMinBlocks)
gate_gemm_kernel(const T* __restrict__ x, const float* __restrict__ mu,
                 const float* __restrict__ rstd, const T* __restrict__ lng,
                 const T* __restrict__ lnb, const T* __restrict__ w,
                 const float* __restrict__ wb, const T* __restrict__ ow,
                 const float* __restrict__ ob, TY* __restrict__ y, float* __restrict__ part,
                 int t_in, int c_in, int vp, int kt, int c0, int n_out, int apply_ln,
                 int residual, int v_true, Drop drop_in, Drop drop_out) {
  constexpr bool BF16 = std::is_same<T, bf16>::value;
  // y's bf16 second product carries its sums between passes in registers
  // (y rounds them): K1's, whose c0 fits one pass on the STGCN plan
  constexpr bool CARRY = !LN && !std::is_same<TY, float>::value;
  constexpr bool GATED = GateShape<ACT>::kGated;
  constexpr int CP = GateShape<ACT>::kPass;
  using C = GemmCfg<ONE_PIECE>;
  using SX = f32tile::RSlots<C, kGemmLanes>;
  using L4 = Lanes4<T>;
  constexpr int kWPer = C::BK * C::BM / C::kThreads;   // weight values a thread stages
  static_assert(C::kThreads == 128 && C::TN == 8, "two outputs at 4 lanes a thread");
  static_assert(C::kThreads == kLanes, "block_sum2 sums over kLanes threads");
  extern __shared__ float4 smem4[];
  auto& sm = *reinterpret_cast<GemmSmem<C, CP, LN>*>(smem4);
  __shared__ float red[2 * kLanes / 32];

  const int tid = threadIdx.x;
  const int t_out = t_in - kt + 1, rows = kt * c_in, g = GATED ? 2 * c0 : c0;
  const int t = blockIdx.x % t_out, b = blockIdx.x / t_out, v0 = blockIdx.y * kGemmLanes;
  const int t_res = t + kt - 1;   // the in-gate residual's step
  const f32tile::Pos<C> pos;
  const uint32_t key_in = drop_key(drop_in.seed, drop_in.site);
  const uint32_t key_out = drop_key(drop_out.seed, drop_out.site);

  // x[b, tt, c, v .. v+3] normalized (val: loaded x, m/rs: the step's
  // statistics, gg/bb: the affine) and dropped out, as K1's input; bf16:
  // the normalized value rounded, then the bf16 product with the mask
  auto xn = [&](float4 val, float m, float rs, float4 gg, float4 bb, int tt, int c, int v) {
    if constexpr (!BF16) {
      if (apply_ln) {
        val.x = (val.x - m) * rs * gg.x + bb.x;
        val.y = (val.y - m) * rs * gg.y + bb.y;
        val.z = (val.z - m) * rs * gg.z + bb.z;
        val.w = (val.w - m) * rs * gg.w + bb.w;
      }
      if (drop_in.threshold) {
        const size_t row = (size_t)(b * t_in + tt) * c_in + c;
        val.x *= drop_mask(drop_in, key_in, row, v);
        val.y *= drop_mask(drop_in, key_in, row, v + 1);
        val.z *= drop_mask(drop_in, key_in, row, v + 2);
        val.w *= drop_mask(drop_in, key_in, row, v + 3);
      }
    } else {
      if (apply_ln) {
        val.x = bf16r((val.x - m) * rs * gg.x + bb.x);
        val.y = bf16r((val.y - m) * rs * gg.y + bb.y);
        val.z = bf16r((val.z - m) * rs * gg.z + bb.z);
        val.w = bf16r((val.w - m) * rs * gg.w + bb.w);
      }
      if (drop_in.threshold) {
        const size_t row = (size_t)(b * t_in + tt) * c_in + c;
        val.x = bf16r(val.x * drop_mask(drop_in, key_in, row, v));
        val.y = bf16r(val.y * drop_mask(drop_in, key_in, row, v + 1));
        val.z = bf16r(val.z * drop_mask(drop_in, key_in, row, v + 2));
        val.w = bf16r(val.w * drop_mask(drop_in, key_in, row, v + 3));
      }
    }
    return val;
  };
  auto ld4 = [](const T* p) { return L4::load(p); };
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // the weight column a thread stages: tile row wj (gated: p rows, then q rows)
  const int wj = tid % C::BM, wk0 = (tid / C::BM) * kWPer;
  const int lq = tid % 16, o0 = 2 * (tid / 16);   // the second product: lanes 4 lq .., o0, o0 + 1
  auto yrow = [&](int o) { return y + ((size_t)(b * t_out + t) * n_out + o) * vp + v0 + 4 * lq; };
  float carry[2][4];   // CARRY: the second product's sums of the passes so far

  // passes of CP channels: all of them in the block, or (LN) one a block
  for (int s0 = blockIdx.z * CP; s0 < c0; s0 += CP * gridDim.z) {
    // published by the stage loop's first barrier; the previous pass's
    // second product has passed the barrier that ends it
    if constexpr (!LN)
      for (int i = tid; i < CP * kMaxOut; i += C::kThreads) {
        const int c = i / kMaxOut, o = i % kMaxOut;
        sm.ow[c][o] = (s0 + c < c0 && o < n_out) ? widen(ow[(size_t)(s0 + c) * n_out + o]) : 0.0f;
      }

    float acc[C::TM][C::TN];
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
      const int j = pos.row(i), c = s0 + j % CP;
      const float bv = c < c0 ? wb[(GATED && j >= CP) ? c0 + c : c] : 0.0f;
#pragma unroll
      for (int l = 0; l < C::TN; ++l) acc[i][l] = bv;
    }
    const int wc = s0 + wj % CP;
    const T* wcol = wc < c0 ? w + ((GATED && wj >= CP) ? c0 + wc : wc) : nullptr;

    float wv[kWPer];
    typename L4::V xv[SX::kSlots], gv[SX::kSlots], bv[SX::kSlots];
    float mv[SX::kSlots], rv[SX::kSlots];
    int tv[SX::kSlots], cv[SX::kSlots];   // the slot's step and channel, -1: past `rows`
#pragma unroll
    for (int p = 0; p < SX::kSlots; ++p) {   // read only with apply_ln
      if constexpr (!BF16) gv[p] = bv[p] = zero4;
      else gv[p] = bv[p] = make_uint2(0u, 0u);
      mv[p] = rv[p] = 0.0f;
    }
    auto load = [&](int step) {
      const int r0 = step * C::BK;
#pragma unroll
      for (int q = 0; q < kWPer; ++q) {
        const int r = r0 + wk0 + q;
        wv[q] = wcol && r < rows ? ldw(wcol + (size_t)r * g) : 0.0f;
      }
#pragma unroll
      for (int p = 0; p < SX::kSlots; ++p) {
        const int r = r0 + SX::k(p), v = v0 + SX::roff(p);
        tv[p] = -1;
        if (r < rows) {
          const int k = r / c_in, c = r - k * c_in, tt = t + k;
          tv[p] = tt;
          cv[p] = c;
          xv[p] = ld4(x + ((size_t)(b * t_in + tt) * c_in + c) * vp + v);
          if (apply_ln) {
            mv[p] = __ldg(mu + b * t_in + tt);
            rv[p] = __ldg(rstd + b * t_in + tt);
            gv[p] = ld4(lng + (size_t)c * vp + v);
            bv[p] = ld4(lnb + (size_t)c * vp + v);
          }
        }
      }
    };
    auto store = [&](int buf) {
#pragma unroll
      for (int q = 0; q < kWPer; ++q) sm.st.a[buf][wk0 + q][wj] = wv[q];
      if constexpr (!BF16) {   // in place: the float32 kernel's code
#pragma unroll
        for (int p = 0; p < SX::kSlots; ++p) {
          if (tv[p] < 0) {
            xv[p] = zero4;
            continue;
          }
          xv[p] = xn(xv[p], mv[p], rv[p], gv[p], bv[p], tv[p], cv[p], v0 + SX::roff(p));
          const int cr = cv[p] - s0;   // the last tap's rows are the pass's residual
          if (residual && tv[p] == t_res && cr >= 0 && cr < CP)
            *reinterpret_cast<float4*>(&sm.a[cr][SX::roff(p)]) = xv[p];
        }
        SX::store(sm.st.b[buf], xv);
      } else {   // widened into float32 slots
        float4 xf[SX::kSlots];
#pragma unroll
        for (int p = 0; p < SX::kSlots; ++p) {
          if (tv[p] < 0) {
            xf[p] = zero4;
            continue;
          }
          xf[p] = xn(L4::widen(xv[p]), mv[p], rv[p], L4::widen(gv[p]), L4::widen(bv[p]), tv[p],
                     cv[p], v0 + SX::roff(p));
          const int cr = cv[p] - s0;
          if (residual && tv[p] == t_res && cr >= 0 && cr < CP)
            *reinterpret_cast<float4*>(&sm.a[cr][SX::roff(p)]) = xf[p];
        }
        SX::store(sm.st.b[buf], xf);
      }
    };
    if constexpr (ONE_PIECE) {   // rows <= BK
      load(0);
      store(0);
      __syncthreads();
      f32tile::fma_piece<C, true>(sm.st.a[0], sm.st.b[0], pos, acc, rows);
    } else {
      const int steps = (rows + C::BK - 1) / C::BK;
      f32tile::stage_loop<C>(sm.st, pos, steps, acc, load, store, rows - (steps - 1) * C::BK);
    }

    constexpr int kCh = GATED ? C::TM / 2 : C::TM;   // channels a thread holds
    if constexpr (LN) {
      // the LayerNorm-partial epilogue: gate (in-gate residual as below),
      // the gated tile to y [B, t_out, c0, Vp], and its sums (sum, sum of
      // squares) over the pass's channels and the true lanes, in the
      // thread's order, then the block's (block_sum2): one partial per
      // (b, t, pass, lane tile) in part
      float ps = 0.0f, pss = 0.0f;
#pragma unroll
      for (int i = 0; i < kCh; ++i) {
        const int j = pos.row(i), c = s0 + j;
        if (c >= c0) continue;
        TY* yr = y + ((size_t)(b * t_out + t) * c0 + c) * vp;
#pragma unroll
        for (int h = 0; h < 2; ++h) {   // lanes 4 tx .. and 32 + 4 tx ..
          const int l0 = h * (kGemmLanes / 2) + 4 * pos.tx, v = v0 + l0;
          const float4 xin =
              residual && c < c_in ? *reinterpret_cast<const float4*>(&sm.a[j][l0]) : zero4;
          const float xi[4] = {xin.x, xin.y, xin.z, xin.w};
          float av[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if constexpr (!BF16)
              av[u] = gate(ACT, acc[i][4 * h + u], GATED ? acc[i + C::TM / 2][4 * h + u] : 0.0f,
                           xi[u]);
            else   // s rounded first
              av[u] = gate_bf16<ACT>(bf16r(acc[i][4 * h + u]),
                                     GATED ? bf16r(acc[i + C::TM / 2][4 * h + u]) : 0.0f, xi[u]);
            if (v + u < v_true) {
              ps += av[u];
              pss += av[u] * av[u];
            }
          }
          st4(yr + v, av);
        }
      }
      block_sum2(ps, pss, red);   // its barriers also end the pass's reads of sm
      if (tid == 0) {
        const int npass = (c0 + CP - 1) / CP;
        const size_t idx =
            (((size_t)(b * t_out + t) * npass + s0 / CP) * gridDim.y + blockIdx.y) * 2;
        part[idx] = ps;
        part[idx + 1] = pss;
      }
    } else {
      // the second product's epilogue: gate (in-gate residual: the window's
      // last step as staged, channels zero-padded), K4's output mask (bf16:
      // a bf16 product); the gated tile over the residual in shared memory,
      // each element by the thread that read it
#pragma unroll
      for (int i = 0; i < kCh; ++i) {
        const int j = pos.row(i), c = s0 + j;
#pragma unroll
        for (int h = 0; h < 2; ++h) {   // lanes 4 tx .. and 32 + 4 tx ..
          const int l0 = h * (kGemmLanes / 2) + 4 * pos.tx, v = v0 + l0;
          float4* ap = reinterpret_cast<float4*>(&sm.a[j][l0]);
          const float4 xin = residual && c < c_in ? *ap : zero4;
          const float xi[4] = {xin.x, xin.y, xin.z, xin.w};
          float av[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float q = GATED ? acc[i + C::TM / 2][4 * h + u] : 0.0f;
            if constexpr (!BF16) {
              av[u] = c < c0 ? gate(ACT, acc[i][4 * h + u], q, xi[u]) : 0.0f;
              if (drop_out.threshold && c < c0)
                av[u] *= drop_mask(drop_out, key_out, (size_t)(b * t_out + t) * c0 + c, v + u);
            } else {   // s rounded first; the mask a bf16 product
              av[u] = c < c0 ? gate_bf16<ACT>(bf16r(acc[i][4 * h + u]), bf16r(q), xi[u]) : 0.0f;
              if (drop_out.threshold && c < c0)
                av[u] = bf16r(av[u] * drop_mask(drop_out, key_out,
                                                (size_t)(b * t_out + t) * c0 + c, v + u));
            }
          }
          *ap = make_float4(av[0], av[1], av[2], av[3]);
        }
      }
      __syncthreads();

      // the second product: y[o, v] = ob[o] + sum over c ascending of a[c, v]
      // ow[c, o]; between passes its sums wait in y, which only this thread
      // writes and reads (CARRY: in registers)
      if (o0 < n_out) {
        float out[2][4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if constexpr (CARRY) {
#pragma unroll
            for (int u = 0; u < 4; ++u)
              out[e][u] = s0 > 0 ? carry[e][u] : (o0 + e < n_out ? ob[o0 + e] : 0.0f);
          } else {
            float4 o4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (o0 + e < n_out)
              o4 = s0 > 0 ? *reinterpret_cast<const float4*>(yrow(o0 + e))
                          : make_float4(ob[o0 + e], ob[o0 + e], ob[o0 + e], ob[o0 + e]);
            out[e][0] = o4.x;
            out[e][1] = o4.y;
            out[e][2] = o4.z;
            out[e][3] = o4.w;
          }
        }
        const int nc = min(CP, c0 - s0);
#pragma unroll 4
        for (int c = 0; c < nc; ++c) {
          const float4 a4 = *reinterpret_cast<const float4*>(&sm.a[c][4 * lq]);
          const float2 w2 = *reinterpret_cast<const float2*>(&sm.ow[c][o0]);
          const float al[4] = {a4.x, a4.y, a4.z, a4.w}, we[2] = {w2.x, w2.y};
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int u = 0; u < 4; ++u) out[e][u] = fmaf(al[u], we[e], out[e][u]);
        }
        if constexpr (CARRY) {
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int u = 0; u < 4; ++u) carry[e][u] = out[e][u];
          if (s0 + CP >= c0) {   // the last pass: y rounded once
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (o0 + e < n_out) st4(yrow(o0 + e), out[e]);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (o0 + e < n_out) st4(yrow(o0 + e), out[e]);
        }
      }
      __syncthreads();   // the residual, the tile and the weights are rewritten by the next pass
    }
  }
}

template <typename T, typename TY, int ACT, bool ONE_PIECE, bool LN>
cudaError_t gate_gemm_launch(const GateGemmArgs& a, cudaStream_t stream) {
  constexpr size_t smem = sizeof(GemmSmem<GemmCfg<ONE_PIECE>, GateShape<ACT>::kPass, LN>);
  const cudaError_t err = set_smem(gate_gemm_kernel<T, TY, ACT, ONE_PIECE, LN>, smem);
  if (err != cudaSuccess) return err;
  // (t, b) fastest: the kt output steps that read one input step, and the
  // blocks that read one lane tile of the LayerNorm affine, run together
  const int t_out = a.t_in - a.kt + 1, tiles = a.vp / kGemmLanes;
  // the LayerNorm-partial epilogue runs its passes as a grid axis, one a
  // block: no slower than passes in the block at 100k and 1M, and 1.5x
  // faster at PeMSD7(M), whose (b, lane tile) grid (128 blocks) leaves SMs
  // idle (PERF.md §6); the second product sums over the passes in y, so
  // it keeps them in the block
  const int npass = (a.c0 + GateShape<ACT>::kPass - 1) / GateShape<ACT>::kPass;
  const dim3 grid(t_out * a.batch, tiles, LN ? npass : 1);
  gate_gemm_kernel<T, TY, ACT, ONE_PIECE, LN>
      <<<grid, GemmCfg<ONE_PIECE>::kThreads, smem, stream>>>(
          static_cast<const T*>(a.x), a.mu, a.rstd, static_cast<const T*>(a.lng),
          static_cast<const T*>(a.lnb), static_cast<const T*>(a.w), a.wb,
          static_cast<const T*>(a.ow), a.ob, static_cast<TY*>(a.y), a.part, a.t_in, a.c_in,
          a.vp, a.kt, a.c0, a.n_out, a.apply_ln, a.residual, a.v_true, a.drop_in, a.drop_out);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess || !LN) return launched;
  return launch_reduce_partials(a.part, a.ps, a.pss, t_out * a.batch, npass * tiles, stream);
}

template <typename T, typename TY, bool ONE_PIECE, bool LN>
cudaError_t gate_gemm_act(const GateGemmArgs& a, cudaStream_t stream) {
  switch (a.act) {
    case kGlu: return gate_gemm_launch<T, TY, kGlu, ONE_PIECE, LN>(a, stream);
    case kGtu: return gate_gemm_launch<T, TY, kGtu, ONE_PIECE, LN>(a, stream);
    case kRelu: return gate_gemm_launch<T, TY, kRelu, ONE_PIECE, LN>(a, stream);
    case kSilu: return gate_gemm_launch<T, TY, kSilu, ONE_PIECE, LN>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// the argument checks of both launchers; *one: the rows fit one staged piece
inline bool gate_gemm_args_ok(const GateGemmArgs& a, bool* one) {
  *one = a.kt * a.c_in <= 16;   // one staged piece: K1 on the first block
  return a.vp % kGemmLanes == 0 && (a.part != nullptr || a.n_out <= kMaxOut) && a.t_in >= a.kt;
}

}  // namespace

}  // namespace stgcn
