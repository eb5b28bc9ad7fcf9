// K3b and K4b of the STGCN output head ('TNFF'), backward: the C entry
// points, each a pipeline of the building blocks in bwd_blocks.cu that
// recomputes its forward from the saved inputs.
//
// Replaces the TPU kernels stgcn_tpu/kernels/output_head.py
// `_ohead_pallas_bwd` (:253, body `_make_ohead_bwd_kernel` :159) and
// `_ofc_pallas_bwd` (:440, body `_make_ofc_bwd_kernel` :353).
//
// K3b: x4 = LN-normalize(x) * mask -> the gate pass of K1b and K2b on the
//      register tile (launch_gate_pass, cotangent policy): s = tconv(x4) + cb
//      (ko taps, time -> 1) recomputed in registers, the gate backward from
//      ga plus the head LayerNorm-partial cotangents (gps + 2 gpss a on true
//      lanes) in its epilogue, writing only ds (s and the residual's gradient
//      dxin never reach device memory) -> dck with dcb (a ones row, one pass
//      over ds) -> dx4 = tconv^T(ds) + ds's linear half on the tile
//      (launch_gate_dx, t_out = 1) -> LayerNorm backward dx, dmu, drstd,
//      dlng, dlnb.
//      What bounds it: float32 FMA issue, three products of ko*c_in*g per
//      lane (recompute, dck, dx4), then the LayerNorm's bytes.
// K4b: h = LN-normalize(a) -> one pass on the register tile (launch_fc_pass:
//      K1b's gate pass, head policy, kt = 1, relu, no in-gate residual)
//      that recomputes s2 = h . w1 + b1, takes dzd = gout . w2^T, fc1's
//      dropout mask and the ReLU in its epilogue, writes only ds2 = dzd *
//      mask * (s2 > 0), and sums dw2 = zd^T gout and db1 = sum of ds2 from
//      registers as per-block partials (s2, dzd and zd never reach device
//      memory) -> db2 (a ones row) -> dw1 (on the 128 x 128 tile; with db1
//      as its ones row, 129 rows on the 128 x 64 tile, it took 0.97 ms at
//      100k on an H100 SXM at 700 W, against 0.62 alone) ->
//      dh = ds2 . w1^T on the tile (launch_gate_dx, kt = 1, no residual;
//      dh takes h's place) -> LayerNorm backward da, dmu, drstd, dlnw, dlnb.
//      What bounds it: float32 FMA issue, three products of c0*c1 per lane
//      (recompute, dw1, dh), then the LayerNorm's bytes.
// The bf16 variants (stgcn_ohead_bwd_bf16, stgcn_ofc_bwd_bf16: the TPU
// kernels with precision="bfloat16") run the same pipelines on the bf16
// overloads of the building blocks (bwd_blocks_bf16.cu), which round where
// the TPU kernels round (bwd_blocks.cuh); K4b first rounds its float32
// output cotangent gout to bf16, as the TPU kernel does. The workspace holds
// x4, dx4 and ds (K3b), h (then dh) and ds2 (K4b) in bf16; the weight
// gradients stay float32 sums.
#include <type_traits>

#include "bwd_blocks.cuh"

namespace stgcn {
namespace {

template <typename T>
cudaError_t ohead_bwd(const T* x, const float* mu, const float* rstd, const T* lng, const T* lnb,
                      const T* ck, const float* cb, const T* ga, const float* gps,
                      const float* gpss, T* dx, float* dmu, float* drstd, T* dlng, T* dlnb,
                      float* dck, float* dcb, float* work, size_t* floats, int B, int ko,
                      int c_in, int vp, int c0, int act, int v_true, Drop drop, cudaStream_t s) {
  const bool gated = act == kGlu || act == kGtu;
  const int g = gated ? 2 * c0 : c0;
  const size_t lane = (size_t)B * vp;
  Carver w{work};
  T* x4 = w.take_as<T>(lane * ko * c_in);
  T* dx4 = w.take_as<T>(lane * ko * c_in);
  T* ds = w.take_as<T>(lane * g);
  const long long r = (long long)B * vp;
  float* part = w.take(wgrad_part_floats({{ko * c_in + 1, g, r}}));
  float* lnpart = w.take(ln_bwd_part_floats(B, ko));
  if (floats) *floats = w.used;
  if (!work) return cudaSuccess;
  if (ko < 1) return cudaErrorInvalidValue;

  STGCN_TRY(launch_ln_drop(x, mu, rstd, lng, lnb, drop, x4, B, ko, c_in, vp, s));
  // s = tconv(x4) + cb, time collapsed to one step, and the gate backward in one pass: ds
  STGCN_TRY(launch_gate_pass(x4, ck, cb, GateUpT<T>{ga, nullptr, 0, gps, gpss, v_true}, ds,
                             nullptr, B, ko, c_in, vp, ko, c0, act, s));
  STGCN_TRY(launch_wgrad_bias(CvT<T>{x4, ko, c_in}, ko, CvT<T>{ds, 1, g}, dck, dcb, part, B, vp,
                              s));
  // dx4 = tconv^T(ds) + dxin at the last step
  STGCN_TRY(launch_gate_dx(ds, ck, dx4, B, ko, c_in, vp, ko, g, s));
  return launch_ln_bwd(x, mu, rstd, lng, drop, dx4, dx, dmu, drstd, dlng, dlnb, lnpart, B, ko,
                       c_in, vp, s);
}

template <typename T>
cudaError_t ofc_bwd(const T* a, const float* mu, const float* rstd, const T* lnw, const T* lnb,
                    const T* w1, const float* b1, const T* w2, const float* gout, T* da,
                    float* dmu, float* drstd, T* dlnw, T* dlnb, float* dw1, float* db1,
                    float* dw2, float* db2, float* work, size_t* floats, int B, int c0, int c1,
                    int ce, int vp, Drop drop, cudaStream_t s) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  const size_t lane = (size_t)B * vp;
  Carver w{work};
  T* h = w.take_as<T>(lane * c0);   // then dh: h is last read by dw1's pass
  T* ds2 = w.take_as<T>(lane * c1);
  T* gout16 = kF32 ? nullptr : w.take_as<T>(lane * ce);   // bf16: gout rounded
  const long long r = (long long)B * vp;
  float* part = w.take(wgrad_part_floats({{1, ce, r}, {c0, c1, r}}));
  float* fcpart = w.take(fc_pass_part_floats(B, vp, c1, ce));
  float* lnpart = w.take(ln_bwd_part_floats(B, 1));
  if (floats) *floats = w.used;
  if (!work) return cudaSuccess;

  const Drop off = make_drop(0, 0, 0, 1.0f, drop.v_true);
  const T* g;
  if constexpr (kF32) {
    g = gout;
  } else {
    STGCN_TRY(launch_to_bf16(gout, gout16, lane * ce, s));
    g = gout16;
  }
  STGCN_TRY(launch_ln_drop(a, mu, rstd, lnw, lnb, off, h, B, 1, c0, vp, s));
  // s2, dzd, the mask and the ReLU in one pass: ds2, and dw2 and db1 from its partials
  STGCN_TRY(launch_fc_pass(h, w1, b1, g, w2, drop, ds2, dw2, db1, fcpart, B, c0, vp, c1, ce, s));
  STGCN_TRY(launch_wgrad(CvT<T>{nullptr, 0, 1}, 1, CvT<T>{g, 1, ce}, db2, part, B, vp, s));
  STGCN_TRY(launch_wgrad(CvT<T>{h, 1, c0}, 1, CvT<T>{ds2, 1, c1}, dw1, part, B, vp, s));
  T* dh = h;
  STGCN_TRY(launch_gate_dx(ds2, w1, dh, B, 1, c0, vp, 1, c1, s, false));
  return launch_ln_bwd(a, mu, rstd, lnw, off, dh, da, dmu, drstd, dlnw, dlnb, lnpart, B, 1, c0,
                       vp, s);
}

}  // namespace
}  // namespace stgcn

using namespace stgcn;

extern "C" {

// K3b. ga [B, 1, c0, Vp], gps/gpss [B]. Outputs: dx [B, ko, c_in, Vp], dmu,
// drstd [B, ko], dlng, dlnb [c_in, Vp], dck [ko, c_in, g], dcb [g].
int stgcn_ohead_bwd(const float* x, const float* mu, const float* rstd, const float* lng,
                    const float* lnb, const float* ck, const float* cb, const float* ga,
                    const float* gps, const float* gpss, float* dx, float* dmu, float* drstd,
                    float* dlng, float* dlnb, float* dck, float* dcb, float* work, int B, int ko,
                    int c_in, int vp, int c0, int act, int v_true, unsigned seed, int site,
                    unsigned threshold, float scale, void* stream) {
  return ohead_bwd<float>(x, mu, rstd, lng, lnb, ck, cb, ga, gps, gpss, dx, dmu, drstd, dlng,
                          dlnb, dck, dcb, work, nullptr, B, ko, c_in, vp, c0, act, v_true,
                          make_drop(seed, site, threshold, scale, v_true),
                          static_cast<cudaStream_t>(stream));
}

long long stgcn_ohead_bwd_work(int B, int ko, int c_in, int vp, int c0, int act) {
  size_t n = 0;
  ohead_bwd<float>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                   nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                   nullptr, nullptr, &n, B, ko, c_in, vp, c0, act, 0,
                   make_drop(0, 0, 0, 1.0f, 0), nullptr);
  return (long long)n;
}

// K4b. gout [B, 1, ce, Vp]. Outputs: da [B, 1, c0, Vp], dmu, drstd [B],
// dlnw, dlnb [c0, Vp], dw1 [c0, c1], db1 [c1], dw2 [c1, ce], db2 [ce].
int stgcn_ofc_bwd(const float* a, const float* mu, const float* rstd, const float* lnw,
                  const float* lnb, const float* w1, const float* b1, const float* w2,
                  const float* gout, float* da, float* dmu, float* drstd, float* dlnw,
                  float* dlnb, float* dw1, float* db1, float* dw2, float* db2, float* work,
                  int B, int c0, int c1, int ce, int vp, int v_true, unsigned seed, int site,
                  unsigned threshold, float scale, void* stream) {
  return ofc_bwd<float>(a, mu, rstd, lnw, lnb, w1, b1, w2, gout, da, dmu, drstd, dlnw, dlnb, dw1,
                        db1, dw2, db2, work, nullptr, B, c0, c1, ce, vp,
                        make_drop(seed, site, threshold, scale, v_true),
                        static_cast<cudaStream_t>(stream));
}

long long stgcn_ofc_bwd_work(int B, int c0, int c1, int ce, int vp) {
  size_t n = 0;
  ofc_bwd<float>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                 nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                 nullptr, &n, B, c0, c1, ce, vp, make_drop(0, 0, 0, 1.0f, 0), nullptr);
  return (long long)n;
}

// The bf16 variants of K3b and K4b: x, lng, lnb, ck, ga and dx, dlng, dlnb
// (K3b); a, lnw, lnb, w1, w2 and da, dlnw, dlnb (K4b) are bf16; gout (K4f's
// float32 output's cotangent), mu, rstd, the biases, gps, gpss, dmu, drstd
// and the weight gradients float32. The dropout scale is rounded to bf16.
int stgcn_ohead_bwd_bf16(const void* x, const float* mu, const float* rstd, const void* lng,
                         const void* lnb, const void* ck, const float* cb, const void* ga,
                         const float* gps, const float* gpss, void* dx, float* dmu, float* drstd,
                         void* dlng, void* dlnb, float* dck, float* dcb, float* work, int B,
                         int ko, int c_in, int vp, int c0, int act, int v_true, unsigned seed,
                         int site, unsigned threshold, float scale, void* stream) {
  using P = const bf16*;
  return ohead_bwd<bf16>(P(x), mu, rstd, P(lng), P(lnb), P(ck), cb, P(ga), gps, gpss,
                         static_cast<bf16*>(dx), dmu, drstd, static_cast<bf16*>(dlng),
                         static_cast<bf16*>(dlnb), dck, dcb, work, nullptr, B, ko, c_in, vp, c0,
                         act, v_true, make_drop(seed, site, threshold, bf16r(scale), v_true),
                         static_cast<cudaStream_t>(stream));
}

long long stgcn_ohead_bwd_bf16_work(int B, int ko, int c_in, int vp, int c0, int act) {
  size_t n = 0;
  ohead_bwd<bf16>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, &n, B, ko, c_in, vp, c0, act, 0,
                  make_drop(0, 0, 0, 1.0f, 0), nullptr);
  return (long long)n;
}

int stgcn_ofc_bwd_bf16(const void* a, const float* mu, const float* rstd, const void* lnw,
                       const void* lnb, const void* w1, const float* b1, const void* w2,
                       const float* gout, void* da, float* dmu, float* drstd, void* dlnw,
                       void* dlnb, float* dw1, float* db1, float* dw2, float* db2, float* work,
                       int B, int c0, int c1, int ce, int vp, int v_true, unsigned seed, int site,
                       unsigned threshold, float scale, void* stream) {
  using P = const bf16*;
  return ofc_bwd<bf16>(P(a), mu, rstd, P(lnw), P(lnb), P(w1), b1, P(w2), gout,
                       static_cast<bf16*>(da), dmu, drstd, static_cast<bf16*>(dlnw),
                       static_cast<bf16*>(dlnb), dw1, db1, dw2, db2, work, nullptr, B, c0, c1,
                       ce, vp, make_drop(seed, site, threshold, bf16r(scale), v_true),
                       static_cast<cudaStream_t>(stream));
}

long long stgcn_ofc_bwd_bf16_work(int B, int c0, int c1, int ce, int vp) {
  size_t n = 0;
  ofc_bwd<bf16>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                nullptr, &n, B, c0, c1, ce, vp, make_drop(0, 0, 0, 1.0f, 0), nullptr);
  return (long long)n;
}

}  // extern "C"
