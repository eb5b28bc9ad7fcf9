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
// K4b: h = LN-normalize(a) -> s2 = h . w1 + b1 -> dzd = gout . w2^T -> zd =
//      relu(s2) * mask, ds2 = dzd * mask * (s2 > 0) -> dw2, db2, dw1, db1 ->
//      dh = ds2 . w1^T -> LayerNorm backward da, dmu, drstd, dlnw, dlnb.
#include "bwd_blocks.cuh"

namespace stgcn {
namespace {

cudaError_t ohead_bwd(const float* x, const float* mu, const float* rstd, const float* lng,
                      const float* lnb, const float* ck, const float* cb, const float* ga,
                      const float* gps, const float* gpss, float* dx, float* dmu, float* drstd,
                      float* dlng, float* dlnb, float* dck, float* dcb, float* work,
                      size_t* floats, int B, int ko, int c_in, int vp, int c0, int act,
                      int v_true, Drop drop, cudaStream_t s) {
  const bool gated = act == kGlu || act == kGtu;
  const int g = gated ? 2 * c0 : c0;
  const size_t lane = (size_t)B * vp;
  Carver w{work};
  float* x4 = w.take(lane * ko * c_in);
  float* dx4 = w.take(lane * ko * c_in);
  float* ds = w.take(lane * g);
  const long long r = (long long)B * vp;
  float* part = w.take(wgrad_part_floats({{ko * c_in + 1, g, r}}));
  float* lnpart = w.take(ln_bwd_part_floats(B, ko));
  if (floats) *floats = w.used;
  if (!work) return cudaSuccess;
  if (ko < 1) return cudaErrorInvalidValue;

  STGCN_TRY(launch_ln_drop(x, mu, rstd, lng, lnb, drop, x4, B, ko, c_in, vp, s));
  // s = tconv(x4) + cb, time collapsed to one step, and the gate backward in one pass: ds
  STGCN_TRY(launch_gate_pass(x4, ck, cb, GateUp{ga, nullptr, 0, gps, gpss, v_true}, ds, nullptr,
                             B, ko, c_in, vp, ko, c0, act, s));
  STGCN_TRY(launch_wgrad_bias(Cv{x4, ko, c_in}, ko, Cv{ds, 1, g}, dck, dcb, part, B, vp, s));
  // dx4 = tconv^T(ds) + dxin at the last step
  STGCN_TRY(launch_gate_dx(ds, ck, dx4, B, ko, c_in, vp, ko, g, s));
  return launch_ln_bwd(x, mu, rstd, lng, drop, dx4, dx, dmu, drstd, dlng, dlnb, lnpart, B, ko,
                       c_in, vp, s);
}

cudaError_t ofc_bwd(const float* a, const float* mu, const float* rstd, const float* lnw,
                    const float* lnb, const float* w1, const float* b1, const float* w2,
                    const float* gout, float* da, float* dmu, float* drstd, float* dlnw,
                    float* dlnb, float* dw1, float* db1, float* dw2, float* db2, float* work,
                    size_t* floats, int B, int c0, int c1, int ce, int vp, Drop drop,
                    cudaStream_t s) {
  const size_t lane = (size_t)B * vp;
  Carver w{work};
  float* h = w.take(lane * c0);
  float* dh = w.take(lane * c0);
  float* s2 = w.take(lane * c1);
  float* dzd = w.take(lane * c1);
  float* zd = w.take(lane * c1);
  float* ds2 = w.take(lane * c1);
  const long long r = (long long)B * vp;
  float* part = w.take(wgrad_part_floats({{c1, ce, r}, {1, ce, r}, {c0, c1, r}, {1, c1, r}}));
  float* lnpart = w.take(ln_bwd_part_floats(B, 1));
  if (floats) *floats = w.used;
  if (!work) return cudaSuccess;

  const Cv none{nullptr, 0, 0};
  const Drop off = make_drop(0, 0, 0, 1.0f, drop.v_true);
  STGCN_TRY(launch_ln_drop(a, mu, rstd, lnw, lnb, off, h, B, 1, c0, vp, s));
  STGCN_TRY(launch_contract({{h, nullptr, nullptr}, 1, c0, w1, 1, 0, 0, b1, none, 0, 0, nullptr,
                             s2, B, 1, c1, vp}, s));
  STGCN_TRY(launch_contract({{gout, nullptr, nullptr}, 1, ce, w2, 1, 0, 1, nullptr, none, 0, 0,
                             nullptr, dzd, B, 1, c1, vp}, s));
  STGCN_TRY(launch_relu_drop(s2, drop, dzd, zd, ds2, B, 1, c1, vp, s));
  STGCN_TRY(launch_wgrad(Cv{zd, 1, c1}, 1, Cv{gout, 1, ce}, dw2, part, B, vp, s));
  STGCN_TRY(launch_wgrad(Cv{nullptr, 0, 1}, 1, Cv{gout, 1, ce}, db2, part, B, vp, s));
  STGCN_TRY(launch_wgrad(Cv{h, 1, c0}, 1, Cv{ds2, 1, c1}, dw1, part, B, vp, s));
  STGCN_TRY(launch_wgrad(Cv{nullptr, 0, 1}, 1, Cv{ds2, 1, c1}, db1, part, B, vp, s));
  STGCN_TRY(launch_contract({{ds2, nullptr, nullptr}, 1, c1, w1, 1, 0, 1, nullptr, none, 0, 0,
                             nullptr, dh, B, 1, c0, vp}, s));
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
  return ohead_bwd(x, mu, rstd, lng, lnb, ck, cb, ga, gps, gpss, dx, dmu, drstd, dlng, dlnb, dck,
                   dcb, work, nullptr, B, ko, c_in, vp, c0, act, v_true,
                   make_drop(seed, site, threshold, scale, v_true),
                   static_cast<cudaStream_t>(stream));
}

long long stgcn_ohead_bwd_work(int B, int ko, int c_in, int vp, int c0, int act) {
  size_t n = 0;
  ohead_bwd(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
            nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, &n,
            B, ko, c_in, vp, c0, act, 0, make_drop(0, 0, 0, 1.0f, 0), nullptr);
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
  return ofc_bwd(a, mu, rstd, lnw, lnb, w1, b1, w2, gout, da, dmu, drstd, dlnw, dlnb, dw1, db1,
                 dw2, db2, work, nullptr, B, c0, c1, ce, vp,
                 make_drop(seed, site, threshold, scale, v_true),
                 static_cast<cudaStream_t>(stream));
}

long long stgcn_ofc_bwd_work(int B, int c0, int c1, int ce, int vp) {
  size_t n = 0;
  ofc_bwd(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
          nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
          nullptr, &n, B, c0, c1, ce, vp, make_drop(0, 0, 0, 1.0f, 0), nullptr);
  return (long long)n;
}

}  // extern "C"
