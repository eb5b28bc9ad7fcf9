"""The fused forward in bf16 against the JAX package's ``precision="bfloat16"``
build, kernel by kernel: the plain versions of K1f-K4f's bf16 variants
against the JAX jnp mirrors (``head_reference``, ``tail_reference``,
``_ln_drop_fwd`` + ``_ohead_core``, ``_ofc_core``) on the same bf16 inputs,
pass by pass on the JAX pass's input within 2 ulps of bf16 (2^-7·|ref| +
1e-4·min(1, max |ref|), ``PERF.md`` §2) and whole within that bound beside
the rounding scale of the terms (``kernels/bf16_bounds.py``: an earlier pass
rounded to the neighbouring bf16 value, as float32 sums in another order
may, moves a later one by more than 2 ulps of its own value); the output
dtypes against JAX's. V = 150 in Vp = 384 (a whole 128-lane tile past the
true vertices), B = 3; no Pallas interpret mode. The slice (the bf16 model's
``fused_sparse_forward``), the wrappers' C calls and the refusals are in
``tests/test_torch_fused_bf16_slice.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgcn_tpu.kernels import output_head as joh
from stgcn_tpu.kernels import vertex_fused as jvf
from stgcn_tpu_torch.kernels import bf16_bounds as bb
from stgcn_tpu_torch.kernels import output_head as toh
from stgcn_tpu_torch.kernels import vertex_fused as tvf
from stgcn_tpu_torch.kernels.dropout import Drop, apply_cv, keep_mask
from tests.torch_parity_utils import B, V, rand

BF16 = torch.bfloat16
V_PAD = 384            # lanes 150-383 padded: the third 128-lane tile holds no true vertex


def _t16(a) -> torch.Tensor:
    """float32 numpy → a bf16 torch tensor (rounded to nearest even)."""
    return torch.from_numpy(np.array(a, np.float32)).to(BF16)


def _t(a) -> torch.Tensor:
    """A JAX or numpy array → torch, in its own type (bf16 stays bf16)."""
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(BF16)
    return torch.from_numpy(np.array(a))


def _j(t: torch.Tensor):
    """torch → JAX, in its own type."""
    a = jnp.asarray(t.detach().float().numpy())
    return a.astype(jnp.bfloat16) if t.dtype == BF16 else a


def _within(got: torch.Tensor, ref) -> None:
    """Two ulps of bf16 plus the floor, and the same dtype."""
    ref = _t(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    g, r = got.float(), ref.float()
    bound = 2.0 ** -7 * r.abs() + 1e-4 * min(1.0, float(r.abs().max()))
    bad = (g - r).abs() > bound
    assert not bool(bad.any()), (f"{int(bad.sum())} of {bad.numel()} outside 2 ulps, max |Δ| "
                                 f"{float((g - r).abs().max()):.3e}")


def _cfgs(act, apply_ln, **kw):
    kw = dict(kt=3, ks=3, act_func=act, graph_conv_type="cheb_graph_conv", v_true=V,
              v_pad=V_PAD, t_in=8 if apply_ln else 12, c_in=16 if apply_ln else 8, c0=16,
              c1=8, c2=16, apply_ln=apply_ln, precision="bfloat16") | kw
    return (jvf.VertexBlockCfg(droprate=0.5, tile_v=128, training=False, **kw),
            tvf.VertexBlockCfg(**kw))


def _ln(rng, t_in, c):
    mu = torch.from_numpy(rand(rng, B, t_in, 1, 1, scale=0.1))
    rstd = torch.from_numpy((0.5 + rng.random((B, t_in, 1, 1))).astype(np.float32))
    lng, lnb = 1.0 + rand(rng, c, V_PAD, scale=0.1), rand(rng, c, V_PAD, scale=0.1)
    lng[:, V:] = 0.0
    lnb[:, V:] = 0.0
    return mu, rstd, _t16(lng), _t16(lnb)


# --------------------------------------------------------------------------
# the plain versions against the JAX mirrors
# --------------------------------------------------------------------------

@pytest.mark.parametrize("apply_ln", [False, True])
@pytest.mark.parametrize("act", ["glu", "gtu", "relu"])
def test_plain_head_bf16_matches_jax(act, apply_ln):
    """K1f: the normalized and dropped input, conv 1 (s1), the gate (a1) and
    the align (xg), each on the JAX pass's input, then the whole; bf16 xg."""
    jcfg, cfg = _cfgs(act, apply_ln)
    rng = np.random.default_rng(31)
    x = _t16(rand(rng, B, cfg.t_in, cfg.c_in, V_PAD))
    ln = _ln(rng, cfg.t_in, cfg.c_in) if apply_ln else None
    w = (_t16(rand(rng, 3, cfg.c_in, cfg.g1, scale=0.3)), torch.from_numpy(rand(rng, cfg.g1)),
         _t16(rand(rng, cfg.c0, cfg.c1, scale=0.3)), torch.from_numpy(rand(rng, cfg.c1)))
    drop = Drop(0.5, 5, 1) if apply_ln else None
    jw, jln = [_j(a) for a in w], [_j(a) for a in ln] if apply_ln else None
    mask = _j(keep_mask(drop, tuple(x.shape), V).to(BF16)) if drop else None

    jxn = jvf._ln_drop_fwd(jcfg, _j(x), *jln, mask) if apply_ln else _j(x)
    if apply_ln:
        _within(apply_cv(tvf.ln_normalize_cv(x, *ln), drop, V), jxn)
    fw = jvf._head_core(jcfg, jxn, jw)
    xn = _t(jxn)
    _within(tvf.tconv_cv(xn, w[0], w[1], 3), fw["s1"])
    _within(tvf.gate_cv(act, _t(fw["s1"]), tvf.pad_channels_cv(xn[:, 2:], cfg.c0), cfg.c0),
            fw["a1"])
    _within(tvf.linear_cv(_t(fw["a1"]), w[2], w[3]), fw["xg"])

    got = tvf.head_fwd(cfg, x, *(ln or (None,) * 4), *w, drop=drop)
    ref = jvf.head_reference(jcfg, _j(x), jln, jw, mask)
    assert got.dtype == BF16 and ref.dtype == jnp.bfloat16
    bb.within(got, _t(ref), bb.head_scale(cfg, x, ln, w, drop))


@pytest.mark.parametrize("gct,ks,act", [("cheb_graph_conv", 3, "glu"),
                                        ("cheb_graph_conv", 2, "gtu"),
                                        ("graph_conv", 3, "relu")])
def test_plain_tail_bf16_matches_jax(gct, ks, act):
    """K2f: the contraction rounded before the residual (r), conv 2 on h
    (s2), the gate (a2) and the partial sums, each on the JAX pass's input,
    then the whole; bf16 a2, float32 partials."""
    jcfg, cfg = _cfgs(act, False, graph_conv_type=gct, ks=ks)
    rng = np.random.default_rng(32)
    xg, ta, tb = (_t16(rand(rng, B, cfg.t1, cfg.c1, V_PAD)) for _ in range(3))
    n_c = cfg.n_terms + (gct == "cheb_graph_conv")
    w = (_t16(rand(rng, n_c, cfg.c1, cfg.c1, scale=0.3)), torch.from_numpy(rand(rng, cfg.c1)),
         _t16(rand(rng, 3, cfg.c1, cfg.g2, scale=0.3)), torch.from_numpy(rand(rng, cfg.g2)))
    terms = [ta, tb][: cfg.n_terms]
    jw = [_j(a) for a in w]
    fw = jvf._tail_core(jcfg, _j(xg), [_j(a) for a in terms], jw)
    _within(tvf.tail_preact(cfg, xg, terms, w), fw["r"])
    h = _t(fw["h"])
    _within(tvf.tconv_cv(h, w[2], w[3], 3), fw["s2"])
    _within(tvf.gate_cv(act, _t(fw["s2"]), tvf.pad_channels_cv(h[:, 2:], cfg.c2), cfg.c2),
            fw["a2"])
    ref = jvf.tail_reference(jcfg, _j(xg), [_j(a) for a in terms], jw)
    for got, r in zip(tvf.masked_ln_sums(_t(fw["a2"]), V), ref[1:]):
        _within(got, r)

    got = tvf.tail_fwd(cfg, xg, ta, tb, *w)
    assert [g.dtype for g in got] == [BF16, torch.float32, torch.float32]
    assert [r.dtype for r in ref] == [jnp.bfloat16, jnp.float32, jnp.float32]
    bb.within(got, tuple(_t(r) for r in ref), bb.tail_scale(cfg, xg, terms, w))


def _ohead_cfgs(act, **kw):
    kw = dict(ko=4, c_in=16, c0=32, c1=24, c_end=1, act_func=act, v_true=V, v_pad=V_PAD,
              precision="bfloat16") | kw
    return (joh.OutHeadCfg(droprate=0.5, tile_v=128, b_tile=B, training=False, **kw),
            toh.OutHeadCfg(**kw))


@pytest.mark.parametrize("act", ["glu", "gtu", "relu"])
def test_plain_ohead_bf16_matches_jax(act):
    """K3f: the final block's LayerNorm and dropout, the ko-tap conv (s),
    the gate (a) and the partial sums, each on the JAX pass's input, then the
    whole; bf16 a, float32 partials."""
    jcfg, cfg = _ohead_cfgs(act)
    rng = np.random.default_rng(33)
    x = _t16(rand(rng, B, cfg.ko, cfg.c_in, V_PAD))
    ln = _ln(rng, cfg.ko, cfg.c_in)
    ck, cb = _t16(rand(rng, cfg.ko, cfg.c_in, cfg.g, scale=0.2)), torch.from_numpy(
        rand(rng, cfg.g))
    drop = Drop(0.5, 6, 2)
    mask = _j(keep_mask(drop, tuple(x.shape), V).to(BF16))
    jxn = jvf._ln_drop_fwd(jcfg, _j(x), *[_j(a) for a in ln], mask)
    _within(apply_cv(tvf.ln_normalize_cv(x, *ln), drop, V), jxn)
    s, _, a, _ = joh._ohead_core(jcfg, jxn, _j(ck), _j(cb))
    xn = _t(jxn)
    _within(tvf.tconv_cv(xn, ck, cb, cfg.ko), s)
    _within(tvf.gate_cv(act, _t(s), tvf.pad_channels_cv(xn[:, cfg.ko - 1:], cfg.c0), cfg.c0),
            a)
    a32 = np.asarray(a.astype(jnp.float32))[..., :V]   # the JAX kernel's float32 sums
    ref_sums = (a32.sum((2, 3), keepdims=True), (a32 * a32).sum((2, 3), keepdims=True))
    for got, r in zip(tvf.masked_ln_sums(_t(a), V), ref_sums):
        _within(got, r)

    got = toh.ohead_fwd(cfg, x, *ln, ck, cb, drop=drop)
    assert [g.dtype for g in got] == [BF16, torch.float32, torch.float32]
    bb.within(got, (_t(a), *(torch.from_numpy(r) for r in ref_sums)),
              bb.ohead_scale(cfg, x, *ln, ck, cb, drop=drop))


@pytest.mark.parametrize("rate", [None, 0.5, 0.3])
def test_plain_ofc_bf16_matches_jax(rate):
    """K4f: the LayerNorm output, fc1 (s2) and, on the JAX ReLU output, the
    mask (a bf16 product, its scale rounded to bf16: 1/0.7 is not a bf16
    value) and fc2, then the whole; the output float32, as JAX's."""
    jcfg, cfg = _ohead_cfgs("glu")
    rng = np.random.default_rng(34)
    a = _t16(rand(rng, B, 1, cfg.c0, V_PAD))
    ln = _ln(rng, 1, cfg.c0)
    w = (_t16(rand(rng, cfg.c0, cfg.c1, scale=0.3)), torch.from_numpy(rand(rng, cfg.c1)),
         _t16(rand(rng, cfg.c1, cfg.c_end, scale=0.3)), torch.from_numpy(rand(rng, cfg.c_end)))
    drop = Drop(rate, 7, 3) if rate else None
    jw = [_j(t) for t in w]
    jh = jvf._ln_drop_fwd(jcfg, _j(a), *[_j(t) for t in ln], None)
    _within(tvf.ln_normalize_cv(a, *ln), jh)
    s2, z = joh._ofc_core(jcfg, jh, jw[0], jw[1])
    _within(tvf.linear_cv(_t(jh), w[0], w[1]), s2)
    zm = z if drop is None else z * _j(keep_mask(drop, tuple(z.shape), V).to(BF16))
    ref = joh._bdot(zm, jw[2]) + jw[3][:, None]
    _within(toh.ofc_out(cfg, _t(z), w[2], w[3], drop), ref)

    got = toh.ofc_fwd(cfg, a, *ln, *w, drop=drop)
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    bb.within(got, _t(ref), bb.ofc_scale(cfg, a, *ln, *w, drop=drop))
