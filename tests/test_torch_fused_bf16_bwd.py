"""Fused training in bf16 against the JAX package's ``precision="bfloat16"``
build: the plain versions of K1b-K4b's bf16 variants against the JAX cores
on the same bf16 inputs (K1b: ``_head_core`` + ``_head_core_bwd`` +
``_ln_drop_bwd``; K2b: ``_tail_core`` + ``_tail_core_bwd``; K3b and K4b: the
bodies of ``_make_ohead_bwd_kernel`` and ``_make_ofc_bwd_kernel``, mirrored
here), with one batch tile, so the LayerNorm affine gradients are summed
over the whole batch in float32 and rounded once on both sides. The bf16
outputs are held within 2 ulps of bf16 beside their rounding scale, and
only a share 2^-10 of them past the strict 2 ulps (``kernels/bf16_bounds.py``);
the float32 ones (weight and bias gradients, the LayerNorm statistics'
gradients) within 2^-8 in relative L2; the output dtypes against JAX's.
Then the slice: the gradients of the bf16 model's ``fused_sparse_forward``
on the dense and BCSR operators against ``jax.grad`` of the JAX one
(``use_pallas="xla"``) within 0.2 in relative L2 (the unfused bf16 bound,
``tests/test_torch_bf16.py``), a few fused bf16 ``Trainer`` steps against
the float32 fused ones (rtol 0.08, ``tests/test_train.py:235``), and the
bf16 backward wrappers' C calls. V = 150 in Vp = 256 (lanes 192-255: a
64-lane tile past the true vertices), B = 3; no Pallas interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgcn_tpu.data.synthetic import generate_synthetic_vel, random_road_graph
from stgcn_tpu.kernels import output_head as joh
from stgcn_tpu.kernels import vertex_fused as jvf
from stgcn_tpu.nn.fused_sparse import fused_sparse_forward as jax_fused_sparse_forward
from stgcn_tpu.nn.model import STGCN as JaxSTGCN
from stgcn_tpu_torch import kernels
from stgcn_tpu_torch.data import ForecastDataset, ZScoreScaler
from stgcn_tpu_torch.graph import build_gso
from stgcn_tpu_torch.kernels import _build
from stgcn_tpu_torch.kernels import bf16_bounds as bb
from stgcn_tpu_torch.kernels import output_head as toh
from stgcn_tpu_torch.kernels import vertex_fused as tvf
from stgcn_tpu_torch.kernels.dropout import Drop, keep_mask
from stgcn_tpu_torch.nn.convert import params_from_jax, params_to_jax
from stgcn_tpu_torch.nn.fused_sparse import fused_sparse_forward
from stgcn_tpu_torch.nn.model import STGCN
from stgcn_tpu_torch.ops import dense_graph_op
from stgcn_tpu_torch.train import TrainConfig, Trainer
from tests.test_torch_fused_bf16 import BF16, _j, _t, _t16
from tests.test_torch_fused_bf16_slice import N_HIS, _bdot_xla_f32, _FakeLib, _meta, _ops
from tests.torch_parity_utils import B, V, rand

V_PAD = 256
PREC = jvf._PRECISIONS["bfloat16"]
GRAD_REL_L2 = 0.2    # the port's unfused bf16 gradient bound (tests/test_torch_bf16.py)


def _vm():
    return (jnp.arange(V_PAD) < V).astype(jnp.float32)


def _check(got, ref, scale) -> dict:
    """``bf16_bounds.within_grads``, the dtypes against JAX's, and a print of
    max |Δ| and the float32 outputs' relative L2."""
    ref = [None if r is None else _t(r) for r in ref]
    assert [g is None for g in got] == [r is None for r in ref]
    out = bb.within_grads(got, ref, scale)
    print(f"max |Δ| {out['max_abs_err']:.3e}, float32 relative L2 "
          f"{max(out['rel_l2'], default=0.0):.3e}")
    return out


def _cfgs(act, apply_ln, **kw):
    kw = dict(kt=3, ks=3, act_func=act, graph_conv_type="cheb_graph_conv", v_true=V,
              v_pad=V_PAD, t_in=8 if apply_ln else 12, c_in=16 if apply_ln else 1, c0=16,
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


def _mask(drop, shape):
    return None if drop is None else _j(keep_mask(drop, tuple(shape), V).to(BF16))


# --------------------------------------------------------------------------
# the plain versions against the JAX cores
# --------------------------------------------------------------------------

@pytest.mark.parametrize("apply_ln", [False, True])
@pytest.mark.parametrize("act", ["glu", "gtu", "relu"])
def test_plain_head_bwd_bf16_matches_jax(act, apply_ln):
    """K1b: block 1's narrow input (c_in = 1, no LayerNorm) and a later
    block's (LayerNorm and dropout): bf16 dx, dlng, dlnb; float32 dmu,
    drstd and weight gradients."""
    jcfg, cfg = _cfgs(act, apply_ln)
    rng = np.random.default_rng(41)
    x = _t16(rand(rng, B, cfg.t_in, cfg.c_in, V_PAD))
    ln = _ln(rng, cfg.t_in, cfg.c_in) if apply_ln else None
    w = (_t16(rand(rng, 3, cfg.c_in, cfg.g1, scale=0.3)), torch.from_numpy(rand(rng, cfg.g1)),
         _t16(rand(rng, cfg.c0, cfg.c1, scale=0.3)), torch.from_numpy(rand(rng, cfg.c1)))
    gy = _t16(rand(rng, B, cfg.t1, cfg.c1, V_PAD))
    drop = Drop(0.5, 5, 1) if apply_ln else None
    jw, mask = [_j(a) for a in w], _mask(drop, x.shape)
    jln = [_j(a) for a in ln] if apply_ln else None
    x4 = jvf._ln_drop_fwd(jcfg, _j(x), *jln, mask) if apply_ln else _j(x)
    fw = jvf._head_core(jcfg, x4, jw)
    bw = jvf._head_core_bwd(jcfg, x4, jw, fw, _j(gy))
    if apply_ln:
        dx, dmu, drstd, dlng, dlnb = jvf._ln_drop_bwd(jcfg, _j(x), *jln, mask, bw["dx4"])
        ref = [dx, dmu, drstd, dlng.astype(jln[2].dtype), dlnb.astype(jln[3].dtype)]
    else:
        ref = [bw["dx4"], None, None, None, None]
    ref += [bw["dc1k"], bw["dc1b"], bw["dgaw"], bw["dgab"]]
    got = tvf.head_bwd(cfg, x, *(ln or (None,) * 4), *w, gy, drop=drop)
    assert [g is None or g.dtype for g in got] == \
        [r is None or _t(r).dtype for r in ref]
    _check(got, ref, bb.head_bwd_scale(cfg, x, ln, w, gy, drop))


@pytest.mark.parametrize("gct,ks,act", [("cheb_graph_conv", 3, "glu"),
                                        ("cheb_graph_conv", 2, "gtu"),
                                        ("graph_conv", 3, "relu")])
def test_plain_tail_bwd_bf16_matches_jax(gct, ks, act):
    """K2b: the LayerNorm-partial cotangents folded into da2 on the true
    lanes, a nonzero ga2 on the padded ones; bf16 dxg and graph-term
    gradients, float32 weight gradients."""
    jcfg, cfg = _cfgs(act, False, graph_conv_type=gct, ks=ks, c_in=16)
    rng = np.random.default_rng(42)
    xg, ta, tb = (_t16(rand(rng, B, cfg.t1, cfg.c1, V_PAD)) for _ in range(3))
    n_c = cfg.n_terms + (gct == "cheb_graph_conv")
    w = (_t16(rand(rng, n_c, cfg.c1, cfg.c1, scale=0.3)), torch.from_numpy(rand(rng, cfg.c1)),
         _t16(rand(rng, 3, cfg.c1, cfg.g2, scale=0.3)), torch.from_numpy(rand(rng, cfg.g2)))
    ga2 = _t16(rand(rng, B, cfg.t2, cfg.c2, V_PAD))
    gps, gpss = (torch.from_numpy(rand(rng, B, cfg.t2, 1, 1, scale=1e-2)) for _ in range(2))
    terms = [ta, tb][: cfg.n_terms]
    jw, jterms = [_j(a) for a in w], [_j(a) for a in terms]
    fw = jvf._tail_core(jcfg, _j(xg), jterms, jw)
    da2 = (_j(ga2).astype(jnp.float32) + (_j(gps) + 2.0 * _j(gpss) * fw["a2"].astype(
        jnp.float32)) * _vm()).astype(jnp.bfloat16)
    bw = jvf._tail_core_bwd(jcfg, _j(xg), jterms, jw, fw, da2)
    dterms = list(bw["dterms"]) + [jnp.zeros_like(_j(xg))] * (2 - len(terms))
    ref = [bw["dxg"], *dterms, bw["dgcw"], bw["dgcb"], bw["dc2k"], bw["dc2b"]]
    got = tvf.tail_bwd(cfg, xg, ta, tb, *w, ga2, gps, gpss)
    assert [g.dtype for g in got] == [BF16] * 3 + [torch.float32] * 4
    m_dxg, m_dt = bb.tail_bwd_scale(cfg, xg, terms, w, ga2, gps, gpss)
    m_dt = list(m_dt) + [torch.zeros(xg.shape)] * (2 - len(terms))
    _check(got, ref, [m_dxg, *m_dt])


def _ohead_cfgs(act, **kw):
    kw = dict(ko=4, c_in=16, c0=32, c1=24, c_end=1, act_func=act, v_true=V, v_pad=V_PAD,
              precision="bfloat16") | kw
    return (joh.OutHeadCfg(droprate=0.5, tile_v=128, b_tile=B, training=False, **kw),
            toh.OutHeadCfg(**kw))


@pytest.mark.parametrize("act", ["glu", "gtu", "relu"])
def test_plain_ohead_bwd_bf16_matches_jax(act):
    """K3b with dropout on: the body of ``_make_ohead_bwd_kernel`` on the
    same bf16 inputs; bf16 dx, dlng, dlnb, float32 dmu, drstd, dck, dcb."""
    jcfg, cfg = _ohead_cfgs(act)
    rng = np.random.default_rng(43)
    x = _t16(rand(rng, B, cfg.ko, cfg.c_in, V_PAD))
    ln = _ln(rng, cfg.ko, cfg.c_in)
    ck, cb = _t16(rand(rng, cfg.ko, cfg.c_in, cfg.g, scale=0.2)), torch.from_numpy(
        rand(rng, cfg.g))
    ga = _t16(rand(rng, B, 1, cfg.c0, V_PAD))
    gps, gpss = (torch.from_numpy(rand(rng, B, 1, 1, 1, scale=1e-2)) for _ in range(2))
    drop = Drop(0.5, 6, 2)
    mask, jln = _mask(drop, x.shape), [_j(a) for a in ln]
    x4 = jvf._ln_drop_fwd(jcfg, _j(x), *jln, mask)
    s, xin, a, aux = joh._ohead_core(jcfg, x4, _j(ck), _j(cb))
    vm = _vm()
    da = (_j(ga).astype(jnp.float32) + (_j(gps) + 2.0 * _j(gpss) * a.astype(jnp.float32) * vm)
          * vm).astype(x4.dtype)
    ds, dxin = jvf._gate_bwd_cv(jcfg, s, xin, cfg.c0, da, aux=aux)
    dck, dcb, dx4 = jvf._tconv_bwd_cv(x4, ds, _j(ck), cfg.ko, PREC)
    dx4 = dx4 + jvf._shift_pad_t(dxin[:, :, :cfg.c_in, :], cfg.ko - 1, cfg.ko)
    dx, dmu, drstd, dlng, dlnb = jvf._ln_drop_bwd(jcfg, _j(x), *jln, mask, dx4)
    ref = [dx, dmu, drstd, dlng.astype(jln[2].dtype), dlnb.astype(jln[3].dtype), dck, dcb]
    got = toh.ohead_bwd(cfg, x, *ln, ck, cb, ga, gps, gpss, drop=drop)
    assert [g.dtype for g in got] == [BF16, torch.float32, torch.float32, BF16, BF16,
                                      torch.float32, torch.float32]
    _check(got, ref, bb.ohead_bwd_scale(cfg, x, *ln, ck, cb, ga, gps, gpss, drop=drop))


@pytest.mark.parametrize("rate", [None, 0.5])
def test_plain_ofc_bwd_bf16_matches_jax(rate):
    """K4b: the body of ``_make_ofc_bwd_kernel`` (gout rounded to bf16 first,
    dzd and dh rounded, the mask a bf16 product); bf16 da, dlnw, dlnb."""
    jcfg, cfg = _ohead_cfgs("glu")
    rng = np.random.default_rng(44)
    a = _t16(rand(rng, B, 1, cfg.c0, V_PAD))
    ln = _ln(rng, 1, cfg.c0)
    w = (_t16(rand(rng, cfg.c0, cfg.c1, scale=0.3)), torch.from_numpy(rand(rng, cfg.c1)),
         _t16(rand(rng, cfg.c1, cfg.c_end, scale=0.3)), torch.from_numpy(rand(rng, cfg.c_end)))
    gout = torch.from_numpy(rand(rng, B, 1, cfg.c_end, V_PAD))
    drop = Drop(rate, 7, 3) if rate else None
    jw, jln = [_j(t) for t in w], [_j(t) for t in ln]
    h = jvf._ln_drop_fwd(jcfg, _j(a), *jln, None)
    s2, z = joh._ofc_core(jcfg, h, jw[0], jw[1])
    mask = _mask(drop, z.shape)
    zd = z if mask is None else z * mask
    g = _j(gout).astype(h.dtype)
    dzd = joh._bdot(g, jw[2].T, PREC).astype(h.dtype)
    dz = dzd if mask is None else dzd * mask
    ds2 = dz * joh._pos_mask(s2)
    dh = joh._bdot(ds2, jw[0].T, PREC).astype(h.dtype)
    da, dmu, drstd, dlnw, dlnb = jvf._ln_drop_bwd(jcfg, _j(a), *jln, None, dh)
    ref = [da, dmu, drstd, dlnw.astype(jln[2].dtype), dlnb.astype(jln[3].dtype),
           joh._bdot_sum(h, ds2, PREC), jnp.sum(ds2.astype(jnp.float32), axis=(0, 1, 3)),
           joh._bdot_sum(zd, g, PREC), jnp.sum(g.astype(jnp.float32), axis=(0, 1, 3))]
    got = toh.ofc_bwd(cfg, a, *ln, *w, gout, drop=drop)
    _check(got, ref, bb.ofc_bwd_scale(cfg, a, *ln, *w, gout, drop=drop))


# --------------------------------------------------------------------------
# the slice
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "bcsr"])
def test_fused_bf16_grads_match_jax(kind, monkeypatch):
    """The parameter gradients of the bf16 model's ``fused_sparse_forward``
    (the Functions over K1b-K4b's bf16 plain versions; on BCSR the graph
    terms' adjoint through K10's bf16 plain version on the transposed pack)
    against ``jax.grad`` of the JAX bf16 model's ``fused_sparse_forward(
    use_pallas="xla")`` with the same weights: each within 0.2 in relative
    L2; every parameter gets a float32 gradient (the master weights), each
    rounded to bf16 where the JAX custom_vjp rounds it (bf16 weights)."""
    monkeypatch.setattr(jvf, "_bdot_xla", _bdot_xla_f32)
    jop, top, v = _ops(kind)
    rng = np.random.default_rng(7)
    x, ct = rand(rng, B, N_HIS, v, 1), rand(rng, B, 1, v, 1)
    tm = STGCN(N_HIS, v, dtype=BF16, device="cpu", generator=torch.Generator().manual_seed(8))
    jm = JaxSTGCN(n_his=N_HIS, dtype=jnp.bfloat16)
    jgrad = jax.jit(jax.grad(lambda p: jnp.sum(jax_fused_sparse_forward(
        p, jnp.asarray(x), jop, jm, deterministic=True, use_pallas="xla") * ct)))(
        params_to_jax(tm))
    ref = params_from_jax(jax.device_get(jgrad))
    params = dict(tm.named_parameters())
    out = fused_sparse_forward(params, torch.from_numpy(x), top, tm)
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), list(params.values()))
    assert set(ref) == set(params)
    worst = 0.0
    for name, g in zip(params, grads):
        r = ref[name].float()
        assert g.dtype == torch.float32 and g.shape == r.shape
        err = float(torch.linalg.vector_norm(g - r) / torch.linalg.vector_norm(r))
        worst = max(worst, err)
        assert err <= GRAD_REL_L2, (name, err)
    print(f"worst relative L2 {worst:.3e}")


def test_fused_bf16_trainer_steps_match_f32(tmp_path):
    """Three fused bf16 ``Trainer`` steps (``fused=True``,
    ``compute_dtype="bfloat16"``, dropout on) from the weights of three
    fused float32 steps: the losses within rtol 0.08; the parameters and
    optimizer state stay float32; nothing launched on the CPU."""
    adj = random_road_graph(V, k_neighbors=4, seed=11)
    vel = generate_synthetic_vel(adj, 23, seed=12)
    scaler = ZScoreScaler().fit(vel)
    ds = ForecastDataset.from_numpy(scaler.transform(vel), N_HIS, 3, device="cpu")
    gop = dense_graph_op(build_gso(adj, "sym_norm_lap", cheb=True), device="cpu")
    state = STGCN(N_HIS, V, device="cpu", generator=torch.Generator().manual_seed(9)).state_dict()

    def run(dtype):
        model = STGCN(N_HIS, V, dtype=dtype, device="cpu")
        model.load_state_dict(state)
        cfg = TrainConfig(n_his=N_HIS, n_pred=3, batch_size=B, seed=3, fused=True,
                          compute_dtype="bfloat16" if dtype is not None else None,
                          ckpt_dir=str(tmp_path / str(dtype)), dataset_name="toy")
        tr = Trainer(cfg, model, gop, ds, ds, ds, scaler, device="cpu")
        losses = [float(tr.train_step(starts, n, i))
                  for i, (starts, n) in enumerate(tr._plan(tr.train_ds))]
        assert all(p.dtype == torch.float32 for p in tr.params.values())
        assert all(m.dtype == torch.float32 for m in tr.opt_state["mu"].values())
        return losses

    kernels.reset_launch_counts()
    l16, l32 = run(BF16), run(None)
    assert not any(kernels.launch_counts().values())
    assert len(l16) == 3 and np.isfinite(l16).all()
    np.testing.assert_allclose(l16, l32, rtol=0.08)


def test_bf16_bwd_wrappers_call_their_entry_points(monkeypatch):
    """On a non-CPU tensor each bf16 backward wrapper sizes its workspace by
    ``stgcn_*_bwd_bf16_work`` and makes one call of ``stgcn_*_bwd_bf16`` with
    the signature's argument count, counted under its ``_bf16`` name and not
    the float32 one's; the data gradients are bf16, the weight gradients
    float32; a float32 gradient input is refused."""
    fake = _FakeLib()
    monkeypatch.setattr(_build, "library", lambda: fake)
    for mod in (tvf, toh):
        monkeypatch.setattr(mod, "cuda_device", lambda t: t.device)
        monkeypatch.setattr(mod, "stream_of", lambda dev: 0)
    f32 = torch.float32
    _, cfg = _cfgs("glu", True, v_pad=384)
    stats = (_meta(B, 8, 1, 1, dtype=f32), _meta(B, 8, 1, 1, dtype=f32))
    _, ocfg = _ohead_cfgs("glu", v_pad=384)
    head = (cfg, _meta(B, 8, 16, 384), *stats, _meta(16, 384), _meta(16, 384), _meta(3, 16, 32),
            _meta(32, dtype=f32), _meta(16, 8), _meta(8, dtype=f32))
    calls = {
        "head_bwd": lambda: tvf.head_bwd(*head, _meta(B, 6, 8, 384)),
        "tail_bwd": lambda: tvf.tail_bwd(
            cfg, *(_meta(B, 6, 8, 384) for _ in range(3)), _meta(3, 8, 8), _meta(8, dtype=f32),
            _meta(3, 8, 32), _meta(32, dtype=f32), _meta(B, 4, 16, 384),
            _meta(B, 4, 1, 1, dtype=f32), _meta(B, 4, 1, 1, dtype=f32)),
        "ohead_bwd": lambda: toh.ohead_bwd(
            ocfg, _meta(B, 4, 16, 384), _meta(B, 4, 1, 1, dtype=f32),
            _meta(B, 4, 1, 1, dtype=f32), _meta(16, 384), _meta(16, 384), _meta(4, 16, 64),
            _meta(64, dtype=f32), _meta(B, 1, 32, 384), _meta(B, 1, 1, 1, dtype=f32),
            _meta(B, 1, 1, 1, dtype=f32)),
        "ofc_bwd": lambda: toh.ofc_bwd(
            ocfg, _meta(B, 1, 32, 384), _meta(B, 1, 1, 1, dtype=f32),
            _meta(B, 1, 1, 1, dtype=f32), _meta(32, 384), _meta(32, 384), _meta(32, 24),
            _meta(24, dtype=f32), _meta(24, 1), _meta(1, dtype=f32),
            _meta(B, 1, 1, 384, dtype=f32)),
    }
    for name, call in calls.items():
        before = kernels.launch_counts()
        out = [g for g in call() if g is not None]
        after = kernels.launch_counts()
        assert after[f"{name}_bf16"] == before[f"{name}_bf16"] + 1 and after[name] == before[name]
        (work_name, _), (c_name, args) = fake.calls[-2:]
        assert (work_name, c_name) == (f"stgcn_{name}_bf16_work", f"stgcn_{name}_bf16")
        assert len(args) == len(_build.SIGNATURES[c_name]) == len(_build.SIGNATURES[f"stgcn_{name}"])
        assert out[0].dtype == BF16 and out[-1].dtype == f32
    with pytest.raises(TypeError, match="gy must be torch.bfloat16"):
        tvf.head_bwd(*head, _meta(B, 6, 8, 384, dtype=f32))
