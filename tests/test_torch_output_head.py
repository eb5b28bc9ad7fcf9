"""Plain versions of K3 (ohead) and K4 (ofc) against the JAX package's output
head kernels in Pallas interpret mode, and the port's fused output head
against both packages' cv oracle ``_output_block_apply_cv``."""

import jax.numpy as jnp
import numpy as np
import pytest

from stgcn_tpu.kernels import output_head as joh
from stgcn_tpu_torch.kernels import output_head as toh
from stgcn_tpu_torch.kernels.dropout import Drop, keep_mask
from tests.gate_gemm_edges import OFC_EDGES, OHEAD_EDGES, v_true_of
from tests.torch_parity_utils import B, rand, t

ATOL = 2e-5
V_TRUE, V_PAD = 150, 256
ACTS = ["glu", "gtu", "relu", "silu"]


def _cfgs(act, c_in=16):
    kw = dict(ko=4, c_in=c_in, c0=32, c1=24, c_end=1, act_func=act, v_true=V_TRUE,
              v_pad=V_PAD)
    return (joh.OutHeadCfg(droprate=0.5, tile_v=128, b_tile=B, training=False,
                           interpret=True, **kw), toh.OutHeadCfg(**kw))


def _stats(rng, n_t):
    return (rand(rng, B, n_t, 1, 1, scale=0.1),
            (0.5 + rng.random((B, n_t, 1, 1))).astype(np.float32))


def _affine(rng, c):
    g, b = 1.0 + rand(rng, c, V_PAD, scale=0.1), rand(rng, c, V_PAD)
    g[:, V_TRUE:] = 0.0
    b[:, V_TRUE:] = 0.0
    return g, b


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("act", ACTS)
def test_ohead_plain_matches_jax_kernel(act):
    jcfg, cfg = _cfgs(act)
    rng = np.random.default_rng(31)
    x = rand(rng, B, cfg.ko, cfg.c_in, V_PAD)
    args = [x, *_stats(rng, cfg.ko), *_affine(rng, cfg.c_in),
            rand(rng, cfg.ko, cfg.c_in, cfg.g, scale=0.2), rand(rng, cfg.g, scale=0.1)]
    got = toh.ohead_fwd(cfg, *map(t, args))
    kern = joh.ohead_fused(jcfg, jnp.int32(V_TRUE), 0, *_j(args))
    for g, k in zip(got, kern):
        atol = ATOL * max(1.0, float(np.abs(np.asarray(k)).max()))
        np.testing.assert_allclose(g.numpy(), np.asarray(k), atol=atol)
    assert got[0].shape == (B, 1, cfg.c0, V_PAD) and got[1].shape == (B, 1, 1, 1)


@pytest.mark.parametrize("act", ACTS[:2])
def test_ofc_plain_matches_jax_kernel(act):
    jcfg, cfg = _cfgs(act)
    rng = np.random.default_rng(32)
    args = [rand(rng, B, 1, cfg.c0, V_PAD), *_stats(rng, 1), *_affine(rng, cfg.c0),
            rand(rng, cfg.c0, cfg.c1, scale=0.2), rand(rng, cfg.c1, scale=0.1),
            rand(rng, cfg.c1, cfg.c_end, scale=0.2), rand(rng, cfg.c_end, scale=0.1)]
    got = toh.ofc_fwd(cfg, *map(t, args)).numpy()
    kern = np.asarray(joh.ofc_fused(jcfg, jnp.int32(V_TRUE), 0, *_j(args)))
    assert got.shape == (B, 1, cfg.c_end, V_PAD)
    np.testing.assert_allclose(got, kern, atol=ATOL)


@pytest.mark.parametrize("act,c0,c_in,ko,drop,batch,v_pad", OHEAD_EDGES)
def test_ohead_plain_at_tile_edges_matches_jax(act, c0, c_in, ko, drop, batch, v_pad):
    """K3f's plain version against the JAX K3f's body (``_ln_drop_fwd``,
    ``_ohead_core``, the partial sums over the true lanes) at the edge shapes
    of the gate GEMM's tile, where the card tests hold the kernel to the
    plain version; the keyed input mask handed to both."""
    v_true = v_true_of(v_pad)
    kw = dict(ko=ko, c_in=c_in, c0=c0, c1=1, c_end=1, act_func=act, v_true=v_true,
              v_pad=v_pad)
    jcfg = joh.OutHeadCfg(droprate=0.5, tile_v=128, b_tile=batch, training=False, **kw)
    cfg = toh.OutHeadCfg(**kw)
    rng = np.random.default_rng(35)
    lng, lnb = 1.0 + rand(rng, c_in, v_pad, scale=0.1), rand(rng, c_in, v_pad)
    lng[:, v_true:] = 0.0
    lnb[:, v_true:] = 0.0
    args = [rand(rng, batch, ko, c_in, v_pad), rand(rng, batch, ko, 1, 1, scale=0.1),
            (0.5 + rng.random((batch, ko, 1, 1))).astype(np.float32), lng, lnb,
            rand(rng, ko, c_in, cfg.g, scale=(ko * c_in) ** -0.5), rand(rng, cfg.g, scale=0.1)]
    d = Drop(0.5, 2024, 2) if drop else None
    got = toh.ohead_fwd(cfg, *map(t, args), drop=d)
    mask = None if d is None else jnp.asarray(keep_mask(d, (batch, ko, c_in, v_pad),
                                                        v_true).numpy())
    x, mu, rstd, lng_, lnb_, ck, cb = _j(args)
    _, _, a, _ = joh._ohead_core(jcfg, joh._ln_drop_fwd(jcfg, x, mu, rstd, lng_, lnb_, mask),
                                 ck, cb)
    live = np.asarray(a) * (np.arange(v_pad) < v_true)
    ref = (np.asarray(a), live.sum((2, 3), keepdims=True), (live * live).sum((2, 3),
                                                                             keepdims=True))
    assert got[0].shape == (batch, 1, c0, v_pad) and got[1].shape == (batch, 1, 1, 1)
    for g, r in zip(got, ref):
        atol = ATOL * max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g.numpy(), r, atol=atol)


def _jax_ofc(jcfg, a, mu, rstd, lnw, lnb, w1, b1, w2, b2, mask):
    """The body of the JAX K4f (``_make_ofc_fwd_kernel``) on whole arrays,
    its dropout mask given."""
    h = joh._ln_drop_fwd(jcfg, a, mu, rstd, lnw, lnb, None)
    _, z = joh._ofc_core(jcfg, h, w1, b1)
    if mask is not None:
        z = z * mask
    return joh._bdot(z, w2, joh._PRECISIONS[jcfg.precision]) + b2[:, None]


@pytest.mark.parametrize("c0,c1,c_end,drop,batch,v_pad", OFC_EDGES)
def test_ofc_plain_at_tile_edges_matches_jax(c0, c1, c_end, drop, batch, v_pad):
    """K4f's plain version against the JAX K4f's body at the edge shapes of
    the gate GEMM's tile, where the card tests hold the kernel to the plain
    version; the keyed mask after the ReLU handed to both."""
    v_true = v_true_of(v_pad)
    kw = dict(ko=4, c_in=1, c0=c0, c1=c1, c_end=c_end, act_func="glu", v_true=v_true,
              v_pad=v_pad)
    jcfg = joh.OutHeadCfg(droprate=0.5, tile_v=128, b_tile=batch, training=False, **kw)
    cfg = toh.OutHeadCfg(**kw)
    rng = np.random.default_rng(34)
    lnw, lnb = 1.0 + rand(rng, c0, v_pad, scale=0.1), rand(rng, c0, v_pad)
    lnw[:, v_true:] = 0.0
    lnb[:, v_true:] = 0.0
    args = [rand(rng, batch, 1, c0, v_pad), rand(rng, batch, 1, 1, 1, scale=0.1),
            (0.5 + rng.random((batch, 1, 1, 1))).astype(np.float32), lnw, lnb,
            rand(rng, c0, c1, scale=c0 ** -0.5), rand(rng, c1, scale=0.1),
            rand(rng, c1, c_end, scale=c1 ** -0.5), rand(rng, c_end, scale=0.1)]
    d = Drop(0.5, 2024, 3) if drop else None
    got = toh.ofc_fwd(cfg, *map(t, args), drop=d).numpy()
    mask = None if d is None else keep_mask(d, (batch, 1, c1, v_pad), v_true).numpy()
    ref = np.asarray(_jax_ofc(jcfg, *_j(args), mask))
    assert got.shape == (batch, 1, c_end, v_pad)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def _head_params(rng, cfg):
    """A flax output-block subtree (numpy) at the cfg's widths."""
    return {"tmp_conv1": {"causal_conv": {
                "kernel": rand(rng, cfg.ko, 1, cfg.c_in, cfg.g, scale=0.2),
                "bias": rand(rng, cfg.g, scale=0.1)}},
            "ln": {"scale": 1.0 + rand(rng, V_TRUE, cfg.c0, scale=0.1),
                   "bias": rand(rng, V_TRUE, cfg.c0, scale=0.1)},
            "fc1": {"kernel": rand(rng, cfg.c0, cfg.c1, scale=0.2),
                    "bias": rand(rng, cfg.c1, scale=0.1)},
            "fc2": {"kernel": rand(rng, cfg.c1, cfg.c_end, scale=0.2),
                    "bias": rand(rng, cfg.c_end, scale=0.1)}}
