"""Plain versions of K1 (head) and K2 (tail) against the JAX package's
vertex-fused kernels in Pallas interpret mode and their ``*_reference``
oracles; the CUDA kernels against the plain versions on a card."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgcn_tpu.kernels import vertex_fused as jvf
from stgcn_tpu_torch.kernels import vertex_fused as tvf
from stgcn_tpu_torch.kernels.dropout import Drop, keep_mask
from tests.gate_gemm_edges import HEAD_EDGES, TAIL_EDGES, v_true_of
from tests.torch_parity_utils import B, GATE_CASES, rand, t

ATOL = 2e-5
V_TRUE, V_PAD = 150, 256   # V is not a multiple of the 128-lane tile


def _cfgs(gct, ks, act, apply_ln):
    c_in = 16 if apply_ln else 8   # JAX floors c_in at 8 (a Mosaic limit)
    kw = dict(kt=3, ks=ks, act_func=act, graph_conv_type=gct, v_true=V_TRUE,
              v_pad=V_PAD, t_in=8 if apply_ln else 12, c_in=c_in, c0=16, c1=8, c2=16,
              apply_ln=apply_ln)
    jcfg = jvf.VertexBlockCfg(droprate=0.5, tile_v=128, training=False, interpret=True,
                              **kw)
    return jcfg, tvf.VertexBlockCfg(**kw)


def _head_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    x = rand(rng, B, cfg.t_in, cfg.c_in, cfg.v_pad)
    mu = rand(rng, B, cfg.t_in, 1, 1, scale=0.1)
    rstd = (0.5 + rng.random((B, cfg.t_in, 1, 1))).astype(np.float32)
    lng, lnb = 1.0 + rand(rng, cfg.c_in, cfg.v_pad, scale=0.1), rand(rng, cfg.c_in, cfg.v_pad)
    lng[:, cfg.v_true:] = 0.0
    lnb[:, cfg.v_true:] = 0.0
    w = (rand(rng, cfg.kt, cfg.c_in, cfg.g1, scale=0.2), rand(rng, cfg.g1, scale=0.1),
         rand(rng, cfg.c0, cfg.c1, scale=0.2), rand(rng, cfg.c1, scale=0.1))
    return x, (mu, rstd, lng, lnb), w


def _tail_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    xg, ta, tb = (rand(rng, B, cfg.t1, cfg.c1, cfg.v_pad) for _ in range(3))
    n_c = cfg.n_terms + (cfg.graph_conv_type == "cheb_graph_conv")
    w = (rand(rng, n_c, cfg.c1, cfg.c1, scale=0.2), rand(rng, cfg.c1, scale=0.1),
         rand(rng, cfg.kt, cfg.c1, cfg.g2, scale=0.2), rand(rng, cfg.g2, scale=0.1))
    return xg, ta, tb, w


@pytest.mark.parametrize("apply_ln", [False, True])
@pytest.mark.parametrize("gct,ks,act", GATE_CASES)
def test_head_plain_matches_jax_kernel(gct, ks, act, apply_ln):
    jcfg, cfg = _cfgs(gct, ks, act, apply_ln)
    x, ln, w = _head_inputs(cfg, seed=11)
    got = tvf.head_fwd(cfg, t(x), *(map(t, ln) if apply_ln else [None] * 4),
                       *map(t, w)).numpy()
    jx, jln, jw = jnp.asarray(x), [jnp.asarray(a) for a in ln], [jnp.asarray(a) for a in w]
    kern = np.asarray(jvf.head_fused(jcfg, 0, jx, *jln, *jw))
    ref = np.asarray(jvf.head_reference(jcfg, jx, jln if apply_ln else None, jw))
    assert got.shape == (B, cfg.t1, cfg.c1, V_PAD)
    np.testing.assert_allclose(got, kern, atol=ATOL)
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("act,c0,c_in,kt,t_in,c1,apply_ln,drop,batch,v_pad", HEAD_EDGES)
def test_head_plain_at_tile_edges_matches_jax(act, c0, c_in, kt, t_in, c1, apply_ln, drop,
                                              batch, v_pad):
    """K1f's plain version against the JAX ``head_reference`` at the edge
    shapes of the gate GEMM's tile, where the card tests hold the kernel to
    the plain version; the input dropout's keyed mask handed to both."""
    kw = dict(kt=kt, ks=3, act_func=act, graph_conv_type="cheb_graph_conv",
              v_true=v_true_of(v_pad), v_pad=v_pad, t_in=t_in, c_in=c_in, c0=c0, c1=c1, c2=c1,
              apply_ln=apply_ln)
    jcfg = jvf.VertexBlockCfg(droprate=0.5, tile_v=128, training=False, **kw)
    cfg = tvf.VertexBlockCfg(**kw)
    rng = np.random.default_rng(14)
    x = rand(rng, batch, t_in, c_in, v_pad)
    ln = (rand(rng, batch, t_in, 1, 1, scale=0.1),
          (0.5 + rng.random((batch, t_in, 1, 1))).astype(np.float32),
          1.0 + rand(rng, c_in, v_pad, scale=0.1), rand(rng, c_in, v_pad))
    ln[2][:, cfg.v_true:] = 0.0
    ln[3][:, cfg.v_true:] = 0.0
    w = (rand(rng, kt, c_in, cfg.g1, scale=(kt * c_in) ** -0.5), rand(rng, cfg.g1, scale=0.1),
         rand(rng, c0, c1, scale=c0 ** -0.5), rand(rng, c1, scale=0.1))
    d = Drop(0.5, 2024, 1) if drop else None
    got = tvf.head_fwd(cfg, t(x), *(map(t, ln) if apply_ln else [None] * 4), *map(t, w),
                       drop=d).numpy()
    mask = None if d is None else keep_mask(d, x.shape, cfg.v_true).numpy()
    ref = np.asarray(jvf.head_reference(jcfg, jnp.asarray(x),
                                        [jnp.asarray(a) for a in ln] if apply_ln else None,
                                        [jnp.asarray(a) for a in w], mask))
    assert got.shape == (batch, cfg.t1, c1, v_pad)
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("gct,ks,act", GATE_CASES)
def test_tail_plain_matches_jax_kernel(gct, ks, act):
    jcfg, cfg = _cfgs(gct, ks, act, True)
    xg, ta, tb, w = _tail_inputs(cfg, seed=12)
    got = tvf.tail_fwd(cfg, t(xg), t(ta), t(tb), *map(t, w))
    j = [jnp.asarray(a) for a in (xg, ta, tb, *w)]
    kern = jvf.tail_fused(jcfg, jnp.int32(V_TRUE), *j)
    ref = jvf.tail_reference(jcfg, j[0], [j[1], j[2]][: jcfg.n_terms], tuple(j[3:]))
    for g, k, r in zip(got, kern, ref):
        # ps / pss are sums of V_TRUE * c2 terms: the bound scales with them
        atol = ATOL * max(1.0, float(np.abs(np.asarray(r)).max()))
        np.testing.assert_allclose(g.numpy(), np.asarray(k), atol=atol)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=atol)
    assert got[1].shape == (B, cfg.t2, 1, 1)


@pytest.mark.parametrize("act,gct,ks,c1,c2,kt,t1,batch,v_pad", TAIL_EDGES)
def test_tail_plain_at_tile_edges_matches_jax(act, gct, ks, c1, c2, kt, t1, batch, v_pad):
    """K2f's plain version against the JAX ``tail_reference`` at the edge
    shapes of its ring walk, where the card tests hold the kernel to the
    plain version: a2 within 2e-5, ps / pss (sums over c2 channels and the
    true lanes) within 2e-5 of their magnitude."""
    kw = dict(kt=kt, ks=ks, act_func=act, graph_conv_type=gct, v_true=v_true_of(v_pad),
              v_pad=v_pad, t_in=t1 + kt - 1, c_in=c1, c0=c1, c1=c1, c2=c2, apply_ln=False)
    jcfg = jvf.VertexBlockCfg(droprate=0.5, tile_v=128, training=False, **kw)
    cfg = tvf.VertexBlockCfg(**kw)
    rng = np.random.default_rng(15)
    xg, ta, tb = (rand(rng, batch, t1, c1, v_pad) for _ in range(3))
    n_c = cfg.n_terms + (gct == "cheb_graph_conv")
    w = (rand(rng, n_c, c1, c1, scale=(n_c * c1) ** -0.5), rand(rng, c1, scale=0.1),
         rand(rng, kt, c1, cfg.g2, scale=(kt * c1) ** -0.5), rand(rng, cfg.g2, scale=0.1))
    got = tvf.tail_fwd(cfg, t(xg), t(ta), t(tb), *map(t, w))
    j = [jnp.asarray(a) for a in (xg, ta, tb, *w)]
    ref = jvf.tail_reference(jcfg, j[0], [j[1], j[2]][: jcfg.n_terms], tuple(j[3:]))
    assert got[0].shape == (batch, cfg.t2, c2, v_pad) and got[1].shape == (batch, cfg.t2, 1, 1)
    for g, r in zip(got, ref):
        atol = ATOL * max(1.0, float(np.abs(np.asarray(r)).max()))
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=atol)


def test_tail_masks_padded_lanes():
    """Lanes v >= v_true hold garbage in the real path: they must stay out of
    the LayerNorm partials (`vertex_fused.py:485`)."""
    _, cfg = _cfgs("cheb_graph_conv", 3, "glu", True)
    xg, ta, tb, w = _tail_inputs(cfg, seed=13)
    a2, ps, pss = tvf.tail_fwd(cfg, t(xg), t(ta), t(tb), *map(t, w))
    live = a2[..., :V_TRUE]
    torch.testing.assert_close(ps, live.sum((2, 3), keepdim=True), rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(pss, (live ** 2).sum((2, 3), keepdim=True), rtol=1e-5,
                               atol=1e-4)
    assert float(a2[..., V_TRUE:].abs().max()) > 0   # padded lanes are not zero


def test_bf16_variant_raises():
    """K1f's bf16 variant runs forward (``tests/test_torch_fused_bf16.py``
    holds it to the JAX package); its backward, K1b in bf16, is not ported
    yet and raises rather than casting to float32."""
    _, cfg = _cfgs("cheb_graph_conv", 3, "glu", False)
    x, _, w = _head_inputs(cfg, seed=1)
    x16 = t(x).bfloat16().requires_grad_()
    w16 = (t(w[0]).bfloat16(), t(w[1]), t(w[2]).bfloat16(), t(w[3]))
    y = tvf.head_fused(dataclasses.replace(cfg, precision="bfloat16"), x16, None, None, None,
                       None, *w16)
    assert y.dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="bf16"):
        y.float().sum().backward()
