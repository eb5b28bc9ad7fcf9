"""Plain versions of K1 (head) and K2 (tail) against the JAX package's
vertex-fused kernels in Pallas interpret mode and their ``*_reference``
oracles; the CUDA kernels against the plain versions on a card."""


import jax.numpy as jnp
import numpy as np
import pytest

from stgcn_tpu.kernels import vertex_fused as jvf
from stgcn_tpu_torch.kernels import vertex_fused as tvf
from stgcn_tpu_torch.kernels.dropout import Drop, keep_mask
from tests.gate_gemm_edges import HEAD_EDGES, v_true_of
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
