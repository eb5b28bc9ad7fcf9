"""More of ``tests/test_torch_fused_stblock.py``'s tests: each port test file holds at most
20 collected tests. Helpers, constants and fixtures come from there."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgcn_tpu.kernels.fused_stblock import _ln_fwd as jax_ln_fwd
from stgcn_tpu.kernels.fused_stblock import fused_st_block as jax_fused_st_block
from stgcn_tpu_torch.kernels import fused_stblock as fs
from tests.torch_parity_utils import t
from tests.test_torch_fused_stblock import (
    B,
    KT,
    T,
    V,
    _kw,
    _setup,
)


@pytest.mark.parametrize("v_pad", [V, 32])   # no padded lane; V = 24 of 32 lanes
@pytest.mark.parametrize("dropped", [False, True])
def test_ln_stats_cotangents_give_the_layernorm_vjp(dropped, v_pad):
    """K12b's LayerNorm backward as its kernels split it: the elementwise
    term rstd·lng·mask·gy (``ln_bwd``), and the chain through the
    statistics as gps + 2·gpss·a2 from ``ln_stats_cotangents`` (dmu =
    −rstd·Σ mask·gy·lng, drstd = Σ mask·gy·lng·(a2 − mu) over the row, lng
    zero past V as the kernel's affine is); on the true lanes their sum
    equals ``jax.vjp`` of the JAX block's LayerNorm (``_ln_fwd``) followed
    by the mask, though a2 and gy hold values on the padded lanes."""
    rng = np.random.default_rng(7)
    c2, t2 = 64, 3
    a2 = rng.standard_normal((B, t2, v_pad, c2)).astype(np.float32) * 0.7 + 0.2
    gy = rng.standard_normal((B, t2, v_pad, c2)).astype(np.float32)
    lng = (1.0 + 0.1 * rng.standard_normal((v_pad, c2))).astype(np.float32)
    lnb = (0.1 * rng.standard_normal((v_pad, c2))).astype(np.float32)
    lng[V:] = 0.0
    lnb[V:] = 0.0
    mask = np.ones((B, t2, v_pad, c2), np.float32)
    if dropped:
        mask = (rng.random(mask.shape) >= 0.5).astype(np.float32) * 2.0
    mask[:, :, V:] = 0.0
    vmask = (jnp.arange(v_pad) < V).astype(jnp.float32)[None, None, :, None]
    cfg = types.SimpleNamespace(v_true=V, c2=c2)

    def ln(a):
        y, _, _ = jax_ln_fwd(cfg, a, vmask, jnp.asarray(lng), jnp.asarray(lnb))
        return y * jnp.asarray(mask)

    _, mu, rstd = jax_ln_fwd(cfg, jnp.asarray(a2), vmask, jnp.asarray(lng), jnp.asarray(lnb))
    _, vjp = jax.vjp(ln, jnp.asarray(a2))
    ref = np.asarray(vjp(jnp.asarray(gy))[0])

    a, mu, rstd = t(a2), t(np.asarray(mu)), t(np.asarray(rstd))
    dxn = t(gy) * t(mask) * t(lng)
    dmu = -rstd * dxn.sum((2, 3), keepdim=True)
    drstd = (dxn * (a - mu)).sum((2, 3), keepdim=True)
    gps, gpss = fs.ln_stats_cotangents(mu, rstd, dmu, drstd, V * c2)
    got = (rstd * dxn + gps + 2.0 * gpss * a).numpy()
    assert gps.shape == gpss.shape == (B, t2, 1, 1)
    np.testing.assert_allclose(got[:, :, :V], ref[:, :, :V], rtol=0,
                               atol=2e-5 * max(1.0, float(np.abs(ref).max())))


def test_relu_out_holds_the_relu_output():
    """``relu_out`` receives the block's ReLU output ``h`` (on the card: the
    kernel's, whose signs are its ReLU decisions)."""
    gso, x, _, tp = _setup("glu", "cheb_graph_conv", 3, 1)
    w = fs.block_weights(tp, "cheb_graph_conv")
    cfg = fs.FusedBlockConfig(kt=KT, ks=3, act_func="glu", graph_conv_type="cheb_graph_conv",
                              droprate=0.5, v_true=V, t_in=T, c_in=1, c0=64, c1=16, c2=64,
                              training=False)
    h = torch.full((B, cfg.t1, V, cfg.c1), float("nan"))
    with torch.no_grad():
        y = fs.stblock_fwd(cfg, t(x), t(gso), *w, relu_out=h)
        r = fs.relu_input(cfg, t(x), t(gso), w)
    assert torch.equal(h, torch.relu(r)) and bool((h == 0).any()) and bool((h > 0).any())
    assert torch.equal(y, fs.st_block_reference(cfg, t(x), t(gso), w))


def test_dropout_keep_rate_as_jax():
    """Against JAX only the keep rate can be matched: its masks come from
    ``jax.random`` (the kernel's from the TPU's PRNG), the port's are keyed
    by element."""
    gso, x, jp, tp = _setup("glu", "cheb_graph_conv", 3, 1)
    with torch.no_grad():
        y = fs.fused_st_block(t(x), t(gso), tp, deterministic=False, seed=3, site=0,
                              **_kw("glu", "cheb_graph_conv", 3))
    y_jax = jax_fused_st_block(jnp.asarray(x), jnp.asarray(gso), jp, deterministic=False,
                               use_pallas=False, drop_rng=jax.random.PRNGKey(3),
                               **_kw("glu", "cheb_graph_conv", 3))
    for zeros in (float((y == 0).float().mean()), float(jnp.mean(y_jax == 0.0))):
        assert 0.4 < zeros < 0.6


def test_block_refuses_what_it_does_not_take():
    gso, x, _, tp = _setup("glu", "cheb_graph_conv", 3, 1)
    kw = _kw("glu", "cheb_graph_conv", 3)
    with pytest.raises(ValueError, match="seed"):
        fs.fused_st_block(t(x), t(gso), tp, deterministic=False, site=0, **kw)
    wide = t(np.random.default_rng(5).standard_normal((B, T, V, 80)))
    with pytest.raises(ValueError, match="c_in <= c0"):
        fs.fused_st_block(wide, t(gso), tp, deterministic=True, site=0, **kw)
    cfg = fs.FusedBlockConfig(kt=KT, ks=3, act_func="glu", graph_conv_type="cheb_graph_conv",
                              droprate=0.5, v_true=V, t_in=T, c_in=1, c0=64, c1=16, c2=64,
                              training=False, precision="bfloat16")
    w = fs.block_weights(tp, "cheb_graph_conv")
    with pytest.raises(NotImplementedError, match="bf16"):
        fs.stblock_fwd(cfg, t(x), t(gso), *w)
