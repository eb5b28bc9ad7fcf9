"""More of ``tests/test_torch_fused_stblock.py``'s tests: each port test file holds at most
20 collected tests. Helpers, constants and fixtures come from there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgcn_tpu.kernels.fused_stblock import fused_st_block as jax_fused_st_block
from stgcn_tpu_torch.kernels import dropout as D
from stgcn_tpu_torch.kernels import fused_stblock as fs
from stgcn_tpu_torch.nn.convert import params_from_jax
from stgcn_tpu_torch.nn.layers import STConvBlock
from stgcn_tpu_torch.ops import DenseGraphOp
from tests.torch_parity_utils import t
from tests.test_torch_fused_stblock import (
    B,
    CASES,
    FWD_TOL,
    GRAD_TOL,
    KT,
    T,
    V,
    _kw,
    _loss_grads_jax,
    _loss_grads_port,
    _setup,
)


@pytest.mark.parametrize("act,gct,ks,c_in", CASES)
def test_block_gradients_match_jax(act, gct, ks, c_in):
    """K12b's plain version (autograd through the forward's) against
    ``jax.grad`` through the JAX block's reference path; no gradient reaches
    the GSO, as in JAX."""
    gso, x, jp, tp = _setup(act, gct, ks, c_in)
    g_gso, gp, gx = _loss_grads_port(x, gso, tp, act, gct, ks)
    ref_p, ref_x = _loss_grads_jax(x, gso, jp, act, gct, ks, use_pallas=False)
    assert g_gso is None
    np.testing.assert_allclose(gx.numpy(), ref_x, **GRAD_TOL)
    assert set(gp) == set(ref_p)
    for k, v in gp.items():
        np.testing.assert_allclose(v.numpy(), ref_p[k], err_msg=k, **GRAD_TOL)


def test_layernorm_of_a_large_mean_matches_jax():
    """The block where every a2 row has |mean| / std >= 1e3, through the
    port's plain version against the JAX block's reference path: both take
    the LayerNorm's variance in two passes, the mean square deviation from
    the mean, where Σa²/n − mu² loses it in f32 (shown below). a2 holds
    exact f32 values on a grid of 1/4 around 1024 (gcb = −100 turns h to 0,
    so a2 = relu(c2b)), and a row holds 2048 of them (V = 32, c2 = 64), so
    its sum and mean are exact in any order: a deviation comes from the
    statistics, not from two orders of summing a2. The card's K12f is held
    to the same block in tests/test_torch_kernels_cuda.py."""
    v, kw = 32, _kw("relu", "cheb_graph_conv", 3)
    gso, x, jp, _ = _setup("relu", "cheb_graph_conv", 3, 1, v=v)
    c2b = 1024.0 + np.random.default_rng(8).integers(-4, 5, 64) / 4.0
    jp["graph_conv"]["cheb_graph_conv"]["bias"] = np.full(16, -100.0, np.float32)
    jp["tmp_conv2"]["causal_conv"]["bias"] = c2b.astype(np.float32)
    tp = params_from_jax(jp)
    with torch.no_grad():
        got = fs.fused_st_block(t(x), t(gso), tp, deterministic=True, site=0, **kw).numpy()
        w = fs.block_weights(tp, "cheb_graph_conv")
        cfg = fs.FusedBlockConfig(kt=KT, ks=3, act_func="relu",
                                  graph_conv_type="cheb_graph_conv", droprate=0.5, v_true=v,
                                  t_in=T, c_in=1, c0=64, c1=16, c2=64, training=False)
        assert not bool(fs.relu_input(cfg, t(x), t(gso), w).gt(0).any())   # h = 0
    a2 = np.broadcast_to(c2b.astype(np.float32), (v, 64)).reshape(-1)
    assert abs(a2.astype(np.float64).mean()) >= 1e3 * a2.astype(np.float64).std()
    sq = np.cumsum(a2 * a2, dtype=np.float32)[-1] / np.float32(a2.size)
    one_pass = float(sq - np.float32(a2.mean(dtype=np.float32)) ** 2)
    assert abs(one_pass / a2.astype(np.float64).var() - 1.0) > 0.1
    ref = np.asarray(jax.jit(lambda xx, g, p: jax_fused_st_block(
        xx, g, p, deterministic=True, use_pallas=False, **kw))(jnp.asarray(x), jnp.asarray(gso),
                                                                jp))
    assert got.shape == ref.shape == (B, T - 2 * (KT - 1), v, 64)
    np.testing.assert_allclose(got, ref, **FWD_TOL)


@pytest.mark.parametrize("act,gct,ks", [("glu", "cheb_graph_conv", 3),
                                        ("gtu", "graph_conv", 3)])
def test_block_gradients_match_jax_kernel(act, gct, ks):
    """Against ``jax.grad`` through the TPU kernels in interpret mode (K12b
    ``_bwd_pallas``), the tolerance of the JAX package's own kernel test
    (``tests/test_fused.py:99-101``)."""
    gso, x, jp, tp = _setup(act, gct, ks, 1)
    _, gp, gx = _loss_grads_port(x, gso, tp, act, gct, ks, "sum")
    ref_p, ref_x = _loss_grads_jax(x, gso, jp, act, gct, ks, "sum", use_pallas=True,
                                   interpret=True)
    np.testing.assert_allclose(gx.numpy(), ref_x, atol=1e-4, rtol=1e-3)
    for k, v in gp.items():
        np.testing.assert_allclose(v.numpy(), ref_p[k], atol=1e-4, rtol=1e-3, err_msg=k)


@pytest.mark.parametrize("act,gct,ks", [("glu", "cheb_graph_conv", 3),
                                        ("silu", "cheb_graph_conv", 4),
                                        ("relu", "graph_conv", 3)])
def test_dropout_equals_unfused_block(act, gct, ks):
    """Training mode drops what the port's unfused ``STConvBlock`` drops at the
    same (seed, site): the outputs and the gradients agree."""
    gso, x, _, tp = _setup(act, gct, ks, 1)
    blk = STConvBlock(KT, ks, V, 1, (64, 16, 64), act, gct, device="cpu")
    blk.load_state_dict(tp)
    drop = D.Drop(0.5, D.step_seed(42, 9), 1)
    xx = t(x).requires_grad_(True)
    y_unf = blk(xx, DenseGraphOp(matrix=t(gso)), drop)
    params = dict(blk.named_parameters())
    y_fus = fs.fused_st_block(xx, t(gso), params, deterministic=False, seed=drop.seed, site=1,
                              **_kw(act, gct, ks))
    np.testing.assert_allclose(y_fus.detach().numpy(), y_unf.detach().numpy(), atol=1e-6,
                               rtol=1e-6)
    assert torch.equal(y_fus == 0, y_unf == 0)
    gy = t(np.random.default_rng(4).standard_normal(y_fus.shape))
    ins = [xx, *params.values()]
    g_fus = torch.autograd.grad(y_fus, ins, gy)
    g_unf = torch.autograd.grad(y_unf, ins, gy)
    for a, b in zip(g_fus, g_unf):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(b.abs().max())))
