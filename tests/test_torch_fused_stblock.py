"""The port's fused ST block (K12f / K12b: their plain versions on CPU tensors)
against the JAX package's ``fused_st_block``, in its reference path and in
Pallas interpret mode (the TPU kernels ``_fwd_pallas`` / ``_bwd_pallas``),
and against the port's unfused ``STConvBlock``. Same inputs from numpy seeds,
same weights (``nn.convert.params_from_jax``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgcn_tpu.kernels.fused_stblock import fused_st_block as jax_fused_st_block
from stgcn_tpu.nn.layers import STConvBlock as JaxSTConvBlock
from stgcn_tpu.ops.graph_op import DenseGraphOp as JaxDenseGraphOp
from stgcn_tpu_torch.kernels import dropout as D
from stgcn_tpu_torch.kernels import fused_stblock as fs
from stgcn_tpu_torch.nn.convert import params_from_jax
from stgcn_tpu_torch.nn.layers import STConvBlock
from stgcn_tpu_torch.ops import DenseGraphOp
from tests.torch_parity_utils import t, to_np

V, B, T, KT = 24, 5, 12, 3      # V not a multiple of the TPU's 16-row padding
FWD_TOL = dict(atol=1e-4, rtol=1e-4)     # tests/test_fused.py:38-45
GRAD_TOL = dict(atol=1e-5, rtol=1e-3)    # tests/test_fused.py:156-183

# every gate x both graph convs at Ks=3; Ks 1, 2 and 4; an input narrower than c0
CASES = [(act, gct, 3, 1) for act in ("glu", "gtu", "relu", "silu")
         for gct in ("cheb_graph_conv", "graph_conv")]
CASES += [("glu", "cheb_graph_conv", ks, 1) for ks in (1, 2, 4)]
CASES += [("gtu", "cheb_graph_conv", 3, 8)]


def _setup(act, gct, ks, c_in, seed=1):
    rng = np.random.default_rng(0)
    gso = (rng.standard_normal((V, V)) * 0.1).astype(np.float32)
    x = rng.standard_normal((B, T, V, c_in)).astype(np.float32)
    blk = JaxSTConvBlock(kt=KT, ks=ks, channels=(64, 16, 64), act_func=act,
                         graph_conv_type=gct, droprate=0.5)
    jp = to_np(blk.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                        JaxDenseGraphOp(matrix=jnp.asarray(gso)), deterministic=True)["params"])
    return gso, x, jp, params_from_jax(jp)


def _kw(act, gct, ks):
    return dict(kt=KT, ks=ks, act_func=act, graph_conv_type=gct, droprate=0.5)


def _jax_block(x, gso, jp, act, gct, ks, **kw):
    """The JAX block, jitted: one compile runs faster here than its eager ops."""
    fn = jax.jit(lambda xx, g, p: jax_fused_st_block(xx, g, p, deterministic=True,
                                                     **_kw(act, gct, ks), **kw))
    return fn(jnp.asarray(x), jnp.asarray(gso), jp)


@pytest.mark.parametrize("act,gct,ks,c_in", CASES)
def test_block_forward_matches_jax(act, gct, ks, c_in):
    gso, x, jp, tp = _setup(act, gct, ks, c_in)
    with torch.no_grad():
        got = fs.fused_st_block(t(x), t(gso), tp, deterministic=True, site=0,
                                **_kw(act, gct, ks)).numpy()
    ref = np.asarray(_jax_block(x, gso, jp, act, gct, ks, use_pallas=False))
    pal = np.asarray(_jax_block(x, gso, jp, act, gct, ks, use_pallas=True, interpret=True))
    assert got.shape == ref.shape == (B, T - 2 * (KT - 1), V, 64)
    np.testing.assert_allclose(got, ref, **FWD_TOL)
    np.testing.assert_allclose(got, pal, **FWD_TOL)


# the losses: a mean, whose gradients are on the scale of GRAD_TOL's atol (the
# full model's in tests/test_fused.py:168-183), and the kernel test's sum
LOSSES = {"mean": (jnp.mean, torch.mean), "sum": (jnp.sum, torch.sum)}


def _loss_grads_jax(x, gso, jp, act, gct, ks, reduce="mean", **kw):
    def loss(p, xx):
        y = _jax_block(xx, gso, p, act, gct, ks, **kw)
        return LOSSES[reduce][0](y * jnp.cos(y))
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp, jnp.asarray(x))
    return params_from_jax(to_np(gp)), np.asarray(gx)


def _loss_grads_port(x, gso, tp, act, gct, ks, reduce="mean"):
    p = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xx, g = t(x).requires_grad_(True), t(gso).requires_grad_(True)
    y = fs.fused_st_block(xx, g, p, deterministic=True, site=0, **_kw(act, gct, ks))
    grads = torch.autograd.grad(LOSSES[reduce][1](y * torch.cos(y)), [xx, g, *p.values()],
                                allow_unused=True)
    return grads[1], dict(zip(p, grads[2:])), grads[0]


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
