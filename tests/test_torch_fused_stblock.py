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
from stgcn_tpu_torch.kernels import fused_stblock as fs
from stgcn_tpu_torch.nn.convert import params_from_jax
from tests.torch_parity_utils import t, to_np

V, B, T, KT = 24, 5, 12, 3      # V not a multiple of the TPU's 16-row padding
FWD_TOL = dict(atol=1e-4, rtol=1e-4)     # tests/test_fused.py:38-45
GRAD_TOL = dict(atol=1e-5, rtol=1e-3)    # tests/test_fused.py:156-183

# every gate x both graph convs at Ks=3; Ks 1, 2 and 4; an input narrower than c0
CASES = [(act, gct, 3, 1) for act in ("glu", "gtu", "relu", "silu")
         for gct in ("cheb_graph_conv", "graph_conv")]
CASES += [("glu", "cheb_graph_conv", ks, 1) for ks in (1, 2, 4)]
CASES += [("gtu", "cheb_graph_conv", 3, 8)]


def _setup(act, gct, ks, c_in, seed=1, v=V):
    rng = np.random.default_rng(0)
    gso = (rng.standard_normal((v, v)) * 0.1).astype(np.float32)
    x = rng.standard_normal((B, T, v, c_in)).astype(np.float32)
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
