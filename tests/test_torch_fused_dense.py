"""The port's dense whole-block route, ``nn.fused.fused_forward`` (K12f / K12b:
their plain versions on CPU tensors), against the JAX package's
``fused_forward`` (reference path and Pallas interpret mode) and
``model.apply``, and against the port's unfused ``STGCN``: forward and
gradients at both output heads, dropout on with the unfused model's masks,
and a 3-step AdamW trajectory."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgcn_tpu.nn.fused import fused_forward as jax_fused_forward
from stgcn_tpu.nn.model import STGCN as JaxSTGCN
from stgcn_tpu.ops.graph_op import DenseGraphOp as JaxDenseGraphOp
from stgcn_tpu_torch import kernels
from stgcn_tpu_torch.kernels.dropout import step_seed
from stgcn_tpu_torch.nn import STGCN, fused_forward
from stgcn_tpu_torch.nn.convert import params_from_jax
from stgcn_tpu_torch.ops import DenseGraphOp
from stgcn_tpu_torch.train import masked_mse
from stgcn_tpu_torch.train.optim import adamw, apply_updates
from tests.torch_parity_utils import t, to_np

V, B = 24, 4
FWD_TOL = dict(atol=1e-4, rtol=1e-4)     # tests/test_fused.py:186-212
GRAD_TOL = dict(atol=1e-5, rtol=1e-3)    # tests/test_fused.py:202-212

# (n_his, Ks, act, graph conv): the main.py plan with its Ko=4 'TNFF' head;
# the Ko=0 plan's inline fc head; Ks=4 and a first-order gtu model
PLANS = [(12, 3, "glu", "cheb_graph_conv"), (8, 3, "glu", "cheb_graph_conv"),
         (12, 4, "relu", "cheb_graph_conv"), (12, 3, "gtu", "graph_conv")]


def _setup(n_his, ks, act, gct):
    rng = np.random.default_rng(0)
    gso = (rng.standard_normal((V, V)) * 0.1).astype(np.float32)
    x = rng.standard_normal((B, n_his, V, 1)).astype(np.float32)
    jm = JaxSTGCN(n_his=n_his, ks=ks, act_func=act, graph_conv_type=gct)
    jop = JaxDenseGraphOp(matrix=jnp.asarray(gso))
    jp = to_np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jop, deterministic=True)["params"])
    tm = STGCN(n_his, V, ks=ks, act_func=act, graph_conv_type=gct, device="cpu")
    tm.load_state_dict(params_from_jax(jp))
    return gso, x, jm, jop, jp, tm, DenseGraphOp(matrix=t(gso))


@pytest.mark.parametrize("plan", PLANS)
def test_fused_forward_matches_jax_and_unfused(plan):
    gso, x, jm, jop, jp, tm, top = _setup(*plan)
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = fused_forward(tm.state_dict(), t(x), top, tm).numpy()
        unfused = tm(t(x), top).numpy()
    assert not any(kernels.launch_counts().values())   # CPU tensors: the plain versions
    ref = np.asarray(jax.jit(lambda p, xx: jax_fused_forward(
        p, xx, jop, jm, deterministic=True, use_pallas=False))(jp, jnp.asarray(x)))
    ref_apply = np.asarray(jax.jit(lambda p, xx: jm.apply(
        {"params": p}, xx, jop, deterministic=True))(jp, jnp.asarray(x)))
    assert got.shape == ref.shape == ref_apply.shape == unfused.shape
    for other in (ref, ref_apply, unfused):
        np.testing.assert_allclose(got, other, **FWD_TOL)


def test_fused_forward_matches_jax_kernel():
    """Against the JAX route through the TPU kernel K12 in interpret mode."""
    gso, x, jm, jop, jp, tm, top = _setup(*PLANS[0])
    with torch.no_grad():
        got = fused_forward(tm.state_dict(), t(x), top, tm).numpy()
    ref = np.asarray(jax_fused_forward(jp, jnp.asarray(x), jop, jm, deterministic=True,
                                       use_pallas=True, interpret=True))
    np.testing.assert_allclose(got, ref, **FWD_TOL)


@pytest.mark.parametrize("plan", PLANS)
def test_fused_gradients_match_jax_and_unfused(plan):
    """``jax.grad`` of a mean-square loss through the JAX model (what the JAX
    package's own fused route is held to, ``tests/test_fused.py:202-212``),
    and the port's unfused model's gradients; no gradient reaches the GSO."""
    gso, x, jm, jop, jp, tm, top = _setup(*plan)

    def loss_j(p):
        return jnp.mean(jm.apply({"params": p}, jnp.asarray(x), jop, deterministic=True) ** 2)

    ref = params_from_jax(to_np(jax.jit(jax.grad(loss_j))(jp)))
    params = dict(tm.named_parameters())
    names = list(params)
    mat = t(gso).requires_grad_(True)
    y = fused_forward(params, t(x), DenseGraphOp(matrix=mat), tm)
    g = torch.autograd.grad((y ** 2).mean(), [params[k] for k in names] + [mat],
                            allow_unused=True)
    assert g[-1] is None
    g_unf = torch.autograd.grad((tm(t(x), top) ** 2).mean(), [params[k] for k in names])
    for k, a, b in zip(names, g, g_unf):
        np.testing.assert_allclose(a.numpy(), ref[k], err_msg=k, **GRAD_TOL)
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=k, **GRAD_TOL)


def test_dropout_sites_equal_unfused():
    """Training: block l drops at site l, the head's fc1 at site n_st_blocks,
    with the unfused model's masks; outputs and gradients agree."""
    gso, x, jm, jop, jp, tm, top = _setup(*PLANS[0])
    params = dict(tm.named_parameters())
    names = list(params)
    seed = step_seed(42, 5)

    def run(fn):
        y = fn()
        return y, torch.autograd.grad((y * torch.cos(y)).sum(), [params[k] for k in names])

    yf, gf = run(lambda: fused_forward(params, t(x), top, tm, deterministic=False, seed=seed))
    yu, gu = run(lambda: tm(t(x), top, deterministic=False, seed=seed))
    np.testing.assert_allclose(yf.detach().numpy(), yu.detach().numpy(), atol=1e-5, rtol=1e-5)
    for k, a, b in zip(names, gf, gu):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, err_msg=k,
                                   atol=1e-5 * max(1.0, float(b.abs().max())))
    with torch.no_grad():   # dropout is on: the output differs from the deterministic one
        assert float((yf - fused_forward(params, t(x), top, tm)).abs().max()) > 1e-3


def test_adamw_trajectory_equals_unfused():
    """Three AdamW steps (lr 1e-3, weight decay 1e-3) through fused_forward and
    through the unfused model from the same weights, dropout on with the same
    masks: the losses and the weights stay together."""
    gso, x, jm, jop, jp, tm, top = _setup(*PLANS[0])
    y = t(np.random.default_rng(3).standard_normal((B, V)))
    runs = {}
    for fused in (True, False):
        params = {k: v.detach().clone().requires_grad_(True) for k, v in tm.named_parameters()}
        tx = adamw(1e-3, weight_decay=1e-3)
        state, losses = tx.init(params), []
        for step in range(3):
            seed = step_seed(42, step)
            pred = (fused_forward(params, t(x), top, tm, deterministic=False, seed=seed)
                    if fused else torch.func.functional_call(
                        tm, params, (t(x), top), {"deterministic": False, "seed": seed}))
            loss = masked_mse(pred.reshape(B, -1), y, B)
            grads = torch.autograd.grad(loss, list(params.values()))
            updates, state = tx.update(dict(zip(params, grads)), state, params)
            apply_updates(params, updates)
            losses.append(float(loss.detach()))
        runs[fused] = (losses, params)
    np.testing.assert_allclose(runs[True][0], runs[False][0], atol=1e-5, rtol=1e-5)
    for k, p in runs[True][1].items():
        np.testing.assert_allclose(p.detach().numpy(), runs[False][1][k].detach().numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=k)


def test_fused_forward_refuses_what_it_does_not_take():
    gso, x, jm, jop, jp, tm, top = _setup(*PLANS[0])

    class SparseStandIn:
        v_pad = 128

    with pytest.raises(TypeError, match="dense graph operator"):
        fused_forward(tm.state_dict(), t(x), SparseStandIn(), tm)
    with pytest.raises(ValueError, match="seed"):
        fused_forward(tm.state_dict(), t(x), top, tm, deterministic=False)
