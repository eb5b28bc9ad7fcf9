"""More of ``tests/test_torch_vertex_fused_bwd.py``'s tests: each port test file holds at most
20 collected tests. Helpers, constants and fixtures come from there."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from stgcn_tpu.kernels import vertex_fused as jvf
from stgcn_tpu_torch.kernels import dropout as D
from stgcn_tpu_torch.kernels import vertex_fused as tvf
from stgcn_tpu_torch.nn.fused_sparse import fused_sparse_forward
from tests.torch_parity_utils import B, GATE_CASES, assert_grads, rand, setup_model, t
from tests.test_torch_vertex_fused import _cfgs, _head_inputs, _tail_inputs
from tests.test_torch_vertex_fused_bwd import (
    _j,
)


@pytest.mark.parametrize("batch,t_in,gct,ks,act,c2", [
    (1, 8, "cheb_graph_conv", 3, "glu", 16),   # batch 1
    (2, 5, "cheb_graph_conv", 3, "relu", 16),  # t2 = 1 (t1 = kt)
    (2, 8, "cheb_graph_conv", 3, "gtu", 40),   # c2 ragged against a 64-channel pass
    (2, 8, "graph_conv", 3, "silu", 16),       # one graph term, no T_0
    (1, 8, "cheb_graph_conv", 2, "glu", 16),   # Chebyshev with one term besides T_0
])
def test_tail_bwd_plain_matches_jax_reference_at_edge_shapes(batch, t_in, gct, ks, act, c2):
    """K2b's plain version against ``jax.vjp`` of the JAX ``tail_reference``
    at the shapes where the card kernel cuts its work differently: batch 1,
    one output step of the gate (t2 = 1), 40 gate channels in a 64-channel
    pass, one graph term (``graph_conv``, Chebyshev Ks = 2: the unused term's
    gradient is zero), V = 150 of 256 lanes with nonzero inputs and
    cotangents on the padded lanes."""
    jcfg0, cfg0 = _cfgs(gct, ks, act, True)
    jcfg = dataclasses.replace(jcfg0, t_in=t_in, c2=c2)
    cfg = dataclasses.replace(cfg0, t_in=t_in, c2=c2)
    rng = np.random.default_rng(27)
    xg, ta, tb = (rand(rng, batch, cfg.t1, cfg.c1, cfg.v_pad) for _ in range(3))
    n_c = cfg.n_terms + (gct == "cheb_graph_conv")
    w = (rand(rng, n_c, cfg.c1, cfg.c1, scale=0.2), rand(rng, cfg.c1, scale=0.1),
         rand(rng, cfg.kt, cfg.c1, cfg.g2, scale=0.2), rand(rng, cfg.g2, scale=0.1))
    ga2 = rand(rng, batch, cfg.t2, c2, cfg.v_pad)
    gps, gpss = (rand(rng, batch, cfg.t2, 1, 1, scale=1e-2) for _ in range(2))
    assert float(np.abs(ga2[..., cfg.v_true:]).max()) > 0
    got = tvf.tail_bwd(cfg, t(xg), t(ta), t(tb), *map(t, w), t(ga2), t(gps), t(gpss))
    n = cfg.n_terms
    terms = [ta, tb][:n]
    _, vjp = jax.vjp(lambda x_, *r: jvf.tail_reference(jcfg, x_, list(r[:n]), tuple(r[n:])),
                     *_j([xg, *terms, *w]))
    ref = vjp(tuple(_j([ga2, gps, gpss])))
    assert_grads([got[0].numpy(), *(g.numpy() for g in got[1:1 + n]),
                  *(g.numpy() for g in got[3:])], ref)
    if n == 1:
        assert not bool(got[2].any())


def test_tail_bwd_plain_takes_given_relu_decisions():
    """The ``relu_mask`` of the plain version (the card check's way to hold it
    to a kernel's ReLU decisions): its own decisions give the default result
    (to f32 rounding: autograd may sum the bias gradient in another order);
    one unit's flipped decision moves the data gradient at its own (b, t, v)
    and nowhere outside its vertex v of batch b (the gate's temporal conv
    spreads it over t)."""
    _, cfg = _cfgs("cheb_graph_conv", 3, "glu", True)
    xg, ta, tb, w = _tail_inputs(cfg, seed=25)
    rng = np.random.default_rng(26)
    cot = (t(rand(rng, B, cfg.t2, cfg.c2, cfg.v_pad)), t(rand(rng, B, cfg.t2, 1, 1)),
           t(rand(rng, B, cfg.t2, 1, 1)))
    args = (cfg, t(xg), [t(ta), t(tb)][: cfg.n_terms], tuple(map(t, w)), *cot)
    own = (tvf.tail_preact(*args[:4]) > 0).float()
    ref = tvf.tail_bwd_reference(*args)
    same = tvf.tail_bwd_reference(*args, relu_mask=own)
    for a, b in zip([ref[0], *ref[1], *ref[2:]], [same[0], *same[1], *same[2:]]):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-6 * float(a.abs().max()))
    own[1, 2, 3, 40] = 1.0 - own[1, 2, 3, 40]
    moved = (tvf.tail_bwd_reference(*args, relu_mask=own)[0] != same[0]).any(2)
    assert moved[1, 2, 40] and int(moved.sum()) == int(moved[1, :, 40].sum())


@pytest.mark.parametrize("gct,ks,act", GATE_CASES)
def test_fused_gradients_match_unfused_with_dropout(gct, ks, act):
    """Same seed, same masks: the fused route's loss gradients (kernels' plain
    versions) within the JAX package's fused-vs-autodiff bound
    (``tests/test_vertex_fused.py:52-74``) of the unfused model's."""
    _, _, _, tm, top, x = setup_model(gct, ks, act)
    params = dict(tm.named_parameters())
    names = list(params)

    def grads(fn):
        y = fn()
        return torch.autograd.grad((y * torch.cos(y)).sum(), [params[k] for k in names])

    seed = D.step_seed(42, 5)
    gu = grads(lambda: tm(t(x), top, deterministic=False, seed=seed))
    gf = grads(lambda: fused_sparse_forward(params, t(x), top, tm, deterministic=False,
                                            seed=seed))
    fu, ff = torch.cat([g.flatten() for g in gu]), torch.cat([g.flatten() for g in gf])
    assert float((ff - fu).norm() / (fu.norm() + 1e-12)) < 1e-4
    for k, a, b in zip(names, gf, gu):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4, rtol=2e-3, err_msg=k)
    with torch.no_grad():   # dropout is on: the output differs from the deterministic one
        y_det = tm(t(x), top)
        y_tr = fused_sparse_forward(params, t(x), top, tm, deterministic=False, seed=seed)
    assert float((y_tr - y_det).abs().max()) > 1e-3


def test_training_needs_a_seed():
    _, _, _, tm, top, x = setup_model()
    with pytest.raises(ValueError, match="seed"):
        tm(t(x), top, deterministic=False)
