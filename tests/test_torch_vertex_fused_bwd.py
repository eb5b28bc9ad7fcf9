"""Plain versions of K1b (head backward) and K2b (tail backward) against the
JAX package's ``_head_pallas_bwd`` / ``_tail_pallas_bwd`` in Pallas interpret
mode (through ``jax.vjp`` of ``head_fused`` / ``tail_fused``, droprate 0), and
with dropout through ``jax.vjp`` of ``head_reference`` fed the port's mask
(the interpret mode's PRNG stub returns zero bits). Then the port's fused
gradients against its unfused ones with dropout on."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stgcn_tpu.kernels import vertex_fused as jvf
from stgcn_tpu_torch.kernels import dropout as D
from stgcn_tpu_torch.kernels import vertex_fused as tvf
from tests.torch_parity_utils import B, GATE_CASES, assert_grads, rand, t
from tests.test_torch_vertex_fused import _cfgs, _head_inputs, _tail_inputs

ATOL = 2e-5   # scaled by max(1, |ref|) per gradient: assert_grads
DROP = D.Drop(0.5, D.step_seed(42, 3), 0)


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("apply_ln", [False, True])
@pytest.mark.parametrize("gct,ks,act", GATE_CASES)
def test_head_bwd_plain_matches_jax_kernel(gct, ks, act, apply_ln):
    jcfg, cfg = _cfgs(gct, ks, act, apply_ln)
    x, ln, w = _head_inputs(cfg, seed=21)
    gy = rand(np.random.default_rng(22), B, cfg.t1, cfg.c1, cfg.v_pad)
    got = tvf.head_bwd(cfg, t(x), *(map(t, ln) if apply_ln else [None] * 4), *map(t, w), t(gy))
    args = _j([x, *ln, *w])
    _, vjp = jax.vjp(lambda *a: jvf.head_fused(jcfg, 0, *a), *args)
    ref = vjp(jnp.asarray(gy))
    keep = [0, 1, 2, 3, 4] if apply_ln else [0]
    assert_grads([got[i].numpy() for i in keep] + [g.numpy() for g in got[5:]],
                  [ref[i] for i in keep] + list(ref[5:]))
    if not apply_ln:
        assert got[1:5] == (None,) * 4


@pytest.mark.parametrize("gct,ks,act", GATE_CASES)
def test_head_bwd_with_dropout_matches_jax_reference(gct, ks, act):
    """The port's mask fed to the JAX oracle ``head_reference(..., drop_mask)``."""
    jcfg, cfg = _cfgs(gct, ks, act, True)
    x, ln, w = _head_inputs(cfg, seed=23)
    gy = rand(np.random.default_rng(24), B, cfg.t1, cfg.c1, cfg.v_pad)
    mask = D.keep_mask(DROP, x.shape, cfg.v_true).numpy()
    got = tvf.head_bwd(cfg, t(x), *map(t, ln), *map(t, w), t(gy), drop=DROP)
    fwd = tvf.head_fwd(cfg, t(x), *map(t, ln), *map(t, w), drop=DROP)

    def f(x_, mu, rstd, lng, lnb, *w_):
        return jvf.head_reference(jcfg, x_, (mu, rstd, lng, lnb), w_, jnp.asarray(mask))

    y, vjp = jax.vjp(f, *_j([x, *ln, *w]))
    np.testing.assert_allclose(fwd.numpy(), np.asarray(y), atol=ATOL)
    assert_grads([g.numpy() for g in got], vjp(jnp.asarray(gy)))


@pytest.mark.parametrize("batch,c_in,apply_ln", [(1, 1, False), (2, 1, False), (1, 16, True)])
def test_head_bwd_plain_matches_jax_reference_at_edge_shapes(batch, c_in, apply_ln):
    """K1b's plain version against ``jax.vjp`` of the JAX ``head_reference``
    at the shapes where the card kernel cuts its work differently: block 1's
    (c_in 1, t_in 12, no LayerNorm; the JAX kernel floors c_in at 8), batch 1
    (B·t1 < 64: the weight gradients cut each step's lanes), V = 150 of 256
    lanes with nonzero inputs and cotangents on the padded lanes."""
    _, cfg0 = _cfgs("cheb_graph_conv", 3, "glu", apply_ln)
    jcfg0, _ = _cfgs("cheb_graph_conv", 3, "glu", apply_ln)
    cfg = dataclasses.replace(cfg0, c_in=c_in)
    jcfg = dataclasses.replace(jcfg0, c_in=c_in)
    rng = np.random.default_rng(25)
    x = rand(rng, batch, cfg.t_in, c_in, cfg.v_pad)
    ln = (rand(rng, batch, cfg.t_in, 1, 1, scale=0.1),
          (0.5 + rng.random((batch, cfg.t_in, 1, 1))).astype(np.float32),
          1.0 + rand(rng, c_in, cfg.v_pad, scale=0.1), rand(rng, c_in, cfg.v_pad))
    for a in ln[2:]:
        a[:, cfg.v_true:] = 0.0
    w = (rand(rng, cfg.kt, c_in, cfg.g1, scale=0.2), rand(rng, cfg.g1, scale=0.1),
         rand(rng, cfg.c0, cfg.c1, scale=0.2), rand(rng, cfg.c1, scale=0.1))
    gy = rand(rng, batch, cfg.t1, cfg.c1, cfg.v_pad)
    got = tvf.head_bwd(cfg, t(x), *(map(t, ln) if apply_ln else [None] * 4), *map(t, w), t(gy))
    if apply_ln:
        y, vjp = jax.vjp(lambda x_, mu, rs, g_, b_, *w_: jvf.head_reference(
            jcfg, x_, (mu, rs, g_, b_), w_), *_j([x, *ln, *w]))
        assert_grads([g.numpy() for g in got], vjp(jnp.asarray(gy)))
    else:
        y, vjp = jax.vjp(lambda x_, *w_: jvf.head_reference(jcfg, x_, None, w_), *_j([x, *w]))
        assert got[1:5] == (None,) * 4
        assert_grads([got[0].numpy()] + [g.numpy() for g in got[5:]], vjp(jnp.asarray(gy)))


@pytest.mark.parametrize("gct,ks,act", GATE_CASES)
def test_tail_bwd_plain_matches_jax_kernel(gct, ks, act):
    jcfg, cfg = _cfgs(gct, ks, act, True)
    xg, ta, tb, w = _tail_inputs(cfg, seed=25)
    rng = np.random.default_rng(26)
    ga2 = rand(rng, B, cfg.t2, cfg.c2, cfg.v_pad)
    gps, gpss = rand(rng, B, cfg.t2, 1, 1, scale=1e-2), rand(rng, B, cfg.t2, 1, 1, scale=1e-2)
    got = tvf.tail_bwd(cfg, t(xg), t(ta), t(tb), *map(t, w), t(ga2), t(gps), t(gpss))
    _, vjp = jax.vjp(lambda *a: jvf.tail_fused(jcfg, jnp.int32(cfg.v_true), *a),
                     *_j([xg, ta, tb, *w]))
    ref = vjp(tuple(_j([ga2, gps, gpss])))
    assert_grads([g.numpy() for g in got], ref)
