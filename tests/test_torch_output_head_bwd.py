"""Plain versions of K3b (ohead backward) and K4b (ofc backward) against
``jax.vjp`` of the JAX package's kernel cores (``_ln_drop_fwd`` +
``_ohead_core`` / ``_ofc_core``) fed the port's dropout mask, and against
``ohead_fused`` / ``ofc_fused`` in Pallas interpret mode without dropout."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgcn_tpu.kernels import output_head as joh
from stgcn_tpu.kernels.vertex_fused import _bdot, _ln_drop_fwd
from stgcn_tpu_torch.kernels import dropout as D
from stgcn_tpu_torch.kernels import output_head as toh
from tests.test_torch_output_head import ACTS, V_PAD, V_TRUE, _affine, _cfgs, _j, _stats
from tests.torch_parity_utils import B, assert_grads, rand, t

DROPS = {"nodrop": None, "drop": D.Drop(0.5, D.step_seed(42, 9), 1)}


def _ohead_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    args = [rand(rng, B, cfg.ko, cfg.c_in, V_PAD), *_stats(rng, cfg.ko), *_affine(rng, cfg.c_in),
            rand(rng, cfg.ko, cfg.c_in, cfg.g, scale=0.2), rand(rng, cfg.g, scale=0.1)]
    cot = [rand(rng, B, 1, cfg.c0, V_PAD), rand(rng, B, 1, 1, 1, scale=1e-2),
           rand(rng, B, 1, 1, 1, scale=1e-2)]
    return args, cot


def _ofc_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    args = [rand(rng, B, 1, cfg.c0, V_PAD), *_stats(rng, 1), *_affine(rng, cfg.c0),
            rand(rng, cfg.c0, cfg.c1, scale=0.2), rand(rng, cfg.c1, scale=0.1),
            rand(rng, cfg.c1, cfg.c_end, scale=0.2), rand(rng, cfg.c_end, scale=0.1)]
    return args, rand(rng, B, 1, cfg.c_end, V_PAD)


def _mask(drop, shape):
    return None if drop is None else jnp.asarray(D.keep_mask(drop, shape, V_TRUE).numpy())


@pytest.mark.parametrize("drop", sorted(DROPS))
@pytest.mark.parametrize("act", ACTS)
def test_ohead_bwd_plain_matches_jax_core(act, drop):
    jcfg, cfg = _cfgs(act)
    args, cot = _ohead_inputs(cfg, seed=61)
    mask = _mask(DROPS[drop], args[0].shape)
    vm = (jnp.arange(V_PAD) < V_TRUE).astype(jnp.float32)

    def f(x, mu, rstd, lng, lnb, ck, cb):
        x4 = _ln_drop_fwd(jcfg, x, mu, rstd, lng, lnb, mask)
        _, _, a, _ = joh._ohead_core(jcfg, x4, ck, cb)
        am = a * vm
        return a, am.sum((2, 3), keepdims=True), (am * am).sum((2, 3), keepdims=True)

    outs, vjp = jax.vjp(f, *_j(args))
    fwd = toh.ohead_fwd(cfg, *map(t, args), drop=DROPS[drop])
    assert_grads([o.numpy() for o in fwd], outs)
    got = toh.ohead_bwd(cfg, *map(t, args), *map(t, cot), drop=DROPS[drop])
    assert_grads([g.numpy() for g in got], vjp(tuple(_j(cot))))


@pytest.mark.parametrize("batch,ko,c0,act,drop", [
    (1, 1, 32, "glu", "drop"),     # time already one step: one tap
    (1, 4, 40, "gtu", "nodrop"),   # 40 gate channels in a 64-channel pass, batch 1
    (2, 1, 40, "relu", "drop"),
])
def test_ohead_bwd_plain_matches_jax_core_at_edge_shapes(batch, ko, c0, act, drop):
    """K3b's plain version against ``jax.vjp`` of the JAX core where the card
    kernel cuts its work differently: ko = 1, c0 = 40 (ragged against a
    64-channel pass), batch 1; V = 150 of 256 lanes with nonzero inputs and
    a nonzero ``ga`` on the padded lanes, where the JAX kernel adds the
    LayerNorm-partial cotangents only on true lanes."""
    jcfg0, cfg0 = _cfgs(act)
    jcfg = dataclasses.replace(jcfg0, ko=ko, c0=c0, b_tile=batch)
    cfg = dataclasses.replace(cfg0, ko=ko, c0=c0)
    rng = np.random.default_rng(65)
    c_in = cfg.c_in
    lng, lnb = 1.0 + rand(rng, c_in, V_PAD, scale=0.1), rand(rng, c_in, V_PAD)
    lng[:, V_TRUE:] = 0.0
    lnb[:, V_TRUE:] = 0.0
    args = [rand(rng, batch, ko, c_in, V_PAD), rand(rng, batch, ko, 1, 1, scale=0.1),
            (0.5 + rng.random((batch, ko, 1, 1))).astype(np.float32), lng, lnb,
            rand(rng, ko, c_in, cfg.g, scale=0.2), rand(rng, cfg.g, scale=0.1)]
    cot = [rand(rng, batch, 1, c0, V_PAD), rand(rng, batch, 1, 1, 1, scale=1e-2),
           rand(rng, batch, 1, 1, 1, scale=1e-2)]
    assert float(np.abs(cot[0][..., V_TRUE:]).max()) > 0
    mask = _mask(DROPS[drop], args[0].shape)
    vm = (jnp.arange(V_PAD) < V_TRUE).astype(jnp.float32)

    def f(x, mu, rstd, lng_, lnb_, ck, cb):
        x4 = _ln_drop_fwd(jcfg, x, mu, rstd, lng_, lnb_, mask)
        _, _, a, _ = joh._ohead_core(jcfg, x4, ck, cb)
        am = a * vm
        return a, am.sum((2, 3), keepdims=True), (am * am).sum((2, 3), keepdims=True)

    _, vjp = jax.vjp(f, *_j(args))
    got = toh.ohead_bwd(cfg, *map(t, args), *map(t, cot), drop=DROPS[drop])
    assert_grads([g.numpy() for g in got], vjp(tuple(_j(cot))))


@pytest.mark.parametrize("drop", sorted(DROPS))
@pytest.mark.parametrize("act", ACTS[:2])
def test_ofc_bwd_plain_matches_jax_core(act, drop):
    jcfg, cfg = _cfgs(act)
    args, gout = _ofc_inputs(cfg, seed=62)
    mask = _mask(DROPS[drop], (B, 1, cfg.c1, V_PAD))

    def f(a, mu, rstd, lnw, lnb, w1, b1, w2, b2):
        h = _ln_drop_fwd(jcfg, a, mu, rstd, lnw, lnb, None)
        _, z = joh._ofc_core(jcfg, h, w1, b1)
        if mask is not None:
            z = z * mask
        return _bdot(z, w2, None) + b2[:, None]

    out, vjp = jax.vjp(f, *_j(args))
    fwd = toh.ofc_fwd(cfg, *map(t, args), drop=DROPS[drop])
    assert_grads([fwd.numpy()], [out])
    got = toh.ofc_bwd(cfg, *map(t, args), t(gout), drop=DROPS[drop])
    assert_grads([g.numpy() for g in got], vjp(jnp.asarray(gout)))


@pytest.mark.parametrize("act", ["glu", "relu"])
def test_ohead_and_ofc_bwd_plain_match_jax_kernels(act):
    """Without dropout, the JAX custom VJPs run ``_ohead_pallas_bwd`` and
    ``_ofc_pallas_bwd`` themselves (interpret mode)."""
    jcfg, cfg = _cfgs(act)
    args, cot = _ohead_inputs(cfg, seed=63)
    _, vjp = jax.vjp(lambda *a: joh.ohead_fused(jcfg, jnp.int32(V_TRUE), 0, *a), *_j(args))
    got = toh.ohead_bwd(cfg, *map(t, args), *map(t, cot))
    assert_grads([g.numpy() for g in got], vjp(tuple(_j(cot))))

    args, gout = _ofc_inputs(cfg, seed=64)
    _, vjp = jax.vjp(lambda *a: joh.ofc_fused(jcfg, jnp.int32(V_TRUE), 0, *a), *_j(args))
    got = toh.ofc_bwd(cfg, *map(t, args), t(gout))
    assert_grads([g.numpy() for g in got], vjp(jnp.asarray(gout)))


@pytest.mark.parametrize("drop", sorted(DROPS))
def test_ofc_bwd_plain_takes_given_relu_decisions(drop):
    """The ``relu_mask`` of the plain version (the card check's way to hold it
    to a kernel's ReLU decisions): its own decisions give the default result
    (to f32 rounding: autograd may sum a bias gradient in another order); one
    kept unit's flipped decision moves ``da`` at that unit's lane (b, v)
    only."""
    _, cfg = _cfgs("glu")
    args, gout = _ofc_inputs(cfg, seed=71)
    args = [cfg, *map(t, args), t(gout)]
    own = (toh.ofc_preact(*args[1:8]) > 0).float()
    ref = toh.ofc_bwd_reference(*args, drop=DROPS[drop])
    same = toh.ofc_bwd_reference(*args, drop=DROPS[drop], relu_mask=own)
    for a, b in zip(ref, same):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-6 * float(a.abs().max()))
    keep = (torch.ones_like(own) if DROPS[drop] is None
            else D.keep_mask(DROPS[drop], own.shape, V_TRUE))
    b, g, v = next((b, g, v) for b, g, v in [(1, 2, 40), (0, 5, 17), (1, 7, 3), (0, 1, 90)]
                   if keep[b, 0, g, v])
    own[b, 0, g, v] = 1.0 - own[b, 0, g, v]
    moved = (toh.ofc_bwd_reference(*args, drop=DROPS[drop], relu_mask=own)[0] != same[0]).any(2)
    assert moved[b, 0, v] and int(moved.sum()) == 1
