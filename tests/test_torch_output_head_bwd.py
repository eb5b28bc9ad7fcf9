"""Plain versions of K3b (ohead backward) and K4b (ofc backward) against
``jax.vjp`` of the JAX package's kernel cores (``_ln_drop_fwd`` +
``_ohead_core`` / ``_ofc_core``) fed the port's dropout mask, and against
``ohead_fused`` / ``ofc_fused`` in Pallas interpret mode without dropout."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

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


@pytest.mark.parametrize("drop", sorted(DROPS))
@pytest.mark.parametrize("ce", [1, 16])
def test_ofc_bwd_plain_matches_jax_core_at_edge_shapes(ce, drop):
    """K4b's plain version against ``jax.vjp`` of the core of the JAX kernel
    ``_make_ofc_bwd_kernel`` (``_ln_drop_fwd`` + ``_ofc_core`` + fc2, the
    port's keyed mask handed in) where the card kernel's fc pass cuts its
    work unevenly: batch 1, c0 = 100 (a part piece of the recompute's
    rows), c1 = 72 (a ragged second 64-channel pass), ce 1 and 16 (the
    widths of fc2 it keeps in registers), V = 150 of 256 lanes with a
    nonzero ``gout`` on the padded lanes (dw2 and db2 sum every lane, as the
    JAX kernel's do)."""
    jcfg0, cfg0 = _cfgs("glu")
    kw = dict(c0=100, c1=72, c_end=ce)
    jcfg = dataclasses.replace(jcfg0, b_tile=1, **kw)
    cfg = dataclasses.replace(cfg0, **kw)
    rng = np.random.default_rng(66)
    lnw, lnb = 1.0 + rand(rng, 100, V_PAD, scale=0.1), rand(rng, 100, V_PAD)
    lnw[:, V_TRUE:] = 0.0
    lnb[:, V_TRUE:] = 0.0
    args = [rand(rng, 1, 1, 100, V_PAD), rand(rng, 1, 1, 1, 1, scale=0.1),
            (0.5 + rng.random((1, 1, 1, 1))).astype(np.float32), lnw, lnb,
            rand(rng, 100, 72, scale=0.1), rand(rng, 72, scale=0.1),
            rand(rng, 72, ce, scale=0.12), rand(rng, ce, scale=0.1)]
    gout = rand(rng, 1, 1, ce, V_PAD)
    assert float(np.abs(gout[..., V_TRUE:]).max()) > 0
    mask = None if DROPS[drop] is None else jnp.asarray(
        D.keep_mask(DROPS[drop], (1, 1, 72, V_PAD), V_TRUE).numpy())

    def f(a, mu, rstd, lnw_, lnb_, w1, b1, w2, b2):
        h = _ln_drop_fwd(jcfg, a, mu, rstd, lnw_, lnb_, None)
        _, z = joh._ofc_core(jcfg, h, w1, b1)
        if mask is not None:
            z = z * mask
        return _bdot(z, w2, None) + b2[:, None]

    _, vjp = jax.vjp(f, *_j(args))
    got = toh.ofc_bwd(cfg, *map(t, args), t(gout), drop=DROPS[drop])
    assert_grads([g.numpy() for g in got], vjp(jnp.asarray(gout)))
