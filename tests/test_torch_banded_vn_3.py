"""More of ``tests/test_torch_banded_vn.py``'s tests: each port test file holds at most
20 collected tests. Helpers, constants and fixtures come from there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgcn_tpu.kernels import banded_nv as jnv
from stgcn_tpu.kernels import banded_spmm as jbs
from stgcn_tpu_torch.kernels import banded_nv as tnv
from stgcn_tpu_torch.kernels import banded_spmm as tbs
from tests.torch_parity_utils import BANDED_V as V
from tests.torch_parity_utils import B, rand, t
from tests.test_torch_banded_vn import (
    KERNEL_TOL,
    OP_KW,
    _close,
    _ops,
    _vjp_cases,
)


@pytest.mark.parametrize("mode", ["pair", "chain"])
@pytest.mark.parametrize("kind", ["stream", "int8"])
def test_k9_plain_matches_jax(kind, mode):
    """K9's plain version against the JAX off-TPU pair
    (``_cheb_pair_stream_primal``) and chain (``_pair_stream_fallback``, the
    arithmetic of ``_cheb_pair_stream_bwd``), on the transpose pack of a
    non-symmetric GSO, the padded rows past nbr·bs included."""
    jop, top = _ops("rw_norm_lap", bs=256, **OP_KW[kind])
    rng = np.random.default_rng(9)
    x, g = rand(rng, top.v_pad, 80), rand(rng, top.v_pad, 80)
    if mode == "pair":
        got = tbs.banded_cheb_pair_stream(top.slabs, top.lo, t(x), scales=top.scales)
        ref = jbs._cheb_pair_stream_primal(jop.slabs, jop.lo, jnp.asarray(x), jop.scales, False)
    else:
        got = tbs.banded_chain_stream(top.slabs_t, top.lo_t, t(x), t(g), scales_t=top.scales_t)
        ref = jbs._pair_stream_fallback(jop.slabs_t, jop.lo_t, jnp.asarray(x), jnp.asarray(g),
                                        jop.scales_t, None, 256)
    _close(got, ref)


@pytest.mark.parametrize("mode", ["single", "pair", "chain"])
def test_k5_int8_plain_matches_jax(mode):
    """K5's plain version on an int8 nv pack with its per-lane scales
    against JAX ``_stream_nv_call`` (the ``banded_spmm_nv`` / ``cheb_pair_nv``
    primal), on an operand whose padded lanes are not zero."""
    jop, top = _ops("rw_norm_lap", bs=128, **OP_KW["int8_nv"])
    rng = np.random.default_rng(10)
    x = rand(rng, 3 * 5 * 16 + 1, top.v_pad)
    g = rand(rng, *x.shape) if mode == "chain" else None
    got = tnv.stream_nv(top.slabs_nv, top.lo, t(x), None if g is None else t(g), mode,
                        scales=top.scales)
    ref = jnv._stream_nv_call(jop.slabs_nv, jop.lo, jnp.asarray(x),
                              None if g is None else jnp.asarray(g), jop.scales, None, mode)
    _close(got, ref)
    if mode == "single":   # the Chebyshev 2G step: alpha, never the scales
        _close(tnv.stream_nv(top.slabs_nv, top.lo, t(x), scales=top.scales, scale=2.0),
               2.0 * np.asarray(ref), atol=2 * KERNEL_TOL)


@pytest.mark.parametrize("name", sorted(_vjp_cases()))
def test_vjps_match_jax(name):
    """dx of every autograd Function against ``jax.vjp`` of its JAX
    counterpart: K7 and K8 backward as two K7 applications on the
    transpose pack, K9 as the chain, K5 int8 as single and chain."""
    kind, port_fn, jax_fn = _vjp_cases()[name]
    jop, top = _ops("rw_norm_lap", bs=128, **OP_KW[kind])
    rng = np.random.default_rng(11)
    nv = name.startswith("k5")
    x = rand(rng, 96, top.v_pad) if nv else rand(rng, top.v_pad, 96)
    g1, g2 = rand(rng, *x.shape), rand(rng, *x.shape)
    out, vjp = jax.vjp(lambda v: jax_fn(jop, v), jnp.asarray(x))
    pair = isinstance(out, (tuple, list))
    # the JAX single application has nbr·bs rows (640 of v_pad 768 here):
    # the port's rows past it are zero, so their cotangents move nothing
    ct = (jnp.asarray(g1), jnp.asarray(g2)) if pair else jnp.asarray(g1[:out.shape[0]])
    (dx_ref,) = vjp(ct)
    xt = t(x).requires_grad_(True)
    y = port_fn(top, xt)
    loss = (y[0] * t(g1)).sum() + (y[1] * t(g2)).sum() if pair else (y * t(g1)).sum()
    (dx,) = torch.autograd.grad(loss, [xt])
    _close(dx, dx_ref)


@pytest.mark.parametrize("kind", ["stream", "stream_nv", "nv_only", "int8", "int8_nv",
                                  "clamped"])
def test_operator_surfaces_match_jax(kind):
    """Every surface of the operator against the JAX operator built with the
    same arguments: ``__call__`` (scale 1 and 2), ``cheb_pair``,
    ``apply_vn``, ``cheb_pair_vn`` and, where it holds the nv pack,
    ``apply_nv`` / ``cheb_pair_nv``; a symmetric GSO at bs 256, so the
    stream pair runs."""
    jop, top = _ops(bs=256, **OP_KW[kind])
    rng = np.random.default_rng(2)
    x = rand(rng, B, 4, V, 5)
    _close(top(t(x)), jop(jnp.asarray(x)))
    _close(top(t(x), scale=2.0), jop(jnp.asarray(x), scale=2.0), atol=2 * KERNEL_TOL)
    _close(top.cheb_pair(t(x)), jop.cheb_pair(jnp.asarray(x)))
    x_vn = rand(rng, V, 40)
    _close(top.apply_vn(t(x_vn)), jop.apply_vn(jnp.asarray(x_vn)))
    _close(top.cheb_pair_vn(t(x_vn)), jop.cheb_pair_vn(jnp.asarray(x_vn)))
    assert top.has_nv == jop.has_nv
    if top.has_nv:
        x_nv = rand(rng, 40, top.v_pad)
        _close(top.apply_nv(t(x_nv)), jop.apply_nv(jnp.asarray(x_nv)))
        _close(top.cheb_pair_nv(t(x_nv)), jop.cheb_pair_nv(jnp.asarray(x_nv)))
    with pytest.raises(ValueError, match="operand"):
        top.apply_vn(torch.zeros(top.v_pad + 1, 3))
