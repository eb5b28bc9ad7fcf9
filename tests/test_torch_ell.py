"""The port's blocked-ELL route against the JAX package's: the pack (the
device scatter, run on the CPU), K6's plain version in each mode on f32 and int8 packs and
its VJPs, the operator's surfaces, the unfused and the fused forward on an
ELL operator (training on it: ``test_torch_ell_train.py``). V = 600,
RCM-ordered, with bs = 64 (block rows with fewer live tiles than max_b, so
padding tiles) and 256, B = 3; the JAX side runs its off-TPU branches
(``use_pallas=False``: ``ell_nv_reference``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgcn_tpu.graph.packing import pack_ell_nv as jax_pack_ell_nv
from stgcn_tpu.kernels import ell_nv as jek
from stgcn_tpu.ops.graph_op import ell_graph_op as jax_ell_graph_op
from stgcn_tpu_torch.graph.packing import pack_ell_device
from stgcn_tpu_torch.kernels import ell_nv as tek
from stgcn_tpu_torch.ops import EllGraphOp, ell_graph_op
from tests.torch_parity_utils import BANDED_V as V
from tests.torch_parity_utils import assert_grads, banded_gsos, rand, t

KERNEL_TOL = 2e-5   # K6 plain version and VJPs against the JAX package (f32 sums)
MODEL_TOL = 2e-5    # unfused model on the ELL op (tests/test_vertex_fused.py:376)
FUSED_TOL = 2e-4    # fused forward (tests/test_vertex_fused.py:381)


def _ops(gso_type, bs, quantize):
    """(JAX op, port op) of the RCM-ordered V = 600 graph."""
    _, jart, tart = banded_gsos(gso_type)
    return (jax_ell_graph_op(jart, block_size=bs, quantize=quantize, use_pallas=False),
            ell_graph_op(tart, block_size=bs, quantize=quantize, device="cpu"))


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("bs", [64, 256])
@pytest.mark.parametrize("gso_type", ["sym_norm_lap", "rw_norm_lap"])
def test_pack_equals_jax(gso_type, bs, quantize):
    """The scattered pack and the operator's packs (both directions) equal
    the JAX pack exactly: slot order, padding tiles, transposed tiles,
    int8 values and scales; rw_norm_lap is not symmetric, so it has its own
    transpose pack."""
    _, jart, tart = banded_gsos(gso_type)
    ref = jax_pack_ell_nv(jart.matrix, block_size=bs, quantize=quantize)
    dev = pack_ell_device(tart.matrix, block_size=bs, quantize=quantize, device="cpu")
    for r, d in zip(ref, dev):
        if r is None:
            assert d is None
            continue
        assert d.numpy().dtype == r.dtype
        np.testing.assert_array_equal(d.numpy(), r)
    counts = ref[2]
    assert quantize == (ref[0].dtype == np.int8)
    if bs == 64:   # some block rows hold padding tiles: all zero, at block column 0
        assert counts.min() < ref[1].shape[1]
    jop, top = _ops(gso_type, bs, quantize)
    assert isinstance(top, EllGraphOp) and top.v_pad == jop.v_pad and top.n_vertex == V
    assert (top.pack_t is top.pack) == (gso_type == "sym_norm_lap")
    for got, want in ((top.pack, (jop.data, jop.cols, jop.counts, jop.scales)),
                      (top.pack_t, (jop.data_t, jop.cols_t, jop.counts_t, jop.scales_t))):
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _jax_mode(jop, x, g, mode, scale):
    """The JAX functions the port's modes stand for (pair: ``ell_cheb_pair_nv``;
    chain: its VJP's two transpose applications, ``_pair_bwd``)."""
    sc = None if jop.scales is None else jop.scales * scale
    if mode == "single":
        data = jop.data if jop.scales is not None else jop.data * scale
        return (jek.ell_spmm_nv(data, jop.cols, jop.counts, jnp.asarray(x), sc,
                                use_pallas=False),)
    if mode == "pair":
        return jek.ell_cheb_pair_nv(jop.data, jop.cols, jop.counts, jop.data_t, jop.cols_t,
                                    jop.counts_t, jnp.asarray(x), jop.scales, jop.scales_t,
                                    False)
    at_g2 = jek.ell_spmm_nv(jop.data_t, jop.cols_t, jop.counts_t, jnp.asarray(x), jop.scales_t,
                            use_pallas=False)
    u = jnp.asarray(g) + 2.0 * at_g2
    return u, jek.ell_spmm_nv(jop.data_t, jop.cols_t, jop.counts_t, u, jop.scales_t,
                              use_pallas=False) - jnp.asarray(x)


@pytest.mark.parametrize("mode", ["single", "pair", "chain"])
@pytest.mark.parametrize("quantize", [False, True])
def test_k6_plain_modes_match_jax(quantize, mode):
    """Every mode (single with scale 2, the Chebyshev 2G step) on an operand
    whose padded lanes are not zero and an N that is no tile multiple;
    chain on the transpose pack of the non-symmetric rw_norm_lap."""
    jop, top = _ops("rw_norm_lap", 64, quantize)
    rng = np.random.default_rng(7)
    x = rand(rng, 3 * 5 * 16 + 1, top.v_pad)
    g = rand(rng, *x.shape) if mode == "chain" else None
    scale = 2.0 if mode == "single" else 1.0
    pack = top.pack_t if mode == "chain" else top.pack
    got = tek.ell_nv(pack, t(x), None if g is None else t(g), mode, scale=scale)
    got = (got,) if mode == "single" else got
    assert_grads([o.numpy() for o in got], [np.asarray(r) for r in _jax_mode(jop, x, g, mode,
                                                                            scale)],
                 atol=KERNEL_TOL)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("gso_type", ["sym_norm_lap", "rw_norm_lap"])
def test_k6_vjps_match_jax(gso_type, quantize):
    """torch.autograd through EllSpmmNv / EllChebPairNv (K6 single and chain
    on the transpose pack) against jax.vjp of ell_spmm_nv_vjp /
    ell_cheb_pair_nv."""
    jop, top = _ops(gso_type, 64, quantize)
    rng = np.random.default_rng(11)
    x = rand(rng, 96, top.v_pad)
    g1, g2 = rand(rng, *x.shape), rand(rng, *x.shape)
    jargs = (jop.data, jop.cols, jop.counts, jop.data_t, jop.cols_t, jop.counts_t)

    _, vjp = jax.vjp(lambda v: jek.ell_cheb_pair_nv(*jargs, v, jop.scales, jop.scales_t, False),
                     jnp.asarray(x))
    (dx_ref,) = vjp((jnp.asarray(g1), jnp.asarray(g2)))
    xt = t(x).requires_grad_(True)
    t1, t2 = tek.ell_cheb_pair_nv(top.pack, top.pack_t, xt)
    (dx,) = torch.autograd.grad((t1 * t(g1)).sum() + (t2 * t(g2)).sum(), [xt])
    assert_grads([dx.numpy()], [np.asarray(dx_ref)], atol=KERNEL_TOL)

    _, vjp = jax.vjp(lambda v: jek.ell_spmm_nv_vjp(*jargs, v, jop.scales, jop.scales_t, False),
                     jnp.asarray(x))
    (dx_ref,) = vjp(jnp.asarray(g1))
    xt = t(x).requires_grad_(True)
    (dx,) = torch.autograd.grad((tek.ell_spmm_nv(top.pack, top.pack_t, xt) * t(g1)).sum(), [xt])
    assert_grads([dx.numpy()], [np.asarray(dx_ref)], atol=KERNEL_TOL)
