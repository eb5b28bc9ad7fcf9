"""The port's vn banded route and the int8 banded operator against the JAX
package's: the packs (vn and nv, f32 and int8 with scales, the clamped pack
and its transpose, every field of ``banded_graph_op``), the plain versions
of K7 (one application), K8 (the pair on a clamped pack), K9 (the stream
pair and chain) and K5 int8, the operand gradient of every autograd
Function, and every ``BandedGraphOp`` surface (the models and training:
``test_torch_banded_vn_train.py``). V = 600, RCM-ordered, bs = 128 and 256;
the JAX side runs its off-TPU branches (``use_pallas=False``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgcn_tpu.kernels import banded_nv as jnv
from stgcn_tpu.kernels import banded_spmm as jbs
from stgcn_tpu.ops.graph_op import banded_graph_op as jax_banded_graph_op
from stgcn_tpu_torch.kernels import banded_nv as tnv
from stgcn_tpu_torch.kernels import banded_spmm as tbs
from stgcn_tpu_torch.ops import banded_graph_op
from tests.torch_parity_utils import BANDED_V as V
from tests.torch_parity_utils import B, assert_grads, banded_gsos, rand, t

KERNEL_TOL = 2e-5   # plain versions and Functions against the JAX package (f32 sums)

# banded_graph_op's arguments: stream pack (vn; with the nv family; nv only),
# int8 (vn; with nv), and the clamped pack of stream=False
OP_KW = {"stream": {}, "stream_nv": {"nv": True}, "nv_only": {"nv": True, "nv_only": True},
         "int8": {"quantize": True}, "int8_nv": {"quantize": True, "nv": True},
         "clamped": {"stream": False}}
FIELDS = ("slabs", "lo", "slabs_t", "lo_t", "scales", "scales_t", "slabs_nv", "slabs_nv_t")


def _ops(gso_type="sym_norm_lap", bs=128, n=V, seed=0, cheb=True, **kw):
    """(JAX op, port op) built with the same arguments."""
    _, jart, tart = banded_gsos(gso_type, n=n, seed=seed, cheb=cheb)
    return (jax_banded_graph_op(jart, block_size=bs, use_pallas=False, **kw),
            banded_graph_op(tart, block_size=bs, device="cpu", **kw))


def _close(got, ref, atol=KERNEL_TOL):
    got = [got] if isinstance(got, torch.Tensor) else list(got)
    ref = [ref] if not isinstance(ref, (tuple, list)) else list(ref)
    assert_grads([g.detach().numpy() for g in got], [np.asarray(r) for r in ref], atol=atol)


@pytest.mark.parametrize("transpose_slabs", [False, True])
@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("bs", [128, 256])
def test_pack_banded_device_equals_jax(bs, quantize, transpose_slabs):
    """The stream pack (block-aligned, diagonal-containing windows) and the
    clamped one (128-aligned), vn and nv, f32 and int8 with its scales:
    exactly the JAX pack."""
    _, jart, tart = banded_gsos("rw_norm_lap")
    for kw in ({"col_align": bs, "contain_diag": True}, {}):
        ref = jbs.pack_banded_device(jart.matrix, block_size=bs, transpose_slabs=transpose_slabs,
                                     dtype=jnp.int8 if quantize else jnp.float32, **kw)
        got = tbs.pack_banded_device(tart.matrix, block_size=bs, transpose_slabs=transpose_slabs,
                                     dtype=torch.int8 if quantize else torch.float32,
                                     device="cpu", **kw)
        assert len(got) == len(ref) == (4 if quantize else 3) and got[2] == ref[2]
        assert got[0].dtype == (torch.int8 if quantize else torch.float32)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(got[1], ref[1])
        if quantize:
            np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    for got, ref in zip(tbs._window_meta(tart.matrix, bs, 128),
                        jbs._window_meta(jart.matrix, bs, 128)):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("bs", [128, 256])
def test_pack_banded_with_transpose_equals_jax(bs):
    """The clamped pack and its transpose with one v_pad, exactly; the
    wavefront verdict; a v_pad below the window width raises."""
    _, jart, tart = banded_gsos("rw_norm_lap")
    ref = jbs.pack_banded_with_transpose(jart.matrix, block_size=bs)
    got = tbs.pack_banded_with_transpose(tart.matrix, block_size=bs, device="cpu")
    for g, r in zip(got[:4], ref[:4]):
        np.testing.assert_array_equal(g.numpy() if isinstance(g, torch.Tensor) else g, r)
    assert got[4] == ref[4]
    assert tbs.cheb_pair_wavefront_safe(got[1], bs) == jbs.cheb_pair_wavefront_safe(ref[1], bs)
    with pytest.raises(ValueError, match="v_pad"):
        tbs.pack_banded(tart.matrix, block_size=bs, v_pad=64, device="cpu")


@pytest.mark.parametrize("kind", sorted(OP_KW))
@pytest.mark.parametrize("gso_type", ["sym_norm_lap", "rw_norm_lap"])
def test_banded_graph_op_fields_equal_jax(gso_type, kind):
    """Every field of the operator exactly as the JAX one's (the nv-only
    one holds empty vn slabs, as the JAX one does); a symmetric GSO shares
    one stream pack for both directions."""
    jop, top = _ops(gso_type, bs=256, **OP_KW[kind])
    for f in FIELDS:
        got, ref = getattr(top, f), getattr(jop, f)
        assert (got is None) == (ref is None), f
        if got is not None:
            assert tuple(got.shape) == tuple(ref.shape), f
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=f)
    assert (top.v_pad, top.n_vertex, top.pair_safe, top.pair_stream, top.has_nv) == \
        (jop.v_pad, jop.n_vertex, jop.pair_safe, jop.pair_stream, jop.has_nv)
    shared = gso_type == "sym_norm_lap" and kind != "clamped"
    pack, pack_t = ("slabs_nv", "slabs_nv_t") if kind == "nv_only" else ("slabs", "slabs_t")
    assert (getattr(top, pack_t) is getattr(top, pack)) == shared


@pytest.mark.parametrize("scale", [1.0, 2.0])
@pytest.mark.parametrize("kind", ["stream", "int8", "clamped"])
def test_k7_plain_matches_jax(kind, scale):
    """K7's plain version, with and without row scales, against JAX
    ``banded_spmm(use_pallas=False)`` (its nbr·bs rows cut or padded to
    v_pad, as every caller does); the scale as the JAX op folds it, into
    the slabs or the int8 scales."""
    jop, top = _ops(bs=256, **OP_KW[kind])
    x = rand(np.random.default_rng(7), top.v_pad, 3 * 5 * 16 + 1)
    got = tbs.banded_spmm(top.slabs, top.lo, t(x), scales=top.scales, scale=scale)
    q = jop.scales is not None
    ref = jbs.banded_spmm(jop.slabs if q else jop.slabs * scale, jop.lo, jnp.asarray(x),
                          use_pallas=False, scales=jop.scales * scale if q else None)
    ref = np.asarray(ref)[:top.v_pad]
    ref = np.pad(ref, ((0, top.v_pad - ref.shape[0]), (0, 0)))
    assert got.shape == (top.v_pad, x.shape[1])
    _close(got, ref)


def test_k8_plain_matches_jax():
    """K8's plain version against JAX ``banded_cheb_pair(use_pallas=False)``
    on the clamped pack."""
    jop, top = _ops("rw_norm_lap", bs=128, **OP_KW["clamped"])
    x = rand(np.random.default_rng(8), top.v_pad, 97)
    got = tbs.banded_cheb_pair(top.slabs, top.lo, t(x))
    _close(got, jbs.banded_cheb_pair(jop.slabs, jop.lo, jnp.asarray(x), use_pallas=False))


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


def _vjp_cases():
    """(name, op kind, port function of x, JAX function of x) for each
    autograd Function; rw_norm_lap, so the transpose pack is a pack of its
    own."""
    def vn(op):
        return op.slabs, op.lo, op.slabs_t, op.lo_t

    return {
        "k7": ("stream", lambda op, x: tbs.banded_spmm_vjp(*vn(op), x, scale=2.0),
               lambda op, x: jbs.banded_spmm_vjp(op.slabs * 2.0, op.lo, op.slabs_t * 2.0,
                                                 op.lo_t, x, None, None, 128, False)),
        "k7_int8": ("int8", lambda op, x: tbs.banded_spmm_vjp(*vn(op), x, op.scales,
                                                              op.scales_t, scale=2.0),
                    lambda op, x: jbs.banded_spmm_vjp(op.slabs, op.lo, op.slabs_t, op.lo_t, x,
                                                      op.scales * 2.0, op.scales_t * 2.0, 128,
                                                      False)),
        "k8": ("clamped", lambda op, x: tbs.banded_cheb_pair_vjp(*vn(op), x),
               lambda op, x: jbs.banded_cheb_pair_vjp(*vn(op), x, False)),
        "k9": ("stream", lambda op, x: tbs.banded_cheb_pair_stream_vjp(*vn(op), x),
               lambda op, x: jbs.banded_cheb_pair_stream_vjp(*vn(op), x, None, None, False)),
        "k9_int8": ("int8", lambda op, x: tbs.banded_cheb_pair_stream_vjp(
                        *vn(op), x, op.scales, op.scales_t),
                    lambda op, x: jbs.banded_cheb_pair_stream_vjp(
                        *vn(op), x, op.scales, op.scales_t, False)),
        "k5_int8_single": ("int8_nv", lambda op, x: tnv.banded_spmm_nv(
                               op.slabs_nv, op.lo, op.slabs_nv_t, op.lo_t, x, op.scales,
                               op.scales_t, scale=2.0),
                           lambda op, x: jnv.banded_spmm_nv(
                               op.slabs_nv, op.lo, op.slabs_nv_t, op.lo_t, x, op.scales * 2.0,
                               op.scales_t * 2.0)),
        "k5_int8_pair": ("int8_nv", lambda op, x: tnv.cheb_pair_nv(
                             op.slabs_nv, op.lo, op.slabs_nv_t, op.lo_t, x, op.scales,
                             op.scales_t),
                         lambda op, x: jnv.cheb_pair_nv(
                             op.slabs_nv, op.lo, op.slabs_nv_t, op.lo_t, x, op.scales,
                             op.scales_t)),
    }


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
