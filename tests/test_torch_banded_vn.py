"""The port's vn banded route and the int8 banded operator against the JAX
package's: the packs (vn and nv, f32 and int8 with scales, the clamped pack
and its transpose, every field of ``banded_graph_op``), the plain versions
of K7 (one application), K8 (the pair on a clamped pack), K9 (the stream
pair and chain) and K5 int8, the operand gradient of every autograd
Function, and every ``BandedGraphOp`` surface (the models and training:
``test_torch_banded_vn_train.py``). V = 600, RCM-ordered, bs = 128 and 256;
the JAX side runs its off-TPU branches (``use_pallas=False``)."""

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
from tests.torch_parity_utils import assert_grads, banded_gsos

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
