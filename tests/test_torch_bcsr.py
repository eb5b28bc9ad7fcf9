"""The port's BCSR route against the JAX package's: the pack (the device
scatter, run on the CPU), the plain versions of K10 (SpMM) and K11 (SDDMM),
the differentiable SpMM's operand and tile-value gradients, the operator's
surfaces, the unfused model's forward and parameter gradients, the fused
forward's vn branch and a short unfused training trajectory on a BCSR
operator. V = 600 and 520, RCM-ordered, bs = 64 (block rows with fewer
live tiles than max_b, so padding slots; 520 vertices pad to 576, not a
multiple of 128), B = 3; the JAX side runs its off-TPU branches
(``use_pallas=False``: ``bcsr_spmm_reference`` / ``bcsr_sddmm_reference``;
the fused forward with ``use_pallas="xla"``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from stgcn_tpu import native
from stgcn_tpu.graph.packing import pack_bcsr as jax_pack_bcsr
from stgcn_tpu.kernels import sddmm as jsd
from stgcn_tpu.kernels import spmm as jsp
from stgcn_tpu.ops.graph_op import bcsr_graph_op as jax_bcsr_graph_op
from stgcn_tpu_torch.graph.packing import pack_bcsr_device
from stgcn_tpu_torch.kernels import sddmm as tsd
from stgcn_tpu_torch.kernels import spmm as tsp
from stgcn_tpu_torch.ops import BcsrGraphOp, bcsr_graph_op
from tests.torch_parity_utils import BANDED_V as V
from tests.torch_parity_utils import B, assert_grads, banded_gsos, rand, t

BS = 64
V_FUSED = 520       # 9 block rows of 64: n_vertex_pad 576, the fused lanes 640
KERNEL_TOL = 2e-5   # K10 / K11 plain versions and the VJP against the JAX package (f32 sums)
MODEL_TOL = 2e-5    # unfused model on the BCSR op (tests/test_vertex_fused.py:376)
FUSED_TOL = 2e-4    # fused forward (tests/test_vertex_fused.py:381)
T_STEPS, N_HIS, N_PRED = 23, 12, 3   # 8 training windows: 2 full batches of 3 and a tail


def _ops(gso_type="sym_norm_lap", n=V, seed=0, cheb=True):
    """(JAX op, port op) of one RCM-ordered synthetic road graph."""
    _, jart, tart = banded_gsos(gso_type, n=n, seed=seed, cheb=cheb)
    return (jax_bcsr_graph_op(jart, block_size=BS, use_pallas=False),
            bcsr_graph_op(tart, block_size=BS, device="cpu"))


@pytest.mark.parametrize("bs", [64, 256])
@pytest.mark.parametrize("gso_type", ["sym_norm_lap", "rw_norm_lap"])
def test_pack_equals_jax(gso_type, bs):
    """The scattered pack equals the JAX pack exactly: float32 tiles (each
    value rounded once), ascending slot order, padding slots all zero at
    block column 0. Held against ``pack_bcsr`` as the JAX operator calls
    it (its native packer where ``_libstgcn.so`` loads) and against its
    scipy route on sorted column indices (on the unsorted CSR of an
    RCM-permuted GSO that route orders a block row's slots by first
    appearance, which the native packer and the port do not). The
    operator's packs (rw_norm_lap is not symmetric: a transpose pack of its
    own) equal the JAX operator's."""
    _, jart, tart = banded_gsos(gso_type)
    got = pack_bcsr_device(tart.matrix, block_size=bs, device="cpu")
    refs = [jax_pack_bcsr(sp.csr_matrix(jart.matrix).sorted_indices(), block_size=bs,
                          use_native=False)]
    if native.available():
        refs.append(jax_pack_bcsr(jart.matrix, block_size=bs))
    for ref in refs:
        for g, r in zip(got, ref):
            r = r.astype(np.float32) if r.dtype == np.float64 else r
            assert g.numpy().dtype == r.dtype
            np.testing.assert_array_equal(g.numpy(), r)
    data, cols, counts = (a.numpy() for a in got)
    if bs == 64:   # some block rows hold padding slots: all zero, at block column 0
        live = np.arange(cols.shape[1])[None, :] < counts[:, None]
        assert not live.all() and (cols[~live] == 0).all() and (data[~live] == 0).all()
    jop = jax_bcsr_graph_op(jart, block_size=bs, use_pallas=False)
    top = bcsr_graph_op(tart, block_size=bs, device="cpu")
    assert isinstance(top, BcsrGraphOp) and top.n_vertex_pad == jop.n_vertex_pad
    assert top.n_vertex == V and top.block_size == bs
    assert (top.pack_t is top.pack) == (gso_type == "sym_norm_lap")
    for pack, want in ((top.pack, (jop.block_data, jop.block_cols, jop.block_counts)),
                       (top.pack_t, (jop.block_data_t, jop.block_cols_t, jop.block_counts_t))):
        for g, w in zip(pack, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_k10_plain_matches_jax(scale):
    """K10's plain version (scale as alpha) against the JAX ``bcsr_spmm``
    off the TPU on the pack times the scale, as the JAX operator applies
    it; N is no tile multiple."""
    jop, top = _ops("rw_norm_lap")
    x = rand(np.random.default_rng(7), top.n_vertex_pad, 3 * 5 * 16 + 1)
    got = tsp.bcsr_spmm(top.pack, t(x), scale=scale)
    ref = jsp.bcsr_spmm(jop.block_data * scale, jop.block_cols, jnp.asarray(x),
                        counts=jop.block_counts, block_size=BS, use_pallas=False)
    assert_grads([got.numpy()], [np.asarray(ref)], atol=KERNEL_TOL)


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_k11_plain_matches_jax(scale):
    """K11's plain version against the JAX ``bcsr_sddmm`` off the TPU: the
    live tiles of ``g xᵀ``, padding slots exactly zero."""
    jop, top = _ops("rw_norm_lap")
    rng = np.random.default_rng(8)
    g, x = (rand(rng, top.n_vertex_pad, 97) for _ in range(2))
    got = tsd.bcsr_sddmm(top.pack.cols, top.pack.counts, t(g), t(x), block_size=BS,
                         scale=scale)
    ref = scale * jsd.bcsr_sddmm(jop.block_cols, jnp.asarray(g), jnp.asarray(x),
                                 counts=jop.block_counts, block_size=BS, use_pallas=False)
    assert got.shape == ref.shape
    assert_grads([got.numpy()], [np.asarray(ref)], atol=KERNEL_TOL)
    live = torch.arange(got.shape[1])[None, :] < top.pack.counts[:, None]
    assert float(got[~live].abs().max()) == 0.0


@pytest.mark.parametrize("n", [0, 1, 15, 17, 160])
def test_k11_plain_matches_jax_at_edge_widths(n):
    """K11's plain version against the JAX ``bcsr_sddmm`` off the TPU at the
    widths where the card kernel stages its operands differently: none,
    one, ragged below and above a 16-column step, and the 1M route's block
    1; padding slots exactly zero."""
    jop, top = _ops()
    rng = np.random.default_rng(9)
    g, x = (rand(rng, top.n_vertex_pad, n) for _ in range(2))
    got = tsd.bcsr_sddmm(top.pack.cols, top.pack.counts, t(g), t(x), block_size=BS)
    if n:
        ref = jsd.bcsr_sddmm(jop.block_cols, jnp.asarray(g), jnp.asarray(x),
                             counts=jop.block_counts, block_size=BS, use_pallas=False)
    else:   # an empty sum; the JAX reference's reshape cannot take N = 0
        ref = np.zeros((*jop.block_cols.shape, BS, BS), np.float32)
    assert got.shape == ref.shape
    assert_grads([got.numpy()], [np.asarray(ref)], atol=KERNEL_TOL)
    live = torch.arange(got.shape[1])[None, :] < top.pack.counts[:, None]
    assert float(got[~live].abs().max()) == 0.0


@pytest.mark.parametrize("scale", [1.0, 2.0])
@pytest.mark.parametrize("gso_type", ["sym_norm_lap", "rw_norm_lap"])
def test_vjp_matches_jax(gso_type, scale):
    """``bcsr_spmm_vjp``'s operand gradient (K10 on the transpose pack) and
    tile-value gradient (K11 times the scale) against ``jax.grad`` of the
    JAX ``bcsr_spmm_vjp`` on the scaled packs, as the JAX operator builds
    them; without a tile-value request nothing is saved for it."""
    jop, top = _ops(gso_type)
    rng = np.random.default_rng(11)
    x, w = rand(rng, top.n_vertex_pad, 96), rand(rng, top.n_vertex_pad, 96)

    def jloss(data, v):
        y = jsp.bcsr_spmm_vjp(data * scale, jop.block_cols, jop.block_counts,
                              jop.block_data_t * scale, jop.block_cols_t, jop.block_counts_t,
                              v, BS, False)
        return jnp.sum(y * jnp.asarray(w))

    ddata_ref, dx_ref = jax.grad(jloss, argnums=(0, 1))(jop.block_data, jnp.asarray(x))
    data = top.pack.data.clone().requires_grad_(True)
    pack = top.pack._replace(data=data)
    pack_t = pack if top.pack_t is top.pack else top.pack_t
    xt = t(x).requires_grad_(True)
    y = tsp.bcsr_spmm_vjp(pack, pack_t, xt, scale=scale)
    ddata, dx = torch.autograd.grad((y * t(w)).sum(), [data, xt])
    assert_grads([dx.numpy(), ddata.numpy()], [np.asarray(dx_ref), np.asarray(ddata_ref)],
                 atol=KERNEL_TOL)
    y = tsp.bcsr_spmm_vjp(top.pack, top.pack_t, xt, scale=scale)
    assert y.grad_fn.saved_tensors == ()


@pytest.mark.parametrize("gso_type", ["sym_norm_lap", "rw_norm_lap"])
def test_bcsr_op_surfaces_match_jax(gso_type):
    """``__call__`` (scale 1 and 2) and ``apply_vn`` on a full and on a
    short (W = V < n_vertex_pad) operand against the JAX operator."""
    jop, top = _ops(gso_type)
    rng = np.random.default_rng(2)
    x = rand(rng, B, 4, V, 5)
    x_vn = np.ascontiguousarray(x.transpose(2, 0, 1, 3).reshape(V, -1))
    x_pad = rand(rng, top.n_vertex_pad, 37)
    cases = [
        (top(t(x)), jop(jnp.asarray(x))),
        (top(t(x), scale=2.0), jop(jnp.asarray(x), scale=2.0)),
        (top.apply_vn(t(x_vn)), jop.apply_vn(jnp.asarray(x_vn))),
        (top.apply_vn(t(x_pad), scale=2.0), jop.apply_vn(jnp.asarray(x_pad), scale=2.0)),
    ]
    for i, (got, ref) in enumerate(cases):
        assert got.shape == ref.shape, i
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=KERNEL_TOL,
                                   rtol=KERNEL_TOL, err_msg=f"case {i}")
    with pytest.raises(ValueError, match="vn operand"):
        top.apply_vn(torch.zeros(top.n_vertex_pad + 1, 3))
