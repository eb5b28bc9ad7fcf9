"""The port's banded route against the JAX package's: the numpy copies
(synthetic data, RCM), the nv slab pack, K5's plain version in each mode and
its VJPs, the operator's surfaces, the unfused and the fused forward on a
banded operator, and ``make_graph_op``'s routing (training on the banded
operator: ``test_torch_banded_train.py``). V = 600 with bs = 128 and 256,
B = 3; the JAX side runs its off-TPU branches (``_stream_nv_call`` falls back
to ``_nv_ref`` there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from stgcn_tpu.data import synthetic as JS
from stgcn_tpu.graph.partition import permute_matrix as jax_permute_matrix
from stgcn_tpu.graph.partition import rcm_ordering as jax_rcm_ordering
from stgcn_tpu.kernels import banded_nv as jnv
from stgcn_tpu.kernels import banded_spmm as jbs
from stgcn_tpu.nn.fused_sparse import fused_sparse_forward as jax_fused_sparse_forward
from stgcn_tpu.nn.model import STGCN as JaxSTGCN
from stgcn_tpu.ops.graph_op import banded_graph_op as jax_banded_graph_op
from stgcn_tpu_torch.data import synthetic as TS
from stgcn_tpu_torch.graph.partition import permute_matrix, rcm_ordering
from stgcn_tpu_torch.kernels import banded_nv as tnv
from stgcn_tpu_torch.kernels import banded_spmm as tbs
from stgcn_tpu_torch.nn.convert import params_from_jax
from stgcn_tpu_torch.nn.fused_sparse import fused_sparse_forward
from stgcn_tpu_torch.nn.model import STGCN
from stgcn_tpu_torch.ops import banded_graph_op, dense_graph_op
from tests.torch_parity_utils import BANDED_V as V
from tests.torch_parity_utils import GATE_CASES, B, assert_grads, banded_gsos, rand, t, to_np

KERNEL_TOL = 2e-5   # K5 plain version and VJPs against the JAX package (f32 sums)
MODEL_TOL = 2e-5    # unfused model on the banded op (tests/test_vertex_fused.py:376)
FUSED_TOL = 2e-4    # fused forward (tests/test_vertex_fused.py:381)


@pytest.fixture(scope="module", params=[128, 256])
def ops(request):
    """(bs, JAX nv_only op, port op) for the symmetric sym_norm_lap GSO."""
    bs = request.param
    _, jart, tart = banded_gsos()
    jop = jax_banded_graph_op(jart, block_size=bs, use_pallas=False, nv=True, nv_only=True)
    return bs, jop, banded_graph_op(tart, block_size=bs, nv=True, nv_only=True, device="cpu")


def test_synthetic_and_rcm_copies_equal_jax(tmp_path):
    a_j = JS.random_road_graph(V, k_neighbors=8, seed=5)
    a_t = TS.random_road_graph(V, k_neighbors=8, seed=5)
    assert (a_j != a_t).nnz == 0 and a_j.dtype == a_t.dtype
    np.testing.assert_array_equal(JS.generate_synthetic_vel(a_j, 40, seed=3),
                                  TS.generate_synthetic_vel(a_t, 40, seed=3))
    for mod, sub in ((JS, "j"), (TS, "t")):
        (tmp_path / sub / "toy").mkdir(parents=True)
        sp.save_npz(tmp_path / sub / "toy" / "adj.npz", a_j)
        mod.ensure_vel("toy", str(tmp_path / sub), seed=9, n_steps=30)
    assert (tmp_path / "j/toy/vel.csv").read_bytes() == (tmp_path / "t/toy/vel.csv").read_bytes()
    perm = rcm_ordering(a_t)
    np.testing.assert_array_equal(perm, jax_rcm_ordering(a_j))
    assert (permute_matrix(a_t, perm) != jax_permute_matrix(a_j, perm)).nnz == 0


@pytest.mark.parametrize("gso_type", ["sym_norm_lap", "rw_norm_lap"])
@pytest.mark.parametrize("bs", [128, 256])
def test_pack_equals_jax(gso_type, bs):
    """slabs_nv (both directions), lo and v_pad exactly; rw_norm_lap is not
    symmetric, so it has its own transpose pack."""
    _, jart, tart = banded_gsos(gso_type)
    jop = jax_banded_graph_op(jart, block_size=bs, use_pallas=False, nv=True, nv_only=True)
    top = banded_graph_op(tart, block_size=bs, nv=True, nv_only=True, device="cpu")
    assert top.v_pad == jop.v_pad and top.n_vertex == V
    np.testing.assert_array_equal(top.slabs_nv.numpy(), np.asarray(jop.slabs_nv))
    np.testing.assert_array_equal(top.slabs_nv_t.numpy(), np.asarray(jop.slabs_nv_t))
    np.testing.assert_array_equal(top.lo.numpy(), np.asarray(jop.lo))
    np.testing.assert_array_equal(top.lo_t.numpy(), np.asarray(jop.lo_t))
    assert (top.slabs_nv_t is top.slabs_nv) == (gso_type == "sym_norm_lap")
    nbr, w, _ = top.slabs_nv.shape
    assert tbs.cheb_pair_stream_safe(top.lo.numpy(), w, bs)
    assert tbs.banded_viable(tart.matrix) == jbs.banded_viable(jart.matrix)
    for got, ref in zip(tbs._window_meta(tart.matrix, bs, bs, contain_diag=True),
                        jbs._window_meta(jart.matrix, bs, bs, contain_diag=True)):
        np.testing.assert_array_equal(got, ref)


def _jax_mode(jop, x, g, mode, transpose=False):
    slabs, lo = (jop.slabs_nv_t, jop.lo_t) if transpose else (jop.slabs_nv, jop.lo)
    return jnv._stream_nv_call(slabs, lo, jnp.asarray(x), None if g is None else jnp.asarray(g),
                               None, None, mode)


@pytest.mark.parametrize("mode", ["single", "pair", "chain"])
def test_k5_plain_modes_match_jax(ops, mode):
    """Every mode on an operand whose padded lanes are not zero (so the
    padding rules are held too), and an N that is no tile multiple."""
    bs, jop, top = ops
    rng = np.random.default_rng(7)
    x = rand(rng, 3 * 5 * 16 + 1, top.v_pad)
    g = rand(rng, *x.shape) if mode == "chain" else None
    got = tnv.stream_nv(top.slabs_nv, top.lo, t(x), None if g is None else t(g), mode)
    ref = _jax_mode(jop, x, g, mode)
    got, ref = (got,) if mode == "single" else got, (ref,) if mode == "single" else ref
    assert_grads([o.numpy() for o in got], [np.asarray(r) for r in ref], atol=KERNEL_TOL)
    if mode == "single":   # the Chebyshev 2G step scales the application
        np.testing.assert_allclose(
            tnv.stream_nv(top.slabs_nv, top.lo, t(x), scale=2.0).numpy(),
            2.0 * np.asarray(ref[0]), atol=2 * KERNEL_TOL)


@pytest.mark.parametrize("gso_type", ["sym_norm_lap", "rw_norm_lap"])
def test_k5_vjps_match_jax(gso_type):
    """torch.autograd through BandedSpmmNv / ChebPairNv (K5 single and chain
    on the transpose pack) against jax.vjp of banded_spmm_nv / cheb_pair_nv."""
    _, jart, tart = banded_gsos(gso_type)
    jop = jax_banded_graph_op(jart, block_size=128, use_pallas=False, nv=True, nv_only=True)
    top = banded_graph_op(tart, block_size=128, nv=True, nv_only=True, device="cpu")
    rng = np.random.default_rng(11)
    x = rand(rng, 96, top.v_pad)
    g1, g2 = rand(rng, *x.shape), rand(rng, *x.shape)
    jargs = (jop.slabs_nv, jop.lo, jop.slabs_nv_t, jop.lo_t)
    targs = (top.slabs_nv, top.lo, top.slabs_nv_t, top.lo_t)

    _, vjp = jax.vjp(lambda v: jnv.cheb_pair_nv(*jargs, v), jnp.asarray(x))
    (dx_ref,) = vjp((jnp.asarray(g1), jnp.asarray(g2)))
    xt = t(x).requires_grad_(True)
    t1, t2 = tnv.cheb_pair_nv(*targs, xt)
    (dx,) = torch.autograd.grad((t1 * t(g1)).sum() + (t2 * t(g2)).sum(), [xt])
    assert_grads([dx.numpy()], [np.asarray(dx_ref)], atol=KERNEL_TOL)

    _, vjp = jax.vjp(lambda v: jnv.banded_spmm_nv(*jargs, v), jnp.asarray(x))
    (dx_ref,) = vjp(jnp.asarray(g1))
    xt = t(x).requires_grad_(True)
    (dx,) = torch.autograd.grad((tnv.banded_spmm_nv(*targs, xt) * t(g1)).sum(), [xt])
    assert_grads([dx.numpy()], [np.asarray(dx_ref)], atol=KERNEL_TOL)


def test_banded_op_surfaces_match_the_dense_op(ops):
    """apply_nv / cheb_pair_nv / apply_vn / cheb_pair_vn / __call__ /
    cheb_pair of the banded op equal the dense op's products."""
    _, _, top = ops
    _, _, tart = banded_gsos()
    dop = dense_graph_op(tart, device="cpu")
    rng = np.random.default_rng(2)
    x = t(rand(rng, B, 4, V, 5))
    d1 = dop(x)
    d2 = dop(d1, scale=2.0) - x
    np.testing.assert_allclose(top(x).numpy(), d1.numpy(), atol=1e-5)
    np.testing.assert_allclose(top(x, scale=2.0).numpy(), 2 * d1.numpy(), atol=2e-5)
    for got, ref in zip(top.cheb_pair(x), (d1, d2)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5)
    x_vn = x.permute(2, 0, 1, 3).reshape(V, -1)
    ref_vn = d1.permute(2, 0, 1, 3).reshape(V, -1)
    np.testing.assert_allclose(top.apply_vn(x_vn).numpy(), ref_vn.numpy(), atol=1e-5)
    np.testing.assert_allclose(top.cheb_pair_vn(x_vn)[1].numpy(),
                               d2.permute(2, 0, 1, 3).reshape(V, -1).numpy(), atol=2e-5)
    y_nv = top.apply_nv(x_vn.T)   # W = V < v_pad: padded inside, v_pad wide out
    assert y_nv.shape == (x_vn.shape[1], top.v_pad)
    np.testing.assert_allclose(y_nv[:, :V].numpy(), ref_vn.T.numpy(), atol=1e-5)
    assert float(y_nv[:, V:].abs().max()) == 0.0
    with pytest.raises(ValueError, match="nv operand"):
        top.apply_nv(torch.zeros(3, top.v_pad + 1))


def _models(gct, ks, act, bs):
    adj, jart, tart = banded_gsos(cheb=gct == "cheb_graph_conv")
    jop = jax_banded_graph_op(jart, block_size=bs, use_pallas=False, nv=True, nv_only=True)
    top = banded_graph_op(tart, block_size=bs, nv=True, nv_only=True, device="cpu")
    jm = JaxSTGCN(n_his=12, ks=ks, graph_conv_type=gct, act_func=act)
    x = np.random.default_rng(1).standard_normal((B, 12, V, 1)).astype(np.float32)
    jparams = to_np(jm.init(jax.random.PRNGKey(3), jnp.asarray(x), jop,
                            deterministic=True)["params"])
    tm = STGCN(12, V, ks=ks, graph_conv_type=gct, act_func=act, device="cpu")
    tm.load_state_dict(params_from_jax(jparams))
    return jm, jop, jparams, tm, top, x


@pytest.mark.parametrize("gct,ks,act,bs", [(*c, 256) for c in GATE_CASES]
                         + [("cheb_graph_conv", 3, "glu", 128)])
def test_forward_on_banded_op_matches_jax(gct, ks, act, bs):
    """The unfused model (Cheb ks=3 through ``cheb_pair``: K5 pair) and the
    fused forward (K1-K4 and K5 plain versions) against JAX ``model.apply``
    and ``fused_sparse_forward(use_pallas="xla")`` on the same op."""
    jm, jop, jparams, tm, top, x = _models(gct, ks, act, bs)
    ref = np.asarray(jm.apply({"params": jparams}, jnp.asarray(x), jop, deterministic=True))
    ref_fused = np.asarray(jax_fused_sparse_forward(jparams, jnp.asarray(x), jop, jm,
                                                    deterministic=True, use_pallas="xla"))
    with torch.no_grad():
        got = tm(t(x), top).numpy()
        got_fused = fused_sparse_forward(tm.state_dict(), t(x), top, tm).numpy()
    assert got.shape == got_fused.shape == ref.shape == (B, 1, V, 1)
    np.testing.assert_allclose(got, ref, atol=MODEL_TOL, rtol=MODEL_TOL)
    np.testing.assert_allclose(got_fused, ref_fused, atol=FUSED_TOL, rtol=FUSED_TOL)
    np.testing.assert_allclose(got_fused, ref, atol=FUSED_TOL, rtol=FUSED_TOL)
