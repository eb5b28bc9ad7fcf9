"""More of ``tests/test_torch_ell.py``'s tests: each port test file holds at most
20 collected tests. Helpers, constants and fixtures come from there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgcn_tpu.nn.fused_sparse import fused_sparse_forward as jax_fused_sparse_forward
from stgcn_tpu.nn.model import STGCN as JaxSTGCN
from stgcn_tpu.ops.graph_op import ell_graph_op as jax_ell_graph_op
from stgcn_tpu_torch.nn.convert import params_from_jax
from stgcn_tpu_torch.nn.fused_sparse import fused_sparse_forward
from stgcn_tpu_torch.nn.model import STGCN
from stgcn_tpu_torch.ops import ell_graph_op
from tests.torch_parity_utils import BANDED_V as V
from tests.torch_parity_utils import GATE_CASES, B, banded_gsos, rand, t, to_np
from tests.test_torch_ell import (
    FUSED_TOL,
    KERNEL_TOL,
    MODEL_TOL,
    _ops,
)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("gso_type", ["sym_norm_lap", "rw_norm_lap"])
def test_ell_op_surfaces_match_jax(gso_type, quantize):
    """apply_nv (scale 1 and 2, an operand narrower than v_pad),
    cheb_pair_nv, apply_vn, cheb_pair_vn, __call__ and cheb_pair against the
    JAX ell_graph_op(use_pallas=False)."""
    jop, top = _ops(gso_type, 64, quantize)
    rng = np.random.default_rng(2)
    x = rand(rng, B, 4, V, 5)
    x_vn = np.ascontiguousarray(x.transpose(2, 0, 1, 3).reshape(V, -1))
    x_nv = rand(rng, 37, top.v_pad)
    cases = [
        (top(t(x)), jop(jnp.asarray(x))),
        (top(t(x), scale=2.0), jop(jnp.asarray(x), scale=2.0)),
        *zip(top.cheb_pair(t(x)), jop.cheb_pair(jnp.asarray(x))),
        (top.apply_vn(t(x_vn)), jop.apply_vn(jnp.asarray(x_vn))),
        *zip(top.cheb_pair_vn(t(x_vn)), jop.cheb_pair_vn(jnp.asarray(x_vn))),
        (top.apply_nv(t(x_nv), scale=2.0), jop.apply_nv(jnp.asarray(x_nv), scale=2.0)),
        *zip(top.cheb_pair_nv(t(x_nv)), jop.cheb_pair_nv(jnp.asarray(x_nv))),
        (top.apply_nv(t(x_vn.T)), jop.apply_nv(jnp.asarray(x_vn.T))),   # W = V < v_pad
    ]
    for i, (got, ref) in enumerate(cases):
        assert got.shape == ref.shape, i
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=KERNEL_TOL, rtol=KERNEL_TOL,
                                   err_msg=f"case {i}")
    assert float(cases[-1][0][:, V:].abs().max()) == 0.0   # rows past V are empty
    with pytest.raises(ValueError, match="nv operand"):
        top.apply_nv(torch.zeros(3, top.v_pad + 1))


@pytest.mark.parametrize("gct,ks,act,quantize", [(*c, False) for c in GATE_CASES]
                         + [("cheb_graph_conv", 3, "glu", True)])
def test_forward_on_ell_op_matches_jax(gct, ks, act, quantize):
    """The unfused model (Cheb ks=3 through ``cheb_pair``: K6 pair) and the
    fused forward (K1-K4 and K6 plain versions) against JAX ``model.apply``
    and ``fused_sparse_forward(use_pallas="xla")`` on the same op."""
    _, jart, tart = banded_gsos(cheb=gct == "cheb_graph_conv")
    jop = jax_ell_graph_op(jart, block_size=256, quantize=quantize, use_pallas=False)
    top = ell_graph_op(tart, block_size=256, quantize=quantize, device="cpu")
    jm = JaxSTGCN(n_his=12, ks=ks, graph_conv_type=gct, act_func=act)
    x = np.random.default_rng(1).standard_normal((B, 12, V, 1)).astype(np.float32)
    jparams = to_np(jm.init(jax.random.PRNGKey(3), jnp.asarray(x), jop,
                            deterministic=True)["params"])
    tm = STGCN(12, V, ks=ks, graph_conv_type=gct, act_func=act, device="cpu")
    tm.load_state_dict(params_from_jax(jparams))
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
