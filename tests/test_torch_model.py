"""The port's unfused STGCN against the JAX package's ``model.apply``, with
the same weights carried across by ``nn.convert``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgcn_tpu_torch.nn import init as tinit
from stgcn_tpu_torch.nn.convert import params_from_jax, params_to_jax
from stgcn_tpu_torch.nn.model import STGCN, build_blocks, compute_ko
from tests.torch_parity_utils import GATE_CASES, T, V, setup_model, t, to_np

ATOL = 2e-5  # ARCHITECTURE.md:35-37, the layer/model parity bound


def _tree_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _tree_equal(a[k], b[k])
        else:
            assert a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("gct,ks,act", GATE_CASES)
def test_unfused_forward_matches_model_apply(gct, ks, act):
    jm, jop, jparams, tm, top, x = setup_model(gct, ks, act)
    ref = np.asarray(jm.apply({"params": jparams}, jnp.asarray(x), jop, deterministic=True))
    with torch.no_grad():
        got = tm(t(x), top).numpy()
    assert got.shape == ref.shape == (x.shape[0], 1, V, 1)
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("gct,ks,act", GATE_CASES[:2])
def test_params_round_trip_is_exact(gct, ks, act):
    _, _, jparams, tm, _, _ = setup_model(gct, ks, act)
    _tree_equal(params_to_jax(tm), jparams)
    sd = params_from_jax(params_to_jax(tm))
    assert set(sd) == set(tm.state_dict())
    for k, v in tm.state_dict().items():
        assert torch.equal(sd[k], v), k


def test_ko_zero_fc_head_round_trip():
    """n_his=8 leaves Ko=0: the inline fc1/fc2 head (`models.py:38-42`)."""
    from stgcn_tpu.nn.model import STGCN as JaxSTGCN
    from stgcn_tpu.ops import dense_graph_op as jdense

    assert compute_ko(8, 3, 2) == 0 and build_blocks(2, 0)[-2] == [128]
    jm = JaxSTGCN(n_his=8)
    x = np.random.default_rng(0).standard_normal((2, 8, 20, 1)).astype(np.float32)
    jp = to_np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jdense(np.eye(20)),
                       deterministic=True)["params"])
    tm = STGCN(8, 20, device="cpu")
    tm.load_state_dict(params_from_jax(jp))
    _tree_equal(params_to_jax(tm), jp)


def test_init_is_seeded_and_within_fan_in_bounds():
    g = lambda: torch.Generator().manual_seed(7)  # noqa: E731
    a, b = STGCN(T, V, device="cpu", generator=g()), STGCN(T, V, device="cpu", generator=g())
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    sd = a.state_dict()
    # Cheb weight [Ks, c_in, c_out]: torch fan_in = c_in * c_out (nn/init.py)
    w = sd["st_block_0.graph_conv.cheb_graph_conv.weight"]
    bound = tinit.fan_bound(tinit.torch_fan_in(tuple(w.shape)))
    assert bound == (1 / 256) ** 0.5 and float(w.abs().max()) <= bound
    assert float(w.abs().max()) > 0.9 * bound
    assert torch.equal(sd["st_block_0.ln.weight"], torch.ones(V, 64))
    conv = sd["st_block_1.tmp_conv1.causal_conv.weight"]   # fan_in = kt * c_in = 192
    assert float(conv.abs().max()) <= 192 ** -0.5


def test_ko_one_is_rejected():
    with pytest.raises(ValueError, match="Ko == 1"):
        STGCN(9, 10, device="cpu")
