"""The port's vertex-fused forward (kernels' plain versions on CPU) against
the JAX package's ``fused_sparse_forward`` in Pallas interpret mode and its
``model.apply``; ``evaluate_metrics`` against the JAX one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgcn_tpu.data import ForecastDataset as JaxForecastDataset
from stgcn_tpu.data import ZScoreScaler as JaxZScoreScaler
from stgcn_tpu.data import gather_windows as jax_gather_windows
from stgcn_tpu.nn.fused_sparse import fused_sparse_forward as jax_fused_sparse_forward
from stgcn_tpu.train.metrics import evaluate_metrics as jax_evaluate_metrics
from stgcn_tpu_torch.data import ForecastDataset, ZScoreScaler, gather_windows
from stgcn_tpu_torch.nn.fused_sparse import fused_sparse_forward
from stgcn_tpu_torch.train import evaluate_metrics
from tests.torch_parity_utils import GATE_CASES, V, setup_model, t

TOL = 2e-4  # fused vs unfused, the JAX package's own bound (tests/test_vertex_fused.py:49)


@pytest.mark.parametrize("gct,ks,act", GATE_CASES)
def test_fused_forward_matches_jax(gct, ks, act):
    jm, jop, jparams, tm, top, x = setup_model(gct, ks, act)
    with torch.no_grad():
        got = fused_sparse_forward(tm.state_dict(), t(x), top, tm).numpy()
    ref_fused = np.asarray(jax_fused_sparse_forward(jparams, jnp.asarray(x), jop, jm,
                                                    deterministic=True, interpret=True))
    ref_apply = np.asarray(jm.apply({"params": jparams}, jnp.asarray(x), jop,
                                    deterministic=True))
    assert got.shape == ref_apply.shape == (x.shape[0], 1, V, 1)
    np.testing.assert_allclose(got, ref_fused, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, ref_apply, atol=TOL, rtol=TOL)


def test_fused_forward_falls_back_above_ks3():
    jm, jop, jparams, tm, top, x = setup_model("cheb_graph_conv", 4, "glu")
    with torch.no_grad():
        got = fused_sparse_forward(tm.state_dict(), t(x), top, tm).numpy()
    ref = np.asarray(jm.apply({"params": jparams}, jnp.asarray(x), jop, deterministic=True))
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_fused_forward_training_mode_not_ported():
    """A graph operator with none of the surfaces of the ported operators
    (the dense cv one, the nv one of the banded and blocked-ELL operators,
    the vn one of the BCSR operator) raises instead of running."""
    _, _, _, tm, top, x = setup_model()

    class SparseStandIn:
        v_pad = top.v_pad

    with pytest.raises(NotImplementedError,
                       match="only the dense, banded, ELL and BCSR graph operators are ported"):
        fused_sparse_forward(dict(tm.named_parameters()), t(x), SparseStandIn(), tm,
                             deterministic=False, seed=1)


def test_fused_forward_training_needs_seed_and_droprate0_is_deterministic():
    """Without the step's dropout seed training mode refuses to guess one,
    and with a droprate of 0 it is the deterministic forward."""
    _, _, _, tm, top, x = setup_model()
    with pytest.raises(ValueError, match="seed"):
        fused_sparse_forward(tm.state_dict(), t(x), top, tm, deterministic=False)
    tm.droprate = 0.0
    with torch.no_grad():
        got = fused_sparse_forward(tm.state_dict(), t(x), top, tm, deterministic=False)
        ref = fused_sparse_forward(tm.state_dict(), t(x), top, tm)
    assert torch.equal(got, ref)


def test_evaluate_metrics_matches_jax():
    jm, jop, jparams, tm, top, _ = setup_model()
    rng = np.random.default_rng(5)
    raw = rng.uniform(20.0, 70.0, size=(45, V))
    raw[3, 7] = 0.0  # a zero target exercises the MAPE guard
    scaler, jscaler = ZScoreScaler().fit(raw), JaxZScoreScaler().fit(raw)
    ds = ForecastDataset.from_numpy(scaler.transform(raw), 12, 3, device="cpu")
    jds = JaxForecastDataset(jnp.asarray(jscaler.transform(raw), jnp.float32), 12, 3)
    params = tm.state_dict()

    def predict(starts):
        x, y = gather_windows(ds.series, starts, 12, 3)
        with torch.no_grad():
            return fused_sparse_forward(params, x, top, tm).reshape(len(starts), -1), y

    def jax_predict(starts):
        x, y = jax_gather_windows(jds.series, starts, 12, 3)
        out = jm.apply({"params": jparams}, x, jop, deterministic=True)
        return out.reshape(len(starts), -1), y

    got = evaluate_metrics(predict, ds, scaler, batch_size=8)   # 30 windows: padded tail
    ref = jax_evaluate_metrics(jax_predict, jds, jscaler, batch_size=8)
    assert set(got) == set(ref) == {"MAE", "RMSE", "WMAPE", "MAPE"}
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5)


def test_dense_op_surfaces_match_jax():
    """DenseGraphOp's channels-last call and its cv / nv surfaces (padded
    lanes zero in and out) equal the JAX DenseGraphOp's."""
    _, jop, _, _, top, _ = setup_model()
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 3, V, 5)).astype(np.float32)
    np.testing.assert_allclose(top(t(x), scale=2.0).numpy(),
                               np.asarray(jop(jnp.asarray(x), scale=2.0)), atol=1e-5)
    assert top.v_pad == jop.v_pad == 256
    x_cv = np.zeros((2, 3, 5, top.v_pad), np.float32)
    x_cv[..., :V] = x.transpose(0, 1, 3, 2)
    for got, ref in zip(top.cheb_pair_cv(t(x_cv)), jop.cheb_pair_cv(jnp.asarray(x_cv))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
        assert float(got[..., V:].abs().max()) == 0.0
    x_nv = x_cv.reshape(-1, top.v_pad)
    np.testing.assert_allclose(top.apply_nv(t(x_nv), scale=0.5).numpy(),
                               np.asarray(jop.apply_nv(jnp.asarray(x_nv), scale=0.5)), atol=1e-5)
    for got, ref in zip(top.cheb_pair_nv(t(x_nv)), jop.cheb_pair_nv(jnp.asarray(x_nv))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_masked_mse_and_evaluate_mse_match_jax():
    from stgcn_tpu.train.metrics import evaluate_mse as jax_evaluate_mse
    from stgcn_tpu.train.metrics import masked_mse as jax_masked_mse
    from stgcn_tpu_torch.train import evaluate_mse, masked_mse

    rng = np.random.default_rng(6)
    pred, target = rng.standard_normal((2, 8, 10)).astype(np.float32)
    for n_valid in (8, 5, 1):
        np.testing.assert_allclose(float(masked_mse(t(pred), t(target), n_valid)),
                                   float(jax_masked_mse(jnp.asarray(pred), jnp.asarray(target),
                                                        n_valid)), rtol=1e-6)
    series = rng.standard_normal((40, 10))
    ds = ForecastDataset.from_numpy(series, 12, 3, device="cpu")
    jds = JaxForecastDataset(jnp.asarray(series, jnp.float32), 12, 3)
    got = evaluate_mse(lambda s, n: masked_mse(t(pred)[: len(s)], t(target)[: len(s)], n),
                       ds, 8)
    ref = jax_evaluate_mse(lambda s, n: jax_masked_mse(jnp.asarray(pred)[: len(s)],
                                                       jnp.asarray(target)[: len(s)], n),
                           jds, 8)
    np.testing.assert_allclose(got, ref, rtol=1e-6)
