"""The port's Trainer against the JAX package's: a 3-epoch deterministic
trajectory (droprate 0) on the unfused and the fused route, from the same
weights, at the bound of ``tests/test_train.py:155-185``; resume exactness
with dropout on; and the trainer's refusals and test report."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgcn_tpu.data import datasets as JD
from stgcn_tpu.data.synthetic import generate_synthetic_vel, random_road_graph
from stgcn_tpu.graph import build_gso as jax_build_gso
from stgcn_tpu.nn.model import STGCN as JaxSTGCN
from stgcn_tpu.ops import dense_graph_op as jax_dense_graph_op
from stgcn_tpu.train.loop import TrainConfig as JaxTrainConfig
from stgcn_tpu.train.loop import Trainer as JaxTrainer
from stgcn_tpu_torch.data import ForecastDataset, ZScoreScaler
from stgcn_tpu_torch.graph import build_gso
from stgcn_tpu_torch.nn.convert import params_from_jax
from stgcn_tpu_torch.nn.model import STGCN
from stgcn_tpu_torch.ops import banded_graph_op, dense_graph_op
from stgcn_tpu_torch.train import TrainConfig, Trainer
from tests.torch_parity_utils import B, V, to_np

T_STEPS, N_HIS, N_PRED = 38, 12, 3   # 23 training windows: 7 full batches of 3 and a tail of 2


@pytest.fixture(scope="module")
def problem():
    adj = random_road_graph(V, k_neighbors=4, seed=11)
    vel = generate_synthetic_vel(adj, T_STEPS, seed=12)
    return adj, vel


def _port_trainer(problem, tmp_path, *, fused=False, droprate=0.0, state=None, dtype=None,
                  gop=None, **kw):
    adj, vel = problem
    scaler = ZScoreScaler().fit(vel)
    series = scaler.transform(vel)
    ds = lambda a: ForecastDataset.from_numpy(a, N_HIS, N_PRED, device="cpu")  # noqa: E731
    model = STGCN(N_HIS, V, droprate=droprate, dtype=dtype, device="cpu",
                  generator=torch.Generator().manual_seed(42))
    if state is not None:
        model.load_state_dict(state)
    cfg = TrainConfig(n_his=N_HIS, n_pred=N_PRED, droprate=droprate, batch_size=B,
                      fused=fused, ckpt_dir=str(tmp_path), dataset_name="toy", **kw)
    if gop is None:
        gop = dense_graph_op(build_gso(adj, "sym_norm_lap", cheb=True), device="cpu")
    return Trainer(cfg, model, gop, ds(series), ds(series[:20]), ds(series[:20]), scaler,
                   device="cpu")


def _epochs(tr, n):
    out = []
    for _ in range(n):
        out.append(tr.train_epoch())
        tr.epoch += 1
    return out


@pytest.fixture(scope="module")
def jax_run(problem, tmp_path_factory):
    """The JAX trainer's first weights and its 3-epoch train losses."""
    adj, vel = problem
    scaler = JD.ZScoreScaler()
    series = scaler.fit_transform(vel).astype(np.float32)
    ds = lambda a: JD.ForecastDataset(jnp.asarray(a), N_HIS, N_PRED)  # noqa: E731
    cfg = JaxTrainConfig(n_his=N_HIS, n_pred=N_PRED, droprate=0.0, batch_size=B,
                         ckpt_dir=str(tmp_path_factory.mktemp("jax")), dataset_name="toy")
    tr = JaxTrainer(cfg, JaxSTGCN(n_his=N_HIS, droprate=0.0),
                    jax_dense_graph_op(jax_build_gso(adj, "sym_norm_lap", cheb=True)),
                    ds(series), ds(series[:20]), ds(series[:20]), scaler)
    params = params_from_jax(to_np(jax.device_get(tr.params)))
    return params, _epochs(tr, 3)


@pytest.mark.parametrize("fused", [False, True])
def test_trajectory_matches_jax_trainer(problem, jax_run, tmp_path, fused):
    state, ref = jax_run
    tr = _port_trainer(problem, tmp_path, fused=fused, state=state)
    np.testing.assert_allclose(_epochs(tr, 3), ref, rtol=2e-4, atol=2e-5)


def test_resume_is_exact(problem, tmp_path):
    """fit(2) → resume → fit(4) equals an uninterrupted fit(4), dropout on."""
    tr1 = _port_trainer(problem, tmp_path / "a", droprate=0.5, shuffle=True)
    tr1.fit(2, log=False)
    tr2 = _port_trainer(problem, tmp_path / "a", droprate=0.5, shuffle=True)
    assert tr2.resume() and tr2.epoch == 2
    for k, p in tr1.params.items():
        assert torch.equal(p, tr2.params[k]), k
    hist2 = tr2.fit(4, log=False)["history"]
    tr3 = _port_trainer(problem, tmp_path / "b", droprate=0.5, shuffle=True)
    hist3 = tr3.fit(4, log=False)["history"]
    assert [h["train_loss"] for h in hist2] == [h["train_loss"] for h in hist3[2:]]
    for k, p in tr3.params.items():
        assert torch.equal(p, tr2.params[k]), k


def test_test_reports_the_reference_line(problem, tmp_path, capsys):
    tr = _port_trainer(problem, tmp_path, droprate=0.5)
    tr.fit(1, log=False)
    mets = tr.test()
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("Dataset toy | Test loss ") and "| MAE " in line and "| WMAPE " in line
    assert all(np.isfinite(v) for v in mets.values())


@pytest.mark.parametrize("field,value,match", [("compute_dtype", "bfloat16", "K5 / K6"),
                                               ("remat", True, "remat")])
def test_later_slices_raise(problem, tmp_path, field, value, match):
    """remat runs on the unfused model (tests/test_torch_remat.py) and the
    fused route refuses it until the fused bf16 slice; so it does bf16 on an
    operator whose graph terms run on K5 (the banded nv pack, here) or K6.
    On the dense and BCSR operators the fused route trains in bf16
    (tests/test_torch_fused_bf16_bwd.py)."""
    kw = {field: value}
    if field == "compute_dtype":
        gso = build_gso(problem[0], "sym_norm_lap", cheb=True)
        kw |= {"dtype": torch.bfloat16,
               "gop": banded_graph_op(gso, block_size=128, nv=True, device="cpu")}
    with pytest.raises(NotImplementedError, match=match):
        _port_trainer(problem, tmp_path, fused=True, **kw)


def test_mesh_raises(problem, tmp_path):
    tr = _port_trainer(problem, tmp_path)
    with pytest.raises(NotImplementedError, match="dist"):
        Trainer(tr.cfg, tr.model, tr.gop, tr.train_ds, tr.val_ds, tr.test_ds, tr.scaler,
                mesh=object(), device="cpu")
