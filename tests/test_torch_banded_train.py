"""Training on the banded operator: a 2-epoch trajectory of the port's
``Trainer`` (unfused and fused routes) against the JAX ``Trainer`` on its
nv_only banded operator, from the same weights, at the bound of
``tests/test_torch_train.py``; and the fused route's gradients (K1b-K4b and
K5 chain, plain versions) against the unfused model's with dropout on."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgcn_tpu.data import datasets as JD
from stgcn_tpu.data.synthetic import generate_synthetic_vel
from stgcn_tpu.nn.model import STGCN as JaxSTGCN
from stgcn_tpu.ops.graph_op import banded_graph_op as jax_banded_graph_op
from stgcn_tpu.train.loop import TrainConfig as JaxTrainConfig
from stgcn_tpu.train.loop import Trainer as JaxTrainer
from stgcn_tpu_torch.data import ForecastDataset, ZScoreScaler
from stgcn_tpu_torch.graph import build_gso, rcm_ordering
from stgcn_tpu_torch.nn.convert import params_from_jax
from stgcn_tpu_torch.nn.fused_sparse import fused_sparse_forward
from stgcn_tpu_torch.nn.model import STGCN
from stgcn_tpu_torch.ops import banded_graph_op
from stgcn_tpu_torch.train import TrainConfig, Trainer
from tests.torch_parity_utils import B, banded_gsos, rand, t, to_np

V_TRAIN = 520
T_STEPS, N_HIS, N_PRED = 38, 12, 3   # 23 training windows: 7 full batches of 3 and a tail


@pytest.mark.parametrize("fused", [False, True])
def test_trajectory_on_banded_op_matches_jax_trainer(fused, tmp_path):
    """2 epochs, droprate 0, rtol 2e-4 (tests/test_torch_train.py)."""
    adj, jart, tart = banded_gsos(n=V_TRAIN, seed=3)
    perm = rcm_ordering(build_gso(adj, "sym_norm_lap", cheb=True).matrix)
    vel = generate_synthetic_vel(adj, T_STEPS, seed=12)[:, perm]
    jscaler = JD.ZScoreScaler()
    jseries = jscaler.fit_transform(vel).astype(np.float32)
    jds = lambda a: JD.ForecastDataset(jnp.asarray(a), N_HIS, N_PRED)  # noqa: E731
    jcfg = JaxTrainConfig(n_his=N_HIS, n_pred=N_PRED, droprate=0.0, batch_size=B, fused=fused,
                          ckpt_dir=str(tmp_path / "jax"), dataset_name="toy")
    jop = jax_banded_graph_op(jart, block_size=128, use_pallas=False, nv=True, nv_only=True)
    jtr = JaxTrainer(jcfg, JaxSTGCN(n_his=N_HIS, droprate=0.0), jop, jds(jseries),
                     jds(jseries[:20]), jds(jseries[:20]), jscaler)
    state = params_from_jax(to_np(jax.device_get(jtr.params)))
    ref = []
    for _ in range(2):
        ref.append(jtr.train_epoch())
        jtr.epoch += 1

    scaler = ZScoreScaler().fit(vel)
    series = scaler.transform(vel)
    ds = lambda a: ForecastDataset.from_numpy(a, N_HIS, N_PRED, device="cpu")  # noqa: E731
    model = STGCN(N_HIS, V_TRAIN, droprate=0.0, device="cpu")
    model.load_state_dict(state)
    cfg = TrainConfig(n_his=N_HIS, n_pred=N_PRED, droprate=0.0, batch_size=B, fused=fused,
                      ckpt_dir=str(tmp_path / "port"), dataset_name="toy")
    top = banded_graph_op(tart, block_size=128, nv=True, nv_only=True, device="cpu")
    tr = Trainer(cfg, model, top, ds(series), ds(series[:20]), ds(series[:20]), scaler,
                 device="cpu")
    got = []
    for _ in range(2):
        got.append(tr.train_epoch())
        tr.epoch += 1
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)


def test_fused_gradients_on_banded_op_match_unfused():
    """One batch with dropout on, the same masks: relative L2 < 1e-4 and each
    element within 2e-4 + 2e-3·|ref| (tests/test_vertex_fused.py:52-74)."""
    _, _, tart = banded_gsos()
    top = banded_graph_op(tart, nv=True, nv_only=True, device="cpu")
    model = STGCN(N_HIS, tart.n_vertex, droprate=0.5, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    rng = np.random.default_rng(4)
    x, y = t(rand(rng, B, N_HIS, tart.n_vertex, 1)), t(rand(rng, B, tart.n_vertex))

    def grads(fused):
        pred = (fused_sparse_forward(params, x, top, model, deterministic=False, seed=77)
                if fused else model(x, top, deterministic=False, seed=77))
        loss = ((pred.reshape(B, -1) - y) ** 2).mean()
        return torch.autograd.grad(loss, list(params.values()))

    gf, gu = grads(True), grads(False)
    ff, fu = torch.cat([g.flatten() for g in gf]), torch.cat([g.flatten() for g in gu])
    assert float((ff - fu).norm() / fu.norm()) < 1e-4
    for a, b in zip(gf, gu):
        assert bool(((a - b).abs() <= 2e-4 + 2e-3 * b.abs()).all())
