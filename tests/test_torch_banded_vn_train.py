"""Training on the vn banded operator and the int8 banded operator: the
unfused model's forward and parameter gradients on ``banded`` (stream and
clamped packs) and ``banded_int8`` against JAX ``model.apply`` /
``jax.grad``, the fused forward on ``banded_int8`` (K5 int8 or K9 int8)
against ``fused_sparse_forward(use_pallas="xla")``, and 2-epoch unfused
training trajectories against the JAX ``Trainer``. V = 520 (5 block rows of
128), RCM-ordered, B = 3; the JAX side runs its off-TPU branches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgcn_tpu.data import datasets as JD
from stgcn_tpu.data.synthetic import generate_synthetic_vel
from stgcn_tpu.nn.fused_sparse import fused_sparse_forward as jax_fused_sparse_forward
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
from tests.test_torch_banded_vn import OP_KW, _ops
from tests.torch_parity_utils import B, assert_grads, banded_gsos, rand, t, to_np

MODEL_TOL = 2e-5    # unfused model (tests/test_vertex_fused.py:376)
FUSED_TOL = 2e-4    # fused forward (tests/test_vertex_fused.py:381)
V_TRAIN = 520
T_STEPS, N_HIS, N_PRED = 23, 12, 3   # 8 training windows: 2 full batches of 3 and a tail


def _model_case(kind, gct="cheb_graph_conv", ks=3, act="glu"):
    jop, top = _ops(bs=128, n=V_TRAIN, seed=3, cheb=gct == "cheb_graph_conv", **OP_KW[kind])
    jm = JaxSTGCN(n_his=N_HIS, ks=ks, graph_conv_type=gct, act_func=act)
    rng = np.random.default_rng(1)
    x, y = rand(rng, B, N_HIS, V_TRAIN, 1), rand(rng, B, 1, V_TRAIN, 1)
    jparams = to_np(jm.init(jax.random.PRNGKey(3), jnp.asarray(x), jop,
                            deterministic=True)["params"])
    tm = STGCN(N_HIS, V_TRAIN, ks=ks, graph_conv_type=gct, act_func=act, device="cpu")
    tm.load_state_dict(params_from_jax(jparams))
    return jm, jop, jparams, tm, top, x, y


@pytest.mark.parametrize("kind,gct,ks", [("stream", "cheb_graph_conv", 3),
                                         ("int8", "cheb_graph_conv", 3),
                                         ("clamped", "cheb_graph_conv", 3),
                                         ("int8", "graph_conv", 3),
                                         ("stream", "cheb_graph_conv", 2)])
def test_unfused_forward_and_grads_match_jax(kind, gct, ks):
    """The unfused model (Cheb Ks=3 through ``cheb_pair``: K9 on the stream
    packs, K8 on the clamped one; Ks=2 and graph_conv through ``gop(x)``:
    K7) against JAX ``model.apply``, forward and every parameter's
    gradient."""
    jm, jop, jparams, tm, top, x, y = _model_case(kind, gct, ks)

    def jloss(p):
        pred = jm.apply({"params": p}, jnp.asarray(x), jop, deterministic=True)
        return jnp.mean((pred - jnp.asarray(y)) ** 2), pred

    (_, ref), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    params = dict(tm.named_parameters())
    got = tm(t(x), top)
    grads = torch.autograd.grad(((got - t(y)) ** 2).mean(), list(params.values()))
    assert got.shape == ref.shape == (B, 1, V_TRAIN, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=MODEL_TOL,
                               rtol=MODEL_TOL)
    want = params_from_jax(to_np(jgrads))
    assert set(want) == set(params)
    assert_grads([g.numpy() for g in grads], [want[k].numpy() for k in params], atol=MODEL_TOL)


@pytest.mark.parametrize("kind", ["int8_nv", "int8"])
def test_fused_forward_int8_matches_jax(kind):
    """The fused forward on ``banded_int8``: K1-K4 around K5 int8 (the nv
    pack, as the CLI builds it under ``--fused``) or around K9 int8 (the vn
    branch), against JAX ``fused_sparse_forward(use_pallas="xla")`` on the
    same op and against the unfused model."""
    jm, jop, jparams, tm, top, x, _ = _model_case(kind)
    ref = np.asarray(jax_fused_sparse_forward(jparams, jnp.asarray(x), jop, jm,
                                              deterministic=True, use_pallas="xla"))
    with torch.no_grad():
        got = fused_sparse_forward(tm.state_dict(), t(x), top, tm).numpy()
        unfused = tm(t(x), top).numpy()
    np.testing.assert_allclose(got, ref, atol=FUSED_TOL, rtol=FUSED_TOL)
    np.testing.assert_allclose(got, unfused, atol=FUSED_TOL, rtol=FUSED_TOL)


@pytest.mark.parametrize("kind", ["stream", "int8"])
def test_unfused_trajectory_matches_jax_trainer(kind, tmp_path):
    """2 unfused epochs on ``banded`` (K9 f32) and ``banded_int8`` (K9
    int8), droprate 0, from the same weights: the port's Trainer against
    the JAX one at rtol 2e-4 (tests/test_torch_train.py)."""
    adj, jart, tart = banded_gsos(n=V_TRAIN, seed=3)
    perm = rcm_ordering(build_gso(adj, "sym_norm_lap", cheb=True).matrix)
    vel = generate_synthetic_vel(adj, T_STEPS, seed=12)[:, perm]
    jscaler = JD.ZScoreScaler()
    jseries = jscaler.fit_transform(vel).astype(np.float32)
    jds = lambda a: JD.ForecastDataset(jnp.asarray(a), N_HIS, N_PRED)  # noqa: E731
    jcfg = JaxTrainConfig(n_his=N_HIS, n_pred=N_PRED, droprate=0.0, batch_size=B,
                          ckpt_dir=str(tmp_path / "jax"), dataset_name="toy")
    jop = jax_banded_graph_op(jart, block_size=128, use_pallas=False, **OP_KW[kind])
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
    cfg = TrainConfig(n_his=N_HIS, n_pred=N_PRED, droprate=0.0, batch_size=B,
                      ckpt_dir=str(tmp_path / "port"), dataset_name="toy")
    top = banded_graph_op(tart, block_size=128, device="cpu", **OP_KW[kind])
    tr = Trainer(cfg, model, top, ds(series), ds(series[:20]), ds(series[:20]), scaler,
                 device="cpu")
    got = []
    for _ in range(2):
        got.append(tr.train_epoch())
        tr.epoch += 1
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
