"""More of ``tests/test_torch_bcsr.py``'s tests: each port test file holds at most
20 collected tests. Helpers, constants and fixtures come from there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgcn_tpu.data import datasets as JD
from stgcn_tpu.data.synthetic import generate_synthetic_vel
from stgcn_tpu.nn.fused_sparse import fused_sparse_forward as jax_fused_sparse_forward
from stgcn_tpu.nn.model import STGCN as JaxSTGCN
from stgcn_tpu.ops.graph_op import bcsr_graph_op as jax_bcsr_graph_op
from stgcn_tpu.train.loop import TrainConfig as JaxTrainConfig
from stgcn_tpu.train.loop import Trainer as JaxTrainer
from stgcn_tpu_torch.data import ForecastDataset, ZScoreScaler
from stgcn_tpu_torch.graph import build_gso, rcm_ordering
from stgcn_tpu_torch.nn.convert import params_from_jax
from stgcn_tpu_torch.nn.fused_sparse import fused_sparse_forward
from stgcn_tpu_torch.nn.model import STGCN
from stgcn_tpu_torch.ops import bcsr_graph_op
from stgcn_tpu_torch.train import TrainConfig, Trainer
from tests.torch_parity_utils import BANDED_V as V
from tests.torch_parity_utils import GATE_CASES, B, assert_grads, banded_gsos, rand, t, to_np
from tests.test_torch_bcsr import (
    BS,
    FUSED_TOL,
    MODEL_TOL,
    N_HIS,
    N_PRED,
    T_STEPS,
    V_FUSED,
    _ops,
)


@pytest.mark.parametrize("gct,ks,act", GATE_CASES)
def test_forward_and_grads_on_bcsr_op_match_jax(gct, ks, act):
    """The unfused model (the Cheb layer's generic route: ``gop(x)``, then
    ``gop(t1, scale=2.0) − x``; K10 plain version) against JAX
    ``model.apply``, forward and every parameter's gradient; the fused
    forward's vn branch (K1-K4 around K10, plain versions) against JAX
    ``fused_sparse_forward(use_pallas="xla")`` on the same op. V = 520:
    the operator pads to 576 rows, the fused lanes to 640."""
    jop, top = _ops(n=V_FUSED, seed=3, cheb=gct == "cheb_graph_conv")
    jm = JaxSTGCN(n_his=N_HIS, ks=ks, graph_conv_type=gct, act_func=act)
    rng = np.random.default_rng(1)
    x, y = rand(rng, B, N_HIS, V_FUSED, 1), rand(rng, B, 1, V_FUSED, 1)
    jparams = to_np(jm.init(jax.random.PRNGKey(3), jnp.asarray(x), jop,
                            deterministic=True)["params"])
    tm = STGCN(N_HIS, V_FUSED, ks=ks, graph_conv_type=gct, act_func=act, device="cpu")
    tm.load_state_dict(params_from_jax(jparams))

    def jloss(p):
        pred = jm.apply({"params": p}, jnp.asarray(x), jop, deterministic=True)
        return jnp.mean((pred - jnp.asarray(y)) ** 2), pred

    (_, ref), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    ref_fused = jax_fused_sparse_forward(jparams, jnp.asarray(x), jop, jm, deterministic=True,
                                         use_pallas="xla")
    params = dict(tm.named_parameters())
    got = tm(t(x), top)
    grads = torch.autograd.grad(((got - t(y)) ** 2).mean(), list(params.values()))
    with torch.no_grad():
        got_fused = fused_sparse_forward(tm.state_dict(), t(x), top, tm)
    assert got.shape == got_fused.shape == ref.shape == (B, 1, V_FUSED, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=MODEL_TOL,
                               rtol=MODEL_TOL)
    want = params_from_jax(to_np(jgrads))
    assert set(want) == set(params)
    assert_grads([g.numpy() for g in grads], [want[k].numpy() for k in params], atol=MODEL_TOL)
    np.testing.assert_allclose(got_fused.numpy(), np.asarray(ref_fused), atol=FUSED_TOL,
                               rtol=FUSED_TOL)
    np.testing.assert_allclose(got_fused.numpy(), np.asarray(ref), atol=FUSED_TOL,
                               rtol=FUSED_TOL)


@pytest.mark.parametrize("kind", ["dense", "banded", "ell", "bcsr"])
@pytest.mark.parametrize("one", [False, True])
def test_graph_terms_are_contiguous_cv(kind, one):
    """The fused forward's graph terms reach K2 in the contiguous cv layout
    ``[B, T, C, Vp]`` on every operator surface (the CUDA kernel refuses a
    strided operand; the plain versions on the CPU would not notice): the
    cv (dense), nv (banded, ELL) and vn (BCSR, two transposes) branches;
    ``one`` is the one-term case (``graph_conv``, Ks = 2)."""
    from stgcn_tpu_torch.kernels.vertex_fused import VertexBlockCfg
    from stgcn_tpu_torch.nn.fused_sparse import _graph_terms, _op_pad
    from stgcn_tpu_torch.ops import make_graph_op

    _, _, tart = banded_gsos()
    gop = make_graph_op(tart, kind, device="cpu")
    v_pad = -(-_op_pad(gop) // 128) * 128
    cfg = VertexBlockCfg(kt=3, ks=2 if one else 3, act_func="glu",
                         graph_conv_type="cheb_graph_conv", v_true=V, v_pad=v_pad, t_in=8,
                         c_in=16, c0=16, c1=8, c2=16, apply_ln=False)
    xg = torch.nn.functional.pad(t(rand(np.random.default_rng(3), B, 6, 8, V)),
                                 (0, v_pad - V))
    for term in _graph_terms(cfg, gop, xg):
        assert term.shape == xg.shape and term.is_contiguous()
        assert float(term[..., V:].abs().max()) == 0.0


def test_unfused_trajectory_on_bcsr_op_matches_jax_trainer(tmp_path):
    """2 unfused epochs on the BCSR operator, droprate 0, from the same
    weights: the port's Trainer against the JAX one at rtol 2e-4
    (tests/test_torch_train.py)."""
    adj, jart, tart = banded_gsos(n=V_FUSED, seed=3)
    perm = rcm_ordering(build_gso(adj, "sym_norm_lap", cheb=True).matrix)
    vel = generate_synthetic_vel(adj, T_STEPS, seed=12)[:, perm]
    jscaler = JD.ZScoreScaler()
    jseries = jscaler.fit_transform(vel).astype(np.float32)
    jds = lambda a: JD.ForecastDataset(jnp.asarray(a), N_HIS, N_PRED)  # noqa: E731
    jcfg = JaxTrainConfig(n_his=N_HIS, n_pred=N_PRED, droprate=0.0, batch_size=B,
                          ckpt_dir=str(tmp_path / "jax"), dataset_name="toy")
    jop = jax_bcsr_graph_op(jart, block_size=BS, use_pallas=False)
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
    model = STGCN(N_HIS, V_FUSED, droprate=0.0, device="cpu")
    model.load_state_dict(state)
    cfg = TrainConfig(n_his=N_HIS, n_pred=N_PRED, droprate=0.0, batch_size=B,
                      ckpt_dir=str(tmp_path / "port"), dataset_name="toy")
    tr = Trainer(cfg, model, bcsr_graph_op(tart, block_size=BS, device="cpu"), ds(series),
                 ds(series[:20]), ds(series[:20]), scaler, device="cpu")
    got = []
    for _ in range(2):
        got.append(tr.train_epoch())
        tr.epoch += 1
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
