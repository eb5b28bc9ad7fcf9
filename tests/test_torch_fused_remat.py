"""Fused training in bf16 on the nv operators, and the fused route's remat:

- the bf16 model's ``fused_sparse_forward`` (K1f-K4f's bf16 variants around
  K5's or K6's) on the banded operator with its nv pack and on the ELL
  operator over float32 and int8 tiles: its forecast and its parameter
  gradients against JAX ``fused_sparse_forward(use_pallas="xla")`` of the
  bf16 model and ``jax.grad`` of it (forecast atol 0.1 / rtol 0.05,
  gradients 0.2 relative L2: the bounds of the dense and BCSR routes,
  ``tests/test_torch_fused_bf16_slice.py``, ``tests/test_torch_fused_bf16_bwd.py``);
- ``fused_sparse_forward(remat=True, remat_policy=…)``: the gradients under
  each policy bit-equal to the plain route's, float32 and bf16, dropout on;
  what each keeps for the backward; within 2e-5 of JAX
  ``fused_sparse_forward(use_pallas="xla", remat=True, remat_policy=…)`` in
  float32;
- the ``Trainer`` and the CLI: ``fused=True, compute_dtype="bfloat16",
  remat=True`` on every operator kind; three fused bf16 steps on the ELL
  operator within rtol 0.08 of the float32 ones.

V = 520 (RCM-ordered, block size 128) for the banded and ELL operators,
V = 150 for the dense one, B = 3; everything runs the plain versions.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from stgcn_tpu.data.synthetic import random_road_graph as jax_random_road_graph
from stgcn_tpu.kernels import vertex_fused as jvf
from stgcn_tpu.nn.fused_sparse import fused_sparse_forward as jax_fused_sparse_forward
from stgcn_tpu.nn.model import STGCN as JaxSTGCN
from stgcn_tpu.ops.graph_op import banded_graph_op as jax_banded_graph_op
from stgcn_tpu.ops.graph_op import ell_graph_op as jax_ell_graph_op
from stgcn_tpu_torch import kernels
from stgcn_tpu_torch.data import ForecastDataset, ZScoreScaler
from stgcn_tpu_torch.data import synthetic as TS
from stgcn_tpu_torch.data.synthetic import generate_synthetic_vel
from stgcn_tpu_torch.graph import build_gso
from stgcn_tpu_torch.kernels.dropout import step_seed
from stgcn_tpu_torch.nn.convert import params_from_jax, params_to_jax
from stgcn_tpu_torch.nn.fused_sparse import fused_sparse_forward
from stgcn_tpu_torch.nn.model import STGCN
from stgcn_tpu_torch.ops import banded_graph_op, bcsr_graph_op, dense_graph_op, ell_graph_op
from stgcn_tpu_torch.train import TrainConfig, Trainer
from tests.test_torch_fused_bf16_slice import _bdot_xla_f32
from tests.torch_parity_utils import B, V, assert_grads, banded_gsos, rand

tcli = importlib.import_module("stgcn_tpu_torch.cli.main")
BF16 = torch.bfloat16
V_SPARSE = 520
N_HIS = 12
BS = 128
FORECAST_ATOL, FORECAST_RTOL = 0.1, 0.05
GRAD_REL_L2 = 0.2
MODEL_TOL = 2e-5   # the float32 fused route against JAX (tests/test_vertex_fused.py:376)
NV_KINDS = {"banded": {}, "ell_f32": {}, "ell_int8": {"quantize": True}}


def _nv_ops(kind):
    """(JAX op, port op) of the banded operator with its nv pack, or the
    ELL one, float32 (or int8) values, V = 520 RCM-ordered."""
    _, jart, tart = banded_gsos(n=V_SPARSE, seed=3)
    if kind == "banded":
        return (jax_banded_graph_op(jart, block_size=BS, nv=True, use_pallas=False),
                banded_graph_op(tart, block_size=BS, nv=True, device="cpu"))
    return (jax_ell_graph_op(jart, block_size=BS, use_pallas=False, **NV_KINDS[kind]),
            ell_graph_op(tart, block_size=BS, device="cpu", **NV_KINDS[kind]))


def _rel_l2(g, r) -> float:
    return float(torch.linalg.vector_norm(g.float() - r.float()) / torch.linalg.vector_norm(r))


@pytest.mark.parametrize("kind", list(NV_KINDS))
def test_fused_bf16_forecast_and_grads_match_jax(kind, monkeypatch):
    """The bf16 model through ``fused_sparse_forward`` on the nv operator
    (K5's bf16 variant over float32 slabs, K6's over float32 or int8 tiles):
    the forecast against the JAX bf16 model's ``use_pallas="xla"`` forward
    with the same weights, and every parameter's float32 gradient against
    ``jax.grad`` of it; no kernel launched on the CPU."""
    monkeypatch.setattr(jvf, "_bdot_xla", _bdot_xla_f32)
    jop, top = _nv_ops(kind)
    rng = np.random.default_rng(31)
    x, ct = rand(rng, B, N_HIS, V_SPARSE, 1), rand(rng, B, 1, V_SPARSE, 1)
    tm = STGCN(N_HIS, V_SPARSE, dtype=BF16, device="cpu",
               generator=torch.Generator().manual_seed(32))
    jm = JaxSTGCN(n_his=N_HIS, dtype=jnp.bfloat16)

    def jfwd(p):
        return jax_fused_sparse_forward(p, jnp.asarray(x), jop, jm, deterministic=True,
                                        use_pallas="xla")

    jparams = params_to_jax(tm)
    ref = jax.jit(jfwd)(jparams)
    jgrad = jax.jit(jax.grad(lambda p: jnp.sum(jfwd(p) * ct)))(jparams)
    kernels.reset_launch_counts()
    params = dict(tm.named_parameters())
    out = fused_sparse_forward(params, torch.from_numpy(x), top, tm)
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), list(params.values()))
    assert not any(kernels.launch_counts().values())
    assert out.dtype == torch.float32 and out.shape == ref.shape == (B, 1, V_SPARSE, 1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=FORECAST_ATOL,
                               rtol=FORECAST_RTOL)
    ref_g = params_from_jax(jax.device_get(jgrad))
    assert set(ref_g) == set(params)
    errs = {name: _rel_l2(g, ref_g[name]) for name, g in zip(params, grads)}
    assert all(g.dtype == torch.float32 for g in grads)
    assert max(errs.values()) <= GRAD_REL_L2, errs


def _step_grads(tm, params, x, y, gop, **kw):
    """(loss, gradients, bytes and count of the tensors autograd saved
    outside a checkpoint) of one training step with dropout on."""
    saved = {"bytes": 0, "count": 0}

    def pack(t):
        saved["bytes"] += t.numel() * t.element_size()
        saved["count"] += 1
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        pred = fused_sparse_forward(params, x, gop, tm, deterministic=False,
                                    seed=step_seed(5, 2), **kw)
    loss = ((pred - y) ** 2).mean()
    return loss, torch.autograd.grad(loss, list(params.values())), saved


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("kind", ["banded", "ell_int8"])
def test_remat_policies_give_the_plain_gradients(kind, dtype):
    """``remat=True`` under ``"graph-terms"`` and ``"minimal"``, dropout on:
    the loss and every gradient bit-equal to the plain route's (the masks
    are keyed by element, and the replay runs the same kernels on the same
    inputs). ``"graph-terms"`` keeps what the plain route keeps (every
    Function saves only its inputs, ``xg`` and the graph terms among them);
    ``"minimal"`` keeps less: the blocks' insides are recomputed."""
    _, top = _nv_ops(kind)
    rng = np.random.default_rng(33)
    x = torch.from_numpy(rand(rng, B, N_HIS, V_SPARSE, 1))
    y = torch.from_numpy(rand(rng, B, 1, V_SPARSE, 1))
    tm = STGCN(N_HIS, V_SPARSE, dtype=None if dtype == torch.float32 else dtype, device="cpu",
               generator=torch.Generator().manual_seed(34))
    params = dict(tm.named_parameters())
    loss, grads, saved = _step_grads(tm, params, x, y, top)
    for policy in ("graph-terms", "minimal"):
        l2, g2, s2 = _step_grads(tm, params, x, y, top, remat=True, remat_policy=policy)
        assert torch.equal(loss, l2), policy
        for name, a, b in zip(params, grads, g2):
            assert torch.equal(a, b), (policy, name)
        if policy == "graph-terms":
            assert s2 == saved
        else:
            assert s2["bytes"] < saved["bytes"] and s2["count"] < saved["count"]


@pytest.mark.parametrize("policy", ["graph-terms", "minimal"])
def test_remat_matches_jax(policy):
    """In float32 the remat gradients (ELL operator, K6's plain version)
    within 2e-5 of ``jax.grad`` of JAX ``fused_sparse_forward(use_pallas=
    "xla", remat=True, remat_policy=…)`` with the same weights; the model's
    ``remat`` is what ``remat=None`` takes."""
    jop, top = _nv_ops("ell_f32")
    rng = np.random.default_rng(35)
    x, ct = rand(rng, B, N_HIS, V_SPARSE, 1), rand(rng, B, 1, V_SPARSE, 1)
    tm = STGCN(N_HIS, V_SPARSE, remat=True, device="cpu",
               generator=torch.Generator().manual_seed(36))
    jm = JaxSTGCN(n_his=N_HIS)
    jgrad = jax.jit(jax.grad(lambda p: jnp.sum(jax_fused_sparse_forward(
        p, jnp.asarray(x), jop, jm, deterministic=True, use_pallas="xla", remat=True,
        remat_policy=policy) * ct)))(params_to_jax(tm))
    ref = params_from_jax(jax.device_get(jgrad))
    params = dict(tm.named_parameters())
    out = fused_sparse_forward(params, torch.from_numpy(x), top, tm, remat_policy=policy)
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), list(params.values()))
    assert_grads([g.numpy() for g in grads], [ref[n].numpy() for n in params], atol=MODEL_TOL)


def test_remat_policy_is_checked():
    _, top = _nv_ops("ell_f32")
    tm = STGCN(N_HIS, V_SPARSE, device="cpu")
    with pytest.raises(ValueError, match="remat_policy 'everything'"):
        fused_sparse_forward(tm.state_dict(), torch.zeros(1, N_HIS, V_SPARSE, 1), top, tm,
                             remat=True, remat_policy="everything")


def _trainer(tmp_path, gop, v, *, dtype=None, remat=False, tag=""):
    adj = jax_random_road_graph(v, k_neighbors=4, seed=11)
    vel = generate_synthetic_vel(adj, 23, seed=12)
    scaler = ZScoreScaler().fit(vel)
    ds = ForecastDataset.from_numpy(scaler.transform(vel), N_HIS, 3, device="cpu")
    model = STGCN(N_HIS, v, dtype=dtype, remat=remat, device="cpu",
                  generator=torch.Generator().manual_seed(9))
    cfg = TrainConfig(n_his=N_HIS, n_pred=3, batch_size=B, seed=3, fused=True, remat=remat,
                      compute_dtype="bfloat16" if dtype is not None else None,
                      ckpt_dir=str(tmp_path / f"{dtype}{remat}{tag}"), dataset_name="toy")
    return Trainer(cfg, model, gop, ds, ds, ds, scaler, device="cpu")


def test_fused_bf16_trainer_steps_on_ell_match_f32(tmp_path):
    """Three fused bf16 ``Trainer`` steps on the ELL operator (K6's bf16
    variant over float32 tiles, dropout on) from the same weights as three
    fused float32 steps: the losses within rtol 0.08; the parameters and the
    optimizer state stay float32."""
    _, top = _nv_ops("ell_f32")

    def run(dtype):
        tr = _trainer(tmp_path, top, V_SPARSE, dtype=dtype)
        losses = [float(tr.train_step(starts, n, i))
                  for i, (starts, n) in enumerate(tr._plan(tr.train_ds))]
        assert all(p.dtype == torch.float32 for p in tr.params.values())
        assert all(m.dtype == torch.float32 for m in tr.opt_state["mu"].values())
        return losses

    l16, l32 = run(BF16), run(None)
    assert len(l16) == 3 and np.isfinite(l16).all()
    np.testing.assert_allclose(l16, l32, rtol=0.08)


def test_fused_bf16_remat_trainer_runs_on_every_operator(tmp_path):
    """``Trainer(TrainConfig(fused=True, compute_dtype="bfloat16",
    remat=True))`` builds and takes a finite step on every operator kind the
    fused route takes: dense, banded with its nv pack, ELL over float32,
    int8 and bf16 tiles, BCSR; its losses equal those of the same trainer
    without remat (the default policy keeps what the plain route keeps)."""
    _, _, tart = banded_gsos(n=V_SPARSE, seed=3)
    adj = jax_random_road_graph(V, k_neighbors=4, seed=0)
    ops = {"dense": (dense_graph_op(build_gso(adj, "sym_norm_lap", cheb=True), device="cpu"), V),
           "banded": (banded_graph_op(tart, block_size=BS, nv=True, device="cpu"), V_SPARSE),
           "ell_f32": (ell_graph_op(tart, block_size=BS, device="cpu"), V_SPARSE),
           "ell_int8": (ell_graph_op(tart, block_size=BS, quantize=True, device="cpu"),
                        V_SPARSE),
           "ell_bf16": (ell_graph_op(tart, block_size=BS, dtype=BF16, device="cpu"), V_SPARSE),
           "bcsr": (bcsr_graph_op(tart, block_size=BS, device="cpu"), V_SPARSE)}
    for kind, (gop, v) in ops.items():
        losses = []
        for remat in (True, False):
            tr = _trainer(tmp_path, gop, v, dtype=BF16, remat=remat, tag=kind)
            starts, n_valid = tr._plan(tr.train_ds)[0]
            losses.append(float(tr.train_step(starts, n_valid, 0)))
        assert np.isfinite(losses[0]) and losses[0] == losses[1], (kind, losses)


def _toy_cli_data(tmp_path):
    (tmp_path / "toy").mkdir()
    sp.save_npz(tmp_path / "toy" / "adj.npz", TS.random_road_graph(200, k_neighbors=4, seed=2))
    TS.ensure_vel("toy", str(tmp_path), seed=1, n_steps=120)


@pytest.mark.parametrize("graph_op,flags", [("banded", ["--remat", "True"])])
def test_cli_trains_fused_bf16_on_nv_operators(tmp_path, capsys, graph_op, flags):
    """``--fused True --compute_dtype bfloat16 --remat True`` on the banded
    operator (packed with its nv family for K5): one epoch on the CPU, then
    the reference test line with finite metrics."""
    _toy_cli_data(tmp_path)
    mets = tcli.main(["--dataset", "toy", "--data_root", str(tmp_path), "--graph_op", graph_op,
                      "--fused", "True", "--compute_dtype", "bfloat16", *flags, "--epochs", "1",
                      "--batch_size", "8", "--platform", "cpu", "--ckpt_dir",
                      str(tmp_path / "ck")])
    out = capsys.readouterr().out.strip().splitlines()
    assert any(line.startswith("Epoch: 001 |") for line in out)
    assert out[-1].startswith("Dataset toy | Test loss ") and "| WMAPE " in out[-1]
    assert all(np.isfinite(v) for v in mets.values())


def test_cli_builds_fused_bf16_trainer_on_ell_int8(tmp_path):
    """The CLI's assembly of ``--graph_op ell_int8 --fused True
    --compute_dtype bfloat16``: a fused bf16 ``Trainer`` over the int8 ELL
    operator (K6) whose first step is finite and launches nothing on the
    CPU (the full epoch through ``main`` runs on the banded operator above)."""
    _toy_cli_data(tmp_path)
    args = tcli.get_parameters(["--dataset", "toy", "--data_root", str(tmp_path), "--graph_op",
                                "ell_int8", "--fused", "True", "--compute_dtype", "bfloat16",
                                "--batch_size", "8", "--platform", "cpu", "--ckpt_dir",
                                str(tmp_path / "ck")])
    cfg = tcli.config_from_args(args)
    tr = tcli.build_trainer(cfg, dataset="toy", data_root=str(tmp_path), graph_op_kind="ell_int8",
                            device="cpu")
    assert cfg.fused and cfg.compute_dtype == "bfloat16" and tr.model.dtype == BF16
    assert type(tr.gop).__name__ == "EllGraphOp" and tr.gop.pack.quantized
    kernels.reset_launch_counts()
    starts, n_valid = tr._plan(tr.train_ds)[0]
    assert np.isfinite(float(tr.train_step(starts, n_valid, 0)))
    assert not any(kernels.launch_counts().values())
