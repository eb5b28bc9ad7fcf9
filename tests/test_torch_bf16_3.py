"""More of ``tests/test_torch_bf16.py``'s tests: each port test file holds at most
20 collected tests. Helpers, constants and fixtures come from there."""

import numpy as np
import pytest
import torch

from stgcn_tpu.data.synthetic import generate_synthetic_vel, random_road_graph
from stgcn_tpu_torch import kernels
from stgcn_tpu_torch.data import ForecastDataset, ZScoreScaler
from stgcn_tpu_torch.kernels import _build
from stgcn_tpu_torch.kernels import banded_spmm as tbs
from stgcn_tpu_torch.kernels import spmm as tsp
from stgcn_tpu_torch.nn.fused import fused_forward
from stgcn_tpu_torch.nn.fused_sparse import fused_sparse_forward
from stgcn_tpu_torch.nn.model import STGCN
from stgcn_tpu_torch.ops import banded_graph_op, bcsr_graph_op, ell_graph_op
from stgcn_tpu_torch.train import TrainConfig, Trainer
from tests.torch_parity_utils import B, V, banded_gsos
from tests.test_torch_bf16 import (
    BF16,
    N_HIS,
    N_PRED,
    T_STEPS,
    V_SPARSE,
    _FakeLib,
    _ops,
    tcli,
)


@pytest.mark.parametrize("slabs", [torch.float32, BF16, torch.int8])
@pytest.mark.parametrize("mode", ["single", "pair", "chain"])
def test_bf16_launch_names_and_flags(mode, slabs, monkeypatch):
    """A bf16 operand on a non-CPU tensor makes one C call of the vn kernel
    with the bf16 flag and the slabs' value type (float32 0, int8 1, bf16
    2), counted under the ``_bf16`` name; K10 the same under
    ``bcsr_spmm_bf16``. The outputs are bf16."""
    fake = _FakeLib()
    monkeypatch.setattr(_build, "library", lambda: fake)
    for mod in (tbs, tsp):
        monkeypatch.setattr(mod, "cuda_device", lambda t: t.device)
        monkeypatch.setattr(mod, "stream_of", lambda dev: 0)
    data = torch.zeros(2, 128, 256, dtype=slabs, device="meta")
    empty = torch.zeros(0, dtype=torch.int32, device="meta")
    index = kernels.nnz_index.NnzIndex().bind(
        data, torch.zeros(385, dtype=torch.int32, device="meta"), empty, empty)
    lo, x = torch.zeros(2, dtype=torch.int32, device="meta"), torch.zeros(384, 8, dtype=BF16,
                                                                          device="meta")
    q = slabs == torch.int8
    sc = torch.ones(2, 128, device="meta") if q else None
    wrapper = {"single": tbs.banded_spmm, "pair": tbs.banded_cheb_pair_stream,
               "chain": tbs.banded_chain_stream}[mode]
    name = tbs.launch_name(mode, q, bf16=True)
    before = kernels.launch_counts()[name]
    if mode == "chain":
        out = wrapper(data, lo, x, x, scales_t=sc, index_t=index)
    else:
        out = wrapper(data, lo, x, scales=sc, index=index)
    assert kernels.launch_counts()[name] == before + 1
    (c_name, args), = fake.calls
    assert c_name == "stgcn_banded_vn" and len(args) == len(_build.SIGNATURES[c_name])
    assert args[14:17] == ({torch.float32: 0, torch.int8: 1, BF16: 2}[slabs], 1,
                           tbs.MODES[mode])
    assert all(o.dtype == BF16 for o in ([out] if mode == "single" else out))

    if slabs != torch.int8:
        tiles = torch.zeros(3, 1, 128, 128, dtype=slabs, device="meta")
        pack = tsp.BcsrPack(tiles, torch.zeros(3, 1, dtype=torch.int32, device="meta"),
                            torch.ones(3, dtype=torch.int32, device="meta"),
                            kernels.nnz_index.NnzIndex().bind(
                                tiles, torch.zeros(385, dtype=torch.int32, device="meta"),
                                empty, empty))
        before = kernels.launch_counts()
        y = tsp.bcsr_spmm(pack, x, scale=2.0)
        after = kernels.launch_counts()
        assert after["bcsr_spmm_bf16"] == before["bcsr_spmm_bf16"] + 1
        assert after["bcsr_spmm"] == before["bcsr_spmm"] and y.dtype == BF16
        c_name, args = fake.calls[-1]
        assert c_name == "stgcn_bcsr_spmm" and len(args) == len(_build.SIGNATURES[c_name])
        assert args[10:12] == (int(slabs == BF16), 1)


@pytest.mark.parametrize("model_kw,cfg_kw", [({}, {"compute_dtype": "bfloat16"}),
                                              ({"dtype": BF16}, {}),
                                              ({"remat": True}, {}),
                                              ({"dtype": BF16}, {"compute_dtype": "bfloat16",
                                                                 "remat": True})])
def test_unfused_trainer_refuses_a_config_the_model_disagrees_with(tmp_path, model_kw, cfg_kw):
    """On the unfused route the model's ``dtype`` and ``remat`` decide how it
    trains, so a ``TrainConfig`` that says otherwise raises ``ValueError``
    rather than training in another precision without a word."""
    _, top, _ = _ops("dense")
    vel = np.zeros((T_STEPS, V), np.float32)
    ds = ForecastDataset.from_numpy(vel, N_HIS, N_PRED, device="cpu")
    cfg = TrainConfig(n_his=N_HIS, n_pred=N_PRED, ckpt_dir=str(tmp_path), **cfg_kw)
    with pytest.raises(ValueError, match="the model's fields decide"):
        Trainer(cfg, STGCN(N_HIS, V, device="cpu", **model_kw), top, ds, ds, ds,
                ZScoreScaler().fit(vel + 1.0), device="cpu")


def test_fused_route_refuses_bf16_and_remat(tmp_path):
    """``fused=True`` trains a bf16 model (and a float32 one with a bf16
    LayerNorm affine) on the dense operator, with and without remat: one
    step each, finite losses (tests/test_torch_fused_bf16_bwd.py and
    tests/test_torch_fused_remat.py hold them to the float32 steps and to
    JAX); a bf16 ``Trainer`` builds on an operator whose graph terms run on
    K5 (the banded nv pack) or K6 (ELL), whose ``cheb_pair`` gives bf16 on a
    bf16 operand; the CLI takes ``--fused True --remat True``. A float32
    model under ``compute_dtype="bfloat16"`` raises ``ValueError``, as on the
    unfused route. What the fused route still refuses raises
    ``NotImplementedError`` naming ``ROADMAP.md`` §1 item 4: ``fused_forward``
    (K12) of a bf16 model and the BCSR tile-value gradient (K11) on bf16;
    nothing falls back to float32."""
    jop, top, v = _ops("dense")
    adj = random_road_graph(V, k_neighbors=4, seed=11)
    vel = generate_synthetic_vel(adj, T_STEPS, seed=12)
    ds = ForecastDataset.from_numpy(ZScoreScaler().fit(vel).transform(vel), N_HIS, N_PRED,
                                    device="cpu")

    def trainer(model_kw, cfg_kw, gop=top, v_model=V):
        cfg = TrainConfig(n_his=N_HIS, n_pred=N_PRED, fused=True, batch_size=B,
                          ckpt_dir=str(tmp_path), **cfg_kw)
        return Trainer(cfg, STGCN(N_HIS, v_model, device="cpu", **model_kw), gop, ds, ds, ds,
                       ZScoreScaler().fit(vel), device="cpu")

    for model_kw, cfg_kw in (({"dtype": BF16}, {"compute_dtype": "bfloat16"}),
                             ({"ln_param_dtype": BF16}, {}),
                             ({"dtype": BF16, "remat": True},
                              {"compute_dtype": "bfloat16", "remat": True})):
        tr = trainer(model_kw, cfg_kw)
        starts, n_valid = tr._plan(tr.train_ds)[0]
        assert bool(torch.isfinite(tr.train_step(starts, n_valid, 0)))
    with pytest.raises(ValueError, match="the model's fields decide"):
        trainer({}, {"compute_dtype": "bfloat16"})
    args = tcli.get_parameters(["--dataset", "pemsd7-m", "--platform", "cpu", "--fused", "True",
                                "--remat", "True", "--compute_dtype", "bfloat16"])
    tcli.refuse_unported(args)
    cfg = tcli.config_from_args(args)
    assert cfg.fused and cfg.remat and cfg.compute_dtype == "bfloat16"
    model = STGCN(N_HIS, V, dtype=BF16, device="cpu")
    out = fused_sparse_forward(model.state_dict(), torch.zeros(1, N_HIS, V, 1), top, model)
    assert out.dtype == torch.float32 and out.shape == (1, 1, V, 1)
    assert bool(torch.isfinite(out).all())
    with pytest.raises(NotImplementedError, match=r"§1 item 4"):
        fused_forward(model.state_dict(), torch.zeros(1, N_HIS, V, 1), top, model)
    _, _, tart = banded_gsos(n=V_SPARSE, seed=3)
    nv_op = banded_graph_op(tart, block_size=128, nv=True, nv_only=True, device="cpu")
    ell = ell_graph_op(tart, block_size=128, device="cpu")
    xb = torch.zeros(2, N_HIS, V_SPARSE, 4, dtype=BF16)
    for op in (nv_op, ell):
        assert all(t.dtype == BF16 for t in op.cheb_pair(xb))
        trainer({"dtype": BF16}, {"compute_dtype": "bfloat16"}, gop=op, v_model=V_SPARSE)
    bcsr = bcsr_graph_op(tart, block_size=128, dtype=BF16, device="cpu")
    tiles = bcsr.pack.data.detach().requires_grad_(True)
    with pytest.raises(NotImplementedError, match=r"K11.*§1 item 4"):
        tsp.bcsr_spmm_vjp(bcsr.pack._replace(data=tiles), bcsr.pack,
                          torch.zeros(bcsr.n_vertex_pad, 8, dtype=BF16))
