"""The port's CLI (``python -m stgcn_tpu_torch.cli``) against the JAX
package's: the same flags and defaults, ``build_trainer`` on PeMSD7(M)
(V = 228) with ``--graph_op banded --fused True`` — the RCM order, the pack
(one block row: the window clamp and padding edges), the split series and
the scaler — with ``--graph_op banded_int8`` (fused and unfused),
``ell_int8`` and ``bcsr``, a whole CPU run through ``main`` that prints the
reference test line, and the refusals of what is not ported (and of what
the JAX CLI cannot run either)."""

import importlib
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from stgcn_tpu_torch.data import synthetic as TS
from stgcn_tpu_torch.ops import BandedGraphOp, BcsrGraphOp, EllGraphOp

# the modules (each package's __init__ re-exports the function ``main``)
jcli = importlib.import_module("stgcn_tpu.cli.main")
tcli = importlib.import_module("stgcn_tpu_torch.cli.main")

ROOT = Path(__file__).resolve().parents[1]
DATA = str(ROOT / "data")


def test_flags_and_defaults_match_jax():
    argv = ["--dataset", "pemsd7-m", "--graph_op", "banded", "--fused", "True", "--Ks", "2",
            "--act_func", "gtu", "--enable_bias", "false", "--batch_size", "8", "--resume",
            "--mesh_graph", "2", "--compute_dtype", "bfloat16"]
    for args in ([], argv):
        got, ref = vars(tcli.get_parameters(args)), vars(jcli.get_parameters(args))
        assert got == ref
    cfg = tcli.config_from_args(tcli.get_parameters(argv))
    assert (cfg.ks, cfg.act_func, cfg.enable_bias, cfg.batch_size, cfg.fused) == \
        (2, "gtu", False, 8, True)
    assert cfg.ckpt_dir == "checkpoints/STGCN_pemsd7-m"


def test_build_trainer_banded_matches_jax(tmp_path):
    """Same RCM-permuted series, scaler and nv pack as the JAX CLI's."""
    argv = ["--dataset", "pemsd7-m", "--graph_op", "banded", "--fused", "True",
            "--ckpt_dir", str(tmp_path / "ck")]
    kw = dict(dataset="pemsd7-m", data_root=DATA, graph_op_kind="banded")
    jtr = jcli.build_trainer(jcli.config_from_args(jcli.get_parameters(argv)), **kw)
    ttr = tcli.build_trainer(tcli.config_from_args(tcli.get_parameters(argv)), device="cpu",
                             **kw)
    gop, jop = ttr.gop, jtr.gop
    assert isinstance(gop, BandedGraphOp) and gop.slabs_nv.shape[0] == 1   # 228 < 256
    assert gop.v_pad == jop.v_pad == 256
    for f in ("slabs", "slabs_nv", "lo"):   # both pack families under --fused, as the JAX CLI
        np.testing.assert_array_equal(getattr(gop, f).numpy(), np.asarray(getattr(jop, f)))
    for split in ("train_ds", "val_ds", "test_ds"):
        np.testing.assert_array_equal(getattr(ttr, split).series.numpy(),
                                      np.asarray(getattr(jtr, split).series))
    np.testing.assert_array_equal(ttr.scaler.mean_, jtr.scaler.mean_)
    np.testing.assert_array_equal(ttr.scaler.scale_, jtr.scaler.scale_)
    assert ttr.cfg.fused and ttr.steps_per_epoch == jtr.steps_per_epoch


def test_build_trainer_ell_int8_matches_jax(tmp_path):
    """``--graph_op ell_int8``: the same RCM-permuted series, scaler and int8
    ELL pack (tiles, column blocks, counts, scales) as the JAX CLI's."""
    argv = ["--dataset", "pemsd7-m", "--graph_op", "ell_int8", "--fused", "True",
            "--ckpt_dir", str(tmp_path / "ck")]
    kw = dict(dataset="pemsd7-m", data_root=DATA, graph_op_kind="ell_int8")
    jtr = jcli.build_trainer(jcli.config_from_args(jcli.get_parameters(argv)), **kw)
    ttr = tcli.build_trainer(tcli.config_from_args(tcli.get_parameters(argv)), device="cpu",
                             **kw)
    gop, jop = ttr.gop, jtr.gop
    assert isinstance(gop, EllGraphOp) and gop.pack.quantized and gop.v_pad == jop.v_pad == 256
    for got, ref in zip(gop.pack, (jop.data, jop.cols, jop.counts, jop.scales)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for split in ("train_ds", "val_ds", "test_ds"):
        np.testing.assert_array_equal(getattr(ttr, split).series.numpy(),
                                      np.asarray(getattr(jtr, split).series))
    np.testing.assert_array_equal(ttr.scaler.mean_, jtr.scaler.mean_)
    assert ttr.cfg.fused and ttr.steps_per_epoch == jtr.steps_per_epoch


@pytest.mark.parametrize("fused", [False, True])
def test_build_trainer_banded_int8_matches_jax(fused, tmp_path):
    """``--graph_op banded_int8``: the same RCM-permuted series and int8
    pack (slabs, window starts, scales; the nv family under ``--fused``, as
    the JAX CLI asks for it) as the JAX CLI's."""
    argv = ["--dataset", "pemsd7-m", "--graph_op", "banded_int8", "--fused", str(fused),
            "--ckpt_dir", str(tmp_path / "ck")]
    kw = dict(dataset="pemsd7-m", data_root=DATA, graph_op_kind="banded_int8")
    jtr = jcli.build_trainer(jcli.config_from_args(jcli.get_parameters(argv)), **kw)
    ttr = tcli.build_trainer(tcli.config_from_args(tcli.get_parameters(argv)), device="cpu",
                             **kw)
    gop, jop = ttr.gop, jtr.gop
    assert isinstance(gop, BandedGraphOp) and gop.slabs.dtype == torch.int8
    assert gop.v_pad == jop.v_pad == 256 and gop.has_nv == jop.has_nv == fused
    for f in ("slabs", "lo", "scales", "slabs_t", "scales_t", "slabs_nv"):
        got, ref = getattr(gop, f), getattr(jop, f)
        assert (got is None) == (ref is None), f
        if got is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=f)
    for split in ("train_ds", "val_ds", "test_ds"):
        np.testing.assert_array_equal(getattr(ttr, split).series.numpy(),
                                      np.asarray(getattr(jtr, split).series))
    assert ttr.cfg.fused == fused and ttr.steps_per_epoch == jtr.steps_per_epoch


def test_main_trains_on_the_banded_op_and_prints_the_test_line(tmp_path, capsys):
    """A synthetic 200-vertex dataset (one block row of 256) without vel.csv:
    the CLI makes the series, trains one fused epoch on the CPU and tests."""
    (tmp_path / "toy").mkdir()
    sp.save_npz(tmp_path / "toy" / "adj.npz", TS.random_road_graph(200, k_neighbors=4, seed=2))
    TS.ensure_vel("toy", str(tmp_path), seed=1, n_steps=120)
    mets = tcli.main(["--dataset", "toy", "--data_root", str(tmp_path), "--graph_op", "banded",
                      "--fused", "True", "--epochs", "1", "--batch_size", "8",
                      "--platform", "cpu", "--ckpt_dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out.strip().splitlines()
    assert any(line.startswith("Epoch: 001 |") for line in out)
    assert out[-1].startswith("Dataset toy | Test loss ") and "| WMAPE " in out[-1]
    assert all(np.isfinite(v) for v in mets.values())


def test_main_trains_fused_bf16_on_the_dense_op(tmp_path, capsys):
    """``--fused True --compute_dtype bfloat16`` on the dense operator: the
    CLI trains one fused bf16 epoch on the CPU (K1-K4 and K1b-K4b in their
    bf16 plain versions) and tests."""
    (tmp_path / "toy").mkdir()
    sp.save_npz(tmp_path / "toy" / "adj.npz", TS.random_road_graph(200, k_neighbors=4, seed=2))
    TS.ensure_vel("toy", str(tmp_path), seed=1, n_steps=120)
    mets = tcli.main(["--dataset", "toy", "--data_root", str(tmp_path), "--graph_op", "dense",
                      "--fused", "True", "--compute_dtype", "bfloat16", "--epochs", "1",
                      "--batch_size", "8", "--platform", "cpu", "--ckpt_dir",
                      str(tmp_path / "ck")])
    out = capsys.readouterr().out.strip().splitlines()
    assert any(line.startswith("Epoch: 001 |") for line in out)
    assert out[-1].startswith("Dataset toy | Test loss ") and "| WMAPE " in out[-1]
    assert all(np.isfinite(v) for v in mets.values())


@pytest.mark.parametrize("flags,match", [
    # remat and bf16 run fused and unfused on every operator kind
    # (tests/test_torch_fused_remat.py); a mesh on any of its axes still raises
    (["--mesh_model", "2", "--fused", "True"], "dist"),
    (["--mesh_graph", "2", "--compute_dtype", "bfloat16", "--remat", "True"], "dist"),
    (["--mesh_data", "2"], "dist"),
    (["--distributed"], "dist"),
    (["--profile_dir", "trace"], "profiling"),
    (["--fused_tile_v", "256"], "tiles"),
])
def test_unported_options_raise(flags, match):
    with pytest.raises(NotImplementedError, match=match):
        tcli.main(["--dataset", "pemsd7-m", "--data_root", DATA, "--platform", "cpu", *flags])


def test_build_trainer_bcsr_matches_jax(tmp_path):
    """``--graph_op bcsr`` by name: the graph keeps its order (no RCM, as in
    the JAX CLI), the same BCSR pack as the JAX CLI's, and the same split
    series to the last bit but one: the JAX loader's array is column-major
    (pandas), so numpy sums the scaler's column means in another order (2
    of 2M elements 1 ulp apart; the RCM-permuted copies above are
    row-major in both packages and equal)."""
    argv = ["--dataset", "pemsd7-m", "--graph_op", "bcsr", "--fused", "True",
            "--ckpt_dir", str(tmp_path / "ck")]
    kw = dict(dataset="pemsd7-m", data_root=DATA, graph_op_kind="bcsr")
    jtr = jcli.build_trainer(jcli.config_from_args(jcli.get_parameters(argv)), **kw)
    ttr = tcli.build_trainer(tcli.config_from_args(tcli.get_parameters(argv)), device="cpu",
                             **kw)
    gop, jop = ttr.gop, jtr.gop
    assert isinstance(gop, BcsrGraphOp) and gop.n_vertex_pad == jop.n_vertex_pad == 256
    for got, ref in zip(gop.pack, (jop.block_data, jop.block_cols, jop.block_counts)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for split in ("train_ds", "val_ds", "test_ds"):
        np.testing.assert_allclose(getattr(ttr, split).series.numpy(),
                                   np.asarray(getattr(jtr, split).series), rtol=2.5e-7, atol=0)
    assert ttr.cfg.fused and ttr.steps_per_epoch == jtr.steps_per_epoch


def test_sparse_kinds_not_ported_raise(tmp_path):
    """Every sparse kind the JAX CLI builds builds here: ``banded_int8`` and
    ``--graph_op bcsr`` give a Trainer on their operator; and ``--fused
    True`` with ``auto`` picking bcsr (a 5000-vertex graph whose hub vertex
    keeps the RCM band wider than the banded slabs take) raises a TypeError
    in both packages: the JAX CLI asks ``bcsr_graph_op`` for nv packs it has
    no argument for."""
    cfg = tcli.config_from_args(tcli.get_parameters(["--ckpt_dir", str(tmp_path)]))
    tr = tcli.build_trainer(cfg, dataset="pemsd7-m", data_root=DATA, graph_op_kind="banded_int8",
                            device="cpu")
    assert isinstance(tr.gop, BandedGraphOp) and tr.gop.scales is not None
    assert not tr.gop.has_nv and not tr.cfg.fused
    tr = tcli.build_trainer(cfg, dataset="pemsd7-m", data_root=DATA, graph_op_kind="bcsr",
                            device="cpu")
    assert isinstance(tr.gop, BcsrGraphOp) and not tr.cfg.fused
    (tmp_path / "hub").mkdir()
    adj = sp.lil_matrix(TS.random_road_graph(5000, k_neighbors=4, seed=2))
    adj[0, 1:] = 1.0
    adj[1:, 0] = 1.0
    sp.save_npz(tmp_path / "hub" / "adj.npz", adj.tocsr())
    argv = ["--graph_op", "auto", "--fused", "True", "--ckpt_dir", str(tmp_path / "ck")]
    kw = dict(dataset="hub", data_root=str(tmp_path), graph_op_kind="auto")
    with pytest.raises(TypeError, match="nv"):
        jcli.build_trainer(jcli.config_from_args(jcli.get_parameters(argv)), **kw)
    with pytest.raises(TypeError, match="--graph_op bcsr"):
        tcli.build_trainer(tcli.config_from_args(tcli.get_parameters(argv)), device="cpu",
                           **kw)
