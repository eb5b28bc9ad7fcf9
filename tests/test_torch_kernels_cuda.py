"""The CUDA kernels K1-K4 (f32, and their forward kernels' bf16 variants), their
backward kernels K1b-K4b, the banded nv
SpMM K5 (f32 and int8, and its bf16 variant over f32, bf16 and int8 slabs),
the banded vn kernel of K7-K9 (f32 and int8, and its bf16 variant over f32,
bf16 and int8 slabs), the blocked-ELL nv SpMM K6 (and its bf16 variant
over f32, int8 and bf16 tiles), the
BCSR SpMM K10 (f32, and its bf16 variant over f32 and bf16 tiles) and SDDMM
K11 and the whole dense
ST block K12f / K12b against their plain PyTorch versions, on a card; the
kernels' dropout masks against the plain mask bit for bit; the nonzero
index that K5, K6, K7-K9 and K10 walk, built once per pack on the card.

This file imports neither JAX nor the JAX package, so it runs on the card
machine, which has neither:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Without a card every test skips (decided at run time). ``chip_smoke.py``
holds the same kernels against the same plain versions at the main path's
full shapes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from stgcn_tpu_torch import kernels
from stgcn_tpu_torch.data.synthetic import random_road_graph
from stgcn_tpu_torch.graph import build_gso, permute_matrix, rcm_ordering
from stgcn_tpu_torch.graph.gso import GraphShiftOperator
from stgcn_tpu_torch.kernels import banded_nv as nv
from stgcn_tpu_torch.kernels import banded_spmm as bvn
from stgcn_tpu_torch.kernels import bf16_bounds as bb
from stgcn_tpu_torch.kernels import ell_nv as ek
from stgcn_tpu_torch.kernels import fused_stblock as fs
from stgcn_tpu_torch.kernels import nnz_index
from stgcn_tpu_torch.kernels import output_head as oh
from stgcn_tpu_torch.kernels import sddmm as sd
from stgcn_tpu_torch.kernels import spmm as spm
from stgcn_tpu_torch.kernels import vertex_fused as vf
from stgcn_tpu_torch.kernels._ab import launches, retired_launches
from stgcn_tpu_torch.kernels.dropout import Drop, step_seed
from stgcn_tpu_torch.kernels.probes import mask_probes
from stgcn_tpu_torch.nn import STGCN, fused_forward
from stgcn_tpu_torch.ops import DenseGraphOp, banded_graph_op, bcsr_graph_op, ell_graph_op
from tests.gate_gemm_edges import HEAD_EDGES, OFC_EDGES, OHEAD_EDGES, TAIL_EDGES, v_true_of

pytestmark = pytest.mark.cuda
B, V_TRUE, V_PAD = 3, 150, 256
TOL = dict(rtol=1e-4, atol=1e-4)  # f32, sums in another order


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, dev, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)


def _ln_args(rng, dev, n_t, c):
    mu = _rand(rng, dev, B, n_t, 1, 1, scale=0.1)
    rstd = 0.5 + _rand(rng, dev, B, n_t, 1, 1, scale=0.1).abs()
    lng, lnb = 1.0 + _rand(rng, dev, c, V_PAD, scale=0.1), _rand(rng, dev, c, V_PAD)
    lng[:, V_TRUE:] = 0.0
    lnb[:, V_TRUE:] = 0.0
    return mu, rstd, lng, lnb


@pytest.mark.parametrize("act", ["glu", "gtu", "relu", "silu"])
@pytest.mark.parametrize("apply_ln", [False, True])
def test_head_and_tail_match_plain(dev, act, apply_ln):
    rng = np.random.default_rng(21)
    cfg = vf.VertexBlockCfg(kt=3, ks=3, act_func=act, graph_conv_type="cheb_graph_conv",
                            v_true=V_TRUE, v_pad=V_PAD, t_in=8 if apply_ln else 12,
                            c_in=16 if apply_ln else 1, c0=80, c1=16, c2=32,
                            apply_ln=apply_ln)
    x = _rand(rng, dev, B, cfg.t_in, cfg.c_in, V_PAD)
    ln = _ln_args(rng, dev, cfg.t_in, cfg.c_in) if apply_ln else None
    w = (_rand(rng, dev, 3, cfg.c_in, cfg.g1, scale=0.2), _rand(rng, dev, cfg.g1, scale=0.1),
         _rand(rng, dev, cfg.c0, cfg.c1, scale=0.2), _rand(rng, dev, cfg.c1, scale=0.1))
    xg = vf.head_fwd(cfg, x, *(ln or (None,) * 4), *w)
    torch.testing.assert_close(xg, vf.head_reference(cfg, x, ln, w), **TOL)

    terms = [_rand(rng, dev, B, cfg.t1, cfg.c1, V_PAD) for _ in range(2)]
    w2 = (_rand(rng, dev, 3, cfg.c1, cfg.c1, scale=0.2), _rand(rng, dev, cfg.c1, scale=0.1),
          _rand(rng, dev, 3, cfg.c1, cfg.g2, scale=0.2), _rand(rng, dev, cfg.g2, scale=0.1))
    got = vf.tail_fwd(cfg, xg, *terms, *w2)
    for g, r in zip(got, vf.tail_reference(cfg, xg, terms, w2)):
        torch.testing.assert_close(g, r, **TOL)
    again = vf.tail_fwd(cfg, xg, *terms, *w2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))   # no atomics


@pytest.mark.parametrize("gct,ks", [("graph_conv", 3), ("cheb_graph_conv", 2),
                                    ("cheb_graph_conv", 1)])
def test_tail_with_one_or_two_terms_matches_plain(dev, gct, ks):
    """K2 reads one graph term (graph_conv, Ks=2) or none (Ks=1)."""
    rng = np.random.default_rng(22)
    cfg = vf.VertexBlockCfg(kt=3, ks=ks, act_func="glu", graph_conv_type=gct, v_true=V_TRUE,
                            v_pad=V_PAD, t_in=8, c_in=16, c0=32, c1=16, c2=32, apply_ln=True)
    n_c = cfg.n_terms + (gct == "cheb_graph_conv")
    xg, ta, tb = (_rand(rng, dev, B, cfg.t1, cfg.c1, V_PAD) for _ in range(3))
    w = (_rand(rng, dev, n_c, cfg.c1, cfg.c1, scale=0.2), _rand(rng, dev, cfg.c1, scale=0.1),
         _rand(rng, dev, 3, cfg.c1, cfg.g2, scale=0.2), _rand(rng, dev, cfg.g2, scale=0.1))
    got = vf.tail_fwd(cfg, xg, ta, tb, *w)
    for g, r in zip(got, vf.tail_reference(cfg, xg, [ta, tb][: cfg.n_terms], w)):
        torch.testing.assert_close(g, r, **TOL)


@pytest.mark.parametrize("act", ["glu", "silu", "gtu", "relu"])
def test_ohead_and_ofc_match_plain(dev, act):
    rng = np.random.default_rng(41)
    cfg = oh.OutHeadCfg(ko=4, c_in=16, c0=40, c1=24, c_end=1, act_func=act, v_true=V_TRUE,
                        v_pad=V_PAD)
    args = (_rand(rng, dev, B, cfg.ko, cfg.c_in, V_PAD), *_ln_args(rng, dev, cfg.ko, cfg.c_in),
            _rand(rng, dev, cfg.ko, cfg.c_in, cfg.g, scale=0.2), _rand(rng, dev, cfg.g, scale=0.1))
    for g, r in zip(oh.ohead_fwd(cfg, *args), oh.ohead_reference(cfg, *args)):
        torch.testing.assert_close(g, r, **TOL)
    args = (_rand(rng, dev, B, 1, cfg.c0, V_PAD), *_ln_args(rng, dev, 1, cfg.c0),
            _rand(rng, dev, cfg.c0, cfg.c1, scale=0.2), _rand(rng, dev, cfg.c1, scale=0.1),
            _rand(rng, dev, cfg.c1, cfg.c_end, scale=0.2), _rand(rng, dev, cfg.c_end, scale=0.1))
    torch.testing.assert_close(oh.ofc_fwd(cfg, *args), oh.ofc_reference(cfg, *args), **TOL)


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    cfg = oh.OutHeadCfg(ko=4, c_in=16, c0=40, c1=24, c_end=1, act_func="glu", v_true=V_TRUE,
                        v_pad=V_PAD)
    rng = np.random.default_rng(3)
    args = [_rand(rng, dev, B, 1, cfg.c0, V_PAD), *_ln_args(rng, dev, 1, cfg.c0),
            _rand(rng, dev, cfg.c0, cfg.c1), _rand(rng, dev, cfg.c1),
            _rand(rng, dev, cfg.c1, 1), _rand(rng, dev, 1)]
    with pytest.raises(ValueError, match="shape"):
        oh.ofc_fwd(cfg, *args[:5], args[5].T.contiguous(), *args[6:])
    with pytest.raises(TypeError, match="float32"):
        oh.ofc_fwd(cfg, args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        oh.ofc_fwd(cfg, *args[:3], args[3].T.contiguous().T, *args[4:])


DROP = Drop(0.5, 2024, 1)


def _head_case(rng, dev, act, apply_ln):
    cfg = vf.VertexBlockCfg(kt=3, ks=3, act_func=act, graph_conv_type="cheb_graph_conv",
                            v_true=V_TRUE, v_pad=V_PAD, t_in=8 if apply_ln else 12,
                            c_in=16 if apply_ln else 1, c0=40, c1=16, c2=32, apply_ln=apply_ln)
    x = _rand(rng, dev, B, cfg.t_in, cfg.c_in, V_PAD)
    ln = _ln_args(rng, dev, cfg.t_in, cfg.c_in) if apply_ln else (None,) * 4
    w = (_rand(rng, dev, 3, cfg.c_in, cfg.g1, scale=0.2), _rand(rng, dev, cfg.g1, scale=0.1),
         _rand(rng, dev, cfg.c0, cfg.c1, scale=0.2), _rand(rng, dev, cfg.c1, scale=0.1))
    return cfg, x, ln, w


def _close_all(got, ref):
    for g, r in zip(got, ref):
        if r is None:
            assert g is None
        else:
            torch.testing.assert_close(g, r, **TOL)


@pytest.mark.parametrize("act", ["glu", "gtu", "relu", "silu"])
def test_head_forward_with_dropout_matches_plain(dev, act):
    rng = np.random.default_rng(51)
    cfg, x, ln, w = _head_case(rng, dev, act, True)
    torch.testing.assert_close(vf.head_fwd(cfg, x, *ln, *w, drop=DROP),
                               vf.head_reference(cfg, x, ln, w, DROP), **TOL)


def _ln_of(rng, dev, batch, n_t, c, v_true, v_pad):
    mu = _rand(rng, dev, batch, n_t, 1, 1, scale=0.1)
    rstd = 0.5 + _rand(rng, dev, batch, n_t, 1, 1, scale=0.1).abs()
    lng, lnb = 1.0 + _rand(rng, dev, c, v_pad, scale=0.1), _rand(rng, dev, c, v_pad)
    lng[:, v_true:] = 0.0
    lnb[:, v_true:] = 0.0
    return mu, rstd, lng, lnb


@pytest.mark.parametrize("act,c0,c_in,kt,t_in,c1,apply_ln,drop,batch,v_pad", HEAD_EDGES)
def test_head_fwd_at_tile_edges_matches_plain(dev, act, c0, c_in, kt, t_in, c1, apply_ln,
                                              drop, batch, v_pad):
    """K1f (the gate GEMM) at the edges of its tile (``gate_gemm_edges``):
    within the kernel tolerance of its plain version, a repeat launch
    bit-identical, one launch counted per call."""
    rng = np.random.default_rng(57)
    v_true = v_true_of(v_pad)
    cfg = vf.VertexBlockCfg(kt=kt, ks=3, act_func=act, graph_conv_type="cheb_graph_conv",
                            v_true=v_true, v_pad=v_pad, t_in=t_in, c_in=c_in, c0=c0, c1=c1,
                            c2=c1, apply_ln=apply_ln)
    x = _rand(rng, dev, batch, t_in, c_in, v_pad)
    ln = _ln_of(rng, dev, batch, t_in, c_in, v_true, v_pad) if apply_ln else (None,) * 4
    w = (_rand(rng, dev, kt, c_in, cfg.g1, scale=(kt * c_in) ** -0.5),
         _rand(rng, dev, cfg.g1, scale=0.1), _rand(rng, dev, c0, c1, scale=c0 ** -0.5),
         _rand(rng, dev, c1, scale=0.1))
    d = DROP if drop else None
    before = kernels.launch_counts()["head_fwd"]
    got = vf.head_fwd(cfg, x, *ln, *w, drop=d)
    assert torch.equal(got, vf.head_fwd(cfg, x, *ln, *w, drop=d))
    assert kernels.launch_counts()["head_fwd"] == before + 2
    assert got.shape == (batch, cfg.t1, c1, v_pad)
    torch.testing.assert_close(got, vf.head_reference(cfg, x, ln if apply_ln else None, w, d),
                               **TOL)


@pytest.mark.parametrize("c0,c1,c_end,drop,batch,v_pad", OFC_EDGES)
def test_ofc_fwd_at_tile_edges_matches_plain(dev, c0, c1, c_end, drop, batch, v_pad):
    """K4f (the gate GEMM: relu, no residual, its dropout after the ReLU) at
    the edges of its tile, against its plain version; a repeat launch
    bit-identical."""
    rng = np.random.default_rng(58)
    v_true = v_true_of(v_pad)
    cfg = oh.OutHeadCfg(ko=4, c_in=1, c0=c0, c1=c1, c_end=c_end, act_func="glu",
                        v_true=v_true, v_pad=v_pad)
    args = (cfg, _rand(rng, dev, batch, 1, c0, v_pad),
            *_ln_of(rng, dev, batch, 1, c0, v_true, v_pad),
            _rand(rng, dev, c0, c1, scale=c0 ** -0.5), _rand(rng, dev, c1, scale=0.1),
            _rand(rng, dev, c1, c_end, scale=c1 ** -0.5), _rand(rng, dev, c_end, scale=0.1))
    d = Drop(0.5, 2024, 3) if drop else None
    before = kernels.launch_counts()["ofc_fwd"]
    got = oh.ofc_fwd(*args, drop=d)
    assert torch.equal(got, oh.ofc_fwd(*args, drop=d))
    assert kernels.launch_counts()["ofc_fwd"] == before + 2
    assert got.shape == (batch, 1, c_end, v_pad)
    torch.testing.assert_close(got, oh.ofc_reference(*args, drop=d), **TOL)


def _tail_edge(rng, dev, act, gct, ks, c1, c2, kt, t1, batch, v_pad):
    cfg = vf.VertexBlockCfg(kt=kt, ks=ks, act_func=act, graph_conv_type=gct,
                            v_true=v_true_of(v_pad), v_pad=v_pad, t_in=t1 + kt - 1, c_in=c1,
                            c0=c1, c1=c1, c2=c2, apply_ln=False)
    xg, ta, tb = (_rand(rng, dev, batch, t1, c1, v_pad) for _ in range(3))
    n_c = cfg.n_terms + (gct == "cheb_graph_conv")
    w = (_rand(rng, dev, n_c, c1, c1, scale=(n_c * c1) ** -0.5), _rand(rng, dev, c1, scale=0.1),
         _rand(rng, dev, kt, c1, cfg.g2, scale=(kt * c1) ** -0.5),
         _rand(rng, dev, cfg.g2, scale=0.1))
    return cfg, (xg, ta, tb), w


def _tail_fwd_matches_plain(cfg, ins, w):
    """K2f within the kernel tolerance of its plain version, a repeat launch
    bit-identical, one launch counted per call."""
    before = kernels.launch_counts()["tail_fwd"]
    got = vf.tail_fwd(cfg, *ins, *w)
    again = vf.tail_fwd(cfg, *ins, *w)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert kernels.launch_counts()["tail_fwd"] == before + 2
    b = ins[0].shape[0]
    assert got[0].shape == (b, cfg.t2, cfg.c2, cfg.v_pad) and got[1].shape == (b, cfg.t2, 1, 1)
    _close_all(got, vf.tail_reference(cfg, ins[0], list(ins[1:3])[: cfg.n_terms], w))


@pytest.mark.parametrize("act,gct,ks,c1,c2,kt,t1,batch,v_pad", TAIL_EDGES)
def test_tail_fwd_at_tile_edges_matches_plain(dev, act, gct, ks, c1, c2, kt, t1, batch, v_pad):
    """K2f (h, then conv 2 on the gate GEMM) at the edges of its tile
    (``gate_gemm_edges``); the padded lanes out of the partial sums."""
    rng = np.random.default_rng(59)
    _tail_fwd_matches_plain(*_tail_edge(rng, dev, act, gct, ks, c1, c2, kt, t1, batch, v_pad))


@pytest.mark.parametrize("act", ["glu", "relu"])
def test_tail_fwd_on_a_large_grid_matches_plain(dev, act):
    """K2f at c2 = 130 (conv 2 in two or three passes, one a block) on a
    grid of thousands of blocks, as the 100k and 1M paths launch it."""
    rng = np.random.default_rng(60)
    _tail_fwd_matches_plain(*_tail_edge(rng, dev, act, "cheb_graph_conv", 3, 16, 130, 3, 10, 3,
                                        8448))


def _ohead_edge(rng, dev, act, c0, c_in, ko, batch, v_pad):
    v_true = v_true_of(v_pad)
    cfg = oh.OutHeadCfg(ko=ko, c_in=c_in, c0=c0, c1=1, c_end=1, act_func=act, v_true=v_true,
                        v_pad=v_pad)
    return (cfg, _rand(rng, dev, batch, ko, c_in, v_pad),
            *_ln_of(rng, dev, batch, ko, c_in, v_true, v_pad),
            _rand(rng, dev, ko, c_in, cfg.g, scale=(ko * c_in) ** -0.5),
            _rand(rng, dev, cfg.g, scale=0.1))


def _ohead_fwd_matches_plain(args, d):
    """K3f within the kernel tolerance of its plain version, a repeat launch
    bit-identical, one launch counted per call."""
    before = kernels.launch_counts()["ohead_fwd"]
    got = oh.ohead_fwd(*args, drop=d)
    again = oh.ohead_fwd(*args, drop=d)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert kernels.launch_counts()["ohead_fwd"] == before + 2
    cfg, b = args[0], args[1].shape[0]
    assert got[0].shape == (b, 1, cfg.c0, cfg.v_pad) and got[1].shape == (b, 1, 1, 1)
    _close_all(got, oh.ohead_reference(*args, drop=d))


@pytest.mark.parametrize("act,c0,c_in,ko,drop,batch,v_pad", OHEAD_EDGES)
def test_ohead_fwd_at_tile_edges_matches_plain(dev, act, c0, c_in, ko, drop, batch, v_pad):
    """K3f (the gate GEMM with its LayerNorm-partial epilogue) at the edges
    of its tile (``gate_gemm_edges``); the padded lanes out of the partial
    sums."""
    rng = np.random.default_rng(61)
    _ohead_fwd_matches_plain(_ohead_edge(rng, dev, act, c0, c_in, ko, batch, v_pad),
                             Drop(0.5, 2024, 2) if drop else None)


@pytest.mark.parametrize("act", ["glu", "relu"])
def test_ohead_fwd_on_a_large_grid_matches_plain(dev, act):
    """K3f at c0 = 130 (three or two passes, one a block) on a grid of
    thousands of blocks, as the 100k and 1M paths launch it."""
    rng = np.random.default_rng(62)
    _ohead_fwd_matches_plain(_ohead_edge(rng, dev, act, 130, 64, 4, 3, 22016), DROP)


@pytest.mark.parametrize("apply_ln,drop", [(False, None), (True, None), (True, DROP)])
@pytest.mark.parametrize("act", ["glu", "gtu", "relu", "silu"])
def test_head_bwd_matches_plain(dev, act, apply_ln, drop):
    rng = np.random.default_rng(52)
    cfg, x, ln, w = _head_case(rng, dev, act, apply_ln)
    gy = _rand(rng, dev, B, cfg.t1, cfg.c1, V_PAD)
    before = kernels.launch_counts()["head_bwd"]
    got = vf.head_bwd(cfg, x, *ln, *w, gy, drop=drop)
    again = vf.head_bwd(cfg, x, *ln, *w, gy, drop=drop)
    assert kernels.launch_counts()["head_bwd"] == before + 2
    assert all(a is None or torch.equal(a, b) for a, b in zip(got, again))   # no atomics
    _close_all(got, vf.head_bwd_reference(cfg, x, ln if apply_ln else None, w, gy, drop))


# (v_true, v_pad): PeMSD7(M)'s lanes and a 64k-lane graph, whose long
# reductions take the shared tile's 128-row shapes
LANES_SMALL, LANES_LARGE = (V_TRUE, V_PAD), (65_000, 65_536)


@pytest.mark.parametrize("b,t_in,c_in,drop,lanes", [
    (3, 12, 1, None, LANES_SMALL), (3, 8, 64, DROP, LANES_SMALL),
    (1, 8, 64, None, LANES_LARGE), (1, 12, 1, None, LANES_LARGE)])
def test_head_bwd_at_the_main_widths_matches_plain(dev, b, t_in, c_in, drop, lanes):
    """K1b at block 1's shape (c_in 1, t_in 12, no LayerNorm: the narrow data
    gradient) and block 2's (c_in 64, t_in 8, LayerNorm and dropout) at the
    main.py widths (c0 64, c1 16), at batch 3 and at batch 1 (B·t1 < 64: the
    weight gradients cut each step's lanes); inputs and cotangents nonzero
    on the padded lanes, the cotangent at a training step's scale (1e-3). A
    repeat is bit-identical."""
    rng = np.random.default_rng(56)
    apply_ln = c_in > 1
    v_true, v_pad = lanes
    cfg = vf.VertexBlockCfg(kt=3, ks=3, act_func="glu", graph_conv_type="cheb_graph_conv",
                            v_true=v_true, v_pad=v_pad, t_in=t_in, c_in=c_in, c0=64, c1=16,
                            c2=64, apply_ln=apply_ln)
    x = _rand(rng, dev, b, t_in, c_in, v_pad)
    gy = _rand(rng, dev, b, cfg.t1, cfg.c1, v_pad, scale=1e-3)   # a step's cotangent scale
    assert bool((x[..., v_true:] != 0).any()) and bool((gy[..., v_true:] != 0).any())
    if apply_ln:
        mu = _rand(rng, dev, b, t_in, 1, 1, scale=0.1)
        rstd = 0.5 + _rand(rng, dev, b, t_in, 1, 1, scale=0.1).abs()
        lng, lnb = 1.0 + _rand(rng, dev, c_in, v_pad, scale=0.1), _rand(rng, dev, c_in, v_pad)
        lng[:, v_true:] = 0.0
        lnb[:, v_true:] = 0.0
        ln = (mu, rstd, lng, lnb)
    else:
        ln = (None,) * 4
    w = (_rand(rng, dev, 3, c_in, cfg.g1, scale=(3 * c_in) ** -0.5),
         _rand(rng, dev, cfg.g1, scale=0.1), _rand(rng, dev, 64, 16, scale=0.125),
         _rand(rng, dev, 16, scale=0.1))
    got = vf.head_bwd(cfg, x, *ln, *w, gy, drop=drop)
    again = vf.head_bwd(cfg, x, *ln, *w, gy, drop=drop)
    assert all(a is None or torch.equal(a, c) for a, c in zip(got, again))
    _close_all(got, vf.head_bwd_reference(cfg, x, ln if apply_ln else None, w, gy, drop))


def _ohead_case(rng, dev, v_true, v_pad):
    """K3b's inputs at the main.py widths and batch 1 (dck 256 x 256), the
    cotangents at a training step's scale."""
    cfg = oh.OutHeadCfg(ko=4, c_in=64, c0=128, c1=128, c_end=1, act_func="glu",
                        v_true=v_true, v_pad=v_pad)
    mu = _rand(rng, dev, 1, 4, 1, 1, scale=0.1)
    rstd = 0.5 + _rand(rng, dev, 1, 4, 1, 1, scale=0.1).abs()
    args = (_rand(rng, dev, 1, 4, 64, v_pad), mu, rstd, 1.0 + _rand(rng, dev, 64, v_pad, scale=0.1),
            _rand(rng, dev, 64, v_pad), _rand(rng, dev, 4, 64, 256, scale=0.06),
            _rand(rng, dev, 256, scale=0.1))
    cot = (_rand(rng, dev, 1, 1, 128, v_pad, scale=1e-3),
           *(_rand(rng, dev, 1, 1, 1, 1, scale=1e-5) for _ in range(2)))
    return cfg, args, cot


def test_weight_gradient_tiles_through_k2b_k3b_k4b(dev):
    """The weight gradients of K2b (dc2k 48 x 128, dgcw 16 x 16, the biases),
    K3b (dck 256 x 256) and K4b (dw1 128 x 128, dw2 128 x 1) at the main.py
    widths and batch 1 on 256 lanes (the small tiles a small product takes),
    against their plain versions; a repeat is bit-identical. Cotangents at a
    training step's scale (1e-3; bwd_ab.py's)."""
    rng = np.random.default_rng(57)
    cfg = vf.VertexBlockCfg(kt=3, ks=3, act_func="glu", graph_conv_type="cheb_graph_conv",
                            v_true=V_TRUE, v_pad=V_PAD, t_in=12, c_in=1, c0=64, c1=16, c2=64,
                            apply_ln=False)
    tail = [_rand(rng, dev, 1, cfg.t1, 16, V_PAD) for _ in range(3)]
    w = (_rand(rng, dev, 3, 16, 16, scale=0.25), _rand(rng, dev, 16, scale=0.1),
         _rand(rng, dev, 3, 16, 128, scale=0.15), _rand(rng, dev, 128, scale=0.1))
    cot = (_rand(rng, dev, 1, cfg.t2, 64, V_PAD, scale=1e-3),
           *(_rand(rng, dev, 1, cfg.t2, 1, 1, scale=1e-5) for _ in range(2)))
    got = vf.tail_bwd(cfg, *tail, *w, *cot)
    assert all(torch.equal(a, c) for a, c in zip(got, vf.tail_bwd(cfg, *tail, *w, *cot)))
    ref = vf.tail_bwd(cfg, *[t_.cpu() for t_ in (*tail, *w, *cot)])
    _close_all([g.cpu() for g in got], ref)

    ocfg, args, gcot = _ohead_case(rng, dev, V_TRUE, V_PAD)
    got = oh.ohead_bwd(ocfg, *args, *gcot, drop=DROP)
    assert all(torch.equal(a, c) for a, c in zip(got, oh.ohead_bwd(ocfg, *args, *gcot, drop=DROP)))
    _close_all(got, oh.ohead_bwd_reference(ocfg, *args, *gcot, DROP))

    args = (_rand(rng, dev, 1, 1, 128, V_PAD), _rand(rng, dev, 1, 1, 1, 1, scale=0.1),
            0.5 + _rand(rng, dev, 1, 1, 1, 1, scale=0.1).abs(),
            1.0 + _rand(rng, dev, 128, V_PAD, scale=0.1), _rand(rng, dev, 128, V_PAD),
            _rand(rng, dev, 128, 128, scale=0.09), _rand(rng, dev, 128, scale=0.1),
            _rand(rng, dev, 128, 1, scale=0.09), _rand(rng, dev, 1, scale=0.1))
    gout = _rand(rng, dev, 1, 1, 1, V_PAD, scale=1e-3)
    got = oh.ofc_bwd(ocfg, *args, gout, drop=DROP)
    assert all(torch.equal(a, c) for a, c in zip(got, oh.ofc_bwd(ocfg, *args, gout, drop=DROP)))
    _close_all(got, oh.ofc_bwd_reference(ocfg, *args, gout, DROP))


def test_weight_gradient_tiles_on_many_lanes_through_k3b(dev):
    """K3b's weight gradients on 65,536 lanes, where dck (256 x 256) takes the
    128 x 128 tile and dcb the 128 x 16 one, against the plain version; a
    repeat is bit-identical. (K2b and K4b have a ReLU: on 1e7 units two f32
    orders disagree on a few decisions, which ``chip_smoke.py`` handles with
    ``relu_checked``.)"""
    ocfg, args, gcot = _ohead_case(np.random.default_rng(58), dev, *LANES_LARGE)
    got = oh.ohead_bwd(ocfg, *args, *gcot, drop=DROP)
    assert all(torch.equal(a, c) for a, c in zip(got, oh.ohead_bwd(ocfg, *args, *gcot, drop=DROP)))
    _close_all(got, oh.ohead_bwd_reference(ocfg, *args, *gcot, DROP))


@pytest.mark.parametrize("gct,ks,act", [("cheb_graph_conv", 3, "glu"),
                                        ("cheb_graph_conv", 2, "gtu"),
                                        ("cheb_graph_conv", 1, "relu"),
                                        ("graph_conv", 3, "silu")])
def test_tail_bwd_matches_plain(dev, gct, ks, act):
    rng = np.random.default_rng(53)
    cfg = vf.VertexBlockCfg(kt=3, ks=ks, act_func=act, graph_conv_type=gct, v_true=V_TRUE,
                            v_pad=V_PAD, t_in=8, c_in=16, c0=32, c1=16, c2=32, apply_ln=True)
    n_c = cfg.n_terms + (gct == "cheb_graph_conv")
    xg, ta, tb = (_rand(rng, dev, B, cfg.t1, cfg.c1, V_PAD) for _ in range(3))
    w = (_rand(rng, dev, n_c, cfg.c1, cfg.c1, scale=0.2), _rand(rng, dev, cfg.c1, scale=0.1),
         _rand(rng, dev, 3, cfg.c1, cfg.g2, scale=0.2), _rand(rng, dev, cfg.g2, scale=0.1))
    ga2 = _rand(rng, dev, B, cfg.t2, cfg.c2, V_PAD)
    gps, gpss = (_rand(rng, dev, B, cfg.t2, 1, 1, scale=1e-2) for _ in range(2))
    got = vf.tail_bwd(cfg, xg, ta, tb, *w, ga2, gps, gpss)
    again = vf.tail_bwd(cfg, xg, ta, tb, *w, ga2, gps, gpss)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    cpu = [t.cpu() for t in (xg, ta, tb, *w, ga2, gps, gpss)]
    ref = vf.tail_bwd(cfg, *cpu)          # the plain version, on the CPU copy
    _close_all([g.cpu() for g in got], ref)


@pytest.mark.parametrize("batch,t_in,gct,ks,act,c2", [
    (1, 8, "cheb_graph_conv", 3, "glu", 64),    # batch 1
    (2, 5, "cheb_graph_conv", 3, "relu", 64),   # t2 = 1 (t1 = kt)
    (2, 8, "cheb_graph_conv", 3, "gtu", 40),    # 40 gate channels in a 64-channel pass
    (2, 8, "graph_conv", 3, "silu", 64),        # one graph term, no T_0
    (1, 8, "cheb_graph_conv", 2, "glu", 64),    # Chebyshev with one term besides T_0
])
def test_tail_bwd_at_edge_shapes_matches_plain(dev, batch, t_in, gct, ks, act, c2):
    """K2b where its gate pass and dr pass cut their work differently, c1 = 16
    (the dr tile's rows), V = 150 of 256 lanes with nonzero inputs and ga2 on
    the padded lanes: against the plain version on a CPU copy, a repeat
    bit-identical, the unused term's gradient zero."""
    rng = np.random.default_rng(59)
    cfg = vf.VertexBlockCfg(kt=3, ks=ks, act_func=act, graph_conv_type=gct, v_true=V_TRUE,
                            v_pad=V_PAD, t_in=t_in, c_in=16, c0=64, c1=16, c2=c2, apply_ln=True)
    n_c = cfg.n_terms + (gct == "cheb_graph_conv")
    xg, ta, tb = (_rand(rng, dev, batch, cfg.t1, cfg.c1, V_PAD) for _ in range(3))
    w = (_rand(rng, dev, n_c, cfg.c1, cfg.c1, scale=0.2), _rand(rng, dev, cfg.c1, scale=0.1),
         _rand(rng, dev, 3, cfg.c1, cfg.g2, scale=0.15), _rand(rng, dev, cfg.g2, scale=0.1))
    ga2 = _rand(rng, dev, batch, cfg.t2, c2, V_PAD)
    gps, gpss = (_rand(rng, dev, batch, cfg.t2, 1, 1, scale=1e-2) for _ in range(2))
    got = vf.tail_bwd(cfg, xg, ta, tb, *w, ga2, gps, gpss)
    again = vf.tail_bwd(cfg, xg, ta, tb, *w, ga2, gps, gpss)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if cfg.n_terms == 1:
        assert not bool(got[2].any())
    ref = vf.tail_bwd(cfg, *[t.cpu() for t in (xg, ta, tb, *w, ga2, gps, gpss)])
    _close_all([g.cpu() for g in got], ref)


@pytest.mark.parametrize("batch,ko,c_in,c0,act,drop", [
    (1, 1, 16, 32, "glu", DROP),      # time already one step: one tap
    (1, 4, 16, 40, "gtu", None),      # 40 gate channels in a 64-channel pass
    (32, 4, 64, 128, "glu", DROP),    # the main.py widths on PeMSD7(M)'s grid: two passes
])
def test_ohead_bwd_at_edge_shapes_matches_plain(dev, batch, ko, c_in, c0, act, drop):
    """K3b where its gate pass and data gradient cut their work differently,
    and at the main.py widths (c_in 64, c0 128) and PeMSD7(M)'s batch and
    lanes (B = 32, Vp = 256), where the gate pass puts its two channel
    passes in the grid; nonzero ga on the padded lanes, cotangents at a
    training step's scale; a repeat is bit-identical."""
    rng = np.random.default_rng(60)
    cfg = oh.OutHeadCfg(ko=ko, c_in=c_in, c0=c0, c1=128, c_end=1, act_func=act, v_true=V_TRUE,
                        v_pad=V_PAD)
    mu = _rand(rng, dev, batch, ko, 1, 1, scale=0.1)
    rstd = 0.5 + _rand(rng, dev, batch, ko, 1, 1, scale=0.1).abs()
    lng, lnb = 1.0 + _rand(rng, dev, c_in, V_PAD, scale=0.1), _rand(rng, dev, c_in, V_PAD)
    lng[:, V_TRUE:] = 0.0
    lnb[:, V_TRUE:] = 0.0
    args = (_rand(rng, dev, batch, ko, c_in, V_PAD), mu, rstd, lng, lnb,
            _rand(rng, dev, ko, c_in, cfg.g, scale=(ko * c_in) ** -0.5),
            _rand(rng, dev, cfg.g, scale=0.1))
    cot = (_rand(rng, dev, batch, 1, c0, V_PAD, scale=1e-3),
           *(_rand(rng, dev, batch, 1, 1, 1, scale=1e-5) for _ in range(2)))
    assert bool((cot[0][..., V_TRUE:] != 0).any())
    got = oh.ohead_bwd(cfg, *args, *cot, drop=drop)
    assert all(torch.equal(a, b) for a, b in zip(got, oh.ohead_bwd(cfg, *args, *cot, drop=drop)))
    _close_all(got, oh.ohead_bwd_reference(cfg, *args, *cot, drop))


@pytest.mark.parametrize("drop", [None, DROP])
@pytest.mark.parametrize("act", ["glu", "gtu", "relu", "silu"])
def test_ohead_bwd_matches_plain(dev, act, drop):
    rng = np.random.default_rng(54)
    cfg = oh.OutHeadCfg(ko=4, c_in=16, c0=40, c1=24, c_end=1, act_func=act, v_true=V_TRUE,
                        v_pad=V_PAD)
    args = (_rand(rng, dev, B, cfg.ko, cfg.c_in, V_PAD), *_ln_args(rng, dev, cfg.ko, cfg.c_in),
            _rand(rng, dev, cfg.ko, cfg.c_in, cfg.g, scale=0.2), _rand(rng, dev, cfg.g, scale=0.1))
    _close_all(oh.ohead_fwd(cfg, *args, drop=drop), oh.ohead_reference(cfg, *args, drop))
    cot = (_rand(rng, dev, B, 1, cfg.c0, V_PAD), _rand(rng, dev, B, 1, 1, 1, scale=1e-2),
           _rand(rng, dev, B, 1, 1, 1, scale=1e-2))
    got = oh.ohead_bwd(cfg, *args, *cot, drop=drop)
    assert all(torch.equal(a, b) for a, b in zip(got, oh.ohead_bwd(cfg, *args, *cot, drop=drop)))
    _close_all(got, oh.ohead_bwd_reference(cfg, *args, *cot, drop))


@pytest.mark.parametrize("drop", [None, DROP])
def test_ofc_bwd_matches_plain(dev, drop):
    rng = np.random.default_rng(55)
    cfg = oh.OutHeadCfg(ko=4, c_in=16, c0=40, c1=24, c_end=1, act_func="glu", v_true=V_TRUE,
                        v_pad=V_PAD)
    args = (_rand(rng, dev, B, 1, cfg.c0, V_PAD), *_ln_args(rng, dev, 1, cfg.c0),
            _rand(rng, dev, cfg.c0, cfg.c1, scale=0.2), _rand(rng, dev, cfg.c1, scale=0.1),
            _rand(rng, dev, cfg.c1, cfg.c_end, scale=0.2), _rand(rng, dev, cfg.c_end, scale=0.1))
    _close_all([oh.ofc_fwd(cfg, *args, drop=drop)], [oh.ofc_reference(cfg, *args, drop)])
    gout = _rand(rng, dev, B, 1, cfg.c_end, V_PAD)
    got = oh.ofc_bwd(cfg, *args, gout, drop=drop)
    assert all(torch.equal(a, b) for a, b in zip(got, oh.ofc_bwd(cfg, *args, gout, drop=drop)))
    _close_all(got, oh.ofc_bwd_reference(cfg, *args, gout, drop))


# (c0, c1, c_end, dropout): the recompute's rows and dh's channels c0, the fc
# pass's 64-channel passes over c1, the fc2 outputs c_end it keeps
OFC_BWD_EDGES = [(16, 16, 1, True), (100, 72, 5, False), (128, 128, 16, True),
                 (130, 16, 16, False), (130, 128, 1, True), (16, 72, 16, False),
                 (100, 128, 5, True), (128, 16, 1, False)]


@pytest.mark.parametrize("c0,c1,c_end,dropped", OFC_BWD_EDGES)
def test_ofc_bwd_at_tile_edges_matches_plain(dev, c0, c1, c_end, dropped):
    """K4b (the fc pass on the tile, dw2 from its partials, dh on the data
    gradient's tile without a residual) where it cuts its work unevenly,
    on V = 300 of Vp = 384 lanes (6 of the fc pass's 64-lane tiles, 3 of the
    data gradient's 128) with a nonzero ``gout`` on the padded lanes, batch
    2, cotangents at a training step's scale: against the plain version, a
    repeat bit-identical, and no ``contract_kernel`` among its launches."""
    rng = np.random.default_rng(81)
    v_true, v_pad, b = 300, 384, 2
    cfg = oh.OutHeadCfg(ko=4, c_in=16, c0=c0, c1=c1, c_end=c_end, act_func="glu",
                        v_true=v_true, v_pad=v_pad)
    lnw, lnb = 1.0 + _rand(rng, dev, c0, v_pad, scale=0.1), _rand(rng, dev, c0, v_pad)
    lnw[:, v_true:] = 0.0
    lnb[:, v_true:] = 0.0
    args = (_rand(rng, dev, b, 1, c0, v_pad), _rand(rng, dev, b, 1, 1, 1, scale=0.1),
            0.5 + _rand(rng, dev, b, 1, 1, 1, scale=0.1).abs(), lnw, lnb,
            _rand(rng, dev, c0, c1, scale=c0 ** -0.5), _rand(rng, dev, c1, scale=0.1),
            _rand(rng, dev, c1, c_end, scale=c1 ** -0.5), _rand(rng, dev, c_end, scale=0.1))
    gout = _rand(rng, dev, b, 1, c_end, v_pad, scale=1e-3)
    drop = DROP if dropped else None
    got = oh.ofc_bwd(cfg, *args, gout, drop=drop)
    assert all(torch.equal(a, c) for a, c in zip(got, oh.ofc_bwd(cfg, *args, gout, drop=drop)))
    _close_all(got, oh.ofc_bwd_reference(cfg, *args, gout, drop))
    ev = launches(torch, lambda: oh.ofc_bwd(cfg, *args, gout, drop=drop))
    assert not retired_launches("ofc_bwd", ev), [e["name"] for e in ev]


K12B_CASES = [(act, gct, ks) for gct, ks in (("cheb_graph_conv", 1), ("cheb_graph_conv", 2),
                                             ("cheb_graph_conv", 3), ("cheb_graph_conv", 4),
                                             ("graph_conv", 1))
              for act in ("glu", "gtu", "relu", "silu")]


def _k12_general_case(dev, i):
    """K12B_CASES[i] with the block input c_in 1, 3 and 64 in turn, dropout on."""
    act, gct, ks = K12B_CASES[i]
    c_in = (1, 3, 64)[i % 3]
    rng = np.random.default_rng(90 + i)
    cfg = fs.FusedBlockConfig(kt=3, ks=ks, act_func=act, graph_conv_type=gct, droprate=0.5,
                              v_true=V_TRUE, t_in=12 if c_in == 1 else 8, c_in=c_in,
                              c0=max(32, c_in), c1=16, c2=32, training=True)
    scales = (c_in ** -0.5, 0.1, 0.2, 0.1, 0.2, 0.1, 0.2, 0.1, 0.1, 0.1)
    w = [_rand(rng, dev, *shape, scale=sc) for shape, sc in zip(cfg.weight_shapes(), scales)]
    w[8] = w[8] + 1.0
    gso = _rand(rng, dev, V_TRUE, V_TRUE, scale=0.1)
    x = _rand(rng, dev, B, cfg.t_in, V_TRUE, c_in)
    return rng, cfg, x, gso, w, Drop(0.5, 78, 2)


@pytest.mark.parametrize("i", range(len(K12B_CASES)))
def test_k12f_matches_plain_without_the_retired_launches(dev, i):
    """K12f (the graph product on the tile, h by tail_h_kernel, conv 2 and
    gate 2 on the gate GEMM, the output stage in the transposing tile) at
    Ks 1-4 and ``graph_conv``, every gate, c_in 1, 3 and 64, dropout on:
    against the plain version, its ReLU output through ``relu_out``, a
    repeat bit-identical, and no launch of a retired kernel
    (``contract_kernel``, ``gate_fwd_kernel``)."""
    _, cfg, x, gso, w, drop = _k12_general_case(dev, i)
    h = torch.empty((B, cfg.t1, V_TRUE, cfg.c1), device=dev)
    y = fs.stblock_fwd(cfg, x, gso, *w, drop=drop, relu_out=h)
    h2 = torch.empty_like(h)
    assert torch.equal(y, fs.stblock_fwd(cfg, x, gso, *w, drop=drop, relu_out=h2))
    assert torch.equal(h, h2)
    torch.testing.assert_close(y, fs.st_block_reference(cfg, x, gso, w, drop), **TOL)
    torch.testing.assert_close(h, torch.relu(fs.relu_input(cfg, x, gso, w)), **TOL)
    ev = launches(torch, lambda: fs.stblock_fwd(cfg, x, gso, *w, drop=drop, relu_out=h))
    assert not retired_launches("stblock_fwd", ev), [e["name"] for e in ev]


@pytest.mark.parametrize("i", range(len(K12B_CASES)))
def test_k12b_matches_plain_without_the_retired_launches(dev, i):
    """K12b's backward (K2b's tail, K1b's head around the adjoint chain)
    at Ks 1-4 and ``graph_conv``, every gate, the block input c_in 1, 3 and
    64 in turn (the head's data gradient by lanes or on the tile), dropout
    on: against the plain version at the kernel's ReLU decisions (read back
    through ``relu_out``), a repeat bit-identical, and no launch of a
    retired kernel over the whole call, its forward recompute included."""
    rng, cfg, x, gso, w, drop = _k12_general_case(dev, i)
    h = torch.empty((B, cfg.t1, V_TRUE, cfg.c1), device=dev)
    fs.stblock_fwd(cfg, x, gso, *w, drop=drop, relu_out=h)
    gy = _rand(rng, dev, B, cfg.t2, V_TRUE, cfg.c2)
    got = fs.stblock_bwd(cfg, x, gso, *w, gy, drop=drop)
    assert all(torch.equal(a, b) for a, b in zip(got, fs.stblock_bwd(cfg, x, gso, *w, gy,
                                                                      drop=drop)))
    ref = fs.st_block_bwd_reference(cfg, x, gso, w, gy, drop, relu_mask=(h > 0).float())
    for k, (a, b) in enumerate(zip(got, ref)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * max(1.0, float(b.abs().max())),
                                   msg=lambda m, k=k: f"output {k}: {m}")
    ev = launches(torch, lambda: fs.stblock_bwd(cfg, x, gso, *w, gy, drop=drop))
    assert not retired_launches("stblock_bwd", ev), [e["name"] for e in ev]


@pytest.mark.parametrize("gct,ks", [("cheb_graph_conv", 4), ("graph_conv", 1)])
@pytest.mark.parametrize("batch,t_in", [(3, 12), (71, 12), (1, 7)])
def test_k12_graph_product_edges_match_plain(dev, batch, t_in, gct, ks):
    """The graph product's edges through K12f and K12b: V = 300 (Vp 384, the
    last 128-vertex column tile 44 of 128 true), rows B·t1·c1 = 480, 11,360
    and 80, none a multiple of the row tile (64 on the small grid of batches
    3 and 1, 128 on the wide grid of batch 71), and the adjoint's in-place
    ``y == out`` (the Chebyshev recurrence at Ks 4; ``graph_conv``'s dxg);
    at batch 1 the padded GSO does not fit in K12b's ds1, where it lives at
    the other shapes, so K12b carves a buffer of its own; forward and
    gradients against the plain versions, a repeat bit-identical."""
    v = 300
    rng = np.random.default_rng(95 + batch)
    cfg = fs.FusedBlockConfig(kt=3, ks=ks, act_func="glu", graph_conv_type=gct, droprate=0.5,
                              v_true=v, t_in=t_in, c_in=1, c0=32, c1=16, c2=32, training=True)
    scales = (1.0, 0.1, 0.2, 0.1, 0.2, 0.1, 0.2, 0.1, 0.1, 0.1)
    w = [_rand(rng, dev, *shape, scale=sc) for shape, sc in zip(cfg.weight_shapes(), scales)]
    w[8] = w[8] + 1.0
    gso = _rand(rng, dev, v, v, scale=v ** -0.5)
    x = _rand(rng, dev, batch, cfg.t_in, v, 1)
    drop = Drop(0.5, 79, 1)
    h = torch.empty((batch, cfg.t1, v, cfg.c1), device=dev)
    y = fs.stblock_fwd(cfg, x, gso, *w, drop=drop, relu_out=h)
    assert torch.equal(y, fs.stblock_fwd(cfg, x, gso, *w, drop=drop))
    torch.testing.assert_close(y, fs.st_block_reference(cfg, x, gso, w, drop), **TOL)
    torch.testing.assert_close(h, torch.relu(fs.relu_input(cfg, x, gso, w)), **TOL)
    gy = _rand(rng, dev, batch, cfg.t2, v, cfg.c2)
    got = fs.stblock_bwd(cfg, x, gso, *w, gy, drop=drop)
    assert all(torch.equal(a, b) for a, b in zip(got, fs.stblock_bwd(cfg, x, gso, *w, gy,
                                                                      drop=drop)))
    ref = fs.st_block_bwd_reference(cfg, x, gso, w, gy, drop, relu_mask=(h > 0).float())
    for k, (a, b) in enumerate(zip(got, ref)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * max(1.0, float(b.abs().max())),
                                   msg=lambda m, k=k: f"output {k}: {m}")


def test_k12f_layernorm_of_a_large_mean_matches_plain(dev):
    """K12f's LayerNorm where every a2 row has |mean| / std >= 1e3: there the
    one-pass variance Σa²/n − mu² loses the variance in f32 (checked below
    on the plain a2), and the kernel's two-pass statistics keep it, so its
    rows come out with unit variance and equal to the plain version's. The
    block is built so that a2 holds exact f32 values on a grid of 1/4 around
    1024 (gcb = −100 turns h to 0, so a2 = relu(c2b)), 2048 to a row (V =
    64 of 128 lanes, c2 = 32), so a row's sum and mean are exact in any
    order: a deviation comes from the statistics, not from two orders of
    summing a2."""
    rng, v = np.random.default_rng(97), 64
    cfg = fs.FusedBlockConfig(kt=3, ks=3, act_func="relu", graph_conv_type="cheb_graph_conv",
                              droprate=0.5, v_true=v, t_in=8, c_in=3, c0=32, c1=16, c2=32,
                              training=False)
    scales = (0.3, 0.1, 0.2, 0.1, 0.2, 0.1, 0.2, 0.1, 0.1, 0.1)
    w = [_rand(rng, dev, *shape, scale=sc) for shape, sc in zip(cfg.weight_shapes(), scales)]
    w[5] = torch.full_like(w[5], -100.0)                               # gcb: h = 0
    c2b = 1024.0 + rng.integers(-4, 5, cfg.c2) / 4.0
    w[7] = torch.from_numpy(c2b).float().to(dev)
    w[8], w[9] = torch.ones_like(w[8]), torch.zeros_like(w[9])         # the affine off
    gso = _rand(rng, dev, v, v, scale=0.1)
    x = _rand(rng, dev, B, cfg.t_in, v, cfg.c_in)
    h = torch.empty((B, cfg.t1, v, cfg.c1), device=dev)
    y = fs.stblock_fwd(cfg, x, gso, *w, relu_out=h)
    assert not bool(h.any())
    a2 = np.broadcast_to(c2b.astype(np.float32), (v, cfg.c2)).reshape(-1)
    assert abs(a2.astype(np.float64).mean()) >= 1e3 * a2.astype(np.float64).std()
    sq = np.cumsum(a2 * a2, dtype=np.float32)[-1] / np.float32(a2.size)
    one_pass = float(sq - np.float32(a2.mean(dtype=np.float32)) ** 2)
    assert abs(one_pass / a2.astype(np.float64).var() - 1.0) > 0.1
    torch.testing.assert_close(y, fs.st_block_reference(cfg, x, gso, w), **TOL)
    var = y.double().pow(2).mean((2, 3))
    assert float((var - 1.0).abs().max()) < 1e-4, var


@pytest.mark.parametrize("v_true", [V_TRUE, 228])
def test_kernel_masks_equal_the_plain_mask(dev, v_true):
    for name, (got, plain) in mask_probes(DROP, B, 8, v_true, V_PAD, dev).items():
        assert torch.equal(got, plain), name


def _banded_op(dev, n_vertex, bs, gso_type="sym_norm_lap", **kw):
    """The banded operator ``kw`` asks for (K5's: ``nv=True, nv_only=True``)."""
    art = build_gso(random_road_graph(n_vertex, k_neighbors=6, seed=0), gso_type, cheb=True)
    art = GraphShiftOperator(matrix=permute_matrix(art.matrix, rcm_ordering(art.matrix)),
                             gso_type=gso_type, cheb_rescaled=True, lam_max=art.lam_max)
    return banded_graph_op(art, block_size=bs, device=dev, **kw)


@pytest.mark.parametrize("n", [480, 97])        # N a tile multiple, and not
@pytest.mark.parametrize("mode", ["single", "pair", "chain"])
@pytest.mark.parametrize("n_vertex,bs", [(600, 128), (600, 256), (200, 256)])
def test_k5_matches_plain(dev, n_vertex, bs, mode, n):
    """Every mode against its plain version; (200, 256) is a one-block-row
    pack. The operand's padded lanes are not zero, so the padding rules are
    held too. A repeat launch is bit-identical."""
    op = _banded_op(dev, n_vertex, bs, nv=True, nv_only=True)
    rng = np.random.default_rng(5)
    x = _rand(rng, dev, n, op.v_pad)
    g = _rand(rng, dev, n, op.v_pad) if mode == "chain" else None
    before = kernels.launch_counts()[f"nv_{mode}"]
    out1 = nv.stream_nv(op.slabs_nv, op.lo, x, g, mode, index=op.index_nv)
    out2 = nv.stream_nv(op.slabs_nv, op.lo, x, g, mode, index=op.index_nv)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[f"nv_{mode}"] == before + 2
    ref = nv.stream_nv_reference(op.slabs_nv, op.lo, x, g, mode)
    outs1, outs2, refs = ([o] if mode == "single" else list(o) for o in (out1, out2, ref))
    for a, b, r in zip(outs1, outs2, refs):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, r, **TOL)


def test_k5_autograd_matches_plain(dev):
    """The Functions' backward on the card (K5 single and chain on the
    transpose pack of a non-symmetric GSO) against the same on the CPU."""
    op = _banded_op(dev, 600, 128, "rw_norm_lap", nv=True, nv_only=True)
    assert op.slabs_nv_t is not op.slabs_nv
    rng = np.random.default_rng(6)
    x, g1, g2 = (_rand(rng, dev, 96, op.v_pad) for _ in range(3))
    pack = (op.slabs_nv, op.lo, op.slabs_nv_t, op.lo_t)
    index = {"index": op.index_nv, "index_t": op.index_nv_t}
    grads = []
    for d in (dev, torch.device("cpu")):
        xx = x.to(d).requires_grad_(True)
        p = [a.to(d) for a in pack]
        t1, t2 = nv.cheb_pair_nv(*p, xx, **index)
        y = nv.banded_spmm_nv(*p, xx, scale=2.0, **index)
        loss = (t1 * g1.to(d)).sum() + (t2 * g2.to(d)).sum() + (y * g1.to(d)).sum()
        grads.append(torch.autograd.grad(loss, [xx])[0].cpu())
    torch.testing.assert_close(grads[0], grads[1], **TOL)


def test_k5_wrapper_rejects_what_the_kernel_does_not_take(dev):
    op = _banded_op(dev, 600, 256, nv=True, nv_only=True)
    flat = torch.zeros(4 * op.v_pad + 1, device=dev)
    idx = {"index": op.index_nv}
    with pytest.raises(ValueError, match="16-byte"):   # contiguous, one float off
        nv.stream_nv(op.slabs_nv, op.lo, flat[1:].view(4, op.v_pad), **idx)
    with pytest.raises(ValueError, match="int32"):
        nv.stream_nv(op.slabs_nv, op.lo.long(), flat[:-1].view(4, op.v_pad), **idx)
    with pytest.raises(ValueError, match="v_pad % bs"):
        nv.stream_nv(op.slabs_nv, op.lo, torch.zeros(4, op.v_pad + 64, device=dev), **idx)
    with pytest.raises(ValueError, match="no nonzero index"):   # the card walks the index
        nv.stream_nv(op.slabs_nv, op.lo, flat[:-1].view(4, op.v_pad))


@pytest.mark.parametrize("n", [480, 97])        # N a tile multiple, and not
@pytest.mark.parametrize("mode", ["single", "pair", "chain"])
@pytest.mark.parametrize("n_vertex,bs", [(600, 128), (600, 256), (200, 256)])
def test_k5_int8_matches_plain(dev, n_vertex, bs, mode, n):
    """K5 on an int8 pack with its per-lane scales, every mode, against its
    plain version; a repeat launch is bit-identical; the scale is alpha."""
    op = _banded_op(dev, n_vertex, bs, quantize=True, nv=True, nv_only=True)
    rng = np.random.default_rng(5)
    x = _rand(rng, dev, n, op.v_pad)
    g = _rand(rng, dev, n, op.v_pad) if mode == "chain" else None
    name = nv.launch_name(mode, True)
    before = kernels.launch_counts()[name]
    out1 = nv.stream_nv(op.slabs_nv, op.lo, x, g, mode, scales=op.scales, index=op.index_nv)
    out2 = nv.stream_nv(op.slabs_nv, op.lo, x, g, mode, scales=op.scales, index=op.index_nv)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 2
    ref = nv.stream_nv_reference(op.slabs_nv, op.lo, x, g, mode, scales=op.scales)
    outs1, outs2, refs = ([o] if mode == "single" else list(o) for o in (out1, out2, ref))
    for a, b, r in zip(outs1, outs2, refs):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, r, **TOL)
    if mode == "single":
        torch.testing.assert_close(nv.stream_nv(op.slabs_nv, op.lo, x, scales=op.scales,
                                                scale=2.0, index=op.index_nv),
                                   2.0 * refs[0], **TOL)


def test_k5_int8_autograd_matches_plain(dev):
    """The int8 Functions' backward on the card (K5 single and chain on the
    transpose pack of a non-symmetric GSO, with its scales) against the same
    on the CPU."""
    op = _banded_op(dev, 600, 128, "rw_norm_lap", quantize=True, nv=True, nv_only=True)
    assert op.slabs_nv_t is not op.slabs_nv
    rng = np.random.default_rng(6)
    x, g1, g2 = (_rand(rng, dev, 96, op.v_pad) for _ in range(3))
    pack = (op.slabs_nv, op.lo, op.slabs_nv_t, op.lo_t)
    index = {"index": op.index_nv, "index_t": op.index_nv_t}
    grads = []
    for d in (dev, torch.device("cpu")):
        xx = x.to(d).requires_grad_(True)
        p = [a.to(d) for a in pack]
        sc = (op.scales.to(d), op.scales_t.to(d))
        t1, t2 = nv.cheb_pair_nv(*p, xx, *sc, **index)
        y = nv.banded_spmm_nv(*p, xx, *sc, scale=2.0, **index)
        loss = (t1 * g1.to(d)).sum() + (t2 * g2.to(d)).sum() + (y * g1.to(d)).sum()
        grads.append(torch.autograd.grad(loss, [xx])[0].cpu())
    torch.testing.assert_close(grads[0], grads[1], **TOL)


# the vn kernel's wrappers: launch name -> (wrapper, mode, the operator's arguments)
VN_CASES = {
    "vn_single": (bvn.banded_spmm, "single", {}),
    "vn_single_int8": (bvn.banded_spmm, "single", {"quantize": True}),
    "vn_pair_resident": (bvn.banded_cheb_pair, "pair", {"stream": False}),
    "vn_pair": (bvn.banded_cheb_pair_stream, "pair", {}),
    "vn_pair_int8": (bvn.banded_cheb_pair_stream, "pair", {"quantize": True}),
    "vn_chain": (bvn.banded_chain_stream, "chain", {}),
    "vn_chain_int8": (bvn.banded_chain_stream, "chain", {"quantize": True}),
}


@pytest.mark.parametrize("n", [480, 97])        # N a tile multiple, and not
@pytest.mark.parametrize("name", sorted(VN_CASES))
@pytest.mark.parametrize("n_vertex,bs", [(600, 128), (600, 256), (200, 256)])
def test_k7_k8_k9_match_plain(dev, n_vertex, bs, name, n):
    """Every wrapper of the vn kernel (K7 single, K8 pair on the clamped
    pack, K9 pair and chain on the stream pack; f32 and int8) against its
    plain version, the transpose pack of a non-symmetric GSO for the chain;
    the operand's rows past nbr·bs are not zero, so the padding rules are
    held too. A repeat launch is bit-identical; K7's scale is alpha."""
    wrapper, mode, kw = VN_CASES[name]
    op = _banded_op(dev, n_vertex, bs, "rw_norm_lap", **kw)
    rng = np.random.default_rng(5)
    x = _rand(rng, dev, op.v_pad, n)
    if mode == "chain":
        args, sc = (op.slabs_t, op.lo_t, x, _rand(rng, dev, op.v_pad, n)), op.scales_t
        kwargs = {"scales_t": sc} if sc is not None else {}
        kwargs["index_t"] = op.index_t
    else:
        args, sc = (op.slabs, op.lo, x), op.scales
        kwargs = {"scales": sc} if sc is not None else {}
        kwargs["index"] = op.index
    before = kernels.launch_counts()[name]
    out1, out2 = wrapper(*args, **kwargs), wrapper(*args, **kwargs)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 2
    g = args[3] if mode == "chain" else None
    ref = bvn.banded_vn_reference(*args[:3], g, mode, scales=sc)
    outs1, outs2, refs = ([o] if mode == "single" else list(o) for o in (out1, out2, ref))
    for a, b, r in zip(outs1, outs2, refs):
        assert a.shape == (op.v_pad, n) and torch.equal(a, b)
        torch.testing.assert_close(a, r, **TOL)
    if mode == "single":
        torch.testing.assert_close(wrapper(*args, scale=2.0, **kwargs), 2.0 * refs[0], **TOL)


@pytest.mark.parametrize("kw", [{}, {"quantize": True}, {"stream": False}],
                         ids=["stream", "int8", "clamped"])
def test_k7_k8_k9_autograd_matches_plain(dev, kw):
    """The vn Functions' backward on the card (K7 on the transpose pack, K8's
    two K7 applications, K9's chain; a non-symmetric GSO) against the same
    on the CPU, through every surface of the operator."""
    op = _banded_op(dev, 600, 128, "rw_norm_lap", **kw)
    assert op.slabs_t is not op.slabs
    rng = np.random.default_rng(6)
    x = _rand(rng, dev, 3, 4, 600, 5)
    g1, g2, g3 = (_rand(rng, dev, 3, 4, 600, 5) for _ in range(3))
    grads = []
    for d in (dev, torch.device("cpu")):
        cop = dataclasses.replace(op, **{f.name: getattr(op, f.name).to(d)
                                         for f in dataclasses.fields(op)
                                         if isinstance(getattr(op, f.name), torch.Tensor)})
        xx = x.to(d).requires_grad_(True)
        t1, t2 = cop.cheb_pair(xx)
        loss = (t1 * g1.to(d)).sum() + (t2 * g2.to(d)).sum() + (cop(xx, scale=2.0)
                                                                * g3.to(d)).sum()
        grads.append(torch.autograd.grad(loss, [xx])[0].cpu())
    torch.testing.assert_close(grads[0], grads[1], **TOL)


def test_vn_wrapper_rejects_what_the_kernel_does_not_take(dev):
    op = _banded_op(dev, 600, 256, quantize=True)
    x = torch.zeros(op.v_pad, 8, device=dev)
    with pytest.raises(ValueError, match="int8"):   # int8 slabs without their scales
        bvn.banded_spmm(op.slabs, op.lo, x)
    with pytest.raises(ValueError, match="int32"):
        bvn.banded_spmm(op.slabs, op.lo.long(), x, scales=op.scales)
    with pytest.raises(TypeError, match="float32"):
        bvn.banded_spmm(op.slabs, op.lo, x.double(), scales=op.scales)
    with pytest.raises(ValueError, match="contiguous"):
        bvn.banded_spmm(op.slabs, op.lo, x.T.contiguous().T, scales=op.scales)
    with pytest.raises(ValueError, match="chain"):   # the chain without its g1
        bvn.banded_chain_stream(op.slabs_t, op.lo_t, x, None, scales_t=op.scales_t)
    with pytest.raises(ValueError, match="no nonzero index"):   # the card walks the index
        bvn.banded_spmm(op.slabs, op.lo, x, scales=op.scales)


# --- the bf16 variants of the vn kernel (K7-K9) and of K10 -------------------

BF16_REL = 2.0 ** -7   # two ulps of bf16 (kernel and plain version round at the same points)
BF16_LOOSE = 2.0 ** -6   # a whole pair or chain against its plain version (see _vn_bf16_check)


def _bf16_close(got, ref, *, add=None, rel=BF16_REL):
    """Each element within ``rel · (|ref| + |add|)`` plus a floor of
    1e-4 · min(1, max |ref|) (the float32 sums run in another order)."""
    assert got.dtype == ref.dtype == torch.bfloat16 and got.shape == ref.shape
    g, r = got.float(), ref.float()
    assert torch.isfinite(g).all()
    scale = r.abs() if add is None else r.abs() + add.float().abs()
    d = (g - r).abs()
    bad = d > rel * scale + 1e-4 * min(1.0, float(r.abs().max()))
    assert not bad.any(), f"{int(bad.sum())} of {bad.numel()} elements, max |Δ| {float(d.max())}"


def _vn_bf16_check(slabs, lo, x, g, mode, scales, got):
    """A bf16 vn call's outputs against its plain version: ``single`` and
    ``mid`` within two ulps; the second pass within two ulps of its plain
    version fed with the kernel's own ``mid`` (a ``mid`` an ulp apart would
    move it further where ``2·A·mid`` and ``x`` cancel); the whole against
    the plain version within ``BF16_LOOSE · (|ref| + |x|)``."""
    ref = bvn.banded_vn_reference(slabs, lo, x, g, mode, scales=scales)
    if mode == "single":
        _bf16_close(got, ref)
        return
    _bf16_close(got[0], ref[0])
    alpha, beta = (2.0, -1.0) if mode == "pair" else (1.0, -1.0)
    _bf16_close(got[1], bvn.vn_pass_reference(slabs, lo, got[0], x, alpha=alpha, beta=beta,
                                              scales=scales))
    _bf16_close(got[1], ref[1], add=x, rel=BF16_LOOSE)


# launch name -> (wrapper, mode, slabs, the operator's arguments)
VN_BF16_CASES = {
    f"{name}/{slabs}": (wrapper, mode, slabs, {**kw, **({"quantize": True} if slabs == "int8"
                                                        else {"dtype": torch.bfloat16}
                                                        if slabs == "bf16" else {})})
    for name, (wrapper, mode, kw) in {
        "vn_single_bf16": (bvn.banded_spmm, "single", {}),
        "vn_pair_resident_bf16": (bvn.banded_cheb_pair, "pair", {"stream": False}),
        "vn_pair_bf16": (bvn.banded_cheb_pair_stream, "pair", {}),
        "vn_chain_bf16": (bvn.banded_chain_stream, "chain", {})}.items()
    for slabs in ("f32", "bf16", "int8") if name != "vn_pair_resident_bf16" or slabs != "int8"
}


@pytest.mark.parametrize("n", [480, 97])        # 16-byte vectors of eight, and scalar steps
@pytest.mark.parametrize("case", sorted(VN_BF16_CASES))
def test_vn_bf16_matches_plain(dev, case, n):
    """The bf16 variant of every vn wrapper (K7, K8 on the clamped pack, K9
    pair and chain) with a bf16 operand over float32, bf16 and int8 slabs of
    a non-symmetric GSO, against its plain version in bf16 (the same
    rounding points); a repeat launch bit-identical, counted under the
    ``_bf16`` name."""
    wrapper, mode, slabs_kind, kw = VN_BF16_CASES[case]
    op = _banded_op(dev, 600, 256, "rw_norm_lap", **kw)
    assert op.slabs.dtype == {"f32": torch.float32, "bf16": torch.bfloat16,
                              "int8": torch.int8}[slabs_kind]
    rng = np.random.default_rng(7)
    x = _rand(rng, dev, op.v_pad, n).bfloat16()
    g = _rand(rng, dev, op.v_pad, n).bfloat16() if mode == "chain" else None
    slabs, lo, sc, index = ((op.slabs_t, op.lo_t, op.scales_t, op.index_t) if mode == "chain"
                            else (op.slabs, op.lo, op.scales, op.index))
    kwargs = {}
    if sc is not None:
        kwargs["scales_t" if mode == "chain" else "scales"] = sc
    kwargs["index_t" if mode == "chain" else "index"] = index
    args = (slabs, lo, x, g) if mode == "chain" else (slabs, lo, x)
    name = bvn.launch_name(mode, sc is not None, resident=wrapper is bvn.banded_cheb_pair,
                           bf16=True)
    before = kernels.launch_counts()[name]
    out1, out2 = wrapper(*args, **kwargs), wrapper(*args, **kwargs)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 2
    for a, b in zip(flat_outs(out1), flat_outs(out2)):
        assert a.dtype == torch.bfloat16 and a.shape == (op.v_pad, n) and torch.equal(a, b)
    _vn_bf16_check(slabs, lo, x, g, mode, sc, out1)
    if mode == "single":
        _bf16_close(wrapper(*args, scale=2.0, **kwargs),
                    bvn.banded_vn_reference(slabs, lo, x, scales=sc, scale=2.0))


def flat_outs(out):
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("slabs", ["f32", "bf16", "int8"])
def test_vn_bf16_autograd_matches_plain(dev, slabs):
    """The bf16 model's graph terms through every surface of the banded
    operator (K9 pair and chain, K7 at scale 2 and its transpose) with a
    bf16 operand, on the card against the same on the CPU."""
    kw = {"quantize": True} if slabs == "int8" else {"dtype": torch.bfloat16} \
        if slabs == "bf16" else {}
    op = _banded_op(dev, 600, 128, "rw_norm_lap", **kw)
    rng = np.random.default_rng(6)
    x = _rand(rng, dev, 3, 4, 600, 5).bfloat16()
    g1, g2, g3 = (_rand(rng, dev, 3, 4, 600, 5).bfloat16() for _ in range(3))
    grads = []
    for d in (dev, torch.device("cpu")):
        cop = dataclasses.replace(op, **{f.name: getattr(op, f.name).to(d)
                                         for f in dataclasses.fields(op)
                                         if isinstance(getattr(op, f.name), torch.Tensor)})
        xx = x.to(d).requires_grad_(True)
        t1, t2 = cop.cheb_pair(xx)
        assert t1.dtype == t2.dtype == torch.bfloat16
        loss = (t1.float() * g1.to(d).float()).sum() + (t2.float() * g2.to(d).float()).sum() \
            + (cop(xx, scale=2.0).float() * g3.to(d).float()).sum()
        grads.append(torch.autograd.grad(loss, [xx])[0].cpu())
    assert grads[0].dtype == torch.bfloat16
    _bf16_close(grads[0], grads[1], rel=BF16_LOOSE)


@pytest.mark.parametrize("n", [160, 97])        # N as on the 1M route's block 1, and ragged
@pytest.mark.parametrize("scale", [1.0, 2.0])
@pytest.mark.parametrize("tiles", ["f32", "bf16"])
def test_k10_bf16_matches_plain(dev, tiles, scale, n):
    """K10's bf16 variant (a bf16 operand over float32 and bf16 tiles)
    against its plain version in bf16; a repeat launch bit-identical,
    counted under ``bcsr_spmm_bf16`` and not ``bcsr_spmm``."""
    op = bcsr_graph_op(_rcm_gso(600), block_size=64, device=dev,
                       dtype=torch.bfloat16 if tiles == "bf16" else torch.float32)
    x = _rand(np.random.default_rng(5), dev, op.n_vertex_pad, n).bfloat16()
    before = kernels.launch_counts()
    out1 = spm.bcsr_spmm(op.pack, x, scale=scale)
    out2 = spm.bcsr_spmm(op.pack, x, scale=scale)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["bcsr_spmm_bf16"] == before["bcsr_spmm_bf16"] + 2
    assert after["bcsr_spmm"] == before["bcsr_spmm"]
    assert out1.dtype == torch.bfloat16 and torch.equal(out1, out2)
    _bf16_close(out1, spm.bcsr_spmm_reference(op.pack, x, scale=scale))


def test_k10_bf16_takes_an_unaligned_operand(dev):
    """A bf16 operand off a 16-byte boundary runs the scalar steps."""
    op = _sparse_op("bcsr", dev)
    flat = _rand(np.random.default_rng(3), dev, op.n_vertex_pad * 16 + 1).bfloat16()
    x = flat[1:].view(op.n_vertex_pad, 16)
    assert x.data_ptr() % 16
    got = spm.bcsr_spmm(op.pack, x, scale=2.0)
    torch.cuda.synchronize()
    _bf16_close(got, spm.bcsr_spmm_reference(op.pack, x, scale=2.0))


def test_bcsr_bf16_autograd_matches_plain(dev):
    """The BCSR operator's bf16 surface: forward and operand gradient on the
    card against the CPU; the tile-value gradient (K11) refuses bf16."""
    op = bcsr_graph_op(_rcm_gso(600, "rw_norm_lap"), block_size=64, device=dev)
    rng = np.random.default_rng(8)
    x = _rand(rng, dev, 3, 4, 600, 5).bfloat16()
    w = _rand(rng, dev, 3, 4, 600, 5)
    outs = []
    for d in (dev, torch.device("cpu")):
        pack = lambda p: p._replace(**{k: v.to(d) for k, v in p._asdict().items()  # noqa: E731
                                       if isinstance(v, torch.Tensor)})
        cop = dataclasses.replace(op, pack=pack(op.pack), pack_t=pack(op.pack_t))
        xx = x.to(d).requires_grad_(True)
        y = cop(xx, scale=2.0)
        dx = torch.autograd.grad((y.float() * w.to(d)).sum(), [xx])[0]
        outs.append((y.detach().cpu(), dx.cpu()))
    _bf16_close(outs[0][0], outs[1][0])
    _bf16_close(outs[0][1], outs[1][1], rel=BF16_LOOSE)
    tiles = op.pack.data.detach().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="bf16"):
        spm.bcsr_spmm_vjp(op.pack._replace(data=tiles), op.pack,
                          torch.zeros(op.n_vertex_pad, 8, device=dev, dtype=torch.bfloat16))


def test_nv_kernels_refuse_bf16(dev):
    """K5 and K6 take bf16 values only under a bf16 operand: bf16 slabs or
    tiles under a float32 operand raise, nothing is cast (their bf16
    variants: test_k5_bf16_matches_plain, test_k6_bf16_matches_plain)."""
    op = _banded_op(dev, 600, 256, dtype=torch.bfloat16, nv=True, nv_only=True)
    x = torch.zeros(4, op.v_pad, device=dev)
    with pytest.raises(ValueError, match="bf16 under a bf16 operand"):
        nv.stream_nv(op.slabs_nv, op.lo, x, index=op.index_nv)
    eop = ell_graph_op(_rcm_gso(600), block_size=256, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="bf16 under a bf16 operand"):
        ek.ell_nv(eop.pack, torch.zeros(4, eop.v_pad, device=dev))


def _nv_bf16_check(outs1, outs2, ref, scale):
    """A bf16 K5 / K6 call against its plain version (``bf16_bounds.within``
    beside ``spmm_scale``), a repeat bit-identical."""
    outs1, outs2, ref, scale = ([o] if torch.is_tensor(o) else list(o)
                                for o in (outs1, outs2, ref, scale))
    for a, b in zip(outs1, outs2):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    bb.within(outs1, ref, scale)


@pytest.mark.parametrize("n", [480, 97])        # N a multiple of the 16-byte vector, and not
@pytest.mark.parametrize("mode", ["single", "pair", "chain"])
@pytest.mark.parametrize("slabs", ["f32", "bf16", "int8"])
def test_k5_bf16_matches_plain(dev, slabs, mode, n):
    """K5's bf16 variant over float32, bf16 and int8 slabs, every mode,
    against its plain version; a repeat launch bit-identical; each launch
    counted under its ``_bf16`` name and none under the float32 one."""
    kw = {"f32": {}, "bf16": {"dtype": torch.bfloat16}, "int8": {"quantize": True}}[slabs]
    op = _banded_op(dev, 600, 128, nv=True, nv_only=True, **kw)
    rng = np.random.default_rng(7)
    x = _rand(rng, dev, n, op.v_pad).bfloat16()
    g = _rand(rng, dev, n, op.v_pad).bfloat16() if mode == "chain" else None
    q = op.scales is not None
    name = nv.launch_name(mode, q, bf16=True)
    before = kernels.launch_counts()
    out1 = nv.stream_nv(op.slabs_nv, op.lo, x, g, mode, scales=op.scales, index=op.index_nv)
    out2 = nv.stream_nv(op.slabs_nv, op.lo, x, g, mode, scales=op.scales, index=op.index_nv)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after[name] == before[name] + 2
    assert after[nv.launch_name(mode, q)] == before[nv.launch_name(mode, q)]
    ref = nv.stream_nv_reference(op.slabs_nv, op.lo, x, g, mode, scales=op.scales)
    slabs_abs = op.slabs_nv.float().abs()
    scales_abs = None if op.scales is None else op.scales.abs()
    absa = lambda v: nv.nv_pass_reference(slabs_abs, op.lo, v, scales=scales_abs)  # noqa: E731
    _nv_bf16_check(out1, out2, ref, bb.spmm_scale(absa, x, g, mode))


@pytest.mark.parametrize("n", [480, 97])
@pytest.mark.parametrize("mode", ["single", "pair", "chain"])
@pytest.mark.parametrize("tiles", ["f32", "int8", "bf16"])
def test_k6_bf16_matches_plain(dev, tiles, mode, n):
    """K6's bf16 variant over float32, int8 and bf16 tiles, every mode (the
    product rounded to bf16 before an add, as the JAX ELL path does),
    against its plain version; a repeat bit-identical; counted under
    ``ell_<tiles>_<mode>_bf16`` only."""
    kw = {"f32": {}, "int8": {"quantize": True}, "bf16": {"dtype": torch.bfloat16}}[tiles]
    op = ell_graph_op(_rcm_gso(600), block_size=64, device=dev, **kw)
    rng = np.random.default_rng(8)
    x = _rand(rng, dev, n, op.v_pad).bfloat16()
    g = _rand(rng, dev, n, op.v_pad).bfloat16() if mode == "chain" else None
    name = ek.pack_launch_name(op.pack, mode, x)
    assert name == f"ell_{tiles}_{mode}_bf16"
    before = kernels.launch_counts()
    out1 = ek.ell_nv(op.pack, x, g, mode)
    out2 = ek.ell_nv(op.pack, x, g, mode)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after[name] == before[name] + 2
    if tiles != "bf16":
        f32_name = ek.launch_name(tiles == "int8", mode)
        assert after[f32_name] == before[f32_name]
    ref = ek.ell_nv_reference(op.pack, x, g, mode)
    absp = op.pack._replace(data=op.pack.data.float().abs(),
                            scales=None if op.pack.scales is None else op.pack.scales.abs())
    absa = lambda v: ek._apply_reference(absp, v)  # noqa: E731
    _nv_bf16_check(out1, out2, ref, bb.spmm_scale(absa, x, g, mode))


# --- the banded packs' nonzero index (kernels/nnz_index.py index_from_slabs) --

# banded_graph_op's arguments: the packs K9 and K7 (vn f32 and int8), K8 (the
# clamped pack) and K5 (nv f32 and int8) walk
BANDED_KINDS = {"vn_f32": {}, "vn_int8": {"quantize": True}, "vn_clamped": {"stream": False},
                "nv_f32": {"nv": True, "nv_only": True},
                "nv_int8": {"quantize": True, "nv": True, "nv_only": True}}


def _banded_single(op, kind, x, scale=1.0):
    """(kernel, plain version) of one application on the kind's pack."""
    if kind.startswith("nv"):
        return (nv.stream_nv(op.slabs_nv, op.lo, x, scales=op.scales, scale=scale,
                             index=op.index_nv),
                nv.stream_nv_reference(op.slabs_nv, op.lo, x, scales=op.scales, scale=scale))
    return (bvn.banded_spmm(op.slabs, op.lo, x, scales=op.scales, scale=scale, index=op.index),
            bvn.banded_vn_reference(op.slabs, op.lo, x, scales=op.scales, scale=scale))


def _banded_x(op, kind, n, dev, seed=5):
    shape = (n, op.v_pad) if kind.startswith("nv") else (op.v_pad, n)
    return _rand(np.random.default_rng(seed), dev, *shape)


@pytest.mark.parametrize("kind", sorted(BANDED_KINDS))
def test_banded_index_built_once_across_launches(dev, kind):
    """The first launch builds the pack's index on the card (the operator
    leaves it unbuilt; one pack for both directions of the symmetric GSO,
    except the clamped pack's Aᵀ); repeated launches, every mode, rebuild
    nothing."""
    before = nnz_index.builds()
    op = _banded_op(dev, 600, 128, **BANDED_KINDS[kind])
    assert nnz_index.builds() == before
    x = _banded_x(op, kind, 33, dev)
    for _ in range(3):
        got, ref = _banded_single(op, kind, x)
        if kind.startswith("nv"):
            nv.stream_nv(op.slabs_nv, op.lo, x, None, "pair", scales=op.scales,
                         index=op.index_nv)
            nv.stream_nv(op.slabs_nv, op.lo, x, x, "chain", scales=op.scales,
                         index=op.index_nv_t)
        else:
            bvn.banded_cheb_pair(op.slabs, op.lo, x, index=op.index) if kind == "vn_clamped" \
                else bvn.banded_cheb_pair_stream(op.slabs, op.lo, x, scales=op.scales,
                                                 index=op.index)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, **TOL)
    idx = op.index_nv if kind.startswith("nv") else op.index
    assert nnz_index.builds() == before + 1 and idx.src.device == x.device


@pytest.mark.parametrize("kind", sorted(BANDED_KINDS))
def test_banded_index_follows_an_edited_slab(dev, kind):
    """A zero slab entry inside a window set in place: the next launch
    rebuilds the index once, on the card, and the kernel follows the new
    value; later launches and a detach() alias rebuild nothing."""
    op = _banded_op(dev, 600, 128, **BANDED_KINDS[kind])
    slabs = op.slabs_nv if kind.startswith("nv") else op.slabs
    x = _banded_x(op, kind, 160, dev)
    zeros = torch.nonzero(slabs == 0)
    entry = tuple(int(v) for v in zeros[len(zeros) // 2])
    _banded_single(op, kind, x)
    before = nnz_index.builds()
    with torch.no_grad():
        slabs[entry] = 3 if slabs.dtype == torch.int8 else 0.5
    got, ref = _banded_single(op, kind, x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, **TOL)
    assert nnz_index.builds() == before + 1
    field = "slabs_nv" if kind.startswith("nv") else "slabs"
    alias = dataclasses.replace(op, **{field: slabs.detach()})
    assert torch.equal(_banded_single(alias, kind, x)[0], got)
    assert nnz_index.builds() == before + 1


@pytest.mark.parametrize("kind", ["vn_f32", "nv_int8"])
def test_banded_padded_rows_follow_the_off_tpu_branch(dev, kind):
    """On a stream pack with v_pad > nbr·bs (V = 600, bs = 256: 1024 > 768)
    and N not a multiple of 4: past nbr·bs, A x is 0, t2 = −x and dx = −g2,
    bit for bit, as in the JAX package's off-TPU branch."""
    op = _banded_op(dev, 600, 256, "rw_norm_lap", **BANDED_KINDS[kind])
    nbr, bs = op.lo.shape[0], 256
    assert op.v_pad > nbr * bs
    x, g = _banded_x(op, kind, 97, dev), _banded_x(op, kind, 97, dev, seed=6)
    if kind.startswith("nv"):
        single = nv.stream_nv(op.slabs_nv, op.lo, x, scales=op.scales, index=op.index_nv)
        t1, t2 = nv.stream_nv(op.slabs_nv, op.lo, x, None, "pair", scales=op.scales,
                              index=op.index_nv)
        u, dx = nv.stream_nv(op.slabs_nv_t, op.lo_t, x, g, "chain", scales=op.scales_t,
                             index=op.index_nv_t)
        pad = (slice(None), slice(nbr * bs, None))
    else:
        single = bvn.banded_spmm(op.slabs, op.lo, x, index=op.index)
        t1, t2 = bvn.banded_cheb_pair_stream(op.slabs, op.lo, x, index=op.index)
        u, dx = bvn.banded_chain_stream(op.slabs_t, op.lo_t, x, g, index_t=op.index_t)
        pad = (slice(nbr * bs, None), slice(None))
    torch.cuda.synchronize()
    assert not single[pad].any() and not t1[pad].any()
    assert torch.equal(t2[pad], -x[pad]) and torch.equal(dx[pad], -x[pad])
    assert torch.equal(u[pad], g[pad])


@pytest.mark.parametrize("fused", [True, False])
def test_banded_index_built_once_across_a_fit(dev, fused, tmp_path):
    """A short fit on the banded operator (fused: K5 pair and chain on the
    nv pack; unfused: K9 on the vn stream pack) builds each pack's index at
    its first launch, once (one pack for both directions of the symmetric
    GSO), and the rest of the fit and test() rebuild nothing."""
    from stgcn_tpu_torch import STGCN, ForecastDataset, Trainer, TrainConfig, ZScoreScaler
    from stgcn_tpu_torch.data.synthetic import generate_synthetic_vel

    v, n_his, n_pred = 520, 12, 3
    adj = random_road_graph(v, k_neighbors=6, seed=0)
    art = build_gso(adj, "sym_norm_lap", cheb=True)
    perm = rcm_ordering(art.matrix)
    art = GraphShiftOperator(matrix=permute_matrix(art.matrix, perm), gso_type="sym_norm_lap",
                             cheb_rescaled=True, lam_max=art.lam_max)
    op = banded_graph_op(art, block_size=128, nv=fused, device=dev)
    vel = generate_synthetic_vel(adj, 30, seed=1)[:, perm]
    scaler = ZScoreScaler().fit(vel)
    ds = lambda a: ForecastDataset.from_numpy(scaler.transform(a), n_his, n_pred,  # noqa: E731
                                              device=dev)
    cfg = TrainConfig(n_his=n_his, n_pred=n_pred, droprate=0.5, batch_size=4, fused=fused,
                      ckpt_dir=str(tmp_path), dataset_name="toy")
    tr = Trainer(cfg, STGCN(n_his, v, device=dev), op, ds(vel), ds(vel[:20]), ds(vel[:20]),
                 scaler, device=dev)
    before = nnz_index.builds()
    kernels.reset_launch_counts()
    tr.fit(2)
    tr.test()
    counts = kernels.launch_counts()
    names = ("nv_pair", "nv_chain") if fused else ("vn_pair", "vn_chain")
    assert all(counts[k] > 0 for k in names), counts
    assert nnz_index.builds() == before + 1


def _rcm_gso(n_vertex, gso_type="sym_norm_lap"):
    art = build_gso(random_road_graph(n_vertex, k_neighbors=6, seed=0), gso_type, cheb=True)
    return GraphShiftOperator(matrix=permute_matrix(art.matrix, rcm_ordering(art.matrix)),
                              gso_type=gso_type, cheb_rescaled=True, lam_max=art.lam_max)


@pytest.mark.parametrize("n", [480, 97])        # N a tile multiple, and not
@pytest.mark.parametrize("mode", ["single", "pair", "chain"])
@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("n_vertex,bs", [(600, 64), (600, 256), (200, 256)])
def test_k6_matches_plain(dev, n_vertex, bs, quantize, mode, n):
    """Every mode on f32 and int8 packs against its plain version; (600, 64)
    has block rows with fewer live tiles than max_b (padding tiles), (200,
    256) is a one-block-row pack. A repeat launch is bit-identical."""
    op = ell_graph_op(_rcm_gso(n_vertex), block_size=bs, quantize=quantize, device=dev)
    rng = np.random.default_rng(5)
    x = _rand(rng, dev, n, op.v_pad)
    g = _rand(rng, dev, n, op.v_pad) if mode == "chain" else None
    name = ek.launch_name(quantize, mode)
    before = kernels.launch_counts()[name]
    out1 = ek.ell_nv(op.pack, x, g, mode)
    out2 = ek.ell_nv(op.pack, x, g, mode)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 2
    ref = ek.ell_nv_reference(op.pack, x, g, mode)
    outs1, outs2, refs = ([o] if mode == "single" else list(o) for o in (out1, out2, ref))
    for a, b, r in zip(outs1, outs2, refs):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, r, **TOL)
    if mode == "single":   # the Chebyshev 2G step: into alpha, never into the pack
        torch.testing.assert_close(ek.ell_nv(op.pack, x, scale=2.0), 2.0 * refs[0], **TOL)


@pytest.mark.parametrize("quantize", [False, True])
def test_k6_autograd_matches_plain(dev, quantize):
    """The Functions' backward on the card (K6 single and chain on the
    transpose pack of a non-symmetric GSO) against the same on the CPU."""
    op = ell_graph_op(_rcm_gso(600, "rw_norm_lap"), block_size=64, quantize=quantize,
                      device=dev)
    assert op.pack_t is not op.pack
    rng = np.random.default_rng(6)
    x, g1, g2 = (_rand(rng, dev, 96, op.v_pad) for _ in range(3))
    grads = []
    for d in (dev, torch.device("cpu")):
        xx = x.to(d).requires_grad_(True)
        pack, pack_t = (ek.EllPack(*(None if a is None else a.to(d) for a in p))
                        for p in (op.pack, op.pack_t))
        t1, t2 = ek.ell_cheb_pair_nv(pack, pack_t, xx)
        y = ek.ell_spmm_nv(pack, pack_t, xx, scale=2.0)
        loss = (t1 * g1.to(d)).sum() + (t2 * g2.to(d)).sum() + (y * g1.to(d)).sum()
        grads.append(torch.autograd.grad(loss, [xx])[0].cpu())
    torch.testing.assert_close(grads[0], grads[1], **TOL)


def test_k6_wrapper_rejects_what_the_kernel_does_not_take(dev):
    op = ell_graph_op(_rcm_gso(600), block_size=256, quantize=True, device=dev)
    flat = torch.zeros(4 * op.v_pad + 1, device=dev)
    with pytest.raises(ValueError, match="16-byte"):   # contiguous, one float off
        ek.ell_nv(op.pack, flat[1:].view(4, op.v_pad))
    with pytest.raises(ValueError, match="int32"):
        ek.ell_nv(op.pack._replace(cols=op.pack.cols.long()), flat[:-1].view(4, op.v_pad))
    with pytest.raises(ValueError, match="wide"):
        ek.ell_nv(op.pack, torch.zeros(4, op.v_pad - 64, device=dev))
    with pytest.raises(ValueError, match="int8"):   # int8 tiles without their scales
        ek.ell_nv(op.pack._replace(scales=None), flat[:-1].view(4, op.v_pad))


@pytest.mark.parametrize("n", [160, 97])        # N as on the 1M route's block 1, and ragged
@pytest.mark.parametrize("scale", [1.0, 2.0])
@pytest.mark.parametrize("n_vertex,bs", [(600, 64), (600, 256), (200, 256)])
def test_k10_matches_plain(dev, n_vertex, bs, scale, n):
    """K10 against its plain version; (600, 64) has block rows with fewer
    live tiles than max_b (padding slots), (200, 256) is a one-block-row
    pack. The scale is alpha; a repeat launch is bit-identical."""
    op = bcsr_graph_op(_rcm_gso(n_vertex), block_size=bs, device=dev)
    x = _rand(np.random.default_rng(5), dev, op.n_vertex_pad, n)
    before = kernels.launch_counts()["bcsr_spmm"]
    out1 = spm.bcsr_spmm(op.pack, x, scale=scale)
    out2 = spm.bcsr_spmm(op.pack, x, scale=scale)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["bcsr_spmm"] == before + 2
    assert torch.equal(out1, out2)
    torch.testing.assert_close(out1, spm.bcsr_spmm_reference(op.pack, x, scale=scale), **TOL)


@pytest.mark.parametrize("n", [160, 97])
@pytest.mark.parametrize("n_vertex,bs", [(600, 64), (600, 256), (200, 256)])
def test_k11_matches_plain(dev, n_vertex, bs, n):
    """K11 against its plain version, padding slots exactly zero; a repeat
    launch is bit-identical."""
    op = bcsr_graph_op(_rcm_gso(n_vertex), block_size=bs, device=dev)
    rng = np.random.default_rng(6)
    g, x = (_rand(rng, dev, op.n_vertex_pad, n) for _ in range(2))
    args = (op.pack.cols, op.pack.counts, g, x)
    before = kernels.launch_counts()["bcsr_sddmm"]
    out1 = sd.bcsr_sddmm(*args, block_size=bs, scale=0.5)
    out2 = sd.bcsr_sddmm(*args, block_size=bs, scale=0.5)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["bcsr_sddmm"] == before + 2
    assert torch.equal(out1, out2)
    torch.testing.assert_close(out1, sd.bcsr_sddmm_reference(*args, block_size=bs, scale=0.5),
                               **TOL)
    live = torch.arange(out1.shape[1], device=dev)[None, :] < op.pack.counts[:, None]
    assert not bool(out1[~live].any())


@pytest.mark.parametrize("n", [0, 1, 15, 17, 160])
@pytest.mark.parametrize("bs", [64, 256])
def test_k11_writes_padding_slots_over_nan(dev, bs, n):
    """K11 at widths none, one, ragged around a 16-column step, and the 1M
    route's; its output lands on memory filled with NaN just before, so the
    padding slots must be written as zeros (and nothing read there); a
    repeat is bit-identical."""
    op = bcsr_graph_op(_rcm_gso(600), block_size=bs, device=dev)
    assert bool((op.pack.counts < op.pack.cols.shape[1]).any())   # padding slots exist
    rng = np.random.default_rng(8)
    g, x = (_rand(rng, dev, op.n_vertex_pad, n) for _ in range(2))
    args = (op.pack.cols, op.pack.counts, g, x)
    filler = torch.full((*op.pack.cols.shape, bs, bs), float("nan"), device=dev)
    ptr = filler.data_ptr()
    del filler   # the caching allocator hands the same block to the kernel's output
    out = sd.bcsr_sddmm(*args, block_size=bs)
    torch.cuda.synchronize()
    assert out.data_ptr() == ptr
    assert not bool(out.isnan().any())
    live = torch.arange(out.shape[1], device=dev)[None, :] < op.pack.counts[:, None]
    assert not bool(out[~live].any())
    assert torch.equal(out, sd.bcsr_sddmm(*args, block_size=bs))
    torch.testing.assert_close(out, sd.bcsr_sddmm_reference(*args, block_size=bs), **TOL)


def test_bcsr_autograd_matches_plain(dev):
    """The Function's backward on the card (K10 on the transpose pack of a
    non-symmetric GSO, K11 for the tile values, scale 2) against the same on
    the CPU."""
    op = bcsr_graph_op(_rcm_gso(600, "rw_norm_lap"), block_size=64, device=dev)
    assert op.pack_t is not op.pack
    rng = np.random.default_rng(7)
    x, w = (_rand(rng, dev, op.n_vertex_pad, 96) for _ in range(2))
    grads = []
    for d in (dev, torch.device("cpu")):
        pack, pack_t = (spm.BcsrPack(*(a.to(d) for a in p)) for p in (op.pack, op.pack_t))
        data = pack.data.clone().requires_grad_(True)
        xx = x.to(d).requires_grad_(True)
        y = spm.bcsr_spmm_vjp(pack._replace(data=data), pack_t, xx, scale=2.0)
        grads.append([gr.cpu() for gr in torch.autograd.grad((y * w.to(d)).sum(), [xx, data])])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, **TOL)


def test_bcsr_wrappers_reject_what_the_kernels_do_not_take(dev):
    op = bcsr_graph_op(_rcm_gso(600), block_size=64, device=dev)
    x = torch.zeros(op.n_vertex_pad, 8, device=dev)
    with pytest.raises(ValueError, match="int32"):
        spm.bcsr_spmm(op.pack._replace(cols=op.pack.cols.long()), x)
    with pytest.raises(ValueError, match="float32"):
        spm.bcsr_spmm(op.pack._replace(data=op.pack.data.half()), x)
    with pytest.raises(ValueError, match="nbr"):
        spm.bcsr_spmm(op.pack, x[:-64])
    with pytest.raises(ValueError, match="nbr"):
        sd.bcsr_sddmm(op.pack.cols, op.pack.counts, x[:-64], x[:-64], block_size=64)
    with pytest.raises(TypeError, match="float32"):
        sd.bcsr_sddmm(op.pack.cols, op.pack.counts, x.double(), x, block_size=64)



# --- the nonzero index that K6 and K10 walk (kernels/nnz_index.py) --------

def _sparse_op(kind, dev, n_vertex=600, bs=64, gso_type="sym_norm_lap"):
    gso = _rcm_gso(n_vertex, gso_type)
    if kind == "bcsr":
        return bcsr_graph_op(gso, block_size=bs, device=dev)
    return ell_graph_op(gso, block_size=bs, quantize=kind == "ell_int8", device=dev)


def _sparse_apply(pack, x):
    """(kernel, plain version) of one application of K10 or K6 single."""
    if isinstance(pack, spm.BcsrPack):
        return spm.bcsr_spmm(pack, x), spm.bcsr_spmm_reference(pack, x)
    return ek.ell_nv(pack, x), ek.ell_nv_reference(pack, x)


def _sparse_x(pack, n, dev, seed=5):
    vp = pack.cols.shape[0] * pack.data.shape[-1]
    shape = (vp, n) if isinstance(pack, spm.BcsrPack) else (n, vp)
    return _rand(np.random.default_rng(seed), dev, *shape)


@pytest.mark.parametrize("kind", ["bcsr", "ell_f32", "ell_int8"])
def test_sparse_index_built_once_across_launches(dev, kind):
    """The first launch builds each pack's index on the card (one pack for
    both directions of the symmetric GSO, which the packer leaves unbuilt);
    repeated launches rebuild nothing."""
    before = nnz_index.builds()
    op = _sparse_op(kind, dev)
    assert op.pack_t is op.pack and nnz_index.builds() == before
    x = _sparse_x(op.pack, 33, dev)
    for _ in range(5):
        got, ref = _sparse_apply(op.pack, x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, **TOL)
    assert nnz_index.builds() == before + 1 and op.pack.index.src.device == op.pack.data.device


@pytest.mark.parametrize("kind", ["bcsr", "ell_f32", "ell_int8"])
def test_sparse_index_follows_an_edited_pack(dev, kind):
    """A zero entry of a live tile set in place (a learned tile value leaving
    zero): the next launch rebuilds the index once, on the card, and the
    kernel follows the new value; later launches and a detach() alias
    rebuild nothing."""
    op = _sparse_op(kind, dev)
    pack = op.pack
    x = _sparse_x(pack, 160, dev)
    live = torch.arange(pack.cols.shape[1], device=dev)[None, :] < pack.counts[:, None]
    zeros = torch.nonzero((pack.data == 0) & live[:, :, None, None])
    entry = tuple(int(v) for v in zeros[len(zeros) // 2])
    _sparse_apply(pack, x)
    before = nnz_index.builds()
    with torch.no_grad():
        pack.data[entry] = 3 if kind == "ell_int8" else 0.5
    got, ref = _sparse_apply(pack, x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, **TOL)
    assert nnz_index.builds() == before + 1
    for p in (pack, pack._replace(data=pack.data.detach())):
        assert torch.equal(_sparse_apply(p, x)[0], got)
    assert nnz_index.builds() == before + 1


@pytest.mark.parametrize("kind", ["bcsr", "ell_f32", "ell_int8"])
def test_sparse_dense_tile(dev, kind):
    """A fully dense live tile goes through the same kernel."""
    op = _sparse_op(kind, dev, n_vertex=200, gso_type="rw_norm_lap")
    rng = np.random.default_rng(9)
    fill = rng.integers(1, 100, (64, 64)) if kind == "ell_int8" else rng.uniform(0.1, 1, (64, 64))
    with torch.no_grad():
        op.pack.data[1, 0] = torch.from_numpy(fill).to(op.pack.data.dtype).to(dev)
    got, ref = _sparse_apply(op.pack, _sparse_x(op.pack, 96, dev))
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, **TOL)


@pytest.mark.parametrize("n", [1, 97])   # the scalar path of K10; K6 any N
@pytest.mark.parametrize("kind", ["bcsr", "ell_f32", "ell_int8"])
def test_sparse_narrow_and_ragged_n(dev, kind, n):
    op = _sparse_op(kind, dev, bs=256)
    got, ref = _sparse_apply(op.pack, _sparse_x(op.pack, n, dev))
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, **TOL)


def test_k10_takes_an_unaligned_operand(dev):
    """K10 takes an operand that does not start on a 16-byte boundary on its
    scalar path (N % 4 == 0, so it would read float4 if it were aligned);
    K6 raises for one (test_k6_wrapper_rejects_what_the_kernel_does_not_take)."""
    op = _sparse_op("bcsr", dev)
    flat = _rand(np.random.default_rng(3), dev, op.n_vertex_pad * 8 + 1)
    x = flat[1:].view(op.n_vertex_pad, 8)
    assert x.data_ptr() % 16
    got = spm.bcsr_spmm(op.pack, x, scale=2.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, spm.bcsr_spmm_reference(op.pack, x, scale=2.0), **TOL)

def _stblock_case(rng, dev, act, gct, ks, c_in, training, v=V_TRUE):
    cfg = fs.FusedBlockConfig(kt=3, ks=ks, act_func=act, graph_conv_type=gct, droprate=0.5,
                              v_true=v, t_in=12 if c_in == 1 else 8, c_in=c_in, c0=32, c1=16,
                              c2=32, training=training)
    scales = (0.3, 0.1, 0.2, 0.1, 0.2, 0.1, 0.2, 0.1, 0.1, 0.1)
    w = [_rand(rng, dev, *shape, scale=sc) for shape, sc in zip(cfg.weight_shapes(), scales)]
    w[8] = w[8] + 1.0   # LayerNorm scale about 1
    gso = _rand(rng, dev, v, v, scale=0.1)
    x = _rand(rng, dev, B, cfg.t_in, v, c_in)
    drop = Drop(0.5, 77, 1) if training else None
    return cfg, x, gso, w, drop


@pytest.mark.parametrize("gct,ks", [("cheb_graph_conv", 1), ("cheb_graph_conv", 2),
                                    ("cheb_graph_conv", 3), ("cheb_graph_conv", 4),
                                    ("graph_conv", 1)])
@pytest.mark.parametrize("act", ["glu", "gtu", "relu", "silu"])
@pytest.mark.parametrize("c_in,training", [(1, False), (16, True)])
def test_k12_matches_plain(dev, act, gct, ks, c_in, training):
    """K12f and K12b against their plain versions (the backward's held to the
    kernel's ReLU decisions, read back through ``relu_out``), a repeat launch
    bit-identical, one launch counted per call."""
    rng = np.random.default_rng(31)
    cfg, x, gso, w, drop = _stblock_case(rng, dev, act, gct, ks, c_in, training)
    h = torch.empty((B, cfg.t1, cfg.v_true, cfg.c1), device=dev)
    before = kernels.launch_counts()
    y = fs.stblock_fwd(cfg, x, gso, *w, drop=drop, relu_out=h)
    assert torch.equal(y, fs.stblock_fwd(cfg, x, gso, *w, drop=drop))
    torch.testing.assert_close(y, fs.st_block_reference(cfg, x, gso, w, drop), **TOL)
    r = fs.relu_input(cfg, x, gso, w)
    torch.testing.assert_close(h, torch.relu(r), **TOL)
    gy = _rand(rng, dev, *y.shape)
    got = fs.stblock_bwd(cfg, x, gso, *w, gy, drop=drop)
    assert all(torch.equal(a, b) for a, b in zip(got, fs.stblock_bwd(cfg, x, gso, *w, gy,
                                                                      drop=drop)))
    ref = fs.st_block_bwd_reference(cfg, x, gso, w, gy, drop, relu_mask=(h > 0).float())
    for i, (a, b) in enumerate(zip(got, ref)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * max(1.0, float(b.abs().max())),
                                   msg=lambda m, i=i: f"output {i}: {m}")
    after = kernels.launch_counts()
    assert after["stblock_fwd"] - before["stblock_fwd"] == 2
    assert after["stblock_bwd"] - before["stblock_bwd"] == 2


def test_k12_autograd_matches_plain(dev):
    """``fused_st_block`` on the card against the same on the CPU (the plain
    versions), dropout on; no gradient reaches the GSO."""
    rng = np.random.default_rng(32)
    cfg, x, gso, w, _ = _stblock_case(rng, dev, "glu", "cheb_graph_conv", 3, 16, True, v=200)
    params = {"tmp_conv1.causal_conv.weight": w[0].permute(2, 1, 0)[..., None],
              "tmp_conv1.causal_conv.bias": w[1], "graph_conv.align.align_conv.weight": w[2].T,
              "graph_conv.align.align_conv.bias": w[3],
              "graph_conv.cheb_graph_conv.weight": w[4], "graph_conv.cheb_graph_conv.bias": w[5],
              "tmp_conv2.causal_conv.weight": w[6].permute(2, 1, 0)[..., None],
              "tmp_conv2.causal_conv.bias": w[7], "ln.weight": w[8], "ln.bias": w[9]}
    gy = _rand(rng, dev, B, cfg.t2, 200, cfg.c2)
    grads = []
    for d in (dev, torch.device("cpu")):
        p = {k: v.detach().to(d).requires_grad_(True) for k, v in params.items()}
        xx, g = x.to(d).requires_grad_(True), gso.to(d).requires_grad_(True)
        y = fs.fused_st_block(xx, g, p, kt=3, ks=3, act_func="glu",
                              graph_conv_type="cheb_graph_conv", droprate=0.5,
                              deterministic=False, seed=77, site=1)
        gr = torch.autograd.grad((y * gy.to(d)).sum(), [xx, g, *p.values()], allow_unused=True)
        assert gr[1] is None
        grads.append([y.detach().cpu(), gr[0].cpu(), *(t.cpu() for t in gr[2:])])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * max(1.0, float(b.abs().max())))


def test_fused_forward_with_the_head_at_tile_edges_matches_plain(dev):
    """K12f's head is the gate GEMM: ``fused_forward`` through a model whose
    blocks sit at the edges of its tile (gate widths 100 and 130: two and
    three 64-channel passes; bottlenecks 5 and 16; a 65-channel block input),
    dropout on, on the card against the same on the CPU (the plain versions)."""
    blocks = [[1], [100, 5, 65], [130, 16, 64], [128, 128], [1]]
    model = STGCN(12, V_TRUE, blocks=blocks, device="cpu",
                  generator=torch.Generator().manual_seed(5))
    rng = np.random.default_rng(34)
    gso = _rand(rng, dev, V_TRUE, V_TRUE, scale=0.1)
    x = _rand(rng, dev, B, 12, V_TRUE, 1)
    params = model.state_dict()
    before = kernels.launch_counts()["stblock_fwd"]
    with torch.no_grad():
        got = fused_forward({k: v.to(dev) for k, v in params.items()}, x, DenseGraphOp(gso),
                            model, deterministic=False, seed=step_seed(9, 1))
        ref = fused_forward(params, x.cpu(), DenseGraphOp(gso.cpu()), model,
                            deterministic=False, seed=step_seed(9, 1))
    assert kernels.launch_counts()["stblock_fwd"] == before + 2
    torch.testing.assert_close(got.cpu(), ref, **TOL)


def test_k12_wrapper_rejects_what_the_kernel_does_not_take(dev):
    rng = np.random.default_rng(33)
    cfg, x, gso, w, _ = _stblock_case(rng, dev, "glu", "cheb_graph_conv", 3, 16, False)
    with pytest.raises(ValueError, match="c1"):
        wide = dataclasses.replace(cfg, c1=24, c2=32)
        ws = [_rand(rng, dev, *s) for s in wide.weight_shapes()]
        fs.stblock_fwd(wide, x, gso, *ws)
    with pytest.raises(ValueError, match="gso"):
        fs.stblock_fwd(cfg, x, gso[:-1], *w)
    with pytest.raises(NotImplementedError, match="bf16"):
        fs.stblock_fwd(dataclasses.replace(cfg, precision="bfloat16"), x, gso, *w)


# --- the bf16 variants of K1f-K4f (the gate GEMM and tail_h_kernel in bf16) ---

BF16 = torch.bfloat16


def _bf16_matches_plain(name, kernel, plain, scale):
    """A bf16 forward kernel within the bf16 bound of its plain version
    (``kernels/bf16_bounds.py``), a repeat launch bit-identical, two launches
    counted under its ``_bf16`` name and none under the float32 kernel's."""
    before = kernels.launch_counts()
    got, again = kernel(), kernel()
    after = kernels.launch_counts()
    flat = (lambda o: list(o) if isinstance(o, tuple) else [o])
    assert all(torch.equal(a, b) for a, b in zip(flat(got), flat(again)))
    assert after[name] == before[name] + 2
    assert after[name[:-len("_bf16")]] == before[name[:-len("_bf16")]]
    return bb.within(got, plain(), scale())


def _ln_bf16(rng, dev, batch, n_t, c, v_true, v_pad):
    mu, rstd, lng, lnb = _ln_of(rng, dev, batch, n_t, c, v_true, v_pad)
    return mu, rstd, lng.to(BF16), lnb.to(BF16)


@pytest.mark.parametrize("act,c0,c_in,kt,t_in,c1,apply_ln,drop,batch,v_pad", HEAD_EDGES)
def test_head_fwd_bf16_at_tile_edges_matches_plain(dev, act, c0, c_in, kt, t_in, c1, apply_ln,
                                                   drop, batch, v_pad):
    """K1f's bf16 variant at the edges of the gate GEMM's tile: bf16 xg
    within the bf16 bound of the plain version, which rounds at the same
    points."""
    rng = np.random.default_rng(63)
    v_true = v_true_of(v_pad)
    cfg = vf.VertexBlockCfg(kt=kt, ks=3, act_func=act, graph_conv_type="cheb_graph_conv",
                            v_true=v_true, v_pad=v_pad, t_in=t_in, c_in=c_in, c0=c0, c1=c1,
                            c2=c1, apply_ln=apply_ln, precision="bfloat16")
    x = _rand(rng, dev, batch, t_in, c_in, v_pad).to(BF16)
    ln = _ln_bf16(rng, dev, batch, t_in, c_in, v_true, v_pad) if apply_ln else (None,) * 4
    w = (_rand(rng, dev, kt, c_in, cfg.g1, scale=(kt * c_in) ** -0.5).to(BF16),
         _rand(rng, dev, cfg.g1, scale=0.1), _rand(rng, dev, c0, c1, scale=c0 ** -0.5).to(BF16),
         _rand(rng, dev, c1, scale=0.1))
    d = DROP if drop else None
    lnr = ln if apply_ln else None
    _bf16_matches_plain("head_fwd_bf16", lambda: vf.head_fwd(cfg, x, *ln, *w, drop=d),
                        lambda: vf.head_reference(cfg, x, lnr, w, d),
                        lambda: bb.head_scale(cfg, x, lnr, w, d))
    assert vf.head_fwd(cfg, x, *ln, *w, drop=d).dtype == BF16


def _tail_bf16(rng, dev, act, gct, ks, c1, c2, kt, t1, batch, v_pad):
    cfg, ins, w = _tail_edge(rng, dev, act, gct, ks, c1, c2, kt, t1, batch, v_pad)
    cfg = dataclasses.replace(cfg, precision="bfloat16")
    return cfg, [t.to(BF16) for t in ins], (w[0].to(BF16), w[1], w[2].to(BF16), w[3])


def _tail_bf16_matches_plain(cfg, ins, w):
    terms = list(ins[1:3])[: cfg.n_terms]
    r = _bf16_matches_plain("tail_fwd_bf16", lambda: vf.tail_fwd(cfg, *ins, *w),
                            lambda: vf.tail_reference(cfg, ins[0], terms, w),
                            lambda: bb.tail_scale(cfg, ins[0], terms, w))
    a2, ps, _ = vf.tail_fwd(cfg, *ins, *w)
    assert a2.dtype == BF16 and ps.dtype == torch.float32
    return r


@pytest.mark.parametrize("act,gct,ks,c1,c2,kt,t1,batch,v_pad", TAIL_EDGES)
def test_tail_fwd_bf16_at_tile_edges_matches_plain(dev, act, gct, ks, c1, c2, kt, t1, batch,
                                                   v_pad):
    """K2f's bf16 variant (h in bf16 by tail_h_kernel, conv 2 on the bf16
    gate GEMM) at the edges of its tile: bf16 a2 and float32 partial sums of
    its true lanes within the bf16 bound of the plain version."""
    rng = np.random.default_rng(64)
    _tail_bf16_matches_plain(*_tail_bf16(rng, dev, act, gct, ks, c1, c2, kt, t1, batch, v_pad))


@pytest.mark.parametrize("act", ["glu", "relu"])
def test_tail_fwd_bf16_on_a_large_grid_matches_plain(dev, act):
    """K2f's bf16 variant at c2 = 130 on a grid of thousands of blocks."""
    rng = np.random.default_rng(65)
    _tail_bf16_matches_plain(*_tail_bf16(rng, dev, act, "cheb_graph_conv", 3, 16, 130, 3, 10, 3,
                                         8448))


def _ohead_bf16(rng, dev, act, c0, c_in, ko, batch, v_pad):
    cfg, x, mu, rstd, lng, lnb, ck, cb = _ohead_edge(rng, dev, act, c0, c_in, ko, batch, v_pad)
    return (dataclasses.replace(cfg, precision="bfloat16"), x.to(BF16), mu, rstd, lng.to(BF16),
            lnb.to(BF16), ck.to(BF16), cb)


def _ohead_bf16_matches_plain(args, d):
    r = _bf16_matches_plain("ohead_fwd_bf16", lambda: oh.ohead_fwd(*args, drop=d),
                            lambda: oh.ohead_reference(*args, drop=d),
                            lambda: bb.ohead_scale(*args, drop=d))
    assert oh.ohead_fwd(*args, drop=d)[0].dtype == BF16
    return r


@pytest.mark.parametrize("act,c0,c_in,ko,drop,batch,v_pad", OHEAD_EDGES)
def test_ohead_fwd_bf16_at_tile_edges_matches_plain(dev, act, c0, c_in, ko, drop, batch,
                                                    v_pad):
    """K3f's bf16 variant at the edges of its tile, input dropout in bf16."""
    rng = np.random.default_rng(66)
    _ohead_bf16_matches_plain(_ohead_bf16(rng, dev, act, c0, c_in, ko, batch, v_pad),
                              Drop(0.5, 2024, 2) if drop else None)


@pytest.mark.parametrize("act", ["glu", "relu"])
def test_ohead_fwd_bf16_on_a_large_grid_matches_plain(dev, act):
    """K3f's bf16 variant at c0 = 130 on a grid of thousands of blocks."""
    rng = np.random.default_rng(67)
    _ohead_bf16_matches_plain(_ohead_bf16(rng, dev, act, 130, 64, 4, 3, 22016), DROP)


@pytest.mark.parametrize("c0,c1,c_end,drop,batch,v_pad", OFC_EDGES)
def test_ofc_fwd_bf16_at_tile_edges_matches_plain(dev, c0, c1, c_end, drop, batch, v_pad):
    """K4f's bf16 variant at the edges of its tile: float32 output, its
    LayerNorm and fc1 rounded to bf16, the mask a bf16 product."""
    rng = np.random.default_rng(68)
    v_true = v_true_of(v_pad)
    cfg = oh.OutHeadCfg(ko=4, c_in=1, c0=c0, c1=c1, c_end=c_end, act_func="glu",
                        v_true=v_true, v_pad=v_pad, precision="bfloat16")
    args = (cfg, _rand(rng, dev, batch, 1, c0, v_pad).to(BF16),
            *_ln_bf16(rng, dev, batch, 1, c0, v_true, v_pad),
            _rand(rng, dev, c0, c1, scale=c0 ** -0.5).to(BF16), _rand(rng, dev, c1, scale=0.1),
            _rand(rng, dev, c1, c_end, scale=c1 ** -0.5).to(BF16),
            _rand(rng, dev, c_end, scale=0.1))
    d = Drop(0.3, 2024, 3) if drop else None
    _bf16_matches_plain("ofc_fwd_bf16", lambda: oh.ofc_fwd(*args, drop=d),
                        lambda: oh.ofc_reference(*args, drop=d),
                        lambda: bb.ofc_scale(*args, drop=d))
    assert oh.ofc_fwd(*args, drop=d).dtype == torch.float32


def test_bf16_wrappers_take_only_their_types(dev):
    """A bf16 call takes bf16 activations and weights and float32 biases and
    statistics; a float32 call refuses bf16 ones: nothing is cast."""
    rng = np.random.default_rng(69)
    cfg = vf.VertexBlockCfg(kt=3, ks=3, act_func="glu", graph_conv_type="cheb_graph_conv",
                            v_true=V_TRUE, v_pad=V_PAD, t_in=12, c_in=1, c0=16, c1=8, c2=16,
                            apply_ln=False, precision="bfloat16")
    x = _rand(rng, dev, B, 12, 1, V_PAD)
    w = (_rand(rng, dev, 3, 1, 32).to(BF16), _rand(rng, dev, 32), _rand(rng, dev, 16, 8).to(BF16),
         _rand(rng, dev, 8))
    with pytest.raises(TypeError, match="x must be torch.bfloat16"):
        vf.head_fwd(cfg, x, None, None, None, None, *w)
    with pytest.raises(TypeError, match="c1b must be torch.float32"):
        vf.head_fwd(cfg, x.to(BF16), None, None, None, None, w[0], w[1].to(BF16), *w[2:])
    f32 = dataclasses.replace(cfg, precision="default")
    with pytest.raises(TypeError, match="x must be torch.float32"):
        vf.head_fwd(f32, x.to(BF16), None, None, None, None, *(t.float() for t in w))


# --- the bf16 variants of K1b-K4b (bwd_blocks_bf16.cu) ------------------------

def _bf16_bwd_matches_plain(name, kernel, plain, scale):
    """A bf16 backward kernel against its plain version, which rounds at the
    same points: its bf16 outputs within the bf16 bound and its float32 ones
    within 2^-8 in relative L2 (``bf16_bounds.within_grads``); a repeat launch
    bit-identical (no atomics); two launches counted under its ``_bf16`` name
    and none under the float32 kernel's."""
    before = kernels.launch_counts()
    got, again = kernel(), kernel()
    after = kernels.launch_counts()
    assert all(a is None or torch.equal(a, b) for a, b in zip(got, again))
    assert after[name] == before[name] + 2
    assert after[name[:-len("_bf16")]] == before[name[:-len("_bf16")]]
    return bb.within_grads(got, plain(), scale())


def _head_bwd_bf16_case(rng, dev, act, c0, c_in, kt, t_in, c1, apply_ln, batch, v_pad):
    v_true = v_true_of(v_pad)
    cfg = vf.VertexBlockCfg(kt=kt, ks=3, act_func=act, graph_conv_type="cheb_graph_conv",
                            v_true=v_true, v_pad=v_pad, t_in=t_in, c_in=c_in, c0=c0, c1=c1,
                            c2=c1, apply_ln=apply_ln, precision="bfloat16")
    x = _rand(rng, dev, batch, t_in, c_in, v_pad).to(BF16)
    ln = _ln_bf16(rng, dev, batch, t_in, c_in, v_true, v_pad) if apply_ln else (None,) * 4
    w = (_rand(rng, dev, kt, c_in, cfg.g1, scale=(kt * c_in) ** -0.5).to(BF16),
         _rand(rng, dev, cfg.g1, scale=0.1), _rand(rng, dev, c0, c1, scale=c0 ** -0.5).to(BF16),
         _rand(rng, dev, c1, scale=0.1))
    gy = _rand(rng, dev, batch, cfg.t1, c1, v_pad).to(BF16)
    return cfg, x, ln, w, gy


def _head_bwd_bf16_matches_plain(cfg, x, ln, w, gy, d):
    lnr = ln if cfg.apply_ln else None
    r = _bf16_bwd_matches_plain(
        "head_bwd_bf16", lambda: vf.head_bwd(cfg, x, *ln, *w, gy, drop=d),
        lambda: vf.head_bwd_reference(cfg, x, lnr, w, gy, d),
        lambda: bb.head_bwd_scale(cfg, x, lnr, w, gy, d))
    got = vf.head_bwd(cfg, x, *ln, *w, gy, drop=d)
    assert got[0].dtype == BF16 and all(g.dtype == torch.float32 for g in got[5:])
    return r


@pytest.mark.parametrize("act,c0,c_in,kt,t_in,c1,apply_ln,drop,batch,v_pad", HEAD_EDGES)
def test_head_bwd_bf16_at_tile_edges_matches_plain(dev, act, c0, c_in, kt, t_in, c1, apply_ln,
                                                   drop, batch, v_pad):
    """K1b's bf16 variant at the edges of the gate pass's and the data
    gradient's tiles (c_in 1 and 3: the bf16 lane kernel, kt 1-3), its
    dropout regenerated in bf16."""
    rng = np.random.default_rng(71)
    case = _head_bwd_bf16_case(rng, dev, act, c0, c_in, kt, t_in, c1, apply_ln, batch, v_pad)
    _head_bwd_bf16_matches_plain(*case, DROP if drop else None)


@pytest.mark.parametrize("b,t_in,c_in,drop,v_pad", [(3, 12, 1, None, 256), (3, 8, 64, DROP, 256),
                                                   (1, 8, 64, DROP, 65_536),
                                                   (1, 12, 1, None, 65_536)])
def test_head_bwd_bf16_at_the_main_widths_matches_plain(dev, b, t_in, c_in, drop, v_pad):
    """K1b's bf16 variant at block 1's and block 2's shapes (c0 64, c1 16),
    on PeMSD7(M)'s lanes and a 64k-lane graph's."""
    rng = np.random.default_rng(72)
    case = _head_bwd_bf16_case(rng, dev, "glu", 64, c_in, 3, t_in, 16, c_in > 1, b, v_pad)
    _head_bwd_bf16_matches_plain(*case, drop)


def _tail_bwd_bf16_matches_plain(rng, dev, cfg, ins, w):
    xg = ins[0]
    b, t2 = xg.shape[0], cfg.t2
    ga2 = _rand(rng, dev, b, t2, cfg.c2, cfg.v_pad).to(BF16)
    gps, gpss = (_rand(rng, dev, b, t2, 1, 1, scale=1e-2) for _ in range(2))
    terms = list(ins[1:3])[: cfg.n_terms]

    def plain():
        dxg, dterms, *dw = vf.tail_bwd_reference(cfg, xg, terms, w, ga2, gps, gpss)
        return (dxg, *dterms, *[torch.zeros_like(xg)] * (2 - len(dterms)), *dw)

    def scale():
        m_dxg, m_dt = bb.tail_bwd_scale(cfg, xg, terms, w, ga2, gps, gpss)
        return [m_dxg, *m_dt, *[torch.zeros(xg.shape, device=dev)] * (2 - len(m_dt))]

    return _bf16_bwd_matches_plain(
        "tail_bwd_bf16", lambda: vf.tail_bwd(cfg, *ins, *w, ga2, gps, gpss), plain, scale)


@pytest.mark.parametrize("act,gct,ks,c1,c2,kt,t1,batch,v_pad", TAIL_EDGES)
def test_tail_bwd_bf16_at_tile_edges_matches_plain(dev, act, gct, ks, c1, c2, kt, t1, batch,
                                                   v_pad):
    """K2b's bf16 variant (h recomputed in bf16, the gate pass's cotangent
    policy, tail_dr's per-tap rounding and bf16 graph-term gradients) at the
    edges of its tiles."""
    rng = np.random.default_rng(73)
    _tail_bwd_bf16_matches_plain(rng, dev, *_tail_bf16(rng, dev, act, gct, ks, c1, c2, kt, t1,
                                                        batch, v_pad))


@pytest.mark.parametrize("act", ["glu", "relu"])
def test_tail_bwd_bf16_on_a_large_grid_matches_plain(dev, act):
    """K2b's bf16 variant at the main widths (c1 16, c2 64) on 64k lanes."""
    rng = np.random.default_rng(74)
    _tail_bwd_bf16_matches_plain(rng, dev, *_tail_bf16(rng, dev, act, "cheb_graph_conv", 3, 16,
                                                        64, 3, 8, 1, 65_536))


@pytest.mark.parametrize("act,c0,c_in,ko,drop,batch,v_pad", OHEAD_EDGES)
def test_ohead_bwd_bf16_at_tile_edges_matches_plain(dev, act, c0, c_in, ko, drop, batch,
                                                    v_pad):
    """K3b's bf16 variant at the edges of its tiles, input dropout in bf16."""
    rng = np.random.default_rng(75)
    args = _ohead_bf16(rng, dev, act, c0, c_in, ko, batch, v_pad)
    cot = (_rand(rng, dev, batch, 1, c0, v_pad).to(BF16),
           *(_rand(rng, dev, batch, 1, 1, 1, scale=1e-2) for _ in range(2)))
    d = Drop(0.5, 2024, 2) if drop else None
    _bf16_bwd_matches_plain("ohead_bwd_bf16", lambda: oh.ohead_bwd(*args, *cot, drop=d),
                            lambda: oh.ohead_bwd_reference(*args, *cot, drop=d),
                            lambda: bb.ohead_bwd_scale(*args, *cot, drop=d))


@pytest.mark.parametrize("c0,c1,c_end,drop,batch,v_pad", OFC_EDGES)
def test_ofc_bwd_bf16_at_tile_edges_matches_plain(dev, c0, c1, c_end, drop, batch, v_pad):
    """K4b's bf16 variant at the edges of its tiles: the float32 gout rounded
    first, fc1's dropout a bf16 product, dh on the bf16 data gradient."""
    rng = np.random.default_rng(76)
    v_true = v_true_of(v_pad)
    cfg = oh.OutHeadCfg(ko=4, c_in=1, c0=c0, c1=c1, c_end=c_end, act_func="glu",
                        v_true=v_true, v_pad=v_pad, precision="bfloat16")
    args = (cfg, _rand(rng, dev, batch, 1, c0, v_pad).to(BF16),
            *_ln_bf16(rng, dev, batch, 1, c0, v_true, v_pad),
            _rand(rng, dev, c0, c1, scale=c0 ** -0.5).to(BF16), _rand(rng, dev, c1, scale=0.1),
            _rand(rng, dev, c1, c_end, scale=c1 ** -0.5).to(BF16),
            _rand(rng, dev, c_end, scale=0.1))
    gout = _rand(rng, dev, batch, 1, c_end, v_pad)
    d = Drop(0.3, 2024, 3) if drop else None
    _bf16_bwd_matches_plain("ofc_bwd_bf16", lambda: oh.ofc_bwd(*args, gout, drop=d),
                            lambda: oh.ofc_bwd_reference(*args, gout, drop=d),
                            lambda: bb.ofc_bwd_scale(*args, gout, drop=d))
