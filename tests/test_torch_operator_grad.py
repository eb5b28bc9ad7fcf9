"""The banded and ELL operators refuse the gradient of their f32 values.

The JAX VJPs return it (``banded_sddmm_scan``, ``_nv_dslabs``,
``_ell_nv_ddata``); the port does not have those scans yet, so each of its
autograd Functions raises ``NotImplementedError`` when an f32 slab or tile
tensor requires grad, instead of returning nothing. An int8 pack (frozen,
as in JAX) and an operator that does not require grad still train the
operand, and the BCSR operator still gives its tile-value gradient (K11).
All on CPU tensors: the kernels' plain versions run.
"""

import dataclasses

import numpy as np
import pytest
import torch

from stgcn_tpu_torch.kernels import banded_nv as nvk
from stgcn_tpu_torch.kernels import banded_spmm as bk
from stgcn_tpu_torch.kernels import ell_nv as ek
from stgcn_tpu_torch.ops import banded_graph_op, bcsr_graph_op, ell_graph_op
from tests.torch_parity_utils import banded_gsos

N = 12   # operand columns (B·T·C of a tiny batch)


@pytest.fixture(scope="module")
def gso():
    """The V=600 RCM-ordered road graph, Chebyshev sym_norm_lap GSO."""
    return banded_gsos()[2]


def _leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().clone().requires_grad_(True)


def _operand(v: int) -> torch.Tensor:
    x = np.random.default_rng(0).standard_normal((v, N)).astype(np.float32)
    return torch.from_numpy(x).requires_grad_(True)


def _banded_vn(gso, stream: bool):
    op = banded_graph_op(gso, stream=stream, device="cpu")
    slabs = _leaf(op.slabs)
    slabs_t = slabs if op.slabs_t is op.slabs else _leaf(op.slabs_t)
    return op, slabs, slabs_t


def _call_banded_spmm(gso):
    op, slabs, slabs_t = _banded_vn(gso, stream=True)
    return bk.banded_spmm_vjp(slabs, op.lo, slabs_t, op.lo_t, _operand(op.v_pad))


def _call_banded_cheb_pair(gso):
    op, slabs, slabs_t = _banded_vn(gso, stream=False)
    return bk.banded_cheb_pair_vjp(slabs, op.lo, slabs_t, op.lo_t, _operand(op.v_pad))


def _call_banded_cheb_pair_stream(gso):
    op, slabs, slabs_t = _banded_vn(gso, stream=True)
    return bk.banded_cheb_pair_stream_vjp(slabs, op.lo, slabs_t, op.lo_t, _operand(op.v_pad))


def _banded_nv(gso):
    op = banded_graph_op(gso, nv=True, nv_only=True, device="cpu")
    s = _leaf(op.slabs_nv)
    s_t = s if op.slabs_nv_t is op.slabs_nv else _leaf(op.slabs_nv_t)
    return op, s, s_t, _operand(op.v_pad).detach().T.contiguous().requires_grad_(True)


def _call_banded_spmm_nv(gso):
    op, s, s_t, x_nv = _banded_nv(gso)
    return nvk.banded_spmm_nv(s, op.lo, s_t, op.lo_t, x_nv)


def _call_cheb_pair_nv(gso):
    op, s, s_t, x_nv = _banded_nv(gso)
    return nvk.cheb_pair_nv(s, op.lo, s_t, op.lo_t, x_nv)


def _ell(gso):
    op = ell_graph_op(gso, device="cpu")
    pack = op.pack._replace(data=_leaf(op.pack.data))
    pack_t = pack if op.pack_t is op.pack else op.pack_t._replace(data=_leaf(op.pack_t.data))
    x_nv = _operand(op.v_pad).detach().T.contiguous().requires_grad_(True)
    return pack, pack_t, x_nv


def _call_ell_spmm_nv(gso):
    pack, pack_t, x_nv = _ell(gso)
    return ek.ell_spmm_nv(pack, pack_t, x_nv)


def _call_ell_cheb_pair_nv(gso):
    pack, pack_t, x_nv = _ell(gso)
    return ek.ell_cheb_pair_nv(pack, pack_t, x_nv)


FUNCTIONS = {
    "BandedSpmmVjp": _call_banded_spmm,
    "BandedChebPairVjp": _call_banded_cheb_pair,
    "BandedChebPairStreamVjp": _call_banded_cheb_pair_stream,
    "BandedSpmmNv": _call_banded_spmm_nv,
    "ChebPairNv": _call_cheb_pair_nv,
    "EllSpmmNv": _call_ell_spmm_nv,
    "EllChebPairNv": _call_ell_cheb_pair_nv,
}


@pytest.mark.parametrize("name", list(FUNCTIONS))
def test_f32_value_grad_raises(gso, name):
    """Each Function refuses an f32 pack whose values require grad, naming
    the queue item that ports the scans, instead of dropping the gradient."""
    with pytest.raises(NotImplementedError,
                       match=r'ROADMAP\.md §1, "The operator-value gradients"'):
        FUNCTIONS[name](gso)


def _x_grad(op, x):
    """d(sum of every output)/dx through the operator's call and pair."""
    outs = [op(x)]
    if hasattr(op, "cheb_pair"):
        outs += list(op.cheb_pair(x))
    if getattr(op, "has_nv", False) or hasattr(op, "pack"):
        x_nv = x.detach().reshape(-1, x.shape[-2]).clone().requires_grad_(True)
        outs += [op.apply_nv(x_nv), *op.cheb_pair_nv(x_nv)]
        sum(o.sum() for o in outs).backward()
        return x.grad, x_nv.grad
    sum(o.sum() for o in outs).backward()
    return x.grad, None


@pytest.mark.parametrize("kind", ["banded_int8", "ell_int8", "banded_f32_fixed",
                                  "ell_f32_fixed"])
def test_frozen_operators_still_train_x(gso, kind):
    """int8 packs (frozen, as in JAX) and f32 operators that do not require
    grad go on giving the operand's gradient."""
    if kind.startswith("banded"):
        op = banded_graph_op(gso, quantize=kind == "banded_int8", nv=True, device="cpu")
    else:
        op = ell_graph_op(gso, quantize=kind == "ell_int8", device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 600, 3)).astype(np.float32)).requires_grad_(True)
    gx, gx_nv = _x_grad(op, x)
    for g in (gx, gx_nv):
        if g is not None:
            assert torch.isfinite(g).all() and float(g.abs().max()) > 0


def test_bcsr_value_grad_flows(gso):
    """The BCSR operator gives ``pack.data.grad`` (K11's plain version)."""
    op = bcsr_graph_op(gso, device="cpu")
    data = _leaf(op.pack.data)
    pack = op.pack._replace(data=data)
    op = dataclasses.replace(op, pack=pack, pack_t=pack)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 600, 3)).astype(np.float32))
    op(x).square().sum().backward()
    assert data.grad is not None
    assert torch.isfinite(data.grad).all() and float(data.grad.abs().max()) > 0
