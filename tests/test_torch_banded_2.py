"""More of ``tests/test_torch_banded.py``'s tests: each port test file holds at most
20 collected tests. Helpers, constants and fixtures come from there."""

import numpy as np
import pytest
import torch

from stgcn_tpu.ops.graph_op import banded_graph_op as jax_banded_graph_op
from stgcn_tpu_torch.data import synthetic as TS
from stgcn_tpu_torch.graph import build_gso
from stgcn_tpu_torch.graph.gso import GraphShiftOperator
from stgcn_tpu_torch.graph.partition import permute_matrix, rcm_ordering
from stgcn_tpu_torch.kernels import banded_nv as tnv
from stgcn_tpu_torch.kernels import banded_spmm as tbs
from stgcn_tpu_torch.ops import BandedGraphOp, BcsrGraphOp, DenseGraphOp, EllGraphOp
from stgcn_tpu_torch.ops import make_graph_op
from tests.torch_parity_utils import BANDED_V as V
from tests.torch_parity_utils import banded_gsos


def test_make_graph_op_routing():
    """auto: dense up to 4096 vertices, banded above when the band is narrow,
    BCSR when it is not; banded_int8, bcsr, ell / ell_int8 by name; the
    banded kinds build the JAX operator (the vn stream pack, and the nv one
    with ``nv=True``)."""
    _, jart, tart = banded_gsos()
    assert isinstance(make_graph_op(tart, "auto", device="cpu"), DenseGraphOp)
    op = make_graph_op(tart, "banded", device="cpu")
    assert isinstance(op, BandedGraphOp) and op.slabs.shape[1] == 256 and not op.has_nv
    assert op.pair_stream and op.scales is None
    big = TS.random_road_graph(5000, k_neighbors=4, seed=1)
    art = build_gso(big, "sym_norm_lap", cheb=False)
    op = make_graph_op(art, "auto", device="cpu")   # unordered: a wide band
    assert isinstance(op, BcsrGraphOp) and op.n_vertex == 5000 and op.block_size == 256
    assert op.pack_t is op.pack and op.n_vertex_pad == 20 * 256
    art = GraphShiftOperator(matrix=permute_matrix(art.matrix, rcm_ordering(art.matrix)),
                             gso_type=art.gso_type, cheb_rescaled=False, lam_max=None)
    op = make_graph_op(art, "auto", device="cpu")
    assert isinstance(op, BandedGraphOp) and op.n_vertex == 5000
    assert op.slabs_t is op.slabs and op.slabs.shape[1] == 256
    for kind in ("ell", "ell_int8"):
        op = make_graph_op(tart, kind, device="cpu")
        assert isinstance(op, EllGraphOp) and op.pack.quantized == (kind == "ell_int8")
        assert op.pack_t is op.pack and op.block_size == 256 and op.n_vertex == V
    op = make_graph_op(tart, "bcsr", device="cpu")
    assert isinstance(op, BcsrGraphOp) and op.pack_t is op.pack and op.block_size == 256
    assert op.n_vertex == V and op.n_vertex_pad == 768
    for nv in (False, True):
        op = make_graph_op(tart, "banded_int8", nv=nv, device="cpu")
        jop = jax_banded_graph_op(jart, quantize=True, use_pallas=False, nv=nv)
        assert isinstance(op, BandedGraphOp) and op.slabs.dtype == torch.int8
        assert op.has_nv == nv and op.pair_stream == jop.pair_stream
        for f in ("slabs", "lo", "scales") + (("slabs_nv",) if nv else ()):
            np.testing.assert_array_equal(getattr(op, f).numpy(), np.asarray(getattr(jop, f)))
    with pytest.raises(ValueError, match="unknown"):
        make_graph_op(tart, "csr", device="cpu")


def test_banded_pack_refuses_what_is_not_ported():
    _, _, tart = banded_gsos()
    with pytest.raises(ValueError, match="v_pad"):
        tbs.pack_banded_device(tart.matrix, v_pad=128, device="cpu")
    with pytest.raises(TypeError, match="float32"):   # float32, bf16 or int8 packs only
        tbs.pack_banded_device(tart.matrix, dtype=torch.float16, device="cpu")
    with pytest.raises(ValueError, match="chain"):
        tnv.stream_nv(torch.zeros(1, 256, 256), torch.zeros(1, dtype=torch.int32),
                      torch.zeros(2, 256), mode="chain")
