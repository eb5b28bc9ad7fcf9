"""The nonzero index that K6 and K10 walk (``stgcn_tpu_torch/kernels/
nnz_index.py``), on the CPU, against the JAX package: the index built from
the tile values at the first launch equals the one the packed CSR matrix
implies (BCSR, ELL f32 and int8); a plain product over the index (the
kernels' arithmetic, by ``index_add_``) equals the port's plain versions
in every mode and the JAX ``bcsr_spmm_reference`` / ``ell_nv_reference``;
an in-place edit of the tile values makes the next launch rebuild the
index once, unchanged values and a ``detach()`` alias rebuild nothing, an
edit through ``.data`` is not seen until ``invalidate()``; a fully dense
tile. The RCM road graphs of V = 600 and 200
(``tests/test_torch_kernels_cuda.py``), bs 64 and 256, ``sym_norm_lap``
(one pack for both directions) and ``rw_norm_lap`` (a transpose pack of
its own)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from stgcn_tpu.kernels import ell_nv as jek
from stgcn_tpu.kernels import spmm as jsp
from stgcn_tpu_torch.data.synthetic import random_road_graph
from stgcn_tpu_torch.graph import build_gso, permute_matrix, rcm_ordering
from stgcn_tpu_torch.graph.gso import GraphShiftOperator
from stgcn_tpu_torch.kernels import ell_nv as ek
from stgcn_tpu_torch.kernels import nnz_index
from stgcn_tpu_torch.kernels import spmm as spm
from stgcn_tpu_torch.ops import bcsr_graph_op, ell_graph_op

TOL = dict(rtol=2e-5, atol=2e-5)   # f32 sums in another order
GRAPHS = [(600, 64, "sym_norm_lap"), (600, 256, "rw_norm_lap"), (200, 256, "sym_norm_lap")]
KINDS = ["bcsr", "ell_f32", "ell_int8"]


def _rcm_gso(n_vertex, gso_type):
    art = build_gso(random_road_graph(n_vertex, k_neighbors=6, seed=0), gso_type, cheb=True)
    return GraphShiftOperator(matrix=permute_matrix(art.matrix, rcm_ordering(art.matrix)),
                              gso_type=gso_type, cheb_rescaled=True, lam_max=art.lam_max)


def _op(kind, n_vertex, bs, gso_type):
    gso = _rcm_gso(n_vertex, gso_type)
    if kind == "bcsr":
        return bcsr_graph_op(gso, block_size=bs, device="cpu")
    return ell_graph_op(gso, block_size=bs, quantize=kind == "ell_int8", device="cpu")


def _current(pack):
    """What the wrapper does before a launch: the index of the current tiles."""
    return nnz_index.current(pack.index, pack.data, pack.cols, pack.counts,
                             transposed=isinstance(pack, ek.EllPack), name="test")


def _index_product(pack, x, scale=1.0):
    """One application ``scale · (A x)`` over the index alone: each nonzero's
    value read from the tiles at its offset, times the source row (vn, BCSR)
    or column (nv, ELL) of x, summed into its output row by ``index_add_``;
    an int8 pack's lane factors after the sum."""
    idx = _current(pack)
    nbr, max_b, bs, _ = pack.data.shape
    rows = torch.repeat_interleave(torch.arange(nbr * bs), idx.row_ptr.diff().long())
    vals = pack.data.reshape(-1)[(rows // bs) * (max_b * bs * bs) + idx.off.long()].float()
    src = idx.src.long()
    if isinstance(pack, spm.BcsrPack):
        return scale * torch.zeros_like(x).index_add_(0, rows, vals[:, None] * x[src])
    y = torch.zeros_like(x).index_add_(1, rows, vals[None, :] * x[:, src])
    lane = pack.scales.reshape(-1) if pack.scales is not None else 1.0
    return scale * (y * lane)


def _index_modes(pack, x, g, mode):
    """The K6 modes over the index product, as the kernel composes them."""
    if mode == "single":
        return _index_product(pack, x)
    if mode == "pair":
        t1 = _index_product(pack, x)
        return t1, 2.0 * _index_product(pack, t1) - x
    u = g + 2.0 * _index_product(pack, x)
    return u, _index_product(pack, u) - x


def _x(pack, n, seed=5):
    vp = pack.cols.shape[0] * pack.data.shape[-1]
    shape = (vp, n) if isinstance(pack, spm.BcsrPack) else (n, vp)
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))


def _reference(pack, x, scale=1.0):
    if isinstance(pack, spm.BcsrPack):
        return spm.bcsr_spmm_reference(pack, x, scale=scale)
    return ek.ell_nv_reference(pack, x, scale=scale)


def _csr_index(matrix, pack):
    """``(row_ptr, src, stored)`` that the packed matrix implies, in CSR
    order: its entries whose stored value (f32, or an int8 pack's
    ``rint(value / lane factor)``) is nonzero, over the padded rows."""
    csr = sp.csr_matrix(matrix)
    csr.sort_indices()
    rows = np.repeat(np.arange(csr.shape[0]), np.diff(csr.indptr))
    if getattr(pack, "scales", None) is None:
        stored = csr.data.astype(np.float32)
    else:
        stored = np.rint(csr.data / pack.scales.numpy().reshape(-1)[rows]).astype(np.int8)
    keep = stored != 0
    rows, src, stored = rows[keep], csr.indices[keep], stored[keep]
    vp = pack.cols.shape[0] * pack.data.shape[-1]
    row_ptr = np.zeros(vp + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=vp), out=row_ptr[1:])
    return row_ptr, src, stored


@pytest.mark.parametrize("n_vertex,bs,gso_type", GRAPHS)
@pytest.mark.parametrize("kind", KINDS)
def test_packer_index_equals_rebuilt(kind, n_vertex, bs, gso_type):
    """The packs leave the index unbuilt; the first launch builds it from
    the tile values, once for a symmetric GSO's shared pack, and it equals
    the index of the packed matrix: the same rows and source vertices in
    CSR order, each offset in a live tile of its block row at the tile
    position of (row, source), holding the stored value."""
    op = _op(kind, n_vertex, bs, gso_type)
    assert (op.pack_t is op.pack) == (gso_type == "sym_norm_lap")
    matrix = _rcm_gso(n_vertex, gso_type).matrix
    transposed = kind != "bcsr"
    packs = [(op.pack, matrix)] + ([] if op.pack_t is op.pack else [(op.pack_t, matrix.T)])
    for pack, m in packs:
        assert pack.index.nnz == 0 and not pack.index.built_for(pack.data)
        before = nnz_index.builds()
        idx = _current(pack)
        assert nnz_index.builds() == before + 1 and idx is pack.index
        row_ptr, src, stored = _csr_index(m, pack)
        for t in (idx.row_ptr, idx.src, idx.off):
            assert t.dtype == torch.int32
        assert np.array_equal(idx.row_ptr.numpy(), row_ptr)
        assert np.array_equal(idx.src.numpy(), src)
        rows = np.repeat(np.arange(len(row_ptr) - 1), np.diff(row_ptr))
        nbr, max_b, _, _ = pack.data.shape
        k, pos = np.divmod(idx.off.numpy().astype(np.int64), bs * bs)
        lane, c = (pos % bs, pos // bs) if transposed else (pos // bs, pos % bs)
        br = rows // bs
        assert (k < pack.counts.numpy()[br]).all() and (lane == rows % bs).all()
        assert np.array_equal(pack.cols.numpy()[br, k] * bs + c, src)
        assert np.array_equal(pack.data.numpy().reshape(nbr, -1)[br, idx.off.numpy()], stored)
        assert idx.nnz == int((pack.data != 0).sum())
    before = nnz_index.builds()
    assert _current(op.pack_t) is op.pack_t.index and nnz_index.builds() == before


@pytest.mark.parametrize("n_vertex,bs,gso_type", GRAPHS)
@pytest.mark.parametrize("kind", KINDS)
def test_index_product_matches_plain_and_jax(kind, n_vertex, bs, gso_type):
    """One application over the index (scale 1 and 2) against the port's
    plain version and the JAX reference on the same pack; for ELL every
    mode (chain on the transpose pack) against ``ell_nv_reference``."""
    op = _op(kind, n_vertex, bs, gso_type)
    pack = op.pack
    x = _x(pack, 97)
    got = _index_product(pack, x)
    torch.testing.assert_close(got, _reference(pack, x), **TOL)
    torch.testing.assert_close(_index_product(pack, x, 2.0), _reference(pack, x, 2.0), **TOL)
    data, cols = jnp.asarray(pack.data.numpy()), jnp.asarray(pack.cols.numpy())
    if kind == "bcsr":
        ref = jsp.bcsr_spmm_reference(data, cols, jnp.asarray(x.numpy()), block_size=bs)
    else:
        scales = None if pack.scales is None else jnp.asarray(pack.scales.numpy())
        ref = jek.ell_nv_reference(data, cols, jnp.asarray(pack.counts.numpy()),
                                   jnp.asarray(x.numpy()), scales)
    torch.testing.assert_close(got, torch.from_numpy(np.array(ref)), **TOL)
    if kind != "bcsr":
        g = _x(pack, 97, seed=6)
        for mode, p in (("pair", op.pack), ("chain", op.pack_t)):
            for a, b in zip(_index_modes(p, x, g if mode == "chain" else None, mode),
                            ek.ell_nv_reference(p, x, g if mode == "chain" else None, mode)):
                torch.testing.assert_close(a, b, **TOL)


def _zero_entry(pack):
    """(block row, slot, r, c) of a zero entry of a live tile."""
    live = torch.arange(pack.cols.shape[1])[None, :] < pack.counts[:, None]
    zeros = torch.nonzero((pack.data == 0) & live[:, :, None, None])
    return tuple(int(v) for v in zeros[len(zeros) // 2])


@pytest.mark.parametrize("kind", KINDS)
def test_in_place_edit_rebuilds_once(kind):
    """A zero tile entry set in place (a learned tile value leaving zero)
    makes the next launch rebuild the index once, and the product follows
    the new values; further launches, unchanged values and a ``detach()``
    alias rebuild nothing; a pack of other tiles never runs on this one's
    index."""
    op = _op(kind, 600, 64, "sym_norm_lap")
    pack = op.pack
    x = _x(pack, 33)
    _current(pack)   # the first launch builds the index
    before = nnz_index.builds()
    _current(pack)
    alias = pack._replace(data=pack.data.detach())
    _current(alias)
    assert nnz_index.builds() == before
    nnz = pack.index.nnz
    with torch.no_grad():
        pack.data[_zero_entry(pack)] = 3 if kind == "ell_int8" else 0.5
    torch.testing.assert_close(_index_product(pack, x), _reference(pack, x), **TOL)
    assert nnz_index.builds() == before + 1 and pack.index.nnz == nnz + 1
    assert op.pack_t.index is pack.index   # the shared transpose follows
    _current(pack)
    _current(alias)
    assert nnz_index.builds() == before + 1
    other = pack._replace(data=pack.data.clone())
    torch.testing.assert_close(_index_product(other, x), _reference(other, x), **TOL)
    assert nnz_index.builds() == before + 2 and pack.index.built_for(other.data)


@pytest.mark.parametrize("kind", KINDS)
def test_data_edit_is_seen_only_after_invalidate(kind):
    """The index follows the version counter of the tiles tensor: an edit
    through ``pack.data.data`` does not move it, so the index stays as it
    was (the documented limit) until ``invalidate()``, after which the next
    launch rebuilds it once and the product follows the new value."""
    op = _op(kind, 600, 64, "sym_norm_lap")
    pack = op.pack
    x = _x(pack, 33)
    _current(pack)
    before, nnz = nnz_index.builds(), pack.index.nnz
    pack.data.data[_zero_entry(pack)] = 3 if kind == "ell_int8" else 0.5
    _current(pack)
    assert nnz_index.builds() == before and pack.index.nnz == nnz
    pack.index.invalidate()
    torch.testing.assert_close(_index_product(pack, x), _reference(pack, x), **TOL)
    assert nnz_index.builds() == before + 1 and pack.index.nnz == nnz + 1


@pytest.mark.parametrize("kind", KINDS)
def test_dense_tile(kind):
    """A fully dense live tile goes through the same index: bs² nonzeros of
    one tile, and the product still equals the plain version."""
    op = _op(kind, 200, 64, "rw_norm_lap")
    pack = op.pack
    rng = np.random.default_rng(9)
    fill = rng.integers(1, 100, (64, 64)) if kind == "ell_int8" else rng.uniform(0.1, 1, (64, 64))
    with torch.no_grad():
        pack.data[1, 0] = torch.from_numpy(fill).to(pack.data.dtype)
    x = _x(pack, 20)
    torch.testing.assert_close(_index_product(pack, x), _reference(pack, x), **TOL)
    rows = pack.index.row_ptr.diff()[64:128]
    assert int(rows.min()) >= 64


def test_pack_without_index_or_from_inference_mode_raises():
    op = _op("bcsr", 200, 64, "sym_norm_lap")
    with pytest.raises(ValueError, match="no nonzero index"):
        nnz_index.current(None, op.pack.data, op.pack.cols, op.pack.counts, transposed=False,
                          name="K10")
    with torch.inference_mode():
        frozen = op.pack.data.clone()
    with pytest.raises(ValueError, match="inference_mode"):
        nnz_index.current(op.pack.index, frozen, op.pack.cols, op.pack.counts,
                          transposed=False, name="K10")
