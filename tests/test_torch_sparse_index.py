"""The nonzero index that K6, K10, K5 and the vn kernel of K7-K9 walk
(``stgcn_tpu_torch/kernels/nnz_index.py``), on the CPU, against the JAX
package: the index built from the tile or slab values at the first launch
equals the one the packed CSR matrix implies (BCSR, ELL f32 and int8; the
banded packs: vn f32 stream, vn int8, the clamped f32 pack of
``stream=False``, nv f32 and nv int8); a plain product over the index (the
kernels' arithmetic, by ``index_add_``) equals the port's plain versions
in every mode and the JAX ``bcsr_spmm_reference`` / ``ell_nv_reference``
/ ``banded_spmm`` and its pair and chain / ``_stream_nv_call`` (their
off-TPU branches), the padded rows and lanes included; an in-place edit of
the values makes the next launch rebuild the index once, unchanged values
and a ``detach()`` alias rebuild nothing, an edit through ``.data`` is not
seen until ``invalidate()``; a fully dense tile or slab. The RCM road
graphs of V = 600 and 200 (``tests/test_torch_kernels_cuda.py``), bs 64
and 256, ``sym_norm_lap`` (one pack for both directions) and
``rw_norm_lap`` (a transpose pack of its own)."""

from types import SimpleNamespace
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from stgcn_tpu.kernels import banded_nv as jnv
from stgcn_tpu.kernels import banded_spmm as jbs
from stgcn_tpu.kernels import ell_nv as jek
from stgcn_tpu.kernels import spmm as jsp
from stgcn_tpu_torch.data.synthetic import random_road_graph
from stgcn_tpu_torch.graph import build_gso, permute_matrix, rcm_ordering
from stgcn_tpu_torch.graph.gso import GraphShiftOperator
from stgcn_tpu_torch.kernels import banded_nv as tnv
from stgcn_tpu_torch.kernels import banded_spmm as tbs
from stgcn_tpu_torch.kernels import ell_nv as ek
from stgcn_tpu_torch.kernels import nnz_index
from stgcn_tpu_torch.kernels import spmm as spm
from stgcn_tpu_torch.ops import banded_graph_op, bcsr_graph_op, ell_graph_op

TOL = dict(rtol=2e-5, atol=2e-5)   # f32 sums in another order
GRAPHS = [(600, 64, "sym_norm_lap"), (600, 256, "rw_norm_lap"), (200, 256, "sym_norm_lap")]
TILE_KINDS = ["bcsr", "ell_f32", "ell_int8"]
# banded_graph_op's arguments for each banded kind; nv_* hold only the nv family
BANDED = {"vn_f32": {}, "vn_int8": {"quantize": True}, "vn_clamped": {"stream": False},
          "nv_f32": {"nv": True, "nv_only": True},
          "nv_int8": {"quantize": True, "nv": True, "nv_only": True}}
KINDS = TILE_KINDS + sorted(BANDED)


class SlabPack(NamedTuple):
    """One direction of a banded operator as its kernel takes it."""

    data: torch.Tensor               # slabs: vn [nbr, bs, w], nv [nbr, w, bs]
    lo: torch.Tensor                 # [nbr] int32 window starts
    v_pad: int                       # the operand's rows (vn) or lanes (nv)
    scales: torch.Tensor | None      # [nbr, bs] per-row factors (int8)
    index: nnz_index.NnzIndex
    transposed: bool                 # the nv layout

    @property
    def bs(self) -> int:
        return self.data.shape[2 if self.transposed else 1]

    @property
    def w(self) -> int:
        return self.data.shape[1 if self.transposed else 2]


def _rcm_gso(n_vertex, gso_type):
    art = build_gso(random_road_graph(n_vertex, k_neighbors=6, seed=0), gso_type, cheb=True)
    return GraphShiftOperator(matrix=permute_matrix(art.matrix, rcm_ordering(art.matrix)),
                              gso_type=gso_type, cheb_rescaled=True, lam_max=art.lam_max)


def _op(kind, n_vertex, bs, gso_type):
    gso = _rcm_gso(n_vertex, gso_type)
    if kind == "bcsr":
        return bcsr_graph_op(gso, block_size=bs, device="cpu")
    if kind in BANDED:
        op = banded_graph_op(gso, block_size=bs, device="cpu", **BANDED[kind])
        nv = kind.startswith("nv")
        fields = ("slabs_nv", "slabs_nv_t", "index_nv", "index_nv_t") if nv else \
            ("slabs", "slabs_t", "index", "index_t")
        slabs, slabs_t, index, index_t = (getattr(op, f) for f in fields)
        pack = SlabPack(slabs, op.lo, op.v_pad, op.scales, index, nv)
        pack_t = pack if slabs_t is slabs else \
            SlabPack(slabs_t, op.lo_t, op.v_pad, op.scales_t, index_t, nv)
        return SimpleNamespace(pack=pack, pack_t=pack_t)
    return ell_graph_op(gso, block_size=bs, quantize=kind == "ell_int8", device="cpu")


def _current(pack):
    """What the wrapper does before a launch: the index of the current tiles."""
    if isinstance(pack, SlabPack):
        return nnz_index.current(pack.index, pack.data, pack.lo, pack.v_pad,
                                 transposed=pack.transposed, name="test",
                                 build=nnz_index.index_from_slabs)
    return nnz_index.current(pack.index, pack.data, pack.cols, pack.counts,
                             transposed=isinstance(pack, ek.EllPack), name="test")


def _vn(pack) -> bool:
    """The operand is vn ``[V, N]`` (BCSR, vn slabs), else nv ``[N, V]``."""
    return isinstance(pack, spm.BcsrPack) or (isinstance(pack, SlabPack) and not pack.transposed)


def _stride(pack) -> int:
    """Values a block row holds (its tiles, or its slab)."""
    return pack.data[0].numel()


def _index_product(pack, x, scale=1.0):
    """One application ``scale · (A x)`` over the index alone: each nonzero's
    value read from the tiles or slab at its offset, times the source row
    (vn) or column (nv) of x, summed into its output row by ``index_add_``;
    an int8 pack's row factors after the sum."""
    idx = _current(pack)
    bs = pack.bs if isinstance(pack, SlabPack) else pack.data.shape[2]
    rows = torch.repeat_interleave(torch.arange(idx.row_ptr.numel() - 1),
                                   idx.row_ptr.diff().long())
    vals = pack.data.reshape(-1)[(rows // bs) * _stride(pack) + idx.off.long()].float()
    src = idx.src.long()
    if isinstance(pack, spm.BcsrPack):
        return scale * torch.zeros_like(x).index_add_(0, rows, vals[:, None] * x[src])
    factor = torch.ones(x.shape[0] if _vn(pack) else x.shape[1])
    if pack.scales is not None:
        live = min(factor.numel(), pack.scales.numel())
        factor[:live] = pack.scales.reshape(-1)[:live]
    if _vn(pack):
        y = torch.zeros_like(x).index_add_(0, rows, vals[:, None] * x[src])
        return scale * (y * factor[:, None])
    y = torch.zeros_like(x).index_add_(1, rows, vals[None, :] * x[:, src])
    return scale * (y * factor)


def _index_modes(pack, x, g, mode):
    """The modes over the index product, as the kernels compose them."""
    if mode == "single":
        return _index_product(pack, x)
    if mode == "pair":
        t1 = _index_product(pack, x)
        return t1, 2.0 * _index_product(pack, t1) - x
    u = g + 2.0 * _index_product(pack, x)
    return u, _index_product(pack, u) - x


def _x(pack, n, seed=5):
    if isinstance(pack, SlabPack):
        vp = pack.v_pad
    else:
        vp = pack.cols.shape[0] * pack.data.shape[-1]
    shape = (vp, n) if _vn(pack) else (n, vp)
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))


def _reference(pack, x, scale=1.0, g=None, mode="single"):
    """The port's plain version of the pack's kernel in ``mode``."""
    if isinstance(pack, spm.BcsrPack):
        return spm.bcsr_spmm_reference(pack, x, scale=scale)
    if isinstance(pack, ek.EllPack):
        return ek.ell_nv_reference(pack, x, g, mode, scale=scale)
    if pack.transposed:
        return tnv.stream_nv_reference(pack.data, pack.lo, x, g, mode, scales=pack.scales,
                                       scale=scale)
    return tbs.banded_vn_reference(pack.data, pack.lo, x, g, mode, scales=pack.scales,
                                   scale=scale)


def _jax_banded(kind, pack, x, g, mode):
    """The JAX functions (off-TPU branches) on the port's pack: K5's
    ``_stream_nv_call``; K7's ``banded_spmm`` (its ``nbr·bs`` rows cut or
    padded to ``v_pad``, as every caller does), K9's pair
    ``_cheb_pair_stream_primal`` and chain ``_pair_stream_fallback`` on the
    stream packs, K8's ``banded_cheb_pair`` on the clamped one and its
    backward (two ``banded_spmm`` on the transpose pack) for the chain."""
    slabs, lo = jnp.asarray(pack.data.numpy()), jnp.asarray(pack.lo.numpy())
    scales = None if pack.scales is None else jnp.asarray(pack.scales.numpy())
    xj, gj = jnp.asarray(x.numpy()), None if g is None else jnp.asarray(g.numpy())
    if pack.transposed:
        return jnv._stream_nv_call(slabs, lo, xj, gj, scales, None, mode)

    def one(v):
        y = jbs.banded_spmm(slabs, lo, v, block_size=pack.bs, use_pallas=False, scales=scales)
        y = y[:pack.v_pad]
        return jnp.pad(y, ((0, pack.v_pad - y.shape[0]), (0, 0)))

    if mode == "single":
        return one(xj)
    if kind == "vn_clamped":
        if mode == "pair":
            return jbs.banded_cheb_pair(slabs, lo, xj, use_pallas=False)
        u = gj + 2.0 * one(xj)
        return u, one(u) - xj
    if mode == "pair":
        return jbs._cheb_pair_stream_primal(slabs, lo, xj, scales, False)
    return jbs._pair_stream_fallback(slabs, lo, xj, gj, scales, None, pack.bs)


def _csr_index(matrix, pack):
    """``(row_ptr, src, stored)`` that the packed matrix implies, in CSR
    order: its entries whose stored value (f32, or an int8 pack's
    ``rint(value / row factor)`` in the packer's precision) is nonzero,
    over the padded rows (a slab pack's ``v_pad`` rows: past it none)."""
    csr = sp.csr_matrix(matrix)
    csr.sort_indices()
    rows = np.repeat(np.arange(csr.shape[0]), np.diff(csr.indptr))
    if getattr(pack, "scales", None) is None:
        stored = csr.data.astype(np.float32)
    else:   # as each packer quantizes: the banded one in float32, the ELL one in float64
        values = csr.data.astype(np.float32) if isinstance(pack, SlabPack) else csr.data
        stored = np.rint(values / pack.scales.numpy().reshape(-1)[rows]).astype(np.int8)
    keep = stored != 0
    rows, src, stored = rows[keep], csr.indices[keep], stored[keep]
    vp = pack.v_pad if isinstance(pack, SlabPack) else pack.cols.shape[0] * pack.data.shape[-1]
    row_ptr = np.zeros(vp + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=vp), out=row_ptr[1:])
    return row_ptr, src, stored


def _check_slab_index(idx, pack, src, stored):
    """Each offset of a slab pack's index lies in its row's slab row (vn) or
    lane (nv), at the window position of its source vertex, and holds the
    stored value."""
    rows = np.repeat(np.arange(idx.row_ptr.numel() - 1), np.diff(idx.row_ptr.numpy()))
    br, off = rows // pack.bs, idx.off.numpy().astype(np.int64)
    lane, k = (off % pack.bs, off // pack.bs) if pack.transposed else \
        (off // pack.w, off % pack.w)
    assert (lane == rows % pack.bs).all() and (k < pack.w).all()
    assert np.array_equal(pack.lo.numpy().astype(np.int64)[br] + k, src)
    nbr = pack.data.shape[0]
    assert np.array_equal(pack.data.numpy().reshape(nbr, -1)[br, off], stored)


def _check_tile_index(idx, pack, src, stored, transposed):
    rows = np.repeat(np.arange(idx.row_ptr.numel() - 1), np.diff(idx.row_ptr.numpy()))
    nbr, max_b, bs, _ = pack.data.shape
    k, pos = np.divmod(idx.off.numpy().astype(np.int64), bs * bs)
    lane, c = (pos % bs, pos // bs) if transposed else (pos // bs, pos % bs)
    br = rows // bs
    assert (k < pack.counts.numpy()[br]).all() and (lane == rows % bs).all()
    assert np.array_equal(pack.cols.numpy()[br, k] * bs + c, src)
    assert np.array_equal(pack.data.numpy().reshape(nbr, -1)[br, idx.off.numpy()], stored)


def check_packer_index(kind, n_vertex, bs, gso_type):
    """The packs leave the index unbuilt; the first launch builds it from
    the tile or slab values, once for a symmetric GSO's shared pack (the
    clamped pack of ``stream=False`` packs Aᵀ apart), and it equals the
    index of the packed matrix: the same rows and source vertices in CSR
    order, each offset in its block row's tiles or slab at the position of
    (row, source), holding the stored value (an int8 value that rounds to 0
    left out)."""
    op = _op(kind, n_vertex, bs, gso_type)
    assert (op.pack_t is op.pack) == (gso_type == "sym_norm_lap" and kind != "vn_clamped")
    matrix = _rcm_gso(n_vertex, gso_type).matrix
    packs = [(op.pack, matrix)] + [(op.pack_t, matrix.T)] * (op.pack_t is not op.pack)
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
        if isinstance(pack, SlabPack):
            _check_slab_index(idx, pack, src, stored)
        else:
            _check_tile_index(idx, pack, src, stored, kind != "bcsr")
        assert idx.nnz == int((pack.data != 0).sum())
    before = nnz_index.builds()
    assert _current(op.pack_t) is op.pack_t.index and nnz_index.builds() == before


def check_index_product(kind, n_vertex, bs, gso_type):
    """One application over the index (scale 1 and 2) against the port's
    plain version and the JAX reference on the same pack; for ELL and the
    banded packs every mode (chain on the transpose pack) against the plain
    version, and for the banded packs against the JAX functions too, on
    operands whose padded rows or lanes are not zero."""
    op = _op(kind, n_vertex, bs, gso_type)
    pack = op.pack
    x = _x(pack, 97)
    got = _index_product(pack, x)
    torch.testing.assert_close(got, _reference(pack, x), **TOL)
    torch.testing.assert_close(_index_product(pack, x, 2.0), _reference(pack, x, 2.0), **TOL)
    if kind in BANDED:
        ref = _jax_banded(kind, pack, x, None, "single")
    elif kind == "bcsr":
        ref = jsp.bcsr_spmm_reference(jnp.asarray(pack.data.numpy()),
                                      jnp.asarray(pack.cols.numpy()), jnp.asarray(x.numpy()),
                                      block_size=bs)
    else:
        scales = None if pack.scales is None else jnp.asarray(pack.scales.numpy())
        ref = jek.ell_nv_reference(jnp.asarray(pack.data.numpy()), jnp.asarray(pack.cols.numpy()),
                                   jnp.asarray(pack.counts.numpy()), jnp.asarray(x.numpy()),
                                   scales)
    torch.testing.assert_close(got, torch.from_numpy(np.array(ref)), **TOL)
    if kind != "bcsr":
        g = _x(pack, 97, seed=6)
        for mode, p in (("pair", op.pack), ("chain", op.pack_t)):
            gm = g if mode == "chain" else None
            refs = [_reference(p, x, g=gm, mode=mode)]
            if kind in BANDED:
                refs.append([torch.from_numpy(np.array(r))
                             for r in _jax_banded(kind, p, x, gm, mode)])
            for ref in refs:
                for a, b in zip(_index_modes(p, x, gm, mode), ref):
                    torch.testing.assert_close(a, b, **TOL)


def _zero_entry(pack):
    """(block row, slot, r, c) of a zero entry of a live tile, or (block
    row, r, c) of a zero entry of a slab."""
    if isinstance(pack, SlabPack):
        zeros = torch.nonzero(pack.data == 0)
    else:
        live = torch.arange(pack.cols.shape[1])[None, :] < pack.counts[:, None]
        zeros = torch.nonzero((pack.data == 0) & live[:, :, None, None])
    return tuple(int(v) for v in zeros[len(zeros) // 2])


@pytest.mark.parametrize("n_vertex,bs,gso_type", GRAPHS)
@pytest.mark.parametrize("kind", TILE_KINDS)
def test_packer_index_equals_rebuilt(kind, n_vertex, bs, gso_type):
    """``check_packer_index`` on the tile packs (the banded ones:
    ``tests/test_torch_sparse_index_2.py``)."""
    check_packer_index(kind, n_vertex, bs, gso_type)


@pytest.mark.parametrize("kind", KINDS)
def test_in_place_edit_rebuilds_once(kind):
    """A zero tile entry set in place (a learned tile value leaving zero)
    makes the next launch rebuild the index once, and the product follows
    the new values; further launches, unchanged values and a ``detach()``
    alias rebuild nothing; a pack of other tiles never runs on this one's
    index. The same for a zero slab entry inside a window."""
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
        pack.data[_zero_entry(pack)] = 3 if pack.data.dtype == torch.int8 else 0.5
    torch.testing.assert_close(_index_product(pack, x), _reference(pack, x), **TOL)
    assert nnz_index.builds() == before + 1 and pack.index.nnz == nnz + 1
    # the shared transpose follows (the clamped pack packs Aᵀ apart)
    assert (op.pack_t.index is pack.index) == (kind != "vn_clamped")
    _current(pack)
    _current(alias)
    assert nnz_index.builds() == before + 1
    other = pack._replace(data=pack.data.clone())
    torch.testing.assert_close(_index_product(other, x), _reference(other, x), **TOL)
    assert nnz_index.builds() == before + 2 and pack.index.built_for(other.data)


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
