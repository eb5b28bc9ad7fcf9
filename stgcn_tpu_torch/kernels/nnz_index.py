"""The nonzero index of a tile or slab pack: what K6 (:mod:`.ell_nv`), K10
(:mod:`.spmm`), K5 (:mod:`.banded_nv`) and the vn kernel of K7-K9
(:mod:`.banded_spmm`) walk instead of the ``bs × bs`` tiles or the band.

A blocked-ELL or BCSR pack keeps each block row's live ``bs × bs`` tiles,
and a road graph fills a live tile to under 1 % (at 1M vertices about 300
nonzeros in each tile's 65,536 entries); a banded pack keeps each block
row's whole column window, which a road graph fills to 0.57 % (100k
vertices, RCM, bs = 256: 1.02M nonzeros in 391 slabs of 256 × 1792). The
index lists the nonzeros in CSR order, by output row, then ascending
source vertex:

- ``row_ptr`` ``[rows + 1]`` int32: output row ``r``'s nonzeros are
  ``row_ptr[r] .. row_ptr[r + 1]`` (padded rows are empty); ``rows`` is
  ``nbr·bs`` for a tile pack and the operand's ``v_pad`` for a slab pack;
- ``src`` ``[nnz]`` int32: the source vertex, ``cols[i, k]·bs + c`` in a
  tile pack, ``lo[i] + k`` in a slab pack;
- ``off`` ``[nnz]`` int32: the value's offset in its own block row's tiles
  or slab, ``k·bs² + position`` (position ``a·bs + c`` in a row-major BCSR
  tile, ``c·bs + b`` in a transposed ELL tile), ``a·w + k`` in a vn slab
  ``[bs, w]``, ``k·bs + b`` in an nv slab ``[w, bs]``.

The values stay in the tiles or slabs: a kernel reads each one at ``off``,
so the index is built from the values the kernel reads (a bf16 pack's bf16
values: an entry that rounds to zero in bf16 is left out).
The graph operators give each pack an unbuilt :class:`NnzIndex` (one for
both directions of a symmetric GSO, which shares its pack), and the first
CUDA launch builds it on the device from the values
(:func:`index_from_tiles` or :func:`index_from_slabs`, through
:func:`current`). The index follows the values: it records the tensor's
``(data_ptr, _version)`` when it is built, and :func:`current` rebuilds it
when a launch brings values it was not built for, as after an in-place
update of learned tile values (K11 gives them a gradient over the whole
tile, so an entry can leave zero). A ``detach()`` alias shares the version
counter and so the index. Every build is counted (:func:`builds`), so a run
can show that a fit builds each pack's index once and never rebuilds it.
The packing metadata (``cols``, ``counts``, ``lo``) is fixed: an edit of it
is not followed.

The limit: only an edit through the values tensor itself (or a
``detach()`` alias), under ``torch.no_grad``, moves the version counter. An
edit through ``pack.data.data`` (``param.data.copy_(…)``,
``.data.clamp_()``) goes through a tensor with a counter of its own, so the
index does not see it and the kernels would walk the old nonzeros; after
such an edit call :meth:`NnzIndex.invalidate`.
"""

from __future__ import annotations

import weakref

import torch

# elements of the rebuild's largest temporary (one chunk of block rows)
CHUNK_ELEMS = 1 << 26
_BUILDS = [0]


def builds() -> int:
    """Index builds from the tile or slab values so far (first builds and rebuilds)."""
    return _BUILDS[0]


class NnzIndex:
    """The index of a pack's current tile or slab values (mutable: a
    rebuild replaces the tensors in place, so every pack that carries it,
    the transpose of a symmetric operator included, sees the new one). It
    follows in-place edits of the values tensor, not edits through its
    ``.data`` (call :meth:`invalidate` after those)."""

    __slots__ = ("row_ptr", "src", "off", "_ptr", "_version", "_source")

    def __init__(self) -> None:
        self.row_ptr = self.src = self.off = None
        self._ptr, self._version, self._source = 0, -1, None

    def bind(self, data: torch.Tensor, row_ptr, src, off) -> NnzIndex:
        """Take ``(row_ptr, src, off)`` as the index of ``data``'s current
        values (counted as a build)."""
        self.row_ptr, self.src, self.off = row_ptr, src, off
        self._ptr, self._version, self._source = (data.data_ptr(), data._version,
                                                  weakref.ref(data))
        _BUILDS[0] += 1
        return self

    def built_for(self, data: torch.Tensor) -> bool:
        """True when the index was built from these values: the same
        storage, alive, at the same version."""
        src = self._source() if self._source is not None else None
        return (src is not None and self._ptr == data.data_ptr()
                and self._version == data._version)

    def invalidate(self) -> None:
        """Make the next launch rebuild the index, after an edit of the
        values that the version counter does not see (through ``.data``)."""
        self._source = None

    @property
    def nnz(self) -> int:
        return 0 if self.src is None else self.src.numel()

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.row_ptr, self.src, self.off)
                   if t is not None)

    def to(self, device) -> NnzIndex:
        """An unbuilt index: the values on another device are other tensors,
        so their index is built from their values at their first launch."""
        return NnzIndex()


def _check_int32(per_row: int, rows: int, nnz: int) -> None:
    if max(per_row, rows + 1, nnz) >= 2 ** 31:
        raise ValueError(f"the nonzero index is int32: a pack of {rows} rows, {per_row} values "
                         f"a block row and {nnz} nonzeros does not fit it")


def _row_ptr(row_counts: torch.Tensor) -> torch.Tensor:
    row_ptr = torch.zeros(row_counts.numel() + 1, dtype=torch.int64, device=row_counts.device)
    torch.cumsum(row_counts, 0, out=row_ptr[1:])
    return row_ptr


def index_from_tiles(data: torch.Tensor, cols: torch.Tensor, counts: torch.Tensor, *,
                     transposed: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(row_ptr, src, off)`` of the nonzero values of the live tiles
    (``k < counts[i]``), on the tiles' device, one chunk of block rows at a
    time: ``torch.nonzero`` lists a chunk's nonzeros by (block row, slot,
    tile row, tile column); a stable sort by output row keeps each row's in
    ascending (slot, column), which is ascending source vertex. The output
    lane is the tile row of a row-major (BCSR) tile and the tile column of
    a ``transposed`` (ELL) one."""
    nbr, max_b, bs, _ = data.shape
    dev = data.device
    live = torch.arange(max_b, device=dev)[None, :] < counts.to(dev).long()[:, None]
    cols = cols.to(dev).long()
    step = max(1, CHUNK_ELEMS // (max_b * bs * bs))
    row_counts = torch.zeros(nbr * bs, dtype=torch.int64, device=dev)
    srcs, offs = [], []
    for s in range(0, nbr, step):
        nz = torch.nonzero((data[s:s + step] != 0) & live[s:s + step, :, None, None])
        r, k, p, q = nz.unbind(1)
        lane, c = (q, p) if transposed else (p, q)
        row = (s + r) * bs + lane
        row, order = torch.sort(row, stable=True)
        srcs.append((cols[s + r, k] * bs + c)[order])
        offs.append(((k * bs + p) * bs + q)[order])
        row_counts += torch.bincount(row, minlength=nbr * bs)
    src, off = torch.cat(srcs), torch.cat(offs)
    _check_int32(max_b * bs * bs, nbr * bs, src.numel())
    return _row_ptr(row_counts).int(), src.int(), off.int()


def index_from_slabs(slabs: torch.Tensor, lo: torch.Tensor, v_pad: int, *,
                     transposed: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(row_ptr, src, off)`` of the nonzero values of a banded pack, on the
    slabs' device, one chunk of block rows at a time, for an operand of
    ``v_pad`` rows: vn slabs ``[nbr, bs, w]`` (row ``i·bs + a``, offset
    ``a·w + k``) or, ``transposed``, nv slabs ``[nbr, w, bs]`` (row
    ``i·bs + b``, offset ``k·bs + b``); the source vertex is ``lo[i] + k``
    either way. ``torch.nonzero`` lists a vn chunk's nonzeros by (block
    row, slab row, k), already CSR order; an nv chunk's by (block row, k,
    lane), so a stable sort by output row keeps each row's in ascending k,
    which is ascending source vertex. Rows and sources at or past
    ``v_pad`` are left out (the kernels read x as zero there), so
    ``row_ptr`` has ``v_pad + 1`` entries, empty past ``nbr·bs``."""
    nbr, d1, d2 = slabs.shape
    bs, w = (d2, d1) if transposed else (d1, d2)
    dev = slabs.device
    lo = lo.to(dev).long()
    step = max(1, CHUNK_ELEMS // (bs * w))
    row_counts = torch.zeros(v_pad, dtype=torch.int64, device=dev)
    srcs, offs = [], []
    for s in range(0, nbr, step):
        r, p, q = torch.nonzero(slabs[s:s + step] != 0).unbind(1)
        lane, k = (q, p) if transposed else (p, q)
        row, src = (s + r) * bs + lane, lo[s + r] + k
        keep = (row < v_pad) & (src < v_pad)
        row, src, off = row[keep], src[keep], (p * d2 + q)[keep]
        if transposed:
            row, order = torch.sort(row, stable=True)
            src, off = src[order], off[order]
        srcs.append(src)
        offs.append(off)
        row_counts += torch.bincount(row, minlength=v_pad)
    src, off = torch.cat(srcs), torch.cat(offs)
    _check_int32(bs * w, max(v_pad, nbr * bs), src.numel())
    return _row_ptr(row_counts).int(), src.int(), off.int()


def current(index: NnzIndex | None, data: torch.Tensor, *meta, transposed: bool, name: str,
            build=index_from_tiles) -> NnzIndex:
    """``index``, rebuilt first by ``build(data, *meta, transposed=…)``
    (:func:`index_from_tiles` with ``cols, counts``; :func:`index_from_slabs`
    with ``lo, v_pad``) unless it was built for these values; raises for a
    pack without one, and for values made under ``torch.inference_mode``
    (they have no version counter to follow)."""
    if index is None:
        raise ValueError(f"{name}: the pack carries no nonzero index; give it index=NnzIndex() "
                         "(the graph operators do) and its first launch builds it")
    if data.is_inference():
        raise ValueError(f"{name}: values made under torch.inference_mode have no version "
                         "counter for the nonzero index to follow; build the pack outside it")
    if not index.built_for(data):
        index.bind(data, *build(data, *meta, transposed=transposed))
    return index


def require(index: NnzIndex, rows: int, device: torch.device) -> tuple[int, int, int]:
    """Check a built index for a kernel of ``rows`` output rows on
    ``device``; returns the pointers ``(row_ptr, src, off)``."""
    nnz = index.nnz
    for t, name, shape in ((index.row_ptr, "row_ptr", (rows + 1,)), (index.src, "src", (nnz,)),
                           (index.off, "off", (nnz,))):
        if t is None or t.device != device or t.dtype != torch.int32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"the nonzero index's {name} must be a contiguous int32 "
                             f"{list(shape)} tensor on {device}")
    return index.row_ptr.data_ptr(), index.src.data_ptr(), index.off.data_ptr()
