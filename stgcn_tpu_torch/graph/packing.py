"""Blocked-ELL packs of the GSO: the nv pack of kernel K6 (port of
``pack_ell_nv``, ``stgcn_tpu/graph/packing.py:63-133``, f32 and int8) and
the BCSR pack of kernels K10/K11 (port of ``pack_bcsr``, ``:17-60``, and of
its native twin ``stgcn_tpu/native/packing.cpp``, f32).

The ``[V, V]`` operator is cut into ``bs × bs`` tiles and only the tiles that
hold a nonzero are kept, ``counts[i]`` of them for block row ``i``, padded
to a common ``max_b`` with all-zero tiles that point at block column 0; the
slots of a block row hold its column blocks in ascending order. The two
packs differ in the tile orientation:

- :func:`pack_ell_device` stores each tile pre-transposed (``data[i, k] =
  A_tile(i, k)ᵀ``), the operand layout of the nv kernel
  :mod:`stgcn_tpu_torch.kernels.ell_nv`. An int8 pack stores
  ``rint(A[r, c] / scales[r])`` (computed in float64) with the per-row
  factor ``scales[r] = absmax_r / 127`` (1.0 for an empty row);
- :func:`pack_bcsr_device` stores each tile row-major (``data[i, k] =
  A_tile(i, k)``), the layout of the vn kernels :mod:`stgcn_tpu_torch.
  kernels.spmm` (K10) and :mod:`~stgcn_tpu_torch.kernels.sddmm` (K11),
  float32 only: each float64 GSO value rounded to float32 once, as the
  native packer rounds before it packs.

The JAX package assembles the pack on the host, one block row at a time
(59 s for the ELL pack at 1M vertices there; the BCSR one is a 13.3 GB
float32 host array there). Here the index of every nonzero in the pack is
computed for all of them at once (:func:`_ell_layout`), and the device
packers send only the indices and values to the device and scatter there,
into a zeroed tensor; on the CPU their results equal the JAX functions'
exactly.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from stgcn_tpu_torch.device import resolve_device


def _ell_layout(matrix: sp.spmatrix, block_size: int, quantize: bool, transposed: bool = True):
    """Where every nonzero goes in the pack, and its stored value; the tiles
    are transposed (the nv pack) or row-major (the BCSR pack).

    Returns ``(flat, values, cols, counts, scales, shape)``: ``flat`` the
    int64 offset of each nonzero in the flattened ``[nbr, max_b, bs, bs]``
    pack, ``values`` its stored value (int8 when ``quantize``, else
    float32), and the pack's ``cols``, ``counts``, ``scales`` (None unless
    ``quantize``) and shape."""
    csr = sp.csr_matrix(matrix)
    v = csr.shape[0]
    bs = block_size
    nbr = -(-v // bs)
    n_bc = -(-csr.shape[1] // bs)
    indptr, indices, vals = csr.indptr, csr.indices.astype(np.int64), csr.data

    scales_rows = None
    if quantize:
        absmax = np.zeros(nbr * bs, np.float64)
        # per-row abs max without a dense temporary
        absmax[:v] = np.maximum.reduceat(np.abs(np.concatenate([vals, [0.0]])),
                                         np.minimum(indptr[:-1], len(vals)))
        absmax[:v][np.diff(indptr) == 0] = 0.0
        scales_rows = (absmax / 127.0).astype(np.float32)
        scales_rows[scales_rows == 0.0] = 1.0

    row_of = np.repeat(np.arange(v, dtype=np.int64), np.diff(indptr))
    br, cb = row_of // bs, indices // bs
    # the live tiles, sorted by block row, then column block: a tile's slot
    # is its rank among its block row's tiles
    tiles, tile_of = np.unique(br * n_bc + cb, return_inverse=True)
    tile_br = tiles // n_bc
    counts = np.bincount(tile_br, minlength=nbr).astype(np.int32)
    tile_slot = np.arange(len(tiles)) - (np.cumsum(counts) - counts)[tile_br]
    max_b = max(int(counts.max()), 1)
    cols = np.zeros((nbr, max_b), np.int32)
    cols[tile_br, tile_slot] = tiles % n_bc
    # a tile's offset, then [col-local, row-local] (transposed) or [row-local, col-local]
    lead, trail = (indices % bs, row_of - br * bs) if transposed else (row_of - br * bs,
                                                                       indices % bs)
    flat = ((br * max_b + tile_slot[tile_of.ravel()]) * bs + lead) * bs + trail

    values = vals.astype(np.float64)
    if quantize:
        values = np.rint(values / scales_rows[row_of]).astype(np.int8)
    else:
        values = values.astype(np.float32)
    scales = None if scales_rows is None else scales_rows.reshape(nbr, bs)
    return flat, values, cols, counts, scales, (nbr, max_b, bs, bs)


def pack_ell_device(matrix: sp.spmatrix, *, block_size: int = 256, quantize: bool = False,
                    dtype: torch.dtype = torch.float32, device: str | torch.device = "cuda"):
    """The JAX ``pack_ell_nv`` built on ``device``: the pack's indices and
    values travel there, the zero-filled tiles (3.3 GB int8 for the
    1M-vertex road graph) are scattered in place by one ``index_put_``.
    Returns ``(data, cols, counts, scales)`` as tensors on ``device``:
    ``data`` ``[nbr, max_b, bs, bs]`` (int8 when ``quantize``, else float32,
    or ``dtype=torch.bfloat16``: each float32 value rounded to nearest even,
    as the JAX ``ell_graph_op`` casts its float32 host pack on transfer),
    ``cols`` ``[nbr, max_b]`` int32, ``counts`` ``[nbr]`` int32, ``scales``
    ``[nbr, bs]`` float32 or None."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the ELL tiles are float32 or bfloat16 (or int8 by quantize), got "
                        f"{dtype}")
    dev = resolve_device(device)
    flat, values, cols, counts, scales, shape = _ell_layout(matrix, block_size, quantize)
    return (_scatter(flat, values, shape, dev, None if quantize else dtype),
            torch.from_numpy(cols).to(dev), torch.from_numpy(counts).to(dev),
            None if scales is None else torch.from_numpy(scales).to(dev))


def pack_bcsr_device(matrix: sp.spmatrix, *, block_size: int = 256,
                     dtype: torch.dtype = torch.float32, device: str | torch.device = "cuda"):
    """The JAX ``pack_bcsr`` built on ``device`` (13.3 GB of float32 tiles
    for the 1M-vertex road graph, scattered in place). Returns ``(data,
    cols, counts)`` as tensors on ``device``: ``data`` ``[nbr, max_b, bs,
    bs]`` row-major tiles, float32 or ``dtype=torch.bfloat16`` (each float32
    value rounded to nearest even, as ``jnp.asarray(data, bfloat16)``),
    ``cols`` ``[nbr, max_b]`` int32 (padding slots: 0), ``counts`` ``[nbr]``
    int32."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the BCSR tiles are float32 or bfloat16, got {dtype}")
    dev = resolve_device(device)
    flat, values, cols, counts, _, shape = _ell_layout(matrix, block_size, False,
                                                       transposed=False)
    return (_scatter(flat, values, shape, dev, dtype), torch.from_numpy(cols).to(dev),
            torch.from_numpy(counts).to(dev))


def _scatter(flat: np.ndarray, values: np.ndarray, shape: tuple, dev: torch.device,
             dtype: torch.dtype | None = None):
    """A zeroed tensor of ``shape`` on ``dev`` with ``values`` (cast to
    ``dtype`` when given) at the flat offsets ``flat`` (one ``index_put_``)."""
    values = torch.from_numpy(values).to(dev)
    if dtype is not None:
        values = values.to(dtype)
    data = torch.zeros(int(np.prod(shape)), dtype=values.dtype, device=dev)
    data.index_put_((torch.from_numpy(flat).to(dev),), values)
    return data.reshape(shape)
