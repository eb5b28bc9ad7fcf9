"""Host side of the banded slab pack (port of the pack functions of
``stgcn_tpu/kernels/banded_spmm.py``: ``_round_up`` :46, ``_window_meta`` :50,
``banded_viable`` :440, ``cheb_pair_stream_safe`` :598, ``pack_banded_device``
:1026).

After reverse Cuthill–McKee reordering a road graph's GSO has a narrow band:
every nonzero of a ``bs``-row block lies in one column window. The pack
stores each block row as one dense slab over its window, zero-filled; the
nv kernel K5 (:mod:`stgcn_tpu_torch.kernels.banded_nv`) multiplies by the
slabs directly. The windows here are the streaming kind
(``contain_diag=True``, ``col_align=bs`` in the JAX functions): block-aligned
and covering each block's own diagonal, as the fused path's pack is built on
the TPU. The vn-layout packs and kernels of that module (K7-K9) are not
ported yet.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from stgcn_tpu_torch.device import resolve_device


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _window_meta(csr: sp.csr_matrix, block_size: int) -> tuple[np.ndarray, np.ndarray, int, int]:
    """Per-block-row column-window metadata of the streaming pack (the JAX
    ``_window_meta(csr, bs, col_align=bs, contain_diag=True)``): window
    starts aligned to the block, raw entry-extent ends, the common (max,
    aligned) window width, and the natural ``v_pad``.

    Each window is widened to cover the block's own diagonal rows
    ``[i*bs, (i+1)*bs)`` — the precondition of the streaming pair, whose T1
    operand is addressed at block granularity."""
    v = csr.shape[0]
    bs = block_size
    nbr = -(-v // bs)
    lo = np.zeros(nbr, np.int64)
    hi = np.zeros(nbr, np.int64)
    indptr, indices = csr.indptr, csr.indices
    for i in range(nbr):
        s, e = indptr[i * bs], indptr[min((i + 1) * bs, v)]
        if e > s:
            seg = indices[s:e]
            lo[i], hi[i] = seg.min(), seg.max() + 1
        else:
            # empty block row: park the window at the block's own diagonal
            lo[i], hi[i] = i * bs, i * bs + 1
    blocks = np.arange(nbr, dtype=np.int64)
    lo = np.minimum(lo, blocks * bs)
    hi = np.maximum(hi, (blocks + 1) * bs)
    lo_al = (lo // bs) * bs
    width = int((hi - lo_al).max())
    w = _round_up(max(width, bs), bs)
    # windows are never clamped (that would break block alignment and
    # diagonal coverage): pad x far enough to cover every window
    natural = _round_up(max(v, int(lo_al.max()) + w), bs)
    return lo_al, hi, w, natural


def banded_viable(matrix: sp.spmatrix, *, block_size: int = 128,
                  max_width: int = 4096) -> bool:
    """Cheap check: is the post-RCM band narrow enough for the slab path?"""
    csr = sp.csr_matrix(matrix)
    v = csr.shape[0]
    nbr = -(-v // block_size)
    width = 0
    for i in range(0, nbr, max(nbr // 64, 1)):  # sample block rows
        s, e = csr.indptr[i * block_size], csr.indptr[min((i + 1) * block_size, v)]
        if e > s:
            seg = csr.indices[s:e]
            width = max(width, int(seg.max()) - int(seg.min()) + 1)
    return width <= max_width


def cheb_pair_stream_safe(lo, w: int, block_size: int) -> bool:
    """Preconditions of the streaming pair and chain: block-aligned windows
    that contain each block's own diagonal rows — what
    :func:`pack_banded_device` produces."""
    lo = np.asarray(lo, np.int64)
    i = np.arange(len(lo), dtype=np.int64)
    return bool(w % block_size == 0
                and (lo % block_size == 0).all()
                and (lo <= i * block_size).all()
                and (lo + w >= (i + 1) * block_size).all())


def pack_banded_device(matrix: sp.spmatrix, *, block_size: int = 256,
                       v_pad: int | None = None, device: str | torch.device = "cuda"):
    """The streaming nv pack (the JAX ``pack_banded_device(contain_diag=True,
    col_align=block_size, transpose_slabs=True)``), built on the device:
    only the COO triplets travel there; the zero-filled slabs (717 MB at
    100k vertices) are scattered in place by one ``index_put_``. Returns
    ``(slabs, lo, v_pad)``: ``slabs`` ``[nbr, w, bs]`` (each block row's
    slab transposed, the operand layout of K5), ``lo`` the int32 window
    starts (numpy). float32 only: the int8 pack with per-row scales comes
    with the ``banded_int8`` slice of the port."""
    csr = sp.csr_matrix(matrix)
    bs = block_size
    nbr = -(-csr.shape[0] // bs)
    lo, _, w, natural = _window_meta(csr, bs)
    if v_pad is None:
        v_pad = natural
    elif v_pad < natural:
        raise ValueError(f"v_pad={v_pad} too small (need >= {natural})")

    coo = csr.tocoo()
    br = (coo.row // bs).astype(np.int64)
    flat = (br * w + coo.col - lo[br]) * bs + coo.row - br * bs   # slabs[br, col - lo, row % bs]
    dev = resolve_device(device)
    slabs = torch.zeros(nbr * w * bs, dtype=torch.float32, device=dev)
    slabs.index_put_((torch.from_numpy(flat).to(dev),),
                     torch.from_numpy(coo.data.astype(np.float32)).to(dev))
    return slabs.reshape(nbr, w, bs), lo.astype(np.int32), v_pad
