"""Banded-slab SpMM on the vn operand ``[V, N]`` (port of
``stgcn_tpu/kernels/banded_spmm.py``): the slab packs, and the kernels K7
(one application), K8 (the Chebyshev pair on a clamped pack) and K9 (the
streaming pair and its VJP chain), float32, bf16 or int8 slabs under a
float32 or bf16 operand.

After reverse Cuthill–McKee reordering a road graph's GSO has a narrow band:
every nonzero of a ``bs``-row block lies in one column window. A pack
stores each block row as one dense slab over its window, zero-filled:

- :func:`pack_banded` (JAX :93) — 128-aligned windows clamped to
  ``lo_i + w <= v_pad``, the non-stream pack of ``banded_graph_op(stream=
  False)``; :func:`pack_banded_with_transpose` (:427) packs ``A`` and ``Aᵀ``
  with one ``v_pad``;
- :func:`pack_banded_device` (:1026) — the pack scattered on the device
  from the COO triplets; ``contain_diag=True, col_align=bs`` gives the
  streaming pack (block-aligned windows that cover each block's own
  diagonal), ``dtype=torch.int8`` int8 slabs with per-row scales,
  ``dtype=torch.bfloat16`` bf16 slabs (each value rounded to nearest even),
  ``transpose_slabs=True`` the nv layout ``[nbr, w, bs]`` of K5
  (:mod:`stgcn_tpu_torch.kernels.banded_nv`).

One application on the vn operand, slab ``i`` row-major ``[bs, w]`` over the
window starting at ``lo_i``, ``s`` the per-row dequant factors of an int8
pack (1 for f32), ``α`` a scalar:

    y[i·bs + a, c] = α · s[i·bs + a] · Σ_k slab_i[a, k] · x[lo_i + k, c]

The TPU has four kernels for it. K7a ``_banded_pallas_resident`` (:255) and
K7b ``_banded_pallas`` (:302) differ only in whether x sits in VMEM or is
streamed by DMA; K8 ``banded_cheb_pair`` (:519) and K9 ``_pair_stream_call``
(:774) run the ks=3 Chebyshev pair ``(A x, 2 A (A x) − x)`` (and K9 its
VJP chain ``(u = g1 + 2 Aᵀ g2, Aᵀ u − g2)``) as wavefronts over a
sequential grid, the slab streamed once for both applications. On Hopper
one CUDA kernel (``csrc/banded_vn.cu``) serves all four: x lies in device
memory either way, and a CUDA grid runs in no order, so the pair and the
chain are two passes through device memory, launched by one C entry point.
It runs at every width: the TPU's VMEM escape hatches (``_RESIDENT_X_BYTES``
:299, ``_pair_stream_fallback`` :753) have no counterpart. It does not walk
the band, which a road graph fills to 0.57 %: it walks the pack's nonzero
index (:func:`stgcn_tpu_torch.kernels.nnz_index.index_from_slabs`, which
the graph operator carries and the first launch builds from the slabs), a
warp per output row gathering the x rows of its nonzeros, as K10 does
(``csrc/csr_rows.cuh``). Each wrapper takes the pack's index as ``index``
(the chain the transpose pack's as ``index_t``); on the card it is needed.

Each wrapper counts its launches under its own name (:func:`launch_name`):
``vn_single`` (K7, :func:`banded_spmm`), ``vn_pair_resident`` (K8,
:func:`banded_cheb_pair`), ``vn_pair`` and ``vn_chain`` (K9,
:func:`banded_cheb_pair_stream`, :func:`banded_chain_stream`), with an
``_int8`` suffix on int8 packs and a ``_bf16`` suffix on a bf16 operand
(over float32, bf16 or int8 slabs). On a CPU tensor each runs its plain
version (:func:`banded_vn_reference`).

bf16 (the TPU kernels' bf16 operands into an f32 accumulator, JAX
:214-219, :245-250): a bf16 operand and bf16 slab values widen exactly to
float32, each output is one float32 sum, the scale and epilogue run in
float32, and the result is rounded once to the operand's type. The pair
rounds T1 to bf16 before the second application reads it (the TPU
kernel's ``t1c``, :719-721; in the chain from ``2·acc + g`` in float32,
:718), and ``t2 = round(y2 − x)`` from float32 (:744-748). The plain
versions keep these rounding points. The JAX off-TPU branch rounds
elsewhere (``_pair_stream_fallback`` :753-771: ``round(A t1)``, then
``2·that − x`` in bf16), so the two may differ by an ulp of bf16 there.

Padding: the operand and every output have ``v_pad`` rows (the JAX single
application returns ``nbr·bs`` rows; every caller cuts or pads them to
``v_pad``, the rows past the graph being zero). Past ``nbr·bs`` a row of
``A x`` is zero, so there ``t2 = −x``, ``u = g1`` and ``dx = −g2``: the
off-TPU branch of the JAX functions (:926-934, :954-964); the TPU kernel K9
writes zeros there (:866-871). Those rows are padding, and a slab entry
there is zero, so nothing downstream sees the difference.

:class:`BandedSpmmVjp`, :class:`BandedChebPairVjp` and
:class:`BandedChebPairStreamVjp` are the autograd Functions (JAX
``banded_spmm_vjp`` :381, ``banded_cheb_pair_vjp`` :979,
``banded_cheb_pair_stream_vjp`` :907): the backward runs the kernels on the
transpose pack. Like the K5 Functions they return no slab-value gradient:
``banded_sddmm_scan`` (:154) is a scan on the TPU, not a Pallas kernel, and
the trainer never differentiates the operator.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from stgcn_tpu_torch.device import resolve_device
from stgcn_tpu_torch.kernels import _build, nnz_index
from stgcn_tpu_torch.kernels._launch import (count_launch, cuda_device, on_cpu,
                                             refuse_value_grad, require, require_index,
                                             stream_of)

MODES = {"single": 0, "pair": 1, "chain": 2}
# elements of the plain version's largest temporary (one chunk of block rows)
REF_CHUNK_ELEMS = 1 << 26


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# --------------------------------------------------------------------------
# the packs (host side; the slabs are scattered on the device)
# --------------------------------------------------------------------------

def _window_meta(csr: sp.csr_matrix, block_size: int, col_align: int,
                 contain_diag: bool = False) -> tuple[np.ndarray, np.ndarray, int, int]:
    """Per-block-row column-window metadata: aligned window starts, raw
    entry-extent ends, the common (max, aligned) window width, and the
    natural ``v_pad``.

    ``contain_diag=True`` widens each window to cover the block's own
    diagonal rows ``[i*bs, (i+1)*bs)`` — the precondition of the streaming
    pair, whose operand is addressed at block granularity (pass
    ``col_align=block_size`` with it so windows start on block boundaries)."""
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
    if contain_diag:
        blocks = np.arange(nbr, dtype=np.int64)
        lo = np.minimum(lo, blocks * bs)
        hi = np.maximum(hi, (blocks + 1) * bs)
    lo_al = (lo // col_align) * col_align
    width = int((hi - lo_al).max())
    w = _round_up(max(width, col_align), col_align)
    if contain_diag:
        # windows must not be clamped (that would break block alignment and
        # diagonal coverage): pad x far enough to cover every window
        natural = _round_up(max(v, int(lo_al.max()) + w), col_align)
    else:
        natural = _round_up(max(v, w), col_align)
    return lo_al, hi, w, natural


def _scatter(coo: sp.coo_matrix, lo: np.ndarray, shape: tuple[int, int, int], vals: np.ndarray,
             dtype: torch.dtype, transpose_slabs: bool, dev: torch.device) -> torch.Tensor:
    """Zero-filled slabs ``[nbr, bs, w]`` (``[nbr, w, bs]`` when
    ``transpose_slabs``) with ``vals`` at the COO entries, scattered on
    ``dev`` by one ``index_put_``: only the triplets travel there."""
    nbr, bs, w = shape
    br = (coo.row // bs).astype(np.int64)
    r, c = coo.row - br * bs, coo.col - lo[br]
    flat = (br * w + c) * bs + r if transpose_slabs else (br * bs + r) * w + c
    slabs = torch.zeros(nbr * bs * w, dtype=dtype, device=dev)
    slabs.index_put_((torch.from_numpy(flat.astype(np.int64)).to(dev),),
                     torch.from_numpy(vals).to(dtype).to(dev))
    return slabs.reshape((nbr, w, bs) if transpose_slabs else (nbr, bs, w))


def pack_banded(matrix: sp.spmatrix, *, block_size: int = 128, col_align: int = 128,
                v_pad: int | None = None, dtype: torch.dtype = torch.float32,
                device: str | torch.device = "cuda"):
    """Pack an (RCM-ordered) sparse matrix into per-block-row dense slabs
    over ``col_align``-aligned windows, each clamped so ``lo_i + w <=
    v_pad``. Returns ``(slabs [nbr, bs, w] float32 (or ``dtype``,
    ``torch.bfloat16``) on the device, lo [nbr] int32 numpy, v_pad)``; pass
    ``v_pad`` to force a common padding with another pack (the transpose)."""
    csr = sp.csr_matrix(matrix)
    v = csr.shape[0]
    bs = block_size
    lo, _, w, natural = _window_meta(csr, bs, col_align)
    if v_pad is None:
        v_pad = natural
    elif v_pad < max(v, w):
        raise ValueError(f"v_pad={v_pad} too small (need >= {max(v, w)})")
    lo = np.minimum(lo, v_pad - w)
    coo = csr.tocoo()
    slabs = _scatter(coo, lo, (-(-v // bs), bs, w), coo.data.astype(np.float32),
                     _slab_dtype(dtype, int8=False), False, resolve_device(device))
    return slabs, lo.astype(np.int32), v_pad


def pack_banded_with_transpose(matrix: sp.spmatrix, *, block_size: int = 128,
                               dtype: torch.dtype = torch.float32,
                               device: str | torch.device = "cuda"):
    """Forward and transpose packs (the backward's ``Aᵀ``) with a common
    ``v_pad``: ``(slabs, lo, slabs_t, lo_t, v_pad)``."""
    csr = sp.csr_matrix(matrix)
    csr_t = csr.T.tocsr()
    v_pad = max(_window_meta(m, block_size, 128)[3] for m in (csr, csr_t))
    slabs, lo, _ = pack_banded(csr, block_size=block_size, v_pad=v_pad, dtype=dtype,
                               device=device)
    slabs_t, lo_t, _ = pack_banded(csr_t, block_size=block_size, v_pad=v_pad, dtype=dtype,
                                   device=device)
    return slabs, lo, slabs_t, lo_t, v_pad


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


def cheb_pair_wavefront_safe(lo, block_size: int) -> bool:
    """The TPU's wavefront pair (K8) reads T1 rows that earlier grid steps
    wrote, which holds only when every block's window starts at or before
    its own rows (``lo[i] <= i*bs``). The port's two passes need no such
    rule; the operator keeps the JAX decision so that it launches what the
    JAX package launches."""
    lo = np.asarray(lo)
    return bool(np.all(lo <= np.arange(len(lo), dtype=np.int64) * block_size))


def cheb_pair_stream_safe(lo, w: int, block_size: int) -> bool:
    """Preconditions of the streaming pair and chain (K9): block-aligned
    windows that contain each block's own diagonal rows — what
    ``pack_banded_device(contain_diag=True, col_align=block_size)`` produces."""
    lo = np.asarray(lo, np.int64)
    i = np.arange(len(lo), dtype=np.int64)
    return bool(w % block_size == 0
                and (lo % block_size == 0).all()
                and (lo <= i * block_size).all()
                and (lo + w >= (i + 1) * block_size).all())


def _slab_dtype(dtype: torch.dtype, int8: bool = True) -> torch.dtype:
    allowed = (torch.float32, torch.bfloat16, torch.int8) if int8 else (torch.float32,
                                                                      torch.bfloat16)
    if dtype not in allowed:
        raise TypeError(f"these banded slabs are {' or '.join(map(str, allowed))}, got {dtype}")
    return dtype


def pack_banded_device(matrix: sp.spmatrix, *, block_size: int = 256, col_align: int = 128,
                       dtype: torch.dtype = torch.float32, v_pad: int | None = None,
                       contain_diag: bool = False, transpose_slabs: bool = False,
                       device: str | torch.device = "cuda"):
    """The slab pack built on the device: only the COO triplets travel
    there; the zero-filled slabs (717 MB at 100k vertices in f32) are
    scattered in place. Returns ``(slabs, lo, v_pad)``, and for
    ``dtype=torch.int8`` also the per-row dequant factors ``scales [nbr,
    bs]`` float32 on the device: ``slabs`` ``[nbr, bs, w]`` (``[nbr, w, bs]``
    with ``transpose_slabs``, the operand layout of K5), float32, bf16 (each
    float32 value rounded to nearest even, the JAX ``v.astype(bfloat16)``)
    or int8, ``lo`` the int32 window starts (numpy).

    The int8 values are the JAX pack's, computed as it computes them, in
    float32: a row's scale is its max |a| / 127 (1 for an empty row), a
    value ``round(a / scale)`` clipped to ±127."""
    _slab_dtype(dtype)
    csr = sp.csr_matrix(matrix)
    bs = block_size
    nbr = -(-csr.shape[0] // bs)
    lo, _, w, natural = _window_meta(csr, bs, col_align, contain_diag=contain_diag)
    if v_pad is None:
        v_pad = natural
    elif v_pad < natural:
        raise ValueError(f"v_pad={v_pad} too small (need >= {natural})")
    if not contain_diag:   # diagonal-containing windows are never clamped (alignment)
        lo = np.minimum(lo, v_pad - w)
    lo = lo.astype(np.int64)

    coo = csr.tocoo()
    vals = coo.data.astype(np.float32)
    dev = resolve_device(device)
    scales = None
    if dtype == torch.int8:
        # per-matrix-row scale, applied to the output rows by the kernels
        row_max = np.zeros(nbr * bs, np.float32)
        np.maximum.at(row_max, coo.row, np.abs(vals))
        row_scale = np.where(row_max > 0, row_max / 127.0, 1.0)
        vals = np.clip(np.round(vals / row_scale[coo.row]), -127, 127)
        scales = torch.from_numpy(row_scale.astype(np.float32).reshape(nbr, bs)).to(dev)
    slabs = _scatter(coo, lo, (nbr, bs, w), vals, dtype, transpose_slabs, dev)
    if scales is not None:
        return slabs, lo.astype(np.int32), v_pad, scales
    return slabs, lo.astype(np.int32), v_pad


# --------------------------------------------------------------------------
# K7 / K8 / K9: plain versions and the kernel wrapper
# --------------------------------------------------------------------------

def launch_name(mode: str, quantized: bool = False, resident: bool = False,
                bf16: bool = False) -> str:
    """The launch counter of the vn kernel in ``mode``: ``vn_single`` (K7),
    ``vn_pair_resident`` (K8), ``vn_pair`` / ``vn_chain`` (K9); ``_int8``
    on an int8 pack, ``_bf16`` on a bf16 operand."""
    return (f"vn_{mode}{'_resident' if resident else ''}{'_int8' if quantized else ''}"
            f"{'_bf16' if bf16 else ''}")


def _apply_reference(slabs, lo, x, scales=None) -> torch.Tensor:
    """One application ``A x`` with ``x.shape[0]`` rows out (the JAX
    ``banded_spmm_reference`` :121, its ``nbr·bs`` rows cut or zero-padded),
    in float32 whatever the operand's and slabs' types (each widens
    exactly), chunked over block rows so the gathered windows stay small;
    the row factors multiply the sums."""
    nbr, bs, w = slabs.shape
    rows, n = x.shape
    chunk = max(1, REF_CHUNK_ELEMS // (w * max(n, bs)))
    lo = lo.to(x.device).long()
    ys = []
    for s in range(0, nbr, chunk):
        win = x[lo[s:s + chunk, None] + torch.arange(w, device=x.device)].float()  # [rows, w, n]
        y = torch.einsum("ibw,iwn->ibn", slabs[s:s + chunk].float(), win)
        ys.append(y if scales is None else y * scales[s:s + chunk, :, None])
    y = torch.cat(ys).reshape(nbr * bs, n)
    return torch.nn.functional.pad(y, (0, 0, 0, rows - nbr * bs)) if nbr * bs < rows \
        else y[:rows]


def vn_pass_reference(slabs, lo, x, add=None, *, alpha: float = 1.0, beta: float = 0.0,
                      scales=None) -> torch.Tensor:
    """Plain version of one pass of the vn kernel: ``alpha · (A x) + beta ·
    add`` in float32 (the row factors on the sum), rounded once to x's type."""
    y = _apply_reference(slabs, lo, x, scales)
    if alpha != 1.0:
        y = alpha * y
    if add is not None:
        y = y + beta * add.float()
    return y.to(x.dtype)


def banded_vn_reference(slabs, lo, x, g=None, mode: str = "single", *, scales=None,
                        scale: float = 1.0):
    """Plain version of the vn kernel: one application (``single``, times
    ``scale``), or two as the off-TPU branches of the JAX pair
    (``_cheb_pair_stream_primal`` :919, ``banded_cheb_pair`` :539-548) and
    chain (``_cheb_pair_stream_bwd`` :953-964) apply them, pass by pass as
    the kernel runs them (:func:`vn_pass_reference`): each sum and its
    epilogue in float32, each result rounded to x's type, T1 before the
    second application reads it (the module's notes)."""
    def one(v, add=None, alpha=1.0, beta=0.0):
        return vn_pass_reference(slabs, lo, v, add, alpha=alpha, beta=beta, scales=scales)

    if mode == "single":
        return one(x, alpha=scale)
    if mode == "pair":
        t1 = one(x)
        return t1, one(t1, x, 2.0, -1.0)
    if mode == "chain":
        u = one(x, g, 2.0, 1.0)
        return u, one(u, x, 1.0, -1.0)
    raise ValueError(f"unknown mode {mode!r}; expected one of {sorted(MODES)}")


def banded_spmm_reference(slabs, lo, x, *, scales=None, scale: float = 1.0):
    """Plain version of :func:`banded_spmm` (K7)."""
    return banded_vn_reference(slabs, lo, x, scales=scales, scale=scale)


# the C entry point's value types of the slabs
VALUE_TYPES = {torch.float32: 0, torch.int8: 1, torch.bfloat16: 2}
OPERAND_TYPES = (torch.float32, torch.bfloat16)


def _vn_call(slabs, lo, x, g, mode: str, scales, scale: float, name: str, index):
    """The vn kernel in ``mode`` (one C call: one pass, or two for pair and
    chain) over the pack's nonzero ``index`` (built from the slabs at the
    first launch), counted under ``name``; the plain version for a CPU
    tensor. A bf16 operand launches the bf16 variant; its outputs (and
    ``mid``) are bf16."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {sorted(MODES)}")
    if (g is not None) != (mode == "chain"):
        raise ValueError("g is given for mode 'chain' and only for it")
    if scale != 1.0 and mode != "single":
        raise ValueError("scale applies to mode 'single' only")
    if on_cpu(x):
        return banded_vn_reference(slabs, lo, x, g, mode, scales=scales, scale=scale)
    dev = cuda_device(x)
    nbr, bs, w = slabs.shape
    if x.dim() != 2:
        raise ValueError(f"the vn kernel takes an operand [rows, N]; got {tuple(x.shape)}")
    if x.dtype not in OPERAND_TYPES:
        raise TypeError(f"the vn kernel takes a float32 or bf16 operand, got {x.dtype}")
    int8 = slabs.dtype == torch.int8
    if slabs.device != dev or slabs.dtype not in VALUE_TYPES or (scales is not None) != int8 \
            or not slabs.is_contiguous():
        raise ValueError(f"the slabs are {slabs.dtype} on {slabs.device}; the vn kernel takes "
                         f"contiguous [nbr, bs, w] slabs on {dev}, float32 or bf16 without "
                         "scales or int8 with them")
    rows, n = x.shape
    x_p = require(x, "x", (rows, n), dev, x.dtype)
    g_p = require(g, "g", (rows, n), dev, x.dtype)
    scales_p = require(scales, "scales", (nbr, bs), dev)
    require_index(lo, "lo", (nbr,), dev)
    idx = nnz_index.current(index, slabs, lo, rows, transposed=False, name=name,
                            build=nnz_index.index_from_slabs)
    index_p = nnz_index.require(idx, rows, dev)
    out = torch.empty((rows, n), device=dev, dtype=x.dtype)
    mid = None if mode == "single" else torch.empty_like(out)
    err = _build.library().stgcn_banded_vn(
        slabs.data_ptr(), *index_p, scales_p, x_p, g_p, 0 if mid is None else mid.data_ptr(),
        out.data_ptr(), nbr, bs, w, rows, n, VALUE_TYPES[slabs.dtype],
        int(x.dtype == torch.bfloat16), MODES[mode], float(scale), stream_of(dev))
    _build.check(f"banded_vn[{mode}]", err)
    count_launch(name)
    return out if mid is None else (mid, out)


def _bf16(x) -> bool:
    return x.dtype == torch.bfloat16


def banded_spmm(slabs, lo, x, *, scales=None, scale: float = 1.0, index=None):
    """K7 (JAX ``banded_spmm`` :344, the TPU's K7a and K7b): ``scale · A x``
    on the vn operand. ``slabs`` [nbr, bs, w] float32 or bf16, or int8 with
    ``scales`` [nbr, bs]; ``lo`` [nbr] int32 on the operand's device;
    ``index`` the pack's :class:`~stgcn_tpu_torch.kernels.nnz_index.NnzIndex`
    (the graph operator's; needed on the card); ``x`` [v_pad, N] float32 or
    bf16, any N. Returns [v_pad, N] in x's type. ``scale`` (the Chebyshev
    2G step) is the kernel's alpha; the slabs are never multiplied."""
    return _vn_call(slabs, lo, x, None, "single", scales, scale,
                    launch_name("single", scales is not None, bf16=_bf16(x)), index)


def banded_cheb_pair(slabs, lo, x, *, index=None):
    """K8 (JAX ``banded_cheb_pair`` :519): ``(A x, 2 A (A x) − x)`` on a
    float32 or bf16 pack, each [v_pad, N] in x's type."""
    return _vn_call(slabs, lo, x, None, "pair", None, 1.0,
                    launch_name("pair", resident=True, bf16=_bf16(x)), index)


def banded_cheb_pair_stream(slabs, lo, x, *, scales=None, index=None):
    """K9's pair (JAX ``banded_cheb_pair_stream`` :875): ``(A x, 2 A (A x) −
    x)``, float32 or bf16 slabs or int8 with ``scales``, each [v_pad, N] in
    x's type."""
    return _vn_call(slabs, lo, x, None, "pair", scales, 1.0,
                    launch_name("pair", scales is not None, bf16=_bf16(x)), index)


def banded_chain_stream(slabs_t, lo_t, g2, g1, *, scales_t=None, index_t=None):
    """K9's chain (JAX ``banded_chain_stream`` :891) on the transpose pack
    and its index: ``(u = g1 + 2 Aᵀ g2, Aᵀ u − g2)``, each [v_pad, N] in
    g2's type (g1 the same). The row factors multiply each sum before the
    doubling and the ``+ g1`` (:715-718)."""
    return _vn_call(slabs_t, lo_t, g2, g1, "chain", scales_t, 1.0,
                    launch_name("chain", scales_t is not None, bf16=_bf16(g2)), index_t)


# --------------------------------------------------------------------------
# autograd Functions: the operator is fixed, the operand differentiable
# --------------------------------------------------------------------------

def _cotangents(g1, g2):
    ref = g1 if g1 is not None else g2
    return (torch.zeros_like(ref) if g1 is None else g1.contiguous(),
            torch.zeros_like(ref) if g2 is None else g2.contiguous())


class BandedSpmmVjp(torch.autograd.Function):
    """``y = scale·(A x)`` (K7); d/dx is K7 on the transpose pack."""

    @staticmethod
    def forward(ctx, x, slabs, lo, slabs_t, lo_t, scales, scales_t, scale, index, index_t):
        refuse_value_grad(slabs, slabs_t)
        ctx.pack_t, ctx.scale = (slabs_t, lo_t, scales_t, index_t), scale
        return banded_spmm(slabs, lo, x, scales=scales, scale=scale, index=index)

    @staticmethod
    def backward(ctx, g):
        slabs_t, lo_t, scales_t, index_t = ctx.pack_t
        dx = banded_spmm(slabs_t, lo_t, g.contiguous(), scales=scales_t, scale=ctx.scale,
                         index=index_t)
        return (dx,) + (None,) * 9


class BandedChebPairVjp(torch.autograd.Function):
    """``(A x, 2 A (A x) − x)`` (K8); backward as the JAX ``_cheb_pair_bwd``
    (:996): ``dT1 = g1 + 2 Aᵀ g2``, ``dx = Aᵀ dT1 − g2``, two K7
    applications on the transpose pack."""

    @staticmethod
    def forward(ctx, x, slabs, lo, slabs_t, lo_t, index, index_t):
        refuse_value_grad(slabs, slabs_t)
        ctx.pack_t = (slabs_t, lo_t, index_t)
        return banded_cheb_pair(slabs, lo, x, index=index)

    @staticmethod
    def backward(ctx, g1, g2):
        slabs_t, lo_t, index_t = ctx.pack_t
        g1, g2 = _cotangents(g1, g2)
        dt1 = g1 + banded_spmm(slabs_t, lo_t, g2, scale=2.0, index=index_t)
        return (banded_spmm(slabs_t, lo_t, dt1, index=index_t) - g2,) + (None,) * 6


class BandedChebPairStreamVjp(torch.autograd.Function):
    """``(A x, 2 A (A x) − x)`` (K9 pair); backward: K9's chain on the
    transpose pack, as on the TPU (:948-952)."""

    @staticmethod
    def forward(ctx, x, slabs, lo, slabs_t, lo_t, scales, scales_t, index, index_t):
        refuse_value_grad(slabs, slabs_t)
        ctx.pack_t = (slabs_t, lo_t, scales_t, index_t)
        return banded_cheb_pair_stream(slabs, lo, x, scales=scales, index=index)

    @staticmethod
    def backward(ctx, g1, g2):
        slabs_t, lo_t, scales_t, index_t = ctx.pack_t
        g1, g2 = _cotangents(g1, g2)
        _, dx = banded_chain_stream(slabs_t, lo_t, g2, g1, scales_t=scales_t, index_t=index_t)
        return (dx,) + (None,) * 8


def banded_spmm_vjp(slabs, lo, slabs_t, lo_t, x, scales=None, scales_t=None, *,
                    scale: float = 1.0, index=None, index_t=None):
    """Differentiable in ``x`` (JAX ``banded_spmm_vjp``); ``index`` and
    ``index_t`` are the packs' nonzero indexes (needed on the card)."""
    return BandedSpmmVjp.apply(x, slabs, lo, slabs_t, lo_t, scales, scales_t, scale, index,
                               index_t)


def banded_cheb_pair_vjp(slabs, lo, slabs_t, lo_t, x, *, index=None, index_t=None):
    """Differentiable in ``x`` (JAX ``banded_cheb_pair_vjp``)."""
    return BandedChebPairVjp.apply(x, slabs, lo, slabs_t, lo_t, index, index_t)


def banded_cheb_pair_stream_vjp(slabs, lo, slabs_t, lo_t, x, scales=None, scales_t=None, *,
                                index=None, index_t=None):
    """Differentiable in ``x`` (JAX ``banded_cheb_pair_stream_vjp``)."""
    return BandedChebPairStreamVjp.apply(x, slabs, lo, slabs_t, lo_t, scales, scales_t, index,
                                         index_t)
