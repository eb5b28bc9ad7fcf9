"""K6: blocked-ELL SpMM on the nv operand ``[N, V]`` (port of
``stgcn_tpu/kernels/ell_nv.py``): a float32 operand over float32 or int8
tiles, a bf16 one over float32, int8 or bf16 tiles.

The O(nnz) operator of the 1M-vertex road graph: a contiguous-window pack
(K5's banded slabs) grows as ``V^1.5`` on a road graph, so the blocked-ELL
pack (:func:`stgcn_tpu_torch.graph.packing.pack_ell_device`) keeps only the
live ``bs × bs`` tiles, pre-transposed, and one application is

    y[:, i·bs:(i+1)·bs] = scales[i] ⊙ Σ_{k < counts[i]} x[:, cols[i,k]·bs : +bs] @ tiles[i,k]

with ``scales`` the per-output-lane dequant factors of an int8 pack (none
for f32). :func:`ell_nv` serves the modes of K5:

- ``single`` — ``A x`` (times ``scale``);
- ``pair``   — the ks=3 Chebyshev recurrence ``(t1 = A x, 2 A t1 − x)``
  (`model/layers.py:154-161`);
- ``chain``  — its VJP on the transpose pack, given ``(g2, g1)``:
  ``(u = g1 + 2 Aᵀ g2, Aᵀ u − g2)``.

The TPU kernel (``_ell_nv_pallas`` :123) streams x's column blocks by DMA
into a VMEM ring per block row; the pair is two kernel applications there
(``ell_cheb_pair_nv`` :274) with ``2y − x`` in XLA. The CUDA kernel
(``csrc/ell_nv.cu``) does not walk the tiles: a road graph fills a live
tile to under 1 %, so it walks the pack's nonzero index
(:mod:`stgcn_tpu_torch.kernels.nnz_index`, carried by the pack and rebuilt
from the tile values when they change), reading each value from the tiles
at its offset. It transposes x to ``[V, N]`` by hand into a workspace,
gathers the x rows each output row needs and writes the sums back in nv
through shared memory. The pair and chain are two gather passes launched
by one C entry point (the first also keeping its result in vn for the
second, the second folding ``2y − x`` into its epilogue), counted as one
launch of the wrapper's mode and dtypes (``ell_f32_pair``,
``ell_int8_chain``; on a bf16 operand ``ell_{f32,int8,bf16}_{mode}_bf16``,
the tiles' type first).

bf16: each application sums in float32 (a bf16 operand and bf16 or int8
tile values widen exactly) and is written in x's type, as the JAX ELL path
writes it (:116-118); the pair and chain then combine the rounded products
in float32 and round again (``ell_cheb_pair_nv`` :274-285: t1 = bf16(A x),
t2 = bf16(2·bf16(A t1) − x); ``_pair_bwd`` :302-313: u = bf16(g1 +
2·bf16(Aᵀ g2)), dx = bf16(bf16(Aᵀ u) − g2)). So where an add follows, the
kernel rounds the product first (``csrc/nv_rows.cuh``'s ``ROUND``); single
mode rounds once. K5 rounds once a pass, as its TPU kernel does: the two
bf16 variants differ there.

The operand is exactly ``nbr·bs`` wide (the operator pads to it); output
lanes of rows past ``n_vertex`` are zero. :class:`EllSpmmNv` and
:class:`EllChebPairNv` are the autograd Functions (JAX ``ell_spmm_nv_vjp``
:237, ``ell_cheb_pair_nv`` :274): their backward runs ``single`` and
``chain`` on the transpose pack. The tile-value gradient (``_ell_nv_ddata``,
a scan SDDMM on the TPU, not a Pallas kernel) is not ported: the trainer
never differentiates the operator, and the Functions return no gradient
for it. :func:`ell_nv_reference` is the plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stgcn_tpu_torch.kernels import _build, nnz_index
from stgcn_tpu_torch.kernels._launch import (count_launch, cuda_device, on_cpu,
                                             refuse_value_grad, require, require_index,
                                             stream_of, workspace)
from stgcn_tpu_torch.kernels.banded_nv import pair_cotangents
from stgcn_tpu_torch.kernels.banded_spmm import VALUE_TYPES

MODES = {"single": 0, "pair": 1, "chain": 2}
# elements of the plain version's largest temporary (one chunk of block rows)
REF_CHUNK_ELEMS = 1 << 26


class EllPack(NamedTuple):
    """One direction of a blocked-ELL operator (the JAX pack's arrays)."""

    data: torch.Tensor                # [nbr, max_b, bs, bs] float32, bf16 or int8, transposed
    cols: torch.Tensor                # [nbr, max_b] int32 column blocks (padding: 0)
    counts: torch.Tensor              # [nbr] int32 live tiles per block row
    scales: torch.Tensor | None = None  # [nbr, bs] float32 per output lane (int8 packs)
    index: nnz_index.NnzIndex | None = None   # the nonzeros K6 walks

    @property
    def quantized(self) -> bool:
        return self.scales is not None


TILE_KINDS = {torch.float32: "f32", torch.int8: "int8", torch.bfloat16: "bf16"}


def launch_name(quantized: bool, mode: str, *, bf16: bool = False,
                bf16_tiles: bool = False) -> str:
    """The launch counter of K6 in ``mode`` on an int8, float32 or bf16
    pack, with a ``_bf16`` suffix on a bf16 operand."""
    tiles = "int8" if quantized else "bf16" if bf16_tiles else "f32"
    return f"ell_{tiles}_{mode}{'_bf16' if bf16 else ''}"


def pack_launch_name(pack: EllPack, mode: str, x: torch.Tensor) -> str:
    """:func:`launch_name` of ``pack`` under the operand ``x``."""
    return launch_name(pack.quantized, mode, bf16=x.dtype == torch.bfloat16,
                       bf16_tiles=pack.data.dtype == torch.bfloat16)


def _apply_reference(pack: EllPack, x_nv: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """One application ``scale · (A x)`` in float32 (the operand and the
    tiles widen exactly), ``[n, nbr·bs]``, chunked over block rows so the
    gathered x windows (``[n, rows, max_b, bs]``) stay small. Padding tiles
    are all zero, so no count masking is needed (the JAX ``ell_nv_reference``
    :47)."""
    nbr, max_b, bs, _ = pack.data.shape
    n = x_nv.shape[0]
    xb = x_nv.float().reshape(n, nbr, bs)
    rows = max(1, REF_CHUNK_ELEMS // (max_b * bs * max(n, bs)))
    ys = []
    for s in range(0, nbr, rows):
        win = xb[:, pack.cols[s:s + rows].long()]            # [n, rows, max_b, bs]
        ys.append(torch.einsum("nrkj,rkjb->nrb", win, pack.data[s:s + rows].float()))
    y = torch.cat(ys, dim=1)                                   # [n, nbr, bs]
    if pack.scales is not None:   # the dequant factors per output lane, scale folded in
        y = y * (pack.scales if scale == 1.0 else pack.scales * scale)
    elif scale != 1.0:
        y = scale * y
    return y.reshape(n, nbr * bs)


def ell_pass_reference(pack: EllPack, x_nv, add=None, *, alpha: float = 1.0,
                       beta: float = 0.0) -> torch.Tensor:
    """Plain version of one pass of K6: ``alpha · (A x) + beta · add`` in
    float32, rounded to x's type; on a bf16 operand the product ``A x`` is
    rounded to bf16 first where an add follows (the module's notes)."""
    y = _apply_reference(pack, x_nv)
    if add is not None and x_nv.dtype != torch.float32:
        y = y.to(x_nv.dtype).float()
    if alpha != 1.0:
        y = alpha * y
    if add is not None:
        y = y + beta * add.float()
    return y.to(x_nv.dtype)


def ell_nv_reference(pack: EllPack, x_nv, g_nv=None, mode: str = "single", *,
                     scale: float = 1.0):
    """Plain version of :func:`ell_nv`: one application, or two (pass by
    pass, :func:`ell_pass_reference`) as the JAX ``ell_spmm_nv_vjp`` /
    ``ell_cheb_pair_nv`` apply them."""
    if mode == "single":
        return _apply_reference(pack, x_nv, scale).to(x_nv.dtype)
    if mode == "pair":
        t1 = ell_pass_reference(pack, x_nv)
        return t1, ell_pass_reference(pack, t1, x_nv, alpha=2.0, beta=-1.0)
    if mode == "chain":
        u = ell_pass_reference(pack, x_nv, g_nv, alpha=2.0, beta=1.0)
        return u, ell_pass_reference(pack, u, x_nv, beta=-1.0)
    raise ValueError(f"unknown mode {mode!r}; expected one of {sorted(MODES)}")


def ell_nv(pack: EllPack, x_nv, g_nv=None, mode: str = "single", *, scale: float = 1.0):
    """K6. ``pack`` (with its nonzero index) on the operand's device;
    ``x_nv`` [N, nbr·bs] float32 or bf16, 16-byte aligned; ``g_nv`` [N,
    nbr·bs] in x's type, only for ``chain``. Returns ``y`` (single) or
    ``(t1, t2)`` / ``(u, dx)``, each [N, nbr·bs] in x's type: a bf16 operand
    launches the bf16 variant (over float32, int8 or bf16 tiles; bf16 tiles
    only under a bf16 operand). ``scale`` multiplies the single application
    (the Chebyshev ``2G`` step; for an int8 pack it joins the dequant
    factors, the tiles are never multiplied)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {sorted(MODES)}")
    if (g_nv is not None) != (mode == "chain"):
        raise ValueError("g_nv is given for mode 'chain' and only for it")
    if scale != 1.0 and mode != "single":
        raise ValueError("scale applies to mode 'single' only")
    if on_cpu(x_nv):
        return ell_nv_reference(pack, x_nv, g_nv, mode, scale=scale)
    dev = cuda_device(x_nv)
    nbr, max_b, bs, _ = pack.data.shape
    n, vp = x_nv.shape
    if bs % 64 or vp != nbr * bs:
        raise ValueError(f"K6 needs bs % 64 == 0 and an operand nbr·bs = {nbr * bs} wide; got "
                         f"bs={bs}, width {vp}")
    bf16 = x_nv.dtype == torch.bfloat16
    if x_nv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K6 takes a float32 or bf16 operand, got {x_nv.dtype}")
    want = (torch.int8,) if pack.quantized else \
        (torch.float32, torch.bfloat16) if bf16 else (torch.float32,)
    if pack.data.device != dev or pack.data.dtype not in want or \
            not pack.data.is_contiguous() or pack.data.shape[3] != bs:
        raise ValueError(f"the tiles are {pack.data.dtype} on {pack.data.device}; K6 takes "
                         f"contiguous [nbr, max_b, bs, bs] tiles on {dev}, float32 (or bf16 "
                         "under a bf16 operand) without scales or int8 with them")
    require_index(pack.cols, "cols", (nbr, max_b), dev)
    require_index(pack.counts, "counts", (nbr,), dev)
    scales_p = require(pack.scales, "scales", (nbr, bs), dev)
    x_p = require(x_nv, "x_nv", (n, vp), dev, x_nv.dtype)
    g_p = require(g_nv, "g_nv", (n, vp), dev, x_nv.dtype)
    if x_p % 16:
        raise ValueError("x_nv must start on a 16-byte boundary (the kernel reads it in "
                         "16-byte vectors)")
    idx = nnz_index.current(pack.index, pack.data, pack.cols, pack.counts, transposed=True,
                            name="K6")
    index_p = nnz_index.require(idx, vp, dev)
    out = torch.empty((n, vp), device=dev, dtype=x_nv.dtype)
    mid = None if mode == "single" else torch.empty_like(out)
    # x in vn, and for pair and chain the first pass's result in vn too, in x's type
    work = workspace(n * vp * (1 if mode == "single" else 2), dev, x_nv.dtype)
    err = _build.library().stgcn_ell_nv(
        pack.data.data_ptr(), *index_p, scales_p, x_p, g_p,
        0 if mid is None else mid.data_ptr(), out.data_ptr(), work.data_ptr(), nbr, max_b, bs,
        n, VALUE_TYPES[pack.data.dtype], int(bf16), MODES[mode], float(scale), stream_of(dev))
    _build.check(f"ell_nv[{mode}]", err)
    count_launch(pack_launch_name(pack, mode, x_nv))
    return out if mid is None else (mid, out)


# --------------------------------------------------------------------------
# autograd Functions: the operator is fixed, the operand differentiable
# --------------------------------------------------------------------------

class EllSpmmNv(torch.autograd.Function):
    """``y = scale·(A x)`` on the nv operand; d/dx applies the transpose pack."""

    @staticmethod
    def forward(ctx, x_nv, pack, pack_t, scale):
        refuse_value_grad(pack.data, pack_t.data)
        ctx.pack_t, ctx.scale, ctx.dtype = pack_t, scale, x_nv.dtype
        return ell_nv(pack, x_nv, scale=scale)

    @staticmethod
    def backward(ctx, g):
        return (ell_nv(ctx.pack_t, g.to(ctx.dtype).contiguous(), scale=ctx.scale), None, None,
                None)


class EllChebPairNv(torch.autograd.Function):
    """``(A x, 2 A (A x) − x)``; backward: the chain on the transpose pack."""

    @staticmethod
    def forward(ctx, x_nv, pack, pack_t):
        refuse_value_grad(pack.data, pack_t.data)
        ctx.pack_t, ctx.dtype = pack_t, x_nv.dtype
        return ell_nv(pack, x_nv, mode="pair")

    @staticmethod
    def backward(ctx, g1, g2):
        g1, g2 = pair_cotangents(g1, g2, ctx.dtype)
        _, dx = ell_nv(ctx.pack_t, g2, g1, mode="chain")
        return dx, None, None


def ell_spmm_nv(pack: EllPack, pack_t: EllPack, x_nv, *, scale: float = 1.0):
    """Differentiable in ``x_nv`` (JAX ``ell_spmm_nv_vjp``)."""
    return EllSpmmNv.apply(x_nv, pack, pack_t, scale)


def ell_cheb_pair_nv(pack: EllPack, pack_t: EllPack, x_nv):
    """Differentiable in ``x_nv`` (JAX ``ell_cheb_pair_nv``)."""
    return EllChebPairNv.apply(x_nv, pack, pack_t)
