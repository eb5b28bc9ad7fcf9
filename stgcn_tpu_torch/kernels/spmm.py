"""K10: BCSR SpMM on the vn operand ``[Vp, N]`` (port of
``stgcn_tpu/kernels/spmm.py``): float32 or bf16 tiles under a float32 or
bf16 operand.

The operator of ``--graph_op bcsr``, which ``make_graph_op(kind="auto")``
picks above 4096 vertices when the RCM band is too wide for the banded
slabs (the 1M-vertex road graph). The pack
(:func:`stgcn_tpu_torch.graph.packing.pack_bcsr_device`) keeps each block
row's live ``bs × bs`` tiles, row-major, and one application is

    y[i·bs:(i+1)·bs, :] = scale · Σ_{k < counts[i]} tiles[i,k] @ x[cols[i,k]·bs : +bs, :]

The TPU has two kernels for it, ``_spmm_pallas_resident`` (:123, x
resident in VMEM) and ``_spmm_pallas`` (:166, x streamed by DMA), and pads
N to a multiple of 512 and chunks the block rows by 1024 for its scalar
memory (:222-245). The CUDA kernel (``csrc/bcsr_spmm.cu``) is one kernel
for both, and it does not walk the tiles: a road graph fills a live tile to
under 1 %, so it walks the pack's nonzero index
(:mod:`stgcn_tpu_torch.kernels.nnz_index`, carried by the pack and rebuilt
from the tile values when they change), reading each value from the tiles
at its offset and gathering the x rows it needs; any N, any alignment, no
chunking. A scalar ``scale`` is the kernel's alpha, never multiplied into
the pack (the JAX op copies the pack per call,
``ops/graph_op.py:172-173``). A bf16 operand and bf16 tile values widen
exactly to float32 and each output is one float32 sum times the scale,
rounded once to the operand's type (the TPU kernel's ``acc.astype``,
:96, :118); it is counted under ``bcsr_spmm_bf16``.

:class:`BcsrSpmmVjp` is the autograd Function (JAX ``bcsr_spmm_vjp``
:248-279): forward K10 on the pack; ``dx`` K10 on the transpose pack; the
tile-value gradient K11 (:func:`stgcn_tpu_torch.kernels.sddmm.bcsr_sddmm`)
times the scale, computed (and ``x`` saved for it) only when the tile
values require grad; K11's bf16 variant is not ported yet, so a bf16
operand or pack whose tile values require grad raises. :func:`bcsr_spmm_reference`
is the plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stgcn_tpu_torch.kernels import _build, nnz_index
from stgcn_tpu_torch.kernels import sddmm as _sddmm
from stgcn_tpu_torch.kernels._launch import (count_launch, cuda_device, on_cpu, refuse_bf16,
                                             require, require_index, stream_of)

# elements of the plain version's largest temporary (one chunk of block rows)
REF_CHUNK_ELEMS = 1 << 26
LAUNCH_NAME = "bcsr_spmm"
LAUNCH_NAME_BF16 = "bcsr_spmm_bf16"   # a bf16 operand
FLOAT_TYPES = (torch.float32, torch.bfloat16)


class BcsrPack(NamedTuple):
    """One direction of a BCSR operator (the JAX ``BcsrGraphOp`` arrays).
    Edit learned tile values in place through ``data`` itself under
    ``torch.no_grad`` (the index follows its version counter), not through
    ``data.data``, or call ``index.invalidate()`` after."""

    data: torch.Tensor     # [nbr, max_b, bs, bs] float32 or bf16 row-major tiles
    cols: torch.Tensor     # [nbr, max_b] int32 column blocks (padding: 0)
    counts: torch.Tensor   # [nbr] int32 live tiles per block row
    index: nnz_index.NnzIndex | None = None   # the nonzeros K10 walks

    @property
    def block_size(self) -> int:
        return self.data.shape[-1]


def bcsr_spmm_reference(pack: BcsrPack, x_vn: torch.Tensor, *, scale: float = 1.0
                        ) -> torch.Tensor:
    """Plain version of :func:`bcsr_spmm`: the JAX ``bcsr_spmm_reference``
    (:38-48), gather x tiles per (row, slot) and contract in float32,
    chunked over block rows, the result times ``scale`` rounded to x's
    type. Padding tiles are all zero, so no count masking is needed."""
    nbr, max_b, bs, _ = pack.data.shape
    n = x_vn.shape[1]
    xb = x_vn.reshape(nbr, bs, n)
    rows = max(1, REF_CHUNK_ELEMS // (max_b * bs * max(n, bs)))
    ys = [torch.einsum("rkab,rkbn->ran", pack.data[s:s + rows].float(),
                       xb[pack.cols[s:s + rows].long()].float())
          for s in range(0, nbr, rows)]
    y = torch.cat(ys).reshape(nbr * bs, n)
    return (y if scale == 1.0 else scale * y).to(x_vn.dtype)


def bcsr_spmm(pack: BcsrPack, x_vn: torch.Tensor, *, scale: float = 1.0) -> torch.Tensor:
    """K10. ``pack`` (float32 or bf16 tiles, with its nonzero index) on the
    operand's device; ``x_vn`` ``[nbr·bs, N]`` float32 or bf16, any N, any
    alignment (16-byte loads, four float32 or eight bf16, where it is
    16-byte aligned and N is a multiple of the vector; scalar ones
    otherwise). Returns ``scale · (A x)``, ``[nbr·bs, N]`` in x's type,
    counted under ``bcsr_spmm`` or, for a bf16 operand, ``bcsr_spmm_bf16``."""
    if on_cpu(x_vn):
        return bcsr_spmm_reference(pack, x_vn, scale=scale)
    dev = cuda_device(x_vn)
    nbr, max_b, bs, _ = pack.data.shape
    if bs % 64 or x_vn.dim() != 2 or x_vn.shape[0] != nbr * bs:
        raise ValueError(f"K10 needs bs % 64 == 0 and an operand [nbr·bs = {nbr * bs}, N]; got "
                         f"bs={bs}, operand {tuple(x_vn.shape)}")
    data = pack.data
    if data.device != dev or data.dtype not in FLOAT_TYPES or not data.is_contiguous() \
            or data.shape[2:] != (bs, bs):
        raise ValueError(f"the tiles are {data.dtype} {tuple(data.shape)} on {data.device}; K10 "
                         f"takes contiguous float32 or bf16 [nbr, max_b, bs, bs] tiles on {dev}")
    if x_vn.dtype not in FLOAT_TYPES:
        raise TypeError(f"K10 takes a float32 or bf16 operand, got {x_vn.dtype}")
    require_index(pack.cols, "cols", (nbr, max_b), dev)
    require_index(pack.counts, "counts", (nbr,), dev)
    x_p = require(x_vn, "x_vn", tuple(x_vn.shape), dev, x_vn.dtype)
    idx = nnz_index.current(pack.index, data, pack.cols, pack.counts, transposed=False,
                            name="K10")
    index_p = nnz_index.require(idx, nbr * bs, dev)
    out = torch.empty(x_vn.shape, device=dev, dtype=x_vn.dtype)
    bf16 = x_vn.dtype == torch.bfloat16
    err = _build.library().stgcn_bcsr_spmm(data.data_ptr(), *index_p, x_p, out.data_ptr(), nbr,
                                           max_b, bs, x_vn.shape[1],
                                           int(data.dtype == torch.bfloat16), int(bf16),
                                           float(scale), stream_of(dev))
    _build.check("bcsr_spmm", err)
    count_launch(LAUNCH_NAME_BF16 if bf16 else LAUNCH_NAME)
    return out


class BcsrSpmmVjp(torch.autograd.Function):
    """``y = scale·(A x)`` on the vn operand, differentiable in ``x`` (K10 on
    the transpose pack) and in the tile values ``data`` (K11 at the pack's
    live tiles, times ``scale``); ``data`` is the pack's tile tensor, an
    input so that a caller can ask for its gradient."""

    @staticmethod
    def forward(ctx, x_vn, data, pack, pack_t, scale):
        ctx.pack, ctx.pack_t, ctx.scale = pack, pack_t, scale
        if ctx.needs_input_grad[1]:
            refuse_bf16("the BCSR tile-value gradient (K11)", x_vn, data)
            ctx.save_for_backward(x_vn)
        return bcsr_spmm(pack._replace(data=data), x_vn, scale=scale)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dx = bcsr_spmm(ctx.pack_t, g, scale=ctx.scale) if ctx.needs_input_grad[0] else None
        ddata = None
        if ctx.needs_input_grad[1]:
            (x_vn,) = ctx.saved_tensors
            ddata = _sddmm.bcsr_sddmm(ctx.pack.cols, ctx.pack.counts, g, x_vn,
                                      block_size=ctx.pack.block_size, scale=ctx.scale)
        return dx, ddata, None, None, None


def bcsr_spmm_vjp(pack: BcsrPack, pack_t: BcsrPack, x_vn: torch.Tensor, *,
                  scale: float = 1.0) -> torch.Tensor:
    """Differentiable K10 (JAX ``bcsr_spmm_vjp``): in ``x_vn``, and in
    ``pack.data`` when it requires grad."""
    return BcsrSpmmVjp.apply(x_vn, pack.data, pack, pack_t, scale)
