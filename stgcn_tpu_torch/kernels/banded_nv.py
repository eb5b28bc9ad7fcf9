"""K5: banded SpMM on the nv operand ``[N, V]`` (port of
``stgcn_tpu/kernels/banded_nv.py``): a float32 operand over float32 or int8
slabs, a bf16 one over float32, bf16 or int8 slabs.

The vertex-fused ST block moves activations channel-before-vertex
``[B, T, C, Vp]``, whose row-major flattening is ``[N = B·T·C, Vp]``: the
graph product runs on that view with no transpose. With the slabs packed
pre-transposed ``[nbr, w, bs]`` (:func:`stgcn_tpu_torch.kernels.banded_spmm.
pack_banded_device(transpose_slabs=True)``) one application is

    y[:, i·bs:(i+1)·bs] = scales[i] ⊙ (x[:, lo_i : lo_i + w] @ slab_i)

with ``scales`` the per-A-row dequant factors of an int8 pack (``banded_int8``),
applied per output lane to the float32 sum (none for f32), and :func:`stream_nv` serves three modes:

- ``single`` — ``A x`` (times ``scale``);
- ``pair``   — the ks=3 Chebyshev recurrence ``(t1 = A x, 2 A t1 − x)``
  (`model/layers.py:154-161`);
- ``chain``  — its VJP on the transpose pack, given ``(g2, g1)``:
  ``(u = g1 + 2 Aᵀ g2, Aᵀ u − g2)``.

The TPU kernel (``_stream_nv_call`` :208) runs stage 2 of block ``i`` from
a ring of stage-1 blocks that earlier grid steps filled (a wavefront). A
CUDA grid runs in no order, so on Hopper ``pair`` and ``chain`` are two
passes over the whole operand: pass 1 writes t1 (or u) to device memory,
pass 2 reads it (``csrc/banded_nv.cu``). Both passes are launched by one C
entry point, counted as one launch of the wrapper's mode (``nv_pair``,
``nv_chain_int8``, and ``nv_pair_bf16``, ``nv_chain_int8_bf16``, … on a
bf16 operand). The kernel does not walk the band, which a road
graph fills to 0.57 %: it walks the pack's nonzero index
(:func:`stgcn_tpu_torch.kernels.nnz_index.index_from_slabs`, carried by the
graph operator and built from the slabs at the first launch) with K6's
transposing walk (``csrc/nv_rows.cuh``): x transposed by hand into a
workspace of ``N·v_pad`` floats (twice that for pair and chain, which keep
the first pass's result in vn too), then a warp per output lane gathering
the x rows of its nonzeros. Each wrapper takes the pack's index as
``index``; on the card it is needed.

Padding, as on the TPU: N is free; a window reads x (and t1, u) as zero
past ``v_pad`` (the TPU pads to ``x_cols = round_up(max(v_pad, nbr·bs),
bs)`` with zeros); the outputs are ``v_pad`` wide, zero past ``nbr·bs`` for
``single`` and t1, and there ``t2 = −x``, ``u = g1``, ``dx = −g2`` — the
values of the off-TPU branch (:239-255), which is this module's plain
version (:func:`stream_nv_reference`).

bf16 (the TPU kernel's bf16 operand into an f32 accumulator, :141-183):
each pass sums in float32 (a bf16 operand and bf16 or int8 slab values
widen exactly), applies its epilogue in float32 and rounds once to bf16.
Stage 1 takes the lane factor and, for chain, ``2·acc + g`` before its one
rounding (``t1c``, :157-160); that bf16 t1 (or u) is the output and the
operand of stage 2, which doubles (pair), takes the factor and subtracts x
in float32 before its one rounding (:179-183). The plain version keeps
these points, pass by pass (:func:`nv_pass_reference`). The JAX off-TPU
branch rounds ``A·t1`` to bf16 before ``2·that − x`` and subtracts in bf16,
so the two may differ by an ulp of bf16 there (the same divergence as the
vn kernel's, :mod:`.banded_spmm`).

:class:`BandedSpmmNv` and :class:`ChebPairNv` are the autograd Functions
(JAX ``banded_spmm_nv`` :356, ``cheb_pair_nv`` :388): their backward runs
``single`` and ``chain`` on the transpose pack. The slab-value gradient
(``_nv_dslabs``, a scan SDDMM on the TPU) is not ported: the trainer never
differentiates the operator, and the Functions return no gradient for it.
"""

from __future__ import annotations

import torch

from stgcn_tpu_torch.kernels import _build, nnz_index
from stgcn_tpu_torch.kernels._launch import (count_launch, cuda_device, on_cpu,
                                             refuse_value_grad, require, require_index,
                                             stream_of, workspace)
from stgcn_tpu_torch.kernels.banded_spmm import VALUE_TYPES, _round_up

MODES = {"single": 0, "pair": 1, "chain": 2}


def launch_name(mode: str, quantized: bool = False, bf16: bool = False) -> str:
    """The launch counter of K5 in ``mode`` on a float32 (or bf16) or int8
    pack, with a ``_bf16`` suffix on a bf16 operand."""
    return f"nv_{mode}{'_int8' if quantized else ''}{'_bf16' if bf16 else ''}"


def _nv_ref(slabs_nv: torch.Tensor, lo: list[int], x_nv: torch.Tensor,
            scales: torch.Tensor | None) -> torch.Tensor:
    """One application in float32: ``y[:, block i] = scales[i] ⊙ (x[:,
    window_i] @ slab_i)``, ``[n, nbr·bs]`` (the operand and the slabs widen
    exactly)."""
    w = slabs_nv.shape[1]
    x_nv = x_nv.float()
    ys = [x_nv[:, l:l + w] @ slabs_nv[i].float() for i, l in enumerate(lo)]
    if scales is not None:
        ys = [y * scales[i] for i, y in enumerate(ys)]
    return torch.cat(ys, dim=1)


def nv_pass_reference(slabs_nv, lo, x_nv, add=None, *, alpha: float = 1.0, beta: float = 0.0,
                      scales=None) -> torch.Tensor:
    """Plain version of one pass of K5: ``alpha · (A x) + beta · add`` in
    float32 (the lane factors on the sum), rounded once to x's type; ``[N,
    v_pad]``. A window reads x as zero past ``v_pad`` (the TPU pads x to
    ``x_cols = round_up(max(v_pad, nbr·bs), bs)``); lanes past ``nbr·bs``
    hold no slab."""
    nbr, _, bs = slabs_nv.shape
    v_pad = x_nv.shape[1]
    x_cols = _round_up(max(v_pad, nbr * bs), bs)
    lo = [int(v) for v in lo.tolist()]
    v = x_nv if v_pad >= x_cols else torch.nn.functional.pad(x_nv, (0, x_cols - v_pad))
    y = _nv_ref(slabs_nv, lo, v, scales)
    y = torch.nn.functional.pad(y, (0, v_pad - y.shape[1])) if y.shape[1] < v_pad \
        else y[:, :v_pad]
    if alpha != 1.0:
        y = alpha * y
    if add is not None:
        y = y + beta * add.float()
    return y.to(x_nv.dtype)


def stream_nv_reference(slabs_nv, lo, x_nv, g_nv=None, mode: str = "single", *,
                        scales=None, scale: float = 1.0):
    """Plain version of :func:`stream_nv`: :func:`nv_pass_reference` once
    or twice, as the off-TPU branch of ``_stream_nv_call`` (:239-255)
    applies it, each pass rounded to x's type where the TPU kernel rounds
    (the module's notes)."""
    def one(v, add=None, alpha=1.0, beta=0.0):
        return nv_pass_reference(slabs_nv, lo, v, add, alpha=alpha, beta=beta, scales=scales)

    if mode == "single":
        return one(x_nv, alpha=scale)
    if mode == "pair":
        t1 = one(x_nv)
        return t1, one(t1, x_nv, 2.0, -1.0)
    if mode == "chain":
        u = one(x_nv, g_nv, 2.0, 1.0)
        return u, one(u, x_nv, 1.0, -1.0)
    raise ValueError(f"unknown mode {mode!r}; expected one of {sorted(MODES)}")


def stream_nv(slabs_nv, lo, x_nv, g_nv=None, mode: str = "single", *, scales=None,
              scale: float = 1.0, index=None):
    """K5. ``slabs_nv`` [nbr, w, bs] float32 (or bf16 under a bf16 operand),
    or int8 with ``scales`` [nbr, bs]; ``lo`` [nbr] int32 window starts,
    ``index`` the pack's :class:`~stgcn_tpu_torch.kernels.nnz_index.NnzIndex`
    (the graph operator's; needed on the card); ``x_nv`` [N, v_pad] float32
    or bf16; ``g_nv`` [N, v_pad] in x's type, only for ``chain``. Returns
    ``y`` (single) or ``(t1, t2)`` / ``(u, dx)``, each [N, v_pad] in x's
    type: a bf16 operand launches the bf16 variant. ``scale`` multiplies the
    single application (the Chebyshev ``2G`` step): the kernel's alpha,
    never multiplied into the pack or its scales."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {sorted(MODES)}")
    if (g_nv is not None) != (mode == "chain"):
        raise ValueError("g_nv is given for mode 'chain' and only for it")
    if scale != 1.0 and mode != "single":
        raise ValueError("scale applies to mode 'single' only")
    if on_cpu(x_nv):
        return stream_nv_reference(slabs_nv, lo, x_nv, g_nv, mode, scales=scales, scale=scale)
    dev = cuda_device(x_nv)
    nbr, w, bs = slabs_nv.shape
    n, v_pad = x_nv.shape
    if v_pad % bs or v_pad % 32:
        raise ValueError(f"K5 needs v_pad % bs == 0 and v_pad % 32 == 0; got bs={bs}, "
                         f"v_pad={v_pad}")
    bf16 = x_nv.dtype == torch.bfloat16
    if x_nv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K5 takes a float32 or bf16 operand, got {x_nv.dtype}")
    want = (torch.int8,) if scales is not None else \
        (torch.float32, torch.bfloat16) if bf16 else (torch.float32,)
    if slabs_nv.device != dev or slabs_nv.dtype not in want or not slabs_nv.is_contiguous():
        raise ValueError(f"the slabs are {slabs_nv.dtype} on {slabs_nv.device}; K5 takes "
                         f"contiguous [nbr, w, bs] slabs on {dev}, float32 (or bf16 under a "
                         "bf16 operand) without scales or int8 with them")
    scales_p = require(scales, "scales", (nbr, bs), dev)
    x_p = require(x_nv, "x_nv", (n, v_pad), dev, x_nv.dtype)
    g_p = require(g_nv, "g_nv", (n, v_pad), dev, x_nv.dtype)
    if x_p % 16:
        raise ValueError("x_nv must start on a 16-byte boundary (the kernel reads 16-byte "
                         "vectors)")
    require_index(lo, "lo", (nbr,), dev)
    name = launch_name(mode, scales is not None, bf16)
    idx = nnz_index.current(index, slabs_nv, lo, v_pad, transposed=True, name=name,
                            build=nnz_index.index_from_slabs)
    index_p = nnz_index.require(idx, v_pad, dev)
    out = torch.empty((n, v_pad), device=dev, dtype=x_nv.dtype)
    mid = None if mode == "single" else torch.empty_like(out)
    # x in vn, and for pair and chain the first pass's result in vn too, in x's type
    work = workspace(n * v_pad * (1 if mode == "single" else 2), dev, x_nv.dtype)
    err = _build.library().stgcn_banded_nv(
        slabs_nv.data_ptr(), *index_p, scales_p, x_p, g_p, 0 if mid is None else mid.data_ptr(),
        out.data_ptr(), work.data_ptr(), nbr, w, bs, n, v_pad, VALUE_TYPES[slabs_nv.dtype],
        int(bf16), MODES[mode], float(scale), stream_of(dev))
    _build.check(f"stream_nv[{mode}]", err)
    count_launch(name)
    return out if mid is None else (mid, out)


# --------------------------------------------------------------------------
# autograd Functions: the operator is fixed, the operand differentiable
# --------------------------------------------------------------------------

def pair_cotangents(g1, g2, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The pair's cotangents for the chain, contiguous in the operand's type
    (zeros for one autograd did not give)."""
    ref = g1 if g1 is not None else g2
    return tuple(torch.zeros_like(ref, dtype=dtype) if g is None else g.to(dtype).contiguous()
                 for g in (g1, g2))


class BandedSpmmNv(torch.autograd.Function):
    """``y = scale·(A x)`` on the nv operand; d/dx applies the transpose pack."""

    @staticmethod
    def forward(ctx, x_nv, slabs_nv, lo, slabs_nv_t, lo_t, scales, scales_t, scale, index,
                index_t):
        refuse_value_grad(slabs_nv, slabs_nv_t)
        ctx.pack_t, ctx.scale, ctx.dtype = (slabs_nv_t, lo_t, scales_t, index_t), scale, x_nv.dtype
        return stream_nv(slabs_nv, lo, x_nv, scales=scales, scale=scale, index=index)

    @staticmethod
    def backward(ctx, g):
        slabs_t, lo_t, scales_t, index_t = ctx.pack_t
        dx = stream_nv(slabs_t, lo_t, g.to(ctx.dtype).contiguous(), scales=scales_t,
                       scale=ctx.scale, index=index_t)
        return (dx,) + (None,) * 9


class ChebPairNv(torch.autograd.Function):
    """``(A x, 2 A (A x) − x)``; backward: the chain on the transpose pack."""

    @staticmethod
    def forward(ctx, x_nv, slabs_nv, lo, slabs_nv_t, lo_t, scales, scales_t, index, index_t):
        refuse_value_grad(slabs_nv, slabs_nv_t)
        ctx.pack_t, ctx.dtype = (slabs_nv_t, lo_t, scales_t, index_t), x_nv.dtype
        return stream_nv(slabs_nv, lo, x_nv, mode="pair", scales=scales, index=index)

    @staticmethod
    def backward(ctx, g1, g2):
        slabs_t, lo_t, scales_t, index_t = ctx.pack_t
        g1, g2 = pair_cotangents(g1, g2, ctx.dtype)
        _, dx = stream_nv(slabs_t, lo_t, g2, g1, mode="chain", scales=scales_t, index=index_t)
        return (dx,) + (None,) * 8


def banded_spmm_nv(slabs_nv, lo, slabs_nv_t, lo_t, x_nv, scales=None, scales_t=None, *,
                   scale: float = 1.0, index=None, index_t=None):
    """Differentiable in ``x_nv`` (JAX ``banded_spmm_nv``); ``index`` and
    ``index_t`` are the packs' nonzero indexes (needed on the card)."""
    return BandedSpmmNv.apply(x_nv, slabs_nv, lo, slabs_nv_t, lo_t, scales, scales_t, scale,
                              index, index_t)


def cheb_pair_nv(slabs_nv, lo, slabs_nv_t, lo_t, x_nv, scales=None, scales_t=None, *,
                 index=None, index_t=None):
    """Differentiable in ``x_nv`` (JAX ``cheb_pair_nv``)."""
    return ChebPairNv.apply(x_nv, slabs_nv, lo, slabs_nv_t, lo_t, scales, scales_t, index,
                            index_t)
