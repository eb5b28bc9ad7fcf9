"""K5: banded SpMM on the nv operand ``[N, V]`` (port of
``stgcn_tpu/kernels/banded_nv.py``, float32 and int8 slabs).

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
``nv_chain_int8``, …). The kernel does not walk the band, which a road
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

:class:`BandedSpmmNv` and :class:`ChebPairNv` are the autograd Functions
(JAX ``banded_spmm_nv`` :356, ``cheb_pair_nv`` :388): their backward runs
``single`` and ``chain`` on the transpose pack. The slab-value gradient
(``_nv_dslabs``, a scan SDDMM on the TPU) is not ported: the trainer never
differentiates the operator, and the Functions return no gradient for it.
"""

from __future__ import annotations

import torch

from stgcn_tpu_torch.kernels import _build, nnz_index
from stgcn_tpu_torch.kernels._launch import (count_launch, cuda_device, on_cpu, refuse_bf16,
                                             refuse_value_grad, require, require_index,
                                             stream_of, workspace)
from stgcn_tpu_torch.kernels.banded_spmm import _round_up

MODES = {"single": 0, "pair": 1, "chain": 2}


def launch_name(mode: str, quantized: bool = False) -> str:
    """The launch counter of K5 in ``mode`` on a float32 or int8 pack."""
    return f"nv_{mode}{'_int8' if quantized else ''}"


def _nv_ref(slabs_nv: torch.Tensor, lo: list[int], x_nv: torch.Tensor,
            scales: torch.Tensor | None) -> torch.Tensor:
    """One application: ``y[:, block i] = scales[i] ⊙ (x[:, window_i] @
    slab_i)``, ``[n, nbr·bs]``."""
    w = slabs_nv.shape[1]
    ys = [x_nv[:, l:l + w] @ slabs_nv[i].float() for i, l in enumerate(lo)]
    if scales is not None:
        ys = [y * scales[i] for i, y in enumerate(ys)]
    return torch.cat(ys, dim=1)


def stream_nv_reference(slabs_nv, lo, x_nv, g_nv=None, mode: str = "single", *,
                        scales=None, scale: float = 1.0):
    """Plain version of :func:`stream_nv`: :func:`_nv_ref` once or twice, as
    the off-TPU branch of ``_stream_nv_call`` (:239-255) applies it."""
    nbr, _, bs = slabs_nv.shape
    v_pad = x_nv.shape[1]
    x_cols = _round_up(max(v_pad, nbr * bs), bs)
    lo = [int(v) for v in lo.tolist()]

    def one(v):  # windows read up to x_cols columns; re-pad between applications
        if v.shape[1] < x_cols:
            v = torch.nn.functional.pad(v, (0, x_cols - v.shape[1]))
        y = _nv_ref(slabs_nv, lo, v, scales)
        return torch.nn.functional.pad(y, (0, v_pad - y.shape[1])) \
            if y.shape[1] < v_pad else y[:, :v_pad]

    if mode == "single":
        y = one(x_nv)
        return y if scale == 1.0 else scale * y
    if mode == "pair":
        t1 = one(x_nv)
        return t1, 2.0 * one(t1) - x_nv
    if mode == "chain":
        u = g_nv + 2.0 * one(x_nv)
        return u, one(u) - x_nv
    raise ValueError(f"unknown mode {mode!r}; expected one of {sorted(MODES)}")


def stream_nv(slabs_nv, lo, x_nv, g_nv=None, mode: str = "single", *, scales=None,
              scale: float = 1.0, index=None):
    """K5. ``slabs_nv`` [nbr, w, bs] float32, or int8 with ``scales`` [nbr,
    bs]; ``lo`` [nbr] int32 window starts, ``index`` the pack's
    :class:`~stgcn_tpu_torch.kernels.nnz_index.NnzIndex` (the graph
    operator's; needed on the card); ``x_nv`` [N, v_pad]; ``g_nv`` [N,
    v_pad] only for ``chain``. Returns ``y`` (single) or ``(t1, t2)`` /
    ``(u, dx)``, each [N, v_pad]. ``scale`` multiplies the single
    application (the Chebyshev ``2G`` step): the kernel's alpha, never
    multiplied into the pack or its scales."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {sorted(MODES)}")
    if (g_nv is not None) != (mode == "chain"):
        raise ValueError("g_nv is given for mode 'chain' and only for it")
    if scale != 1.0 and mode != "single":
        raise ValueError("scale applies to mode 'single' only")
    refuse_bf16("K5 (the banded nv kernel)", slabs_nv, x_nv, g_nv)
    if on_cpu(x_nv):
        return stream_nv_reference(slabs_nv, lo, x_nv, g_nv, mode, scales=scales, scale=scale)
    dev = cuda_device(x_nv)
    nbr, w, bs = slabs_nv.shape
    n, v_pad = x_nv.shape
    if v_pad % bs or v_pad % 32:
        raise ValueError(f"K5 needs v_pad % bs == 0 and v_pad % 32 == 0; got bs={bs}, "
                         f"v_pad={v_pad}")
    want = torch.int8 if scales is not None else torch.float32
    if slabs_nv.device != dev or slabs_nv.dtype != want or not slabs_nv.is_contiguous():
        raise ValueError(f"the slabs are {slabs_nv.dtype} on {slabs_nv.device}; K5 takes "
                         f"contiguous [nbr, w, bs] slabs on {dev}, float32 without scales or "
                         "int8 with them")
    scales_p = require(scales, "scales", (nbr, bs), dev)
    x_p = require(x_nv, "x_nv", (n, v_pad), dev)
    g_p = require(g_nv, "g_nv", (n, v_pad), dev)
    if x_p % 16:
        raise ValueError("x_nv must start on a 16-byte boundary (the kernel reads float4)")
    require_index(lo, "lo", (nbr,), dev)
    name = launch_name(mode, scales is not None)
    idx = nnz_index.current(index, slabs_nv, lo, v_pad, transposed=True, name=name,
                            build=nnz_index.index_from_slabs)
    index_p = nnz_index.require(idx, v_pad, dev)
    out = torch.empty((n, v_pad), device=dev, dtype=torch.float32)
    mid = None if mode == "single" else torch.empty_like(out)
    # x in vn, and for pair and chain the first pass's result in vn too
    work = workspace(n * v_pad * (1 if mode == "single" else 2), dev)
    err = _build.library().stgcn_banded_nv(
        slabs_nv.data_ptr(), *index_p, scales_p, x_p, g_p, 0 if mid is None else mid.data_ptr(),
        out.data_ptr(), work.data_ptr(), nbr, w, bs, n, v_pad, int(scales is not None),
        MODES[mode], float(scale), stream_of(dev))
    _build.check(f"stream_nv[{mode}]", err)
    count_launch(name)
    return out if mid is None else (mid, out)


# --------------------------------------------------------------------------
# autograd Functions: the operator is fixed, the operand differentiable
# --------------------------------------------------------------------------

class BandedSpmmNv(torch.autograd.Function):
    """``y = scale·(A x)`` on the nv operand; d/dx applies the transpose pack."""

    @staticmethod
    def forward(ctx, x_nv, slabs_nv, lo, slabs_nv_t, lo_t, scales, scales_t, scale, index,
                index_t):
        refuse_value_grad(slabs_nv, slabs_nv_t)
        ctx.pack_t, ctx.scale = (slabs_nv_t, lo_t, scales_t, index_t), scale
        return stream_nv(slabs_nv, lo, x_nv, scales=scales, scale=scale, index=index)

    @staticmethod
    def backward(ctx, g):
        slabs_t, lo_t, scales_t, index_t = ctx.pack_t
        dx = stream_nv(slabs_t, lo_t, g.contiguous(), scales=scales_t, scale=ctx.scale,
                       index=index_t)
        return (dx,) + (None,) * 9


class ChebPairNv(torch.autograd.Function):
    """``(A x, 2 A (A x) − x)``; backward: the chain on the transpose pack."""

    @staticmethod
    def forward(ctx, x_nv, slabs_nv, lo, slabs_nv_t, lo_t, scales, scales_t, index, index_t):
        refuse_value_grad(slabs_nv, slabs_nv_t)
        ctx.pack_t = (slabs_nv_t, lo_t, scales_t, index_t)
        return stream_nv(slabs_nv, lo, x_nv, mode="pair", scales=scales, index=index)

    @staticmethod
    def backward(ctx, g1, g2):
        slabs_t, lo_t, scales_t, index_t = ctx.pack_t
        ref = g1 if g1 is not None else g2
        g1 = torch.zeros_like(ref) if g1 is None else g1.contiguous()
        g2 = torch.zeros_like(ref) if g2 is None else g2.contiguous()
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
