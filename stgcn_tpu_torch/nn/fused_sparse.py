"""Vertex-fused forward of the whole STGCN (port of
``stgcn_tpu/nn/fused_sparse.py:90-135,290-577``, single device), differentiable
through the backward kernels K1b-K4b.

A functional apply over the port's ``state_dict``: the same weights the
unfused :class:`~stgcn_tpu_torch.nn.model.STGCN` holds. Each ST block runs as
two hand-written kernels around the graph product::

    K1 head (prev-LN-normalize → tconv1 → gate → align)
      → graph aggregation (DenseGraphOp.cheb_pair_cv: torch.matmul; the
        cheb_pair_nv of BandedGraphOp (K5) or EllGraphOp (K6) on the
        [N, Vp] view, no transpose; or, on the [Vp, N] transpose,
        BcsrGraphOp.apply_vn twice (K10) or the cheb_pair_vn of a banded
        operator without its nv pack (K9), ``_graph_terms``)
      → K2 tail (contraction → residual → ReLU → tconv2 → gate + LN partials)

and the output head as K3 → μ/σ → K4 (:mod:`stgcn_tpu_torch.kernels.
output_head`). Activations travel between them channel-before-vertex
``[B, T, C, Vp]``. Per batch that is K1 ×n_blocks, K2 ×n_blocks, K3 ×1,
K4 ×1, and in the backward K1b/K2b ×n_blocks, K3b ×1, K4b ×1; on a banded
(ELL) operator also K5 (K6) ``pair`` ×n_blocks, and ``chain`` ×n_blocks in
the backward; on a BCSR operator K10 ×2·n_blocks, and as many in the
backward. On CPU
tensors every kernel wrapper runs its plain version. The LayerNorm
statistics between blocks (``ln_stats``), the graph product and the weight
layout conversions are PyTorch ops, differentiated by autograd.

Training (``deterministic=False``) drops out at one site per ST block (its
LayerNorm output, site ``l``, applied inside block ``l+1``'s K1 or in K3)
plus fc1's output in K4 (site ``n_blocks``), with masks keyed by element
(:mod:`stgcn_tpu_torch.kernels.dropout`): the unfused model given the same
``seed`` drops the same elements. Cheb ``Ks > 3`` and the degenerate
``Ko == 0`` plan run the unfused model (same math), as the JAX package does
for ``Ks > 3``.

``precision`` is the JAX argument's (``nn/fused_sparse.py:290-297,
367-376``): ``"auto"`` runs a bf16 model (``STGCN(dtype=bfloat16)``) through
the kernels' bf16 variants (``"bfloat16"``) and any other in float32
(``"default"``). In bf16 the input, the weights (biases stay float32), the
activations between the kernels and the LayerNorm affine threaded between
blocks are bf16, the LayerNorm statistics float32; the graph terms come
from the operator in bf16 (the dense ``torch.matmul``, the bf16 variants of
K5 on the banded nv pack, K6 on ELL and K10 on BCSR). The backward runs
K1b-K4b's bf16 variants: the data gradients in bf16 (the cotangents of
``xg`` from the tail and from the graph terms' adjoint meet as a bf16 add,
as in JAX), each weight gradient a float32 sum rounded to bf16 by its
Function, as the JAX ``custom_vjp`` casts it, then cast to the float32
master parameter by autograd; μ/rstd and their gradients float32.

``remat`` (default: the model's) and ``remat_policy`` are the JAX
arguments (``nn/fused_sparse.py:290-298, 475-483``), taken where autograd
records. ``"minimal"`` keeps nothing of an ST block but its inputs (head
input, μ, rstd, the LayerNorm affine, the weights): the block runs under
``torch.utils.checkpoint`` and the backward replays K1, the graph product
(K5 / K6 / K10 / the matmul) and K2 before K2b and K1b; the dropout masks
are keyed by element, so the replay draws the same ones, and the gradients
are the plain route's bit for bit. ``"graph-terms"`` keeps the block's
inputs, ``xg`` and the graph terms and recomputes the rest, as the JAX
policy ``save_only_these_names("stgcn_xg", "stgcn_graph_term")`` does. On
this route that is what the plain route keeps: K1's Function saves only its
inputs, K2's only ``xg``, the graph terms and its weights, the nv pairs and
K10's Function only their transpose pack (the dense ``torch.matmul`` also
its padded ``[Vp, Vp]`` matrix), so the policy runs the block as it is,
with no replay.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt

from stgcn_tpu_torch.kernels._launch import LANES
from stgcn_tpu_torch.kernels.dropout import Drop
from stgcn_tpu_torch.kernels.fused_stblock import block_weights
from stgcn_tpu_torch.kernels.output_head import output_head_fused
from stgcn_tpu_torch.kernels.vertex_fused import (
    VertexBlockCfg, head_fused, ln_stats, tail_fused)
from stgcn_tpu_torch.nn.fused import subtree
from stgcn_tpu_torch.nn.model import STGCN


def _graph_terms(cfg: VertexBlockCfg, gop: Any, xg: torch.Tensor):
    """The graph outputs entering the tail contraction, in cv layout."""
    if cfg.ks == 1 and cfg.graph_conv_type == "cheb_graph_conv":
        return xg, xg  # contraction uses T_0 only
    one = cfg.graph_conv_type == "graph_conv" or cfg.ks == 2
    if hasattr(gop, "cheb_pair_cv") and hasattr(gop, "apply_cv"):
        if one:
            t = gop.apply_cv(xg)
            return t, t
        return gop.cheb_pair_cv(xg)
    if getattr(gop, "has_nv", False):
        # the cv layout [B, T, C, Vp] is a reshape view of the nv operand
        # [N, Vp], and the kernels' Vp is the operator's v_pad: no copy
        x_nv = xg.reshape(-1, xg.shape[-1])
        if one:
            t = gop.apply_nv(x_nv).reshape(xg.shape)
            return t, t
        return tuple(t.reshape(xg.shape) for t in gop.cheb_pair_nv(x_nv))
    if hasattr(gop, "apply_vn"):
        # an operator on the folded [V, N] operand (BCSR: K10; banded without
        # its nv pack: K7-K9): a transpose each way; rows past the operator's
        # pad are zero padding
        x_vn = xg.reshape(-1, xg.shape[-1]).T[:_op_pad(gop)]
        if one:
            t = _from_vn(gop.apply_vn(x_vn), xg)
            return t, t
        if hasattr(gop, "cheb_pair_vn"):
            t1, t2 = gop.cheb_pair_vn(x_vn)
        else:
            t1 = gop.apply_vn(x_vn)
            t2 = gop.apply_vn(t1, scale=2.0) - x_vn
        return _from_vn(t1, xg), _from_vn(t2, xg)
    raise NotImplementedError(f"{type(gop).__name__} has neither the cv, the nv nor the vn "
                              "surface; only the dense, banded, ELL and BCSR graph operators "
                              "are ported")


def _from_vn(y_vn: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``[W, N]`` → the cv layout of ``like`` (``[B, T, C, Vp]``), rows past W
    zero, contiguous (K2 reads it as such)."""
    y_vn = F.pad(y_vn, (0, 0, 0, like.shape[-1] - y_vn.shape[0]))
    return y_vn.T.contiguous().reshape(like.shape)


def _op_pad(gop: Any) -> int | None:
    """The operator's padded vertex count: ``v_pad`` (dense, banded, ELL)
    or ``n_vertex_pad`` (BCSR), as the JAX package reads it."""
    return getattr(gop, "v_pad", None) or getattr(gop, "n_vertex_pad", None)


def _st_block(cfg: VertexBlockCfg, gop: Any, head_in, mu, rstd, lng_p, lnb_p, w,
              drop: Drop | None):
    """One ST block: K1 → graph aggregation → K2; returns (a2, ps, pss)."""
    c1k, c1b, gaw, gab, gcw, gcb, c2k, c2b = w
    xg = head_fused(cfg, head_in, mu, rstd, lng_p, lnb_p, c1k, c1b, gaw, gab, drop=drop)
    t_a, t_b = _graph_terms(cfg, gop, xg)
    return tail_fused(cfg, xg, t_a, t_b, gcw, gcb, c2k, c2b)


REMAT_POLICIES = ("graph-terms", "minimal")


def fused_sparse_forward(params: dict, x: torch.Tensor, gop: Any, model: STGCN, *,
                         deterministic: bool = True, seed: int | None = None,
                         precision: str = "auto", remat: bool | None = None,
                         remat_policy: str = "graph-terms") -> torch.Tensor:
    """Forward pass through the vertex-fused kernels.

    ``params``: the port's ``state_dict`` (``model.state_dict()``, or one
    made by :func:`stgcn_tpu_torch.nn.convert.params_from_jax`), or
    ``dict(model.named_parameters())`` to train; ``model`` supplies the
    configuration. ``x``: ``[B, T, V, C]`` on the device the kernels run on
    (CUDA; CPU tensors take the plain versions). ``gop`` must expose a
    padded vertex count (``v_pad``, or ``n_vertex_pad``; the kernels' lanes
    round it up to a multiple of 128) and the cv surface
    (:class:`~stgcn_tpu_torch.ops.DenseGraphOp`), the nv one
    (:class:`~stgcn_tpu_torch.ops.BandedGraphOp`,
    :class:`~stgcn_tpu_torch.ops.EllGraphOp`) or the vn one
    (:class:`~stgcn_tpu_torch.ops.BcsrGraphOp`). With ``deterministic=False``
    and a nonzero droprate, ``seed`` (one step's dropout seed,
    :func:`stgcn_tpu_torch.kernels.dropout.step_seed`) keys the masks.
    ``precision``: ``"auto"`` (bf16 for a bf16 model), ``"default"``
    (float32) or ``"bfloat16"``. ``remat`` (None: ``model.remat``) and
    ``remat_policy`` (``"graph-terms"`` or ``"minimal"``): what the backward
    recomputes (the module's notes). Returns ``[B, 1, V, 1]`` float32.
    """
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {remat_policy!r}: one of {REMAT_POLICIES}")
    if remat is None:
        remat = model.remat
    block = _st_block
    if remat and remat_policy == "minimal" and torch.is_grad_enabled():
        def block(*args):
            return ckpt.checkpoint(_st_block, *args, use_reentrant=False,
                                   preserve_rng_state=False)
    if precision == "auto":
        precision = "bfloat16" if model.dtype == torch.bfloat16 else "default"
    if precision not in ("default", "bfloat16"):
        raise ValueError(f"precision {precision!r}: 'auto', 'default' or 'bfloat16'")
    # the JAX package's cdt and ln_dt: a float32 model's bf16 LayerNorm affine
    # (ln_param_dtype) is cast to float32
    cdt = torch.bfloat16 if precision == "bfloat16" else torch.float32
    training = not deterministic and model.droprate > 0.0
    if training and seed is None:
        raise ValueError("training with dropout needs the step's dropout seed (seed=...)")
    blocks, ko = model.plan()
    if (model.graph_conv_type == "cheb_graph_conv" and model.ks > 3) or ko == 0:
        # the kernels carry at most the ks=3 recurrence's two graph terms,
        # and Ko == 0 leaves no time step for them: run the unfused model
        return torch.func.functional_call(model, params, (x, gop),
                                          {"deterministic": deterministic, "seed": seed})

    def drop(site: int) -> Drop | None:
        return Drop(model.droprate, seed, site) if training else None

    gv = _op_pad(gop)
    if gv is None:
        raise ValueError("fused_sparse_forward needs a graph operator exposing a padded "
                         "vertex count, v_pad (DenseGraphOp, BandedGraphOp, EllGraphOp) or "
                         "n_vertex_pad (BcsrGraphOp)")
    # K1-K4 take whole 128-lane blocks (the JAX _round_up(gv, tile_v)); the
    # dense, banded and ELL pads are multiples already, a BCSR one may not be
    v_pad = -(-gv // LANES) * LANES
    b, _, v_true, c_x = x.shape

    x = x.to(cdt)
    if c_x == 1:  # the cv transpose of one channel is a reshape
        x = x.reshape(b, x.shape[1], 1, v_true)
    else:
        x = x.transpose(2, 3)
    x = F.pad(x, (0, v_pad - v_true)).contiguous()

    state = None  # (a2, mu, rstd, lng_pad, lnb_pad) awaiting normalize
    cur_t, c_in = model.n_his, c_x
    for l in range(len(blocks) - 3):
        c0, c1, c2 = blocks[l + 1]
        cfg = VertexBlockCfg(kt=model.kt, ks=model.ks, act_func=model.act_func,
                             graph_conv_type=model.graph_conv_type, v_true=v_true,
                             v_pad=v_pad, t_in=cur_t, c_in=c_in, c0=c0, c1=c1, c2=c2,
                             apply_ln=l > 0, precision=precision)
        *w, lng, lnb = block_weights(subtree(params, f"st_block_{l}"), model.graph_conv_type)
        w = [t.to(cdt if i % 2 == 0 else torch.float32) for i, t in enumerate(w)]   # biases f32
        if state is None:
            head_in, mu, rstd, lng_p, lnb_p = x, None, None, None, None
        else:
            head_in, mu, rstd, lng_p, lnb_p = state
        a2, ps, pss = block(cfg, gop, head_in, mu, rstd, lng_p, lnb_p, w,
                            drop(l - 1) if l > 0 else None)
        mu, rstd = ln_stats(ps, pss, v_true * c2)
        pad_v = (0, 0, 0, v_pad - v_true)
        state = (a2, mu, rstd, F.pad(lng.to(cdt), pad_v).T.contiguous(),
                 F.pad(lnb.to(cdt), pad_v).T.contiguous())
        cur_t, c_in = cfg.t2, c2

    a2, mu, rstd, lng_p, lnb_p = state
    n_st = len(blocks) - 3
    out = output_head_fused(subtree(params, "output"), a2, mu, rstd, lng_p, lnb_p,
                            v_true=v_true, act_func=model.act_func,
                            drop_in=drop(n_st - 1), drop_fc=drop(n_st))
    return out[:, :, :v_true, :]
