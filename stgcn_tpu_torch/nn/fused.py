"""The whole-block dense route of the STGCN (port of ``stgcn_tpu/nn/fused.py``):
:func:`fused_forward` runs each ST block as the fused kernels K12f / K12b
(:mod:`stgcn_tpu_torch.kernels.fused_stblock`) on the dense GSO, then the
output head in plain PyTorch, as the JAX package leaves the head to XLA
outside any Pallas kernel.

A functional apply over the port's ``state_dict``, the same weights the
unfused :class:`~stgcn_tpu_torch.nn.model.STGCN` trains. Per forward: K12f
once per ST block; per backward: K12b once per ST block; nothing else of
the port's kernels. Training drops out at the sites of ``STGCN.forward``
(block ``l``'s LayerNorm output at site ``l``, the head's fc1 output at site
``n_st_blocks``), with masks keyed by element, so the unfused model given
the same ``seed`` drops the same elements.

Also here: the head on cv-layout input (``_output_block_apply_cv``), the
oracle of the fused output head (:mod:`stgcn_tpu_torch.kernels.output_head`).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from stgcn_tpu_torch.kernels import dropout
from stgcn_tpu_torch.kernels._launch import refuse_bf16_model
from stgcn_tpu_torch.kernels.dropout import Drop
from stgcn_tpu_torch.kernels.fused_stblock import fused_st_block, gate_nm, tconv_nm
from stgcn_tpu_torch.kernels.vertex_fused import gate_cv, pad_channels_cv
from stgcn_tpu_torch.nn.model import STGCN


def subtree(params: dict, prefix: str) -> dict:
    """The entries of a flat ``state_dict`` under ``prefix.``, prefix removed."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + ".")}


def _linear(params: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, params[f"{name}.weight"], params.get(f"{name}.bias"))


def _output_block_apply(params: dict, x: torch.Tensor, *, act_func: str,
                        drop: Drop | None = None) -> torch.Tensor:
    """The 'TNFF' head on vertex-major ``x`` [B, Ko, V, c] (`model/layers.py:
    260-284`): time-collapsing temporal gate → LayerNorm([V, C]) → fc1 →
    ReLU → dropout (``drop``) → fc2; returns [B, 1, V, end]. ``params``: the
    output block's entries of the port's ``state_dict``, prefix removed."""
    w = params["tmp_conv1.causal_conv.weight"]           # [g, c_in, ko, 1]
    g, _, ko, _ = w.shape
    c0 = g // 2 if act_func in ("glu", "gtu") else g
    s = tconv_nm(x, w[..., 0].permute(2, 1, 0), params["tmp_conv1.causal_conv.bias"], ko)
    a = gate_nm(act_func, s, x[:, ko - 1:], c0)          # [B, 1, V, c0]
    mu = a.mean(dim=(-2, -1), keepdim=True)
    var = ((a - mu) ** 2).mean(dim=(-2, -1), keepdim=True)
    a = (a - mu) * torch.rsqrt(var + 1e-12) * params["ln.weight"] + params["ln.bias"]
    a = dropout.apply_channels_last(torch.relu(_linear(params, "fc1", a)), drop)
    return _linear(params, "fc2", a)


def fused_forward(params: dict, x: torch.Tensor, gop: Any, model: STGCN, *,
                  deterministic: bool = True, seed: int | None = None) -> torch.Tensor:
    """Forward pass with the fused ST-block kernels (the JAX ``fused_forward``,
    ``stgcn_tpu/nn/fused.py:155``).

    ``params``: the port's ``state_dict`` (``model.state_dict()``, or one made
    by :func:`stgcn_tpu_torch.nn.convert.params_from_jax`), or
    ``dict(model.named_parameters())`` to train; ``model`` supplies the
    configuration. ``x``: ``[B, T, V, C]`` on the device the kernels run on
    (CUDA; CPU tensors take the plain versions). ``gop`` must be a dense
    graph operator (``gop.matrix``, :class:`~stgcn_tpu_torch.ops.DenseGraphOp`).
    With ``deterministic=False`` and a nonzero droprate, ``seed`` (one step's
    dropout seed, :func:`stgcn_tpu_torch.kernels.dropout.step_seed`) keys the
    masks. Returns ``[B, T_out, V, end]`` float32.
    """
    gso = getattr(gop, "matrix", None)
    if gso is None:
        raise TypeError(f"fused_forward needs a dense graph operator (gop.matrix); "
                        f"{type(gop).__name__} has none: use fused_sparse_forward or the "
                        "unfused model")
    refuse_bf16_model(model, "fused_forward",
                      "the bf16 variants of K12f / K12b (ROADMAP.md §1 item 4)")
    training = not deterministic and model.droprate > 0.0
    if training and seed is None:
        raise ValueError("training with dropout needs the step's dropout seed (seed=...)")
    blocks, ko = model.plan()
    n_st = len(blocks) - 3
    for l in range(n_st):
        x = fused_st_block(x, gso, subtree(params, f"st_block_{l}"), kt=model.kt, ks=model.ks,
                           act_func=model.act_func, graph_conv_type=model.graph_conv_type,
                           droprate=model.droprate, deterministic=deterministic, seed=seed,
                           site=l)
    if ko > 1:
        drop = Drop(model.droprate, seed, n_st) if training else None
        y = _output_block_apply(subtree(params, "output"), x, act_func=model.act_func,
                                drop=drop)
    else:   # ko == 0: the inline fc head (`models.py:38-42,48-51`), no dropout
        y = _linear(params, "fc2", torch.relu(_linear(params, "fc1", x)))
    return y.float()


def _cv_dot(x_bcv: torch.Tensor, w_cd: torch.Tensor) -> torch.Tensor:
    """``[B, C, V] × [C, D] → [B, D, V]``."""
    return torch.einsum("bcv,cd->bdv", x_bcv, w_cd)


def _output_block_apply_cv(params: dict, x_cv: torch.Tensor, v_true: int, *,
                           act_func: str) -> torch.Tensor:
    """Deterministic output head on ``[B, Ko, C, V_pad]``; returns
    ``[B, 1, V_true, end]``. ``params``: the output block's entries of the
    port's ``state_dict`` with the ``output.`` prefix removed."""
    w = params["tmp_conv1.causal_conv.weight"]           # [g, c_in, ko, 1]
    g, c_in, ko, _ = w.shape
    c0 = g // 2 if act_func in ("glu", "gtu") else g

    x_cv = x_cv[..., :v_true]                            # [B, Ko, C, V]
    s = sum(_cv_dot(x_cv[:, k], w[:, :, k, 0].T) for k in range(ko))
    s = s + params["tmp_conv1.causal_conv.bias"][:, None]     # [B, g, V]
    xin = pad_channels_cv(x_cv[:, ko - 1:], c0)          # [B, 1, c0, V]
    a = gate_cv(act_func, s[:, None], xin, c0)[:, 0]     # [B, c0, V]

    # LayerNorm over (C, V) jointly, eps=1e-12 (`model/layers.py:272`)
    mu = a.mean(dim=(-2, -1), keepdim=True)
    var = ((a - mu) ** 2).mean(dim=(-2, -1), keepdim=True)
    a = (a - mu) * torch.rsqrt(var + 1e-12)
    a = a * params["ln.weight"].T[None] + params["ln.bias"].T[None]   # [V, C] → cv

    a = _cv_dot(a, params["fc1.weight"].T)
    if "fc1.bias" in params:
        a = a + params["fc1.bias"][:, None]
    a = _cv_dot(torch.relu(a), params["fc2.weight"].T)
    if "fc2.bias" in params:
        a = a + params["fc2.bias"][:, None]
    return a.permute(0, 2, 1)[:, None]                   # [B, 1, V, end]
