"""The output head in plain PyTorch on cv-layout input (port of
``stgcn_tpu/nn/fused.py:96-153``, ``_output_block_apply_cv``).

It is the oracle of the fused output head (:mod:`stgcn_tpu_torch.kernels.
output_head`): the same 'TNFF' math (`model/layers.py:260-284`) written
directly, with the LayerNorm statistics taken over the true vertices only.
The whole-block dense route (``fused_forward``, TPU kernel K12) is not
ported yet.
"""

from __future__ import annotations

import torch

from stgcn_tpu_torch.kernels.vertex_fused import gate_cv, pad_channels_cv


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
