"""STGCN layers (port of ``stgcn_tpu/nn/layers.py:31-311``).

Activations are channels-last ``[batch, time, vertex, channel]``, as in
the JAX package. Parameters keep PyTorch's own layouts: a temporal conv
weight is ``[c_out, c_in, kt, 1]`` (``nn.Conv2d``), a linear weight is
``[out, in]`` and the joint LayerNorm is ``nn.LayerNorm([V, C])``;
:mod:`stgcn_tpu_torch.nn.convert` maps them to and from the flax tree.

Every module draws its parameters in ``reset_parameters(generator)``
(:mod:`stgcn_tpu_torch.nn.init`). The graph operator is a call argument.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from stgcn_tpu_torch.kernels import dropout
from stgcn_tpu_torch.kernels.dropout import Drop
from stgcn_tpu_torch.nn import init as tinit

ACTIVATIONS = ("glu", "gtu", "relu", "silu")


class Linear(nn.Linear):
    """``nn.Linear`` whose weight and bias are both ``U(±1/√in)``, drawn
    from the generator given to :meth:`reset_parameters`."""

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        if generator is None:  # nn.Linear.__init__ calls this; drawn later
            return
        bound = tinit.fan_bound(self.in_features)
        tinit.uniform_(self.weight, bound, generator)
        if self.bias is not None:
            tinit.uniform_(self.bias, bound, generator)


class Align(nn.Module):
    """Channel matcher for residual paths (`model/layers.py:7-23`): 1×1
    conv when shrinking, zero-pad channels when growing, identity else."""

    def __init__(self, c_in: int, c_out: int, *, device=None):
        super().__init__()
        self.c_in, self.c_out = c_in, c_out
        if c_in > c_out:
            self.align_conv = Linear(c_in, c_out, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.c_in > self.c_out:
            return self.align_conv(x)
        if self.c_in < self.c_out:
            return F.pad(x, (0, self.c_out - self.c_in))
        return x


class CausalConv(nn.Module):
    """Valid temporal conv with kernel ``(kt, 1)`` (`model/layers.py:40-57`,
    ``causal_pad=False``, the only mode STGCN uses): time shrinks by
    ``kt − 1``. Computed as a sum over taps of ``[.., c_in] @ [c_in, c_out]``
    matmuls, which keeps it off cuDNN's TF32 default."""

    def __init__(self, c_in: int, c_out: int, kt: int, *, device=None):
        super().__init__()
        self.c_in, self.c_out, self.kt = c_in, c_out, kt
        self.weight = nn.Parameter(torch.empty(c_out, c_in, kt, 1, device=device))
        self.bias = nn.Parameter(torch.empty(c_out, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = tinit.fan_bound(self.kt * self.c_in)
        tinit.uniform_(self.weight, bound, generator)
        tinit.uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t_out = x.shape[1] - self.kt + 1
        w = self.weight[..., 0]                        # [c_out, c_in, kt]
        y = torch.matmul(x[:, 0:t_out], w[:, :, 0].T)
        for k in range(1, self.kt):
            y = y + torch.matmul(x[:, k:k + t_out], w[:, :, k].T)
        return y + self.bias


class TemporalConvLayer(nn.Module):
    """Gated temporal conv (`model/layers.py:59-120`).

    GLU: ``(x_p + x_in) ⊙ σ(x_q)`` — the residual is added *inside* the
    linear branch of the gate (`layers.py:105`), a nonstandard GLU kept for
    parity. GTU: ``tanh(x_p + x_in) ⊙ σ(x_q)``. relu/silu:
    ``act(conv(x) + x_in)``.
    """

    def __init__(self, kt: int, c_in: int, c_out: int, act_func: str = "glu", *,
                 device=None):
        super().__init__()
        if act_func not in ACTIVATIONS:
            raise NotImplementedError(
                f"activation {act_func!r} not implemented; expected {ACTIVATIONS}")
        self.kt, self.c_out, self.act_func = kt, c_out, act_func
        self.gated = act_func in ("glu", "gtu")
        self.align = Align(c_in, c_out, device=device)
        self.causal_conv = CausalConv(c_in, 2 * c_out if self.gated else c_out, kt,
                                      device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_in = self.align(x)[:, self.kt - 1:]
        y = self.causal_conv(x)
        if self.gated:
            lin = y[..., : self.c_out] + x_in
            if self.act_func == "gtu":
                lin = torch.tanh(lin)
            return lin * torch.sigmoid(y[..., self.c_out:])
        if self.act_func == "relu":
            return torch.relu(y + x_in)
        return F.silu(y + x_in)


class ChebGraphConv(nn.Module):
    """Chebyshev graph conv of order ``Ks`` (`model/layers.py:122-172`):
    ``T_0 = x``, ``T_1 = Gx``, ``T_k = 2G·T_{k−1} − T_{k−2}``; output
    ``Σ_k T_k W_k + b``, folded term by term (no ``[Ks, ...]`` stack). At
    ``Ks = 3`` an operator with ``cheb_pair`` (the banded or ELL one: K5 or
    K6 ``pair``) gives both terms in one call (`nn/layers.py:159-168` of the
    JAX package)."""

    def __init__(self, c_in: int, c_out: int, ks: int, use_bias: bool = True, *,
                 device=None):
        super().__init__()
        if ks < 1:
            raise ValueError(f"Ks must be a positive integer, got {ks}")
        self.ks = ks
        self.weight = nn.Parameter(torch.empty(ks, c_in, c_out, device=device))
        self.bias = nn.Parameter(torch.empty(c_out, device=device)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        # torch-shape [Ks, c_in, c_out] ⇒ fan_in = c_in*c_out (see nn/init.py)
        bound = tinit.fan_bound(tinit.torch_fan_in(tuple(self.weight.shape)))
        tinit.uniform_(self.weight, bound, generator)
        if self.bias is not None:
            tinit.uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor, gop: Any) -> torch.Tensor:
        t_prev2 = x
        out = torch.matmul(x, self.weight[0])
        if self.ks == 3 and hasattr(gop, "cheb_pair"):
            # fused recurrence: the sparse operator streams once for both terms
            t1, t2 = gop.cheb_pair(x)
            out = out + torch.matmul(t1, self.weight[1])
            out = out + torch.matmul(t2, self.weight[2])
        elif self.ks >= 2:
            t_prev1 = gop(x)
            out = out + torch.matmul(t_prev1, self.weight[1])
            for k in range(2, self.ks):
                t_k = gop(t_prev1, scale=2.0) - t_prev2
                out = out + torch.matmul(t_k, self.weight[k])
                t_prev2, t_prev1 = t_prev1, t_k
        if self.bias is not None:
            out = out + self.bias
        return out


class GraphConv(nn.Module):
    """1st-order GCN conv: ``(Gx)W + b`` (`model/layers.py:174-206`)."""

    def __init__(self, c_in: int, c_out: int, use_bias: bool = True, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_in, c_out, device=device))
        self.bias = nn.Parameter(torch.empty(c_out, device=device)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        # torch-shape [c_in, c_out] ⇒ torch fan_in = size(1) = c_out (quirk)
        bound = tinit.fan_bound(tinit.torch_fan_in(tuple(self.weight.shape)))
        tinit.uniform_(self.weight, bound, generator)
        if self.bias is not None:
            tinit.uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor, gop: Any) -> torch.Tensor:
        out = torch.matmul(gop(x), self.weight)
        return out + self.bias if self.bias is not None else out


class GraphConvLayer(nn.Module):
    """Align → graph conv (square, at ``c_out``) → residual add
    (`model/layers.py:208-231`). The 64→16 bottleneck is the align."""

    def __init__(self, graph_conv_type: str, c_in: int, c_out: int, ks: int,
                 use_bias: bool = True, *, device=None):
        super().__init__()
        self.align = Align(c_in, c_out, device=device)
        if graph_conv_type == "cheb_graph_conv":
            self.cheb_graph_conv = ChebGraphConv(c_out, c_out, ks, use_bias, device=device)
        elif graph_conv_type == "graph_conv":
            self.graph_conv = GraphConv(c_out, c_out, use_bias, device=device)
        else:
            raise ValueError(f"unknown graph_conv_type {graph_conv_type!r}")
        self.graph_conv_type = graph_conv_type

    def forward(self, x: torch.Tensor, gop: Any) -> torch.Tensor:
        x_in = self.align(x)
        conv = self.cheb_graph_conv if self.graph_conv_type == "cheb_graph_conv" \
            else self.graph_conv
        return conv(x_in, gop) + x_in


class STConvBlock(nn.Module):
    """'TGTND' sandwich (`model/layers.py:233-258`): temporal gate → graph
    conv → ReLU → temporal gate → LayerNorm([V, C], eps=1e-12) → dropout.
    The dropout mask is keyed by element (``drop``, from the model), so the
    fused kernels drop the same elements."""

    def __init__(self, kt: int, ks: int, n_vertex: int, c_in: int,
                 channels: tuple[int, int, int], act_func: str,
                 graph_conv_type: str, use_bias: bool = True, *, device=None):
        super().__init__()
        self.tmp_conv1 = TemporalConvLayer(kt, c_in, channels[0], act_func, device=device)
        self.graph_conv = GraphConvLayer(graph_conv_type, channels[0], channels[1], ks,
                                         use_bias, device=device)
        self.tmp_conv2 = TemporalConvLayer(kt, channels[1], channels[2], act_func,
                                           device=device)
        self.ln = nn.LayerNorm([n_vertex, channels[2]], eps=1e-12, device=device)

    def forward(self, x: torch.Tensor, gop: Any, drop: Drop | None = None) -> torch.Tensor:
        x = self.tmp_conv1(x)
        x = torch.relu(self.graph_conv(x, gop))
        x = self.ln(self.tmp_conv2(x))
        return dropout.apply_channels_last(x, drop)


class OutputBlock(nn.Module):
    """'TNFF' head (`model/layers.py:260-284`): temporal gate collapsing the
    remaining ``Ko`` steps to 1 → LayerNorm → fc1 → ReLU → dropout → fc2."""

    def __init__(self, ko: int, n_vertex: int, c_in: int, channels: tuple[int, int],
                 end_channel: int, act_func: str, use_bias: bool = True, *, device=None):
        super().__init__()
        self.tmp_conv1 = TemporalConvLayer(ko, c_in, channels[0], act_func, device=device)
        self.ln = nn.LayerNorm([n_vertex, channels[0]], eps=1e-12, device=device)
        self.fc1 = Linear(channels[0], channels[1], bias=use_bias, device=device)
        self.fc2 = Linear(channels[1], end_channel, bias=use_bias, device=device)

    def forward(self, x: torch.Tensor, drop: Drop | None = None) -> torch.Tensor:
        x = self.ln(self.tmp_conv1(x))
        x = torch.relu(self.fc1(x))
        x = dropout.apply_channels_last(x, drop)
        return self.fc2(x)
