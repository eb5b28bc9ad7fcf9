"""STGCN layers (port of ``stgcn_tpu/nn/layers.py:31-311``).

Activations are channels-last ``[batch, time, vertex, channel]``, as in
the JAX package. Parameters keep PyTorch's own layouts: a temporal conv
weight is ``[c_out, c_in, kt, 1]`` (``nn.Conv2d``), a linear weight is
``[out, in]`` and the joint LayerNorm is ``nn.LayerNorm([V, C])``;
:mod:`stgcn_tpu_torch.nn.convert` maps them to and from the flax tree.

Every module draws its parameters in ``reset_parameters(generator)``
(:mod:`stgcn_tpu_torch.nn.init`). The graph operator is a call argument.

Mixed precision follows the JAX layers' ``dtype`` field (``nn/layers.py:
75-88``, ``:151-153``, ``:182``, ``:200-211``): a layer with ``dtype`` set
(``torch.bfloat16``) casts its input, its weights and its bias to it and
computes there; the parameters stay float32. Where two operands of a
product or a sum differ in type (a float32 dense graph term, a zero-padded
float32 residual) the result takes the promoted type, as ``jnp`` promotes.
The LayerNorms run in float32 with their affine in ``ln_param_dtype`` and
cast to ``dtype`` afterwards (``:266-273``, ``:294-300``). ``dtype=None``
is the float32 model, unchanged.

Per-block recompute (``STConvBlock(remat=True)``, the JAX ``nn.remat`` with
``save_only_these_names("stgcn_graph_term")``, ``nn/model.py:85-92``): the
block runs as head → graph terms → tail, the head (temporal conv 1 and the
graph conv's align) and the tail (the graph conv's weight contraction and
residual, ReLU, temporal conv 2, LayerNorm, dropout) each under
``torch.utils.checkpoint`` (``use_reentrant=False``), the graph terms
between them outside it. So the backward replays the head and the tail
and never the graph product; the autograd graph is the one of the plain
block, so the gradients are the same bits. Saved across the block: its
input, the graph operand (the head's output) and the graph terms.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt
from torch import nn

from stgcn_tpu_torch.kernels import dropout
from stgcn_tpu_torch.kernels.dropout import Drop
from stgcn_tpu_torch.nn import init as tinit

ACTIVATIONS = ("glu", "gtu", "relu", "silu")


def _cast(t: torch.Tensor | None, dtype: torch.dtype | None) -> torch.Tensor | None:
    """``t`` in the compute dtype (unchanged for ``dtype=None``)."""
    return t if t is None or dtype is None else t.to(dtype)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted type of the two (``jnp.einsum`` promotes;
    ``torch.matmul`` does not)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """The joint LayerNorm in float32 with its affine widened from
    ``ln_param_dtype``, then cast to ``dtype`` (the JAX ``nn.LayerNorm(dtype=
    float32, param_dtype=ln_param_dtype)`` and the ``astype`` after it)."""
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(), ln.eps)
    return _cast(y, dtype)


class Linear(nn.Linear):
    """``nn.Linear`` whose weight and bias are both ``U(±1/√in)``, drawn
    from the generator given to :meth:`reset_parameters`. ``compute_dtype``
    is the flax ``Dense(dtype=...)``: input, weight and bias cast to it;
    None computes in the promoted type of input and weight (``nn.Linear``'s
    own ``dtype`` is the parameters', which stay float32)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 device=None, compute_dtype: torch.dtype | None = None):
        super().__init__(in_features, out_features, bias, device=device)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))

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

    def __init__(self, c_in: int, c_out: int, *, device=None, dtype=None):
        super().__init__()
        self.c_in, self.c_out = c_in, c_out
        if c_in > c_out:
            self.align_conv = Linear(c_in, c_out, device=device, compute_dtype=dtype)

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
    matmuls, which keeps it off cuDNN's TF32 default. ``dtype``: input,
    kernel and bias cast to it."""

    def __init__(self, c_in: int, c_out: int, kt: int, *, device=None, dtype=None):
        super().__init__()
        self.c_in, self.c_out, self.kt, self.dtype = c_in, c_out, kt, dtype
        self.weight = nn.Parameter(torch.empty(c_out, c_in, kt, 1, device=device))
        self.bias = nn.Parameter(torch.empty(c_out, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = tinit.fan_bound(self.kt * self.c_in)
        tinit.uniform_(self.weight, bound, generator)
        tinit.uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t_out = x.shape[1] - self.kt + 1
        x = _cast(x, self.dtype)
        w = _cast(self.weight[..., 0], self.dtype)     # [c_out, c_in, kt]
        y = torch.matmul(x[:, 0:t_out], w[:, :, 0].T)
        for k in range(1, self.kt):
            y = y + torch.matmul(x[:, k:k + t_out], w[:, :, k].T)
        return y + _cast(self.bias, self.dtype)


class TemporalConvLayer(nn.Module):
    """Gated temporal conv (`model/layers.py:59-120`).

    GLU: ``(x_p + x_in) ⊙ σ(x_q)`` — the residual is added *inside* the
    linear branch of the gate (`layers.py:105`), a nonstandard GLU kept for
    parity. GTU: ``tanh(x_p + x_in) ⊙ σ(x_q)``. relu/silu:
    ``act(conv(x) + x_in)``.
    """

    def __init__(self, kt: int, c_in: int, c_out: int, act_func: str = "glu", *,
                 device=None, dtype=None):
        super().__init__()
        if act_func not in ACTIVATIONS:
            raise NotImplementedError(
                f"activation {act_func!r} not implemented; expected {ACTIVATIONS}")
        self.kt, self.c_out, self.act_func = kt, c_out, act_func
        self.gated = act_func in ("glu", "gtu")
        self.align = Align(c_in, c_out, device=device, dtype=dtype)
        self.causal_conv = CausalConv(c_in, 2 * c_out if self.gated else c_out, kt,
                                      device=device, dtype=dtype)

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
    JAX package). :meth:`graph_terms` (the graph products: what remat
    keeps, the JAX ``"stgcn_graph_term"`` names) and :meth:`contract` (the
    weights) are the two halves of :meth:`forward`; ``x`` reaches both in
    the compute dtype (:meth:`operand`)."""

    def __init__(self, c_in: int, c_out: int, ks: int, use_bias: bool = True, *,
                 device=None, dtype=None):
        super().__init__()
        if ks < 1:
            raise ValueError(f"Ks must be a positive integer, got {ks}")
        self.ks, self.dtype = ks, dtype
        self.weight = nn.Parameter(torch.empty(ks, c_in, c_out, device=device))
        self.bias = nn.Parameter(torch.empty(c_out, device=device)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        # torch-shape [Ks, c_in, c_out] ⇒ fan_in = c_in*c_out (see nn/init.py)
        bound = tinit.fan_bound(tinit.torch_fan_in(tuple(self.weight.shape)))
        tinit.uniform_(self.weight, bound, generator)
        if self.bias is not None:
            tinit.uniform_(self.bias, bound, generator)

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        return _cast(x, self.dtype)

    def graph_terms(self, x: torch.Tensor, gop: Any) -> list[torch.Tensor]:
        """``[T_1, ..., T_{Ks−1}]`` of the operand ``x``."""
        if self.ks == 3 and hasattr(gop, "cheb_pair"):
            # fused recurrence: the sparse operator streams once for both terms
            return list(gop.cheb_pair(x))
        terms: list[torch.Tensor] = []
        if self.ks >= 2:
            t_prev2, t_prev1 = x, gop(x)
            terms.append(t_prev1)
            for _ in range(2, self.ks):
                t_k = gop(t_prev1, scale=2.0) - t_prev2
                terms.append(t_k)
                t_prev2, t_prev1 = t_prev1, t_k
        return terms

    def contract(self, x: torch.Tensor, terms: list[torch.Tensor]) -> torch.Tensor:
        w = _cast(self.weight, self.dtype)
        out = _mm(x, w[0])
        for k, t_k in enumerate(terms, 1):
            out = out + _mm(t_k, w[k])
        if self.bias is not None:
            out = out + _cast(self.bias, self.dtype)
        return out

    def forward(self, x: torch.Tensor, gop: Any) -> torch.Tensor:
        x = self.operand(x)
        return self.contract(x, self.graph_terms(x, gop))


class GraphConv(nn.Module):
    """1st-order GCN conv: ``(Gx)W + b`` (`model/layers.py:174-206`), in the
    halves of :class:`ChebGraphConv`."""

    def __init__(self, c_in: int, c_out: int, use_bias: bool = True, *, device=None,
                 dtype=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(c_in, c_out, device=device))
        self.bias = nn.Parameter(torch.empty(c_out, device=device)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        # torch-shape [c_in, c_out] ⇒ torch fan_in = size(1) = c_out (quirk)
        bound = tinit.fan_bound(tinit.torch_fan_in(tuple(self.weight.shape)))
        tinit.uniform_(self.weight, bound, generator)
        if self.bias is not None:
            tinit.uniform_(self.bias, bound, generator)

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        return _cast(x, self.dtype)

    def graph_terms(self, x: torch.Tensor, gop: Any) -> list[torch.Tensor]:
        return [gop(x)]

    def contract(self, x: torch.Tensor, terms: list[torch.Tensor]) -> torch.Tensor:
        out = _mm(terms[0], _cast(self.weight, self.dtype))
        return out + _cast(self.bias, self.dtype) if self.bias is not None else out

    def forward(self, x: torch.Tensor, gop: Any) -> torch.Tensor:
        x = self.operand(x)
        return self.contract(x, self.graph_terms(x, gop))


class GraphConvLayer(nn.Module):
    """Align → graph conv (square, at ``c_out``) → residual add
    (`model/layers.py:208-231`). The 64→16 bottleneck is the align."""

    def __init__(self, graph_conv_type: str, c_in: int, c_out: int, ks: int,
                 use_bias: bool = True, *, device=None, dtype=None):
        super().__init__()
        self.align = Align(c_in, c_out, device=device, dtype=dtype)
        if graph_conv_type == "cheb_graph_conv":
            self.cheb_graph_conv = ChebGraphConv(c_out, c_out, ks, use_bias, device=device,
                                                 dtype=dtype)
        elif graph_conv_type == "graph_conv":
            self.graph_conv = GraphConv(c_out, c_out, use_bias, device=device, dtype=dtype)
        else:
            raise ValueError(f"unknown graph_conv_type {graph_conv_type!r}")
        self.graph_conv_type = graph_conv_type

    @property
    def conv(self) -> ChebGraphConv | GraphConv:
        return self.cheb_graph_conv if self.graph_conv_type == "cheb_graph_conv" \
            else self.graph_conv

    def operand(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(x_in, xg)``: the aligned input (the residual) and the graph
        operand, ``x_in`` in the compute dtype."""
        x_in = self.align(x)
        return x_in, self.conv.operand(x_in)

    def finish(self, x_in: torch.Tensor, xg: torch.Tensor,
               terms: list[torch.Tensor]) -> torch.Tensor:
        return self.conv.contract(xg, terms) + x_in

    def forward(self, x: torch.Tensor, gop: Any) -> torch.Tensor:
        x_in, xg = self.operand(x)
        return self.finish(x_in, xg, self.conv.graph_terms(xg, gop))


class STConvBlock(nn.Module):
    """'TGTND' sandwich (`model/layers.py:233-258`): temporal gate → graph
    conv → ReLU → temporal gate → LayerNorm([V, C], eps=1e-12) → dropout.
    The dropout mask is keyed by element (``drop``, from the model), so the
    fused kernels drop the same elements, and a recompute under ``remat``
    draws it again with no RNG state. The LayerNorm's affine is in
    ``ln_param_dtype``."""

    def __init__(self, kt: int, ks: int, n_vertex: int, c_in: int,
                 channels: tuple[int, int, int], act_func: str,
                 graph_conv_type: str, use_bias: bool = True, *, device=None, dtype=None,
                 ln_param_dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.dtype, self.remat = dtype, remat
        self.tmp_conv1 = TemporalConvLayer(kt, c_in, channels[0], act_func, device=device,
                                           dtype=dtype)
        self.graph_conv = GraphConvLayer(graph_conv_type, channels[0], channels[1], ks,
                                         use_bias, device=device, dtype=dtype)
        self.tmp_conv2 = TemporalConvLayer(kt, channels[1], channels[2], act_func,
                                           device=device, dtype=dtype)
        self.ln = nn.LayerNorm([n_vertex, channels[2]], eps=1e-12, device=device,
                               dtype=ln_param_dtype)

    def head(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Temporal conv 1 and the graph conv's align: ``(x_in, xg)``."""
        return self.graph_conv.operand(self.tmp_conv1(x))

    def tail(self, x_in: torch.Tensor, xg: torch.Tensor, drop: Drop | None,
             *terms: torch.Tensor) -> torch.Tensor:
        """The graph conv's contraction and residual, ReLU, temporal conv 2,
        LayerNorm and dropout."""
        x = torch.relu(self.graph_conv.finish(x_in, xg, list(terms)))
        x = layer_norm(self.ln, self.tmp_conv2(x), self.dtype)
        return dropout.apply_channels_last(x, drop)

    def forward(self, x: torch.Tensor, gop: Any, drop: Drop | None = None) -> torch.Tensor:
        if not (self.remat and torch.is_grad_enabled()):
            x_in, xg = self.head(x)
            return self.tail(x_in, xg, drop, *self.graph_conv.conv.graph_terms(xg, gop))
        x_in, xg = ckpt.checkpoint(self.head, x, use_reentrant=False, preserve_rng_state=False)
        terms = self.graph_conv.conv.graph_terms(xg, gop)   # kept, never replayed
        return ckpt.checkpoint(self.tail, x_in, xg, drop, *terms, use_reentrant=False,
                               preserve_rng_state=False)


class OutputBlock(nn.Module):
    """'TNFF' head (`model/layers.py:260-284`): temporal gate collapsing the
    remaining ``Ko`` steps to 1 → LayerNorm → fc1 → ReLU → dropout → fc2."""

    def __init__(self, ko: int, n_vertex: int, c_in: int, channels: tuple[int, int],
                 end_channel: int, act_func: str, use_bias: bool = True, *, device=None,
                 dtype=None, ln_param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.tmp_conv1 = TemporalConvLayer(ko, c_in, channels[0], act_func, device=device,
                                           dtype=dtype)
        self.ln = nn.LayerNorm([n_vertex, channels[0]], eps=1e-12, device=device,
                               dtype=ln_param_dtype)
        self.fc1 = Linear(channels[0], channels[1], bias=use_bias, device=device,
                          compute_dtype=dtype)
        self.fc2 = Linear(channels[1], end_channel, bias=use_bias, device=device,
                          compute_dtype=dtype)

    def forward(self, x: torch.Tensor, drop: Drop | None = None) -> torch.Tensor:
        x = layer_norm(self.ln, self.tmp_conv1(x), self.dtype)
        x = torch.relu(self.fc1(x))
        x = dropout.apply_channels_last(x, drop)
        return self.fc2(x)
