"""STGCN model family (port of ``stgcn_tpu/nn/model.py:21-128``).

One class covers both reference variants (`model/models.py:6-103`): the
Cheb/1st-order split is a config field. Input ``[B, n_his, V, 1]``
(channels-last), output ``[B, T_out, V, 1]`` with ``T_out = 1`` for every
valid config. The graph operator is a call argument.

The JAX model's precision and memory fields (``nn/model.py:64-69``) are
``dtype`` (None, float32; ``torch.bfloat16`` runs the layers in bf16 with
float32 parameters), ``ln_param_dtype`` (the LayerNorm affine's own type)
and ``remat`` (each ST block recomputed in its backward, the graph terms
kept: :class:`~stgcn_tpu_torch.nn.layers.STConvBlock`).
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from stgcn_tpu_torch.device import resolve_device
from stgcn_tpu_torch.kernels.dropout import Drop
from stgcn_tpu_torch.nn import layers as L


def compute_ko(n_his: int, kt: int, stblock_num: int) -> int:
    """Remaining time steps after the ST blocks (`main.py:80`)."""
    return n_his - (kt - 1) * 2 * stblock_num


def build_blocks(stblock_num: int, ko: int) -> list[list[int]]:
    """Bottleneck channel plan (`main.py:84-92`):
    ``[[1]] + N×[[64,16,64]] + ([128,128] if Ko>0 else [128]) + [[1]]``."""
    blocks: list[list[int]] = [[1]]
    for _ in range(stblock_num):
        blocks.append([64, 16, 64])
    if ko == 0:
        blocks.append([128])
    elif ko > 0:
        blocks.append([128, 128])
    else:
        raise ValueError(f"invalid config: Ko = {ko} < 0 "
                         "(n_his too small for Kt/stblock_num)")
    blocks.append([1])
    return blocks


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter of ``model`` from ``generator`` with the
    reference fan-in bounds; LayerNorms start at scale 1, bias 0."""
    for mod in model.modules():
        if isinstance(mod, (L.Linear, L.CausalConv, L.ChebGraphConv, L.GraphConv)):
            mod.reset_parameters(generator)
        elif isinstance(mod, nn.LayerNorm):
            mod.reset_parameters()


class STGCN(nn.Module):
    """Spatio-temporal GCN: ``stblock_num`` × STConvBlock + output head.

    Parameters are drawn from ``generator`` (default: a CPU generator seeded
    with 0) and live on ``device``, which defaults to ``"cuda"``. ``dtype``
    is the compute dtype (None or ``torch.float32``: float32;
    ``torch.bfloat16``: mixed precision, the parameters float32 but the
    LayerNorm affine's, which is ``ln_param_dtype``); ``remat`` recomputes
    each ST block in its backward. The output is float32 either way."""

    def __init__(self, n_his: int, n_vertex: int, kt: int = 3, ks: int = 3,
                 blocks: Sequence[Sequence[int]] | None = None, stblock_num: int = 2,
                 act_func: str = "glu", graph_conv_type: str = "cheb_graph_conv",
                 use_bias: bool = True, droprate: float = 0.5, *,
                 dtype: torch.dtype | None = None,
                 ln_param_dtype: torch.dtype = torch.float32, remat: bool = False,
                 device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        if dtype == torch.float32:
            dtype = None
        if dtype not in (None, torch.bfloat16) or ln_param_dtype not in (torch.float32,
                                                                         torch.bfloat16):
            raise ValueError(f"dtype {dtype} / ln_param_dtype {ln_param_dtype}: the model "
                             "computes in float32 or bfloat16")
        self.n_his, self.n_vertex, self.kt, self.ks = n_his, n_vertex, kt, ks
        self.stblock_num, self.act_func = stblock_num, act_func
        self.graph_conv_type, self.use_bias, self.droprate = graph_conv_type, use_bias, droprate
        self.dtype, self.ln_param_dtype, self.remat = dtype, ln_param_dtype, remat
        self.blocks = None if blocks is None else [list(b) for b in blocks]
        blocks, ko = self.plan()
        if ko == 1:
            # The reference silently returns the st-block output unchanged
            # here (`models.py:44-53` has no Ko==1 branch) — a latent bug,
            # not a capability; rejected loudly as in the JAX package.
            raise ValueError("Ko == 1 is not a valid STGCN config "
                             "(no output head can consume a single step)")
        for l in range(len(blocks) - 3):
            self.add_module(f"st_block_{l}", L.STConvBlock(
                kt, ks, n_vertex, blocks[l][-1], tuple(blocks[l + 1]), act_func,
                graph_conv_type, use_bias, device=dev, dtype=dtype,
                ln_param_dtype=ln_param_dtype, remat=remat))
        if ko > 1:
            self.output = L.OutputBlock(ko, n_vertex, blocks[-3][-1], tuple(blocks[-2]),
                                        blocks[-1][0], act_func, use_bias, device=dev,
                                        dtype=dtype, ln_param_dtype=ln_param_dtype)
        else:  # ko == 0 — fc head (`models.py:38-42,48-51`); its dropout is
            # defined there but never applied in forward — mirrored here. As in
            # the JAX model its Dense layers have no dtype: they compute in the
            # promoted type of their input and float32 weights
            self.fc1 = L.Linear(blocks[-3][-1], blocks[-2][0], bias=use_bias, device=dev)
            self.fc2 = L.Linear(blocks[-2][0], blocks[-1][0], bias=use_bias, device=dev)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_parameters(self, generator)

    def plan(self) -> tuple[list[list[int]], int]:
        ko = compute_ko(self.n_his, self.kt, self.stblock_num)
        blocks = [list(b) for b in self.blocks] if self.blocks is not None \
            else build_blocks(self.stblock_num, ko)
        return blocks, ko

    @property
    def n_st_blocks(self) -> int:
        return len(self.plan()[0]) - 3

    def forward(self, x: torch.Tensor, gop: Any, *, deterministic: bool = True,
                seed: int | None = None) -> torch.Tensor:
        """``deterministic=False`` with a nonzero droprate needs ``seed``, one
        training step's dropout seed: block ``l`` drops its LayerNorm output
        at site ``l``, the output head its fc1 output at site ``n_st_blocks``
        (:mod:`stgcn_tpu_torch.kernels.dropout`)."""
        training = not deterministic and self.droprate > 0.0
        if training and seed is None:
            raise ValueError("training with dropout needs the step's dropout seed (seed=...)")

        def drop(site: int) -> Drop | None:
            return Drop(self.droprate, seed, site) if training else None

        n_st = self.n_st_blocks
        for l in range(n_st):
            x = getattr(self, f"st_block_{l}")(x, gop, drop(l))
        if hasattr(self, "output"):
            x = self.output(x, drop(n_st))
        else:
            x = self.fc2(torch.relu(self.fc1(x)))
        return x.float()
