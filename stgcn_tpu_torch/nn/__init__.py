"""Neural-network layers, the STGCN model and its fused forward."""

from stgcn_tpu_torch.nn.layers import (  # noqa: F401
    Align,
    CausalConv,
    ChebGraphConv,
    GraphConv,
    GraphConvLayer,
    OutputBlock,
    STConvBlock,
    TemporalConvLayer,
)
from stgcn_tpu_torch.nn.model import STGCN, build_blocks, compute_ko  # noqa: F401
from stgcn_tpu_torch.nn.fused import fused_forward  # noqa: F401
