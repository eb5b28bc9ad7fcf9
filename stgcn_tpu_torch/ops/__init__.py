"""On-device graph operators."""

from stgcn_tpu_torch.ops.graph_op import (  # noqa: F401
    DenseGraphOp,
    dense_graph_op,
    make_graph_op,
)
