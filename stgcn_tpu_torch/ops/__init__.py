"""On-device graph operators."""

from stgcn_tpu_torch.ops.graph_op import (  # noqa: F401
    BandedGraphOp,
    BcsrGraphOp,
    DenseGraphOp,
    EllGraphOp,
    banded_graph_op,
    bcsr_graph_op,
    dense_graph_op,
    ell_graph_op,
    make_graph_op,
)
