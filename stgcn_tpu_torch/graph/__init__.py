"""Graph preprocessing: GSO construction, normalization, Chebyshev rescale."""

from stgcn_tpu_torch.graph.gso import (  # noqa: F401
    GSO_TYPES,
    GraphShiftOperator,
    build_gso,
    calc_chebynet_gso,
    calc_gso,
    lambda_max,
    symmetrize,
)
