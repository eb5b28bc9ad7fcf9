"""Graph preprocessing: GSO construction, normalization, Chebyshev rescale,
and the RCM vertex order of the banded operator."""

from stgcn_tpu_torch.graph.gso import (  # noqa: F401
    GSO_TYPES,
    GraphShiftOperator,
    build_gso,
    calc_chebynet_gso,
    calc_gso,
    lambda_max,
    symmetrize,
)
from stgcn_tpu_torch.graph.partition import permute_matrix, rcm_ordering  # noqa: F401
