"""Bandwidth-reducing vertex order for the banded graph operator (the
single-device part of ``stgcn_tpu/graph/partition.py:21-30``; the vertex
partition for several devices comes with the ``dist`` slice).

Reverse Cuthill–McKee concentrates a road graph's edges near the diagonal,
so every block row of the GSO has its nonzeros in a narrow column window:
the precondition of the banded slab pack (:mod:`stgcn_tpu_torch.kernels.
banded_spmm`).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def rcm_ordering(matrix: sp.spmatrix) -> np.ndarray:
    """Reverse Cuthill–McKee permutation (bandwidth-minimizing)."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    return np.asarray(reverse_cuthill_mckee(sp.csr_matrix(matrix), symmetric_mode=True))


def permute_matrix(matrix: sp.spmatrix, perm: np.ndarray) -> sp.csr_matrix:
    m = sp.csr_matrix(matrix)
    return m[perm][:, perm].tocsr()
