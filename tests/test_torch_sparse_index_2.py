"""tests/test_torch_sparse_index.py, continued (split so that each file holds
at most 20 collected tests): the packers' index on the banded packs."""

import pytest

from tests.test_torch_sparse_index import (
    BANDED,
    GRAPHS,
    check_packer_index,
)


@pytest.mark.parametrize("n_vertex,bs,gso_type", GRAPHS)
@pytest.mark.parametrize("kind", sorted(BANDED))
def test_packer_index_equals_rebuilt(kind, n_vertex, bs, gso_type):
    """``check_packer_index`` on the banded packs."""
    check_packer_index(kind, n_vertex, bs, gso_type)
