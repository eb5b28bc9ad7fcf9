"""tests/test_torch_sparse_index.py, continued (split so that each file holds
at most 20 collected tests): a product over the index on the banded packs."""

import pytest

from tests.test_torch_sparse_index import (
    BANDED,
    GRAPHS,
    check_index_product,
)


@pytest.mark.parametrize("n_vertex,bs,gso_type", GRAPHS)
@pytest.mark.parametrize("kind", sorted(BANDED))
def test_index_product_matches_plain_and_jax(kind, n_vertex, bs, gso_type):
    """``check_index_product`` on the banded packs."""
    check_index_product(kind, n_vertex, bs, gso_type)
