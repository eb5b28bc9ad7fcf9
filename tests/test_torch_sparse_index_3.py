"""tests/test_torch_sparse_index.py, continued (split so that each file holds
at most 20 collected tests): a product over the index on the tile packs, and a
dense tile."""

import numpy as np
import pytest
import torch

from tests.test_torch_sparse_index import (
    BANDED,
    GRAPHS,
    KINDS,
    TILE_KINDS,
    TOL,
    _index_product,
    _op,
    _reference,
    _x,
    check_index_product,
)


@pytest.mark.parametrize("n_vertex,bs,gso_type", GRAPHS)
@pytest.mark.parametrize("kind", TILE_KINDS)
def test_index_product_matches_plain_and_jax(kind, n_vertex, bs, gso_type):
    """``check_index_product`` on the tile packs (the banded ones:
    ``tests/test_torch_sparse_index_4.py``)."""
    check_index_product(kind, n_vertex, bs, gso_type)


@pytest.mark.parametrize("kind", KINDS)
def test_dense_tile(kind):
    """A fully dense live tile (or a slab whose whole window is nonzero)
    goes through the same index: bs² nonzeros of one tile (bs·w of the
    slab), and the product still equals the plain version."""
    op = _op(kind, 200, 64, "rw_norm_lap")
    pack = op.pack
    rng = np.random.default_rng(9)
    shape = tuple(pack.data.shape[1:] if kind in BANDED else (64, 64))
    int8 = pack.data.dtype == torch.int8
    fill = rng.integers(1, 100, shape) if int8 else rng.uniform(0.1, 1, shape)
    with torch.no_grad():
        pack.data[(1,) if kind in BANDED else (1, 0)] = torch.from_numpy(fill).to(pack.data.dtype)
    x = _x(pack, 20)
    torch.testing.assert_close(_index_product(pack, x), _reference(pack, x), **TOL)
    rows = pack.index.row_ptr.diff()[64:128]
    assert int(rows.min()) >= (pack.w if kind in BANDED else 64)
