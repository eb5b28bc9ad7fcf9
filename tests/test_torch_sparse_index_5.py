"""tests/test_torch_sparse_index.py, continued (split so that each file holds
at most 20 collected tests): an edit through ``.data``, seen only after
``invalidate()``."""

import pytest
import torch

from stgcn_tpu_torch.kernels import nnz_index
from tests.test_torch_sparse_index import (
    KINDS,
    TOL,
    _current,
    _index_product,
    _op,
    _reference,
    _x,
    _zero_entry,
)


@pytest.mark.parametrize("kind", KINDS)
def test_data_edit_is_seen_only_after_invalidate(kind):
    """The index follows the version counter of the tiles tensor: an edit
    through ``pack.data.data`` does not move it, so the index stays as it
    was (the documented limit) until ``invalidate()``, after which the next
    launch rebuilds it once and the product follows the new value."""
    op = _op(kind, 600, 64, "sym_norm_lap")
    pack = op.pack
    x = _x(pack, 33)
    _current(pack)
    before, nnz = nnz_index.builds(), pack.index.nnz
    pack.data.data[_zero_entry(pack)] = 3 if pack.data.dtype == torch.int8 else 0.5
    _current(pack)
    assert nnz_index.builds() == before and pack.index.nnz == nnz
    pack.index.invalidate()
    torch.testing.assert_close(_index_product(pack, x), _reference(pack, x), **TOL)
    assert nnz_index.builds() == before + 1 and pack.index.nnz == nnz + 1
