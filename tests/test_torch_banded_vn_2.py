"""More of ``tests/test_torch_banded_vn.py``'s tests: each port test file holds at most
20 collected tests. Helpers, constants and fixtures come from there."""

import jax.numpy as jnp
import numpy as np
import pytest

from stgcn_tpu.kernels import banded_spmm as jbs
from stgcn_tpu_torch.kernels import banded_spmm as tbs
from tests.torch_parity_utils import rand, t
from tests.test_torch_banded_vn import (
    FIELDS,
    OP_KW,
    _close,
    _ops,
)


@pytest.mark.parametrize("kind", sorted(OP_KW))
@pytest.mark.parametrize("gso_type", ["sym_norm_lap", "rw_norm_lap"])
def test_banded_graph_op_fields_equal_jax(gso_type, kind):
    """Every field of the operator exactly as the JAX one's (the nv-only
    one holds empty vn slabs, as the JAX one does); a symmetric GSO shares
    one stream pack for both directions."""
    jop, top = _ops(gso_type, bs=256, **OP_KW[kind])
    for f in FIELDS:
        got, ref = getattr(top, f), getattr(jop, f)
        assert (got is None) == (ref is None), f
        if got is not None:
            assert tuple(got.shape) == tuple(ref.shape), f
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=f)
    assert (top.v_pad, top.n_vertex, top.pair_safe, top.pair_stream, top.has_nv) == \
        (jop.v_pad, jop.n_vertex, jop.pair_safe, jop.pair_stream, jop.has_nv)
    shared = gso_type == "sym_norm_lap" and kind != "clamped"
    pack, pack_t = ("slabs_nv", "slabs_nv_t") if kind == "nv_only" else ("slabs", "slabs_t")
    assert (getattr(top, pack_t) is getattr(top, pack)) == shared


@pytest.mark.parametrize("scale", [1.0, 2.0])
@pytest.mark.parametrize("kind", ["stream", "int8", "clamped"])
def test_k7_plain_matches_jax(kind, scale):
    """K7's plain version, with and without row scales, against JAX
    ``banded_spmm(use_pallas=False)`` (its nbr·bs rows cut or padded to
    v_pad, as every caller does); the scale as the JAX op folds it, into
    the slabs or the int8 scales."""
    jop, top = _ops(bs=256, **OP_KW[kind])
    x = rand(np.random.default_rng(7), top.v_pad, 3 * 5 * 16 + 1)
    got = tbs.banded_spmm(top.slabs, top.lo, t(x), scales=top.scales, scale=scale)
    q = jop.scales is not None
    ref = jbs.banded_spmm(jop.slabs if q else jop.slabs * scale, jop.lo, jnp.asarray(x),
                          use_pallas=False, scales=jop.scales * scale if q else None)
    ref = np.asarray(ref)[:top.v_pad]
    ref = np.pad(ref, ((0, top.v_pad - ref.shape[0]), (0, 0)))
    assert got.shape == (top.v_pad, x.shape[1])
    _close(got, ref)


def test_k8_plain_matches_jax():
    """K8's plain version against JAX ``banded_cheb_pair(use_pallas=False)``
    on the clamped pack."""
    jop, top = _ops("rw_norm_lap", bs=128, **OP_KW["clamped"])
    x = rand(np.random.default_rng(8), top.v_pad, 97)
    got = tbs.banded_cheb_pair(top.slabs, top.lo, t(x))
    _close(got, jbs.banded_cheb_pair(jop.slabs, jop.lo, jnp.asarray(x), use_pallas=False))
