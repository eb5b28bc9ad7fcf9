"""The port's GSO pipeline (a copy of stgcn_tpu/graph/gso.py) equals the JAX
package's on synthetic road graphs and on the shipped PeMSD7(M) graph.

The sparse normalizations are compared bit for bit. The Chebyshev rescale
divides by lambda_max, an SVD / eigensolver result that multithreaded LAPACK
does not reproduce to the last bit from one call to the next (two calls of
the JAX function differ alike), so those compare at 1e-12 relative."""

import numpy as np
import pytest

from stgcn_tpu.data.synthetic import random_road_graph
from stgcn_tpu.graph import gso as jgso
from stgcn_tpu_torch.graph import gso as tgso


@pytest.mark.parametrize("gso_type", tgso.GSO_TYPES)
def test_calc_gso_equal(gso_type):
    adj = random_road_graph(90, k_neighbors=5, seed=3)
    got = tgso.calc_gso(adj, gso_type)
    ref = jgso.calc_gso(adj, gso_type)
    assert (got != ref).nnz == 0


@pytest.mark.parametrize("cheb", [True, False])
def test_build_gso_equal(cheb):
    adj = random_road_graph(150, k_neighbors=4, seed=0)
    got = tgso.build_gso(adj, "sym_norm_lap", cheb=cheb)
    ref = jgso.build_gso(adj, "sym_norm_lap", cheb=cheb)
    assert got.cheb_rescaled == ref.cheb_rescaled
    if cheb:
        np.testing.assert_allclose(got.lam_max, ref.lam_max, rtol=1e-12)
    else:
        assert got.lam_max is ref.lam_max is None
    np.testing.assert_allclose(got.to_dense(np.float64), ref.to_dense(np.float64),
                               rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("method", ["exact", "lanczos", "power"])
def test_chebynet_gso_equal(method):
    adj = random_road_graph(120, k_neighbors=4, seed=1)
    g = jgso.calc_gso(adj, "rw_norm_lap")
    got = tgso.calc_chebynet_gso(g, lambda_max_method=method)
    ref = jgso.calc_chebynet_gso(g, lambda_max_method=method)
    np.testing.assert_allclose(got.toarray(), ref.toarray(), rtol=1e-12, atol=1e-15)


def test_pemsd7_gso_equal():
    from stgcn_tpu.data import load_adj as jax_load_adj
    from stgcn_tpu_torch.data import load_adj

    adj, n = load_adj("pemsd7-m")
    jadj, jn = jax_load_adj("pemsd7-m")
    assert n == jn == 228 and (adj != jadj).nnz == 0
    np.testing.assert_allclose(tgso.build_gso(adj).to_dense(np.float64),
                               jgso.build_gso(jadj).to_dense(np.float64), rtol=1e-12, atol=1e-15)
