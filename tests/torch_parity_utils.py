"""Shared setup for the port's parity tests (tests/test_torch_*.py): the same
graph, inputs and weights fed to the JAX package and to stgcn_tpu_torch.

Inputs come from numpy seeds; weights are the JAX model's init, carried
into the port by ``nn.convert.params_from_jax``. Everything runs on CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import dataclasses

from stgcn_tpu.data.synthetic import random_road_graph
from stgcn_tpu.graph import build_gso as jax_build_gso
from stgcn_tpu.graph.partition import permute_matrix as jax_permute_matrix
from stgcn_tpu.graph.partition import rcm_ordering as jax_rcm_ordering
from stgcn_tpu.nn.model import STGCN as JaxSTGCN
from stgcn_tpu.ops import dense_graph_op as jax_dense_graph_op
from stgcn_tpu_torch.graph import build_gso, permute_matrix, rcm_ordering
from stgcn_tpu_torch.nn.convert import params_from_jax
from stgcn_tpu_torch.nn.model import STGCN
from stgcn_tpu_torch.ops import dense_graph_op

# The test suite runs in several worker processes at once; torch's default
# of one intra-op thread per core in each of them oversubscribes the CPU,
# and at these sizes one thread is as fast as eight.
torch.set_num_threads(1)

# V is not a multiple of 128, so the padded vertex lanes are exercised
V, B, T = 150, 3, 12

# the banded route's tests: 3 block rows of 256, 5 of 128, a multiple of neither
BANDED_V = 600

GATE_CASES = [
    ("cheb_graph_conv", 3, "glu"),
    ("cheb_graph_conv", 2, "gtu"),
    ("cheb_graph_conv", 1, "glu"),
    ("graph_conv", 3, "silu"),
]


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def setup_model(gct="cheb_graph_conv", ks=3, act="glu", seed=0):
    """(jax model, jax op, jax params, port model, port op, x numpy)."""
    adj = random_road_graph(V, k_neighbors=4, seed=seed)
    cheb = gct == "cheb_graph_conv"
    jop = jax_dense_graph_op(jax_build_gso(adj, "sym_norm_lap", cheb=cheb))
    top = dense_graph_op(build_gso(adj, "sym_norm_lap", cheb=cheb), device="cpu")
    jm = JaxSTGCN(n_his=T, ks=ks, graph_conv_type=gct, act_func=act)
    x = np.random.default_rng(1).standard_normal((B, T, V, 1)).astype(np.float32)
    jparams = to_np(jm.init(jax.random.PRNGKey(3), jnp.asarray(x), jop,
                            deterministic=True)["params"])
    tm = STGCN(T, V, ks=ks, graph_conv_type=gct, act_func=act, device="cpu")
    tm.load_state_dict(params_from_jax(jparams))
    return jm, jop, jparams, tm, top, x


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def t(a):
    """numpy → CPU torch tensor (a copy)."""
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def assert_grads(got, ref, atol=2e-5):
    """Each gradient (or output) within ``atol`` scaled by the largest |ref|
    of that array above 1: weight gradients and LayerNorm partial sums are
    sums over batch, time and vertices."""
    for i, (g, r) in enumerate(zip(got, ref)):
        g, r = np.asarray(g), np.asarray(r)
        assert g.shape == r.shape, (i, g.shape, r.shape)
        np.testing.assert_allclose(g, r, atol=atol * max(1.0, float(np.abs(r).max())),
                                   err_msg=f"array {i}")


def banded_gsos(gso_type="sym_norm_lap", n=BANDED_V, seed=0, cheb=True):
    """(adjacency, JAX GSO, port GSO) of one synthetic road graph, each
    RCM-ordered by its own package: the banded operator's input."""
    adj = random_road_graph(n, k_neighbors=6, seed=seed)
    jart = jax_build_gso(adj, gso_type, cheb=cheb)
    jart = dataclasses.replace(jart, matrix=jax_permute_matrix(
        jart.matrix, jax_rcm_ordering(jart.matrix)))
    tart = build_gso(adj, gso_type, cheb=cheb)
    tart = dataclasses.replace(tart, matrix=permute_matrix(tart.matrix,
                                                           rcm_ordering(tart.matrix)))
    return adj, jart, tart
