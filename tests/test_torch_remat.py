"""Per-block recompute (``STGCN(remat=True)``): the port's gradients with
remat bit-equal to those without, dropout on, float32 and bf16, on the
dense, banded (K9 pair and chain) and BCSR (K10 twice a block) operators;
within 2e-5 of the JAX ``STGCN(remat=True)`` in float32; and the graph
operator called as often with remat as without (the graph product is kept,
never replayed; on the CPU the launch counters skip the plain versions, so
a counting wrapper counts the operator's calls). V = 150 (dense) or 520
(banded, BCSR), B = 3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgcn_tpu.nn.model import STGCN as JaxSTGCN
from stgcn_tpu_torch.kernels.dropout import step_seed
from stgcn_tpu_torch.nn.convert import params_from_jax, params_to_jax
from stgcn_tpu_torch.nn.model import STGCN
from tests.test_torch_bf16 import _ops
from tests.torch_parity_utils import B, assert_grads, rand

MODEL_TOL = 2e-5   # the unfused model against JAX (tests/test_vertex_fused.py:376)


class _Counting:
    """Wraps a graph operator and counts its calls (``__call__`` and, where
    the operator has it, ``cheb_pair``)."""

    def __init__(self, op):
        self.op, self.calls = op, 0
        if hasattr(op, "cheb_pair"):
            self.cheb_pair = self._counted(op.cheb_pair)

    def _counted(self, fn):
        def call(*args, **kwargs):
            self.calls += 1
            return fn(*args, **kwargs)
        return call

    def __call__(self, *args, **kwargs):
        return self._counted(self.op)(*args, **kwargs)


def _grads(model, x, y, op, seed):
    """(loss, parameter gradients, operator calls in the forward, in the
    forward and backward, runs of the ST blocks' head and tail) of one
    training step with dropout on."""
    counted = _Counting(op)
    runs = {"head": 0, "tail": 0}
    for l in range(model.n_st_blocks):
        blk = getattr(model, f"st_block_{l}")
        for part in runs:
            def run(*a, _fn=getattr(blk, part), _part=part):
                runs[_part] += 1
                return _fn(*a)
            setattr(blk, part, run)
    params = dict(model.named_parameters())
    pred = model(torch.from_numpy(x), counted, deterministic=False, seed=seed)
    loss = ((pred - torch.from_numpy(y)) ** 2).mean()
    fwd_calls = counted.calls
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss, grads, fwd_calls, counted.calls, runs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["dense", "banded", "bcsr"])
def test_remat_gradients_equal_plain_ones(kind, dtype):
    """remat=True against remat=False on the same weights, input and
    dropout seed: the same loss and every parameter's gradient bit for bit
    (the checkpointed head and tail replay the very ops of the plain block,
    in the same autograd graph), and the operator called as often in the
    step, all of its calls in the forward (Ks = 3 on the banded operator:
    one ``cheb_pair`` a block; on the dense and BCSR ones two applications
    a block), while each block's head and tail run twice under remat (the
    forward and its replay in the backward) and once without."""
    _, op, v = _ops(kind)
    rng = np.random.default_rng(4)
    x, y = rand(rng, B, 12, v, 1), rand(rng, B, 1, v, 1)
    out = []
    for remat in (False, True):
        model = STGCN(12, v, droprate=0.5, dtype=dtype, remat=remat, device="cpu",
                      generator=torch.Generator().manual_seed(5))
        out.append(_grads(model, x, y, op, step_seed(42, 3)))
    (l0, g0, f0, c0, r0), (l1, g1, f1, c1, r1) = out
    assert r0 == {"head": 2, "tail": 2} and r1 == {"head": 4, "tail": 4}
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    per_block = 1 if kind == "banded" else 2
    assert f0 == f1 == c0 == c1 == 2 * per_block


@pytest.mark.parametrize("kind", ["dense", "banded"])
def test_remat_gradients_match_jax_remat(kind):
    """The port's remat=True model against JAX ``STGCN(remat=True)`` (its
    ``save_only_these_names("stgcn_graph_term")`` policy) in float32,
    deterministic: forward and every parameter's gradient within 2e-5."""
    jop, top, v = _ops(kind)
    rng = np.random.default_rng(6)
    x, y = rand(rng, B, 12, v, 1), rand(rng, B, 1, v, 1)
    tm = STGCN(12, v, remat=True, device="cpu", generator=torch.Generator().manual_seed(7))
    jm = JaxSTGCN(n_his=12, remat=True)

    def jloss(p):
        pred = jm.apply({"params": p}, jnp.asarray(x), jop, deterministic=True)
        return jnp.mean((pred - jnp.asarray(y)) ** 2), pred

    (_, ref), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params_to_jax(tm))
    params = dict(tm.named_parameters())
    got = tm(torch.from_numpy(x), top)
    grads = torch.autograd.grad(((got - torch.from_numpy(y)) ** 2).mean(),
                                list(params.values()))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=MODEL_TOL,
                               rtol=MODEL_TOL)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    assert_grads([g.numpy() for g in grads], [want[k].numpy() for k in params],
                 atol=MODEL_TOL)
