"""More of ``tests/test_torch_output_head_bwd.py``'s tests: each port test file holds at most
20 collected tests. Helpers, constants and fixtures come from there."""

import jax
import jax.numpy as jnp
import pytest
import torch

from stgcn_tpu.kernels import output_head as joh
from stgcn_tpu_torch.kernels import dropout as D
from stgcn_tpu_torch.kernels import output_head as toh
from tests.test_torch_output_head import ACTS, V_PAD, V_TRUE, _affine, _cfgs, _j, _stats
from tests.torch_parity_utils import assert_grads, t
from tests.test_torch_output_head_bwd import (
    DROPS,
    _ofc_inputs,
    _ohead_inputs,
)


@pytest.mark.parametrize("act", ["glu", "relu"])
def test_ohead_and_ofc_bwd_plain_match_jax_kernels(act):
    """Without dropout, the JAX custom VJPs run ``_ohead_pallas_bwd`` and
    ``_ofc_pallas_bwd`` themselves (interpret mode)."""
    jcfg, cfg = _cfgs(act)
    args, cot = _ohead_inputs(cfg, seed=63)
    _, vjp = jax.vjp(lambda *a: joh.ohead_fused(jcfg, jnp.int32(V_TRUE), 0, *a), *_j(args))
    got = toh.ohead_bwd(cfg, *map(t, args), *map(t, cot))
    assert_grads([g.numpy() for g in got], vjp(tuple(_j(cot))))

    args, gout = _ofc_inputs(cfg, seed=64)
    _, vjp = jax.vjp(lambda *a: joh.ofc_fused(jcfg, jnp.int32(V_TRUE), 0, *a), *_j(args))
    got = toh.ofc_bwd(cfg, *map(t, args), t(gout))
    assert_grads([g.numpy() for g in got], vjp(jnp.asarray(gout)))


@pytest.mark.parametrize("drop", sorted(DROPS))
def test_ofc_bwd_plain_takes_given_relu_decisions(drop):
    """The ``relu_mask`` of the plain version (the card check's way to hold it
    to a kernel's ReLU decisions): its own decisions give the default result
    (to f32 rounding: autograd may sum a bias gradient in another order); one
    kept unit's flipped decision moves ``da`` at that unit's lane (b, v)
    only."""
    _, cfg = _cfgs("glu")
    args, gout = _ofc_inputs(cfg, seed=71)
    args = [cfg, *map(t, args), t(gout)]
    own = (toh.ofc_preact(*args[1:8]) > 0).float()
    ref = toh.ofc_bwd_reference(*args, drop=DROPS[drop])
    same = toh.ofc_bwd_reference(*args, drop=DROPS[drop], relu_mask=own)
    for a, b in zip(ref, same):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-6 * float(a.abs().max()))
    keep = (torch.ones_like(own) if DROPS[drop] is None
            else D.keep_mask(DROPS[drop], own.shape, V_TRUE))
    b, g, v = next((b, g, v) for b, g, v in [(1, 2, 40), (0, 5, 17), (1, 7, 3), (0, 1, 90)]
                   if keep[b, 0, g, v])
    own[b, 0, g, v] = 1.0 - own[b, 0, g, v]
    moved = (toh.ofc_bwd_reference(*args, drop=DROPS[drop], relu_mask=own)[0] != same[0]).any(2)
    assert moved[b, 0, v] and int(moved.sum()) == 1
