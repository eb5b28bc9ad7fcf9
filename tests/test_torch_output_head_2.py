"""More of ``tests/test_torch_output_head.py``'s tests: each port test file holds at most
20 collected tests. Helpers, constants and fixtures come from there."""

import jax.numpy as jnp
import numpy as np
import pytest

from stgcn_tpu.nn.fused import _output_block_apply_cv as jax_output_block_apply_cv
from stgcn_tpu_torch.kernels import output_head as toh
from stgcn_tpu_torch.nn.convert import params_from_jax
from stgcn_tpu_torch.nn.fused import _output_block_apply_cv
from tests.torch_parity_utils import B, rand, t
from tests.test_torch_output_head import (
    ATOL,
    V_PAD,
    V_TRUE,
    _affine,
    _cfgs,
    _head_params,
    _stats,
)


@pytest.mark.parametrize("act,c_in", [("glu", 16), ("gtu", 32), ("relu", 16), ("silu", 8)])
def test_output_head_fused_matches_cv_oracles(act, c_in):
    """K3 → μ/σ → K4 (plain versions) equals the unfused cv head of both
    packages on the normalized input, at the true vertices."""
    jcfg, cfg = _cfgs(act, c_in)
    rng = np.random.default_rng(33)
    jp = _head_params(rng, cfg)
    a2 = rand(rng, B, cfg.ko, cfg.c_in, V_PAD)
    mu, rstd = _stats(rng, cfg.ko)
    lng, lnb = _affine(rng, cfg.c_in)
    got = toh.output_head_fused(params_from_jax(jp), t(a2), t(mu), t(rstd), t(lng), t(lnb),
                                v_true=V_TRUE, act_func=act)
    assert got.shape == (B, 1, V_PAD, cfg.c_end)
    y = (a2 - mu) * rstd * lng + lnb                  # the block's LN, as the path applies it
    ref_t = _output_block_apply_cv(params_from_jax(jp), t(y), V_TRUE, act_func=act)
    ref_j = np.asarray(jax_output_block_apply_cv(jp, jnp.asarray(y), V_TRUE, act_func=act,
                                                 droprate=0.5, deterministic=True, rng=None))
    np.testing.assert_allclose(ref_t.numpy(), ref_j, atol=ATOL)
    np.testing.assert_allclose(got[:, :, :V_TRUE].numpy(), ref_j, atol=ATOL)
