"""The port's optimizers and StepLR against stgcn_tpu.train.optim: the same
parameters and gradient sequence (numpy seeds) give the same parameters
after every one of 5 steps, within 1e-6 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stgcn_tpu.train import optim as jopt
from stgcn_tpu_torch.train import optim as topt

SHAPES = {"w": (4, 3), "b": (3,), "k": (2, 3, 5)}
STEPS = 5


def _params(rng):
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}


def _run_jax(tx, p0, grads):
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(params)
    out = []
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, upd)
        out.append({k: np.asarray(v) for k, v in params.items()})
    return out


def _run_torch(tx, p0, grads):
    params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    state = tx.init(params)
    out = []
    for g in grads:
        upd, state = tx.update({k: torch.from_numpy(v) for k, v in g.items()}, state, params)
        topt.apply_updates(params, upd)
        out.append({k: v.numpy().copy() for k, v in params.items()})
    return out


@pytest.mark.parametrize("name", sorted(topt.OPTIMIZERS))
def test_optimizer_matches_jax_for_five_steps(name):
    rng = np.random.default_rng(7)
    p0 = _params(rng)
    grads = [_params(rng) for _ in range(STEPS)]
    # StepLR with a decay inside the 5 steps: lr(count - 1) must line up
    jlr = jopt.make_step_lr(1e-2, 2, 0.5, steps_per_epoch=1)
    tlr = topt.make_step_lr(1e-2, 2, 0.5, steps_per_epoch=1)
    ref = _run_jax(jopt.make_optimizer(name, lr=jlr, weight_decay=1e-2), p0, grads)
    got = _run_torch(topt.make_optimizer(name, lr=tlr, weight_decay=1e-2), p0, grads)
    for step, (g, r) in enumerate(zip(got, ref)):
        for k in SHAPES:
            np.testing.assert_allclose(g[k], r[k], rtol=1e-6, atol=0, err_msg=f"{k} @ {step}")


def test_lion_with_bf16_momentum_matches_jax():
    rng = np.random.default_rng(8)
    p0 = _params(rng)
    grads = [_params(rng) for _ in range(STEPS)]
    ref = _run_jax(jopt.lion(1e-2, mu_dtype=jnp.bfloat16), p0, grads)
    got = _run_torch(topt.lion(1e-2, mu_dtype=torch.bfloat16), p0, grads)
    for g, r in zip(got, ref):
        for k in SHAPES:
            np.testing.assert_allclose(g[k], r[k], rtol=1e-6, atol=0)


def test_step_lr_matches_jax():
    j = jopt.make_step_lr(1e-3, 10, 0.95, steps_per_epoch=7)
    t = topt.make_step_lr(1e-3, 10, 0.95, steps_per_epoch=7)
    for step in (0, 6, 7, 69, 70, 71, 700, 1399, 1400):
        assert float(t(step)) == float(jax.device_get(j(step))), step


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="undefined"):
        topt.make_optimizer("sgd", lr=1e-3, weight_decay=0.0)
