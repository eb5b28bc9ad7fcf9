"""Optimizers and the StepLR schedule (port of ``stgcn_tpu/train/optim.py``).

Functional updates over named parameters, in the JAX package's order, so
a fixed-seed trajectory matches it step for step: ``update(grads, state,
params)`` returns the updates to add and the new state, with the learning
rate of step ``count - 1`` and the decoupled weight decay added inside the
step. The state is a dict of tensors (``torch.save``-able):

- ``adamw``  — torch ``optim.AdamW`` semantics (`main.py:148`);
- ``nadamw`` — torch ``optim.NAdam(decoupled_weight_decay=True)``
  (`main.py:150`), with torch's ``momentum_decay`` μ-product schedule;
- ``lion``   — the reference's Lion (`script/opt.py:10-76`); ``mu_dtype``
  stores the momentum narrower;
- ``tiger``  — the reference's Tiger (`script/opt.py:79-145`), whose momentum
  buffer is never written back (so it is sign-SGD), kept as it is;
  ``tiger_fixed`` applies the intended update;
- ``make_step_lr`` — ``StepLR(step_size, gamma)`` stepped once per epoch
  (`main.py:156,172`).

Scalars (learning rate, bias corrections) are float32 tensors, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

Params = dict[str, torch.Tensor]
_F32 = torch.float32


def _scalar(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=_F32, device=device)


def _lr(learning_rate, count: int, device) -> torch.Tensor:
    lr = learning_rate(count - 1) if callable(learning_rate) else learning_rate
    return _scalar(lr, device)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """An optax-style pair: ``init(params) -> state`` and
    ``update(grads, state, params) -> (updates, state)``."""

    init: Callable[[Params], dict]
    update: Callable[[Params, dict, Params], tuple[Params, dict]]


def apply_updates(params: Params, updates: Params) -> None:
    """``p += u`` in place, as ``optax.apply_updates`` computes ``p + u``."""
    with torch.no_grad():
        for k, p in params.items():
            p.add_(updates[k])


def _zeros(params: Params, dtype=None) -> Params:
    return {k: torch.zeros_like(p, dtype=dtype or p.dtype) for k, p in params.items()}


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-3) -> Optimizer:
    def init(params):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    @torch.no_grad()
    def update(grads, state, params):
        count = state["count"] + 1
        dev = next(iter(params.values())).device
        mu = {k: b1 * m + (1 - b1) * grads[k] for k, m in state["mu"].items()}
        nu = {k: b2 * v + (1 - b2) * grads[k] * grads[k] for k, v in state["nu"].items()}
        t = _scalar(count, dev)
        c1 = 1 - torch.pow(_scalar(b1, dev), t)
        c2 = 1 - torch.pow(_scalar(b2, dev), t)
        lr = _lr(learning_rate, count, dev)
        upd = {}
        for k, p in params.items():
            step = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
            upd[k] = -lr * (step + weight_decay * p)
        return upd, {"count": count, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def nadamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-3,
           momentum_decay=4e-3) -> Optimizer:
    """torch NAdam with decoupled weight decay, μ-product schedule included."""

    def init(params):
        dev = next(iter(params.values())).device
        return {"count": 0, "mu_prod": _scalar(1.0, dev), "mu": _zeros(params),
                "nu": _zeros(params)}

    @torch.no_grad()
    def update(grads, state, params):
        count = state["count"] + 1
        dev = next(iter(params.values())).device
        t = _scalar(count, dev)
        mu_t = b1 * (1 - 0.5 * torch.pow(_scalar(0.96, dev), t * momentum_decay))
        mu_next = b1 * (1 - 0.5 * torch.pow(_scalar(0.96, dev), (t + 1) * momentum_decay))
        mu_prod = state["mu_prod"] * mu_t
        mu = {k: b1 * m + (1 - b1) * grads[k] for k, m in state["mu"].items()}
        nu = {k: b2 * v + (1 - b2) * grads[k] * grads[k] for k, v in state["nu"].items()}
        c2 = 1 - torch.pow(_scalar(b2, dev), t)
        lr = _lr(learning_rate, count, dev)
        upd = {}
        for k, p in params.items():
            denom = torch.sqrt(nu[k] / c2) + eps
            step = ((1 - mu_t) / (1 - mu_prod)) * grads[k] / denom \
                + (mu_next / (1 - mu_prod * mu_next)) * mu[k] / denom
            upd[k] = -lr * (step + weight_decay * p)
        return upd, {"count": count, "mu_prod": mu_prod, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def lion(learning_rate, b1=0.9, b2=0.99, weight_decay=1e-3, mu_dtype=None) -> Optimizer:
    """Sign-momentum Lion, reference order: decay → sign step → momentum
    update (`opt.py:56,69-74`)."""

    def init(params):
        return {"count": 0, "mu": _zeros(params, mu_dtype)}

    @torch.no_grad()
    def update(grads, state, params):
        count = state["count"] + 1
        dev = next(iter(params.values())).device
        lr = _lr(learning_rate, count, dev)
        upd = {}
        for k, p in params.items():
            g, m = grads[k], state["mu"][k]
            upd[k] = -lr * (torch.sign(b1 * m.to(g.dtype) + (1 - b1) * g) + weight_decay * p)
        mu = {k: (b2 * m.to(grads[k].dtype) + (1 - b2) * grads[k]).to(m.dtype)
              for k, m in state["mu"].items()}
        return upd, {"count": count, "mu": mu}

    return Optimizer(init, update)


def tiger(learning_rate, beta=0.965, weight_decay=1e-3, *, fixed=False) -> Optimizer:
    """Tiger (`opt.py:79-145`). The reference never updates ``exp_avg``
    (momentum stays zero, so it is sign-SGD); ``fixed=True`` applies the
    intended EMA update."""

    def init(params):
        return {"count": 0, "mu": _zeros(params)}

    @torch.no_grad()
    def update(grads, state, params):
        count = state["count"] + 1
        dev = next(iter(params.values())).device
        lr = _lr(learning_rate, count, dev)
        upd = {k: -lr * (torch.sign(beta * state["mu"][k] + (1 - beta) * grads[k])
                         + weight_decay * p) for k, p in params.items()}
        if fixed:
            mu = {k: beta * m + (1 - beta) * grads[k] for k, m in state["mu"].items()}
        else:
            mu = state["mu"]  # the reference's bug kept: exp_avg is never written back
        return upd, {"count": count, "mu": mu}

    return Optimizer(init, update)


def tiger_fixed(learning_rate, beta=0.965, weight_decay=1e-3) -> Optimizer:
    return tiger(learning_rate, beta, weight_decay, fixed=True)


OPTIMIZERS = {"adamw": adamw, "nadamw": nadamw, "lion": lion, "tiger": tiger,
              "tiger_fixed": tiger_fixed}


def make_step_lr(base_lr: float, step_size: int, gamma: float, steps_per_epoch: int):
    """StepLR stepped per epoch, as a per-step schedule returning float32."""

    def schedule(step: int) -> torch.Tensor:
        epoch = step // steps_per_epoch
        return base_lr * torch.pow(_scalar(gamma, "cpu"), _scalar(epoch // step_size, "cpu"))

    return schedule


def make_optimizer(name: str, *, lr, weight_decay: float) -> Optimizer:
    """Optimizer factory with the reference's dispatch table (`main.py:147-154`,
    extended with tiger / tiger_fixed)."""
    try:
        factory = OPTIMIZERS[name]
    except KeyError:
        raise ValueError(f"the {name!r} optimizer is undefined; "
                         f"expected one of {sorted(OPTIMIZERS)}") from None
    return factory(lr, weight_decay=weight_decay)
