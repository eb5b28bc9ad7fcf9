"""Parameter initializers matching the reference PyTorch distributions
(port of ``stgcn_tpu/nn/init.py``).

The reference initializes every learnable tensor with
``kaiming_uniform_(a=√5)`` and biases with ``U(±1/√fan_in)``
(``model/layers.py:136-141,187-192`` and the torch defaults inside
``nn.Conv2d`` / ``nn.Linear``). With ``a=√5`` the kaiming bound collapses to
``1/√fan_in``, so everything is ``U(±1/√fan_in)`` — with *fan_in following
torch's tensor-shape convention*, quirks included:

- temporal conv kernels: ``fan_in = kt·c_in``
- linear kernels: ``fan_in = in``
- Cheb weight ``[Ks, c_in, c_out]``: dim0 counts as output maps, dim1 as
  input maps, the rest as receptive field ⇒ ``fan_in = c_in·c_out``
- GraphConv weight ``[c_in, c_out]`` (2-D): ``fan_in = size(1) = c_out``

Draws come from an explicit ``torch.Generator`` (a CPU one, so a seed gives
the same weights on every device) and are copied to the parameter's device.
"""

from __future__ import annotations

import torch


def torch_fan_in(shape: tuple[int, ...]) -> int:
    """torch ``_calculate_fan_in_and_fan_out`` on a raw torch-shaped tensor."""
    if len(shape) < 2:
        raise ValueError("fan_in undefined for <2-D tensors")
    receptive = 1
    for s in shape[2:]:
        receptive *= s
    return shape[1] * receptive


def fan_bound(fan_in: int) -> float:
    return (1.0 / fan_in) ** 0.5 if fan_in > 0 else 0.0


@torch.no_grad()
def uniform_(param: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    """Fill ``param`` with ``U(±bound)`` drawn from ``generator``."""
    u = torch.rand(param.shape, generator=generator, dtype=torch.float32,
                   device=generator.device)
    param.copy_((u * (2.0 * bound) - bound).to(param.device, param.dtype))
