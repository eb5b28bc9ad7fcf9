"""Weights carried between the JAX package's flax tree and the port.

The flax ``STGCN`` parameter tree (``model.init(...)["params"]``, as numpy
arrays) and the port's ``state_dict`` hold the same numbers in different
layouts:

- temporal conv kernel: flax ``[kt, 1, c_in, c_out]`` ↔ port
  ``[c_out, c_in, kt, 1]`` (``nn.Conv2d``);
- dense kernel: flax ``[in, out]`` ↔ port ``[out, in]`` (``nn.Linear``);
- LayerNorm ``scale`` ↔ ``weight``, both ``[V, C]``;
- Chebyshev / GraphConv ``weight`` and every ``bias``: unchanged.

Both directions are exact (a transpose is a copy of the same floats).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from stgcn_tpu_torch.nn import layers as L


def _flatten(tree: dict, prefix: tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """flax param tree (nested dicts of arrays) → port ``state_dict``."""
    out = {}
    for path, arr in _flatten(tree):
        *mods, leaf = path
        if leaf == "kernel" and arr.ndim == 4:
            arr, leaf = arr.transpose(3, 2, 0, 1), "weight"
        elif leaf == "kernel":
            arr, leaf = arr.T, "weight"
        elif leaf == "scale":
            leaf = "weight"
        out[".".join([*mods, leaf])] = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return out


def params_to_jax(module: nn.Module) -> dict:
    """Port module → flax param tree of numpy arrays."""
    tree: dict = {}
    for mname, mod in module.named_modules():
        if isinstance(mod, L.CausalConv):
            leaves = {"kernel": mod.weight.detach().cpu().numpy().transpose(2, 3, 1, 0),
                      "bias": mod.bias}
        elif isinstance(mod, nn.Linear):
            leaves = {"kernel": mod.weight.detach().cpu().numpy().T, "bias": mod.bias}
        elif isinstance(mod, nn.LayerNorm):
            leaves = {"scale": mod.weight, "bias": mod.bias}
        elif isinstance(mod, (L.ChebGraphConv, L.GraphConv)):
            leaves = {"weight": mod.weight, "bias": mod.bias}
        else:
            continue
        node = tree
        for part in mname.split("."):
            node = node.setdefault(part, {})
        for k, v in leaves.items():
            if v is None:
                continue
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            node[k] = np.ascontiguousarray(v).copy()
    return tree
