"""Weights carried between the JAX package's flax tree and the port.

The flax ``STGCN`` parameter tree (``model.init(...)["params"]``, as numpy
arrays) and the port's ``state_dict`` hold the same numbers in different
layouts:

- temporal conv kernel: flax ``[kt, 1, c_in, c_out]`` ↔ port
  ``[c_out, c_in, kt, 1]`` (``nn.Conv2d``);
- dense kernel: flax ``[in, out]`` ↔ port ``[out, in]`` (``nn.Linear``);
- LayerNorm ``scale`` ↔ ``weight``, both ``[V, C]``;
- Chebyshev / GraphConv ``weight`` and every ``bias``: unchanged.

Both directions are exact (a transpose is a copy of the same floats). A
bf16 leaf (the LayerNorm affine under ``ln_param_dtype=bfloat16``) comes in
as a torch bf16 tensor bit for bit, through its 16-bit pattern (numpy's
bf16 is a type of its own that ``torch.from_numpy`` does not take), and
goes out as float32, which holds every bf16 value exactly.
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


def _tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.ascontiguousarray(arr).copy()
    if arr.dtype.name == "bfloat16" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


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
        out[".".join([*mods, leaf])] = _tensor(arr)
    return out


def params_to_jax(module: nn.Module) -> dict:
    """Port module → flax param tree of numpy arrays."""
    tree: dict = {}
    for mname, mod in module.named_modules():
        if isinstance(mod, L.CausalConv):
            leaves = {"kernel": _array(mod.weight).transpose(2, 3, 1, 0),
                      "bias": mod.bias}
        elif isinstance(mod, nn.Linear):
            leaves = {"kernel": _array(mod.weight).T, "bias": mod.bias}
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
                v = _array(v)
            node[k] = np.ascontiguousarray(v).copy()
    return tree
