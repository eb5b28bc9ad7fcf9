"""Read a forward kernel's dropout mask back through identity weights.

Each probe feeds a kernel inputs and weights under which its output is
exactly the pre-scaled keep mask it applied: the LayerNorm affine is
``lng = 0, lnb = 1`` (so the normalized input is exactly 1 on every lane),
the contractions are identities and the biases zero, so every sum has one
nonzero term. A kernel's mask then compares bit for bit with
:func:`~stgcn_tpu_torch.kernels.dropout.keep_mask` of the same site.

- K1f (``head_fwd``, kt = 1, relu, the residual adds the dropped input once
  more): ``xg = 2 · mask`` of ``[B, T, 16, Vp]``;
- K3f (``ohead_fwd``, ko = 1, zero conv weight, relu): ``a = mask`` of
  ``[B, 1, 16, Vp]``;
- K4f (``ofc_fwd``, fc1 = fc2 = identity): ``out = mask`` of ``[B, 1, 16, Vp]``.
"""

from __future__ import annotations

import torch

from stgcn_tpu_torch.kernels import output_head as oh
from stgcn_tpu_torch.kernels import vertex_fused as vf
from stgcn_tpu_torch.kernels.dropout import Drop, keep_mask

C = 16   # probe width (the kernels' narrow outputs hold at most 16)


def mask_probes(drop: Drop, b: int, t: int, v_true: int, v_pad: int,
                device: torch.device | str) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
    """Per forward kernel wrapper: (the mask read back from its output, the
    plain :func:`keep_mask`). On CPU tensors the wrappers run their plain
    versions, which checks the probe itself."""
    dev = torch.device(device)

    def z(*shape):
        return torch.zeros(shape, device=dev)

    eye = torch.eye(C, device=dev)
    ones_aff, zero_aff = torch.ones(C, v_pad, device=dev), z(C, v_pad)
    out = {}

    cfg = vf.VertexBlockCfg(kt=1, ks=3, act_func="relu", graph_conv_type="cheb_graph_conv",
                            v_true=v_true, v_pad=v_pad, t_in=t, c_in=C, c0=C, c1=C, c2=C,
                            apply_ln=True)
    x = torch.randn((b, t, C, v_pad), device=dev)
    xg = vf.head_fwd(cfg, x, z(b, t, 1, 1), torch.ones(b, t, 1, 1, device=dev), zero_aff,
                     ones_aff, eye[None].contiguous(), z(C), eye, z(C), drop=drop)
    out["head_fwd"] = (xg * 0.5, keep_mask(drop, (b, t, C, v_pad), v_true, device=dev))

    ocfg = oh.OutHeadCfg(ko=1, c_in=C, c0=C, c1=C, c_end=C, act_func="relu", v_true=v_true,
                         v_pad=v_pad)
    stat0, stat1 = z(b, 1, 1, 1), torch.ones(b, 1, 1, 1, device=dev)
    plain = keep_mask(drop, (b, 1, C, v_pad), v_true, device=dev)
    a, _, _ = oh.ohead_fwd(ocfg, torch.randn((b, 1, C, v_pad), device=dev), stat0, stat1,
                           zero_aff, ones_aff, z(1, C, C), z(C), drop=drop)
    out["ohead_fwd"] = (a, plain)
    y = oh.ofc_fwd(ocfg, torch.randn((b, 1, C, v_pad), device=dev), stat0, stat1, zero_aff,
                   ones_aff, eye, z(C), eye, z(C), drop=drop)
    out["ofc_fwd"] = (y, plain)
    return out
