"""K3 and K4: the fused output head ('TNFF'), forward (port of
``stgcn_tpu/kernels/output_head.py``).

The reference output block (`model/layers.py:260-284`) is the previous
block's LayerNorm, a time-collapsing temporal gate, LayerNorm over (V, C),
fc1 → relu → fc2. It runs as two kernels around the (V, C)-global
statistics:

    K3 (:func:`ohead_fwd`, TPU ``_ohead_pallas``): final-ST-LN normalize →
        ko-tap temporal conv → gate (in-gate residual) → masked LN partial
        sums (Σa, Σa²)
    μ/σ from the partials (a [B, 1, 1, 1]-sized step in PyTorch)
    K4 (:func:`ofc_fwd`, TPU ``_ofc_pallas``): LN normalize + affine → fc1 →
        relu → fc2

The CUDA sources are ``csrc/output_head.cu`` (K3, and both C entry points)
and ``csrc/gate_gemm.cu`` (K4's body, shared with K1). Each wrapper runs its kernel
on a CUDA tensor and its plain version (:func:`ohead_reference`,
:func:`ofc_reference`) on a CPU tensor, and counts its launches.
"""

from __future__ import annotations

import dataclasses

import torch

from stgcn_tpu_torch.kernels import _build
from stgcn_tpu_torch.kernels._launch import (
    ACT_CODES, LANES, MAX_OUT, cuda_device, on_cpu, require, stream_of)
from stgcn_tpu_torch.kernels.vertex_fused import (
    _cdot, gate_cv, ln_normalize_cv, ln_stats, masked_ln_sums, pad_channels_cv, tconv_cv)

_CHUNK = 16     # gate channels per K3 block (csrc/common.cuh kChunk)


@dataclasses.dataclass(frozen=True)
class OutHeadCfg:
    """Static config of the fused output head."""

    ko: int              # collapsed time steps (= conv taps)
    c_in: int            # channels entering the head
    c0: int              # gate output channels (blocks[-2][0])
    c1: int              # fc1 output channels (blocks[-2][1])
    c_end: int           # final channels (blocks[-1][0], 1 in the reference)
    act_func: str
    v_true: int
    v_pad: int
    precision: str = "default"

    @property
    def gated(self) -> bool:
        return self.act_func in ("glu", "gtu")

    @property
    def g(self) -> int:
        return 2 * self.c0 if self.gated else self.c0


def ohead_reference(cfg: OutHeadCfg, x, mu, rstd, lng, lnb, ck, cb):
    """Plain version of :func:`ohead_fwd`; returns (a, ps, pss)."""
    x = ln_normalize_cv(x, mu, rstd, lng, lnb)
    s = tconv_cv(x, ck, cb, cfg.ko)                               # [B, 1, g, Vp]
    a = gate_cv(cfg.act_func, s, pad_channels_cv(x[:, cfg.ko - 1:], cfg.c0), cfg.c0)
    return (a, *masked_ln_sums(a, cfg.v_true))


def ofc_reference(cfg: OutHeadCfg, a, mu, rstd, lnw, lnb, w1, b1, w2, b2) -> torch.Tensor:
    """Plain version of :func:`ofc_fwd`: ``[B, 1, c_end, Vp]``."""
    h = ln_normalize_cv(a, mu, rstd, lnw, lnb)
    z = torch.relu(_cdot(h, w1) + b1[:, None])
    return _cdot(z, w2) + b2[:, None]


def _check_cfg(cfg: OutHeadCfg) -> None:
    if cfg.precision != "default":
        raise NotImplementedError(f"precision {cfg.precision!r}: the bf16 kernel variants "
                                  "are not ported yet")
    if cfg.act_func not in ACT_CODES:
        raise ValueError(f"unknown act_func {cfg.act_func!r}")
    if cfg.v_pad % LANES:
        raise ValueError(f"v_pad {cfg.v_pad} is not a multiple of {LANES}")
    if cfg.c_in > cfg.c0:
        raise ValueError("the fused head supports a zero-pad residual align only (c_in <= c0)")
    if cfg.c_end > MAX_OUT:
        raise ValueError(f"c_end {cfg.c_end} > {MAX_OUT}: K4 keeps fc2 outputs in registers")


def ohead_fwd(cfg: OutHeadCfg, x, mu, rstd, lng, lnb, ck, cb):
    """K3: ``x`` [B, ko, c_in, Vp] (the final ST block's pre-LN output),
    ``mu``/``rstd`` [B, ko, 1, 1], ``lng``/``lnb`` [c_in, Vp], ``ck``
    [ko, c_in, g], ``cb`` [g] → ``(a [B, 1, c0, Vp], ps, pss [B, 1, 1, 1])``."""
    _check_cfg(cfg)
    if on_cpu(x):
        return ohead_reference(cfg, x, mu, rstd, lng, lnb, ck, cb)
    dev = cuda_device(x)
    b = x.shape[0]
    stat, aff = (b, cfg.ko, 1, 1), (cfg.c_in, cfg.v_pad)
    ptrs = [require(x, "x", (b, cfg.ko, cfg.c_in, cfg.v_pad), dev),
            require(mu, "mu", stat, dev), require(rstd, "rstd", stat, dev),
            require(lng, "lng", aff, dev), require(lnb, "lnb", aff, dev),
            require(ck, "ck", (cfg.ko, cfg.c_in, cfg.g), dev),
            require(cb, "cb", (cfg.g,), dev)]
    a = torch.empty((b, 1, cfg.c0, cfg.v_pad), device=dev, dtype=torch.float32)
    nch = -(-cfg.c0 // _CHUNK)
    part = torch.empty((b, nch, cfg.v_pad // LANES, 2), device=dev, dtype=torch.float32)
    ps = torch.empty((b, 1, 1, 1), device=dev, dtype=torch.float32)
    pss = torch.empty_like(ps)
    err = _build.library().stgcn_ohead_fwd(
        *ptrs, a.data_ptr(), part.data_ptr(), ps.data_ptr(), pss.data_ptr(),
        b, cfg.ko, cfg.c_in, cfg.v_pad, cfg.c0, ACT_CODES[cfg.act_func], cfg.v_true,
        stream_of(dev))
    _build.check("ohead_fwd", err)
    ohead_fwd.launches += 1
    return a, ps, pss


ohead_fwd.launches = 0


def ofc_fwd(cfg: OutHeadCfg, a, mu, rstd, lnw, lnb, w1, b1, w2, b2) -> torch.Tensor:
    """K4: ``a`` [B, 1, c0, Vp], ``mu``/``rstd`` [B, 1, 1, 1], ``lnw``/``lnb``
    [c0, Vp], ``w1`` [c0, c1], ``b1`` [c1], ``w2`` [c1, c_end], ``b2``
    [c_end] → ``[B, 1, c_end, Vp]``."""
    _check_cfg(cfg)
    if on_cpu(a):
        return ofc_reference(cfg, a, mu, rstd, lnw, lnb, w1, b1, w2, b2)
    dev = cuda_device(a)
    b = a.shape[0]
    stat, aff = (b, 1, 1, 1), (cfg.c0, cfg.v_pad)
    ptrs = [require(a, "a", (b, 1, cfg.c0, cfg.v_pad), dev),
            require(mu, "mu", stat, dev), require(rstd, "rstd", stat, dev),
            require(lnw, "lnw", aff, dev), require(lnb, "lnb", aff, dev),
            require(w1, "w1", (cfg.c0, cfg.c1), dev), require(b1, "b1", (cfg.c1,), dev),
            require(w2, "w2", (cfg.c1, cfg.c_end), dev), require(b2, "b2", (cfg.c_end,), dev)]
    out = torch.empty((b, 1, cfg.c_end, cfg.v_pad), device=dev, dtype=torch.float32)
    err = _build.library().stgcn_ofc_fwd(
        *ptrs, out.data_ptr(), b, cfg.c0, cfg.c1, cfg.c_end, cfg.v_pad, stream_of(dev))
    _build.check("ofc_fwd", err)
    ofc_fwd.launches += 1
    return out


ofc_fwd.launches = 0


def output_head_fused(params: dict, a2, mu, rstd, lng_p, lnb_p, *, v_true: int,
                      act_func: str) -> torch.Tensor:
    """The whole output head on the cv-layout pre-LN activation of the final
    ST block. ``params``: the output block's entries of the port's
    ``state_dict`` with the ``output.`` prefix removed. ``a2`` [B, ko, C, Vp];
    ``mu``/``rstd`` [B, ko, 1, 1]; ``lng_p``/``lnb_p`` [C, Vp] (the final
    block's LN affine, zero-padded). Returns [B, 1, Vp, c_end]."""
    b, ko, c_in, v_pad = a2.shape
    conv_w = params["tmp_conv1.causal_conv.weight"]          # [g, c_in, ko, 1]
    ck = conv_w[..., 0].permute(2, 1, 0).contiguous()         # [ko, c_in, g]
    g = ck.shape[-1]
    c0 = g // 2 if act_func in ("glu", "gtu") else g
    w1 = params["fc1.weight"].T.contiguous()
    w2 = params["fc2.weight"].T.contiguous()
    b1 = params.get("fc1.bias", torch.zeros(w1.shape[1], device=a2.device))
    b2 = params.get("fc2.bias", torch.zeros(w2.shape[1], device=a2.device))
    cfg = OutHeadCfg(ko=ko, c_in=c_in, c0=c0, c1=w1.shape[1], c_end=w2.shape[1],
                     act_func=act_func, v_true=v_true, v_pad=v_pad)
    pad_v = (0, 0, 0, v_pad - params["ln.weight"].shape[0])
    lnw = torch.nn.functional.pad(params["ln.weight"], pad_v).T.contiguous()
    lnb = torch.nn.functional.pad(params["ln.bias"], pad_v).T.contiguous()

    a, ps, pss = ohead_fwd(cfg, a2, mu, rstd, lng_p, lnb_p, ck,
                           params["tmp_conv1.causal_conv.bias"])
    mu2, rstd2 = ln_stats(ps, pss, v_true * c0)
    out = ofc_fwd(cfg, a, mu2, rstd2, lnw, lnb, w1, b1.contiguous(), w2, b2.contiguous())
    return out.permute(0, 1, 3, 2)  # [B, 1, Vp, c_end]
