"""K3 and K4: the fused output head ('TNFF'), forward and backward (port of
``stgcn_tpu/kernels/output_head.py``).

The reference output block (`model/layers.py:260-284`) is the previous
block's LayerNorm, a time-collapsing temporal gate, LayerNorm over (V, C),
fc1 → relu → fc2. It runs as two kernels around the (V, C)-global
statistics:

    K3 (:func:`ohead_fwd`, TPU ``_ohead_pallas``): final-ST-LN normalize +
        dropout → ko-tap temporal conv → gate (in-gate residual) → masked LN
        partial sums (Σa, Σa²)
    μ/σ from the partials (a [B, 1, 1, 1]-sized step in PyTorch)
    K4 (:func:`ofc_fwd`, TPU ``_ofc_pallas``): LN normalize + affine → fc1 →
        relu → dropout → fc2

with the recompute-based backward kernels :func:`ohead_bwd` (K3b) and
:func:`ofc_bwd` (K4b) behind the autograd Functions :func:`ohead_fused` and
:func:`ofc_fused`. Dropout masks are keyed by element (:mod:`.dropout`).

The CUDA sources are ``csrc/output_head.cu`` (both forward entry points),
``csrc/gate_gemm.cu`` (the body of K3 and K4, shared with K1: the conv or
fc1 on the register tile of ``csrc/f32_tile.cuh``, the LayerNorm and the
input mask applied as its input is staged; K3's epilogue the gate, ``a``
and the LayerNorm partial sums per (b, pass, 64-lane tile), summed in a
fixed order by a second pass; K4's the ReLU, dropout and fc2) and
``csrc/output_head_bwd.cu`` over ``csrc/bwd_blocks.cu`` (K3b, K4b: each
recomputes its product with the gate backward in one gate pass, K4b's fc1
with its dropout, ReLU and dw2 / db1 partials; their data gradients and
weight gradients run on the same tile). Each
wrapper runs its kernel on a CUDA tensor and its plain version (``*_reference``;
the backward ones are autograd through the forward ones) on a CPU tensor,
and counts its launches.

``OutHeadCfg(precision="bfloat16")`` selects K3's and K4's bf16 variants
(``ohead_fwd_bf16``, ``ofc_fwd_bf16``), rounding as the TPU's bf16 kernels
do (``stgcn_tpu/kernels/output_head.py:127-159``, ``:327-348``): K3 as K1
(:mod:`.vertex_fused`), ``a`` stored in bf16 and its partial sums in
float32; K4's LayerNorm output and fc1 → ReLU rounded to bf16, the mask a
bf16 product, fc2 summed in float32 and left in float32. Their backward
raises ``NotImplementedError`` until fused training in bf16 is ported.
"""

from __future__ import annotations

import dataclasses

import torch

from stgcn_tpu_torch.kernels import _build, dropout
from stgcn_tpu_torch.kernels._launch import (
    ACT_CODES, GATE_PASS, LANES, MAX_OUT, TILE_LANES, count_launch, cuda_device, drop_args,
    on_cpu, require, stream_of, workspace)
from stgcn_tpu_torch.kernels.dropout import Drop
from stgcn_tpu_torch.kernels.vertex_fused import (
    BF16, PRECISIONS, _cdot, gate_cv, launch_name, linear_cv, ln_normalize_cv, ln_stats,
    masked_ln_sums, pad_channels_cv, refuse_bf16_bwd, tconv_cv)


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

    @property
    def dtype(self) -> torch.dtype:
        """The activations' and weights' type: bf16 for the bf16 variants."""
        return BF16 if self.precision == "bfloat16" else torch.float32


def ohead_reference(cfg: OutHeadCfg, x, mu, rstd, lng, lnb, ck, cb,
                    drop: Drop | None = None):
    """Plain version of :func:`ohead_fwd`; returns (a, ps, pss)."""
    x = dropout.apply_cv(ln_normalize_cv(x, mu, rstd, lng, lnb), drop, cfg.v_true)
    s = tconv_cv(x, ck, cb, cfg.ko)                               # [B, 1, g, Vp]
    a = gate_cv(cfg.act_func, s, pad_channels_cv(x[:, cfg.ko - 1:], cfg.c0), cfg.c0)
    return (a, *masked_ln_sums(a, cfg.v_true))


def ofc_preact(a, mu, rstd, lnw, lnb, w1, b1) -> torch.Tensor:
    """The input of fc1's ReLU, ``[B, 1, c1, Vp]``; bf16 for a bf16 ``a``
    (the LayerNorm output and the product plus bias each rounded)."""
    return linear_cv(ln_normalize_cv(a, mu, rstd, lnw, lnb), w1, b1)


def ofc_reference(cfg: OutHeadCfg, a, mu, rstd, lnw, lnb, w1, b1, w2, b2,
                  drop: Drop | None = None, relu_mask=None) -> torch.Tensor:
    """Plain version of :func:`ofc_fwd`: ``[B, 1, c_end, Vp]``. ``relu_mask``
    (1 where the ReLU passes, shaped as :func:`ofc_preact`) replaces the
    ReLU's own decisions when given."""
    z = ofc_preact(a, mu, rstd, lnw, lnb, w1, b1)
    return ofc_out(cfg, torch.relu(z) if relu_mask is None else z * relu_mask, w2, b2, drop)


def ofc_out(cfg: OutHeadCfg, h, w2, b2, drop: Drop | None = None) -> torch.Tensor:
    """fc1's ReLU output ``h`` → dropout → fc2: ``[B, 1, c_end, Vp]``, float32
    (for a bf16 ``h`` the mask a bf16 product and fc2's float32 sums left
    unrounded, `_make_ofc_fwd_kernel`, ``output_head.py:335-348``)."""
    return _cdot(dropout.apply_cv(h, drop, cfg.v_true).float(), w2.float()) + b2[:, None]


def _grad_reference(fn, ins, couts):
    """Autograd of ``fn(*ins)`` for the output cotangents ``couts``."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in ins]
        outs = fn(*ins)
        g = torch.autograd.grad(outs, ins, couts, allow_unused=True)
    return tuple(torch.zeros_like(t) if d is None else d for t, d in zip(ins, g))


def ohead_bwd_reference(cfg: OutHeadCfg, x, mu, rstd, lng, lnb, ck, cb, ga, gps, gpss,
                        drop: Drop | None = None):
    """Plain version of :func:`ohead_bwd`: autograd through :func:`ohead_reference`."""
    return _grad_reference(lambda *t: ohead_reference(cfg, *t, drop=drop),
                           (x, mu, rstd, lng, lnb, ck, cb), (ga, gps, gpss))


def ofc_bwd_reference(cfg: OutHeadCfg, a, mu, rstd, lnw, lnb, w1, b1, w2, b2, gout,
                      drop: Drop | None = None, relu_mask=None):
    """Plain version of :func:`ofc_bwd`: autograd through :func:`ofc_reference`
    (with ``relu_mask`` as there)."""
    return _grad_reference(lambda *t: ofc_reference(cfg, *t, drop=drop, relu_mask=relu_mask),
                           (a, mu, rstd, lnw, lnb, w1, b1, w2, b2), gout)


def _check_cfg(cfg: OutHeadCfg) -> None:
    if cfg.precision not in PRECISIONS:
        raise ValueError(f"precision {cfg.precision!r}: one of {PRECISIONS}")
    if cfg.act_func not in ACT_CODES:
        raise ValueError(f"unknown act_func {cfg.act_func!r}")
    if cfg.v_pad % LANES:
        raise ValueError(f"v_pad {cfg.v_pad} is not a multiple of {LANES}")
    if cfg.c_in > cfg.c0:
        raise ValueError("the fused head supports a zero-pad residual align only (c_in <= c0)")
    if cfg.c_end > MAX_OUT:
        raise ValueError(f"c_end {cfg.c_end} > {MAX_OUT}: K4 keeps fc2 outputs in registers")


def ohead_fwd(cfg: OutHeadCfg, x, mu, rstd, lng, lnb, ck, cb, *, drop: Drop | None = None):
    """K3: ``x`` [B, ko, c_in, Vp] (the final ST block's pre-LN output),
    ``mu``/``rstd`` [B, ko, 1, 1], ``lng``/``lnb`` [c_in, Vp], ``ck``
    [ko, c_in, g], ``cb`` [g] → ``(a [B, 1, c0, Vp], ps, pss [B, 1, 1, 1])``.
    ``drop`` drops out the normalized input (training)."""
    _check_cfg(cfg)
    if on_cpu(x):
        return ohead_reference(cfg, x, mu, rstd, lng, lnb, ck, cb, drop)
    dev = cuda_device(x)
    b, cdt = x.shape[0], cfg.dtype
    stat, aff = (b, cfg.ko, 1, 1), (cfg.c_in, cfg.v_pad)
    ptrs = [require(x, "x", (b, cfg.ko, cfg.c_in, cfg.v_pad), dev, cdt),
            require(mu, "mu", stat, dev), require(rstd, "rstd", stat, dev),
            require(lng, "lng", aff, dev, cdt), require(lnb, "lnb", aff, dev, cdt),
            require(ck, "ck", (cfg.ko, cfg.c_in, cfg.g), dev, cdt),
            require(cb, "cb", (cfg.g,), dev)]
    a = torch.empty((b, 1, cfg.c0, cfg.v_pad), device=dev, dtype=cdt)
    part = torch.empty((b, -(-cfg.c0 // GATE_PASS), cfg.v_pad // TILE_LANES, 2), device=dev,
                       dtype=torch.float32)
    ps = torch.empty((b, 1, 1, 1), device=dev, dtype=torch.float32)
    pss = torch.empty_like(ps)
    name = launch_name("ohead_fwd", cfg.precision)
    err = getattr(_build.library(), f"stgcn_{name}")(
        *ptrs, a.data_ptr(), part.data_ptr(), ps.data_ptr(), pss.data_ptr(),
        b, cfg.ko, cfg.c_in, cfg.v_pad, cfg.c0, ACT_CODES[cfg.act_func], cfg.v_true,
        *drop_args(drop), stream_of(dev))
    _build.check(name, err)
    count_launch(name)
    return a, ps, pss


def ofc_fwd(cfg: OutHeadCfg, a, mu, rstd, lnw, lnb, w1, b1, w2, b2, *,
            drop: Drop | None = None) -> torch.Tensor:
    """K4: ``a`` [B, 1, c0, Vp], ``mu``/``rstd`` [B, 1, 1, 1], ``lnw``/``lnb``
    [c0, Vp], ``w1`` [c0, c1], ``b1`` [c1], ``w2`` [c1, c_end], ``b2``
    [c_end] → ``[B, 1, c_end, Vp]`` (float32 for both variants). ``drop``
    drops out fc1's ReLU output."""
    _check_cfg(cfg)
    if on_cpu(a):
        return ofc_reference(cfg, a, mu, rstd, lnw, lnb, w1, b1, w2, b2, drop)
    dev = cuda_device(a)
    b, cdt = a.shape[0], cfg.dtype
    stat, aff = (b, 1, 1, 1), (cfg.c0, cfg.v_pad)
    ptrs = [require(a, "a", (b, 1, cfg.c0, cfg.v_pad), dev, cdt),
            require(mu, "mu", stat, dev), require(rstd, "rstd", stat, dev),
            require(lnw, "lnw", aff, dev, cdt), require(lnb, "lnb", aff, dev, cdt),
            require(w1, "w1", (cfg.c0, cfg.c1), dev, cdt), require(b1, "b1", (cfg.c1,), dev),
            require(w2, "w2", (cfg.c1, cfg.c_end), dev, cdt),
            require(b2, "b2", (cfg.c_end,), dev)]
    out = torch.empty((b, 1, cfg.c_end, cfg.v_pad), device=dev, dtype=torch.float32)
    name = launch_name("ofc_fwd", cfg.precision)
    err = getattr(_build.library(), f"stgcn_{name}")(
        *ptrs, out.data_ptr(), b, cfg.c0, cfg.c1, cfg.c_end, cfg.v_pad, cfg.v_true,
        *drop_args(drop), stream_of(dev))
    _build.check(name, err)
    count_launch(name)
    return out


def ohead_bwd(cfg: OutHeadCfg, x, mu, rstd, lng, lnb, ck, cb, ga, gps, gpss, *,
              drop: Drop | None = None):
    """K3b: the gradients of :func:`ohead_fwd` for the cotangents ``ga``
    [B, 1, c0, Vp] and ``gps``/``gpss`` [B, 1, 1, 1], recomputing the forward
    and regenerating its mask. Returns ``(dx, dmu, drstd, dlng, dlnb, dck,
    dcb)``."""
    _check_cfg(cfg)
    refuse_bf16_bwd("K3b, the backward of K3", cfg.precision)
    if on_cpu(x):
        return ohead_bwd_reference(cfg, x, mu, rstd, lng, lnb, ck, cb, ga, gps, gpss, drop)
    dev = cuda_device(x)
    b = x.shape[0]
    lib = _build.library()
    stat, aff = (b, cfg.ko, 1, 1), (cfg.c_in, cfg.v_pad)
    ins = (x, mu, rstd, lng, lnb, ck, cb)
    ptrs = [require(x, "x", (b, cfg.ko, cfg.c_in, cfg.v_pad), dev),
            require(mu, "mu", stat, dev), require(rstd, "rstd", stat, dev),
            require(lng, "lng", aff, dev), require(lnb, "lnb", aff, dev),
            require(ck, "ck", (cfg.ko, cfg.c_in, cfg.g), dev),
            require(cb, "cb", (cfg.g,), dev),
            require(ga, "ga", (b, 1, cfg.c0, cfg.v_pad), dev),
            require(gps, "gps", (b, 1, 1, 1), dev), require(gpss, "gpss", (b, 1, 1, 1), dev)]
    outs = [torch.empty_like(t) for t in ins]
    act = ACT_CODES[cfg.act_func]
    work = workspace(lib.stgcn_ohead_bwd_work(b, cfg.ko, cfg.c_in, cfg.v_pad, cfg.c0, act), dev)
    err = lib.stgcn_ohead_bwd(
        *ptrs, *[t.data_ptr() for t in outs], work.data_ptr(), b, cfg.ko, cfg.c_in, cfg.v_pad,
        cfg.c0, act, cfg.v_true, *drop_args(drop), stream_of(dev))
    _build.check("ohead_bwd", err)
    count_launch("ohead_bwd")
    return tuple(outs)


def ofc_bwd(cfg: OutHeadCfg, a, mu, rstd, lnw, lnb, w1, b1, w2, b2, gout, *,
            drop: Drop | None = None):
    """K4b: the gradients of :func:`ofc_fwd` for the cotangent ``gout``
    [B, 1, c_end, Vp], recomputing the forward and regenerating its mask.
    Returns ``(da, dmu, drstd, dlnw, dlnb, dw1, db1, dw2, db2)``."""
    _check_cfg(cfg)
    refuse_bf16_bwd("K4b, the backward of K4", cfg.precision)
    if on_cpu(a):
        return ofc_bwd_reference(cfg, a, mu, rstd, lnw, lnb, w1, b1, w2, b2, gout, drop)
    dev = cuda_device(a)
    b = a.shape[0]
    lib = _build.library()
    stat, aff = (b, 1, 1, 1), (cfg.c0, cfg.v_pad)
    ins = (a, mu, rstd, lnw, lnb, w1, b1, w2, b2)
    ptrs = [require(a, "a", (b, 1, cfg.c0, cfg.v_pad), dev),
            require(mu, "mu", stat, dev), require(rstd, "rstd", stat, dev),
            require(lnw, "lnw", aff, dev), require(lnb, "lnb", aff, dev),
            require(w1, "w1", (cfg.c0, cfg.c1), dev), require(b1, "b1", (cfg.c1,), dev),
            require(w2, "w2", (cfg.c1, cfg.c_end), dev),
            require(gout, "gout", (b, 1, cfg.c_end, cfg.v_pad), dev)]
    require(b2, "b2", (cfg.c_end,), dev)
    outs = [torch.empty_like(t) for t in ins]
    work = workspace(lib.stgcn_ofc_bwd_work(b, cfg.c0, cfg.c1, cfg.c_end, cfg.v_pad), dev)
    err = lib.stgcn_ofc_bwd(
        *ptrs, *[t.data_ptr() for t in outs], work.data_ptr(), b, cfg.c0, cfg.c1, cfg.c_end,
        cfg.v_pad, cfg.v_true, *drop_args(drop), stream_of(dev))
    _build.check("ofc_bwd", err)
    count_launch("ofc_bwd")
    return tuple(outs)


class _OheadFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, drop, x, mu, rstd, lng, lnb, ck, cb):
        ctx.cfg, ctx.drop = cfg, drop
        ctx.save_for_backward(x, mu, rstd, lng, lnb, ck, cb)
        return ohead_fwd(cfg, x, mu, rstd, lng, lnb, ck, cb, drop=drop)

    @staticmethod
    def backward(ctx, ga, gps, gpss):
        x = ctx.saved_tensors[0]
        b, cfg = x.shape[0], ctx.cfg
        ga = x.new_zeros((b, 1, cfg.c0, cfg.v_pad)) if ga is None else ga.contiguous()
        gps = x.new_zeros((b, 1, 1, 1)) if gps is None else gps.contiguous()
        gpss = x.new_zeros((b, 1, 1, 1)) if gpss is None else gpss.contiguous()
        return (None, None, *ohead_bwd(cfg, *ctx.saved_tensors, ga, gps, gpss, drop=ctx.drop))


class _OfcFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, drop, a, mu, rstd, lnw, lnb, w1, b1, w2, b2):
        ctx.cfg, ctx.drop = cfg, drop
        ctx.save_for_backward(a, mu, rstd, lnw, lnb, w1, b1, w2, b2)
        return ofc_fwd(cfg, a, mu, rstd, lnw, lnb, w1, b1, w2, b2, drop=drop)

    @staticmethod
    def backward(ctx, gout):
        return (None, None, *ofc_bwd(ctx.cfg, *ctx.saved_tensors, gout.contiguous(),
                                     drop=ctx.drop))


def ohead_fused(cfg: OutHeadCfg, x, mu, rstd, lng, lnb, ck, cb, *, drop: Drop | None = None):
    """Differentiable K3: :func:`ohead_fwd` forward, :func:`ohead_bwd` backward."""
    return _OheadFused.apply(cfg, drop, x, mu, rstd, lng, lnb, ck, cb)


def ofc_fused(cfg: OutHeadCfg, a, mu, rstd, lnw, lnb, w1, b1, w2, b2, *,
              drop: Drop | None = None):
    """Differentiable K4: :func:`ofc_fwd` forward, :func:`ofc_bwd` backward."""
    return _OfcFused.apply(cfg, drop, a, mu, rstd, lnw, lnb, w1, b1, w2, b2)


def output_head_fused(params: dict, a2, mu, rstd, lng_p, lnb_p, *, v_true: int,
                      act_func: str, drop_in: Drop | None = None,
                      drop_fc: Drop | None = None) -> torch.Tensor:
    """The whole output head on the cv-layout pre-LN activation of the final
    ST block, differentiable through K3b/K4b. ``params``: the output block's
    entries of the port's ``state_dict`` (or of ``named_parameters``) with
    the ``output.`` prefix removed. ``a2`` [B, ko, C, Vp]; ``mu``/``rstd``
    [B, ko, 1, 1]; ``lng_p``/``lnb_p`` [C, Vp] (the final block's LN affine,
    zero-padded). ``drop_in`` drops the final block's normalized output,
    ``drop_fc`` fc1's output (training). Returns [B, 1, Vp, c_end], float32.

    A bf16 ``a2`` runs K3's and K4's bf16 variants, as the JAX head does
    (``stgcn_tpu/kernels/output_head.py:547-562``): the conv and fc weights
    cast to bf16, the biases float32, the head's LayerNorm affine in the
    type of the inter-block one (``lng_p``)."""
    b, ko, c_in, v_pad = a2.shape
    precision = "bfloat16" if a2.dtype == BF16 else "default"
    cdt, ln_dt, f32 = a2.dtype, lng_p.dtype, torch.float32
    conv_w = params["tmp_conv1.causal_conv.weight"]          # [g, c_in, ko, 1]
    ck = conv_w[..., 0].permute(2, 1, 0).to(cdt).contiguous()   # [ko, c_in, g]
    g = ck.shape[-1]
    c0 = g // 2 if act_func in ("glu", "gtu") else g
    w1 = params["fc1.weight"].T.to(cdt).contiguous()
    w2 = params["fc2.weight"].T.to(cdt).contiguous()
    b1 = params.get("fc1.bias", torch.zeros(w1.shape[1], device=a2.device))
    b2 = params.get("fc2.bias", torch.zeros(w2.shape[1], device=a2.device))
    cfg = OutHeadCfg(ko=ko, c_in=c_in, c0=c0, c1=w1.shape[1], c_end=w2.shape[1],
                     act_func=act_func, v_true=v_true, v_pad=v_pad, precision=precision)
    pad_v = (0, 0, 0, v_pad - params["ln.weight"].shape[0])
    lnw = torch.nn.functional.pad(params["ln.weight"].to(ln_dt), pad_v).T.contiguous()
    lnb = torch.nn.functional.pad(params["ln.bias"].to(ln_dt), pad_v).T.contiguous()

    a, ps, pss = ohead_fused(cfg, a2, mu, rstd, lng_p, lnb_p, ck,
                             params["tmp_conv1.causal_conv.bias"].to(f32), drop=drop_in)
    mu2, rstd2 = ln_stats(ps, pss, v_true * c0)
    out = ofc_fused(cfg, a, mu2, rstd2, lnw, lnb, w1, b1.to(f32).contiguous(), w2,
                    b2.to(f32).contiguous(), drop=drop_fc)
    return out.permute(0, 1, 3, 2)  # [B, 1, Vp, c_end]
