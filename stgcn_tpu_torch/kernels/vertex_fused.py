"""K1 (block head) and K2 (block tail) of the vertex-fused ST block, forward
and backward (port of ``stgcn_tpu/kernels/vertex_fused.py``).

One ST block runs as two kernels around the graph aggregation:

- :func:`head_fwd` (K1, TPU ``_head_pallas``) — [previous block's
  LayerNorm normalize →] temporal conv 1 → gate → bottleneck align: one
  read of the block input, one write of the ``c1``-narrow graph operand
  ``xg``;
- (the graph product runs between them: ``DenseGraphOp.cheb_pair_cv``);
- :func:`tail_fwd` (K2, TPU ``_tail_pallas``) — Chebyshev weight
  contraction → residual → ReLU → temporal conv 2 → gate, emitting the
  pre-LN activation ``a2`` plus the LayerNorm partial sums (Σ, Σ²) over
  channels and the true vertex lanes, per (batch, step).

In training, K1 drops out its normalized input with a mask keyed by element
(:mod:`.dropout`). :func:`head_bwd` (K1b) and :func:`tail_bwd` (K2b) are the
recompute-based backward kernels; :func:`head_fused` and :func:`tail_fused`
wrap forward and backward as ``torch.autograd.Function``s that save only
their inputs, as the TPU's ``custom_vjp`` does.

All large operands are channel-before-vertex ``[B, T, C, Vp]`` float32, as
on the TPU. The CUDA sources are ``csrc/gate_gemm.cu`` (K1's body: conv 1
on the register tile of ``csrc/f32_tile.cuh``, the input normalized and
dropped out as it is staged, the gate and the align in the epilogue),
``csrc/vertex_fused.cu`` (both forward entry points; K2's first stage,
which forms h once, one thread a lane, then runs conv 2 on the gate GEMM
with the gate, a2 and the LayerNorm partials in its epilogue; the
partials' fixed-order second pass) and ``csrc/vertex_fused_bwd.cu`` over
``csrc/bwd_blocks.cu`` (K1b, K2b: their recompute with the gate backward,
their data gradients and every weight gradient run on the same tile); their
notes say what bounds each kernel and how the design answers it. Every
wrapper runs its kernel on a CUDA tensor and its plain PyTorch version
(``*_reference``; the backward ones are autograd through the forward ones
with the same mask) on a CPU tensor, and counts its kernel launches
(:func:`stgcn_tpu_torch.kernels.launch_counts`). Their bf16 variants
(``precision="bfloat16"`` on the TPU) come with the fused bf16 slice of the
port and raise until then; the unfused bf16 model runs (its graph kernels
K7-K10 have bf16 variants).
"""

from __future__ import annotations

import dataclasses

import torch

from stgcn_tpu_torch.kernels import _build, dropout
from stgcn_tpu_torch.kernels._launch import (
    ACT_CODES, BF16_SLICE, GATE_PASS, LANES, MAX_OUT, TILE_LANES, count_launch, cuda_device,
    drop_args, on_cpu, require, stream_of, workspace)
from stgcn_tpu_torch.kernels.dropout import Drop


@dataclasses.dataclass(frozen=True)
class VertexBlockCfg:
    """Static config shared by the head/tail kernels of one ST block."""

    kt: int
    ks: int
    act_func: str
    graph_conv_type: str
    v_true: int          # true vertex count (LN statistics mask)
    v_pad: int           # padded vertex count (multiple of 128)
    t_in: int            # input time length of this block
    c_in: int
    c0: int
    c1: int
    c2: int
    apply_ln: bool       # head: normalize the input (block l > 0)
    precision: str = "default"

    @property
    def gated(self) -> bool:
        return self.act_func in ("glu", "gtu")

    @property
    def g1(self) -> int:
        return 2 * self.c0 if self.gated else self.c0

    @property
    def g2(self) -> int:
        return 2 * self.c2 if self.gated else self.c2

    @property
    def t1(self) -> int:
        return self.t_in - self.kt + 1

    @property
    def t2(self) -> int:
        return self.t1 - self.kt + 1

    @property
    def n_terms(self) -> int:
        """Graph terms entering the weight contraction besides xg."""
        return 1 if self.graph_conv_type == "graph_conv" else self.ks - 1


# --------------------------------------------------------------------------
# plain PyTorch versions (cv layout, whole arrays)
# --------------------------------------------------------------------------

def _cdot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """cv channel contraction ``[b, t, c, v] × [c, g] → [b, t, g, v]``."""
    return torch.einsum("btcv,cg->btgv", x, w)


def pad_channels_cv(x: torch.Tensor, c_out: int) -> torch.Tensor:
    """Zero-pad the cv channel axis (-2) up to ``c_out`` (`model/layers.py:17-19`)."""
    c_in = x.shape[2]
    if c_in > c_out:
        raise ValueError("the fused block supports c_in <= c_out align only")
    return torch.nn.functional.pad(x, (0, 0, 0, c_out - c_in)) if c_in < c_out else x


def gate_cv(act_func: str, s: torch.Tensor, xin: torch.Tensor, c: int) -> torch.Tensor:
    """Gate with the in-gate residual on the cv channel axis (reference
    semantics `model/layers.py:105,109,111-115`)."""
    if act_func in ("glu", "gtu"):
        lin = s[:, :, :c] + xin
        if act_func == "gtu":
            lin = torch.tanh(lin)
        return lin * torch.sigmoid(s[:, :, c:])
    z = s + xin
    return torch.relu(z) if act_func == "relu" else torch.nn.functional.silu(z)


def tconv_cv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, kt: int) -> torch.Tensor:
    """Valid temporal conv on cv operands, one contraction per tap.
    ``x`` [b, t, c_in, v]; ``kernel`` [kt, c_in, c_out]."""
    t_out = x.shape[1] - kt + 1
    acc = _cdot(x[:, 0:t_out], kernel[0])
    for k in range(1, kt):
        acc = acc + _cdot(x[:, k:k + t_out], kernel[k])
    return acc + bias[:, None]


def ln_normalize_cv(x, mu, rstd, lng, lnb):
    """Normalize with given per-(b, t) statistics ``[B, T, 1, 1]``, then the
    (V, C) affine ``[c, Vp]`` (zero on padded lanes)."""
    return (x - mu) * rstd * lng + lnb


def head_reference(cfg: VertexBlockCfg, x, ln, w, drop: Drop | None = None) -> torch.Tensor:
    """Plain version of :func:`head_fwd`. ``ln`` = (mu, rstd, lng, lnb) or
    None when ``not cfg.apply_ln``; ``w`` = (c1k, c1b, gaw, gab); ``drop``
    drops the normalized input (LN, then dropout, `model/layers.py:255-256`)."""
    c1k, c1b, gaw, gab = w
    if cfg.apply_ln:
        x = dropout.apply_cv(ln_normalize_cv(x, *ln), drop, cfg.v_true)
    s1 = tconv_cv(x, c1k, c1b, cfg.kt)
    a1 = gate_cv(cfg.act_func, s1, pad_channels_cv(x[:, cfg.kt - 1:], cfg.c0), cfg.c0)
    return _cdot(a1, gaw) + gab[:, None]


def tail_preact(cfg: VertexBlockCfg, xg, terms, w) -> torch.Tensor:
    """The input of the tail's ReLU: graph-term contraction plus bias and
    residual, ``[B, t1, c1, Vp]``."""
    gcw, gcb = w[0], w[1]
    cterms = [xg, *terms] if cfg.graph_conv_type == "cheb_graph_conv" else list(terms)
    out = _cdot(cterms[0], gcw[0])
    for k in range(1, len(cterms)):
        out = out + _cdot(cterms[k], gcw[k])
    return out + gcb[:, None] + xg


def _tail_core(cfg: VertexBlockCfg, xg, terms, w, relu_mask=None) -> torch.Tensor:
    _, _, c2k, c2b = w
    z = tail_preact(cfg, xg, terms, w)
    h = torch.relu(z) if relu_mask is None else z * relu_mask
    s2 = tconv_cv(h, c2k, c2b, cfg.kt)
    return gate_cv(cfg.act_func, s2, pad_channels_cv(h[:, cfg.kt - 1:], cfg.c2), cfg.c2)


def masked_ln_sums(a: torch.Tensor, v_true: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σ a, Σ a²) over channels and the true vertex lanes, ``[B, T, 1, 1]``."""
    vm = (torch.arange(a.shape[-1], device=a.device) < v_true).to(a.dtype)
    a = a * vm
    return a.sum((2, 3), keepdim=True), (a * a).sum((2, 3), keepdim=True)


def ln_stats(ps: torch.Tensor, pss: torch.Tensor, count: int):
    """μ and 1/σ from the partial sums over ``count`` elements:
    ``rsqrt(max(var, 0) + 1e-12)`` (``nn/fused_sparse.py:520-523``)."""
    mu = ps / count
    var = pss / count - mu * mu
    return mu, torch.rsqrt(torch.clamp(var, min=0.0) + 1e-12)


def tail_reference(cfg: VertexBlockCfg, xg, terms, w, relu_mask=None):
    """Plain version of :func:`tail_fwd`; returns (a2, ps, pss).
    ``relu_mask`` (1 where the ReLU passes, shaped as :func:`tail_preact`)
    replaces the ReLU's own decisions when given."""
    a2 = _tail_core(cfg, xg, terms, w, relu_mask)
    return (a2, *masked_ln_sums(a2, cfg.v_true))


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def head_bwd_reference(cfg: VertexBlockCfg, x, ln, w, gy, drop: Drop | None = None):
    """Plain version of :func:`head_bwd`: autograd through
    :func:`head_reference` with the same mask."""
    with torch.enable_grad():
        ins = [x, *(ln if cfg.apply_ln else ()), *w]
        ins = [t.detach().requires_grad_() for t in ins]
        n_ln = 4 if cfg.apply_ln else 0
        y = head_reference(cfg, ins[0], ins[1:1 + n_ln] or None, ins[1 + n_ln:], drop)
        g = torch.autograd.grad(y, ins, gy, allow_unused=True)
    g = [torch.zeros_like(t) if d is None else d for t, d in zip(ins, g)]
    return (g[0], *(g[1:5] if cfg.apply_ln else (None,) * 4), *g[1 + n_ln:])


def tail_bwd_reference(cfg: VertexBlockCfg, xg, terms, w, ga2, gps, gpss, relu_mask=None):
    """Plain version of :func:`tail_bwd`: autograd through
    :func:`tail_reference` (with ``relu_mask`` as there); returns (dxg,
    [dterm per term], dgcw, dgcb, dc2k, dc2b)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (xg, *terms, *w)]
        n = len(terms)
        outs = tail_reference(cfg, ins[0], ins[1:1 + n], ins[1 + n:], relu_mask)
        g = torch.autograd.grad(outs, ins, (ga2, gps, gpss), allow_unused=True)
    g = [torch.zeros_like(t) if d is None else d for t, d in zip(ins, g)]
    return g[0], g[1:1 + n], *g[1 + n:]


def _check_cfg(cfg: VertexBlockCfg) -> None:
    if cfg.precision != "default":
        raise NotImplementedError(f"precision {cfg.precision!r}: the bf16 variants of K1-K4 "
                                  f"are not ported yet; they come with {BF16_SLICE}")
    if cfg.act_func not in ACT_CODES:
        raise ValueError(f"unknown act_func {cfg.act_func!r}")
    if cfg.v_pad % LANES:
        raise ValueError(f"v_pad {cfg.v_pad} is not a multiple of {LANES}")
    if cfg.c1 > MAX_OUT:
        raise ValueError(f"c1 {cfg.c1} > {MAX_OUT}: the kernels keep c1 sums in registers")
    if cfg.c_in > cfg.c0 or cfg.c1 > cfg.c2:
        raise ValueError("the fused block supports zero-pad residual aligns only "
                         "(c_in <= c0, c1 <= c2)")


def _check_drop(cfg: VertexBlockCfg, drop: Drop | None) -> None:
    if drop is not None and not cfg.apply_ln:
        raise ValueError("the head drops out only a normalized input (apply_ln)")


def head_fwd(cfg: VertexBlockCfg, x, mu, rstd, lng, lnb, c1k, c1b, gaw, gab, *,
             drop: Drop | None = None) -> torch.Tensor:
    """K1: ``x`` [B, t_in, c_in, Vp] → ``xg`` [B, t1, c1, Vp]. When
    ``cfg.apply_ln`` the input is first normalized with ``mu``/``rstd``
    [B, t_in, 1, 1] and the affine ``lng``/``lnb`` [c_in, Vp], then dropped
    out by ``drop`` (training); otherwise those four may be None. Weights:
    ``c1k`` [kt, c_in, g1], ``c1b`` [g1], ``gaw`` [c0, c1], ``gab`` [c1]."""
    _check_cfg(cfg)
    _check_drop(cfg, drop)
    if on_cpu(x):
        ln = (mu, rstd, lng, lnb) if cfg.apply_ln else None
        return head_reference(cfg, x, ln, (c1k, c1b, gaw, gab), drop)
    dev = cuda_device(x)
    b = x.shape[0]
    ln_shapes = [(b, cfg.t_in, 1, 1)] * 2 + [(cfg.c_in, cfg.v_pad)] * 2
    ptrs = [require(x, "x", (b, cfg.t_in, cfg.c_in, cfg.v_pad), dev)]
    for name, t, shape in zip(("mu", "rstd", "lng", "lnb"), (mu, rstd, lng, lnb), ln_shapes):
        ptrs.append(require(t, name, shape, dev) if cfg.apply_ln else 0)
    ptrs += [require(c1k, "c1k", (cfg.kt, cfg.c_in, cfg.g1), dev),
             require(c1b, "c1b", (cfg.g1,), dev),
             require(gaw, "gaw", (cfg.c0, cfg.c1), dev),
             require(gab, "gab", (cfg.c1,), dev)]
    xg = torch.empty((b, cfg.t1, cfg.c1, cfg.v_pad), device=dev, dtype=torch.float32)
    err = _build.library().stgcn_head_fwd(
        *ptrs, xg.data_ptr(), b, cfg.t_in, cfg.c_in, cfg.v_pad, cfg.kt, cfg.c0, cfg.c1,
        ACT_CODES[cfg.act_func], int(cfg.apply_ln), cfg.v_true, *drop_args(drop),
        stream_of(dev))
    _build.check("head_fwd", err)
    count_launch("head_fwd")
    return xg


def tail_fwd(cfg: VertexBlockCfg, xg, t_a, t_b, gcw, gcb, c2k, c2b):
    """K2: returns ``(a2 [B, t2, c2, Vp], ps [B, t2, 1, 1], pss [B, t2, 1, 1])``
    — the pre-LN activation and its masked LayerNorm partial sums, already
    reduced over all vertex tiles. ``t_a``/``t_b``: the graph outputs
    (``t_b`` is ignored when only one term exists — pass ``t_a`` again).
    Weights: ``gcw`` [n_c, c1, c1] (n_c contraction terms), ``gcb`` [c1],
    ``c2k`` [kt, c1, g2], ``c2b`` [g2]."""
    _check_cfg(cfg)
    terms = [t_a, t_b][: cfg.n_terms]
    if on_cpu(xg):
        return tail_reference(cfg, xg, terms, (gcw, gcb, c2k, c2b))
    dev = cuda_device(xg)
    b = xg.shape[0]
    act = (b, cfg.t1, cfg.c1, cfg.v_pad)
    cterms = [xg, *terms] if cfg.graph_conv_type == "cheb_graph_conv" else terms
    n_c = len(cterms)
    ct = [require(t, f"term{i}", act, dev) for i, t in enumerate(cterms)]
    ct += [0] * (3 - n_c)
    ptrs = [require(xg, "xg", act, dev), *ct,
            require(gcw, "gcw", (n_c, cfg.c1, cfg.c1), dev),
            require(gcb, "gcb", (cfg.c1,), dev),
            require(c2k, "c2k", (cfg.kt, cfg.c1, cfg.g2), dev),
            require(c2b, "c2b", (cfg.g2,), dev)]
    a2 = torch.empty((b, cfg.t2, cfg.c2, cfg.v_pad), device=dev, dtype=torch.float32)
    h = torch.empty(act, device=dev, dtype=torch.float32)   # scratch: the ReLU'd contraction
    part = torch.empty((b, cfg.t2, -(-cfg.c2 // GATE_PASS), cfg.v_pad // TILE_LANES, 2),
                       device=dev, dtype=torch.float32)
    ps = torch.empty((b, cfg.t2, 1, 1), device=dev, dtype=torch.float32)
    pss = torch.empty_like(ps)
    err = _build.library().stgcn_tail_fwd(
        *ptrs, a2.data_ptr(), h.data_ptr(), part.data_ptr(), ps.data_ptr(), pss.data_ptr(),
        b, cfg.t1, cfg.c1, cfg.v_pad, cfg.kt, n_c, cfg.c2, ACT_CODES[cfg.act_func],
        cfg.v_true, stream_of(dev))
    _build.check("tail_fwd", err)
    count_launch("tail_fwd")
    return a2, ps, pss


def head_bwd(cfg: VertexBlockCfg, x, mu, rstd, lng, lnb, c1k, c1b, gaw, gab, gy, *,
             drop: Drop | None = None):
    """K1b: the gradients of :func:`head_fwd` for the output cotangent ``gy``
    [B, t1, c1, Vp], recomputing the forward from its inputs and regenerating
    its mask. Returns ``(dx, dmu, drstd, dlng, dlnb, dc1k, dc1b, dgaw, dgab)``
    shaped as the inputs; the four LayerNorm entries are None unless
    ``cfg.apply_ln``."""
    _check_cfg(cfg)
    _check_drop(cfg, drop)
    ln = (mu, rstd, lng, lnb) if cfg.apply_ln else None
    if on_cpu(x):
        return head_bwd_reference(cfg, x, ln, (c1k, c1b, gaw, gab), gy, drop)
    dev = cuda_device(x)
    b = x.shape[0]
    lib = _build.library()
    act = ACT_CODES[cfg.act_func]
    ins = [require(x, "x", (b, cfg.t_in, cfg.c_in, cfg.v_pad), dev)]
    ln_shapes = [(b, cfg.t_in, 1, 1)] * 2 + [(cfg.c_in, cfg.v_pad)] * 2
    for name, t, shape in zip(("mu", "rstd", "lng", "lnb"), (mu, rstd, lng, lnb), ln_shapes):
        ins.append(require(t, name, shape, dev) if cfg.apply_ln else 0)
    ins += [require(c1k, "c1k", (cfg.kt, cfg.c_in, cfg.g1), dev),
            require(c1b, "c1b", (cfg.g1,), dev),
            require(gaw, "gaw", (cfg.c0, cfg.c1), dev),
            require(gy, "gy", (b, cfg.t1, cfg.c1, cfg.v_pad), dev)]
    require(gab, "gab", (cfg.c1,), dev)

    def new(t):
        return torch.empty_like(t)

    dx = torch.empty_like(x)
    dln = [new(t) for t in (mu, rstd, lng, lnb)] if cfg.apply_ln else [None] * 4
    dw = [new(t) for t in (c1k, c1b, gaw, gab)]
    sizes = (b, cfg.t_in, cfg.c_in, cfg.v_pad, cfg.kt, cfg.c0, cfg.c1, act, int(cfg.apply_ln))
    work = workspace(lib.stgcn_head_bwd_work(*sizes), dev)
    outs = [dx, *dln, *dw]
    err = lib.stgcn_head_bwd(
        *ins, *[0 if t is None else t.data_ptr() for t in outs], work.data_ptr(), *sizes,
        cfg.v_true, *drop_args(drop), stream_of(dev))
    _build.check("head_bwd", err)
    count_launch("head_bwd")
    return tuple(outs)


def tail_bwd(cfg: VertexBlockCfg, xg, t_a, t_b, gcw, gcb, c2k, c2b, ga2, gps, gpss):
    """K2b: the gradients of :func:`tail_fwd` for the cotangents ``ga2`` [B, t2,
    c2, Vp] of ``a2`` and ``gps``/``gpss`` [B, t2, 1, 1] of its LayerNorm
    partial sums, recomputing the forward. Returns ``(dxg, dt_a, dt_b, dgcw,
    dgcb, dc2k, dc2b)``; the gradient of a graph term the tail does not read
    (``t_b`` with one term) is zero."""
    _check_cfg(cfg)
    terms = [t_a, t_b][: cfg.n_terms]
    if on_cpu(xg):
        dxg, dterms, *dw = tail_bwd_reference(cfg, xg, terms, (gcw, gcb, c2k, c2b), ga2, gps,
                                              gpss)
        dterms = [*dterms] + [torch.zeros_like(xg)] * (2 - len(dterms))
        return (dxg, *dterms, *dw)
    dev = cuda_device(xg)
    b = xg.shape[0]
    lib = _build.library()
    cheb = cfg.graph_conv_type == "cheb_graph_conv"
    n_c = len(terms) + int(cheb)
    act = (b, cfg.t1, cfg.c1, cfg.v_pad)
    stat = (b, cfg.t2, 1, 1)
    term_ptrs = [require(t, f"term{i}", act, dev) for i, t in enumerate(terms)]
    ins = [require(xg, "xg", act, dev), *term_ptrs, *[0] * (2 - len(terms)),
           require(gcw, "gcw", (n_c, cfg.c1, cfg.c1), dev),
           require(gcb, "gcb", (cfg.c1,), dev),
           require(c2k, "c2k", (cfg.kt, cfg.c1, cfg.g2), dev),
           require(c2b, "c2b", (cfg.g2,), dev),
           require(ga2, "ga2", (b, cfg.t2, cfg.c2, cfg.v_pad), dev),
           require(gps, "gps", stat, dev), require(gpss, "gpss", stat, dev)]
    dxg = torch.empty_like(xg)
    dterms = [torch.empty_like(xg) if i < len(terms) else torch.zeros_like(xg)
              for i in range(2)]
    dw = [torch.empty_like(t) for t in (gcw, gcb, c2k, c2b)]
    sizes = (b, cfg.t1, cfg.c1, cfg.v_pad, cfg.kt, len(terms), int(cheb), cfg.c2,
             ACT_CODES[cfg.act_func])
    work = workspace(lib.stgcn_tail_bwd_work(*sizes), dev)
    outs = [dxg, *dterms, *dw]
    err = lib.stgcn_tail_bwd(*ins, *[t.data_ptr() for t in outs], work.data_ptr(), *sizes,
                             cfg.v_true, stream_of(dev))
    _build.check("tail_bwd", err)
    count_launch("tail_bwd")
    return tuple(outs)


# --------------------------------------------------------------------------
# autograd Functions: forward and backward kernels, inputs saved
# --------------------------------------------------------------------------

class _HeadFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, drop, x, mu, rstd, lng, lnb, c1k, c1b, gaw, gab):
        ctx.cfg, ctx.drop = cfg, drop
        ctx.save_for_backward(x, mu, rstd, lng, lnb, c1k, c1b, gaw, gab)
        return head_fwd(cfg, x, mu, rstd, lng, lnb, c1k, c1b, gaw, gab, drop=drop)

    @staticmethod
    def backward(ctx, gy):
        grads = head_bwd(ctx.cfg, *ctx.saved_tensors, gy.contiguous(), drop=ctx.drop)
        return (None, None, *grads)


class _TailFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, xg, t_a, t_b, gcw, gcb, c2k, c2b):
        ctx.cfg = cfg
        ctx.save_for_backward(xg, t_a, t_b, gcw, gcb, c2k, c2b)
        return tail_fwd(cfg, xg, t_a, t_b, gcw, gcb, c2k, c2b)

    @staticmethod
    def backward(ctx, ga2, gps, gpss):
        xg = ctx.saved_tensors[0]
        b = xg.shape[0]
        cfg = ctx.cfg
        if ga2 is None:
            ga2 = xg.new_zeros((b, cfg.t2, cfg.c2, cfg.v_pad))
        stat = (b, cfg.t2, 1, 1)
        gps = xg.new_zeros(stat) if gps is None else gps
        gpss = xg.new_zeros(stat) if gpss is None else gpss
        grads = tail_bwd(cfg, *ctx.saved_tensors, ga2.contiguous(), gps.contiguous(),
                         gpss.contiguous())
        return (None, *grads)


def head_fused(cfg: VertexBlockCfg, x, mu, rstd, lng, lnb, c1k, c1b, gaw, gab, *,
               drop: Drop | None = None) -> torch.Tensor:
    """Differentiable K1: :func:`head_fwd` forward, :func:`head_bwd` backward."""
    return _HeadFused.apply(cfg, drop, x, mu, rstd, lng, lnb, c1k, c1b, gaw, gab)


def tail_fused(cfg: VertexBlockCfg, xg, t_a, t_b, gcw, gcb, c2k, c2b):
    """Differentiable K2: :func:`tail_fwd` forward, :func:`tail_bwd` backward."""
    return _TailFused.apply(cfg, xg, t_a, t_b, gcw, gcb, c2k, c2b)
