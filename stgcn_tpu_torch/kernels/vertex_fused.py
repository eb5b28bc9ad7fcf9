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
(:func:`stgcn_tpu_torch.kernels.launch_counts`).

``VertexBlockCfg(precision="bfloat16")`` selects the forward kernels' bf16
variants (the TPU kernels' ``precision="bfloat16"`` build, counted as
``head_fwd_bf16`` and ``tail_fwd_bf16``): bf16 activations, weights and
LayerNorm affine, float32 biases, statistics and partial sums; float32 sums
of bf16 products, rounded to bf16 where the TPU kernel rounds
(``stgcn_tpu/kernels/vertex_fused.py:338-442``): the normalized input, then
its product with the bf16 mask; each product's sum plus bias; the contraction
before the residual; every op of the gate, whose σ is ``tanh(x/2)/2 + 1/2``
as the TPU's bf16 kernels compose it. The plain versions round at the same
points, their products float32 einsums of bf16 values. The backward kernels'
bf16 variants (``head_bwd_bf16``, ``tail_bwd_bf16``: ``csrc/bwd_blocks_bf16.cu``)
recompute that forward and round where the TPU's bf16 backward kernels round
(``stgcn_tpu/kernels/vertex_fused.py:306-469``, ``:525-585``, ``:797-836``):
the upstream gradient (K1b's ``gy · gawᵀ``, K2b's ``ga2`` plus the LayerNorm-
partial cotangents); every op of the gate backward; each tap's data gradient,
the taps then added in bf16 in order and the residual's gradient last; K2b's
``dr`` and each graph term's gradient; the LayerNorm backward's ``dx`` (its
statistics float32) and its affine gradients, summed over the whole batch in
float32 and rounded once. Weight and bias gradients are float32 sums; the
autograd Functions hand each input a gradient in its own type (a bf16 weight
a bf16 one, as the TPU's ``custom_vjp`` casts them), μ/rstd float32 ones.
The plain versions (``head_bwd_reference``, ``tail_bwd_reference``) follow
the same points with float32 einsums of bf16 values.
"""

from __future__ import annotations

import dataclasses

import torch

from stgcn_tpu_torch.kernels import _build, dropout
from stgcn_tpu_torch.kernels._launch import (
    ACT_CODES, GATE_PASS, LANES, MAX_OUT, TILE_LANES, count_launch, cuda_device, drop_args,
    on_cpu, require, stream_of, workspace)
from stgcn_tpu_torch.kernels.dropout import Drop

BF16 = torch.bfloat16
PRECISIONS = ("default", "bfloat16")


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

    @property
    def dtype(self) -> torch.dtype:
        """The activations' and weights' type: bf16 for the bf16 variants."""
        return BF16 if self.precision == "bfloat16" else torch.float32


def launch_name(name: str, precision: str) -> str:
    """The launch counter of a forward kernel: ``name``, or ``name_bf16`` for
    its bf16 variant."""
    return f"{name}_bf16" if precision == "bfloat16" else name


# --------------------------------------------------------------------------
# plain PyTorch versions (cv layout, whole arrays)
# --------------------------------------------------------------------------

def _cdot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """cv channel contraction ``[b, t, c, v] × [c, g] → [b, t, g, v]``."""
    return torch.einsum("btcv,cg->btgv", x, w)


def linear_cv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x`` [b, t, c, v] × ``w`` [c, g] + ``b`` [g] → [b, t, g, v] in x's
    type: for a bf16 ``x``, the float32 sums of its bf16 products plus the
    float32 bias, rounded once (K1's align, K4's fc1: `_head_core`,
    ``stgcn_tpu/kernels/vertex_fused.py:393-404``; `_ofc_core`,
    ``output_head.py:327-332``)."""
    return (_cdot(x.float(), w.float()) + b[:, None]).to(x.dtype)


def pad_channels_cv(x: torch.Tensor, c_out: int) -> torch.Tensor:
    """Zero-pad the cv channel axis (-2) up to ``c_out`` (`model/layers.py:17-19`)."""
    c_in = x.shape[2]
    if c_in > c_out:
        raise ValueError("the fused block supports c_in <= c_out align only")
    return torch.nn.functional.pad(x, (0, 0, 0, c_out - c_in)) if c_in < c_out else x


def sigmoid_bf16(x: torch.Tensor) -> torch.Tensor:
    """σ of a bf16 tensor as the TPU's bf16 kernels compose it,
    ``tanh(x/2)/2 + 1/2``, each op rounded to bf16 (`_sigmoid`,
    ``stgcn_tpu/kernels/fused_stblock.py:182-189``)."""
    return torch.tanh(x * 0.5) * 0.5 + 0.5


def gate_cv(act_func: str, s: torch.Tensor, xin: torch.Tensor, c: int) -> torch.Tensor:
    """Gate with the in-gate residual on the cv channel axis (reference
    semantics `model/layers.py:105,109,111-115`). On bf16 operands every op
    rounds to bf16 and σ is :func:`sigmoid_bf16` (`_gate_fwd_cv`,
    ``stgcn_tpu/kernels/vertex_fused.py:280-303``)."""
    if s.dtype == BF16:
        if act_func in ("glu", "gtu"):
            lin = s[:, :, :c] + xin
            return (torch.tanh(lin) if act_func == "gtu" else lin) * sigmoid_bf16(s[:, :, c:])
        z = s + xin
        return torch.relu(z) if act_func == "relu" else z * sigmoid_bf16(z)
    if act_func in ("glu", "gtu"):
        lin = s[:, :, :c] + xin
        if act_func == "gtu":
            lin = torch.tanh(lin)
        return lin * torch.sigmoid(s[:, :, c:])
    z = s + xin
    return torch.relu(z) if act_func == "relu" else torch.nn.functional.silu(z)


def tconv_cv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, kt: int) -> torch.Tensor:
    """Valid temporal conv on cv operands, one contraction per tap.
    ``x`` [b, t, c_in, v]; ``kernel`` [kt, c_in, c_out]. A bf16 ``x``: the
    float32 sums of its bf16 products plus the float32 bias, rounded once
    to bf16 (`_tconv_fwd_cv`, ``stgcn_tpu/kernels/vertex_fused.py:338-345``)."""
    dt = x.dtype
    x, kernel = x.float(), kernel.float()
    t_out = x.shape[1] - kt + 1
    acc = _cdot(x[:, 0:t_out], kernel[0])
    for k in range(1, kt):
        acc = acc + _cdot(x[:, k:k + t_out], kernel[k])
    return (acc + bias[:, None]).to(dt)


def ln_normalize_cv(x, mu, rstd, lng, lnb):
    """Normalize with given per-(b, t) statistics ``[B, T, 1, 1]``, then the
    (V, C) affine ``[c, Vp]`` (zero on padded lanes). A bf16 ``x`` (and
    affine): in float32, rounded once to bf16 (`_ln_drop_fwd`,
    ``stgcn_tpu/kernels/vertex_fused.py:363-375``)."""
    if x.dtype == BF16:
        return ((x.float() - mu) * rstd * lng.float() + lnb.float()).to(BF16)
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
    return linear_cv(a1, gaw, gab)


def tail_preact(cfg: VertexBlockCfg, xg, terms, w) -> torch.Tensor:
    """The input of the tail's ReLU: graph-term contraction plus bias and
    residual, ``[B, t1, c1, Vp]``. bf16: the contraction plus bias rounded
    to bf16 before the residual, a bf16 add (`_tail_core`,
    ``stgcn_tpu/kernels/vertex_fused.py:423-442``)."""
    gcw, gcb = w[0].float(), w[1]
    cterms = [xg, *terms] if cfg.graph_conv_type == "cheb_graph_conv" else list(terms)
    out = _cdot(cterms[0].float(), gcw[0])
    for k in range(1, len(cterms)):
        out = out + _cdot(cterms[k].float(), gcw[k])
    if xg.dtype == BF16:
        return (out + gcb[:, None]).to(BF16) + xg
    return out + gcb[:, None] + xg


def _tail_core(cfg: VertexBlockCfg, xg, terms, w, relu_mask=None) -> torch.Tensor:
    _, _, c2k, c2b = w
    z = tail_preact(cfg, xg, terms, w)
    h = torch.relu(z) if relu_mask is None else z * relu_mask
    s2 = tconv_cv(h, c2k, c2b, cfg.kt)
    return gate_cv(cfg.act_func, s2, pad_channels_cv(h[:, cfg.kt - 1:], cfg.c2), cfg.c2)


def masked_ln_sums(a: torch.Tensor, v_true: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σ a, Σ a²) over channels and the true vertex lanes, ``[B, T, 1, 1]``,
    in float32 (of a bf16 ``a``'s values)."""
    a = a.float()
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
# the bf16 backward's plain pieces: each op on bf16 tensors rounds, as the
# TPU's bf16 kernels do; products are float32 einsums of bf16 values
# --------------------------------------------------------------------------

def gate_bwd_cv(act_func: str, s, xin, c: int, da):
    """The gate's backward on bf16 operands, each op rounded (`_gate_bwd_cv`,
    ``stgcn_tpu/kernels/vertex_fused.py:306-335``): returns (ds, dxin), dxin
    the gradient of the in-gate residual (ds's linear half)."""
    if act_func in ("glu", "gtu"):
        lin = s[:, :, :c] + xin
        sq = sigmoid_bf16(s[:, :, c:])
        if act_func == "glu":
            dlin, dq = da * sq, da * lin * sq * (1.0 - sq)
        else:
            th = torch.tanh(lin)
            dlin, dq = da * sq * (1.0 - th * th), da * th * sq * (1.0 - sq)
        return torch.cat([dlin, dq], dim=2), dlin
    z = s + xin
    if act_func == "relu":
        dz = da * (z.float() > 0).to(z.dtype)
    else:
        sz = sigmoid_bf16(z)
        dz = da * sz * (1.0 + z * (1.0 - sz))
    return dz, dz


def shift_pad_t(y, k: int, t_total: int):
    """Place ``y`` [B, t_out, C, V] at time offset ``k`` of a zero [B, t_total,
    C, V] (the transpose of a valid-conv tap's slice)."""
    return torch.nn.functional.pad(y, (0, 0, 0, 0, k, t_total - y.shape[1] - k))


def wsum_cv(a, b) -> torch.Tensor:
    """Σ over (b, t, v) of ``a[.., ca, v] · b[.., cb, v]`` → [ca, cb], float32."""
    return torch.einsum("btcv,btgv->cg", a.float(), b.float())


def tconv_bwd_cv(x, ds, kernel, kt: int):
    """Backward of :func:`tconv_cv` on bf16 operands (`_tconv_bwd_cv`,
    ``vertex_fused.py:348-360``): (dkernel, dbias) float32 sums; dx each tap's
    float32 sum rounded to bf16, the taps added in bf16, k = 0 .. kt-1."""
    t_out, t_total = ds.shape[1], x.shape[1]
    dk = torch.stack([wsum_cv(x[:, k:k + t_out], ds) for k in range(kt)])
    db = ds.float().sum((0, 1, 3))
    dx = None
    for k in range(kt):
        tap = shift_pad_t(_cdot(ds.float(), kernel[k].float().T).to(ds.dtype), k, t_total)
        dx = tap if dx is None else dx + tap
    return dk, db, dx


def ln_drop_bwd_cv(x, mu, rstd, lng, mask, dy):
    """The LayerNorm (and dropout) backward with given statistics, bf16
    (`_ln_drop_bwd`, ``vertex_fused.py:378-390``): ``dy · mask`` a bf16
    product, the rest in float32; returns (dx rounded to bf16, dmu, drstd
    [B, T, 1, 1] float32, dlng, dlnb summed over every (b, t) in float32,
    rounded to ``lng``'s type)."""
    xc = x.float() - mu
    dy32 = (dy if mask is None else dy * mask).float()
    dxn = dy32 * lng.float()
    dmu = -dxn.sum((2, 3), keepdim=True) * rstd
    drstd = (dxn * xc).sum((2, 3), keepdim=True)
    return ((dxn * rstd).to(x.dtype), dmu, drstd, (dy32 * (xc * rstd)).sum((0, 1)).to(lng.dtype),
            dy32.sum((0, 1)).to(lng.dtype))


def _drop_mask(drop: Drop | None, like: torch.Tensor, v_true: int):
    """The bf16 keep mask of a site (its scale rounded to bf16) shaped as
    ``like``, or None."""
    if drop is None:
        return None
    return dropout.keep_mask(drop, tuple(like.shape), v_true, device=like.device).to(BF16)


def _head_bwd_bf16(cfg: VertexBlockCfg, x, ln, w, gy, drop: Drop | None):
    """The plain K1b in bf16 (`_make_head_bwd_kernel`, ``vertex_fused.py:525-585``)."""
    c1k, c1b, gaw, _ = w
    x4, mask = x, None
    if cfg.apply_ln:
        mask = _drop_mask(drop, x, cfg.v_true)
        x4 = ln_normalize_cv(x, *ln)
        x4 = x4 if mask is None else x4 * mask
    s1 = tconv_cv(x4, c1k, c1b, cfg.kt)
    xin1 = pad_channels_cv(x4[:, cfg.kt - 1:], cfg.c0)
    a1 = gate_cv(cfg.act_func, s1, xin1, cfg.c0)
    da1 = _cdot(gy.float(), gaw.float().T).to(BF16)
    ds1, dxin1 = gate_bwd_cv(cfg.act_func, s1, xin1, cfg.c0, da1)
    dc1k, dc1b, dx4 = tconv_bwd_cv(x4, ds1, c1k, cfg.kt)
    dx4 = dx4 + shift_pad_t(dxin1[:, :, :cfg.c_in], cfg.kt - 1, cfg.t_in)
    dln = (ln_drop_bwd_cv(x, ln[0], ln[1], ln[2], mask, dx4) if cfg.apply_ln
           else (dx4, None, None, None, None))
    return (*dln, dc1k, dc1b, wsum_cv(a1, gy), gy.float().sum((0, 1, 3)))


def _tail_bwd_bf16(cfg: VertexBlockCfg, xg, terms, w, ga2, gps, gpss):
    """The plain K2b in bf16 (`_make_tail_bwd_kernel`, ``vertex_fused.py:797-836``)."""
    gcw, _, c2k, c2b = w
    cheb = cfg.graph_conv_type == "cheb_graph_conv"
    cterms = [xg, *terms] if cheb else list(terms)
    r = tail_preact(cfg, xg, terms, w)
    h = torch.relu(r)
    s2 = tconv_cv(h, c2k, c2b, cfg.kt)
    xin2 = pad_channels_cv(h[:, cfg.kt - 1:], cfg.c2)
    a2 = gate_cv(cfg.act_func, s2, xin2, cfg.c2)
    vm = (torch.arange(cfg.v_pad, device=ga2.device) < cfg.v_true).float()
    da2 = (ga2.float() + (gps + 2.0 * gpss * a2.float()) * vm).to(BF16)
    ds2, dxin2 = gate_bwd_cv(cfg.act_func, s2, xin2, cfg.c2, da2)
    dc2k, dc2b, dh = tconv_bwd_cv(h, ds2, c2k, cfg.kt)
    dh = dh + shift_pad_t(dxin2[:, :, :cfg.c1], cfg.kt - 1, cfg.t1)
    dr = dh * (r.float() > 0).to(BF16)
    dgcw = torch.stack([wsum_cv(t, dr) for t in cterms])
    dct = [_cdot(dr.float(), gcw[k].float().T).to(BF16) for k in range(len(cterms))]
    dxg = dr + dct[0] if cheb else dr
    return dxg, dct[1:] if cheb else dct, dgcw, dr.float().sum((0, 1, 3)), dc2k, dc2b


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def head_bwd_reference(cfg: VertexBlockCfg, x, ln, w, gy, drop: Drop | None = None):
    """Plain version of :func:`head_bwd`: autograd through
    :func:`head_reference` with the same mask; for bf16 operands the TPU's
    bf16 backward, rounding where it rounds, weight gradients float32."""
    if x.dtype == BF16:
        return _head_bwd_bf16(cfg, x, ln, w, gy, drop)
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
    [dterm per term], dgcw, dgcb, dc2k, dc2b). For bf16 operands the TPU's
    bf16 backward, rounding where it rounds, weight gradients float32
    (``relu_mask`` is not taken there)."""
    if xg.dtype == BF16:
        if relu_mask is not None:
            raise ValueError("relu_mask is a float32 check of the kernel's ReLU decisions")
        return _tail_bwd_bf16(cfg, xg, terms, w, ga2, gps, gpss)
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (xg, *terms, *w)]
        n = len(terms)
        outs = tail_reference(cfg, ins[0], ins[1:1 + n], ins[1 + n:], relu_mask)
        g = torch.autograd.grad(outs, ins, (ga2, gps, gpss), allow_unused=True)
    g = [torch.zeros_like(t) if d is None else d for t, d in zip(ins, g)]
    return g[0], g[1:1 + n], *g[1 + n:]


def _check_cfg(cfg: VertexBlockCfg) -> None:
    if cfg.precision not in PRECISIONS:
        raise ValueError(f"precision {cfg.precision!r}: one of {PRECISIONS}")
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
    b, cdt, f32 = x.shape[0], cfg.dtype, torch.float32
    ln_shapes = [(b, cfg.t_in, 1, 1)] * 2 + [(cfg.c_in, cfg.v_pad)] * 2
    ptrs = [require(x, "x", (b, cfg.t_in, cfg.c_in, cfg.v_pad), dev, cdt)]
    for name, t, shape, dt in zip(("mu", "rstd", "lng", "lnb"), (mu, rstd, lng, lnb), ln_shapes,
                                  (f32, f32, cdt, cdt)):
        ptrs.append(require(t, name, shape, dev, dt) if cfg.apply_ln else 0)
    ptrs += [require(c1k, "c1k", (cfg.kt, cfg.c_in, cfg.g1), dev, cdt),
             require(c1b, "c1b", (cfg.g1,), dev),
             require(gaw, "gaw", (cfg.c0, cfg.c1), dev, cdt),
             require(gab, "gab", (cfg.c1,), dev)]
    xg = torch.empty((b, cfg.t1, cfg.c1, cfg.v_pad), device=dev, dtype=cdt)
    name = launch_name("head_fwd", cfg.precision)
    err = getattr(_build.library(), f"stgcn_{name}")(
        *ptrs, xg.data_ptr(), b, cfg.t_in, cfg.c_in, cfg.v_pad, cfg.kt, cfg.c0, cfg.c1,
        ACT_CODES[cfg.act_func], int(cfg.apply_ln), cfg.v_true, *drop_args(drop),
        stream_of(dev))
    _build.check(name, err)
    count_launch(name)
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
    b, cdt = xg.shape[0], cfg.dtype
    act = (b, cfg.t1, cfg.c1, cfg.v_pad)
    cterms = [xg, *terms] if cfg.graph_conv_type == "cheb_graph_conv" else terms
    n_c = len(cterms)
    ct = [require(t, f"term{i}", act, dev, cdt) for i, t in enumerate(cterms)]
    ct += [0] * (3 - n_c)
    ptrs = [require(xg, "xg", act, dev, cdt), *ct,
            require(gcw, "gcw", (n_c, cfg.c1, cfg.c1), dev, cdt),
            require(gcb, "gcb", (cfg.c1,), dev),
            require(c2k, "c2k", (cfg.kt, cfg.c1, cfg.g2), dev, cdt),
            require(c2b, "c2b", (cfg.g2,), dev)]
    a2 = torch.empty((b, cfg.t2, cfg.c2, cfg.v_pad), device=dev, dtype=cdt)
    h = torch.empty(act, device=dev, dtype=cdt)   # scratch: the ReLU'd contraction
    part = torch.empty((b, cfg.t2, -(-cfg.c2 // GATE_PASS), cfg.v_pad // TILE_LANES, 2),
                       device=dev, dtype=torch.float32)
    ps = torch.empty((b, cfg.t2, 1, 1), device=dev, dtype=torch.float32)
    pss = torch.empty_like(ps)
    name = launch_name("tail_fwd", cfg.precision)
    err = getattr(_build.library(), f"stgcn_{name}")(
        *ptrs, a2.data_ptr(), h.data_ptr(), part.data_ptr(), ps.data_ptr(), pss.data_ptr(),
        b, cfg.t1, cfg.c1, cfg.v_pad, cfg.kt, n_c, cfg.c2, ACT_CODES[cfg.act_func],
        cfg.v_true, stream_of(dev))
    _build.check(name, err)
    count_launch(name)
    return a2, ps, pss


def head_bwd(cfg: VertexBlockCfg, x, mu, rstd, lng, lnb, c1k, c1b, gaw, gab, gy, *,
             drop: Drop | None = None):
    """K1b: the gradients of :func:`head_fwd` for the output cotangent ``gy``
    [B, t1, c1, Vp], recomputing the forward from its inputs and regenerating
    its mask. Returns ``(dx, dmu, drstd, dlng, dlnb, dc1k, dc1b, dgaw, dgab)``
    shaped as the inputs; the four LayerNorm entries are None unless
    ``cfg.apply_ln``. ``dx``, ``dlng`` and ``dlnb`` are in the operands' type
    (bf16 for the bf16 variant), the rest float32: the weight gradients are
    float32 sums, which the caller rounds to the weights' type."""
    _check_cfg(cfg)
    _check_drop(cfg, drop)
    ln = (mu, rstd, lng, lnb) if cfg.apply_ln else None
    if on_cpu(x):
        return head_bwd_reference(cfg, x, ln, (c1k, c1b, gaw, gab), gy, drop)
    dev = cuda_device(x)
    b, cdt, f32 = x.shape[0], cfg.dtype, torch.float32
    lib = _build.library()
    act = ACT_CODES[cfg.act_func]
    ins = [require(x, "x", (b, cfg.t_in, cfg.c_in, cfg.v_pad), dev, cdt)]
    ln_shapes = [(b, cfg.t_in, 1, 1)] * 2 + [(cfg.c_in, cfg.v_pad)] * 2
    for name, t, shape, dt in zip(("mu", "rstd", "lng", "lnb"), (mu, rstd, lng, lnb), ln_shapes,
                                  (f32, f32, cdt, cdt)):
        ins.append(require(t, name, shape, dev, dt) if cfg.apply_ln else 0)
    ins += [require(c1k, "c1k", (cfg.kt, cfg.c_in, cfg.g1), dev, cdt),
            require(c1b, "c1b", (cfg.g1,), dev),
            require(gaw, "gaw", (cfg.c0, cfg.c1), dev, cdt),
            require(gy, "gy", (b, cfg.t1, cfg.c1, cfg.v_pad), dev, cdt)]
    require(gab, "gab", (cfg.c1,), dev)

    def new(t, dt=f32):
        return torch.empty(t.shape, device=dev, dtype=dt)

    dx = torch.empty_like(x)
    dln = [new(mu), new(rstd), new(lng, cdt), new(lnb, cdt)] if cfg.apply_ln else [None] * 4
    dw = [new(t) for t in (c1k, c1b, gaw, gab)]
    sizes = (b, cfg.t_in, cfg.c_in, cfg.v_pad, cfg.kt, cfg.c0, cfg.c1, act, int(cfg.apply_ln))
    name = launch_name("head_bwd", cfg.precision)
    work = workspace(getattr(lib, f"stgcn_{name}_work")(*sizes), dev)
    outs = [dx, *dln, *dw]
    err = getattr(lib, f"stgcn_{name}")(
        *ins, *[0 if t is None else t.data_ptr() for t in outs], work.data_ptr(), *sizes,
        cfg.v_true, *drop_args(drop), stream_of(dev))
    _build.check(name, err)
    count_launch(name)
    return tuple(outs)


def tail_bwd(cfg: VertexBlockCfg, xg, t_a, t_b, gcw, gcb, c2k, c2b, ga2, gps, gpss):
    """K2b: the gradients of :func:`tail_fwd` for the cotangents ``ga2`` [B, t2,
    c2, Vp] of ``a2`` and ``gps``/``gpss`` [B, t2, 1, 1] of its LayerNorm
    partial sums, recomputing the forward. Returns ``(dxg, dt_a, dt_b, dgcw,
    dgcb, dc2k, dc2b)``; the gradient of a graph term the tail does not read
    (``t_b`` with one term) is zero. The data gradients are in the operands'
    type, the weight gradients float32 sums."""
    _check_cfg(cfg)
    terms = [t_a, t_b][: cfg.n_terms]
    if on_cpu(xg):
        dxg, dterms, *dw = tail_bwd_reference(cfg, xg, terms, (gcw, gcb, c2k, c2b), ga2, gps,
                                              gpss)
        dterms = [*dterms] + [torch.zeros_like(xg)] * (2 - len(dterms))
        return (dxg, *dterms, *dw)
    dev = cuda_device(xg)
    b, cdt = xg.shape[0], cfg.dtype
    lib = _build.library()
    cheb = cfg.graph_conv_type == "cheb_graph_conv"
    n_c = len(terms) + int(cheb)
    act = (b, cfg.t1, cfg.c1, cfg.v_pad)
    stat = (b, cfg.t2, 1, 1)
    term_ptrs = [require(t, f"term{i}", act, dev, cdt) for i, t in enumerate(terms)]
    ins = [require(xg, "xg", act, dev, cdt), *term_ptrs, *[0] * (2 - len(terms)),
           require(gcw, "gcw", (n_c, cfg.c1, cfg.c1), dev, cdt),
           require(gcb, "gcb", (cfg.c1,), dev),
           require(c2k, "c2k", (cfg.kt, cfg.c1, cfg.g2), dev, cdt),
           require(c2b, "c2b", (cfg.g2,), dev),
           require(ga2, "ga2", (b, cfg.t2, cfg.c2, cfg.v_pad), dev, cdt),
           require(gps, "gps", stat, dev), require(gpss, "gpss", stat, dev)]
    dxg = torch.empty_like(xg)
    dterms = [torch.empty_like(xg) if i < len(terms) else torch.zeros_like(xg)
              for i in range(2)]
    dw = [torch.empty(t.shape, device=dev, dtype=torch.float32) for t in (gcw, gcb, c2k, c2b)]
    sizes = (b, cfg.t1, cfg.c1, cfg.v_pad, cfg.kt, len(terms), int(cheb), cfg.c2,
             ACT_CODES[cfg.act_func])
    name = launch_name("tail_bwd", cfg.precision)
    work = workspace(getattr(lib, f"stgcn_{name}_work")(*sizes), dev)
    outs = [dxg, *dterms, *dw]
    err = getattr(lib, f"stgcn_{name}")(*ins, *[t.data_ptr() for t in outs], work.data_ptr(),
                                        *sizes, cfg.v_true, stream_of(dev))
    _build.check(name, err)
    count_launch(name)
    return tuple(outs)


# --------------------------------------------------------------------------
# autograd Functions: forward and backward kernels, inputs saved
# --------------------------------------------------------------------------

def as_input_types(grads, inputs) -> tuple:
    """Each gradient in its input's type: the backward kernels' float32
    weight gradients rounded to a bf16 weight's type, as the TPU's
    ``custom_vjp`` casts them (``stgcn_tpu/kernels/vertex_fused.py:753-754``)."""
    return tuple(None if g is None else g.to(t.dtype) for g, t in zip(grads, inputs))


class _HeadFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, drop, x, mu, rstd, lng, lnb, c1k, c1b, gaw, gab):
        ctx.cfg, ctx.drop = cfg, drop
        ctx.save_for_backward(x, mu, rstd, lng, lnb, c1k, c1b, gaw, gab)
        return head_fwd(cfg, x, mu, rstd, lng, lnb, c1k, c1b, gaw, gab, drop=drop)

    @staticmethod
    def backward(ctx, gy):
        saved = ctx.saved_tensors   # once: a checkpoint's replay unpacks each tensor once
        grads = head_bwd(ctx.cfg, *saved, gy.contiguous(), drop=ctx.drop)
        return (None, None, *as_input_types(grads, saved))


class _TailFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, xg, t_a, t_b, gcw, gcb, c2k, c2b):
        ctx.cfg = cfg
        ctx.save_for_backward(xg, t_a, t_b, gcw, gcb, c2k, c2b)
        return tail_fwd(cfg, xg, t_a, t_b, gcw, gcb, c2k, c2b)

    @staticmethod
    def backward(ctx, ga2, gps, gpss):
        saved = ctx.saved_tensors   # once: a checkpoint's replay unpacks each tensor once
        xg = saved[0]
        b = xg.shape[0]
        cfg = ctx.cfg
        if ga2 is None:
            ga2 = xg.new_zeros((b, cfg.t2, cfg.c2, cfg.v_pad))
        stat = (b, cfg.t2, 1, 1)
        gps = xg.new_zeros(stat, dtype=torch.float32) if gps is None else gps
        gpss = xg.new_zeros(stat, dtype=torch.float32) if gpss is None else gpss
        grads = tail_bwd(cfg, *saved, ga2.contiguous(), gps.contiguous(), gpss.contiguous())
        return (None, *as_input_types(grads, saved))


def head_fused(cfg: VertexBlockCfg, x, mu, rstd, lng, lnb, c1k, c1b, gaw, gab, *,
               drop: Drop | None = None) -> torch.Tensor:
    """Differentiable K1: :func:`head_fwd` forward, :func:`head_bwd` backward."""
    return _HeadFused.apply(cfg, drop, x, mu, rstd, lng, lnb, c1k, c1b, gaw, gab)


def tail_fused(cfg: VertexBlockCfg, xg, t_a, t_b, gcw, gcb, c2k, c2b):
    """Differentiable K2: :func:`tail_fwd` forward, :func:`tail_bwd` backward."""
    return _TailFused.apply(cfg, xg, t_a, t_b, gcw, gcb, c2k, c2b)
