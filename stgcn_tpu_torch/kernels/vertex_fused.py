"""K1 (block head) and K2 (block tail) of the vertex-fused ST block, forward
(port of ``stgcn_tpu/kernels/vertex_fused.py``).

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

All large operands are channel-before-vertex ``[B, T, C, Vp]`` float32, as
on the TPU. The CUDA sources are ``csrc/gate_gemm.cu`` (K1's body) and
``csrc/vertex_fused.cu`` (K2, and both C entry points); their notes say
what bounds each kernel and how the design answers it. Every wrapper runs
its kernel on a CUDA tensor and its plain PyTorch version
(:func:`head_reference`, :func:`tail_reference`) on a CPU tensor; ``launches``
on each wrapper counts kernel launches. The bf16 variants (``precision=
"bfloat16"`` on the TPU) are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses

import torch

from stgcn_tpu_torch.kernels import _build
from stgcn_tpu_torch.kernels._launch import (
    ACT_CODES, LANES, MAX_OUT, cuda_device, on_cpu, require, stream_of)


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


def head_reference(cfg: VertexBlockCfg, x, ln, w) -> torch.Tensor:
    """Plain version of :func:`head_fwd`. ``ln`` = (mu, rstd, lng, lnb) or
    None when ``not cfg.apply_ln``; ``w`` = (c1k, c1b, gaw, gab)."""
    c1k, c1b, gaw, gab = w
    if cfg.apply_ln:
        x = ln_normalize_cv(x, *ln)
    s1 = tconv_cv(x, c1k, c1b, cfg.kt)
    a1 = gate_cv(cfg.act_func, s1, pad_channels_cv(x[:, cfg.kt - 1:], cfg.c0), cfg.c0)
    return _cdot(a1, gaw) + gab[:, None]


def _tail_core(cfg: VertexBlockCfg, xg, terms, w) -> torch.Tensor:
    gcw, gcb, c2k, c2b = w
    cterms = [xg, *terms] if cfg.graph_conv_type == "cheb_graph_conv" else list(terms)
    out = _cdot(cterms[0], gcw[0])
    for k in range(1, len(cterms)):
        out = out + _cdot(cterms[k], gcw[k])
    h = torch.relu(out + gcb[:, None] + xg)
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


def tail_reference(cfg: VertexBlockCfg, xg, terms, w):
    """Plain version of :func:`tail_fwd`; returns (a2, ps, pss)."""
    a2 = _tail_core(cfg, xg, terms, w)
    return (a2, *masked_ln_sums(a2, cfg.v_true))


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def _check_cfg(cfg: VertexBlockCfg) -> None:
    if cfg.precision != "default":
        raise NotImplementedError(f"precision {cfg.precision!r}: the bf16 kernel variants "
                                  "are not ported yet")
    if cfg.act_func not in ACT_CODES:
        raise ValueError(f"unknown act_func {cfg.act_func!r}")
    if cfg.v_pad % LANES:
        raise ValueError(f"v_pad {cfg.v_pad} is not a multiple of {LANES}")
    if cfg.c1 > MAX_OUT:
        raise ValueError(f"c1 {cfg.c1} > {MAX_OUT}: the kernels keep c1 sums in registers")
    if cfg.c_in > cfg.c0 or cfg.c1 > cfg.c2:
        raise ValueError("the fused block supports zero-pad residual aligns only "
                         "(c_in <= c0, c1 <= c2)")


def head_fwd(cfg: VertexBlockCfg, x, mu, rstd, lng, lnb, c1k, c1b, gaw, gab) -> torch.Tensor:
    """K1: ``x`` [B, t_in, c_in, Vp] → ``xg`` [B, t1, c1, Vp]. When
    ``cfg.apply_ln`` the input is first normalized with ``mu``/``rstd``
    [B, t_in, 1, 1] and the affine ``lng``/``lnb`` [c_in, Vp]; otherwise
    those four may be None. Weights: ``c1k`` [kt, c_in, g1], ``c1b`` [g1],
    ``gaw`` [c0, c1], ``gab`` [c1]."""
    _check_cfg(cfg)
    if on_cpu(x):
        ln = (mu, rstd, lng, lnb) if cfg.apply_ln else None
        return head_reference(cfg, x, ln, (c1k, c1b, gaw, gab))
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
        ACT_CODES[cfg.act_func], int(cfg.apply_ln), stream_of(dev))
    _build.check("head_fwd", err)
    head_fwd.launches += 1
    return xg


head_fwd.launches = 0


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
    part = torch.empty((b, cfg.t2, cfg.v_pad // LANES, 2), device=dev, dtype=torch.float32)
    ps = torch.empty((b, cfg.t2, 1, 1), device=dev, dtype=torch.float32)
    pss = torch.empty_like(ps)
    err = _build.library().stgcn_tail_fwd(
        *ptrs, a2.data_ptr(), part.data_ptr(), ps.data_ptr(), pss.data_ptr(),
        b, cfg.t1, cfg.c1, cfg.v_pad, cfg.kt, n_c, cfg.c2, ACT_CODES[cfg.act_func],
        cfg.v_true, stream_of(dev))
    _build.check("tail_fwd", err)
    tail_fwd.launches += 1
    return a2, ps, pss


tail_fwd.launches = 0
