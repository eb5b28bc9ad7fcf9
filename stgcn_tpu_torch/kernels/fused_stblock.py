"""K12: one whole ST block on a dense GSO, forward and backward (port of
``stgcn_tpu/kernels/fused_stblock.py``).

One STConvBlock, the reference "TGTND" sandwich (`model/layers.py:233-258`):
temporal gated conv 1 → bottleneck align → Chebyshev chain on the dense
GSO (or the first-order ``graph_conv``) → weight contraction + residual →
ReLU → temporal gated conv 2 → LayerNorm over (V, C) with eps 1e-12 →
dropout. :func:`stblock_fwd` (K12f, TPU ``_fwd_pallas``) computes it;
:func:`stblock_bwd` (K12b, TPU ``_bwd_pallas``) recomputes the forward from
its inputs and applies the chain rule of ``_backward_pieces``, giving the
input gradient and the ten weight gradients. :func:`fused_st_block` wraps
both as a ``torch.autograd.Function`` that saves only its inputs, as the
TPU's ``custom_vjp`` does, and takes one ST block's entries of the port's
``state_dict``. No gradient reaches the GSO, as in JAX (where it is zeros).

Operands are channels-last ``[B, T, V, C]`` float32 with the true vertex
count V: the TPU's 16-row vertex padding, its batch tiles and its padding
of ``c_in < 8`` are VMEM arithmetic, not semantics. The CUDA sources are
``csrc/fused_stblock.cu`` (K12f and the forward recompute shared with K12b)
and ``csrc/fused_stblock_bwd.cu`` (K12b); their notes give the design. The
dropout mask is keyed by element (:mod:`.dropout`), so the block drops what
the unfused ``STConvBlock`` drops at the same site. Each wrapper runs its
kernel on a CUDA tensor and its plain PyTorch version on a CPU tensor
(:func:`st_block_reference`; the backward's is autograd through it with the
same mask), and counts its launches. The bf16 variant is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from stgcn_tpu_torch.kernels import _build, dropout
from stgcn_tpu_torch.kernels._launch import (
    ACT_CODES, MAX_OUT, count_launch, cuda_device, drop_args, on_cpu, require, stream_of,
    workspace)
from stgcn_tpu_torch.kernels.dropout import Drop

GRAPH_CONV_CODES = {"cheb_graph_conv": 0, "graph_conv": 1}


@dataclasses.dataclass(frozen=True)
class FusedBlockConfig:
    """Static configuration of one fused ST block (the semantic fields of the
    JAX ``FusedBlockConfig``)."""

    kt: int
    ks: int
    act_func: str            # glu | gtu | relu | silu
    graph_conv_type: str     # cheb_graph_conv | graph_conv
    droprate: float
    v_true: int              # vertex count
    t_in: int
    c_in: int
    c0: int                  # temporal-gate width
    c1: int                  # graph-conv (bottleneck) width
    c2: int                  # second temporal-gate width
    training: bool           # apply dropout
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
    def n_w(self) -> int:
        """Terms of the graph-conv weight contraction."""
        return 1 if self.graph_conv_type == "graph_conv" else self.ks

    def weight_shapes(self) -> tuple[tuple[int, ...], ...]:
        """Shapes of (c1k, c1b, gaw, gab, gcw, gcb, c2k, c2b, lng, lnb)."""
        return ((self.kt, self.c_in, self.g1), (self.g1,), (self.c0, self.c1), (self.c1,),
                (self.n_w, self.c1, self.c1), (self.c1,), (self.kt, self.c1, self.g2),
                (self.g2,), (self.v_true, self.c2), (self.v_true, self.c2))


# --------------------------------------------------------------------------
# plain PyTorch version (channels-last, whole batch)
# --------------------------------------------------------------------------

def tconv_nm(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
             kt: int) -> torch.Tensor:
    """Valid temporal conv, one ``[.., c_in] @ [c_in, c_out]`` per tap."""
    t_out = x.shape[1] - kt + 1
    acc = torch.matmul(x[:, 0:t_out], kernel[0])
    for k in range(1, kt):
        acc = acc + torch.matmul(x[:, k:k + t_out], kernel[k])
    return acc + bias


def gate_nm(act: str, s: torch.Tensor, xin: torch.Tensor, c: int) -> torch.Tensor:
    """Gate with the in-gate residual (`model/layers.py:105,109,111-115`);
    ``xin`` zero-padded to ``c`` channels (`layers.py:17-19`)."""
    xin = F.pad(xin, (0, c - xin.shape[-1]))
    if act in ("glu", "gtu"):
        lin = s[..., :c] + xin
        if act == "gtu":
            lin = torch.tanh(lin)
        return lin * torch.sigmoid(s[..., c:])
    z = s + xin
    return torch.relu(z) if act == "relu" else F.silu(z)


def relu_input(cfg: FusedBlockConfig, x, gso, w) -> torch.Tensor:
    """The block's ReLU input ``r = Σ_k T_k W_k + b + xg`` ``[B, t1, V, c1]``,
    as the plain version computes it."""
    c1k, c1b, gaw, gab, gcw, gcb = w[:6]
    a1 = gate_nm(cfg.act_func, tconv_nm(x, c1k, c1b, cfg.kt), x[:, cfg.kt - 1:], cfg.c0)
    xg = torch.matmul(a1, gaw) + gab
    if cfg.graph_conv_type == "graph_conv":
        terms = [torch.matmul(gso, xg)]
    else:   # T_0 = x, T_1 = G x, T_k = 2 G T_{k-1} - T_{k-2} (`layers.py:146-168`)
        terms = [xg]
        if cfg.ks >= 2:
            terms.append(torch.matmul(gso, xg))
        for _ in range(2, cfg.ks):
            terms.append(2.0 * torch.matmul(gso, terms[-1]) - terms[-2])
    out = torch.matmul(terms[0], gcw[0])
    for k in range(1, len(terms)):
        out = out + torch.matmul(terms[k], gcw[k])
    return out + gcb + xg


def st_block_reference(cfg: FusedBlockConfig, x, gso, w, drop: Drop | None = None,
                       relu_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of :func:`stblock_fwd` (the JAX ``_forward_pieces``,
    ``:333-375``, over the whole batch): ``x`` [B, t_in, V, c_in], ``gso``
    [V, V], ``w`` = (c1k, c1b, gaw, gab, gcw, gcb, c2k, c2b, lng, lnb) shaped
    as :meth:`FusedBlockConfig.weight_shapes`; returns [B, t2, V, c2].
    ``relu_mask`` (1 where the ReLU passes, ``[B, t1, V, c1]``) replaces the
    ReLU's own decisions when given."""
    c2k, c2b, lng, lnb = w[6:]
    r = relu_input(cfg, x, gso, w)
    h = torch.relu(r) if relu_mask is None else r * relu_mask
    a2 = gate_nm(cfg.act_func, tconv_nm(h, c2k, c2b, cfg.kt), h[:, cfg.kt - 1:], cfg.c2)
    # LayerNorm over (V, C) per (b, t), two-pass statistics (`layers.py:246`)
    mu = a2.mean(dim=(2, 3), keepdim=True)
    var = ((a2 - mu) ** 2).mean(dim=(2, 3), keepdim=True)
    y = (a2 - mu) * torch.rsqrt(var + 1e-12) * lng + lnb
    return dropout.apply_channels_last(y, drop)


def ln_stats_cotangents(mu, rstd, dmu, drstd, count: int):
    """Plain version of K12b's ``ln_cotangents_kernel``: the chain through the
    LayerNorm statistics, ``(dmu − drstd·rstd³·(a − mu)) / count`` for each
    element a of a (b, t) row, written as ``gps + 2·gpss·a`` so that K12b's
    gate pass adds it as K2b's adds its LayerNorm-partial cotangents.
    ``dmu``/``drstd`` are the gradients of the row's ``mu``/``rstd`` through
    the normalized output alone; ``count`` = V·c2. Returns ``(gps, gpss)``,
    shaped as ``mu``."""
    k = drstd * rstd * rstd * rstd
    inv = 1.0 / count
    return (dmu + k * mu) * inv, -0.5 * k * inv


def st_block_bwd_reference(cfg: FusedBlockConfig, x, gso, w, gy, drop: Drop | None = None,
                           relu_mask: torch.Tensor | None = None):
    """Plain version of :func:`stblock_bwd`: autograd through
    :func:`st_block_reference` with the same mask (and ReLU decisions when
    ``relu_mask`` is given); returns (dx, *dw)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (x, *w)]
        y = st_block_reference(cfg, ins[0], gso.detach(), ins[1:], drop, relu_mask)
        g = torch.autograd.grad(y, ins, gy, allow_unused=True)
    return tuple(torch.zeros_like(t) if d is None else d for t, d in zip(ins, g))


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def _check(cfg: FusedBlockConfig, drop: Drop | None) -> None:
    if cfg.precision != "default":
        raise NotImplementedError(f"precision {cfg.precision!r}: the bf16 variant of K12 is "
                                  "not ported yet")
    if cfg.act_func not in ACT_CODES:
        raise ValueError(f"unknown act_func {cfg.act_func!r}")
    if cfg.graph_conv_type not in GRAPH_CONV_CODES:
        raise ValueError(f"unknown graph_conv_type {cfg.graph_conv_type!r}")
    if cfg.c_in > cfg.c0 or cfg.c1 > cfg.c2:
        raise ValueError("the fused block supports zero-pad residual aligns only "
                         "(c_in <= c0, c1 <= c2)")
    if cfg.ks < 1 or cfg.t1 < 1 or cfg.t2 < 0:
        raise ValueError(f"Ks {cfg.ks} and t1 {cfg.t1} must be positive, t2 {cfg.t2} not "
                         "negative")
    if (drop is not None) != cfg.training:
        raise ValueError(f"cfg.training is {cfg.training} but drop is {drop}")


def _kernel_ptrs(cfg: FusedBlockConfig, x, gso, w, dev) -> list[int]:
    if cfg.c1 > MAX_OUT:
        raise ValueError(f"c1 {cfg.c1} > {MAX_OUT}: the head kernel keeps c1 sums in registers")
    names = ("c1k", "c1b", "gaw", "gab", "gcw", "gcb", "c2k", "c2b", "lng", "lnb")
    return [require(x, "x", (x.shape[0], cfg.t_in, cfg.v_true, cfg.c_in), dev),
            require(gso, "gso", (cfg.v_true, cfg.v_true), dev),
            *[require(t, n, s, dev) for t, n, s in zip(w, names, cfg.weight_shapes())]]


def _sizes(cfg: FusedBlockConfig, b: int) -> tuple[int, ...]:
    return (b, cfg.t_in, cfg.v_true, cfg.c_in, cfg.kt, cfg.ks, cfg.c0, cfg.c1, cfg.c2,
            ACT_CODES[cfg.act_func], GRAPH_CONV_CODES[cfg.graph_conv_type])


def stblock_fwd(cfg: FusedBlockConfig, x, gso, c1k, c1b, gaw, gab, gcw, gcb, c2k, c2b, lng,
                lnb, *, drop: Drop | None = None,
                relu_out: torch.Tensor | None = None) -> torch.Tensor:
    """K12f: ``x`` [B, t_in, V, c_in], ``gso`` [V, V] → ``y`` [B, t2, V, c2].
    Weights shaped as :meth:`FusedBlockConfig.weight_shapes`; ``drop`` is the
    block's dropout site (training). ``relu_out`` [B, t1, V, c1], when given,
    receives the kernel's ReLU output ``h``, whose signs are its ReLU
    decisions (a check holds the plain backward to them)."""
    _check(cfg, drop)
    w = (c1k, c1b, gaw, gab, gcw, gcb, c2k, c2b, lng, lnb)
    if on_cpu(x):
        if relu_out is not None:
            relu_out.copy_(torch.relu(relu_input(cfg, x, gso, w)))
        return st_block_reference(cfg, x, gso, w, drop)
    dev = cuda_device(x)
    b = x.shape[0]
    if cfg.t2 == 0:   # the last block of a Ko = 0 plan: an empty output, nothing to launch
        return x.new_empty((b, 0, cfg.v_true, cfg.c2))
    lib = _build.library()
    ptrs = _kernel_ptrs(cfg, x, gso, w, dev)
    h_ptr = require(relu_out, "relu_out", (b, cfg.t1, cfg.v_true, cfg.c1), dev)
    sizes = _sizes(cfg, b)
    y = torch.empty((b, cfg.t2, cfg.v_true, cfg.c2), device=dev, dtype=torch.float32)
    work = workspace(lib.stgcn_stblock_fwd_work(*sizes), dev)
    err = lib.stgcn_stblock_fwd(*ptrs, y.data_ptr(), h_ptr, work.data_ptr(), *sizes,
                                *drop_args(drop), stream_of(dev))
    _build.check("stblock_fwd", err)
    count_launch("stblock_fwd")
    return y


def stblock_bwd(cfg: FusedBlockConfig, x, gso, c1k, c1b, gaw, gab, gcw, gcb, c2k, c2b, lng,
                lnb, gy, *, drop: Drop | None = None):
    """K12b: the gradients of :func:`stblock_fwd` for the output cotangent
    ``gy`` [B, t2, V, c2], recomputing the forward from its inputs and
    regenerating its mask. Returns ``(dx, dc1k, dc1b, dgaw, dgab, dgcw, dgcb,
    dc2k, dc2b, dlng, dlnb)`` shaped as the inputs; the weight gradients are
    summed over the batch in float32."""
    _check(cfg, drop)
    w = (c1k, c1b, gaw, gab, gcw, gcb, c2k, c2b, lng, lnb)
    if on_cpu(x):
        return st_block_bwd_reference(cfg, x, gso, w, gy, drop)
    dev = cuda_device(x)
    b = x.shape[0]
    if cfg.t2 == 0:   # an empty output depends on nothing
        return tuple(torch.zeros_like(t) for t in (x, *w))
    lib = _build.library()
    ptrs = _kernel_ptrs(cfg, x, gso, w, dev)
    ptrs.append(require(gy, "gy", (b, cfg.t2, cfg.v_true, cfg.c2), dev))
    outs = [torch.empty_like(t) for t in (x, *w)]
    sizes = _sizes(cfg, b)
    work = workspace(lib.stgcn_stblock_bwd_work(*sizes), dev)
    err = lib.stgcn_stblock_bwd(*ptrs, *[t.data_ptr() for t in outs], work.data_ptr(), *sizes,
                                *drop_args(drop), stream_of(dev))
    _build.check("stblock_bwd", err)
    count_launch("stblock_bwd")
    return tuple(outs)


# --------------------------------------------------------------------------
# autograd Function and the block's public entry
# --------------------------------------------------------------------------

class _FusedBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, drop, x, gso, *w):
        ctx.cfg, ctx.drop = cfg, drop
        ctx.save_for_backward(x, gso, *w)
        return stblock_fwd(cfg, x, gso, *w, drop=drop)

    @staticmethod
    def backward(ctx, gy):
        x, gso, *w = ctx.saved_tensors
        dx, *dw = stblock_bwd(ctx.cfg, x, gso, *w, gy.contiguous(), drop=ctx.drop)
        return (None, None, dx, None, *dw)   # no gradient for the GSO, as in JAX


def block_weights(blk: dict, graph_conv_type: str):
    """One ST block's weights, from its ``state_dict`` entries (prefix
    removed), in the kernels' layouts: (c1k [kt, c_in, g1], c1b, gaw
    [c0, c1], gab, gcw [n_w, c1, c1], gcb, c2k [kt, c1, g2], c2b, lng
    [V, c2], lnb). Differentiable: autograd carries the gradients back to
    the parameters' own layouts."""
    def conv(name):  # [g, c_in, kt, 1] → [kt, c_in, g]
        return blk[f"{name}.causal_conv.weight"][..., 0].permute(2, 1, 0).contiguous()

    if "graph_conv.align.align_conv.weight" not in blk:
        raise NotImplementedError("the fused block needs the bottleneck align (c0 > c1)")
    gaw = blk["graph_conv.align.align_conv.weight"].T.contiguous()
    if graph_conv_type == "cheb_graph_conv":
        gcw = blk["graph_conv.cheb_graph_conv.weight"].contiguous()
        gcb = blk.get("graph_conv.cheb_graph_conv.bias")
    else:
        gcw = blk["graph_conv.graph_conv.weight"][None].contiguous()
        gcb = blk.get("graph_conv.graph_conv.bias")
    if gcb is None:
        gcb = torch.zeros(gcw.shape[-1], device=gcw.device)
    return (conv("tmp_conv1"), blk["tmp_conv1.causal_conv.bias"], gaw,
            blk["graph_conv.align.align_conv.bias"], gcw, gcb,
            conv("tmp_conv2"), blk["tmp_conv2.causal_conv.bias"],
            blk["ln.weight"], blk["ln.bias"])


def fused_st_block(x: torch.Tensor, gso: torch.Tensor, params: dict, *, kt: int, ks: int,
                   act_func: str, graph_conv_type: str, droprate: float, deterministic: bool,
                   seed: int | None = None, site: int) -> torch.Tensor:
    """Apply one fused STConvBlock (the JAX ``fused_st_block``, ``:756``).

    ``x``: [B, T, V, c_in]; ``gso``: dense [V, V]; ``params``: one ST block's
    entries of the port's ``state_dict`` with the ``st_block_<l>.`` prefix
    removed (the same weights the unfused model trains). Training
    (``deterministic=False`` with a nonzero ``droprate``) drops the
    LayerNorm output with the masks of ``Drop(droprate, seed, site)``.
    Returns [B, T − 2(kt − 1), V, c2], differentiable in ``x`` and the
    weights (K12b), not in ``gso``."""
    training = not deterministic and droprate > 0.0
    if training and seed is None:
        raise ValueError("training with dropout needs the step's dropout seed (seed=...)")
    w = block_weights(params, graph_conv_type)
    b, t_in, v, c_in = x.shape
    c0, c1 = w[2].shape
    cfg = FusedBlockConfig(kt=kt, ks=ks, act_func=act_func, graph_conv_type=graph_conv_type,
                           droprate=droprate, v_true=v, t_in=t_in, c_in=c_in, c0=c0, c1=c1,
                           c2=w[8].shape[-1], training=training)
    drop = Drop(droprate, seed, site) if training else None
    return _FusedBlock.apply(cfg, drop, x.float().contiguous(), gso.float().contiguous(),
                             *(t.contiguous() for t in w))
