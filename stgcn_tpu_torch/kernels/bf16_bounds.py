"""How far a bf16 forward kernel (K1f-K4f's bf16 variants) may lie from its
plain version, and the check that holds it there.

A bf16 kernel and its plain version round at the same points, but each sums
its float32 products in another order. Where such a sum lies near the
midpoint of two bf16 values, the two round it to neighbours, one bf16 ulp
(at most 2^-7 of the value) apart; that happens about once in 2^16 sums,
so every large output holds some. A neighbour moves each later value that
reads it by at most an ulp of the neighbour times the value's sensitivity,
and the gates, normalizations and products after it pass that on. So each
output element is held within ``2^-7 · (|ref| + M) + 1e-4 · min(1, max
|ref|)``, where ``M`` is the rounding scale of the element: the magnitude
of every term its value sums, carried through the function as its forward
error bound is (a sum's M is the sum of its terms' |w|·M plus |bias|; a
gate's the M of its linear half and residual, plus its gate half's M times
|lin| + 1, which bounds σ' and tanh'). ``M`` is computed from the plain
version's own values, in float32. That bound is loose (``M`` sums
magnitudes), so the neighbours must also be rare: at most a fraction
2^-10 of an output's elements may lie outside the strict 2-ulp bound
``2^-7 · |ref| + floor``. A rounding point missed or added, or any other
fault that moves most elements, fails there.

The functions here return ``M`` per output, shaped as the outputs of the
plain version (``head_reference``, ``tail_reference``, ``ohead_reference``,
``ofc_reference``); :func:`within` checks a kernel's outputs against its
plain version's with them.
"""

from __future__ import annotations

import torch

from stgcn_tpu_torch.kernels import dropout
from stgcn_tpu_torch.kernels.vertex_fused import (
    gate_cv, linear_cv, ln_normalize_cv, masked_ln_sums, pad_channels_cv, tail_preact, tconv_cv)

REL = 2.0 ** -7      # two ulps of bf16 (8 significant bits)
FLOOR = 1e-4         # times min(1, max |ref|): float32 sums in another order
RARE = 2.0 ** -10    # the largest share of an output's elements outside 2 ulps


def _abs(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().abs()


def _gate_scale(act_func: str, s, xin, m_s, m_xin, c: int) -> torch.Tensor:
    """M of a gate's output from its inputs (s, xin) and their M."""
    if act_func in ("glu", "gtu"):
        lin = (s[:, :, :c].float() + xin.float()).abs()
        return m_s[:, :, :c] + m_xin + (lin + 1.0) * m_s[:, :, c:]
    return 2.0 * (m_s + m_xin)


def _conv_gate(act_func: str, kt: int, c0: int, x, m_x, kernel, bias):
    """(the plain gated output, its M): conv ``kernel`` over ``x`` (bf16)
    whose M is ``m_x``, then the gate with the in-gate residual."""
    s, xin = tconv_cv(x, kernel, bias, kt), pad_channels_cv(x[:, kt - 1:], c0)
    m_s = tconv_cv(m_x, _abs(kernel), _abs(bias), kt)
    return gate_cv(act_func, s, xin, c0), _gate_scale(
        act_func, s, xin, m_s, pad_channels_cv(m_x[:, kt - 1:], c0), c0)


def _sums_scale(a, m_a, v_true: int):
    """M of the LayerNorm partial sums (Σ a, Σ a²) of ``a`` whose M is ``m_a``."""
    m_ps, _ = masked_ln_sums(m_a, v_true)
    m_pss, _ = masked_ln_sums(2.0 * _abs(a) * m_a + m_a * m_a, v_true)
    return m_ps, m_pss


def head_scale(cfg, x, ln, w, drop=None) -> torch.Tensor:
    """M of K1f's xg (``head_reference``'s arguments)."""
    c1k, c1b, gaw, gab = w
    if cfg.apply_ln:
        x = dropout.apply_cv(ln_normalize_cv(x, *ln), drop, cfg.v_true)
    _, m_a = _conv_gate(cfg.act_func, cfg.kt, cfg.c0, x, _abs(x), c1k, c1b)
    return linear_cv(m_a, _abs(gaw), _abs(gab))


def tail_scale(cfg, xg, terms, w):
    """M of K2f's (a2, ps, pss) (``tail_reference``'s arguments)."""
    gcw, gcb, c2k, c2b = w
    h = torch.relu(tail_preact(cfg, xg, terms, w))
    m_h = tail_preact(cfg, _abs(xg), [_abs(t) for t in terms], (_abs(gcw), _abs(gcb)))
    a2, m_a = _conv_gate(cfg.act_func, cfg.kt, cfg.c2, h, m_h, c2k, c2b)
    return (m_a, *_sums_scale(a2, m_a, cfg.v_true))


def ohead_scale(cfg, x, mu, rstd, lng, lnb, ck, cb, drop=None):
    """M of K3f's (a, ps, pss) (``ohead_reference``'s arguments)."""
    xn = dropout.apply_cv(ln_normalize_cv(x, mu, rstd, lng, lnb), drop, cfg.v_true)
    a, m_a = _conv_gate(cfg.act_func, cfg.ko, cfg.c0, xn, _abs(xn), ck, cb)
    return (m_a, *_sums_scale(a, m_a, cfg.v_true))


def ofc_scale(cfg, a, mu, rstd, lnw, lnb, w1, b1, w2, b2, drop=None) -> torch.Tensor:
    """M of K4f's output (``ofc_reference``'s arguments)."""
    m_z = linear_cv(_abs(ln_normalize_cv(a, mu, rstd, lnw, lnb)), _abs(w1), _abs(b1))
    return linear_cv(dropout.apply_cv(m_z, drop, cfg.v_true), _abs(w2), _abs(b2))


def within(got, ref, scale, *, rel: float = REL, floor: float = FLOOR,
           rare: float = RARE) -> dict:
    """Hold each output of a bf16 kernel (a tensor or a tuple, as the plain
    version returns) against the plain version's ``ref`` with rounding scale
    ``scale``: raises ``AssertionError`` where an element lies outside
    ``rel · (|ref| + M) + floor · min(1, max |ref|)``, where more than a
    share ``rare`` of an output's elements lie outside the strict ``rel ·
    |ref| + floor · min(1, max |ref|)``, or where the dtypes or shapes
    differ. Returns max |Δ|, each output's max |ref| and, per output, the
    count of elements outside the strict bound (the neighbours)."""
    as_list = (lambda o: list(o) if isinstance(o, (tuple, list)) else [o])
    got, ref, scale = as_list(got), as_list(ref), as_list(scale)
    worst, ref_max, strict = 0.0, [], []
    for i, (g, r, m) in enumerate(zip(got, ref, scale)):
        if g.dtype != r.dtype or g.shape != r.shape or not torch.isfinite(g).all():
            raise AssertionError(f"output {i}: {g.dtype} {tuple(g.shape)} against {r.dtype} "
                                 f"{tuple(r.shape)}, or non-finite values")
        g32, r32 = g.detach().float(), r.detach().float()
        d = (g32 - r32).abs()
        ref_max.append(float(r32.abs().max()))
        fl = floor * min(1.0, ref_max[-1])
        bad = d > rel * (r32.abs() + m.float()) + fl
        if bad.any():
            raise AssertionError(f"output {i}: {int(bad.sum())} of {bad.numel()} elements "
                                 f"outside the bf16 bound (max |Δ| {float(d.max()):.3e}, "
                                 f"max |ref| {ref_max[-1]:.3e})")
        strict.append(int((d > rel * r32.abs() + fl).sum()))
        if strict[-1] > rare * d.numel():
            raise AssertionError(f"output {i}: {strict[-1]} of {d.numel()} elements outside 2 "
                                 f"ulps of bf16, more than a share {rare} (max |Δ| "
                                 f"{float(d.max()):.3e}, max |ref| {ref_max[-1]:.3e})")
        worst = max(worst, float(d.max()))
    return {"max_abs_err": worst, "ref_max": ref_max, "outside_2ulp": strict}
