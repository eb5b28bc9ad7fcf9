"""How far a bf16 kernel (K1f-K4f's and K1b-K4b's bf16 variants) may lie from
its plain version, and the check that holds it there.

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

The backward kernels' bf16 outputs (the data gradients, the LayerNorm affine
gradients) are held the same way; their ``M`` (``head_bwd_scale`` ..
``ofc_bwd_scale``) carries the forward's through the backward: a product's M
sums |cotangent|·M(weight) and (|cotangent| + M(cotangent))·|weight|; a
gate's derivative moves by the M of its inputs times a bound of its own
derivative; a ReLU whose input lies within rounding of 0 may decide the
other way, which moves its output by the whole upstream gradient, not by
an ulp of it: there M gains |upstream| / 2^-7, so that the bound holds
it. Their
float32 outputs (weight and bias gradients, the LayerNorm statistics'
gradients) sum many bf16-valued terms: a neighbour moves one term by an ulp,
so :func:`within_grads` holds them in relative L2, within ``2^-8`` of the
plain version's norm.
"""

from __future__ import annotations

import torch

from stgcn_tpu_torch.kernels import dropout
from stgcn_tpu_torch.kernels.vertex_fused import (
    BF16, _cdot, _drop_mask, gate_bwd_cv, gate_cv, linear_cv, ln_normalize_cv, masked_ln_sums,
    pad_channels_cv, shift_pad_t, tail_preact, tconv_bwd_cv, tconv_cv)

REL = 2.0 ** -7      # two ulps of bf16 (8 significant bits)
GRAD_REL = 2.0 ** -8  # float32 outputs of the backward kernels: relative L2
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


# --------------------------------------------------------------------------
# the backward kernels (K1b-K4b's bf16 variants)
# --------------------------------------------------------------------------

def _gate_bwd_scale(act_func: str, s, xin, da, m_s, m_xin, m_da, c: int):
    """M of the gate backward's (ds, dxin) from its inputs and their M: each
    factor's M times a bound of the others (|σ|, |σ'|, |tanh| ≤ 1)."""
    ad = _abs(da)
    if act_func in ("glu", "gtu"):
        lin = _abs(s[:, :, :c].float() + xin.float())
        m_lin, m_q = m_s[:, :, :c] + m_xin, m_s[:, :, c:]
        if act_func == "glu":
            m_dlin = m_da + ad * m_q
            m_dq = (lin + 1.0) * (m_da + ad * m_q) + ad * m_lin
        else:
            m_dlin = m_da + ad * (m_q + 2.0 * m_lin)
            m_dq = m_da + ad * (m_lin + m_q)
        return torch.cat([m_dlin, m_dq], dim=2), m_dlin
    z, m_z = s.float() + xin.float(), m_s + m_xin
    if act_func == "relu":   # a decision within rounding of 0 may go the other way
        m = _relu_flip(da, m_da, z, m_z)
    else:
        m = 2.0 * (m_da + ad * (1.0 + z.abs()) * m_z)
    return m, m


def _dx_scale(ds, m_ds, kernel, kt: int, t_total: int):
    """M of :func:`tconv_bwd_cv`'s data gradient: each tap's |terms|, the
    cotangent's M carried, summed over the taps."""
    a = _abs(ds) + m_ds
    out = None
    for k in range(kt):
        tap = shift_pad_t(_cdot(a, _abs(kernel[k]).T), k, t_total)
        out = tap if out is None else out + tap
    return out


def _ln_bwd_scale(x, mu, rstd, lng, mask, dy, m_dy):
    """M of ``ln_drop_bwd_cv``'s (dx, dlng, dlnb)."""
    am = 1.0 if mask is None else _abs(mask)
    g = _abs(dy) * am
    m_g = m_dy * am
    xn = _abs((x.float() - mu) * rstd)
    return (m_g * _abs(lng) * rstd, ((g + m_g) * xn).sum((0, 1)), (g + m_g).sum((0, 1)))


def _relu_flip(d, m_d, z, m_z):
    """M of ``d · (z > 0)``: d's, plus |d| / REL where z lies within rounding
    of 0 (a decision the other way moves the output by all of |d|)."""
    return m_d + _abs(d) / REL * (_abs(z) <= REL * m_z).float()


def head_bwd_scale(cfg, x, ln, w, gy, drop=None) -> tuple:
    """M of K1b's bf16 outputs, (dx, dlng, dlnb) with ``apply_ln``, else
    (dx,) (``head_bwd_reference``'s arguments)."""
    c1k, c1b, gaw, _ = w
    x4, mask = x, None
    if cfg.apply_ln:
        mask = _drop_mask(drop, x, cfg.v_true)
        x4 = ln_normalize_cv(x, *ln)
        x4 = x4 if mask is None else x4 * mask
    s1, m_s = tconv_cv(x4, c1k, c1b, cfg.kt), tconv_cv(_abs(x4), _abs(c1k), _abs(c1b), cfg.kt)
    xin, m_xin = pad_channels_cv(x4[:, cfg.kt - 1:], cfg.c0), pad_channels_cv(
        _abs(x4)[:, cfg.kt - 1:], cfg.c0)
    da = _cdot(gy.float(), gaw.float().T).to(BF16)
    m_da = _cdot(_abs(gy), _abs(gaw).T)
    ds, dxin = gate_bwd_cv(cfg.act_func, s1, xin, cfg.c0, da)
    m_ds, m_dxin = _gate_bwd_scale(cfg.act_func, s1, xin, da, m_s, m_xin, m_da, cfg.c0)
    dx4 = tconv_bwd_cv(x4, ds, c1k, cfg.kt)[2]
    dx4 = dx4 + shift_pad_t(dxin[:, :, :cfg.c_in], cfg.kt - 1, cfg.t_in)
    m_dx4 = _dx_scale(ds, m_ds, c1k, cfg.kt, cfg.t_in) + shift_pad_t(
        (_abs(dxin) + m_dxin)[:, :, :cfg.c_in], cfg.kt - 1, cfg.t_in)
    if not cfg.apply_ln:
        return (m_dx4,)
    return _ln_bwd_scale(x, ln[0], ln[1], ln[2], mask, dx4, m_dx4)


def tail_bwd_scale(cfg, xg, terms, w, ga2, gps, gpss) -> tuple:
    """M of K2b's bf16 outputs, (dxg, [dterm per term]) (``tail_bwd_reference``'s
    arguments)."""
    gcw, gcb, c2k, c2b = w
    cheb = cfg.graph_conv_type == "cheb_graph_conv"
    r = tail_preact(cfg, xg, terms, w)
    m_r = tail_preact(cfg, _abs(xg), [_abs(t) for t in terms], (_abs(gcw), _abs(gcb)))
    h = torch.relu(r)
    s2, m_s = tconv_cv(h, c2k, c2b, cfg.kt), tconv_cv(m_r, _abs(c2k), _abs(c2b), cfg.kt)
    xin, m_xin = pad_channels_cv(h[:, cfg.kt - 1:], cfg.c2), pad_channels_cv(
        m_r[:, cfg.kt - 1:], cfg.c2)
    a2 = gate_cv(cfg.act_func, s2, xin, cfg.c2)
    m_a2 = _gate_scale(cfg.act_func, s2, xin, m_s, m_xin, cfg.c2)
    vm = (torch.arange(cfg.v_pad, device=xg.device) < cfg.v_true).float()
    da = (ga2.float() + (gps + 2.0 * gpss * a2.float()) * vm).to(BF16)
    m_da = 2.0 * _abs(gpss) * m_a2 * vm
    ds, dxin = gate_bwd_cv(cfg.act_func, s2, xin, cfg.c2, da)
    m_ds, m_dxin = _gate_bwd_scale(cfg.act_func, s2, xin, da, m_s, m_xin, m_da, cfg.c2)
    dh = tconv_bwd_cv(h, ds, c2k, cfg.kt)[2]
    dh = dh + shift_pad_t(dxin[:, :, :cfg.c1], cfg.kt - 1, cfg.t1)
    m_dh = _dx_scale(ds, m_ds, c2k, cfg.kt, cfg.t1) + shift_pad_t(
        (_abs(dxin) + m_dxin)[:, :, :cfg.c1], cfg.kt - 1, cfg.t1)
    m_dr = _relu_flip(dh, m_dh, r, m_r)
    dr = dh * (r.float() > 0).to(BF16)
    a = _abs(dr) + m_dr
    m_dct = [_cdot(a, _abs(gcw[k]).T) for k in range(gcw.shape[0])]
    m_dxg = m_dr + m_dct[0] if cheb else m_dr
    return m_dxg, m_dct[1:] if cheb else m_dct


def ohead_bwd_scale(cfg, x, mu, rstd, lng, lnb, ck, cb, ga, gps, gpss, drop=None) -> tuple:
    """M of K3b's bf16 outputs (dx, dlng, dlnb) (``ohead_bwd_reference``'s
    arguments)."""
    mask = _drop_mask(drop, x, cfg.v_true)
    x4 = ln_normalize_cv(x, mu, rstd, lng, lnb)
    x4 = x4 if mask is None else x4 * mask
    s, m_s = tconv_cv(x4, ck, cb, cfg.ko), tconv_cv(_abs(x4), _abs(ck), _abs(cb), cfg.ko)
    xin, m_xin = pad_channels_cv(x4[:, cfg.ko - 1:], cfg.c0), pad_channels_cv(
        _abs(x4)[:, cfg.ko - 1:], cfg.c0)
    a = gate_cv(cfg.act_func, s, xin, cfg.c0)
    m_a = _gate_scale(cfg.act_func, s, xin, m_s, m_xin, cfg.c0)
    vm = (torch.arange(cfg.v_pad, device=x.device) < cfg.v_true).float()
    da = (ga.float() + (gps + 2.0 * gpss * a.float() * vm) * vm).to(BF16)
    m_da = 2.0 * _abs(gpss) * m_a * vm
    ds, dxin = gate_bwd_cv(cfg.act_func, s, xin, cfg.c0, da)
    m_ds, m_dxin = _gate_bwd_scale(cfg.act_func, s, xin, da, m_s, m_xin, m_da, cfg.c0)
    dx4 = tconv_bwd_cv(x4, ds, ck, cfg.ko)[2]
    dx4 = dx4 + shift_pad_t(dxin[:, :, :cfg.c_in], cfg.ko - 1, cfg.ko)
    m_dx4 = _dx_scale(ds, m_ds, ck, cfg.ko, cfg.ko) + shift_pad_t(
        (_abs(dxin) + m_dxin)[:, :, :cfg.c_in], cfg.ko - 1, cfg.ko)
    return _ln_bwd_scale(x, mu, rstd, lng, mask, dx4, m_dx4)


def ofc_bwd_scale(cfg, a, mu, rstd, lnw, lnb, w1, b1, w2, b2, gout, drop=None) -> tuple:
    """M of K4b's bf16 outputs (da, dlnw, dlnb) (``ofc_bwd_reference``'s
    arguments)."""
    h = ln_normalize_cv(a, mu, rstd, lnw, lnb)
    s2 = linear_cv(h, w1, b1)
    m_s2 = linear_cv(_abs(h), _abs(w1), _abs(b1))
    mask = _drop_mask(drop, s2, cfg.v_true)
    g = gout.to(BF16)
    dzd = _cdot(g.float(), w2.float().T).to(BF16)
    m_dzd = _cdot(_abs(g), _abs(w2).T)
    dz, m_dz = (dzd, m_dzd) if mask is None else (dzd * mask, m_dzd * _abs(mask))
    m_ds2 = _relu_flip(dz, m_dz, s2, m_s2)
    ds2 = dz * (s2.float() > 0).to(BF16)
    dh = _cdot(ds2.float(), w1.float().T).to(BF16)
    m_dh = _cdot(_abs(ds2) + m_ds2, _abs(w1).T)
    return _ln_bwd_scale(a, mu, rstd, lnw, None, dh, m_dh)


def within_grads(got, ref, scale, *, rel: float = GRAD_REL) -> dict:
    """Hold a backward kernel's outputs (as its plain version returns them,
    None entries skipped) against the plain version's: the bf16 ones by
    :func:`within` with ``scale`` (their M, in order), the float32 ones in
    relative L2 within ``rel``. Returns max |Δ| over all and, per float32
    output, its relative L2 error."""
    got = [g for g in got if g is not None]
    ref = [r for r in ref if r is not None]
    if len(got) != len(ref) or any(g.dtype != r.dtype for g, r in zip(got, ref)):
        raise AssertionError(f"dtypes {[g.dtype for g in got]} against {[r.dtype for r in ref]}")
    lo = [(g, r) for g, r in zip(got, ref) if g.dtype == BF16]
    out = within([g for g, _ in lo], [r for _, r in lo], list(scale)) if lo else {
        "max_abs_err": 0.0}
    l2 = []
    for i, (g, r) in enumerate(zip(got, ref)):
        if g.dtype == BF16:
            continue
        g32, r32 = g.detach().float(), r.detach().float()
        err = float(torch.linalg.vector_norm(g32 - r32)) / max(
            float(torch.linalg.vector_norm(r32)), 1e-30)
        if not (err <= rel) or not torch.isfinite(g32).all():
            raise AssertionError(f"float32 output {i}: relative L2 {err:.3e} > {rel:.3e}")
        l2.append(err)
        out["max_abs_err"] = max(out["max_abs_err"], float((g32 - r32).abs().max()))
    out["rel_l2"] = l2
    return out
