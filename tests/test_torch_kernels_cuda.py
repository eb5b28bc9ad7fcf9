"""The CUDA kernels K1-K4 against their plain PyTorch versions, on a card.

This file imports neither JAX nor the JAX package, so it runs on the card
machine, which has neither:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Without a card every test skips (decided at run time). ``chip_smoke.py``
holds the same kernels against the same plain versions at the main path's
full shapes.
"""

import numpy as np
import pytest
import torch

from stgcn_tpu_torch.kernels import output_head as oh
from stgcn_tpu_torch.kernels import vertex_fused as vf

pytestmark = pytest.mark.cuda
B, V_TRUE, V_PAD = 3, 150, 256
TOL = dict(rtol=1e-4, atol=1e-4)  # f32, sums in another order


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, dev, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)


def _ln_args(rng, dev, n_t, c):
    mu = _rand(rng, dev, B, n_t, 1, 1, scale=0.1)
    rstd = 0.5 + _rand(rng, dev, B, n_t, 1, 1, scale=0.1).abs()
    lng, lnb = 1.0 + _rand(rng, dev, c, V_PAD, scale=0.1), _rand(rng, dev, c, V_PAD)
    lng[:, V_TRUE:] = 0.0
    lnb[:, V_TRUE:] = 0.0
    return mu, rstd, lng, lnb


@pytest.mark.parametrize("act", ["glu", "gtu", "relu", "silu"])
@pytest.mark.parametrize("apply_ln", [False, True])
def test_head_and_tail_match_plain(dev, act, apply_ln):
    rng = np.random.default_rng(21)
    cfg = vf.VertexBlockCfg(kt=3, ks=3, act_func=act, graph_conv_type="cheb_graph_conv",
                            v_true=V_TRUE, v_pad=V_PAD, t_in=8 if apply_ln else 12,
                            c_in=16 if apply_ln else 1, c0=80, c1=16, c2=32,
                            apply_ln=apply_ln)
    x = _rand(rng, dev, B, cfg.t_in, cfg.c_in, V_PAD)
    ln = _ln_args(rng, dev, cfg.t_in, cfg.c_in) if apply_ln else None
    w = (_rand(rng, dev, 3, cfg.c_in, cfg.g1, scale=0.2), _rand(rng, dev, cfg.g1, scale=0.1),
         _rand(rng, dev, cfg.c0, cfg.c1, scale=0.2), _rand(rng, dev, cfg.c1, scale=0.1))
    xg = vf.head_fwd(cfg, x, *(ln or (None,) * 4), *w)
    torch.testing.assert_close(xg, vf.head_reference(cfg, x, ln, w), **TOL)

    terms = [_rand(rng, dev, B, cfg.t1, cfg.c1, V_PAD) for _ in range(2)]
    w2 = (_rand(rng, dev, 3, cfg.c1, cfg.c1, scale=0.2), _rand(rng, dev, cfg.c1, scale=0.1),
          _rand(rng, dev, 3, cfg.c1, cfg.g2, scale=0.2), _rand(rng, dev, cfg.g2, scale=0.1))
    got = vf.tail_fwd(cfg, xg, *terms, *w2)
    for g, r in zip(got, vf.tail_reference(cfg, xg, terms, w2)):
        torch.testing.assert_close(g, r, **TOL)
    again = vf.tail_fwd(cfg, xg, *terms, *w2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))   # no atomics


@pytest.mark.parametrize("act", ["glu", "silu"])
def test_ohead_and_ofc_match_plain(dev, act):
    rng = np.random.default_rng(41)
    cfg = oh.OutHeadCfg(ko=4, c_in=16, c0=40, c1=24, c_end=1, act_func=act, v_true=V_TRUE,
                        v_pad=V_PAD)
    args = (_rand(rng, dev, B, cfg.ko, cfg.c_in, V_PAD), *_ln_args(rng, dev, cfg.ko, cfg.c_in),
            _rand(rng, dev, cfg.ko, cfg.c_in, cfg.g, scale=0.2), _rand(rng, dev, cfg.g, scale=0.1))
    for g, r in zip(oh.ohead_fwd(cfg, *args), oh.ohead_reference(cfg, *args)):
        torch.testing.assert_close(g, r, **TOL)
    args = (_rand(rng, dev, B, 1, cfg.c0, V_PAD), *_ln_args(rng, dev, 1, cfg.c0),
            _rand(rng, dev, cfg.c0, cfg.c1, scale=0.2), _rand(rng, dev, cfg.c1, scale=0.1),
            _rand(rng, dev, cfg.c1, cfg.c_end, scale=0.2), _rand(rng, dev, cfg.c_end, scale=0.1))
    torch.testing.assert_close(oh.ofc_fwd(cfg, *args), oh.ofc_reference(cfg, *args), **TOL)


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    cfg = oh.OutHeadCfg(ko=4, c_in=16, c0=40, c1=24, c_end=1, act_func="glu", v_true=V_TRUE,
                        v_pad=V_PAD)
    rng = np.random.default_rng(3)
    args = [_rand(rng, dev, B, 1, cfg.c0, V_PAD), *_ln_args(rng, dev, 1, cfg.c0),
            _rand(rng, dev, cfg.c0, cfg.c1), _rand(rng, dev, cfg.c1),
            _rand(rng, dev, cfg.c1, 1), _rand(rng, dev, 1)]
    with pytest.raises(ValueError, match="shape"):
        oh.ofc_fwd(cfg, *args[:5], args[5].T.contiguous(), *args[6:])
    with pytest.raises(TypeError, match="float32"):
        oh.ofc_fwd(cfg, args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        oh.ofc_fwd(cfg, *args[:3], args[3].T.contiguous().T, *args[4:])
