"""The fused forward in bf16, the slice: ``fused_sparse_forward`` of
``STGCN(dtype=bfloat16)`` (``precision="auto"``, K1f-K4f's bf16 variants)
on the dense and BCSR operators against JAX ``fused_sparse_forward(
use_pallas="xla")`` of the bf16 model and against the float32 model; a
float32 model with a bf16 LayerNorm affine; the ``precision`` argument; the
C calls of the bf16 wrappers; the backward of every bf16 call, which hands
each input a gradient in its own type; and the refusal of ``fused_forward``
(K12) of a bf16 model. V = 150 (dense) or 520
(BCSR, RCM-ordered), B = 3. The kernels one by one against the JAX mirrors
are in ``tests/test_torch_fused_bf16.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgcn_tpu.data.synthetic import random_road_graph
from stgcn_tpu.graph import build_gso as jax_build_gso
from stgcn_tpu.kernels import vertex_fused as jvf
from stgcn_tpu.nn.fused_sparse import fused_sparse_forward as jax_fused_sparse_forward
from stgcn_tpu.nn.model import STGCN as JaxSTGCN
from stgcn_tpu.ops import dense_graph_op as jax_dense_graph_op
from stgcn_tpu.ops.graph_op import bcsr_graph_op as jax_bcsr_graph_op
from stgcn_tpu_torch import kernels
from stgcn_tpu_torch.graph import build_gso
from stgcn_tpu_torch.kernels import _build
from stgcn_tpu_torch.kernels import output_head as toh
from stgcn_tpu_torch.kernels import vertex_fused as tvf
from stgcn_tpu_torch.kernels.dropout import Drop
from stgcn_tpu_torch.nn.convert import params_to_jax
from stgcn_tpu_torch.nn.fused_sparse import fused_sparse_forward
from stgcn_tpu_torch.nn.model import STGCN
from stgcn_tpu_torch.ops import bcsr_graph_op, dense_graph_op
from tests.test_torch_fused_bf16 import BF16, V_PAD, _cfgs, _ln, _ohead_cfgs, _t16
from tests.torch_parity_utils import B, V, banded_gsos, rand

V_SPARSE = 520
N_HIS = 12
# the port's bf16 model against JAX's (tests/test_torch_bf16.py), and a bf16
# model against the float32 one (the JAX package's bound, tests/test_vertex_fused.py:232)
MODEL_ATOL, MODEL_RTOL = 3e-2, 2e-2
F32_ATOL, F32_RTOL = 0.1, 0.05


def _ops(kind):
    """(JAX op, port op, V) of the dense operator (PeMSD7-like V = 150) or
    the BCSR one (V = 520, RCM-ordered), float32 values."""
    if kind == "dense":
        adj = random_road_graph(V, k_neighbors=4, seed=0)
        return (jax_dense_graph_op(jax_build_gso(adj, "sym_norm_lap", cheb=True)),
                dense_graph_op(build_gso(adj, "sym_norm_lap", cheb=True), device="cpu"), V)
    _, jart, tart = banded_gsos(n=V_SPARSE, seed=3)
    return (jax_bcsr_graph_op(jart, block_size=128, use_pallas=False),
            bcsr_graph_op(tart, block_size=128, device="cpu"), V_SPARSE)


def _bdot_xla_f32(x, w, prec=None):
    """The JAX ``_bdot_xla`` on float32 copies of its bf16 operands: the same
    exact products, summed in float32. XLA's CPU backend has no bf16 × bf16
    → float32 dot for the first block's shapes (``DotThunk``), so the JAX
    xla blocks run their products through this in the test."""
    return jnp.einsum("btcv,cg->btgv", x.astype(jnp.float32), w.astype(jnp.float32),
                      precision=prec)


@pytest.mark.parametrize("kind", ["dense", "bcsr"])
def test_fused_sparse_forward_bf16_matches_jax(kind, monkeypatch):
    """``fused_sparse_forward`` of ``STGCN(dtype=bfloat16)`` (precision
    ``"auto"``: the kernels' bf16 variants, the graph terms in bf16: dense
    ``torch.matmul``, K10's bf16 variant on BCSR) against the JAX bf16 model's
    ``fused_sparse_forward(use_pallas="xla")`` with the same weights
    (``params_to_jax``), and against the float32 model's forward within the
    JAX package's bf16 bound; float32 output; nothing launched on the CPU."""
    monkeypatch.setattr(jvf, "_bdot_xla", _bdot_xla_f32)
    jop, top, v = _ops(kind)
    x = rand(np.random.default_rng(2), B, N_HIS, v, 1)
    tm = STGCN(N_HIS, v, dtype=BF16, device="cpu", generator=torch.Generator().manual_seed(5))
    jparams = params_to_jax(tm)
    ref = jax.jit(lambda p, xx: jax_fused_sparse_forward(
        p, xx, jop, JaxSTGCN(n_his=N_HIS, dtype=jnp.bfloat16), deterministic=True,
        use_pallas="xla"))(jparams, jnp.asarray(x))
    ref32 = jax.jit(lambda p, xx: JaxSTGCN(n_his=N_HIS).apply({"params": p}, xx, jop,
                                                             deterministic=True))(
        jparams, jnp.asarray(x))
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = fused_sparse_forward(tm.state_dict(), torch.from_numpy(x), top, tm)
    assert not any(kernels.launch_counts().values())
    assert got.dtype == torch.float32 and got.shape == ref.shape == (B, 1, v, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=MODEL_ATOL, rtol=MODEL_RTOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref32), atol=F32_ATOL, rtol=F32_RTOL)


def test_fused_sparse_forward_of_a_bf16_layernorm_runs_float32():
    """A float32 model whose LayerNorm affine is bf16 (``ln_param_dtype``)
    runs the float32 kernels, the affine cast to float32, as the JAX
    ``fused_sparse_forward`` does: within the fused route's float32 bound of
    the JAX one."""
    jop, top, v = _ops("dense")
    x = rand(np.random.default_rng(3), B, N_HIS, v, 1)
    tm = STGCN(N_HIS, v, ln_param_dtype=BF16, device="cpu",
               generator=torch.Generator().manual_seed(6))
    ref = jax.jit(lambda p, xx: jax_fused_sparse_forward(
        p, xx, jop, JaxSTGCN(n_his=N_HIS, ln_param_dtype=jnp.bfloat16), deterministic=True,
        use_pallas="xla"))(params_to_jax(tm), jnp.asarray(x))
    with torch.no_grad():
        got = fused_sparse_forward(tm.state_dict(), torch.from_numpy(x), top, tm)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=2e-4)


# --------------------------------------------------------------------------
# the C calls, and what stays refused
# --------------------------------------------------------------------------

class _FakeLib:
    """Stands in for the CUDA library: records each entry point's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn


def _meta(*shape, dtype=BF16):
    return torch.zeros(shape, dtype=dtype, device="meta")


def test_bf16_wrappers_call_their_entry_points(monkeypatch):
    """On a non-CPU tensor each bf16 wrapper makes one call of its
    ``stgcn_*_fwd_bf16`` entry point with the signature's argument count,
    counted under its ``_bf16`` name and not the float32 one's; the outputs
    are bf16 but K4f's, which is float32."""
    fake = _FakeLib()
    monkeypatch.setattr(_build, "library", lambda: fake)
    for mod in (tvf, toh):
        monkeypatch.setattr(mod, "cuda_device", lambda t: t.device)
        monkeypatch.setattr(mod, "stream_of", lambda dev: 0)
    f32 = torch.float32
    _, cfg = _cfgs("glu", True)
    stats = (_meta(B, 8, 1, 1, dtype=f32), _meta(B, 8, 1, 1, dtype=f32))
    _, ocfg = _ohead_cfgs("glu")
    calls = {
        "head_fwd": lambda: tvf.head_fwd(
            cfg, _meta(B, 8, 16, V_PAD), *stats, _meta(16, V_PAD), _meta(16, V_PAD),
            _meta(3, 16, 32), _meta(32, dtype=f32), _meta(16, 8), _meta(8, dtype=f32)),
        "tail_fwd": lambda: tvf.tail_fwd(
            cfg, *(_meta(B, 6, 8, V_PAD) for _ in range(3)), _meta(3, 8, 8), _meta(8, dtype=f32),
            _meta(3, 8, 32), _meta(32, dtype=f32))[0],
        "ohead_fwd": lambda: toh.ohead_fwd(
            ocfg, _meta(B, 4, 16, V_PAD), _meta(B, 4, 1, 1, dtype=f32),
            _meta(B, 4, 1, 1, dtype=f32), _meta(16, V_PAD), _meta(16, V_PAD), _meta(4, 16, 64),
            _meta(64, dtype=f32))[0],
        "ofc_fwd": lambda: toh.ofc_fwd(
            ocfg, _meta(B, 1, 32, V_PAD), _meta(B, 1, 1, 1, dtype=f32),
            _meta(B, 1, 1, 1, dtype=f32), _meta(32, V_PAD), _meta(32, V_PAD), _meta(32, 24),
            _meta(24, dtype=f32), _meta(24, 1), _meta(1, dtype=f32)),
    }
    for name, call in calls.items():
        before = kernels.launch_counts()
        out = call()
        after = kernels.launch_counts()
        assert after[f"{name}_bf16"] == before[f"{name}_bf16"] + 1 and after[name] == before[name]
        c_name, args = fake.calls[-1]
        assert c_name == f"stgcn_{name}_bf16"
        assert len(args) == len(_build.SIGNATURES[c_name]) == len(_build.SIGNATURES[f"stgcn_{name}"])
        assert out.dtype == (torch.float32 if name == "ofc_fwd" else BF16)
    with pytest.raises(TypeError, match="c1b must be torch.float32"):
        tvf.head_fwd(cfg, _meta(B, 8, 16, V_PAD), *stats, _meta(16, V_PAD), _meta(16, V_PAD),
                     _meta(3, 16, 32), _meta(32), _meta(16, 8), _meta(8, dtype=f32))


def test_bf16_backward_raises():
    """The backward of each bf16 Function (K1b-K4b in bf16) runs and hands
    every bf16 input a bf16 gradient and every float32 one (μ, rstd, the
    biases) a float32 one, and so does the backward of a bf16 model's
    ``fused_sparse_forward`` (float32 gradients of the master parameters);
    nothing is cast to float32 on the way. (Its values:
    ``tests/test_torch_fused_bf16_bwd.py``.)"""
    jop, top, v = _ops("dense")
    tm = STGCN(N_HIS, v, dtype=BF16, device="cpu", generator=torch.Generator().manual_seed(5))
    x = torch.from_numpy(rand(np.random.default_rng(4), B, N_HIS, v, 1))
    params = dict(tm.named_parameters())
    out = fused_sparse_forward(params, x, top, tm, deterministic=False, seed=3)
    grads = torch.autograd.grad(out.sum(), list(params.values()))
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all()) for g in grads)
    rng = np.random.default_rng(5)

    def run(fn, ins, *rest, **kw):
        ins = [t.requires_grad_() for t in ins]
        outs = fn(*ins, *rest, **kw)
        outs = outs if isinstance(outs, tuple) else (outs,)
        got = torch.autograd.grad([o.float().sum() for o in outs], ins, allow_unused=True)
        for t, g in zip(ins, got):
            assert g is not None and g.dtype == t.dtype and g.shape == t.shape
            assert bool(torch.isfinite(g.float()).all())

    _, cfg = _cfgs("glu", True)
    f32 = torch.float32
    run(lambda *t, **kw: tvf.head_fused(cfg, *t, **kw),
        [_t16(rand(rng, B, 8, 16, V_PAD)), *_ln(rng, 8, 16), _t16(rand(rng, 3, 16, 32)),
         torch.zeros(32), _t16(rand(rng, 16, 8)), torch.zeros(8)], drop=Drop(0.5, 1, 0))
    run(lambda *t: tvf.tail_fused(cfg, *t),
        [*(_t16(rand(rng, B, 6, 8, V_PAD)) for _ in range(3)), _t16(rand(rng, 3, 8, 8)),
         torch.zeros(8), _t16(rand(rng, 3, 8, 32)), torch.zeros(32)])
    _, ocfg = _ohead_cfgs("glu")
    run(lambda *t, **kw: toh.ohead_fused(ocfg, *t, **kw),
        [_t16(rand(rng, B, 4, 16, V_PAD)), *_ln(rng, 4, 16), _t16(rand(rng, 4, 16, 64)),
         torch.zeros(64)], drop=Drop(0.5, 2, 1))
    run(lambda *t, **kw: toh.ofc_fused(ocfg, *t, **kw),
        [_t16(rand(rng, B, 1, 32, V_PAD)), *_ln(rng, 1, 32), _t16(rand(rng, 32, 24)),
         torch.zeros(24, dtype=f32), _t16(rand(rng, 24, 1)), torch.zeros(1)],
        drop=Drop(0.5, 3, 2))


def test_fused_forward_of_a_bf16_model_still_raises():
    """The dense whole-block route (K12) has no bf16 variant yet: a bf16
    model raises, naming its slice."""
    from stgcn_tpu_torch.nn import fused_forward

    _, top, v = _ops("dense")
    tm = STGCN(N_HIS, v, dtype=BF16, device="cpu")
    with pytest.raises(NotImplementedError, match=r"K12f / K12b \(ROADMAP\.md §1 item 4\)"):
        fused_forward(tm.state_dict(), torch.zeros(1, N_HIS, v, 1), top, tm)


def test_precision_argument():
    """``precision`` is the JAX argument's: ``"default"`` runs a bf16 model's
    weights in float32 (the float32 kernels), anything else raises."""
    _, top, v = _ops("dense")
    tm = STGCN(N_HIS, v, dtype=BF16, device="cpu", generator=torch.Generator().manual_seed(5))
    x = torch.from_numpy(rand(np.random.default_rng(6), 1, N_HIS, v, 1))
    with torch.no_grad():
        f32 = fused_sparse_forward(tm.state_dict(), x, top, tm, precision="default")
        auto = fused_sparse_forward(tm.state_dict(), x, top, tm)
        ref = fused_sparse_forward(tm.state_dict(), x, top, STGCN(N_HIS, v, device="cpu"))
    torch.testing.assert_close(f32, ref, rtol=0, atol=0)
    assert not torch.equal(auto, f32)
    np.testing.assert_allclose(auto.numpy(), f32.numpy(), atol=F32_ATOL, rtol=F32_RTOL)
    with pytest.raises(ValueError, match="precision 'highest'"):
        fused_sparse_forward(tm.state_dict(), x, top, tm, precision="highest")
