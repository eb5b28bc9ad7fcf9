"""bf16 mixed precision on the unfused model against the JAX package's
``STGCN(dtype=bfloat16)``: the bf16 packs (banded vn and clamped, BCSR,
dense) bit for bit as 16-bit patterns; the plain versions of the vn kernel
(K7-K9: single, pair, chain over float32, bf16 and int8 slabs) and of K10
(over float32 and bf16 tiles) on bf16 operands against the JAX references;
the bf16 model's forward and parameter gradients on the dense, banded
(float32 and bf16 slabs), ``banded_int8`` and BCSR operators, Ko > 1 and
Ko = 0; each module's output dtype against the JAX module's;
``ln_param_dtype=bfloat16``; a 2-epoch bf16 ``Trainer`` trajectory
against the JAX one and the port's float32 one; the launch names of the bf16
kernels; and the fused route's refusals. Small shapes: V = 150 (dense) or
520 (banded, BCSR; 5 block rows of 128), B = 3; the JAX side runs its
off-TPU branches."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgcn_tpu.data import datasets as JD
from stgcn_tpu.data.synthetic import generate_synthetic_vel, random_road_graph
from stgcn_tpu.graph import build_gso as jax_build_gso
from stgcn_tpu.kernels import banded_spmm as jbs
from stgcn_tpu.kernels import spmm as jsp
from stgcn_tpu.nn.model import STGCN as JaxSTGCN
from stgcn_tpu.ops import dense_graph_op as jax_dense_graph_op
from stgcn_tpu.ops.graph_op import banded_graph_op as jax_banded_graph_op
from stgcn_tpu.ops.graph_op import bcsr_graph_op as jax_bcsr_graph_op
from stgcn_tpu.train.loop import TrainConfig as JaxTrainConfig
from stgcn_tpu.train.loop import Trainer as JaxTrainer
from stgcn_tpu_torch import kernels
from stgcn_tpu_torch.data import ForecastDataset, ZScoreScaler
from stgcn_tpu_torch.graph import build_gso
from stgcn_tpu_torch.kernels import _build
from stgcn_tpu_torch.kernels import banded_spmm as tbs
from stgcn_tpu_torch.kernels import spmm as tsp
from stgcn_tpu_torch.nn.fused_sparse import fused_sparse_forward
from stgcn_tpu_torch.nn.convert import params_from_jax, params_to_jax
from stgcn_tpu_torch.nn.model import STGCN
from stgcn_tpu_torch.ops import banded_graph_op, bcsr_graph_op, dense_graph_op, ell_graph_op
from stgcn_tpu_torch.train import TrainConfig, Trainer
from tests.torch_parity_utils import B, V, banded_gsos, rand, to_np

tcli = importlib.import_module("stgcn_tpu_torch.cli.main")   # the module, not its main

BF16 = torch.bfloat16
V_SPARSE = 520
ULP2 = 2.0 ** -7     # two ulps of bf16 relative to the value (8 significant bits)
FLOOR = 1e-4         # the kernel floor, times max |ref| (float32 sums in another order)
# the bf16 model against JAX model.apply (dtype=bfloat16). The JAX package's
# own bf16 bound (tests/test_vertex_fused.py:232) is atol 0.1, rtol 0.05; the
# forward is held within a third of it (measured: max |Δ| 0.015 at max |ref|
# 0.53, a few ulps). The gradients are bf16 sums taken in other orders and
# rounded at other fusions, and bf16 noise is large in them: on these cases
# JAX's own bf16 gradients lie up to 0.11 from its float32 ones in relative
# L2, the port's from JAX's bf16 ones up to 0.12 (and from JAX's float32 ones
# up to 0.11). Each parameter's gradient is held within 0.2 in relative L2.
MODEL_ATOL, MODEL_RTOL = 3e-2, 2e-2
GRAD_REL_L2 = 0.2


def _bf16_np(a) -> np.ndarray:
    """An array's float32 values rounded to bf16 (nearest even), as float32."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


def _bits(t) -> np.ndarray:
    """The 16-bit patterns of a bf16 torch tensor or JAX / numpy array."""
    if isinstance(t, torch.Tensor):
        assert t.dtype == BF16
        return t.view(torch.int16).numpy()
    a = np.asarray(t)
    assert a.dtype.name == "bfloat16"
    return a.view(np.int16)


def _within(got, ref, *, add=None, rel=ULP2, floor=FLOOR):
    """Each element within ``rel · (|ref| + |add|) + floor · max |ref|``."""
    g, r = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert g.shape == r.shape and np.isfinite(g).all()
    scale = np.abs(r) + (0.0 if add is None else np.abs(np.asarray(add, np.float32)))
    bound = rel * scale + floor * float(np.abs(r).max())
    bad = np.abs(g - r) > bound
    assert not bad.any(), (f"{int(bad.sum())} of {bad.size} outside, max |Δ| "
                           f"{float(np.abs(g - r).max()):.3e}")


# --------------------------------------------------------------------------
# the packs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["banded_stream", "banded_clamped", "bcsr", "dense"])
def test_bf16_packs_equal_jax(kind):
    """``banded_graph_op`` / ``bcsr_graph_op`` / ``dense_graph_op`` with
    ``dtype=bfloat16``: every value tensor equal to the JAX one as 16-bit
    patterns (each float32 value rounded to nearest even on both sides)."""
    _, jart, tart = banded_gsos("rw_norm_lap", n=V_SPARSE, seed=4)
    if kind == "dense":
        pairs = [(dense_graph_op(tart, device="cpu", dtype=BF16).matrix,
                  jax_dense_graph_op(jart, dtype=jnp.bfloat16).matrix)]
    elif kind == "bcsr":
        op = bcsr_graph_op(tart, block_size=128, device="cpu", dtype=BF16)
        jop = jax_bcsr_graph_op(jart, block_size=128, dtype=jnp.bfloat16, use_pallas=False)
        pairs = [(op.pack.data, jop.block_data), (op.pack_t.data, jop.block_data_t)]
    else:
        stream = kind == "banded_stream"
        op = banded_graph_op(tart, block_size=128, stream=stream, dtype=BF16, device="cpu")
        jop = jax_banded_graph_op(jart, block_size=128, stream=stream, dtype=jnp.bfloat16,
                                  use_pallas=False)
        assert op.pair_stream == jop.pair_stream and op.v_pad == jop.v_pad
        np.testing.assert_array_equal(op.lo.numpy(), np.asarray(jop.lo))
        pairs = [(op.slabs, jop.slabs), (op.slabs_t, jop.slabs_t)]
    for got, ref in pairs:
        assert got.dtype == BF16 and tuple(got.shape) == tuple(ref.shape)
        np.testing.assert_array_equal(_bits(got), _bits(ref))


# --------------------------------------------------------------------------
# the plain versions of K7-K9 and K10 on bf16 operands
# --------------------------------------------------------------------------

SLABS = {"f32": {}, "bf16": {"dtype": BF16}, "int8": {"quantize": True}}
JSLABS = {"f32": {}, "bf16": {"dtype": jnp.bfloat16}, "int8": {"quantize": True}}


def _jax_fit(y, v_pad):
    """The JAX callers' cut or zero-pad of a single application to v_pad rows."""
    return jnp.pad(y, ((0, v_pad - y.shape[0]), (0, 0))) if y.shape[0] < v_pad else y[:v_pad]


@pytest.mark.parametrize("slabs", sorted(SLABS))
@pytest.mark.parametrize("mode", ["single", "pair", "chain"])
def test_plain_vn_bf16_matches_jax(mode, slabs):
    """``banded_vn_reference`` on a bf16 operand against the JAX off-TPU
    branch on the same bf16 inputs (``banded_spmm`` on the pack, the pair
    as ``_cheb_pair_stream_primal``, the chain as ``_cheb_pair_stream_bwd``
    computes it): within 2 ulps of bf16 plus the floor, each pass on the
    same input (the second on the JAX first output, as a bf16 ``mid`` an
    ulp apart moves it further where ``2·A·mid`` and ``x`` cancel). The JAX
    branch rounds ``A t1`` to bf16 before ``2·that − x`` and ``2 Aᵀ g2``
    before ``+ g1``, where the port (the TPU kernel's points) rounds once
    after the float32 epilogue, so those are held relative to ``|ref| +
    |addend|``."""
    _, jart, tart = banded_gsos("rw_norm_lap", n=V_SPARSE, seed=4)
    op = banded_graph_op(tart, block_size=128, device="cpu", **SLABS[slabs])
    jop = jax_banded_graph_op(jart, block_size=128, use_pallas=False, **JSLABS[slabs])
    rng = np.random.default_rng(9)
    x32, g32 = (_bf16_np(rand(rng, op.v_pad, 40)) for _ in range(2))
    x, g = torch.from_numpy(x32).to(BF16), torch.from_numpy(g32).to(BF16)
    jx, jg = jnp.asarray(x32, jnp.bfloat16), jnp.asarray(g32, jnp.bfloat16)
    chain = mode == "chain"
    slabs_t, lo, sc = (op.slabs_t, op.lo_t, op.scales_t) if chain else (op.slabs, op.lo,
                                                                          op.scales)
    jslabs, jlo, jsc = (jop.slabs_t, jop.lo_t, jop.scales_t) if chain else (jop.slabs, jop.lo,
                                                                              jop.scales)
    got = tbs.banded_vn_reference(slabs_t, lo, x, g if chain else None, mode, scales=sc)
    got = [got] if mode == "single" else list(got)
    assert all(t.dtype == BF16 for t in got)

    def apply(v, scale=1.0):
        s = jslabs if jsc is not None or scale == 1.0 else jslabs * scale
        scl = jsc * scale if jsc is not None and scale != 1.0 else jsc
        return _jax_fit(jbs.banded_spmm(s, jlo, v, block_size=128, use_pallas=False,
                                        scales=scl), op.v_pad)

    if mode == "single":
        _within(got[0].float().numpy(), np.asarray(apply(jx), np.float32))
        _within(tbs.banded_vn_reference(slabs_t, lo, x, scales=sc, scale=2.0).float(),
                np.asarray(apply(jx, 2.0), np.float32))
        return
    alpha = 2.0 if mode == "pair" else 1.0
    mid = apply(jx) if mode == "pair" else jg + 2.0 * apply(jx)
    out = alpha * apply(mid) - jx
    assert mid.dtype == out.dtype == jnp.bfloat16
    _within(got[0].float().numpy(), np.asarray(mid, np.float32), add=g32 if chain else None)
    second = tbs.vn_pass_reference(slabs_t, lo, torch.from_numpy(np.asarray(mid, np.float32))
                                   .to(BF16), x, alpha=alpha, beta=-1.0, scales=sc)
    _within(second.float().numpy(), np.asarray(out, np.float32), add=x32)


@pytest.mark.parametrize("scale", [1.0, 2.0])
@pytest.mark.parametrize("tiles", ["f32", "bf16"])
def test_plain_k10_bf16_matches_jax(tiles, scale):
    """``bcsr_spmm_reference`` on a bf16 operand over float32 and bf16
    tiles against the JAX ``bcsr_spmm_reference`` (its tiles times the
    scale, as the JAX operator multiplies them): one rounding each, within
    2 ulps of bf16 plus the floor."""
    _, jart, tart = banded_gsos("rw_norm_lap", n=V_SPARSE, seed=4)
    dt = BF16 if tiles == "bf16" else torch.float32
    op = bcsr_graph_op(tart, block_size=128, device="cpu", dtype=dt)
    jop = jax_bcsr_graph_op(jart, block_size=128, use_pallas=False,
                            dtype=jnp.bfloat16 if tiles == "bf16" else jnp.float32)
    x32 = _bf16_np(rand(np.random.default_rng(10), op.n_vertex_pad, 48))
    got = tsp.bcsr_spmm_reference(op.pack, torch.from_numpy(x32).to(BF16), scale=scale)
    ref = jsp.bcsr_spmm_reference(jop.block_data * scale, jop.block_cols,
                                  jnp.asarray(x32, jnp.bfloat16), block_size=128)
    assert got.dtype == BF16 and ref.dtype == jnp.bfloat16
    _within(got.float().numpy(), np.asarray(ref, np.float32))


# --------------------------------------------------------------------------
# the bf16 model against JAX model.apply
# --------------------------------------------------------------------------

def _ops(kind):
    """(JAX op, port op, V) of one operator kind, both without a dtype (the
    CLI's float32 values) unless the kind says otherwise."""
    if kind.startswith("dense"):
        adj = random_road_graph(V, k_neighbors=4, seed=0)
        return (jax_dense_graph_op(jax_build_gso(adj, "sym_norm_lap", cheb=True)),
                dense_graph_op(build_gso(adj, "sym_norm_lap", cheb=True), device="cpu"), V)
    _, jart, tart = banded_gsos(n=V_SPARSE, seed=3)
    if kind == "bcsr":
        return (jax_bcsr_graph_op(jart, block_size=128, use_pallas=False),
                bcsr_graph_op(tart, block_size=128, device="cpu"), V_SPARSE)
    slabs = {"banded": "f32", "banded_bf16": "bf16", "banded_int8": "int8"}[kind]
    return (jax_banded_graph_op(jart, block_size=128, use_pallas=False, **JSLABS[slabs]),
            banded_graph_op(tart, block_size=128, device="cpu", **SLABS[slabs]), V_SPARSE)


@pytest.mark.parametrize("kind", ["dense", "dense_ko0", "banded", "banded_bf16", "banded_int8",
                                  "bcsr"])
def test_bf16_model_matches_jax(kind):
    """The port's ``STGCN(dtype=bfloat16)`` forward and every parameter's
    gradient against JAX ``model.apply`` with ``dtype=bfloat16`` on the same
    operator and weights: the dense one (float32 matrix, so the graph terms
    promote to float32 in both; Ko > 1 and Ko = 0, whose fc head has no
    dtype), the banded one over float32, bf16 and int8 slabs (K9 pair and
    chain, their bf16 variants on the card), and BCSR (K10 twice a block)."""
    jop, top, v = _ops(kind)
    n_his = 8 if kind == "dense_ko0" else 12
    jm = JaxSTGCN(n_his=n_his, dtype=jnp.bfloat16)
    rng = np.random.default_rng(1)
    x, y = rand(rng, B, n_his, v, 1), rand(rng, B, 1, v, 1)
    # the port's weights carried into the flax tree (``jm.init`` runs the
    # model eagerly, op by op: most of a case's time on the CPU)
    tm = STGCN(n_his, v, dtype=BF16, device="cpu", generator=torch.Generator().manual_seed(3))
    jparams = params_to_jax(tm)
    # Ko = 0 forecasts an empty [B, 0, V, 1] in both packages (ROADMAP.md §3):
    # a sum, whose gradients are zero, where a mean would be NaN
    reduce = jnp.sum if kind == "dense_ko0" else jnp.mean

    def jloss(p):
        pred = jm.apply({"params": p}, jnp.asarray(x), jop, deterministic=True)
        return reduce((pred - jnp.asarray(y)) ** 2), pred

    (_, ref), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    params = dict(tm.named_parameters())
    assert all(p.dtype == torch.float32 for p in params.values())
    got = tm(torch.from_numpy(x), top)
    loss = ((got - torch.from_numpy(y)) ** 2)
    grads = torch.autograd.grad(loss.sum() if kind == "dense_ko0" else loss.mean(),
                                list(params.values()), allow_unused=True)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert (kind == "dense_ko0") == (ref.shape[1] == 0) == (not hasattr(tm, "output"))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=MODEL_ATOL,
                               rtol=MODEL_RTOL)
    want = params_from_jax(to_np(jgrads))
    assert set(want) == set(params)
    for k, g in zip(params, grads):
        r = want[k].numpy()
        g = np.zeros_like(r) if g is None else g.numpy()
        if kind == "dense_ko0":
            np.testing.assert_array_equal(g, r, err_msg=k)   # both zero
            continue
        rl2 = np.linalg.norm(g - r) / np.linalg.norm(r)
        assert np.isfinite(g).all() and rl2 <= GRAD_REL_L2, (k, rl2)


@pytest.mark.parametrize("kind", ["dense", "banded", "banded_bf16", "banded_int8", "bcsr"])
def test_bf16_model_dtypes_follow_jax(kind, monkeypatch):
    """Where the bf16 model rounds, layer by layer, which the value bounds
    above cannot see: every port module's output has the dtype of the JAX
    module of the same path (``capture_intermediates``: bf16 after each
    CausalConv, Align and Dense, float32 where a float32 residual or the
    dense float32 matrix promotes, float32 at the model output); the graph
    operator gets a bf16 operand and its terms have the dtype of the JAX
    ``cheb_graph_conv`` output (bf16 on the sparse operators); every
    LayerNorm runs in float32 (input, affine, output, as the JAX ``ln``)
    and the ST block hands bf16 on."""
    jop, top, v = _ops(kind)
    jm = JaxSTGCN(n_his=12, dtype=jnp.bfloat16)
    tm = STGCN(12, v, dtype=BF16, device="cpu")
    x = np.zeros((B, 12, v, 1), np.float32)
    _, state = jax.eval_shape(
        lambda p: jm.apply({"params": p}, jnp.asarray(x), jop, deterministic=True,
                           capture_intermediates=True, mutable=["intermediates"]),
        params_to_jax(tm))
    to_torch = {"bfloat16": BF16, "float32": torch.float32}
    ref = {".".join(str(k.key) for k in path[:-2]): to_torch[leaf.dtype.name]
           for path, leaf in jax.tree_util.tree_flatten_with_path(state["intermediates"])[0]}

    got: dict[str, torch.dtype] = {}
    for name, mod in tm.named_modules():
        mod.register_forward_hook(lambda m, i, o, name=name: got.__setitem__(name, o.dtype))
    ln_calls, op_calls = [], []
    layer_norm = torch.nn.functional.layer_norm

    def ln(x_, shape, w, b, eps):
        y = layer_norm(x_, shape, w, b, eps)
        ln_calls.append((x_.dtype, w.dtype, b.dtype, y.dtype))
        return y

    monkeypatch.setattr(torch.nn.functional, "layer_norm", ln)

    class Recording:
        def __init__(self, op):
            self.op = op

        def __call__(self, xg, **kw):
            out = self.op(xg, **kw)
            op_calls.append((xg.dtype, out.dtype))
            return out

        def cheb_pair(self, xg):
            t1, t2 = self.op.cheb_pair(xg)
            op_calls.append((xg.dtype, t1.dtype, t2.dtype))
            return t1, t2

    out = tm(torch.from_numpy(x), Recording(top) if hasattr(top, "cheb_pair") else top)
    if not hasattr(top, "cheb_pair"):   # the dense operator: its einsum, wrapped plainly
        op_calls = [(BF16, ref["st_block_0.graph_conv.cheb_graph_conv"])]
    assert out.dtype == got[""] == ref[""] == torch.float32
    assert set(got) <= set(ref), set(got) - set(ref)
    mismatched = {k: (d, ref[k]) for k, d in got.items() if d != ref[k]}
    assert not mismatched, mismatched
    assert got["st_block_0.tmp_conv1.causal_conv"] == got["output.fc2"] == BF16
    assert all(got[f"st_block_{l}"] == BF16 for l in range(tm.n_st_blocks))
    terms = {ref[f"st_block_{l}.graph_conv.cheb_graph_conv"] for l in range(tm.n_st_blocks)}
    assert terms == ({torch.float32} if kind == "dense" else {BF16}), terms
    assert op_calls and all(c[0] == BF16 and set(c[1:]) == terms for c in op_calls), op_calls
    assert ln_calls == [(torch.float32,) * 4] * (tm.n_st_blocks + 1), ln_calls
    assert all(ref[f"{blk}.ln"] == torch.float32
               for blk in [f"st_block_{l}" for l in range(tm.n_st_blocks)] + ["output"])


def test_ln_param_dtype_bf16_plumbing():
    """``ln_param_dtype=bfloat16`` (the counterpart of tests/test_ln_bf16.py):
    the LayerNorm affine is bf16 and every other parameter float32; the JAX
    bf16 leaves come in bit for bit and go out exactly; forward and
    gradients match JAX ``model.apply`` (float32 compute) at the float32
    model's bound; the LayerNorm gradients are bf16."""
    jop, top, v = _ops("dense")
    jm = JaxSTGCN(n_his=12, ln_param_dtype=jnp.bfloat16)
    rng = np.random.default_rng(2)
    x = rand(rng, B, 12, v, 1)
    # the JAX tree with bf16 LayerNorm leaves, random so that their patterns
    # are not all those of 1 and 0 (the float32 leaves are a port model's)
    jparams = params_to_jax(STGCN(12, v, device="cpu"))
    for blk in ("st_block_0", "st_block_1", "output"):
        jparams[blk]["ln"] = {k: np.asarray(jnp.asarray(1.0 + 0.3 * rand(rng, *a.shape),
                                                        jnp.bfloat16))
                              for k, a in jparams[blk]["ln"].items()}
    tm = STGCN(12, v, ln_param_dtype=BF16, device="cpu")
    tm.load_state_dict(params_from_jax(jparams))
    for name, p in tm.named_parameters():
        assert p.dtype == (BF16 if ".ln." in name else torch.float32), name
    for blk in ("st_block_0", "st_block_1", "output"):
        for leaf, tleaf in (("scale", "weight"), ("bias", "bias")):
            ref = jparams[blk]["ln"][leaf]
            np.testing.assert_array_equal(_bits(getattr(getattr(tm, blk).ln, tleaf).detach()),
                                          _bits(ref))
            out = params_to_jax(tm)[blk]["ln"][leaf]
            assert out.dtype == np.float32
            np.testing.assert_array_equal(out, np.asarray(ref, np.float32))

    def jloss(p):
        pred = jm.apply({"params": p}, jnp.asarray(x), jop, deterministic=True)
        return jnp.mean(pred ** 2), pred

    (_, ref), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    assert jg["st_block_0"]["ln"]["scale"].dtype == jnp.bfloat16
    params = dict(tm.named_parameters())
    out = tm(torch.from_numpy(x), top)
    grads = dict(zip(params, torch.autograd.grad((out ** 2).mean(), list(params.values()))))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)
    want = params_from_jax(to_np(jg))
    for k, g in grads.items():
        assert g.dtype == params[k].dtype, k
        r = want[k].float().numpy()
        # a bf16 gradient is one rounding of its float32 sum in both packages
        tol = (ULP2 if g.dtype == BF16 else 2e-5) * max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g.float().numpy(), r, atol=tol, rtol=ULP2, err_msg=k)


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

T_STEPS, N_HIS, N_PRED = 23, 12, 3   # 8 training windows: 2 full batches of 3 and a tail


def test_bf16_trajectory_matches_jax_and_f32(tmp_path):
    """Two epochs of bf16 training on the dense operator from the same
    weights, droprate 0: the port's ``Trainer`` against the JAX one and
    against the port's own float32 trajectory, at the JAX package's bf16
    bound (rtol 0.08, tests/test_train.py:235). Parameters and optimizer
    state stay float32."""
    adj = random_road_graph(V, k_neighbors=4, seed=11)
    vel = generate_synthetic_vel(adj, T_STEPS, seed=12)
    jscaler = JD.ZScoreScaler()
    jseries = jscaler.fit_transform(vel).astype(np.float32)
    jds = lambda a: JD.ForecastDataset(jnp.asarray(a), N_HIS, N_PRED)  # noqa: E731
    jcfg = JaxTrainConfig(n_his=N_HIS, n_pred=N_PRED, droprate=0.0, batch_size=B, seed=3,
                          compute_dtype="bfloat16", ckpt_dir=str(tmp_path / "jax"),
                          dataset_name="toy")
    jm = JaxSTGCN(n_his=N_HIS, droprate=0.0, dtype=jnp.bfloat16)
    # the Trainer's model.init, compiled once instead of run op by op (the
    # same draws; the port starts from the weights it gives)
    object.__setattr__(jm, "init", jax.jit(jm.init, static_argnames="deterministic"))
    jtr = JaxTrainer(jcfg, jm, jax_dense_graph_op(jax_build_gso(adj, "sym_norm_lap", cheb=True)),
                     jds(jseries), jds(jseries[:20]), jds(jseries[:20]), jscaler)
    state = params_from_jax(to_np(jax.device_get(jtr.params)))
    ref = []
    for _ in range(2):
        ref.append(jtr.train_epoch())
        jtr.epoch += 1

    scaler = ZScoreScaler().fit(vel)
    series = scaler.transform(vel)
    ds = lambda a: ForecastDataset.from_numpy(a, N_HIS, N_PRED, device="cpu")  # noqa: E731
    gop = dense_graph_op(build_gso(adj, "sym_norm_lap", cheb=True), device="cpu")

    def run(dtype):
        model = STGCN(N_HIS, V, droprate=0.0, dtype=dtype, device="cpu")
        model.load_state_dict(state)
        cfg = TrainConfig(n_his=N_HIS, n_pred=N_PRED, droprate=0.0, batch_size=B, seed=3,
                          compute_dtype="bfloat16" if dtype is not None else None,
                          ckpt_dir=str(tmp_path / str(dtype)), dataset_name="toy")
        tr = Trainer(cfg, model, gop, ds(series), ds(series[:20]), ds(series[:20]), scaler,
                     device="cpu")
        losses = []
        for _ in range(2):
            losses.append(tr.train_epoch())
            tr.epoch += 1
        assert all(p.dtype == torch.float32 for p in tr.params.values())
        assert all(m.dtype == torch.float32 for m in tr.opt_state["mu"].values())
        return losses

    l16, l32 = run(BF16), run(None)
    assert np.isfinite(l16).all()
    np.testing.assert_allclose(l16, ref, rtol=0.08)
    np.testing.assert_allclose(l16, l32, rtol=0.08)


# --------------------------------------------------------------------------
# the bf16 kernels' launch names, and what stays refused
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


@pytest.mark.parametrize("slabs", [torch.float32, BF16, torch.int8])
@pytest.mark.parametrize("mode", ["single", "pair", "chain"])
def test_bf16_launch_names_and_flags(mode, slabs, monkeypatch):
    """A bf16 operand on a non-CPU tensor makes one C call of the vn kernel
    with the bf16 flag and the slabs' value type (float32 0, int8 1, bf16
    2), counted under the ``_bf16`` name; K10 the same under
    ``bcsr_spmm_bf16``. The outputs are bf16."""
    fake = _FakeLib()
    monkeypatch.setattr(_build, "library", lambda: fake)
    for mod in (tbs, tsp):
        monkeypatch.setattr(mod, "cuda_device", lambda t: t.device)
        monkeypatch.setattr(mod, "stream_of", lambda dev: 0)
    data = torch.zeros(2, 128, 256, dtype=slabs, device="meta")
    empty = torch.zeros(0, dtype=torch.int32, device="meta")
    index = kernels.nnz_index.NnzIndex().bind(
        data, torch.zeros(385, dtype=torch.int32, device="meta"), empty, empty)
    lo, x = torch.zeros(2, dtype=torch.int32, device="meta"), torch.zeros(384, 8, dtype=BF16,
                                                                          device="meta")
    q = slabs == torch.int8
    sc = torch.ones(2, 128, device="meta") if q else None
    wrapper = {"single": tbs.banded_spmm, "pair": tbs.banded_cheb_pair_stream,
               "chain": tbs.banded_chain_stream}[mode]
    name = tbs.launch_name(mode, q, bf16=True)
    before = kernels.launch_counts()[name]
    if mode == "chain":
        out = wrapper(data, lo, x, x, scales_t=sc, index_t=index)
    else:
        out = wrapper(data, lo, x, scales=sc, index=index)
    assert kernels.launch_counts()[name] == before + 1
    (c_name, args), = fake.calls
    assert c_name == "stgcn_banded_vn" and len(args) == len(_build.SIGNATURES[c_name])
    assert args[14:17] == ({torch.float32: 0, torch.int8: 1, BF16: 2}[slabs], 1,
                           tbs.MODES[mode])
    assert all(o.dtype == BF16 for o in ([out] if mode == "single" else out))

    if slabs != torch.int8:
        tiles = torch.zeros(3, 1, 128, 128, dtype=slabs, device="meta")
        pack = tsp.BcsrPack(tiles, torch.zeros(3, 1, dtype=torch.int32, device="meta"),
                            torch.ones(3, dtype=torch.int32, device="meta"),
                            kernels.nnz_index.NnzIndex().bind(
                                tiles, torch.zeros(385, dtype=torch.int32, device="meta"),
                                empty, empty))
        before = kernels.launch_counts()
        y = tsp.bcsr_spmm(pack, x, scale=2.0)
        after = kernels.launch_counts()
        assert after["bcsr_spmm_bf16"] == before["bcsr_spmm_bf16"] + 1
        assert after["bcsr_spmm"] == before["bcsr_spmm"] and y.dtype == BF16
        c_name, args = fake.calls[-1]
        assert c_name == "stgcn_bcsr_spmm" and len(args) == len(_build.SIGNATURES[c_name])
        assert args[10:12] == (int(slabs == BF16), 1)


@pytest.mark.parametrize("model_kw,cfg_kw", [({}, {"compute_dtype": "bfloat16"}),
                                              ({"dtype": BF16}, {}),
                                              ({"remat": True}, {}),
                                              ({"dtype": BF16}, {"compute_dtype": "bfloat16",
                                                                 "remat": True})])
def test_unfused_trainer_refuses_a_config_the_model_disagrees_with(tmp_path, model_kw, cfg_kw):
    """On the unfused route the model's ``dtype`` and ``remat`` decide how it
    trains, so a ``TrainConfig`` that says otherwise raises ``ValueError``
    rather than training in another precision without a word."""
    _, top, _ = _ops("dense")
    vel = np.zeros((T_STEPS, V), np.float32)
    ds = ForecastDataset.from_numpy(vel, N_HIS, N_PRED, device="cpu")
    cfg = TrainConfig(n_his=N_HIS, n_pred=N_PRED, ckpt_dir=str(tmp_path), **cfg_kw)
    with pytest.raises(ValueError, match="the model's fields decide"):
        Trainer(cfg, STGCN(N_HIS, V, device="cpu", **model_kw), top, ds, ds, ds,
                ZScoreScaler().fit(vel + 1.0), device="cpu")


def test_fused_route_refuses_bf16_and_remat(tmp_path):
    """``fused=True`` trains a bf16 model (and a float32 one with a bf16
    LayerNorm affine) on the dense operator: one step each, finite losses
    (tests/test_torch_fused_bf16_bwd.py holds them to the float32 steps); a
    float32 model under ``compute_dtype="bfloat16"`` raises ``ValueError``,
    as on the unfused route. What stays refused raises
    ``NotImplementedError`` naming the fused bf16 slice: remat on the fused
    route, in the ``Trainer`` and in the CLI (``--fused True --remat True``);
    a fused bf16 ``Trainer`` on an operator whose graph terms run on K5 (the
    banded nv pack) or K6 (ELL), when it is built, and so the CLI's
    ``--fused True --compute_dtype bfloat16 --graph_op banded`` (the banded
    operator packed for K5); and the nv kernels themselves on a bf16
    operand: nothing falls back to float32."""
    jop, top, v = _ops("dense")
    adj = random_road_graph(V, k_neighbors=4, seed=11)
    vel = generate_synthetic_vel(adj, T_STEPS, seed=12)
    ds = ForecastDataset.from_numpy(ZScoreScaler().fit(vel).transform(vel), N_HIS, N_PRED,
                                    device="cpu")

    def trainer(model_kw, cfg_kw, gop=top, v_model=V):
        cfg = TrainConfig(n_his=N_HIS, n_pred=N_PRED, fused=True, batch_size=B,
                          ckpt_dir=str(tmp_path), **cfg_kw)
        return Trainer(cfg, STGCN(N_HIS, v_model, device="cpu", **model_kw), gop, ds, ds, ds,
                       ZScoreScaler().fit(vel), device="cpu")

    for model_kw, cfg_kw in (({"dtype": BF16}, {"compute_dtype": "bfloat16"}),
                             ({"ln_param_dtype": BF16}, {})):
        tr = trainer(model_kw, cfg_kw)
        starts, n_valid = tr._plan(tr.train_ds)[0]
        assert bool(torch.isfinite(tr.train_step(starts, n_valid, 0)))
    with pytest.raises(ValueError, match="the model's fields decide"):
        trainer({}, {"compute_dtype": "bfloat16"})
    with pytest.raises(NotImplementedError, match="fused bf16 slice"):
        trainer({"remat": True}, {"remat": True})
    with pytest.raises(NotImplementedError, match="fused bf16 slice"):
        tcli.main(["--dataset", "pemsd7-m", "--platform", "cpu", "--fused", "True",
                   "--remat", "True"])
    with pytest.raises(NotImplementedError, match=r"K5 / K6.*fused bf16 slice"):
        tcli.main(["--dataset", "pemsd7-m", "--platform", "cpu", "--fused", "True",
                   "--compute_dtype", "bfloat16", "--graph_op", "banded"])
    model = STGCN(N_HIS, V, dtype=BF16, device="cpu")
    out = fused_sparse_forward(model.state_dict(), torch.zeros(1, N_HIS, V, 1), top, model)
    assert out.dtype == torch.float32 and out.shape == (1, 1, V, 1)
    assert bool(torch.isfinite(out).all())
    _, _, tart = banded_gsos(n=V_SPARSE, seed=3)
    nv_op = banded_graph_op(tart, block_size=128, nv=True, nv_only=True, device="cpu")
    ell = ell_graph_op(tart, block_size=128, device="cpu")
    xb = torch.zeros(2, N_HIS, V_SPARSE, 4, dtype=BF16)
    for op in (nv_op, ell):
        with pytest.raises(NotImplementedError, match="fused bf16 slice"):
            op.cheb_pair(xb)
        with pytest.raises(NotImplementedError, match=r"K5 / K6.*fused bf16 slice"):
            trainer({"dtype": BF16}, {"compute_dtype": "bfloat16"}, gop=op, v_model=V_SPARSE)
