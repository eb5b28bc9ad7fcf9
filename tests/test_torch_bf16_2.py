"""More of ``tests/test_torch_bf16.py``'s tests: each port test file holds at most
20 collected tests. Helpers, constants and fixtures come from there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgcn_tpu.data import datasets as JD
from stgcn_tpu.data.synthetic import generate_synthetic_vel, random_road_graph
from stgcn_tpu.graph import build_gso as jax_build_gso
from stgcn_tpu.nn.model import STGCN as JaxSTGCN
from stgcn_tpu.ops import dense_graph_op as jax_dense_graph_op
from stgcn_tpu.train.loop import TrainConfig as JaxTrainConfig
from stgcn_tpu.train.loop import Trainer as JaxTrainer
from stgcn_tpu_torch.data import ForecastDataset, ZScoreScaler
from stgcn_tpu_torch.graph import build_gso
from stgcn_tpu_torch.nn.convert import params_from_jax, params_to_jax
from stgcn_tpu_torch.nn.model import STGCN
from stgcn_tpu_torch.ops import dense_graph_op
from stgcn_tpu_torch.train import TrainConfig, Trainer
from tests.torch_parity_utils import B, V, rand, to_np
from tests.test_torch_bf16 import (
    BF16,
    GRAD_REL_L2,
    MODEL_ATOL,
    MODEL_RTOL,
    N_HIS,
    N_PRED,
    T_STEPS,
    ULP2,
    _bits,
    _ops,
)


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
