"""The bf16 variants of the nv graph kernels K5 (banded) and K6 (blocked
ELL) against the JAX package, on the CPU (their plain versions):

- K5's plain version in each mode over float32, bf16 and int8 slabs, pass by
  pass against JAX ``_nv_ref`` at the TPU kernel's rounding points
  (``stgcn_tpu/kernels/banded_nv.py:141-183``: one rounding a pass, after
  the epilogue), each pass fed the port's own first pass; the whole pair and
  chain against the off-TPU branch of ``_stream_nv_call`` (:239-255, which
  rounds ``A·t1`` before ``2·that − x``) within the bf16 bound;
- K6's plain version in each mode over float32, int8 and bf16 tiles against
  JAX ``ell_spmm_nv``, ``ell_cheb_pair_nv`` and its VJP (``jax.vjp``) on the
  same bf16 inputs: the JAX ELL path rounds each application before its add,
  and so does K6's bf16 variant;
- the bf16 packs (``ell_graph_op(dtype=bfloat16)``, the banded nv pack of
  ``banded_graph_op(dtype=bfloat16, nv=True)``) bit for bit against JAX's;
- the autograd Functions' gradients in the operand's type, the wrappers' C
  calls through a fake library, and what the kernels refuse.

Each bf16 output is held by ``kernels/bf16_bounds.within``: within 2 ulps of
bf16 beside its rounding scale (``bf16_bounds.spmm_scale``), and at most a
share 2^-10 of its elements past the strict 2 ulps. V = 600 (RCM-ordered,
block size 128: v_pad 640), N = 24 (B = 3 by 8 channels). XLA's CPU
backend has no bf16 dot: the JAX references widen to float32 before theirs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgcn_tpu.kernels import ell_nv as jek
from stgcn_tpu.kernels.banded_nv import _nv_ref as jax_nv_ref
from stgcn_tpu.kernels.banded_nv import _stream_nv_call
from stgcn_tpu.ops.graph_op import banded_graph_op as jax_banded_graph_op
from stgcn_tpu.ops.graph_op import ell_graph_op as jax_ell_graph_op
from stgcn_tpu_torch import kernels
from stgcn_tpu_torch.kernels import _build
from stgcn_tpu_torch.kernels import banded_nv as tnv
from stgcn_tpu_torch.kernels import bf16_bounds as bb
from stgcn_tpu_torch.kernels import ell_nv as tek
from stgcn_tpu_torch.kernels.banded_spmm import _round_up
from stgcn_tpu_torch.kernels.nnz_index import NnzIndex
from stgcn_tpu_torch.ops import banded_graph_op, ell_graph_op
from tests.torch_parity_utils import BANDED_V, banded_gsos, rand

BF16 = torch.bfloat16
BS = 128
N = 24
MODES = ("single", "pair", "chain")
SLABS = {"f32": {}, "bf16": {"dtype": BF16}, "int8": {"quantize": True}}


def _j(t: torch.Tensor):
    """A port tensor as a JAX array of the same type and bits."""
    if t.dtype == BF16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(BF16)
    return torch.from_numpy(np.array(a, copy=True))


def _bf16(rng, *shape) -> torch.Tensor:
    return torch.from_numpy(rand(rng, *shape)).to(BF16)


def _gsos():
    return banded_gsos(n=BANDED_V, seed=3)


def _banded(kind):
    """(JAX op, port op) of the banded stream pack with its nv family."""
    _, jart, tart = _gsos()
    jkw = {"dtype": jnp.bfloat16} if kind == "bf16" else SLABS[kind]
    return (jax_banded_graph_op(jart, block_size=BS, nv=True, use_pallas=False, **jkw),
            banded_graph_op(tart, block_size=BS, nv=True, device="cpu", **SLABS[kind]))


def _ell(kind):
    """(JAX op, port op) of the blocked-ELL operator."""
    _, jart, tart = _gsos()
    jkw = {"dtype": jnp.bfloat16} if kind == "bf16" else SLABS[kind]
    return (jax_ell_graph_op(jart, block_size=BS, use_pallas=False, **jkw),
            ell_graph_op(tart, block_size=BS, device="cpu", **SLABS[kind]))


def _k5_abs(op):
    """``|A| v`` of the banded nv pack (the rounding scale's product)."""
    slabs = op.slabs_nv.float().abs()
    scales = None if op.scales is None else op.scales.abs()
    return lambda v: tnv.nv_pass_reference(slabs, op.lo, v.float(), scales=scales)


def _k6_abs(pack):
    absp = pack._replace(data=pack.data.float().abs(),
                         scales=None if pack.scales is None else pack.scales.abs())
    return lambda v: tek._apply_reference(absp, v.float())


def _jax_k5_one(jop, v32):
    """One application by JAX ``_nv_ref`` in float32, padded as
    ``_stream_nv_call`` pads its windows (:232-235) and cut to v_pad."""
    nbr, _, bs = jop.slabs_nv.shape
    v_pad = v32.shape[1]
    x_cols = _round_up(max(v_pad, nbr * bs), bs)
    y = jax_nv_ref(jop.slabs_nv, jop.lo, jnp.pad(v32, ((0, 0), (0, x_cols - v_pad))),
                   jop.scales)
    return y[:, :v_pad] if y.shape[1] >= v_pad else jnp.pad(y, ((0, 0), (0, v_pad - y.shape[1])))


@pytest.mark.parametrize("kind", list(SLABS))
def test_plain_k5_bf16_passes_match_jax_nv_ref(kind):
    """K5's plain version on a bf16 operand, each pass against JAX
    ``_nv_ref`` (float32 sums) with the TPU kernel's epilogue and its one
    rounding: single ``bf16(α·A x)``; pair ``t1 = bf16(A x)``, ``t2 =
    bf16(2·A t1 − x)``; chain ``u = bf16(2·A x + g)``, ``dx = bf16(A u −
    x)``; the second pass fed the port's own first one. bf16 outputs."""
    jop, op = _banded(kind)
    rng = np.random.default_rng(21)
    x, g = _bf16(rng, N, op.v_pad), _bf16(rng, N, op.v_pad)
    x32, g32 = _j(x.float()), _j(g.float())
    absa = _k5_abs(op)

    def rnd(a):
        return _t(a.astype(jnp.bfloat16))

    for scale in (1.0, 2.0):
        got = tnv.stream_nv_reference(op.slabs_nv, op.lo, x, scales=op.scales, scale=scale)
        bb.within(got, rnd(scale * _jax_k5_one(jop, x32)),
                  bb.spmm_scale(absa, x, scale=scale))
    t1, t2 = tnv.stream_nv_reference(op.slabs_nv, op.lo, x, mode="pair", scales=op.scales)
    m1, m2 = bb.spmm_scale(absa, x, mode="pair")
    bb.within(t1, rnd(_jax_k5_one(jop, x32)), m1)
    bb.within(t2, rnd(2.0 * _jax_k5_one(jop, _j(t1.float())) - x32), m2)
    u, dx = tnv.stream_nv_reference(op.slabs_nv, op.lo, x, g, "chain", scales=op.scales)
    m1, m2 = bb.spmm_scale(absa, x, g, "chain")
    bb.within(u, rnd(2.0 * _jax_k5_one(jop, x32) + g32), m1)
    bb.within(dx, rnd(_jax_k5_one(jop, _j(u.float())) - x32), m2)
    assert all(o.dtype == BF16 for o in (t1, t2, u, dx))


@pytest.mark.parametrize("kind", list(SLABS))
def test_plain_k5_bf16_matches_jax_off_tpu_branch(kind):
    """The whole of each mode against ``_stream_nv_call``'s off-TPU branch
    on the same bf16 inputs, within the bf16 bound beside the rounding scale.
    That branch rounds ``A·t1`` to bf16 before ``2·that − x`` and subtracts
    in bf16, one rounding more than the TPU kernel: where x cancels part of
    ``2·A·t1`` that rounding moves t2 by an ulp of ``2·A·t1``, not of t2, in
    a share of the elements far above 2^-10 (about 15 % here), so the rarity
    rule of the strict 2 ulps is not applied; single mode rounds at the same
    point and keeps it."""
    jop, op = _banded(kind)
    rng = np.random.default_rng(22)
    x, g = _bf16(rng, N, op.v_pad), _bf16(rng, N, op.v_pad)
    absa = _k5_abs(op)
    for mode in MODES:
        got = tnv.stream_nv_reference(op.slabs_nv, op.lo, x, g if mode == "chain" else None,
                                      mode, scales=op.scales)
        ref = _stream_nv_call(jop.slabs_nv, jop.lo, _j(x), _j(g) if mode == "chain" else None,
                              jop.scales, None, mode)
        ref = [_t(r) for r in (ref if mode != "single" else [ref])]
        bb.within(got, ref if mode != "single" else ref[0],
                  bb.spmm_scale(absa, x, g, mode), rare=1.0 if mode != "single" else bb.RARE)


@pytest.mark.parametrize("kind", list(SLABS))
def test_plain_k6_bf16_matches_jax_ell(kind):
    """K6's plain version on a bf16 operand against JAX ``ell_spmm_nv``
    (single, and the Chebyshev 2G step through the op's ``apply_nv(scale=
    2)``), ``ell_cheb_pair_nv`` (t1, t2) and its VJP's dx for cotangents
    (g1, g2) (the chain on the transpose pack: u against JAX's ``dt1 =
    bf16(g1 + 2·bf16(Aᵀ g2))``, dx against ``jax.vjp``); bf16 outputs."""
    jop, op = _ell(kind)
    rng = np.random.default_rng(23)
    x, g1, g2 = (_bf16(rng, N, op.v_pad) for _ in range(3))
    xj, g1j, g2j = _j(x), _j(g1), _j(g2)
    absa = _k6_abs(op.pack)
    jargs = (jop.data, jop.cols, jop.counts, jop.data_t, jop.cols_t, jop.counts_t)

    for scale in (1.0, 2.0):
        got = tek.ell_nv_reference(op.pack, x, scale=scale)
        bb.within(got, _t(jop.apply_nv(xj, scale=scale)), bb.spmm_scale(absa, x, scale=scale))
    got = tek.ell_nv_reference(op.pack, x, mode="pair")
    ref = jek.ell_cheb_pair_nv(*jargs, xj, jop.scales, jop.scales_t, False)
    bb.within(got, [_t(r) for r in ref], bb.spmm_scale(absa, x, mode="pair"))
    _, vjp = jax.vjp(lambda v: jek.ell_cheb_pair_nv(*jargs, v, jop.scales, jop.scales_t, False),
                     xj)
    (dx_ref,) = vjp((g1j, g2j))
    at_g2 = jek.ell_spmm_nv(jop.data_t, jop.cols_t, jop.counts_t, g2j, jop.scales_t,
                            use_pallas=False)
    u_ref = (g1j.astype(jnp.float32) + 2.0 * at_g2.astype(jnp.float32)).astype(jnp.bfloat16)
    u, dx = tek.ell_nv_reference(op.pack_t, g2, g1, "chain")
    bb.within([u, dx], [_t(u_ref), _t(dx_ref)], bb.spmm_scale(_k6_abs(op.pack_t), g2, g1,
                                                              "chain"))
    assert u.dtype == dx.dtype == BF16


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_bf16_packs_match_jax_bit_for_bit(kind):
    """``ell_graph_op(dtype=bfloat16)`` (an int8 one ignores ``dtype``, as in
    JAX) and the nv slabs of ``banded_graph_op(dtype=bfloat16, nv=True)``
    equal the JAX packs bit for bit: 16-bit patterns, int8 values, their
    columns, counts, window starts and lane factors."""
    _, jart, tart = _gsos()
    jell = jax_ell_graph_op(jart, block_size=BS, dtype=jnp.bfloat16, quantize=kind == "int8",
                            use_pallas=False)
    tell = ell_graph_op(tart, block_size=BS, dtype=BF16, quantize=kind == "int8", device="cpu")
    jband = jax_banded_graph_op(jart, block_size=BS, nv=True, dtype=jnp.bfloat16,
                                quantize=kind == "int8", use_pallas=False)
    tband = banded_graph_op(tart, block_size=BS, nv=True, dtype=BF16, quantize=kind == "int8",
                            device="cpu")
    want = BF16 if kind == "bf16" else torch.int8
    pairs = [(tell.pack.data, jell.data), (tell.pack_t.data, jell.data_t),
             (tband.slabs_nv, jband.slabs_nv), (tband.slabs_nv_t, jband.slabs_nv_t)]
    for got, ref in pairs:
        assert got.dtype == want
        bits = got.view(torch.int16) if want == BF16 else got
        rbits = np.asarray(ref).view(np.int16) if want == BF16 else np.asarray(ref)
        np.testing.assert_array_equal(bits.numpy(), rbits)
    for got, ref in ((tell.pack.cols, jell.cols), (tell.pack.counts, jell.counts),
                     (tband.lo, jband.lo)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if kind == "int8":
        np.testing.assert_array_equal(tell.pack.scales.numpy(), np.asarray(jell.scales))
        np.testing.assert_array_equal(tband.scales.numpy(), np.asarray(jband.scales))


@pytest.mark.parametrize("op_kind", ["banded", "ell"])
def test_nv_functions_give_the_operand_type(op_kind):
    """The autograd Functions (``apply_nv`` and ``cheb_pair_nv`` of the
    banded nv and ELL operators) on a bf16 operand: bf16 outputs and a bf16
    gradient, the chain's (or the single's on the transpose pack) plain
    version bit for bit; a float32 operand over the same float32 pack keeps
    float32 throughout."""
    op = _banded("f32")[1] if op_kind == "banded" else _ell("f32")[1]
    rng = np.random.default_rng(24)
    x, g1, g2 = (_bf16(rng, N, op.v_pad) for _ in range(3))
    chain = (lambda a, b: tnv.stream_nv_reference(op.slabs_nv_t, op.lo_t, a, b, "chain",
                                                  scales=op.scales_t)) \
        if op_kind == "banded" else (lambda a, b: tek.ell_nv_reference(op.pack_t, a, b, "chain"))
    for dt in (BF16, torch.float32):
        xx = x.to(dt).requires_grad_(True)
        t1, t2 = op.cheb_pair_nv(xx)
        assert t1.dtype == t2.dtype == dt
        (dx,) = torch.autograd.grad((t1, t2), [xx], (g1.to(dt), g2.to(dt)))
        assert dx.dtype == dt
        torch.testing.assert_close(dx, chain(g2.to(dt), g1.to(dt))[1], rtol=0, atol=0)
        y = op.apply_nv(xx, scale=2.0)
        (dy,) = torch.autograd.grad(y, [xx], g1.to(dt))
        assert y.dtype == dy.dtype == dt


def _fake(monkeypatch):
    """A library that records each entry point's arguments, and the wrappers
    taught to take "meta" tensors as the card's."""
    class Fake:
        def __init__(self):
            self.calls = []

        def __getattr__(self, name):
            def fn(*args):
                self.calls.append((name, args))
                return 0
            return fn

    fake = Fake()
    monkeypatch.setattr(_build, "library", lambda: fake)
    for mod in (tnv, tek):
        monkeypatch.setattr(mod, "cuda_device", lambda t: t.device)
        monkeypatch.setattr(mod, "stream_of", lambda dev: 0)
    return fake


def _meta(*shape, dtype=BF16):
    return torch.zeros(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("mode", MODES)
def test_nv_bf16_wrappers_call_their_entry_points(mode, monkeypatch):
    """On a non-CPU tensor ``stream_nv`` (over float32, bf16 and int8 slabs)
    and ``ell_nv`` (over float32, int8 and bf16 tiles) with a bf16 operand
    make one call of their entry point with the signature's argument count,
    the values' type (float32 0, int8 1, bf16 2), the bf16 flag and the
    mode; the workspace and every output are bf16; each launch counts under
    its ``_bf16`` name and not the float32 one's."""
    fake = _fake(monkeypatch)
    vp, n = 256, 16
    row_ptr, empty = _meta(vp + 1, dtype=torch.int32), _meta(0, dtype=torch.int32)
    x, g = _meta(n, vp), _meta(n, vp) if mode == "chain" else None
    for vals in (torch.float32, BF16, torch.int8):
        q = vals == torch.int8
        slabs = _meta(2, 256, BS, dtype=vals)
        scales = _meta(2, BS, dtype=torch.float32) if q else None
        index = NnzIndex().bind(slabs, row_ptr, empty, empty)
        before = kernels.launch_counts()
        out = tnv.stream_nv(slabs, _meta(2, dtype=torch.int32), x, g, mode, scales=scales,
                            index=index)
        after = kernels.launch_counts()
        name = tnv.launch_name(mode, q, bf16=True)
        assert after[name] == before[name] + 1 and after[tnv.launch_name(mode, q)] == \
            before[tnv.launch_name(mode, q)]
        c_name, args = fake.calls[-1]
        assert c_name == "stgcn_banded_nv" and len(args) == len(_build.SIGNATURES[c_name])
        assert args[15:18] == ({torch.float32: 0, torch.int8: 1, BF16: 2}[vals], 1,
                               tnv.MODES[mode])

        tiles = _meta(2, 1, BS, BS, dtype=vals)
        pack = tek.EllPack(tiles, _meta(2, 1, dtype=torch.int32), _meta(2, dtype=torch.int32),
                           scales, NnzIndex().bind(tiles, row_ptr, empty, empty))
        before = kernels.launch_counts()
        out2 = tek.ell_nv(pack, x, g, mode)
        after = kernels.launch_counts()
        name = tek.pack_launch_name(pack, mode, x)
        assert name.endswith("_bf16") and after[name] == before[name] + 1
        c_name, args = fake.calls[-1]
        assert c_name == "stgcn_ell_nv" and len(args) == len(_build.SIGNATURES[c_name])
        assert args[14:17] == ({torch.float32: 0, torch.int8: 1, BF16: 2}[vals], 1,
                               tek.MODES[mode])
        for o in (out, out2):
            assert all(t.dtype == BF16 for t in ([o] if mode == "single" else o))


def test_nv_kernels_refuse_what_they_lack(monkeypatch):
    """What K5 and K6 do not take raises before any call, and nothing is
    cast: bf16 values under a float32 operand, a float16 operand, an
    operand whose type differs from g's."""
    fake = _fake(monkeypatch)
    vp = 256
    row_ptr, empty = _meta(vp + 1, dtype=torch.int32), _meta(0, dtype=torch.int32)
    slabs = _meta(2, 256, BS)
    index = NnzIndex().bind(slabs, row_ptr, empty, empty)
    lo = _meta(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="bf16 under a bf16 operand"):
        tnv.stream_nv(slabs, lo, _meta(8, vp, dtype=torch.float32), index=index)
    with pytest.raises(TypeError, match="float32 or bf16 operand"):
        tnv.stream_nv(slabs, lo, _meta(8, vp, dtype=torch.float16), index=index)
    with pytest.raises(TypeError, match="g_nv must be torch.bfloat16"):
        tnv.stream_nv(slabs, lo, _meta(8, vp), _meta(8, vp, dtype=torch.float32), "chain",
                      index=index)
    tiles = _meta(2, 1, BS, BS)
    pack = tek.EllPack(tiles, _meta(2, 1, dtype=torch.int32), _meta(2, dtype=torch.int32),
                       None, NnzIndex().bind(tiles, row_ptr, empty, empty))
    with pytest.raises(ValueError, match="bf16 under a bf16 operand"):
        tek.ell_nv(pack, _meta(8, vp, dtype=torch.float32))
    assert not fake.calls
