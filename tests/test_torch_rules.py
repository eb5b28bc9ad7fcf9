"""Rules of the port: it imports no JAX and nothing of ``stgcn_tpu``; its
entry points run on the card unless the caller asks for the CPU; a kernel
wrapper runs its plain version only for a CPU tensor."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import stgcn_tpu_torch
from stgcn_tpu_torch import kernels
from stgcn_tpu_torch.kernels import _build, _launch, nnz_index
from stgcn_tpu_torch.kernels import banded_nv as tnv
from stgcn_tpu_torch.kernels import banded_spmm as tbs
from stgcn_tpu_torch.kernels import ell_nv as tek
from stgcn_tpu_torch.kernels import fused_stblock as tfs
from stgcn_tpu_torch.kernels import output_head as toh
from stgcn_tpu_torch.kernels import sddmm as tsd
from stgcn_tpu_torch.kernels import spmm as tsp
from stgcn_tpu_torch.kernels import vertex_fused as tvf

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "stgcn_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "pandas", "stgcn_tpu"}


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys, stgcn_tpu_torch\n"
        "for m in pkgutil.walk_packages(stgcn_tpu_torch.__path__, 'stgcn_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
        "print(len([m for m in sys.modules if m.startswith('stgcn_tpu_torch')]), bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_mods, bad = out.stdout.strip().split(" ", 1)
    assert int(n_mods) >= 20 and bad == "[]", out.stdout


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in
                                        [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


def _gso():
    from stgcn_tpu_torch.graph import build_gso
    import scipy.sparse as sp

    return build_gso(sp.random(12, 12, density=0.3, random_state=0) + sp.eye(12))


def _cpu_trainer_parts():
    from stgcn_tpu_torch.ops import dense_graph_op

    ds = stgcn_tpu_torch.ForecastDataset.from_numpy(np.zeros((30, 12)), 12, 3, device="cpu")
    scaler = stgcn_tpu_torch.ZScoreScaler().fit(np.ones((30, 12)))
    return (stgcn_tpu_torch.STGCN(12, 12, device="cpu"), dense_graph_op(_gso(), device="cpu"),
            ds, ds, ds, scaler)


ENTRY_POINTS = {
    "STGCN": lambda: stgcn_tpu_torch.STGCN(12, 12),
    "Trainer": lambda: stgcn_tpu_torch.Trainer(stgcn_tpu_torch.TrainConfig(),
                                               *_cpu_trainer_parts()),
    "make_graph_op": lambda: stgcn_tpu_torch.make_graph_op(_gso()),
    "dense_graph_op": lambda: __import__("stgcn_tpu_torch.ops", fromlist=["x"])
    .dense_graph_op(_gso()),
    "ForecastDataset.from_numpy": lambda: stgcn_tpu_torch.ForecastDataset.from_numpy(
        np.zeros((30, 12)), 12, 3),
    "banded_graph_op": lambda: __import__("stgcn_tpu_torch.ops", fromlist=["x"])
    .banded_graph_op(_gso()),
    "make_graph_op(banded)": lambda: stgcn_tpu_torch.make_graph_op(_gso(), "banded"),
    "make_graph_op(banded_int8)": lambda: stgcn_tpu_torch.make_graph_op(_gso(), "banded_int8"),
    "banded_graph_op(quantize=True)": lambda: __import__("stgcn_tpu_torch.ops", fromlist=["x"])
    .banded_graph_op(_gso(), quantize=True),
    "pack_banded_device": lambda: tbs.pack_banded_device(_gso().matrix),
    "pack_banded_with_transpose": lambda: tbs.pack_banded_with_transpose(_gso().matrix),
    "ell_graph_op": lambda: __import__("stgcn_tpu_torch.ops", fromlist=["x"])
    .ell_graph_op(_gso()),
    "make_graph_op(ell_int8)": lambda: stgcn_tpu_torch.make_graph_op(_gso(), "ell_int8"),
    "pack_ell_device": lambda: __import__("stgcn_tpu_torch.graph.packing", fromlist=["x"])
    .pack_ell_device(_gso().matrix),
    "bcsr_graph_op": lambda: __import__("stgcn_tpu_torch.ops", fromlist=["x"])
    .bcsr_graph_op(_gso()),
    "make_graph_op(bcsr)": lambda: stgcn_tpu_torch.make_graph_op(_gso(), "bcsr"),
    "pack_bcsr_device": lambda: __import__("stgcn_tpu_torch.graph.packing", fromlist=["x"])
    .pack_bcsr_device(_gso().matrix),
    "cli.build_trainer": lambda: __import__("stgcn_tpu_torch.cli", fromlist=["x"]).build_trainer(
        stgcn_tpu_torch.TrainConfig(), dataset="pemsd7-m", data_root=str(ROOT / "data")),
    "cli.main": lambda: __import__("stgcn_tpu_torch.cli", fromlist=["x"]).main(
        ["--dataset", "pemsd7-m", "--data_root", str(ROOT / "data"), "--epochs", "1"]),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="cuda"):
        ENTRY_POINTS[name]()


class _FakeLib:
    """Stands in for the CUDA library: records each entry-point call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, len(args)))
            return 0
        return fn


def _wrapper_cases():
    vcfg = tvf.VertexBlockCfg(kt=3, ks=3, act_func="glu", graph_conv_type="cheb_graph_conv",
                              v_true=100, v_pad=128, t_in=8, c_in=16, c0=16, c1=8, c2=16,
                              apply_ln=True)
    ocfg = toh.OutHeadCfg(ko=4, c_in=16, c0=32, c1=24, c_end=1, act_func="glu",
                          v_true=100, v_pad=128)
    b = 2

    def z(*shape):
        return lambda dev: torch.zeros(shape, device=dev)

    st = (z(b, 8, 1, 1), z(b, 8, 1, 1), z(16, 128), z(16, 128))
    head = [z(b, 8, 16, 128), *st, z(3, 16, 32), z(32), z(16, 8), z(8)]
    tail = [z(b, 6, 8, 128)] * 3 + [z(3, 8, 8), z(8), z(3, 8, 32), z(32)]
    ohead = [z(b, 4, 16, 128), z(b, 4, 1, 1), z(b, 4, 1, 1), z(16, 128), z(16, 128),
             z(4, 16, 64), z(64)]
    ofc = [z(b, 1, 32, 128), z(b, 1, 1, 1), z(b, 1, 1, 1), z(32, 128), z(32, 128),
           z(32, 24), z(24), z(24, 1), z(1)]
    return {
        "head_bwd": (tvf, "head_bwd_reference", "stgcn_head_bwd", tvf.head_bwd, vcfg,
                     head + [z(b, 6, 8, 128)]),
        "tail_bwd": (tvf, "tail_bwd_reference", "stgcn_tail_bwd", tvf.tail_bwd, vcfg,
                     tail + [z(b, 4, 16, 128), z(b, 4, 1, 1), z(b, 4, 1, 1)]),
        "ohead_bwd": (toh, "ohead_bwd_reference", "stgcn_ohead_bwd", toh.ohead_bwd, ocfg,
                      ohead + [z(b, 1, 32, 128), z(b, 1, 1, 1), z(b, 1, 1, 1)]),
        "ofc_bwd": (toh, "ofc_bwd_reference", "stgcn_ofc_bwd", toh.ofc_bwd, ocfg,
                    ofc + [z(b, 1, 1, 128)]),
        "head_fwd": (tvf, "head_reference", "stgcn_head_fwd", tvf.head_fwd, vcfg,
                     [z(b, 8, 16, 128), *st, z(3, 16, 32), z(32), z(16, 8), z(8)]),
        "tail_fwd": (tvf, "tail_reference", "stgcn_tail_fwd", tvf.tail_fwd, vcfg,
                     [z(b, 6, 8, 128)] * 3 + [z(3, 8, 8), z(8), z(3, 8, 32), z(32)]),
        "ohead_fwd": (toh, "ohead_reference", "stgcn_ohead_fwd", toh.ohead_fwd, ocfg,
                      [z(b, 4, 16, 128), z(b, 4, 1, 1), z(b, 4, 1, 1), z(16, 128),
                       z(16, 128), z(4, 16, 64), z(64)]),
        "ofc_fwd": (toh, "ofc_reference", "stgcn_ofc_fwd", toh.ofc_fwd, ocfg,
                    [z(b, 1, 32, 128), z(b, 1, 1, 1), z(b, 1, 1, 1), z(32, 128), z(32, 128),
                     z(32, 24), z(24), z(24, 1), z(1)]),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_cases()))
def test_wrapper_takes_plain_version_only_on_cpu(name, monkeypatch):
    """Followed by code path, not by device: with the library replaced by a
    recorder, a non-CPU tensor (``meta`` stands in for CUDA) runs the launch
    path — checks, allocation, one C call, the counter — and never the
    plain version; a CPU tensor runs the plain version and launches nothing."""
    mod, ref_name, c_name, wrapper, cfg, makers = _wrapper_cases()[name]
    plain_calls = []
    real_ref = getattr(mod, ref_name)
    monkeypatch.setattr(mod, ref_name,
                        lambda *a, **k: plain_calls.append(1) or real_ref(*a, **k))
    fake = _FakeLib()
    monkeypatch.setattr(_build, "library", lambda: fake)
    monkeypatch.setattr(mod, "cuda_device", lambda t: t.device)
    monkeypatch.setattr(mod, "stream_of", lambda dev: 0)

    before = kernels.launch_counts()[name]
    wrapper(cfg, *[m("meta") for m in makers])
    assert plain_calls == [] and kernels.launch_counts()[name] == before + 1
    launches = [c for c in fake.calls if c[0] in _build.SIGNATURES]
    assert launches == [(c_name, len(_build.SIGNATURES[c_name]))]
    # besides its one launch, a backward wrapper (and only a backward one)
    # sizes its own workspace first
    others = [c for c in fake.calls if c[0] not in _build.SIGNATURES]
    if name.endswith("_bwd"):
        work = c_name + "_work"
        assert others == [(work, len(_build.WORK_SIGNATURES[work]))]
    else:
        assert others == []
    n_calls = len(fake.calls)

    wrapper(cfg, *[m("cpu") for m in makers])
    assert plain_calls == [1] and kernels.launch_counts()[name] == before + 1
    assert len(fake.calls) == n_calls


@pytest.mark.parametrize("mode", ["single", "pair", "chain"])
def test_nv_wrapper_takes_plain_version_only_on_cpu(mode, monkeypatch):
    """K5's wrapper, as above: one C call per wrapper call (both passes of
    pair and chain are launched inside it), counted under its mode."""
    plain_calls = []
    real_ref = tnv.stream_nv_reference
    monkeypatch.setattr(tnv, "stream_nv_reference",
                        lambda *a, **k: plain_calls.append(1) or real_ref(*a, **k))
    fake = _FakeLib()
    monkeypatch.setattr(_build, "library", lambda: fake)
    monkeypatch.setattr(tnv, "cuda_device", lambda t: t.device)
    monkeypatch.setattr(tnv, "stream_of", lambda dev: 0)

    slabs = {d: torch.zeros(1, 256, 128, device=d) for d in ("meta", "cpu")}
    index = _empty_slab_index(slabs["meta"], 256)

    def args(dev):
        g = torch.zeros(5, 256, device=dev) if mode == "chain" else None
        return (slabs[dev], torch.zeros(1, dtype=torch.int32, device=dev),
                torch.zeros(5, 256, device=dev), g)

    name = f"nv_{mode}"
    before = kernels.launch_counts()[name]
    out = tnv.stream_nv(*args("meta"), mode, index=index)
    assert plain_calls == [] and kernels.launch_counts()[name] == before + 1
    assert fake.calls == [("stgcn_banded_nv", len(_build.SIGNATURES["stgcn_banded_nv"]))]
    assert all(o.shape == (5, 256) for o in ([out] if mode == "single" else out))
    tnv.stream_nv(*args("cpu"), mode)
    assert plain_calls == [1] and kernels.launch_counts()[name] == before + 1
    assert len(fake.calls) == 1
    with pytest.raises(ValueError, match="no nonzero index"):   # the card needs the index
        tnv.stream_nv(*args("meta"), mode)
    with pytest.raises(ValueError, match="CUDA or CPU"):   # without the test double
        monkeypatch.undo()
        tnv.stream_nv(*args("meta"), mode, index=index)


@pytest.mark.parametrize("mode", ["single", "pair", "chain"])
def test_nv_int8_wrapper_takes_plain_version_only_on_cpu(mode, monkeypatch):
    """K5's wrapper on an int8 pack with its scales, as above, counted under
    its mode and dtype."""
    plain_calls = []
    real_ref = tnv.stream_nv_reference
    monkeypatch.setattr(tnv, "stream_nv_reference",
                        lambda *a, **k: plain_calls.append(1) or real_ref(*a, **k))
    fake = _FakeLib()
    monkeypatch.setattr(_build, "library", lambda: fake)
    monkeypatch.setattr(tnv, "cuda_device", lambda t: t.device)
    monkeypatch.setattr(tnv, "stream_of", lambda dev: 0)

    slabs = {d: torch.zeros(1, 256, 128, dtype=torch.int8, device=d) for d in ("meta", "cpu")}
    index = _empty_slab_index(slabs["meta"], 256)

    def args(dev):
        g = torch.zeros(5, 256, device=dev) if mode == "chain" else None
        return (slabs[dev], torch.zeros(1, dtype=torch.int32, device=dev),
                torch.zeros(5, 256, device=dev), g)

    name = tnv.launch_name(mode, True)
    scales = {d: torch.ones(1, 128, device=d) for d in ("meta", "cpu")}
    before = kernels.launch_counts()[name]
    out = tnv.stream_nv(*args("meta"), mode, scales=scales["meta"], index=index)
    assert plain_calls == [] and kernels.launch_counts()[name] == before + 1
    assert fake.calls == [("stgcn_banded_nv", len(_build.SIGNATURES["stgcn_banded_nv"]))]
    assert all(o.shape == (5, 256) for o in ([out] if mode == "single" else out))
    tnv.stream_nv(*args("cpu"), mode, scales=scales["cpu"])
    assert plain_calls == [1] and kernels.launch_counts()[name] == before + 1
    with pytest.raises(ValueError, match="int8"):   # int8 slabs without their scales
        tnv.stream_nv(*args("meta"), mode, index=index)


VN_WRAPPERS = {   # launch name: (wrapper, its mode, int8)
    "vn_single": (tbs.banded_spmm, "single", False),
    "vn_single_int8": (tbs.banded_spmm, "single", True),
    "vn_pair_resident": (tbs.banded_cheb_pair, "pair", False),
    "vn_pair": (tbs.banded_cheb_pair_stream, "pair", False),
    "vn_pair_int8": (tbs.banded_cheb_pair_stream, "pair", True),
    "vn_chain": (tbs.banded_chain_stream, "chain", False),
    "vn_chain_int8": (tbs.banded_chain_stream, "chain", True),
}


@pytest.mark.parametrize("name", sorted(VN_WRAPPERS))
def test_vn_wrappers_take_plain_version_only_on_cpu(name, monkeypatch):
    """The wrappers of the vn kernel (K7, K8, K9), as above: one C call per
    wrapper call (both passes of pair and chain launched inside it), counted
    under the wrapper's own name and dtype."""
    wrapper, mode, int8 = VN_WRAPPERS[name]
    plain_calls = []
    real_ref = tbs.banded_vn_reference
    monkeypatch.setattr(tbs, "banded_vn_reference",
                        lambda *a, **k: plain_calls.append(1) or real_ref(*a, **k))
    fake = _FakeLib()
    monkeypatch.setattr(_build, "library", lambda: fake)
    monkeypatch.setattr(tbs, "cuda_device", lambda t: t.device)
    monkeypatch.setattr(tbs, "stream_of", lambda dev: 0)

    slabs = {d: torch.zeros(2, 128, 256, dtype=torch.int8 if int8 else torch.float32, device=d)
             for d in ("meta", "cpu")}
    index = _empty_slab_index(slabs["meta"], 384)

    def call(dev, with_index=True):
        lo, x = torch.zeros(2, dtype=torch.int32, device=dev), torch.zeros(384, 5, device=dev)
        kw = {"scales_t" if mode == "chain" else "scales": torch.ones(2, 128, device=dev)} \
            if int8 else {}
        if with_index and dev == "meta":
            kw["index_t" if mode == "chain" else "index"] = index
        if mode == "chain":
            return wrapper(slabs[dev], lo, x, x, **kw)
        return wrapper(slabs[dev], lo, x, **kw)

    before = kernels.launch_counts()[name]
    out = call("meta")
    assert plain_calls == [] and kernels.launch_counts()[name] == before + 1
    assert fake.calls == [("stgcn_banded_vn", len(_build.SIGNATURES["stgcn_banded_vn"]))]
    assert all(o.shape == (384, 5) for o in ([out] if mode == "single" else out))
    call("cpu")
    assert plain_calls == [1] and kernels.launch_counts()[name] == before + 1
    assert len(fake.calls) == 1
    with pytest.raises(ValueError, match="no nonzero index"):   # the card needs the index
        call("meta", with_index=False)
    with pytest.raises(ValueError, match="CUDA or CPU"):   # without the test double
        monkeypatch.undo()
        call("meta")


def _empty_slab_index(slabs, rows):
    """The nonzero index of all-zero slabs (K5 and the vn kernel walk it)
    for an operand of ``rows`` rows: every row empty."""
    empty = torch.zeros(0, dtype=torch.int32, device=slabs.device)
    return nnz_index.NnzIndex().bind(
        slabs, torch.zeros(rows + 1, dtype=torch.int32, device=slabs.device), empty, empty)


def _empty_index(data):
    """The nonzero index of all-zero tiles (K6 and K10 walk it): every row
    empty."""
    nbr, _, bs, _ = data.shape
    empty = torch.zeros(0, dtype=torch.int32, device=data.device)
    return nnz_index.NnzIndex().bind(
        data, torch.zeros(nbr * bs + 1, dtype=torch.int32, device=data.device), empty, empty)


@pytest.mark.parametrize("mode", ["single", "pair", "chain"])
@pytest.mark.parametrize("quantize", [False, True])
def test_ell_wrapper_takes_plain_version_only_on_cpu(quantize, mode, monkeypatch):
    """K6's wrapper, as above: one C call per wrapper call (both passes of
    pair and chain are launched inside it), counted under its dtype and
    mode."""
    plain_calls = []
    real_ref = tek.ell_nv_reference
    monkeypatch.setattr(tek, "ell_nv_reference",
                        lambda *a, **k: plain_calls.append(1) or real_ref(*a, **k))
    fake = _FakeLib()
    monkeypatch.setattr(_build, "library", lambda: fake)
    monkeypatch.setattr(tek, "cuda_device", lambda t: t.device)
    monkeypatch.setattr(tek, "stream_of", lambda dev: 0)

    def args(dev):
        data = torch.zeros(2, 3, 128, 128, dtype=torch.int8 if quantize else torch.float32,
                           device=dev)
        pack = tek.EllPack(data, torch.zeros(2, 3, dtype=torch.int32, device=dev),
                           torch.zeros(2, dtype=torch.int32, device=dev),
                           torch.ones(2, 128, device=dev) if quantize else None,
                           _empty_index(data))
        g = torch.zeros(5, 256, device=dev) if mode == "chain" else None
        return pack, torch.zeros(5, 256, device=dev), g

    name = tek.launch_name(quantize, mode)
    before = kernels.launch_counts()[name]
    out = tek.ell_nv(*args("meta"), mode)
    assert plain_calls == [] and kernels.launch_counts()[name] == before + 1
    assert fake.calls == [("stgcn_ell_nv", len(_build.SIGNATURES["stgcn_ell_nv"]))]
    assert all(o.shape == (5, 256) for o in ([out] if mode == "single" else out))
    tek.ell_nv(*args("cpu"), mode)
    assert plain_calls == [1] and kernels.launch_counts()[name] == before + 1
    assert len(fake.calls) == 1
    with pytest.raises(ValueError, match="CUDA or CPU"):   # without the test double
        monkeypatch.undo()
        tek.ell_nv(*args("meta"), mode)


@pytest.mark.parametrize("name", ["bcsr_spmm", "bcsr_sddmm"])
def test_bcsr_wrappers_take_plain_version_only_on_cpu(name, monkeypatch):
    """K10's and K11's wrappers, as above: one C call per wrapper call,
    counted under the wrapper's name."""
    mod, ref_name, c_name = {"bcsr_spmm": (tsp, "bcsr_spmm_reference", "stgcn_bcsr_spmm"),
                             "bcsr_sddmm": (tsd, "bcsr_sddmm_reference",
                                            "stgcn_bcsr_sddmm")}[name]
    plain_calls = []
    real_ref = getattr(mod, ref_name)
    monkeypatch.setattr(mod, ref_name, lambda *a, **k: plain_calls.append(1) or real_ref(*a, **k))
    fake = _FakeLib()
    monkeypatch.setattr(_build, "library", lambda: fake)
    monkeypatch.setattr(mod, "cuda_device", lambda t: t.device)
    monkeypatch.setattr(mod, "stream_of", lambda dev: 0)

    def call(dev):
        data = torch.zeros(2, 3, 128, 128, device=dev)
        pack = tsp.BcsrPack(data, torch.zeros(2, 3, dtype=torch.int32, device=dev),
                            torch.zeros(2, dtype=torch.int32, device=dev), _empty_index(data))
        x = torch.zeros(256, 5, device=dev)
        if name == "bcsr_spmm":
            return tsp.bcsr_spmm(pack, x, scale=2.0), (256, 5)
        return tsd.bcsr_sddmm(pack.cols, pack.counts, x, x, block_size=128), (2, 3, 128, 128)

    before = kernels.launch_counts()[name]
    out, shape = call("meta")
    assert plain_calls == [] and kernels.launch_counts()[name] == before + 1
    assert fake.calls == [(c_name, len(_build.SIGNATURES[c_name]))] and out.shape == shape
    out, _ = call("cpu")
    assert plain_calls == [1] and kernels.launch_counts()[name] == before + 1
    assert len(fake.calls) == 1 and out.shape == shape
    with pytest.raises(ValueError, match="CUDA or CPU"):   # without the test double
        monkeypatch.undo()
        call("meta")


@pytest.mark.parametrize("name,ref_name", [("stblock_fwd", "st_block_reference"),
                                           ("stblock_bwd", "st_block_bwd_reference")])
def test_stblock_wrappers_take_plain_version_only_on_cpu(name, ref_name, monkeypatch):
    """K12f / K12b: a non-CPU tensor sizes the workspace, makes one C call and
    counts it, never the plain version; a CPU tensor runs the plain version
    and launches nothing."""
    cfg = tfs.FusedBlockConfig(kt=3, ks=3, act_func="glu", graph_conv_type="cheb_graph_conv",
                               droprate=0.5, v_true=20, t_in=12, c_in=1, c0=16, c1=8, c2=16,
                               training=False)
    plain_calls = []
    real_ref = getattr(tfs, ref_name)
    monkeypatch.setattr(tfs, ref_name,
                        lambda *a, **k: plain_calls.append(1) or real_ref(*a, **k))
    fake = _FakeLib()
    monkeypatch.setattr(_build, "library", lambda: fake)
    monkeypatch.setattr(tfs, "cuda_device", lambda t: t.device)
    monkeypatch.setattr(tfs, "stream_of", lambda dev: 0)
    shapes = [(2, 12, 20, 1), (20, 20), *cfg.weight_shapes()]
    if name == "stblock_bwd":
        shapes.append((2, cfg.t2, 20, 16))

    def call(dev):
        return getattr(tfs, name)(cfg, *[torch.zeros(sh, device=dev) for sh in shapes])

    before = kernels.launch_counts()[name]
    call("meta")
    c_name = "stgcn_" + name
    assert plain_calls == [] and kernels.launch_counts()[name] == before + 1
    assert fake.calls == [(c_name + "_work", len(_build.WORK_SIGNATURES[c_name + "_work"])),
                          (c_name, len(_build.SIGNATURES[c_name]))]
    call("cpu")
    assert plain_calls == [1] and kernels.launch_counts()[name] == before + 1
    assert len(fake.calls) == 2


def test_wrapper_refuses_a_non_cuda_accelerator_tensor():
    """Without the test double, a tensor that is neither CPU nor CUDA raises
    instead of running the plain version."""
    _, _, _, wrapper, cfg, makers = _wrapper_cases()["ofc_fwd"]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        wrapper(cfg, *[m("meta") for m in makers])
    assert not _launch.on_cpu(torch.zeros(1, device="meta"))


def test_build_needs_nvcc_and_raises_without_it(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "isfile",
                        lambda p: False if str(p).endswith("nvcc") else True)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "_build" / _build.LIB_NAME).exists()


def test_every_source_is_built_and_hashed():
    srcs = {p.name for p in _build.sources()}
    assert srcs == {"gate_gemm.cu", "gate_gemm_bf16.cu", "vertex_fused.cu", "output_head.cu",
                    "bwd_blocks.cu", "bwd_blocks_bf16.cu",
                    "vertex_fused_bwd.cu", "output_head_bwd.cu", "banded_nv.cu", "banded_vn.cu",
                    "ell_nv.cu", "bcsr_spmm.cu", "bcsr_sddmm.cu", "fused_stblock.cu",
                    "fused_stblock_bwd.cu"}
    h = _build.source_hash()
    assert len(h) == 64 and h == _build.source_hash()


def test_every_header_is_hashed_and_the_tile_header_is_shared(monkeypatch, tmp_path):
    """The headers enter the source hash (editing the register tile
    f32_tile.cuh rebuilds the library); the tile serves K11, the gate GEMM of
    K1f-K4f (gate_gemm.cu), K12's graph product (fused_stblock.cu) and, in
    bwd_blocks.cu and bwd_blocks_bf16.cu, every weight gradient and the
    fused gate and data-gradient passes of K1b-K4b and K12b, and the retired
    nv_tile.cuh is gone. The kernel templates are the tile's users for their
    float32 and bf16 instantiations: the gate GEMM's (gate_gemm.cuh:
    gate_gemm.cu, gate_gemm_bf16.cu) and the backward passes'
    (bwd_blocks_impl.cuh: bwd_blocks.cu, bwd_blocks_bf16.cu)."""
    headers = {p.name for p in _build.SRC_DIR.glob("*.cuh")}
    assert headers == {"bwd_blocks.cuh", "bwd_blocks_impl.cuh", "common.cuh", "csr_rows.cuh",
                       "dropout.cuh", "f32_tile.cuh", "fused_stblock.cuh", "gate_gemm.cuh",
                       "nv_rows.cuh"}
    users = {p.name for p in [*_build.sources(), *_build.SRC_DIR.glob("*.cuh")]
             if '#include "f32_tile.cuh"' in p.read_text()}
    assert users == {"bcsr_sddmm.cu", "bwd_blocks_impl.cuh", "gate_gemm.cuh", "fused_stblock.cu"}
    assert {p.name for p in _build.sources() if '#include "gate_gemm.cuh"' in p.read_text()} \
        == {"gate_gemm.cu", "gate_gemm_bf16.cu"}
    assert {p.name for p in _build.sources() if '#include "bwd_blocks_impl.cuh"' in p.read_text()} \
        == {"bwd_blocks.cu", "bwd_blocks_bf16.cu"}
    src = tmp_path / "csrc"
    shutil.copytree(_build.SRC_DIR, src)
    monkeypatch.setattr(_build, "SRC_DIR", src)
    before = _build.source_hash()
    (src / "f32_tile.cuh").write_text((src / "f32_tile.cuh").read_text() + "\n")
    assert _build.source_hash() != before
