"""Time the sparse graph kernels of one or more checkouts on one CUDA card:
at 1M vertices K6 (blocked-ELL nv, every mode, int8 and f32), K10 (BCSR
vn) and K11 (the BCSR SDDMM); at 100k vertices K5 (banded nv, every mode, f32 and int8) and the vn
kernel of K7 (single), K8 (the pair on the clamped pack) and K9 (the stream
pair and chain), f32 and int8.

    python3 stgcn_tpu_torch/kernels/sparse_ab.py --tree PARENT --tree . --tree . --tree PARENT

The road graphs (``random_road_graph(V, k_neighbors=8, seed=0)`` at V =
1M and 100k, ``sym_norm_lap`` Chebyshev GSO, RCM: ``chip_smoke.py``'s) are
built once, by the checkout that holds this file, and saved to temporary
files. Each ``--tree`` is the root of a checkout of this repository, run in
a process of its own (the harness, ``_ab.py``) that builds that checkout's
kernels, packs the saved GSOs with its ``make_graph_op`` / ``banded_graph_op``
(int8 ELL, f32 ELL, BCSR; banded f32 and int8 with their nv packs, and the
clamped pack of ``stream=False``) and times its wrappers, handing each the
operator's nonzero index where the checkout's operator carries one. Per
tree it prints one JSON line: per kernel, mode and width N (160 and 96 at
1M, 1280 and 768 at 100k: ``B·T·c1`` of the two ST blocks at batch 1 and
8) the median CUDA-event milliseconds of ``--reps`` calls (after 2 of
warm-up) on random operands from a fixed seed, and a SHA-256 of the
outputs' bytes. Then the ``nvidia-smi`` name and power limit of the card.
"""

from __future__ import annotations

import os
import sys

if __package__:
    from stgcn_tpu_torch.kernels import _ab
else:   # run as a script: its directory is sys.path[0]
    import _ab

WIDTHS = (160, 96)
WIDTHS_100K = (1280, 768)
GRAPHS = {"1m": 1_000_000, "100k": 100_000}


def build_gso(tmp: str) -> str:
    """The RCM-ordered GSOs of ``chip_smoke.py``, saved under ``tmp``."""
    import scipy.sparse as sp

    sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..")))
    from stgcn_tpu_torch.data.synthetic import random_road_graph
    from stgcn_tpu_torch.graph import build_gso as gso_of
    from stgcn_tpu_torch.graph import permute_matrix, rcm_ordering

    for tag, v in GRAPHS.items():
        art = gso_of(random_road_graph(v, k_neighbors=8, seed=0), "sym_norm_lap", cheb=True)
        sp.save_npz(os.path.join(tmp, f"gso_{tag}.npz"),
                    sp.csr_matrix(permute_matrix(art.matrix, rcm_ordering(art.matrix))))
    return tmp


def _index(op, field: str, key: str = "index") -> dict:
    """The wrapper keyword for the operator's nonzero index ``field``, or
    none for a checkout whose banded operator carries no index."""
    return {key: getattr(op, field)} if hasattr(op, field) else {}


def run_banded(torch, art, result: dict, reps: int, gen) -> None:
    """K5 and the vn kernel (K7, K8, K9) on the 100k packs."""
    from stgcn_tpu_torch.kernels import banded_nv as nv
    from stgcn_tpu_torch.kernels import banded_spmm as bk
    from stgcn_tpu_torch.ops import banded_graph_op

    def time_it(key, fn):
        result["ms"][key], result["sha256"][key] = _ab.timed(torch, fn, reps, warmup=2, key=key)

    for quantize in (False, True):
        op = banded_graph_op(art, quantize=quantize, nv=True, device="cuda")
        sfx = "_int8" if quantize else ""
        for n in WIDTHS_100K:
            x = torch.randn((n, op.v_pad), generator=gen, device="cuda")
            g = torch.randn((n, op.v_pad), generator=gen, device="cuda")
            for mode in ("single", "pair", "chain"):
                time_it(f"{nv.launch_name(mode, quantize)}/N={n}", lambda: nv.stream_nv(
                    op.slabs_nv, op.lo, x, g if mode == "chain" else None, mode,
                    scales=op.scales, **_index(op, "index_nv")))
            x, g = x.T.contiguous(), g.T.contiguous()   # the vn operands [v_pad, N]
            time_it(f"vn_single{sfx}/N={n}", lambda: bk.banded_spmm(
                op.slabs, op.lo, x, scales=op.scales, **_index(op, "index")))
            time_it(f"vn_pair{sfx}/N={n}", lambda: bk.banded_cheb_pair_stream(
                op.slabs, op.lo, x, scales=op.scales, **_index(op, "index")))
            time_it(f"vn_chain{sfx}/N={n}", lambda: bk.banded_chain_stream(
                op.slabs_t, op.lo_t, x, g, scales_t=op.scales_t,
                **_index(op, "index_t", "index_t")))
            del x, g
        del op
        torch.cuda.empty_cache()
    op = banded_graph_op(art, stream=False, device="cuda")
    for n in WIDTHS_100K:
        x = torch.randn((op.v_pad, n), generator=gen, device="cuda")
        time_it(f"vn_pair_resident/N={n}", lambda: bk.banded_cheb_pair(
            op.slabs, op.lo, x, **_index(op, "index")))
        del x
    del op
    torch.cuda.empty_cache()


def run_one(tree: str, reps: int, gso_dir: str) -> dict:
    """Pack the saved GSOs and time K6, K10, K5 and K7-K9 with the checkout
    at ``tree``."""
    import scipy.sparse as sp
    import torch

    import stgcn_tpu_torch
    from stgcn_tpu_torch.graph.gso import GraphShiftOperator
    from stgcn_tpu_torch.kernels import ell_nv as ek
    from stgcn_tpu_torch.kernels import sddmm, spmm
    from stgcn_tpu_torch.ops import make_graph_op

    def gso(tag):
        return GraphShiftOperator(matrix=sp.load_npz(os.path.join(gso_dir, f"gso_{tag}.npz")),
                                  gso_type="sym_norm_lap", cheb_rescaled=True, lam_max=None)

    torch.backends.cuda.matmul.allow_tf32 = False
    art = gso("1m")
    result = {"tree": tree, "package": os.path.dirname(stgcn_tpu_torch.__file__), "ms": {},
              "sha256": {}}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for kind in ("ell_int8", "ell"):
        pack = make_graph_op(art, kind, device="cuda").pack
        vp = pack.cols.shape[0] * pack.data.shape[-1]
        for n in WIDTHS:
            x = torch.randn((n, vp), generator=gen, device="cuda")
            g = torch.randn((n, vp), generator=gen, device="cuda")
            for mode in ("single", "pair", "chain"):
                key = f"{ek.launch_name(pack.quantized, mode)}/N={n}"
                result["ms"][key], result["sha256"][key] = _ab.timed(
                    torch, lambda: ek.ell_nv(pack, x, g if mode == "chain" else None, mode), reps,
                    warmup=2, key=key)
            del x, g
        del pack
        torch.cuda.empty_cache()
    pack = make_graph_op(art, "bcsr", device="cuda").pack
    for n in WIDTHS:
        x = torch.randn((pack.cols.shape[0] * pack.block_size, n), generator=gen, device="cuda")
        key = f"bcsr_spmm/N={n}"
        result["ms"][key], result["sha256"][key] = _ab.timed(
            torch, lambda: spmm.bcsr_spmm(pack, x), reps, warmup=2, key=key)
        g = torch.randn(x.shape, generator=gen, device="cuda")
        key = f"bcsr_sddmm/N={n}"
        result["ms"][key], result["sha256"][key] = _ab.timed(
            torch, lambda: sddmm.bcsr_sddmm(pack.cols, pack.counts, g, x,
                                            block_size=pack.block_size),
            reps, warmup=2, key=key)
        del g
    del pack, x
    torch.cuda.empty_cache()
    run_banded(torch, gso("100k"), result, reps, gen)
    return result


if __name__ == "__main__":
    sys.exit(_ab.main(__file__, __doc__.splitlines()[0], run_one, reps=10, prepare=build_gso))
