"""Time the 1M-vertex sparse kernels K6 (blocked-ELL nv, every mode, int8
and f32) and K10 (BCSR vn) of one or more checkouts on one CUDA card.

    python3 stgcn_tpu_torch/kernels/sparse_ab.py --tree PARENT --tree . --tree . --tree PARENT

The 1M road graph (``random_road_graph(1_000_000, k_neighbors=8,
seed=0)``, ``sym_norm_lap`` Chebyshev GSO, RCM: ``chip_smoke.py``'s) is
built once, by the checkout that holds this file, and saved to a temporary
file. Each ``--tree`` is the root of a checkout of this repository, run in
a process of its own (the harness, ``_ab.py``) that builds that checkout's
kernels, packs the saved GSO with its ``make_graph_op`` (int8 ELL, f32 ELL,
BCSR) and times its wrappers. Per tree it prints one JSON line: per
kernel, mode and width N (160 and 96, ``B·T·c1`` of the two ST blocks at
batch 1) the median CUDA-event milliseconds of ``--reps`` calls (after 2
of warm-up) on random operands from a fixed seed, and a SHA-256 of the
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


def build_gso(tmp: str) -> str:
    """The RCM-ordered 1M GSO of ``chip_smoke.py``, saved under ``tmp``."""
    import scipy.sparse as sp

    sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..")))
    from stgcn_tpu_torch.data.synthetic import random_road_graph
    from stgcn_tpu_torch.graph import build_gso as gso_of
    from stgcn_tpu_torch.graph import permute_matrix, rcm_ordering

    art = gso_of(random_road_graph(1_000_000, k_neighbors=8, seed=0), "sym_norm_lap", cheb=True)
    path = os.path.join(tmp, "gso_1m.npz")
    sp.save_npz(path, sp.csr_matrix(permute_matrix(art.matrix, rcm_ordering(art.matrix))))
    return path


def run_one(tree: str, reps: int, gso_path: str) -> dict:
    """Pack the saved GSO and time K6 and K10 with the checkout at ``tree``."""
    import scipy.sparse as sp
    import torch

    import stgcn_tpu_torch
    from stgcn_tpu_torch.graph.gso import GraphShiftOperator
    from stgcn_tpu_torch.kernels import ell_nv as ek
    from stgcn_tpu_torch.kernels import spmm
    from stgcn_tpu_torch.ops import make_graph_op

    torch.backends.cuda.matmul.allow_tf32 = False
    m = sp.load_npz(gso_path)
    art = GraphShiftOperator(matrix=m, gso_type="sym_norm_lap", cheb_rescaled=True,
                             lam_max=None)
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
                    warmup=2)
            del x, g
        del pack
        torch.cuda.empty_cache()
    pack = make_graph_op(art, "bcsr", device="cuda").pack
    for n in WIDTHS:
        x = torch.randn((pack.cols.shape[0] * pack.block_size, n), generator=gen, device="cuda")
        key = f"bcsr_spmm/N={n}"
        result["ms"][key], result["sha256"][key] = _ab.timed(
            torch, lambda: spmm.bcsr_spmm(pack, x), reps, warmup=2)
    return result


if __name__ == "__main__":
    sys.exit(_ab.main(__file__, __doc__.splitlines()[0], run_one, reps=10, prepare=build_gso))
