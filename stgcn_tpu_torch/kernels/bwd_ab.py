"""Time the backward kernels K1b-K4b of one or more checkouts, at the
training path's PeMSD7(M), 100k- and 1M-vertex shapes, on one CUDA card.

    python3 stgcn_tpu_torch/kernels/bwd_ab.py --tree PARENT --tree . --tree . --tree PARENT

Each ``--tree`` is the root of a checkout of this repository, run in a
process of its own that builds its kernels (the harness, ``_ab.py``). Per
tree it prints one JSON line: per kernel and shape the median CUDA-event
milliseconds of ``--reps`` launches (after 3 of warm-up) on random inputs
drawn from a fixed seed, and a SHA-256 of the outputs' bytes. Then the
``nvidia-smi`` name and power limit of the card.
"""

from __future__ import annotations

import os
import sys

if __package__:
    from stgcn_tpu_torch.kernels import _ab
else:   # run as a script: its directory is sys.path[0]
    import _ab

# (B, V, Vp): the batches of the main.py default, bench.py:253 and bench.py:338
SHAPES = {"pemsd7m": (32, 228, 256), "100k": (8, 100_000, 101_376),
          "1m": (1, 1_000_000, 1_000_192)}


def cases(torch, b: int, v_true: int, vp: int):
    """(name, wrapper, args, kwargs) of K1b (block 2's head, t_in 8), K2b
    (block 1's tail, t_in 12), K3b and K4b at the main.py widths, dropout 0.5
    on (K2b has no dropout site)."""
    from stgcn_tpu_torch.kernels import output_head as oh
    from stgcn_tpu_torch.kernels import vertex_fused as vf
    from stgcn_tpu_torch.kernels.dropout import Drop

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    def ln(t, c):   # mu, rstd [B, t, 1, 1] and the affine [c, Vp], zero past v_true
        g, bb = 1.0 + rnd(c, vp, scale=0.1), rnd(c, vp, scale=0.1)
        g[:, v_true:] = 0.0
        bb[:, v_true:] = 0.0
        return rnd(b, t, 1, 1, scale=0.1), 0.5 + rnd(b, t, 1, 1).abs(), g, bb

    head = vf.VertexBlockCfg(kt=3, ks=3, act_func="glu", graph_conv_type="cheb_graph_conv",
                             v_true=v_true, v_pad=vp, t_in=8, c_in=64, c0=64, c1=16, c2=64,
                             apply_ln=True)
    tail = vf.VertexBlockCfg(kt=3, ks=3, act_func="glu", graph_conv_type="cheb_graph_conv",
                             v_true=v_true, v_pad=vp, t_in=12, c_in=1, c0=64, c1=16, c2=64,
                             apply_ln=False)
    out = oh.OutHeadCfg(ko=4, c_in=64, c0=128, c1=128, c_end=1, act_func="glu",
                        v_true=v_true, v_pad=vp)
    return [
        ("head_bwd", vf.head_bwd,
         (head, rnd(b, 8, 64, vp), *ln(8, 64), rnd(3, 64, 128, scale=192 ** -0.5),
          rnd(128, scale=0.1), rnd(64, 16, scale=0.125), rnd(16, scale=0.1),
          rnd(b, 6, 16, vp, scale=1e-3)), {"drop": Drop(0.5, 11, 1)}),
        ("tail_bwd", vf.tail_bwd,
         (tail, *(rnd(b, 10, 16, vp) for _ in range(3)), rnd(3, 16, 16, scale=48 ** -0.5),
          rnd(16, scale=0.1), rnd(3, 16, 128, scale=48 ** -0.5), rnd(128, scale=0.1),
          rnd(b, 8, 64, vp, scale=1e-3), rnd(b, 8, 1, 1, scale=1e-3),
          rnd(b, 8, 1, 1, scale=1e-3)), {}),
        ("ohead_bwd", oh.ohead_bwd,
         (out, rnd(b, 4, 64, vp), *ln(4, 64), rnd(4, 64, 256, scale=256 ** -0.5),
          rnd(256, scale=0.1), rnd(b, 1, 128, vp, scale=1e-3), rnd(b, 1, 1, 1, scale=1e-3),
          rnd(b, 1, 1, 1, scale=1e-3)), {"drop": Drop(0.5, 11, 2)}),
        ("ofc_bwd", oh.ofc_bwd,
         (out, rnd(b, 1, 128, vp), *ln(1, 128), rnd(128, 128, scale=128 ** -0.5),
          rnd(128, scale=0.1), rnd(128, 1, scale=128 ** -0.5), rnd(1, scale=0.1),
          rnd(b, 1, 1, vp, scale=1e-3)), {"drop": Drop(0.5, 11, 3)}),
    ]


def run_one(tree: str, reps: int, data) -> dict:
    """Time every case with the checkout at ``tree`` imported."""
    import torch

    import stgcn_tpu_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    result = {"tree": tree, "package": os.path.dirname(stgcn_tpu_torch.__file__), "ms": {},
              "sha256": {}}
    for shape, (b, v_true, vp) in SHAPES.items():
        for name, wrapper, args, kwargs in cases(torch, b, v_true, vp):
            key = f"{name}/{shape}"
            result["ms"][key], result["sha256"][key] = _ab.timed(
                torch, lambda: wrapper(*args, **kwargs), reps, warmup=3)
        torch.cuda.empty_cache()
    return result


if __name__ == "__main__":
    sys.exit(_ab.main(__file__, __doc__.splitlines()[0], run_one, reps=20))
