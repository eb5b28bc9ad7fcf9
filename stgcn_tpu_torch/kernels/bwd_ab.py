"""Time the backward kernels K1b-K4b of one or more checkouts, at the
training path's PeMSD7(M), 100k- and 1M-vertex shapes, on one CUDA card.

    python3 stgcn_tpu_torch/kernels/bwd_ab.py --tree PARENT --tree . --tree . --tree PARENT

Each ``--tree`` is the root of a checkout of this repository. Each is run
in a process of its own, which builds that checkout's kernels and imports
its ``stgcn_tpu_torch``, in the order given (so two commits compare as
A, B, B, A on one card). Per tree it prints one JSON line: per kernel and
shape the median CUDA-event milliseconds of ``--reps`` launches (after 3
of warm-up) on random inputs drawn from a fixed seed, and a SHA-256 of the
outputs' bytes, so trees whose sums run in the same order show the same
digest. Then the ``nvidia-smi`` name and power limit of the card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys

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


def run_one(tree: str, reps: int) -> dict:
    """Time every case with the checkout at ``tree`` imported."""
    sys.path[0] = os.path.abspath(tree)   # this file's directory out, the checkout in
    import torch

    import stgcn_tpu_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    result = {"tree": tree, "package": os.path.dirname(stgcn_tpu_torch.__file__), "ms": {},
              "sha256": {}}
    for shape, (b, v_true, vp) in SHAPES.items():
        for name, wrapper, args, kwargs in cases(torch, b, v_true, vp):
            outs = [o for o in wrapper(*args, **kwargs) if o is not None]
            torch.cuda.synchronize()
            digest = hashlib.sha256()
            for o in outs:
                digest.update(o.detach().cpu().numpy().tobytes())
            del outs
            for _ in range(3):
                wrapper(*args, **kwargs)
            times = []
            for _ in range(reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                wrapper(*args, **kwargs)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            result["ms"][f"{name}/{shape}"] = statistics.median(times)
            result["sha256"][f"{name}/{shape}"] = digest.hexdigest()[:16]
        torch.cuda.empty_cache()
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(run_one(args.tree[0], args.reps)), flush=True)
        return 0
    for tree in args.tree:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", "--tree", tree,
                              "--reps", str(args.reps)],
                             capture_output=True, text=True)
        if out.returncode != 0:
            sys.stderr.write(out.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
