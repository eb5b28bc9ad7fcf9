"""Time the backward kernels K1b-K4b of one or more checkouts, at the
training path's PeMSD7(M), 100k- and 1M-vertex shapes, and K12b at
PeMSD7(M) and PEMS-BAY batch 512, on one CUDA card.

    python3 stgcn_tpu_torch/kernels/bwd_ab.py --tree PARENT --tree . --tree . --tree PARENT

Each ``--tree`` is the root of a checkout of this repository, run in a
process of its own that builds its kernels (the harness, ``_ab.py``). Per
tree it prints one JSON line: per kernel and shape the median CUDA-event
milliseconds of ``--reps`` launches (after 3 of warm-up) on random inputs
drawn from a fixed seed, and a SHA-256 of the outputs' bytes; under
``trace`` the device launches of one call of every kernel at every shape,
in launch order, as ``torch.profiler`` sees them, and under ``retired`` the
launches of each K4b and K12b call that are kernels the redesigns retired
(``_ab.py``'s ``retired_launches``, over the whole call, K12b's forward
recompute included); under ``yardstick`` the
CUDA-event ms of one ``torch.matmul`` each, operands laid out for it before
the timing: K1b block 2's ``dc1k`` product at the 100k shape
(``[kt·c_in, B·t1·Vp] × [B·t1·Vp, g1]``), K3b's recompute (``[B·Vp, ko·c_in]
× [ko·c_in, g]``) and K4b's fc1 recompute (``[B·Vp, 128] × [128, 128]``) at
100k, and one of K12b's adjoint graph products at PEMS-BAY batch 512, block
1 (``[B·t1·c1, Vp] × [Vp, Vp]``). Then the ``nvidia-smi`` name and power
limit of the card.

Beside each K1b-K4b case runs its bf16 variant (``<name>_bf16``: the same
inputs rounded to bf16, the statistics, biases, LayerNorm-partial
cotangents and K4b's output cotangent float32, ``precision="bfloat16"``),
with a bf16 ``torch.matmul`` yardstick beside each K1b-K4b one
(``<product>_bf16``, under PyTorch's default
``allow_bf16_reduced_precision_reduction``). A tree whose backward kernels
have no bf16 variant (it raises ``NotImplementedError``) times none and
lists those cases under ``no_bf16``.
"""

from __future__ import annotations

import dataclasses
import os
import sys

if __package__:
    from stgcn_tpu_torch.kernels import _ab
else:   # run as a script: its directory is sys.path[0]
    import _ab

# (B, V, Vp): the batches of the main.py default, bench.py:253 and bench.py:338
SHAPES = {"pemsd7m": (32, 228, 256), "100k": (8, 100_000, 101_376),
          "1m": (1, 1_000_000, 1_000_192)}
# (B, V) of the dense whole-block route: PeMSD7(M) and PEMS-BAY (BASELINE.json configs[2])
K12_SHAPES = {"pemsd7m": (32, 228), "pemsbay": (512, 325)}


def cases(torch, b: int, v_true: int, vp: int):
    """(name, wrapper, args, kwargs) of K1b (``head_bwd``: block 2's head,
    t_in 8; ``head_bwd_blk1``: block 1's, t_in 12, c_in 1, no LayerNorm), K2b
    (``tail_bwd``: block 1's tail, t_in 12; ``tail_bwd_blk2``: block 2's,
    t_in 8), K3b and K4b at the main.py widths, dropout 0.5 on (K2b and block
    1's head have no dropout site)."""
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
    head1 = dataclasses.replace(head, t_in=12, c_in=1, apply_ln=False)
    tail2 = dataclasses.replace(tail, t_in=8, c_in=64, apply_ln=True)
    out = oh.OutHeadCfg(ko=4, c_in=64, c0=128, c1=128, c_end=1, act_func="glu",
                        v_true=v_true, v_pad=vp)

    def tail_args(cfg):
        t1, t2 = cfg.t1, cfg.t2
        return (cfg, *(rnd(b, t1, 16, vp) for _ in range(3)), rnd(3, 16, 16, scale=48 ** -0.5),
                rnd(16, scale=0.1), rnd(3, 16, 128, scale=48 ** -0.5), rnd(128, scale=0.1),
                rnd(b, t2, 64, vp, scale=1e-3), rnd(b, t2, 1, 1, scale=1e-3),
                rnd(b, t2, 1, 1, scale=1e-3))

    return [
        ("head_bwd", vf.head_bwd,
         (head, rnd(b, 8, 64, vp), *ln(8, 64), rnd(3, 64, 128, scale=192 ** -0.5),
          rnd(128, scale=0.1), rnd(64, 16, scale=0.125), rnd(16, scale=0.1),
          rnd(b, 6, 16, vp, scale=1e-3)), {"drop": Drop(0.5, 11, 1)}),
        ("head_bwd_blk1", vf.head_bwd,
         (head1, rnd(b, 12, 1, vp), None, None, None, None, rnd(3, 1, 128, scale=3 ** -0.5),
          rnd(128, scale=0.1), rnd(64, 16, scale=0.125), rnd(16, scale=0.1),
          rnd(b, 10, 16, vp, scale=1e-3)), {}),
        ("tail_bwd", vf.tail_bwd, tail_args(tail), {}),
        ("ohead_bwd", oh.ohead_bwd,
         (out, rnd(b, 4, 64, vp), *ln(4, 64), rnd(4, 64, 256, scale=256 ** -0.5),
          rnd(256, scale=0.1), rnd(b, 1, 128, vp, scale=1e-3), rnd(b, 1, 1, 1, scale=1e-3),
          rnd(b, 1, 1, 1, scale=1e-3)), {"drop": Drop(0.5, 11, 2)}),
        ("ofc_bwd", oh.ofc_bwd,
         (out, rnd(b, 1, 128, vp), *ln(1, 128), rnd(128, 128, scale=128 ** -0.5),
          rnd(128, scale=0.1), rnd(128, 1, scale=128 ** -0.5), rnd(1, scale=0.1),
          rnd(b, 1, 1, vp, scale=1e-3)), {"drop": Drop(0.5, 11, 3)}),
        ("tail_bwd_blk2", vf.tail_bwd, tail_args(tail2), {}),
    ]


# the arguments (1-based, the config first) of each K1b-K4b wrapper that stay
# float32 in its bf16 variant: the statistics, the biases, the LayerNorm-
# partial cotangents and K4b's output cotangent
F32_ARGS = {"head_bwd": {2, 3, 7, 9}, "tail_bwd": {5, 7, 9, 10}, "ohead_bwd": {2, 3, 7, 9, 10},
            "ofc_bwd": {2, 3, 7, 9, 10}}


def bf16_cases(torch, made):
    """The bf16 variant of each K1b-K4b case of ``made``: its inputs rounded
    to bf16 (what stays float32 in ``F32_ARGS``), ``precision="bfloat16"``.
    Built after the float32 cases, so their random inputs are the parent's."""
    out = []
    for name, wrapper, args, kwargs in made:
        keep = F32_ARGS[wrapper.__name__]
        cfg = dataclasses.replace(args[0], precision="bfloat16")
        conv = [t if i in keep or t is None else t.to(torch.bfloat16)
                for i, t in enumerate(args) if i > 0]
        out.append((f"{name}_bf16", wrapper, (cfg, *conv), kwargs))
    return out


def k12_cases(torch, b: int, v: int):
    """(name, wrapper, args, kwargs) of K12b at blocks 1 and 2 of the main.py
    widths (t_in 12, c_in 1; t_in 8, c_in 64), a random dense GSO, dropout on."""
    from stgcn_tpu_torch.kernels import fused_stblock as fs
    from stgcn_tpu_torch.kernels.dropout import Drop

    gen = torch.Generator(device="cuda").manual_seed(1)
    gso = torch.randn((v, v), generator=gen, device="cuda") * v ** -0.5
    out = []
    for blk, (t_in, c_in) in enumerate(((12, 1), (8, 64))):
        cfg = fs.FusedBlockConfig(kt=3, ks=3, act_func="glu", graph_conv_type="cheb_graph_conv",
                                  droprate=0.5, v_true=v, t_in=t_in, c_in=c_in, c0=64, c1=16,
                                  c2=64, training=True)
        w = [torch.randn(s, generator=gen, device="cuda") * 0.1 for s in cfg.weight_shapes()]
        w[8] = w[8] + 1.0
        x = torch.randn((b, t_in, v, c_in), generator=gen, device="cuda")
        gy = torch.randn((b, cfg.t2, v, cfg.c2), generator=gen, device="cuda") * 1e-3
        out.append((f"stblock_bwd_blk{blk + 1}", fs.stblock_bwd, (cfg, x, gso, *w, gy),
                    {"drop": Drop(0.5, 11, blk)}))
    return out


def yardstick(torch, reps: int) -> dict:
    """One ``torch.matmul`` of K1b block 2's ``dc1k`` product at the 100k
    shape, ``[kt·c_in, n] × [n, g1]`` with n = B·t1·Vp; one of K3b's
    recompute, ``[B·Vp, ko·c_in] × [ko·c_in, g]``, and of K4b's fc1
    recompute, ``[B·Vp, c0] × [c0, c1]``, at 100k; and one of K12b's adjoint
    graph products at PEMS-BAY batch 512, block 1 (t1 10, c1 16, Vp 384),
    ``[B·t1·c1, Vp] × [Vp, Vp]``: padded, while its ``flops`` count the true
    V over which ``graph_mm`` contracts, 2·B·t1·c1·V²."""
    b, _, vp = SHAPES["100k"]
    b12, v12 = K12_SHAPES["pemsbay"]
    vp12 = -(-v12 // 128) * 128
    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    for key, (m, k, n) in {"k1b_dc1k": (3 * 64, b * 6 * vp, 128),
                           "k3b_recompute": (b * vp, 4 * 64, 256),
                           "k4b_recompute": (b * vp, 128, 128),
                           "k12b_adjoint_blk1": (b12 * 10 * 16, vp12, vp12)}.items():
        a = torch.randn((m, k), generator=gen, device="cuda")
        d = torch.randn((k, n), generator=gen, device="cuda") * 1e-3
        ms, _ = _ab.timed(torch, lambda: torch.matmul(a, d), reps, warmup=3)
        out[key] = {"shape": [m, k, n], "ms": ms, "flops": 2 * m * k * n}
        if not key.startswith("k12b"):   # the bf16 variants' products
            a16, d16 = a.bfloat16(), d.bfloat16()
            ms, _ = _ab.timed(torch, lambda: torch.matmul(a16, d16), reps, warmup=3)
            out[f"{key}_bf16"] = {"shape": [m, k, n], "ms": ms, "flops": 2 * m * k * n}
            del a16, d16
        del a, d
    out["k12b_adjoint_blk1"]["flops"] = 2 * b12 * 10 * 16 * v12 * v12
    return out


def run_one(tree: str, reps: int, data) -> dict:
    """Time every case with the checkout at ``tree`` imported."""
    import torch

    import stgcn_tpu_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    result = {"tree": tree, "package": os.path.dirname(stgcn_tpu_torch.__file__), "ms": {},
              "sha256": {}, "trace": {}, "retired": {}, "no_bf16": []}

    def made_cases(b, v_true, vp):
        made = cases(torch, b, v_true, vp)
        return made + bf16_cases(torch, made)

    every = [(shape, made_cases(b, v_true, vp)) for shape, (b, v_true, vp) in SHAPES.items()]
    every += [(shape, k12_cases(torch, b, v)) for shape, (b, v) in K12_SHAPES.items()]
    for shape, made in every:
        for name, wrapper, args, kwargs in made:
            key = f"{name}/{shape}"
            try:
                result["ms"][key], result["sha256"][key] = _ab.timed(
                    torch, lambda: wrapper(*args, **kwargs), reps, warmup=3, key=key)
            except NotImplementedError:   # a tree without the bf16 variants
                result["no_bf16"].append(key)
                continue
            ev = result["trace"][key] = _ab.launches(torch, lambda: wrapper(*args, **kwargs))
            if name.startswith(("ofc_bwd", "stblock_bwd")):
                try:
                    result["retired"][key] = _ab.retired_launches(name.split("_blk")[0], ev)
                except AssertionError as e:
                    result["retired"][key] = str(e)
        del made
        torch.cuda.empty_cache()
    result["yardstick"] = yardstick(torch, reps)
    return result


if __name__ == "__main__":
    sys.exit(_ab.main(__file__, __doc__.splitlines()[0], run_one, reps=20))
