"""Time the forward kernels K1f-K4f of one or more checkouts, at the
training path's PeMSD7(M), 100k- and 1M-vertex shapes, and K12f at
PeMSD7(M) and PEMS-BAY batch 512, on one CUDA card.

    python3 stgcn_tpu_torch/kernels/fwd_ab.py --tree PARENT --tree . --tree . --tree PARENT

Each ``--tree`` is the root of a checkout of this repository, run in a
process of its own that builds its kernels (the harness, ``_ab.py``). Per
tree it prints one JSON line: per kernel and shape the median CUDA-event
milliseconds of ``--reps`` launches (after 3 of warm-up) on random inputs
drawn from a fixed seed, and a SHA-256 of the outputs' bytes; under
``trace`` the device launches of one call of every case, in launch order,
as ``torch.profiler`` sees them; under ``yardstick`` the CUDA-event ms of
one ``torch.matmul`` of each kernel's product alone, operands laid out for
it before the timing: at the 100k shape K1f block 2's conv
(``[B·t1·Vp, kt·c_in] × [kt·c_in, g1]``) and K4f's fc1 (``[B·Vp, c0] ×
[c0, c1]``); at every shape K2f's conv2 at both blocks (``[B·t2·Vp, kt·c1]
× [kt·c1, g2]``) and K3f's conv (``[B·Vp, ko·c_in] × [ko·c_in, g]``); at
PEMS-BAY batch 512 one graph product of K12f's Chebyshev chain at blocks 1
and 2 (``[B·t1·c1, Vp] × [Vp, Vp]``, padded). Under ``retired`` the
launches of each K12f call that are kernels the redesigns retired
(``_ab.py``'s ``retired_launches``: none may remain). Then the
``nvidia-smi`` name and power limit of the card.

Beside each K1f-K4f case runs its bf16 variant (``<name>_bf16``: the same
inputs rounded to bf16, biases and statistics float32, ``precision=
"bfloat16"``), with bf16 ``torch.matmul`` yardsticks of the same products
(``<product>_bf16``, under PyTorch's default
``allow_bf16_reduced_precision_reduction``). A tree whose kernels have no
bf16 variant (it raises ``NotImplementedError``) times none and lists those
cases under ``no_bf16``.
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
    """(name, wrapper, args, kwargs) of K1f (``head_fwd_blk1``: block 1's
    head, t_in 12, c_in 1, no LayerNorm, no dropout; ``head_fwd``: block 2's,
    t_in 8, c_in 64, LayerNorm, input dropout 0.5), K2f (``tail_fwd_blk1``,
    ``tail_fwd_blk2``), K3f (input dropout 0.5) and K4f (128 → 128 → 1,
    LayerNorm, dropout 0.5 after the ReLU) at the main.py widths."""
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

    blk2 = vf.VertexBlockCfg(kt=3, ks=3, act_func="glu", graph_conv_type="cheb_graph_conv",
                             v_true=v_true, v_pad=vp, t_in=8, c_in=64, c0=64, c1=16, c2=64,
                             apply_ln=True)
    blk1 = dataclasses.replace(blk2, t_in=12, c_in=1, apply_ln=False)
    out = oh.OutHeadCfg(ko=4, c_in=64, c0=128, c1=128, c_end=1, act_func="glu",
                        v_true=v_true, v_pad=vp)

    def head_w(cfg):
        return (rnd(3, cfg.c_in, 128, scale=(3 * cfg.c_in) ** -0.5), rnd(128, scale=0.1),
                rnd(64, 16, scale=0.125), rnd(16, scale=0.1))

    def tail_args(cfg):
        return (cfg, *(rnd(b, cfg.t1, 16, vp) for _ in range(3)),
                rnd(3, 16, 16, scale=48 ** -0.5), rnd(16, scale=0.1),
                rnd(3, 16, 128, scale=48 ** -0.5), rnd(128, scale=0.1))

    return [
        ("head_fwd_blk1", vf.head_fwd,
         (blk1, rnd(b, 12, 1, vp), None, None, None, None, *head_w(blk1)), {}),
        ("head_fwd", vf.head_fwd, (blk2, rnd(b, 8, 64, vp), *ln(8, 64), *head_w(blk2)),
         {"drop": Drop(0.5, 11, 1)}),
        ("tail_fwd_blk1", vf.tail_fwd, tail_args(blk1), {}),
        ("tail_fwd_blk2", vf.tail_fwd, tail_args(blk2), {}),
        ("ohead_fwd", oh.ohead_fwd,
         (out, rnd(b, 4, 64, vp), *ln(4, 64), rnd(4, 64, 256, scale=256 ** -0.5),
          rnd(256, scale=0.1)), {"drop": Drop(0.5, 11, 2)}),
        ("ofc_fwd", oh.ofc_fwd,
         (out, rnd(b, 1, 128, vp), *ln(1, 128), rnd(128, 128, scale=128 ** -0.5),
          rnd(128, scale=0.1), rnd(128, 1, scale=128 ** -0.5), rnd(1, scale=0.1)),
         {"drop": Drop(0.5, 11, 3)}),
    ]


# the arguments of each K1f-K4f wrapper that stay float32 in its bf16 variant:
# the LayerNorm statistics and the biases (the config is argument 0)
F32_ARGS = {"head_fwd": {2, 3, 7, 9}, "tail_fwd": {5, 7}, "ohead_fwd": {2, 3, 7},
            "ofc_fwd": {2, 3, 7, 9}}


def bf16_cases(torch, made):
    """The bf16 variant of each K1f-K4f case of ``made``: its inputs rounded
    to bf16 (the statistics and biases float32), ``precision="bfloat16"``.
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
    """(name, wrapper, args, kwargs) of K12f at blocks 1 and 2 of the main.py
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
        out.append((f"stblock_fwd_blk{blk + 1}", fs.stblock_fwd, (cfg, x, gso, *w),
                    {"drop": Drop(0.5, 11, blk)}))
    return out


def yardstick(torch, reps: int) -> dict:
    """One ``torch.matmul`` of a kernel's product alone, ``[m, k] × [k, n]``:
    at the 100k shape K1f block 2's conv (m = B·t1·Vp, k = kt·c_in, n = g1)
    and K4f's fc1 (``[B·Vp, c0] × [c0, c1]``); at each shape K2f's conv2 at
    blocks 1 and 2 (m = B·t2·Vp with t2 8 and 4, k = kt·c1, n = g2) and K3f's
    conv (m = B·Vp, k = ko·c_in, n = g); and one graph product of K12f's
    chain at PEMS-BAY batch 512, blocks 1 and 2 (m = B·t1·c1 with t1 10 and
    6, k = n = Vp 384): padded, while its ``flops`` count the true V over
    which ``graph_mm`` contracts, 2·B·t1·c1·V²."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    b, _, vp = SHAPES["100k"]
    products = {"k1f_conv": (b * 6 * vp, 3 * 64, 128), "k4f_fc1": (b * vp, 128, 128)}
    for shape, (b, _, vp) in SHAPES.items():
        products[f"k2f_conv2_blk1/{shape}"] = (b * 8 * vp, 3 * 16, 128)
        products[f"k2f_conv2_blk2/{shape}"] = (b * 4 * vp, 3 * 16, 128)
        products[f"k3f_conv/{shape}"] = (b * vp, 4 * 64, 256)
    b12, v12 = K12_SHAPES["pemsbay"]
    vp12 = -(-v12 // 128) * 128
    chain = {f"k12f_chain_blk{blk}": b12 * t1 * 16 for blk, t1 in ((1, 10), (2, 6))}
    products.update({key: (m, vp12, vp12) for key, m in chain.items()})
    out = {}
    for key, (m, k, n) in products.items():
        a = torch.randn((m, k), generator=gen, device="cuda")
        d = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
        ms, _ = _ab.timed(torch, lambda: torch.matmul(a, d), reps, warmup=3)
        out[key] = {"shape": [m, k, n], "ms": ms, "flops": 2 * m * k * n}
        if not key.startswith("k12f"):   # the bf16 variants' products
            a16, d16 = a.bfloat16(), d.bfloat16()
            ms, _ = _ab.timed(torch, lambda: torch.matmul(a16, d16), reps, warmup=3)
            out[f"{key}_bf16"] = {"shape": [m, k, n], "ms": ms, "flops": 2 * m * k * n}
            del a16, d16
        del a, d
    for key, m in chain.items():
        out[key]["flops"] = 2 * m * v12 * v12
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
            if name.startswith("stblock_fwd"):
                result["retired"][key] = _ab.retired_launches("stblock_fwd", ev)
        del made
        torch.cuda.empty_cache()
    result["yardstick"] = yardstick(torch, reps)
    return result


if __name__ == "__main__":
    sys.exit(_ab.main(__file__, __doc__.splitlines()[0], run_one, reps=20))
