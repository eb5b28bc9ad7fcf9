"""Command-line interface of the port (port of ``stgcn_tpu/cli/main.py``,
one device): the same flags as the JAX package's CLI, which keeps the
reference's (`main.py:39-94`).

    python -m stgcn_tpu_torch.cli --dataset pemsd7-m --graph_op banded --fused True
    python -m stgcn_tpu_torch.cli --dataset pemsd7-m --graph_op banded_int8
    python -m stgcn_tpu_torch.cli --dataset pemsd7-m --graph_op ell_int8 --fused True
    python -m stgcn_tpu_torch.cli --dataset pemsd7-m --graph_op bcsr --fused True
    python -m stgcn_tpu_torch.cli --dataset pemsd7-m --graph_op banded \
        --compute_dtype bfloat16 --remat True

Pipeline: adjacency → GSO → (RCM order for the sparse kinds) → graph
operator on the device; CSV (or a synthetic series) → chronological split
→ z-score (train-fit) → device series; model, optimizer, early stopping;
train → test from the best checkpoint. It runs on the CUDA card; ``--platform
cpu`` (or the reference's ``--enable_cuda False``) asks for the CPU.

``--compute_dtype bfloat16`` and ``--remat True`` build ``STGCN(dtype=
torch.bfloat16, remat=True)`` over an operator packed without a dtype
(float32 values, a bf16 operand), as the JAX CLI does; they train the
unfused model.

Not ported yet, and refused with ``NotImplementedError``: ``--compute_dtype
bfloat16`` or ``--remat True`` with ``--fused True`` (the fused bf16 slice:
the fused kernels' bf16 variants), a device mesh and ``--distributed`` (the
``dist`` slice), ``--profile_dir`` (``utils/
profiling.py``), and ``--fused_tile_v`` / ``--fused_b_tile`` (the TPU
kernels' tile sizes; the CUDA kernels fix their own). ``--fused True`` with
``--graph_op auto`` where auto picks bcsr raises a ``TypeError``, as the
JAX CLI does (it asks ``bcsr_graph_op`` for nv packs it has no argument
for); ``--graph_op bcsr --fused True`` runs.
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch

from stgcn_tpu_torch.data import datasets as D
from stgcn_tpu_torch.data import synthetic as S
from stgcn_tpu_torch.device import resolve_device
from stgcn_tpu_torch.graph import build_gso
from stgcn_tpu_torch.graph.gso import GraphShiftOperator
from stgcn_tpu_torch.graph.partition import permute_matrix, rcm_ordering
from stgcn_tpu_torch.nn.model import STGCN
from stgcn_tpu_torch.ops.graph_op import auto_kind, make_graph_op
from stgcn_tpu_torch.train.loop import TrainConfig, Trainer

SPARSE_KINDS = ("banded", "banded_int8", "ell", "ell_int8")


def _str2bool(v: str) -> bool:
    # the reference uses `type=bool`, which is True for any non-empty
    # string (`main.py:41,53`); parse properly, keep names and defaults
    return str(v).lower() not in ("false", "0", "no", "")


def get_parameters(argv=None):
    parser = argparse.ArgumentParser(description="STGCN (PyTorch / CUDA port)")
    # --- reference-parity flags (`main.py:40-63`) ---
    parser.add_argument("--enable_cuda", type=_str2bool, default=True,
                        help="run on the CUDA card (False: the CPU)")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--dataset", type=str, default="metr-la",
                        help="metr-la | pems-bay | pemsd7-m or any directory under "
                             "--data_root holding adj.npz (+ vel.csv)")
    parser.add_argument("--n_his", type=int, default=12)
    parser.add_argument("--n_pred", type=int, default=3)
    parser.add_argument("--time_intvl", type=int, default=5)  # unused downstream, as in reference
    parser.add_argument("--Kt", type=int, default=3)
    parser.add_argument("--stblock_num", type=int, default=2)
    parser.add_argument("--act_func", type=str, default="glu",
                        choices=["glu", "gtu", "relu", "silu"])
    parser.add_argument("--Ks", type=int, default=3, choices=[3, 2])
    parser.add_argument("--graph_conv_type", type=str, default="cheb_graph_conv",
                        choices=["cheb_graph_conv", "graph_conv"])
    parser.add_argument("--gso_type", type=str, default="sym_norm_lap",
                        choices=["sym_norm_lap", "rw_norm_lap",
                                 "sym_renorm_adj", "rw_renorm_adj",
                                 "sym_norm_adj", "rw_norm_adj",
                                 "sym_renorm_lap", "rw_renorm_lap"])
    parser.add_argument("--enable_bias", type=_str2bool, default=True)
    parser.add_argument("--droprate", type=float, default=0.5)
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--weight_decay_rate", type=float, default=0.001)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--epochs", type=int, default=1000)
    parser.add_argument("--opt", type=str, default="adamw",
                        choices=["adamw", "nadamw", "lion", "tiger", "tiger_fixed"])
    parser.add_argument("--step_size", type=int, default=10)
    parser.add_argument("--gamma", type=float, default=0.95)
    parser.add_argument("--patience", type=int, default=10)
    # --- extensions of the JAX package's CLI ---
    parser.add_argument("--data_root", type=str, default="data")
    parser.add_argument("--platform", type=str, default=None, choices=["cpu", "cuda"],
                        help="force the device (default: cuda, or cpu with --enable_cuda False)")
    parser.add_argument("--matmul_precision", type=str, default="default",
                        choices=["default", "high", "highest"],
                        help="float32 matmul precision; 'default' is full float32 "
                             "(TF32 off), 'high' allows TF32")
    parser.add_argument("--graph_op", type=str, default="auto",
                        choices=["auto", "dense", "bcsr", "banded",
                                 "banded_int8", "ell", "ell_int8"],
                        help="GSO representation: dense matmul, BCSR tiles through the K10 "
                             "kernel, banded slabs (f32 or int8) through K7-K9 (and K5 under "
                             "--fused), or blocked-ELL tiles (f32 or int8) through K6")
    parser.add_argument("--shuffle", type=_str2bool, default=False,
                        help="shuffle training windows (reference keeps False)")
    parser.add_argument("--ckpt_dir", type=str, default=None)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--synthetic_ok", type=_str2bool, default=True,
                        help="generate a deterministic synthetic vel.csv when missing")
    parser.add_argument("--log_path", type=str, default=None)
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="device trace directory (not ported yet)")
    parser.add_argument("--debug_nans", type=_str2bool, default=False,
                        help="torch.autograd anomaly detection (slow; debugging aid)")
    parser.add_argument("--compute_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="bfloat16 = mixed-precision training (f32 params/LN; under "
                             "--fused on the dense and BCSR operators)")
    parser.add_argument("--fused", type=_str2bool, default=False,
                        help="train through the vertex-fused kernels K1-K4 (the banded "
                             "operator aggregates through K5, the ELL one through K6, the "
                             "BCSR one through K10)")
    parser.add_argument("--remat", type=_str2bool, default=False,
                        help="recompute ST blocks in the backward (unfused; the graph "
                             "terms are kept)")
    parser.add_argument("--fused_tile_v", type=int, default=None,
                        help="vertex tile of the TPU kernels (not ported: the CUDA "
                             "kernels fix their own tiles)")
    parser.add_argument("--fused_b_tile", type=int, default=None,
                        help="batch tile of the TPU kernels (not ported)")
    # --- several devices (the dist slice, not ported yet) ---
    parser.add_argument("--mesh_data", type=int, default=1)
    parser.add_argument("--mesh_graph", type=int, default=1)
    parser.add_argument("--mesh_model", type=int, default=1)
    parser.add_argument("--distributed", action="store_true")
    return parser.parse_args(argv)


def refuse_unported(args) -> None:
    """Raise for the options whose code comes with a later slice of the port."""
    later = {
        "--remat True with --fused True": (
            args.remat and args.fused,
            "the fused bf16 slice (fused_sparse_forward(remat=, remat_policy=))"),
        "a device mesh": (args.mesh_data * args.mesh_graph * args.mesh_model > 1
                          or args.distributed, "the dist slice"),
        "--profile_dir": (args.profile_dir is not None,
                          "the utils slice (utils/profiling.py over torch.profiler)"),
        "--fused_tile_v / --fused_b_tile": (
            args.fused_tile_v is not None or args.fused_b_tile is not None,
            "nothing: they size the TPU kernels' tiles; the CUDA kernels fix their own"),
    }
    for flag, (asked, where) in later.items():
        if asked:
            raise NotImplementedError(f"{flag} is not ported; it comes with {where}")


def set_env(seed: int) -> None:
    """Determinism knobs (`main.py:23-37`): the host RNGs and torch's."""
    os.environ["PYTHONHASHSEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def config_from_args(args) -> TrainConfig:
    return TrainConfig(
        n_his=args.n_his, n_pred=args.n_pred, kt=args.Kt, ks=args.Ks,
        stblock_num=args.stblock_num, act_func=args.act_func,
        graph_conv_type=args.graph_conv_type, enable_bias=args.enable_bias,
        droprate=args.droprate, lr=args.lr, weight_decay=args.weight_decay_rate,
        batch_size=args.batch_size, epochs=args.epochs, opt=args.opt,
        step_size=args.step_size, gamma=args.gamma, patience=args.patience,
        seed=args.seed, shuffle=args.shuffle,
        compute_dtype=None if args.compute_dtype == "float32" else args.compute_dtype,
        fused=args.fused, remat=args.remat,
        ckpt_dir=args.ckpt_dir or f"checkpoints/STGCN_{args.dataset}",
        log_path=args.log_path, dataset_name=args.dataset,
    )


def build_trainer(cfg: TrainConfig, *, dataset: str, data_root: str = "data",
                  gso_type: str = "sym_norm_lap", graph_op_kind: str = "auto",
                  synthetic_ok: bool = True, device: str | torch.device = "cuda") -> Trainer:
    """Data + graph + model assembly (`stgcn_tpu/cli/main.py:151-251`, one
    device). The banded and ELL kinds, and ``auto`` above 4096 vertices,
    reorder the graph by RCM and permute the series' sensor columns the same
    way (all metrics are permutation-invariant); ``bcsr`` asked for by name
    keeps the graph's order, as the JAX CLI does."""
    dev = resolve_device(device)
    adj, _ = D.load_adj(dataset, data_root)
    art = build_gso(adj, gso_type, cheb=(cfg.graph_conv_type == "cheb_graph_conv"))

    perm = None
    if graph_op_kind in SPARSE_KINDS or (graph_op_kind == "auto" and art.n_vertex > 4096):
        perm = rcm_ordering(art.matrix)
        art = GraphShiftOperator(matrix=permute_matrix(art.matrix, perm),
                                 gso_type=art.gso_type, cheb_rescaled=art.cheb_rescaled,
                                 lam_max=art.lam_max)
        if cfg.fused and graph_op_kind == "auto" and auto_kind(art) == "bcsr":
            raise TypeError(
                "--fused True with --graph_op auto picks bcsr for this graph (its RCM band is "
                "too wide for the banded slabs); the JAX CLI cannot build that pairing either "
                "(it asks bcsr_graph_op for nv packs, a TypeError). Ask for --graph_op bcsr or "
                "ell by name")
    # the fused path also packs the banded slabs pre-transposed for K5 (the
    # JAX CLI's nv=True, stgcn_tpu/cli/main.py:207-211)
    kw = {}
    if cfg.fused and (graph_op_kind in ("banded", "banded_int8")
                      or graph_op_kind == "auto" and art.n_vertex > 4096):
        kw["nv"] = True
    gop = make_graph_op(art, graph_op_kind, device=dev, **kw)

    vel_path = os.path.join(data_root, dataset, "vel.csv")
    if not os.path.exists(vel_path):
        if not synthetic_ok:
            raise FileNotFoundError(f"{vel_path} missing; pass synthetic_ok=True to generate a "
                                    "deterministic synthetic series")
        S.ensure_vel(dataset, data_root)
    vel = D.load_vel(dataset, data_root)
    if perm is not None:
        vel = vel[:, perm]

    train, val, test = D.chrono_split(vel)
    scaler = D.ZScoreScaler()
    train = scaler.fit_transform(train)
    val = scaler.transform(val)
    test = scaler.transform(test)

    def mk(arr):
        return D.ForecastDataset.from_numpy(arr, cfg.n_his, cfg.n_pred, device=dev)

    model = STGCN(cfg.n_his, art.n_vertex, kt=cfg.kt, ks=cfg.ks, stblock_num=cfg.stblock_num,
                  act_func=cfg.act_func, graph_conv_type=cfg.graph_conv_type,
                  use_bias=cfg.enable_bias, droprate=cfg.droprate, remat=cfg.remat,
                  dtype=torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None,
                  device=dev, generator=torch.Generator().manual_seed(cfg.seed))
    return Trainer(cfg, model, gop, mk(train), mk(val), mk(test), scaler, device=dev)


def main(argv=None):
    args = get_parameters(argv)
    print(f"Training configs: {args}")
    refuse_unported(args)
    set_env(args.seed)
    device = "cpu" if args.platform == "cpu" or not args.enable_cuda else "cuda"
    torch.set_float32_matmul_precision(
        {"default": "highest", "high": "high", "highest": "highest"}[args.matmul_precision])
    torch.backends.cudnn.allow_tf32 = args.matmul_precision == "high"
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)

    cfg = config_from_args(args)
    trainer = build_trainer(cfg, dataset=args.dataset, data_root=args.data_root,
                            gso_type=args.gso_type, graph_op_kind=args.graph_op,
                            synthetic_ok=args.synthetic_ok, device=device)
    if args.resume and trainer.resume():
        print(f"Resumed from epoch {trainer.epoch}")
    trainer.fit()
    return trainer.test()
