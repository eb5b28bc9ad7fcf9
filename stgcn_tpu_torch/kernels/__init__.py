"""Hand-written Hopper kernels of the port, with their plain versions.

K1 :func:`vertex_fused.head_fwd`, K2 :func:`vertex_fused.tail_fwd`,
K3 :func:`output_head.ohead_fwd`, K4 :func:`output_head.ofc_fwd`. The CUDA
sources under ``csrc/`` are built by :mod:`._build` at first use.
"""

from stgcn_tpu_torch.kernels.output_head import ofc_fwd, ohead_fwd
from stgcn_tpu_torch.kernels.vertex_fused import head_fwd, tail_fwd

WRAPPERS = {"head_fwd": head_fwd, "tail_fwd": tail_fwd,
            "ohead_fwd": ohead_fwd, "ofc_fwd": ofc_fwd}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
