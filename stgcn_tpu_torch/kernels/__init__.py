"""Hand-written Hopper kernels of the port, with their plain versions.

K1 :func:`vertex_fused.head_fwd`, K2 :func:`vertex_fused.tail_fwd`,
K3 :func:`output_head.ohead_fwd`, K4 :func:`output_head.ofc_fwd` (each
also counted as ``<name>_bf16`` for its bf16 variant), their
backward kernels K1b-K4b (``head_bwd``, ``tail_bwd``, ``ohead_bwd``,
``ofc_bwd``; ``<name>_bf16`` for their bf16 variants), the banded nv SpMM K5 :func:`banded_nv.stream_nv`, counted
per mode and dtype (``nv_single``, ``nv_pair_int8``, …), the banded vn SpMM
of K7-K9 (:mod:`banded_spmm`), counted per wrapper and dtype (``vn_single``
for K7, ``vn_pair_resident`` for K8, ``vn_pair`` and ``vn_chain`` for K9;
``_int8`` on int8 packs, ``_bf16`` on a bf16 operand), the blocked-ELL nv SpMM K6 :func:`ell_nv.ell_nv`, counted per dtype and mode (``ell_f32_pair``,
``ell_int8_chain``, …), and the BCSR vn SpMM K10 :func:`spmm.bcsr_spmm`
(``bcsr_spmm``, ``bcsr_spmm_bf16`` on a bf16 operand) — K5, K6, K7-K9 and K10 walk the pack's nonzero index
(:mod:`nnz_index`, its builds counted by :func:`nnz_index.builds`) — with its
tile-value gradient, the SDDMM K11
:func:`sddmm.bcsr_sddmm` (``bcsr_sddmm``), and the whole dense ST block
K12f :func:`fused_stblock.stblock_fwd` (``stblock_fwd``) with its backward
K12b :func:`fused_stblock.stblock_bwd` (``stblock_bwd``). The CUDA sources under
``csrc/`` are built by :mod:`._build` at first use.
"""

import functools

from stgcn_tpu_torch.kernels._launch import LAUNCHES
from stgcn_tpu_torch.kernels import banded_nv as _nv
from stgcn_tpu_torch.kernels import banded_spmm as _vn
from stgcn_tpu_torch.kernels import ell_nv as _ell   # the module: its wrapper shares its name
from stgcn_tpu_torch.kernels.fused_stblock import stblock_bwd, stblock_fwd
from stgcn_tpu_torch.kernels.output_head import ofc_bwd, ofc_fwd, ohead_bwd, ohead_fwd
from stgcn_tpu_torch.kernels.sddmm import bcsr_sddmm
from stgcn_tpu_torch.kernels.spmm import bcsr_spmm
from stgcn_tpu_torch.kernels.vertex_fused import head_bwd, head_fwd, tail_bwd, tail_fwd

WRAPPERS = {"head_fwd": head_fwd, "tail_fwd": tail_fwd,
            "ohead_fwd": ohead_fwd, "ofc_fwd": ofc_fwd,
            "head_fwd_bf16": head_fwd, "tail_fwd_bf16": tail_fwd,
            "ohead_fwd_bf16": ohead_fwd, "ofc_fwd_bf16": ofc_fwd,
            "head_bwd": head_bwd, "tail_bwd": tail_bwd,
            "ohead_bwd": ohead_bwd, "ofc_bwd": ofc_bwd,
            "head_bwd_bf16": head_bwd, "tail_bwd_bf16": tail_bwd,
            "ohead_bwd_bf16": ohead_bwd, "ofc_bwd_bf16": ofc_bwd,
            **{_nv.launch_name(m, q): functools.partial(_nv.stream_nv, mode=m)
               for q in (False, True) for m in ("single", "pair", "chain")},
            **{_vn.launch_name("single", q, bf16=h): _vn.banded_spmm
               for q in (False, True) for h in (False, True)},
            **{_vn.launch_name("pair", resident=True, bf16=h): _vn.banded_cheb_pair
               for h in (False, True)},
            **{_vn.launch_name("pair", q, bf16=h): _vn.banded_cheb_pair_stream
               for q in (False, True) for h in (False, True)},
            **{_vn.launch_name("chain", q, bf16=h): _vn.banded_chain_stream
               for q in (False, True) for h in (False, True)},
            **{_ell.launch_name(q, m): functools.partial(_ell.ell_nv, mode=m)
               for q in (False, True) for m in ("single", "pair", "chain")},
            "bcsr_spmm": bcsr_spmm, "bcsr_spmm_bf16": bcsr_spmm, "bcsr_sddmm": bcsr_sddmm,
            "stblock_fwd": stblock_fwd, "stblock_bwd": stblock_bwd}


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def launch_counts() -> dict[str, int]:
    return {name: LAUNCHES.get(name, 0) for name in WRAPPERS}
