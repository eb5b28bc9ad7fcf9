"""K11: blocked SDDMM at the live tiles of a BCSR pack (port of
``stgcn_tpu/kernels/sddmm.py``, float32).

``out[i, k] = G_blk[i] · X_blk[cols[i, k]]ᵀ`` contracting all of N, for
``k < counts[i]``, with the padding slots zero (``sddmm.py:104-109``): the
gradient of the BCSR SpMM K10 with respect to its tile values
(:class:`stgcn_tpu_torch.kernels.spmm.BcsrSpmmVjp`). The trainer never
differentiates the GSO, so K11 runs only where a caller asks for that
gradient.

The TPU kernel (``_sddmm_pallas`` :60) carries each tile's sum over N
across a sequential grid axis in VMEM scratch. The CUDA kernel
(``csrc/bcsr_sddmm.cu``, on the register tile of ``csrc/f32_tile.cuh``)
gives one thread block one 128 × 128 sub-tile of one slot (64 × 64 where
the block size is not a multiple of 128), 8 × 8 sums a thread, and sums all
of N inside it in a fixed order, 16 columns a step staged two buffers deep:
no atomics, a repeat launch is bit-identical; any N. A scalar ``scale`` is
the kernel's alpha.
:func:`bcsr_sddmm_reference` is the plain version.
"""

from __future__ import annotations

import torch

from stgcn_tpu_torch.kernels import _build
from stgcn_tpu_torch.kernels._launch import (count_launch, cuda_device, on_cpu, require,
                                             require_index, stream_of)

# elements of the plain version's largest temporary (one chunk of block rows)
REF_CHUNK_ELEMS = 1 << 26
LAUNCH_NAME = "bcsr_sddmm"


def bcsr_sddmm_reference(cols: torch.Tensor, counts: torch.Tensor, g_vn: torch.Tensor,
                         x_vn: torch.Tensor, *, block_size: int, scale: float = 1.0
                         ) -> torch.Tensor:
    """Plain version of :func:`bcsr_sddmm`: the JAX ``bcsr_sddmm_reference``
    (:24-33) with the padding slots zeroed (:125-130), chunked over block
    rows."""
    nbr, max_b = cols.shape
    bs, n = block_size, g_vn.shape[1]
    gb, xb = g_vn.reshape(nbr, bs, n), x_vn.reshape(x_vn.shape[0] // bs, bs, n)   # any N >= 0
    rows = max(1, REF_CHUNK_ELEMS // (max_b * bs * max(n, bs)))
    slots = torch.arange(max_b, device=cols.device)
    outs = []
    for s in range(0, nbr, rows):
        out = torch.einsum("ran,rkbn->rkab", gb[s:s + rows], xb[cols[s:s + rows].long()])
        live = slots[None, :] < counts[s:s + rows, None]
        outs.append(out * live[..., None, None].to(out.dtype))
    out = torch.cat(outs)
    return out if scale == 1.0 else scale * out


def bcsr_sddmm(cols: torch.Tensor, counts: torch.Tensor, g_vn: torch.Tensor,
               x_vn: torch.Tensor, *, block_size: int, scale: float = 1.0) -> torch.Tensor:
    """K11. ``cols`` ``[nbr, max_b]`` and ``counts`` ``[nbr]`` int32 on the
    operands' device; ``g_vn``, ``x_vn`` ``[nbr·bs, N]`` float32, any N.
    Returns ``[nbr, max_b, bs, bs]`` float32, ``scale ·`` the tiles of
    ``g xᵀ`` at the live slots, zero at the padding ones."""
    if on_cpu(g_vn):
        return bcsr_sddmm_reference(cols, counts, g_vn, x_vn, block_size=block_size,
                                    scale=scale)
    dev = cuda_device(g_vn)
    nbr, max_b = cols.shape
    bs = block_size
    if bs % 64 or g_vn.dim() != 2 or g_vn.shape[0] != nbr * bs:
        raise ValueError(f"K11 needs bs % 64 == 0 and operands [nbr·bs = {nbr * bs}, N]; got "
                         f"bs={bs}, g {tuple(g_vn.shape)}")
    cols_p = require_index(cols, "cols", (nbr, max_b), dev)
    counts_p = require_index(counts, "counts", (nbr,), dev)
    g_p = require(g_vn, "g_vn", tuple(g_vn.shape), dev)
    x_p = require(x_vn, "x_vn", tuple(g_vn.shape), dev)
    out = torch.empty((nbr, max_b, bs, bs), device=dev, dtype=torch.float32)
    err = _build.library().stgcn_bcsr_sddmm(cols_p, counts_p, g_p, x_p, out.data_ptr(), nbr,
                                            max_b, bs, g_vn.shape[1], float(scale),
                                            stream_of(dev))
    _build.check("bcsr_sddmm", err)
    count_launch(LAUNCH_NAME)
    return out
