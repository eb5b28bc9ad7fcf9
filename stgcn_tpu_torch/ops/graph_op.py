"""On-device graph-shift-operator application (port of
``stgcn_tpu/ops/graph_op.py:47-137,574-601``, dense kind).

The reference applies its dense GSO with ``torch.einsum('hi,btij->bthj')``
(``model/layers.py:154-161,198``). Here the GSO is an operator object passed
to the layers at call time. At road-graph sizes (207-325 vertices) the dense
``[V, V]`` product is the whole story: its ``[..., V] @ [V, V]ᵀ`` forms go to
``torch.matmul``, as the JAX package leaves them to XLA outside any Pallas
kernel. The sparse kinds (banded, blocked-ELL, BCSR) come with their kernels
in later slices of the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stgcn_tpu_torch.device import resolve_device
from stgcn_tpu_torch.graph.gso import GraphShiftOperator


@dataclasses.dataclass(frozen=True)
class DenseGraphOp:
    """Dense GSO: ``y[..., u, c] = sum_v A[u, v] x[..., v, c]``.

    Also exposes the cv (``[..., V]`` last-axis) and nv (``[N, V]``)
    surfaces that the vertex-fused forward pairs with its kernels; there the
    vertex axis is zero-padded to :attr:`v_pad`, a multiple of 128, and
    the padded rows and columns of the operator are zero, so padded lanes
    stay zero through every product."""

    matrix: torch.Tensor  # [V, V]

    @property
    def n_vertex(self) -> int:
        return self.matrix.shape[0]

    @property
    def v_pad(self) -> int:
        """128-aligned vertex count of the cv/nv surfaces (zero-padded)."""
        return -(-self.n_vertex // 128) * 128

    def _mat_width(self, w: int, scale: float) -> torch.Tensor:
        if w < self.n_vertex:
            raise ValueError(f"operand has {w} vertex lanes < n_vertex {self.n_vertex}")
        mat = self.matrix if scale == 1.0 else self.matrix * scale
        p = w - self.n_vertex
        return torch.nn.functional.pad(mat, (0, p, 0, p)) if p else mat

    def apply_cv(self, x_cv: torch.Tensor, *, scale: float = 1.0) -> torch.Tensor:
        """``[..., W] → [..., W]`` contraction over the last (vertex) axis,
        ``W >= n_vertex``; lanes past ``n_vertex`` are zero in and out."""
        mat = self._mat_width(x_cv.shape[-1], scale).to(x_cv.dtype)
        return torch.matmul(x_cv, mat.T)

    def cheb_pair_cv(self, x_cv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(G·x, 2G(G·x) − x)`` on the last-axis operand (`model/layers.py:158-161`)."""
        t1 = self.apply_cv(x_cv)
        return t1, 2.0 * self.apply_cv(t1) - x_cv

    def apply_nv(self, x_nv: torch.Tensor, *, scale: float = 1.0) -> torch.Tensor:
        """``[N, W] → [N, W]``: the same product on a 2-D operand."""
        if x_nv.dim() != 2:
            raise ValueError(f"nv operand must be [N, W], got {tuple(x_nv.shape)}")
        return self.apply_cv(x_nv, scale=scale)

    def cheb_pair_nv(self, x_nv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        t1 = self.apply_nv(x_nv)
        return t1, 2.0 * self.apply_nv(t1) - x_nv

    def __call__(self, x: torch.Tensor, *, scale: float = 1.0) -> torch.Tensor:
        """Channels-last ``[..., V, C]`` application."""
        mat = self.matrix if scale == 1.0 else self.matrix * scale
        return torch.einsum("uv,...vc->...uc", mat, x)


def dense_graph_op(gso: GraphShiftOperator | np.ndarray, *,
                   device: str | torch.device = "cuda",
                   dtype: torch.dtype = torch.float32) -> DenseGraphOp:
    mat = gso.to_dense() if isinstance(gso, GraphShiftOperator) else np.asarray(gso)
    return DenseGraphOp(matrix=torch.as_tensor(mat, dtype=dtype).to(resolve_device(device)))


_LATER = {"bcsr": "the --graph_op bcsr slice (blocked-ELL SpMM and SDDMM kernels)",
          "banded": "the 100k-vertex slice (banded nv kernels)",
          "banded_int8": "the 100k-vertex slice (banded nv kernels)",
          "ell": "the 1M-vertex slice (blocked-ELL nv kernels)",
          "ell_int8": "the 1M-vertex slice (blocked-ELL nv kernels)"}


def make_graph_op(gso: GraphShiftOperator, kind: str = "auto", *,
                  device: str | torch.device = "cuda", **kw) -> DenseGraphOp:
    """Pick a representation: dense up to 4096 vertices (the JAX rule,
    ``ops/graph_op.py:580-582``). Sparse kinds are not ported yet and
    raise, naming the slice that brings them."""
    if kind == "auto":
        if gso.n_vertex > 4096:
            raise NotImplementedError(
                f"{gso.n_vertex} vertices need a sparse graph operator, which "
                "comes with a later slice of the port (banded / blocked-ELL)")
        kind = "dense"
    if kind == "dense":
        return dense_graph_op(gso, device=device, **kw)
    if kind in _LATER:
        raise NotImplementedError(f"graph-op kind {kind!r} is not ported yet; it "
                                  f"comes with {_LATER[kind]}")
    raise ValueError(f"unknown graph-op kind {kind!r}")
