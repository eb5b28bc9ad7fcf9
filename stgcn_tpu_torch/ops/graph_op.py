"""On-device graph-shift-operator application (port of
``stgcn_tpu/ops/graph_op.py:30-601``: the dense, BCSR, banded (f32 and int8)
and blocked-ELL kinds).

The reference applies its dense GSO with ``torch.einsum('hi,btij->bthj')``
(``model/layers.py:154-161,198``). Here the GSO is an operator object passed
to the layers at call time:

- :class:`DenseGraphOp` — at road-graph sizes (207-325 vertices) the dense
  ``[V, V]`` product is the whole story: its ``[..., V] @ [V, V]ᵀ`` forms go
  to ``torch.matmul``, as the JAX package leaves them to XLA outside any
  Pallas kernel;
- :class:`BandedGraphOp` — above 4096 vertices, an RCM-ordered road graph
  packed as dense slabs over its band (f32, or int8 with per-row scales),
  applied by the hand-written kernels K7-K9
  (:mod:`stgcn_tpu_torch.kernels.banded_spmm`) on the folded ``[V, N]``
  operand, and by K5 (:mod:`stgcn_tpu_torch.kernels.banded_nv`) on the
  ``[N, V]`` operand of the fused path;
- :class:`EllGraphOp` — the O(nnz) blocked-ELL pack (f32 or int8) that
  carries the 1M-vertex graph, applied by K6
  (:mod:`stgcn_tpu_torch.kernels.ell_nv`) on the same operand;
- :class:`BcsrGraphOp` — the same tiles row-major, applied by K10
  (:mod:`stgcn_tpu_torch.kernels.spmm`) on the folded ``[V, N]`` operand:
  what ``auto`` picks above 4096 vertices when the RCM band is too wide for
  the banded slabs (the 1M-vertex road graph), as in the JAX package.

Every kind takes a bf16 operand (the JAX package's
``STGCN(dtype=bfloat16)``): each builder also packs its values in
``dtype=torch.bfloat16``, as the JAX builders do, and the sparse surfaces
return x's dtype, their kernels summing in float32 (the bf16 variants of
K5-K10). The dense ``__call__`` promotes as the JAX ``einsum`` does (a
float32 matrix and a bf16 operand give a float32 product); its cv and nv
surfaces cast the matrix to x's dtype.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from stgcn_tpu_torch.device import resolve_device
from stgcn_tpu_torch.graph.gso import GraphShiftOperator, effectively_symmetric
from stgcn_tpu_torch.graph.packing import pack_bcsr_device, pack_ell_device
from stgcn_tpu_torch.kernels import banded_nv as nvk
from stgcn_tpu_torch.kernels import banded_spmm as bk
from stgcn_tpu_torch.kernels import ell_nv as ek
from stgcn_tpu_torch.kernels import spmm as sk
from stgcn_tpu_torch.kernels.nnz_index import NnzIndex


def _fold_to_vn(x: torch.Tensor) -> torch.Tensor:
    """``[..., V, C]`` → ``[V, prod(...)·C]``, V leading (the JAX ``_fold_to_vn``)."""
    return x.movedim(-2, 0).reshape(x.shape[-2], -1)


def _fold_padded(x: torch.Tensor, rows: int) -> torch.Tensor:
    """:func:`_fold_to_vn` with zero rows appended up to ``rows``, contiguous,
    in one copy; a vn operand ``[W, N]`` keeps its layout."""
    pad = rows - x.shape[-2]
    if pad < 0:
        raise ValueError(f"operand has {x.shape[-2]} vertices, more than the operator's {rows}")
    x = x.movedim(-2, 0)
    if pad:
        x = torch.nn.functional.pad(x, (0, 0) * (x.dim() - 1) + (0, pad))
    return x.reshape(rows, -1).contiguous()


def _unfold_from_vn(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_fold_to_vn` for an operand shaped like ``like``."""
    return y.reshape(y.shape[0], *like.shape[:-2], like.shape[-1]).movedim(0, -2)


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
        """``(G·x, 2G(G·x) − x)`` on the last-axis operand (`model/layers.py:158-161`),
        ``2·y − x`` in float32 and rounded once to x's dtype, as in JAX."""
        t1 = self.apply_cv(x_cv)
        return t1, (2.0 * self.apply_cv(t1).float() - x_cv.float()).to(x_cv.dtype)

    def apply_nv(self, x_nv: torch.Tensor, *, scale: float = 1.0) -> torch.Tensor:
        """``[N, W] → [N, W]``: the same product on a 2-D operand."""
        if x_nv.dim() != 2:
            raise ValueError(f"nv operand must be [N, W], got {tuple(x_nv.shape)}")
        return self.apply_cv(x_nv, scale=scale)

    def cheb_pair_nv(self, x_nv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        t1 = self.apply_nv(x_nv)
        return t1, (2.0 * self.apply_nv(t1).float() - x_nv.float()).to(x_nv.dtype)

    def __call__(self, x: torch.Tensor, *, scale: float = 1.0) -> torch.Tensor:
        """Channels-last ``[..., V, C]`` application, in the promoted type of
        the matrix and x (the JAX ``einsum``: a float32 matrix lifts a bf16
        operand, exactly)."""
        mat = self.matrix if scale == 1.0 else self.matrix * scale
        dt = torch.promote_types(mat.dtype, x.dtype)
        return torch.einsum("uv,...vc->...uc", mat.to(dt), x.to(dt))


class _NvSurfaces:
    """The surfaces of an operator that carries only the nv kernels: given
    ``apply_nv`` and ``cheb_pair_nv`` on an ``[N, v_pad]`` operand, the
    others (``apply_vn``, ``cheb_pair_vn``, ``__call__``, ``cheb_pair``)
    reach them through a transpose, as the JAX operators do when they hold
    no vn pack (:219-224, :252-256, :396-414). Padded columns of the
    operand are zero."""

    v_pad: int
    has_nv = True

    def _pad(self, x_nv: torch.Tensor) -> torch.Tensor:
        if x_nv.dim() != 2 or x_nv.shape[1] > self.v_pad:
            raise ValueError(f"nv operand must be [N, W <= {self.v_pad}], got {tuple(x_nv.shape)}")
        pad = self.v_pad - x_nv.shape[1]
        return torch.nn.functional.pad(x_nv, (0, pad)) if pad else x_nv.contiguous()

    def apply_vn(self, x_vn: torch.Tensor, *, scale: float = 1.0) -> torch.Tensor:
        """``[V, N]`` operand, through the nv kernel and two transposes."""
        return self.apply_nv(x_vn.T, scale=scale).T[:x_vn.shape[0]]

    def cheb_pair_vn(self, x_vn: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        t1, t2 = self.cheb_pair_nv(x_vn.T)
        v = x_vn.shape[0]
        return t1.T[:v], t2.T[:v]

    @staticmethod
    def _nv_view(x: torch.Tensor) -> torch.Tensor:
        """Channels-last ``[..., V, C]`` → ``[N, V]`` with N ordered (..., C)."""
        return x.movedim(-1, -2).reshape(-1, x.shape[-2])

    @staticmethod
    def _unview(y_nv: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        v = like.shape[-2]
        return y_nv[:, :v].reshape(*like.shape[:-2], like.shape[-1], v).movedim(-1, -2)

    def __call__(self, x: torch.Tensor, *, scale: float = 1.0) -> torch.Tensor:
        """Channels-last ``[..., V, C]`` application."""
        return self._unview(self.apply_nv(self._nv_view(x), scale=scale), x)

    def cheb_pair(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Channels-last ``(G x, 2 G (G x) − x)`` (the Cheb layer's ks=3 route)."""
        t1, t2 = self.cheb_pair_nv(self._nv_view(x))
        return self._unview(t1, x), self._unview(t2, x)


@dataclasses.dataclass(frozen=True)
class BandedGraphOp(_NvSurfaces):
    """Banded-slab GSO for RCM-ordered road graphs (the JAX
    ``BandedGraphOp``, ``ops/graph_op.py:186-329``): per ``bs``-row block of
    the GSO one dense slab over its column window, and the same for ``Aᵀ``
    (the backward's operator), float32 or int8 with per-row dequant factors.

    Two pack families: the vn one ``[nbr, bs, w]`` (``slabs``), which K7-K9
    apply to the folded ``[V, N]`` operand (the unfused model: ``__call__``,
    ``cheb_pair``), and, with ``banded_graph_op(nv=True)``, the nv one
    ``[nbr, w, bs]`` (``slabs_nv``), which K5 applies to the ``[N, V]`` view
    of the fused path. An nv-only operator (``nv_only=True``) holds no vn
    slabs (``slabs.shape[0] == 0``) and reaches its vn surfaces through K5
    and two transposes, as the JAX one does. A scalar ``scale`` is the
    kernels' alpha, never multiplied into the slabs (the JAX op multiplies
    f32 slabs, or an int8 pack's scales, per call: at the model's scales of
    1 and 2 the same product). Each slab tensor carries the nonzero
    index its kernel walks (``index``, ``index_t``, ``index_nv``,
    ``index_nv_t``; one object where two fields hold one tensor), unbuilt
    until its first launch on the card."""

    slabs: torch.Tensor       # [nbr, bs, w] float32 or int8 (nv-only: [0, bs, w])
    lo: torch.Tensor          # [nbr] int32 window starts, on the device
    slabs_t: torch.Tensor     # transpose pack
    lo_t: torch.Tensor
    n_vertex: int
    v_pad: int
    # the JAX routing of the pair: K8 where the wavefront schedule is safe,
    # K9 on a stream pack (block-aligned, diagonal-containing windows)
    pair_safe: bool = True
    pair_stream: bool = False
    scales: torch.Tensor | None = None     # [nbr, bs] per-row dequant (int8)
    scales_t: torch.Tensor | None = None
    slabs_nv: torch.Tensor | None = None   # [nbr, w, bs], banded_graph_op(nv=True)
    slabs_nv_t: torch.Tensor | None = None
    # the nonzero index of each slab tensor (kernels/nnz_index.py)
    index: NnzIndex | None = None
    index_t: NnzIndex | None = None
    index_nv: NnzIndex | None = None
    index_nv_t: NnzIndex | None = None

    @property
    def has_nv(self) -> bool:
        return self.slabs_nv is not None

    @property
    def nv_only(self) -> bool:
        return self.slabs.shape[0] == 0 and self.has_nv

    def _apply_padded(self, x_vn: torch.Tensor, scale: float) -> torch.Tensor:
        """``scale · (A x)`` on a ``[v_pad, N]`` operand (K7)."""
        return bk.banded_spmm_vjp(self.slabs, self.lo, self.slabs_t, self.lo_t, x_vn,
                                  self.scales, self.scales_t, scale=scale, index=self.index,
                                  index_t=self.index_t)

    def _pair_padded(self, x_vn: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(A x, 2 A (A x) − x)`` on a ``[v_pad, N]`` operand, routed as
        the JAX ``cheb_pair_vn`` (:248-282): a stream pack takes K9; an int8
        pack without it, or a band the TPU's wavefront cannot run, two K7
        applications; else K8."""
        if self.pair_stream:
            return bk.banded_cheb_pair_stream_vjp(self.slabs, self.lo, self.slabs_t, self.lo_t,
                                                  x_vn, self.scales, self.scales_t,
                                                  index=self.index, index_t=self.index_t)
        if self.scales is not None or not self.pair_safe:
            t1 = self._apply_padded(x_vn, 1.0)
            return t1, self._apply_padded(t1, 2.0) - x_vn
        return bk.banded_cheb_pair_vjp(self.slabs, self.lo, self.slabs_t, self.lo_t, x_vn,
                                       index=self.index, index_t=self.index_t)

    def apply_vn(self, x_vn: torch.Tensor, *, scale: float = 1.0) -> torch.Tensor:
        """``[W, N] → [W, N]``, ``W <= v_pad`` rows (zero-padded to it for
        the kernel, the result cut back)."""
        if self.nv_only:
            return super().apply_vn(x_vn, scale=scale)
        return self._apply_padded(_fold_padded(x_vn, self.v_pad), scale)[:x_vn.shape[0]]

    def cheb_pair_vn(self, x_vn: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Folded-operand form of :meth:`cheb_pair` (``[W, N]`` in and out)."""
        if self.nv_only:
            return super().cheb_pair_vn(x_vn)
        v = x_vn.shape[0]
        t1, t2 = self._pair_padded(_fold_padded(x_vn, self.v_pad))
        return t1[:v], t2[:v]

    def __call__(self, x: torch.Tensor, *, scale: float = 1.0) -> torch.Tensor:
        """Channels-last ``[..., V, C]`` application."""
        if self.nv_only:
            return super().__call__(x, scale=scale)
        y = self._apply_padded(_fold_padded(x, self.v_pad), scale)
        return _unfold_from_vn(y[:x.shape[-2]], x)

    def cheb_pair(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Channels-last ``(G x, 2 G (G x) − x)`` (the Cheb layer's ks=3
        route): the operand folded once for both terms."""
        if self.nv_only:
            return super().cheb_pair(x)
        v = x.shape[-2]
        t1, t2 = self._pair_padded(_fold_padded(x, self.v_pad))
        return _unfold_from_vn(t1[:v], x), _unfold_from_vn(t2[:v], x)

    def apply_nv(self, x_nv: torch.Tensor, *, scale: float = 1.0) -> torch.Tensor:
        """``[N, W] → [N, v_pad]``: ``scale · (A x)`` on the nv operand (K5 single)."""
        return nvk.banded_spmm_nv(self.slabs_nv, self.lo, self.slabs_nv_t, self.lo_t,
                                  self._pad(x_nv), self.scales, self.scales_t, scale=scale,
                                  index=self.index_nv, index_t=self.index_nv_t)

    def cheb_pair_nv(self, x_nv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """ks=3 recurrence ``(A x, 2 A (A x) − x)`` on the nv operand (K5 pair)."""
        return nvk.cheb_pair_nv(self.slabs_nv, self.lo, self.slabs_nv_t, self.lo_t,
                                self._pad(x_nv), self.scales, self.scales_t,
                                index=self.index_nv, index_t=self.index_nv_t)


@dataclasses.dataclass(frozen=True)
class EllGraphOp(_NvSurfaces):
    """Blocked-ELL GSO in nv orientation (the JAX ``EllGraphOp``,
    ``ops/graph_op.py:332-417``): per ``bs``-row block of the GSO only its
    live ``bs × bs`` tiles, pre-transposed (:class:`~stgcn_tpu_torch.kernels.
    ell_nv.EllPack`), float32 or int8 with per-row dequant factors, and the
    same for ``Aᵀ`` (one shared pack when the GSO is symmetric). O(nnz): the
    1M-vertex road graph's operator. The nv surfaces run K6 on an ``[N, W]``
    operand, ``W <= v_pad = nbr·bs``; a scalar ``scale`` is folded into the
    kernel's epilogue, never into the pack."""

    pack: ek.EllPack
    pack_t: ek.EllPack
    n_vertex: int

    @property
    def block_size(self) -> int:
        return self.pack.data.shape[-1]

    @property
    def v_pad(self) -> int:
        return self.pack.cols.shape[0] * self.block_size

    def apply_nv(self, x_nv: torch.Tensor, *, scale: float = 1.0) -> torch.Tensor:
        """``[N, W] → [N, v_pad]``: ``scale · (A x)`` on the nv operand (K6 single)."""
        return ek.ell_spmm_nv(self.pack, self.pack_t, self._pad(x_nv), scale=scale)

    def cheb_pair_nv(self, x_nv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """ks=3 recurrence ``(A x, 2 A (A x) − x)`` on the nv operand (K6 pair)."""
        return ek.ell_cheb_pair_nv(self.pack, self.pack_t, self._pad(x_nv))


@dataclasses.dataclass(frozen=True)
class BcsrGraphOp:
    """Blocked-CSR GSO applied by K10 (the JAX ``BcsrGraphOp``,
    ``ops/graph_op.py:139-184``): per ``bs``-row block of the GSO its live
    ``bs × bs`` tiles, row-major (:class:`~stgcn_tpu_torch.kernels.spmm.
    BcsrPack`), and the same for ``Aᵀ`` (one shared pack when the GSO is
    symmetric). Its surfaces are the vn operand ``[V, N]`` and, through a
    fold, the channels-last ``[..., V, C]`` one; like the JAX operator it has
    no ``cheb_pair``, so the Cheb layer applies it twice (``gop(x)``, then
    ``gop(t1, scale=2.0) − x``). A scalar ``scale`` is K10's alpha, never
    multiplied into the pack. Differentiable in the operand, and in
    ``pack.data`` when that requires grad (K11)."""

    pack: sk.BcsrPack
    pack_t: sk.BcsrPack
    n_vertex: int

    @property
    def block_size(self) -> int:
        return self.pack.block_size

    @property
    def n_vertex_pad(self) -> int:
        return self.pack.cols.shape[0] * self.block_size

    def apply_vn(self, x_vn: torch.Tensor, *, scale: float = 1.0) -> torch.Tensor:
        """``[W, N] → [W, N]``, ``W <= n_vertex_pad`` rows (zero-padded to
        it for the kernel, the result cut back)."""
        w, pad = x_vn.shape[0], self.n_vertex_pad - x_vn.shape[0]
        if x_vn.dim() != 2 or pad < 0:
            raise ValueError(f"vn operand must be [W <= {self.n_vertex_pad}, N], got "
                             f"{tuple(x_vn.shape)}")
        x_vn = torch.nn.functional.pad(x_vn, (0, 0, 0, pad)) if pad else x_vn.contiguous()
        y = sk.bcsr_spmm_vjp(self.pack, self.pack_t, x_vn, scale=scale)
        return y[:w] if pad else y

    def __call__(self, x: torch.Tensor, *, scale: float = 1.0) -> torch.Tensor:
        """Channels-last ``[..., V, C]`` application."""
        return _unfold_from_vn(self.apply_vn(_fold_to_vn(x), scale=scale), x)


def dense_graph_op(gso: GraphShiftOperator | np.ndarray, *,
                   device: str | torch.device = "cuda",
                   dtype: torch.dtype = torch.float32) -> DenseGraphOp:
    mat = gso.to_dense() if isinstance(gso, GraphShiftOperator) else np.asarray(gso)
    return DenseGraphOp(matrix=torch.as_tensor(mat, dtype=dtype).to(resolve_device(device)))


def _slab_indexes(**slabs: torch.Tensor | None) -> dict[str, NnzIndex]:
    """An unbuilt nonzero index per slab tensor, keyed ``index`` and the
    field's suffix (``slabs_t`` gives ``index_t``); fields that hold one
    tensor (a symmetric GSO's transpose, the empty vn slabs of an nv-only
    operator) share one index."""
    by_tensor: dict[int, NnzIndex] = {}
    return {"index" + name[len("slabs"):]: by_tensor.setdefault(id(t), NnzIndex())
            for name, t in slabs.items() if t is not None}


def banded_graph_op(gso: GraphShiftOperator, *, dtype: torch.dtype = torch.float32,
                    quantize: bool = False, block_size: int | None = None, stream: bool = True,
                    nv: bool = False, nv_only: bool = False,
                    device: str | torch.device = "cuda") -> BandedGraphOp:
    """The JAX ``banded_graph_op`` (:446-537), packed on the device.

    ``stream`` or ``quantize``: block-aligned, diagonal-containing windows
    (``col_align = bs``), the pack of the streaming pair K9, ``dtype``
    (float32 or bf16) or int8 with per-row scales; ``nv`` adds the pre-transposed nv family for K5,
    ``nv_only`` keeps only that one. A symmetric GSO (every ``sym_*``
    normalization, up to rounding) reuses one pack for the transpose;
    ``v_pad`` is the pack's natural one (the max of both directions).
    Otherwise: :func:`~stgcn_tpu_torch.kernels.banded_spmm.pack_banded_with_transpose`,
    128-aligned windows clamped to ``v_pad``, a pack of its own for ``Aᵀ``
    (K7, and K8 where :func:`~stgcn_tpu_torch.kernels.banded_spmm.
    cheb_pair_wavefront_safe` holds); ``nv`` is ignored there, as in the JAX
    function."""
    bs = block_size or 256
    dev = resolve_device(device)
    if not (stream or quantize):
        slabs, lo, slabs_t, lo_t, v_pad = bk.pack_banded_with_transpose(
            gso.matrix, block_size=bs, dtype=dtype, device=dev)
        return BandedGraphOp(slabs=slabs, lo=torch.from_numpy(lo).to(dev), slabs_t=slabs_t,
                             lo_t=torch.from_numpy(lo_t).to(dev), n_vertex=gso.n_vertex,
                             v_pad=v_pad, pair_safe=bk.cheb_pair_wavefront_safe(lo, bs),
                             **_slab_indexes(slabs=slabs, slabs_t=slabs_t))

    if quantize:
        dtype = torch.int8
    csr = sp.csr_matrix(gso.matrix)
    csr_t = csr.T.tocsr()
    symmetric = effectively_symmetric(csr)
    v_pad = max(bk._window_meta(m, bs, bs, contain_diag=True)[3]
                for m in ((csr,) if symmetric else (csr, csr_t)))

    def pack(m, transpose_slabs):
        out = bk.pack_banded_device(m, block_size=bs, col_align=bs, contain_diag=True,
                                    dtype=dtype, v_pad=v_pad, transpose_slabs=transpose_slabs,
                                    device=dev)
        return out[0], out[1], out[3] if quantize else None

    def both(transpose_slabs):
        fwd = pack(csr, transpose_slabs)
        return fwd, fwd if symmetric else pack(csr_t, transpose_slabs)

    (slabs, lo, scales), (slabs_t, lo_t, scales_t) = both(nv and nv_only)
    slabs_nv = slabs_nv_t = None
    if nv:
        # pre-transposed packs for the fused path's kernel K5
        if nv_only:
            # carry only the nv family: the vn surfaces go through K5 and
            # two transposes; empty vn slabs mark it, as in the JAX op
            slabs_nv, slabs_nv_t = slabs, slabs_t
            _, w, _ = slabs.shape
            slabs = slabs_t = torch.zeros((0, bs, w), dtype=dtype, device=dev)
        else:
            (slabs_nv, _, _), (slabs_nv_t, _, _) = both(True)
    w = slabs.shape[-1]
    lo_d = torch.from_numpy(lo).to(dev)
    return BandedGraphOp(
        slabs=slabs, lo=lo_d, slabs_t=slabs_t,
        lo_t=lo_d if symmetric else torch.from_numpy(lo_t).to(dev), n_vertex=gso.n_vertex,
        v_pad=v_pad,
        pair_safe=bk.cheb_pair_wavefront_safe(lo, bs),
        pair_stream=bk.cheb_pair_stream_safe(lo, w, bs) and bk.cheb_pair_stream_safe(lo_t, w, bs),
        scales=scales, scales_t=scales_t, slabs_nv=slabs_nv, slabs_nv_t=slabs_nv_t,
        **_slab_indexes(slabs=slabs, slabs_t=slabs_t, slabs_nv=slabs_nv, slabs_nv_t=slabs_nv_t))


def ell_graph_op(gso: GraphShiftOperator, *, block_size: int = 256, quantize: bool = False,
                 dtype: torch.dtype = torch.float32,
                 device: str | torch.device = "cuda") -> EllGraphOp:
    """The JAX ``ell_graph_op`` (:540-571), packed on the device: int8 tiles
    with per-row scales when ``quantize`` (``dtype`` ignored, as in JAX),
    else float32 or ``dtype=torch.bfloat16`` (the float32 host pack cast on
    transfer, :552-555). A symmetric GSO
    (every ``sym_*`` normalization, up to rounding) reuses the forward pack
    for the transpose application — the same device tensors. Each pack
    carries an unbuilt nonzero index, which K6's first launch builds from
    the tiles (one for both directions of a symmetric GSO)."""
    dev = resolve_device(device)
    csr = sp.csr_matrix(gso.matrix)

    def pack(m):
        return ek.EllPack(*pack_ell_device(m, block_size=block_size, quantize=quantize,
                                           dtype=dtype, device=dev), NnzIndex())

    fwd = pack(csr)
    return EllGraphOp(pack=fwd, pack_t=fwd if effectively_symmetric(csr) else pack(csr.T.tocsr()),
                      n_vertex=gso.n_vertex)


def bcsr_graph_op(gso: GraphShiftOperator, *, block_size: int = 256,
                  dtype: torch.dtype = torch.float32,
                  device: str | torch.device = "cuda") -> BcsrGraphOp:
    """The JAX ``bcsr_graph_op`` (:420-442), packed on the device, float32
    (or ``dtype=torch.bfloat16``), 256 × 256 tiles as its default. A symmetric GSO (every ``sym_*``
    normalization, up to rounding) reuses the forward pack for the
    transpose — the same device tensors; the JAX op packs ``Aᵀ`` apart
    (:434), the same numbers, and at 1M vertices 26.6 GB where one pack is
    13.3 GB. Each pack carries an unbuilt nonzero index, which K10's first
    launch builds from the tiles."""
    dev = resolve_device(device)
    csr = sp.csr_matrix(gso.matrix)

    def pack(m):
        return sk.BcsrPack(*pack_bcsr_device(m, block_size=block_size, dtype=dtype, device=dev),
                           NnzIndex())

    fwd = pack(csr)
    return BcsrGraphOp(pack=fwd, pack_t=fwd if effectively_symmetric(csr) else pack(csr.T.tocsr()),
                       n_vertex=gso.n_vertex)


def auto_kind(gso: GraphShiftOperator) -> str:
    """The representation ``auto`` picks (the JAX rule, ``ops/graph_op.py:
    580-586``): dense up to 4096 vertices; above that the banded slabs when
    the (RCM-ordered) band is narrow, else BCSR."""
    if gso.n_vertex <= 4096:
        return "dense"
    return "banded" if bk.banded_viable(gso.matrix) else "bcsr"


def make_graph_op(gso: GraphShiftOperator, kind: str = "auto", *,
                  device: str | torch.device = "cuda", **kw
                  ) -> DenseGraphOp | BandedGraphOp | EllGraphOp | BcsrGraphOp:
    """Pick a representation (the JAX rule, ``ops/graph_op.py:574-601``):
    ``auto`` as :func:`auto_kind`; ``banded_int8``, ``ell`` / ``ell_int8``
    and ``bcsr`` are asked for by name, as in the JAX package. ``dtype``
    goes to the builder."""
    if kind == "auto":
        kind = auto_kind(gso)
    if kind == "dense":
        return dense_graph_op(gso, device=device, **kw)
    if kind == "bcsr":
        return bcsr_graph_op(gso, device=device, **kw)
    if kind in ("banded", "banded_int8"):
        return banded_graph_op(gso, quantize=kind == "banded_int8", device=device, **kw)
    if kind in ("ell", "ell_int8"):
        return ell_graph_op(gso, quantize=kind == "ell_int8", device=device, **kw)
    raise ValueError(f"unknown graph-op kind {kind!r}")
