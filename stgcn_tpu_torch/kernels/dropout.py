"""Dropout keyed by element: the same mask in every path, kernel or plain.

An element is kept when ``bits(seed, site, index) >= round(p · 2^32)`` (the
threshold rule of the TPU kernels' ``_drop_mask``,
``stgcn_tpu/kernels/vertex_fused.py:472-482``), and a kept element is scaled
by ``1 / (1 - p)``. ``bits`` is a counter-based 32-bit hash built from the
MurmurHash3 finalizer ``fmix32``::

    key  = fmix32(seed ^ fmix32(site * 0x9E3779B9 + 0x7F4A7C15))
    bits = fmix32(fmix32(lo ^ key) ^ hi * 0x85EBCA6B)    lo, hi = index's 32-bit halves

``index`` is the *logical* element index of the dropped tensor in
``[B, T, C, V_true]`` order: never a tile, a grid step or a padded lane.
So the forward and backward kernels may tile freely, and the fused path
and the unfused model (channels-last ``[B, T, V, C]``) drop the same
elements. ``seed`` comes from ``(TrainConfig.seed, global step)``
(:func:`step_seed`); ``site`` names the dropout: ``l`` for ST block ``l``'s
LayerNorm output, ``n_st_blocks`` for the output head's fc1.

This module computes the bits in int64 arithmetic masked to 32 bits; the
CUDA twin (``csrc/dropout.cuh``) computes them in ``uint32_t``, so a
kernel's mask equals :func:`keep_mask` bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

_M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
SITE_OFFSET = 0x7F4A7C15
HI_MUL = 0x85EBCA6B
MASK_CHUNK_ELEMS = 1 << 24   # elements hashed at once by keep_mask


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2^32`` for int64 ``h`` in [0, 2^32): split in 16-bit
    halves of ``c`` so no product leaves int64."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer on int64 values in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _fmix32_int(h: int) -> int:
    return int(fmix32(torch.tensor([h & _M32], dtype=torch.int64))[0])


def site_key(seed: int, site: int) -> int:
    """The 32-bit key of one (seed, site) pair."""
    s = _fmix32_int((site * GOLDEN + SITE_OFFSET) & _M32)
    return _fmix32_int((seed & _M32) ^ s)


def bits(seed: int, site: int, index: torch.Tensor) -> torch.Tensor:
    """The 32 random bits of each logical element index (int64 tensor)."""
    key = site_key(seed, site)
    lo, hi = index & _M32, (index >> 32) & _M32
    return fmix32(fmix32(lo ^ key) ^ _mul32(hi, HI_MUL))


def step_seed(base: int, step: int) -> int:
    """The dropout seed of one training step: ``fmix32(fmix32(base) ^ step·φ)``,
    so a resumed run draws the masks the uninterrupted one did."""
    return _fmix32_int(_fmix32_int(base & _M32) ^ ((step * GOLDEN) & _M32))


@dataclasses.dataclass(frozen=True)
class Drop:
    """One dropout site of one step: rate ``p``, ``seed`` and ``site``."""

    rate: float
    seed: int
    site: int

    def __post_init__(self):
        if not 0.0 < self.rate < 1.0:
            raise ValueError(f"dropout rate {self.rate} must lie in (0, 1); pass no Drop "
                             "for rate 0")

    @property
    def threshold(self) -> int:
        """Keep when ``bits >= threshold``."""
        return round(self.rate * float(2 ** 32))

    @property
    def scale(self) -> float:
        return 1.0 / (1.0 - self.rate)

    def c_args(self) -> tuple[int, int, int, float]:
        """(seed, site, threshold, scale) as the CUDA entry points take them."""
        return self.seed & _M32, self.site, self.threshold, self.scale


NO_DROP_ARGS = (0, 0, 0, 1.0)   # threshold 0 keeps every element at scale 1


def keep_mask(drop: Drop, shape: tuple[int, int, int, int], v_true: int, *,
              device: torch.device | str = "cpu") -> torch.Tensor:
    """The pre-scaled float32 keep mask of a ``[B, T, C, W]`` cv tensor whose
    first ``v_true`` lanes are true vertices; lanes ``>= v_true`` are 0.

    Hashed a chunk of ``[T·C]`` rows at a time: the int64 temporaries of
    :func:`bits` are 8 bytes an element, several alive at once, and a whole
    mask at 1M vertices holds 5e8 elements."""
    b, t, c, w = shape
    rows = b * t * c
    lanes = torch.arange(w, device=device, dtype=torch.int64)
    scale = torch.tensor(drop.scale, dtype=torch.float32, device=device)
    out = torch.empty((rows, w), dtype=torch.float32, device=device)
    step = max(1, MASK_CHUNK_ELEMS // max(w, 1))
    for r0 in range(0, rows, step):
        idx = torch.arange(r0, min(r0 + step, rows), device=device,
                           dtype=torch.int64)[:, None] * v_true + lanes[None, :]
        keep = (bits(drop.seed, drop.site, idx) >= drop.threshold) & (lanes < v_true)[None, :]
        out[r0:r0 + step] = keep.to(torch.float32) * scale
    return out.reshape(b, t, c, w)


def apply_cv(x: torch.Tensor, drop: Drop | None, v_true: int) -> torch.Tensor:
    """``x * keep_mask`` for a cv tensor ``[B, T, C, W]``; identity for None.
    A bf16 ``x`` is multiplied by the mask in bf16 (the scale rounded to
    bf16, the product rounded), as the TPU's bf16 kernels store the mask."""
    if drop is None:
        return x
    return x * keep_mask(drop, tuple(x.shape), v_true, device=x.device).to(x.dtype)


def apply_channels_last(x: torch.Tensor, drop: Drop | None) -> torch.Tensor:
    """Dropout of a channels-last ``[B, T, V, C]`` tensor with the mask of its
    cv layout ``[B, T, C, V]``: the unfused model drops what the kernels drop.
    A bf16 ``x`` is scaled in float32 and rounded once back to bf16."""
    if drop is None:
        return x
    b, t, v, c = x.shape
    return (x * keep_mask(drop, (b, t, c, v), v, device=x.device).transpose(2, 3)).to(x.dtype)
