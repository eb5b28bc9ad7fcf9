"""Argument checks and ctypes plumbing shared by the kernel wrappers."""

from __future__ import annotations

import torch

from stgcn_tpu_torch.kernels.dropout import NO_DROP_ARGS


# kernel launches per wrapper name, read by kernels.launch_counts()
LAUNCHES: dict[str, int] = {}


def count_launch(name: str) -> None:
    """Count one launch of a wrapper's kernel; called only where it launches."""
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def on_cpu(t: torch.Tensor) -> bool:
    """True when a wrapper should run its plain version: only because the
    tensor lies on the CPU. Any other device goes to the kernel, which
    raises unless the device is CUDA."""
    return t.device.type == "cpu"


def require(t: torch.Tensor | None, name: str, shape: tuple[int, ...],
            device: torch.device, dtype: torch.dtype = torch.float32) -> int:
    """Check a kernel operand and return its device pointer (0 for None)."""
    if t is None:
        return 0
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def require_index(t: torch.Tensor, name: str, shape: tuple[int, ...],
                  device: torch.device) -> int:
    """Check an int32 index operand and return its device pointer."""
    if t.device != device or t.dtype != torch.int32 or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int32 {list(shape)} tensor on {device}")
    return t.data_ptr()


def refuse_value_grad(*values: torch.Tensor | None) -> None:
    """Raise where a caller asks for the gradient of an f32 (or bf16)
    operator's values (banded slabs, ELL tiles): the JAX VJPs give it
    through scans that are not ported yet (``ROADMAP.md`` §1, "The
    operator-value gradients"), and returning nothing would drop it without
    a word. int8 values are frozen, as in JAX."""
    if any(v is not None and v.requires_grad and v.dtype.is_floating_point for v in values):
        raise NotImplementedError(
            "the gradient of the graph operator's f32 values (banded slabs, ELL tiles) is "
            "not ported yet (ROADMAP.md §1, \"The operator-value gradients\"); detach the "
            "operator, or use the BCSR operator, whose tile-value gradient runs through K11")


BF16_SLICE = ("the bf16 variants of K11 and K12 (ROADMAP.md §1 item 4), the next slice of "
              "the port")


def refuse_bf16(what: str, *tensors: torch.Tensor | None, where: str = BF16_SLICE) -> None:
    """Raise ``NotImplementedError`` where a kernel whose bf16 variant is not
    ported yet is handed a bf16 tensor: nothing is cast to float32 to reuse
    the float32 kernel."""
    if any(t is not None and t.dtype == torch.bfloat16 for t in tensors):
        raise NotImplementedError(f"{what} on bf16 is not ported yet; it comes with {where}")


def refuse_bf16_model(model, route: str, where: str = BF16_SLICE) -> None:
    """Raise ``NotImplementedError`` for a bf16 model (``dtype`` or
    ``ln_param_dtype``) on a route whose kernels' bf16 variants are not
    ported yet (``fused_forward``'s K12), naming the slice that brings
    them."""
    if model.dtype is not None or model.ln_param_dtype != torch.float32:
        raise NotImplementedError(f"{route} of a bf16 model is not ported yet; it comes with "
                                  f"{where}")


def cuda_device(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA or CPU tensors, got {t.device}")
    return t.device


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def workspace(floats: int, device: torch.device, dtype: torch.dtype = torch.float32
              ) -> torch.Tensor:
    """Scratch of an entry point (a backward entry point sizes it by its
    ``*_work`` function): ``floats`` elements of ``dtype``."""
    return torch.empty(max(int(floats), 1), device=device, dtype=dtype)


def drop_args(drop) -> tuple:
    """The (seed, site, threshold, scale) of a dropout site; the site is off
    (threshold 0) for None."""
    return NO_DROP_ARGS if drop is None else drop.c_args()


ACT_CODES = {"glu": 0, "gtu": 1, "relu": 2, "silu": 3}
LANES = 128   # vertex lanes per CUDA block (csrc/common.cuh kLanes)
TILE_LANES = 64   # vertex lanes of a gate GEMM block (csrc/gate_gemm.cu kGemmLanes)
GATE_PASS = 64    # fewest gate channels of a gate GEMM pass (gated; plain passes take 128)
MAX_OUT = 16  # narrow outputs a thread keeps in registers (csrc/common.cuh kMaxOut)
