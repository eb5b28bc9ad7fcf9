"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` compiles in an ``nvcc`` process of its own, all started
together, and one more ``nvcc`` links the objects into
``_build/libstgcn_torch_kernels.so`` (a git-ignored directory beside this
file), at first use::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \\
         -Xptxas -v -c -o <obj> csrc/<source>.cu          # one per source, in parallel
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o _build/libstgcn_torch_kernels.so <objs>

The sources include no PyTorch header: each kernel is behind a plain C
function that takes device pointers, sizes and a ``cudaStream_t`` and
returns the ``cudaError_t`` of its launches; a backward entry point (and
K12f's) also takes a workspace that its ``*_work`` function sizes. The
library is rebuilt when the hash of the sources differs from the one stored
beside it. A failed build raises with nvcc's output; nothing falls back to
the plain versions.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
LIB_NAME = "libstgcn_torch_kernels.so"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_DROP = [_U, _I, _U, _F]   # a dropout site: seed, site, threshold, scale
# C signature of every entry point: device pointers, then ints (and a
# dropout site), then the stream; each returns its cudaError_t
SIGNATURES = {
    "stgcn_head_fwd": [_P] * 10 + [_I] * 10 + _DROP + [_P],
    "stgcn_tail_fwd": [_P] * 13 + [_I] * 9 + [_P],
    "stgcn_ohead_fwd": [_P] * 11 + [_I] * 7 + _DROP + [_P],
    "stgcn_ofc_fwd": [_P] * 10 + [_I] * 6 + _DROP + [_P],
    "stgcn_head_fwd_bf16": [_P] * 10 + [_I] * 10 + _DROP + [_P],
    "stgcn_tail_fwd_bf16": [_P] * 13 + [_I] * 9 + [_P],
    "stgcn_ohead_fwd_bf16": [_P] * 11 + [_I] * 7 + _DROP + [_P],
    "stgcn_ofc_fwd_bf16": [_P] * 10 + [_I] * 6 + _DROP + [_P],
    "stgcn_head_bwd": [_P] * 19 + [_I] * 10 + _DROP + [_P],
    "stgcn_tail_bwd": [_P] * 18 + [_I] * 10 + [_P],
    "stgcn_ohead_bwd": [_P] * 18 + [_I] * 7 + _DROP + [_P],
    "stgcn_ofc_bwd": [_P] * 19 + [_I] * 6 + _DROP + [_P],
    "stgcn_head_bwd_bf16": [_P] * 19 + [_I] * 10 + _DROP + [_P],
    "stgcn_tail_bwd_bf16": [_P] * 18 + [_I] * 10 + [_P],
    "stgcn_ohead_bwd_bf16": [_P] * 18 + [_I] * 7 + _DROP + [_P],
    "stgcn_ofc_bwd_bf16": [_P] * 19 + [_I] * 6 + _DROP + [_P],
    "stgcn_banded_nv": [_P] * 10 + [_I] * 7 + [_F, _P],
    "stgcn_banded_vn": [_P] * 9 + [_I] * 8 + [_F, _P],
    "stgcn_ell_nv": [_P] * 10 + [_I] * 6 + [_F, _P],
    "stgcn_bcsr_spmm": [_P] * 6 + [_I] * 6 + [_F, _P],
    "stgcn_bcsr_sddmm": [_P] * 5 + [_I] * 4 + [_F, _P],
    "stgcn_stblock_fwd": [_P] * 15 + [_I] * 11 + _DROP + [_P],
    "stgcn_stblock_bwd": [_P] * 25 + [_I] * 11 + _DROP + [_P],
}
# workspace size in floats of each backward entry point, from its sizes
WORK_SIGNATURES = {
    "stgcn_head_bwd_work": [_I] * 9,
    "stgcn_tail_bwd_work": [_I] * 9,
    "stgcn_ohead_bwd_work": [_I] * 6,
    "stgcn_ofc_bwd_work": [_I] * 5,
    "stgcn_head_bwd_bf16_work": [_I] * 9,
    "stgcn_tail_bwd_bf16_work": [_I] * 9,
    "stgcn_ohead_bwd_bf16_work": [_I] * 6,
    "stgcn_ofc_bwd_bf16_work": [_I] * 5,
    "stgcn_stblock_fwd_work": [_I] * 11,
    "stgcn_stblock_bwd_work": [_I] * 11,
}


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    cached: bool     # True when a library with the same source hash existed
    seconds: float   # wall time of this call (nvcc included when not cached)
    log: str         # nvcc's output (ptxas register / shared-memory report)


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted([*SRC_DIR.glob("*.cu"), *SRC_DIR.glob("*.cuh")]):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (checked PATH and /usr/local/cuda/bin); "
                       "the CUDA kernels cannot be built")


def build() -> BuildInfo:
    """Compile the kernels unless a library of the same source hash exists."""
    t0 = time.perf_counter()
    lib, stamp, log = BUILD_DIR / LIB_NAME, BUILD_DIR / "source.sha256", BUILD_DIR / "nvcc.log"
    digest = source_hash()
    if lib.exists() and stamp.exists() and stamp.read_text().strip() == digest:
        return BuildInfo(lib, True, time.perf_counter() - t0,
                         log.read_text() if log.exists() else "")
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        objs = [Path(objdir) / f"{src.stem}.o" for src in sources()]
        procs = [(src, subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True))
                 for src, obj in zip(sources(), objs)]
        logs, failed = [], []
        for src, proc in procs:
            out = proc.communicate()[0]
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {src.name} (rc {proc.returncode}):\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = Path(objdir) / LIB_NAME
        cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        out = "".join(logs) + proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (rc {proc.returncode}): {' '.join(cmd)}\n{out}")
        os.replace(tmp, lib)  # atomic: a concurrent loader sees old or new, never half
    log.write_text(out)
    stamp.write_text(digest)
    return BuildInfo(lib, False, time.perf_counter() - t0, out)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call) with typed entry points."""
    lib = ctypes.CDLL(str(build().path))
    for table, restype in ((SIGNATURES, ctypes.c_int), (WORK_SIGNATURES, ctypes.c_longlong)):
        for name, argtypes in table.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
    lib.stgcn_error_string.argtypes = [ctypes.c_int]
    lib.stgcn_error_string.restype = ctypes.c_char_p
    return lib


def check(name: str, err: int) -> None:
    """Raise if a kernel entry point returned a non-zero ``cudaError_t``."""
    if err != 0:
        msg = library().stgcn_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
