"""Build-at-first-use loader of the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into
a shared library of its own with a plain C interface, and loaded with
``ctypes``. The sources include no PyTorch headers, so a build takes
seconds rather than the minutes a ``torch/extension.h`` translation unit
costs. Libraries go to ``build/torch_ext/`` at the repository root,
named by a hash of the source and the flags, so an edited source builds
anew and an unchanged one is reused. Importing this module builds
nothing: the first call of a kernel wrapper (or :func:`build`) does.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
SOURCES = (
    "decode_attention.cu", "flash_attention.cu", "fused_ce.cu",
    "moe_dispatch.cu",
)
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's output per source of the last build in this process (ptxas
# register / shared-memory / spill lines).
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from source at first use"
        )
    return path


def library_path(source: str) -> Path:
    """The library of one source, named by a hash of that source and the
    flags. Each source is self-contained (it includes no header of its
    own; the TMA, mbarrier and wgmma helpers are copied into each file
    that uses them), so the source's bytes decide the build."""
    src = CSRC / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}_{digest}.so"


def build(sources: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together. Returns the seconds each build took
    (0.0 for a library that was already there); raises with nvcc's
    output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    started = {}
    seconds = {}
    for source in sources:
        out = library_path(source)
        if out.exists():
            seconds[source] = 0.0
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        started[source] = (proc, tmp, out, time.monotonic())
    for source, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{log}")
        os.replace(tmp, out)
        seconds[source] = time.monotonic() - t0
        build_logs[source] = log
    return seconds


def require_local(name: str, *tensors) -> None:
    """The kernels take plain local tensors: a DTensor raises
    ``TypeError`` (its storage is one shard of a global tensor; the
    caller hands the kernel ``to_local()``). ``None`` entries are
    skipped."""
    from torch.distributed.tensor import DTensor

    for t in tensors:
        if isinstance(t, DTensor):
            raise TypeError(
                f"{name} takes plain local tensors, got a DTensor "
                f"{tuple(t.shape)} {t.placements}")


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            build((source,))
            lib = ctypes.CDLL(str(library_path(source)))
            _libs[source] = lib
        return lib
