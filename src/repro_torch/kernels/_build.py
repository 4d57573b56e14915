"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface.  At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/repro_torch_kernels/`` at the root of the checkout, named by a
hash of the sources so that an edited kernel is rebuilt, and loaded with
``ctypes``.  Nothing here runs at import time: the CPU tests import every
module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
KERNELS = ("minscan", "lw_step")

_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): nvcc is needed "
                           "to build the repro_torch kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):   # the .cu files and shared headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one kernel; ``None`` when its library exists."""
    out = _library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name}.cu:\n{log}")
    os.replace(tmp, out)     # atomic: a concurrent loader never sees half a file
    return log


def build_all() -> dict[str, str]:
    """Compile every kernel that is not built yet, one ``nvcc`` per source,
    all started together.  Returns each compiler log (empty when the
    library was already there)."""
    with _lock:
        started = {name: _start(name) for name in KERNELS}
        return {name: _finish(name, s) for name, s in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = _libs[name] = ctypes.CDLL(str(_library_path(name)))
        return lib


def check_cuda(ref, dtype, *others) -> None:
    """Raise unless ``ref`` has ``dtype`` and it and ``others`` are
    contiguous on the current CUDA device: the launch takes raw pointers."""
    import torch

    if ref.device.type != "cuda" or ref.device.index != torch.cuda.current_device():
        raise ValueError(f"the kernel runs on the current CUDA device, got {ref.device}")
    if ref.dtype != dtype:
        raise ValueError(f"expected {dtype}, got {ref.dtype}")
    for t in (ref, *others):
        if t.device != ref.device or not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous and on one device")
