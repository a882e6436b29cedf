"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process (started
together, so a cold build costs the slowest file, not the sum) into a shared
library with a plain C interface under ``build/kernels/`` at the repository
root. The library name carries a hash of the sources, so an edited source is
rebuilt and a built one is reused. Nothing is built at import time: the CPU
test suite imports every module on a machine with no ``nvcc``.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` — the kernels' f32
distance arithmetic must round like the separate elementwise ops of their
plain PyTorch versions (see ``csrc/nn.cuh``). ``-Xptxas -v`` output (registers,
shared memory, spills) is kept in :data:`build_logs`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("nn", "icp_step")

build_logs: dict[str, str] = {}
_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built from source at first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def load(*names: str) -> list[ctypes.CDLL]:
    """Build (if needed, all in parallel) and load the named kernel libraries."""
    with _lock:
        todo = {n: _lib_path(n) for n in names if n not in _libs}
        procs = {}
        for n, path in todo.items():
            if path.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
        failed = []
        for n, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            build_logs[n] = out
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, todo[n])
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        for n, path in todo.items():
            _libs[n] = ctypes.CDLL(str(path))
        return [_libs[n] for n in names]


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def check_args(name: str, tensors: dict, dtypes: dict, shapes: dict) -> None:
    """Raise unless every tensor is contiguous, on one device, of its dtype and shape."""
    dev = next(iter(tensors.values())).device
    for key, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, expected {dev}")
        if t.dtype != dtypes[key]:
            raise TypeError(f"{name}: {key} has dtype {t.dtype}, expected {dtypes[key]}")
        if tuple(t.shape) != tuple(shapes[key]):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected {tuple(shapes[key])}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
