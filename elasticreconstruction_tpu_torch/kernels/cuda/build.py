"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process (started
together, so a cold build costs the slowest file, not the sum) into a shared
library with a plain C interface under ``build/kernels/`` at the repository
root. The library name carries a hash of the sources, so an edited source is
rebuilt and a built one is reused. Nothing is built at import time: the CPU
test suite imports every module on a machine with no ``nvcc``.

Flags: ``sm_90a`` (Hopper) and ``-O3`` for every source, plus the flags
:data:`SOURCE_FLAGS` names for each. ``nn``, ``icp_step``, ``raycast``,
``gn_step`` and ``tsdf_fuse`` take ``-fmad=false``: nvcc contracts no multiply and add of theirs on its own,
so every operation rounds as the plain PyTorch versions say it does; the three
fused multiply-adds of the distance key are asked for by name (``__fmaf_rn``,
see ``csrc/nn.cuh``), and the plain version mirrors them. ``calib`` takes ``-fmad=true``: its FMA chain exists to execute fused
multiply-adds, and under ``-fmad=false`` it would execute a multiply and an add
and measure half the rate. ``-Xptxas -v`` output (registers, shared memory,
spills) is kept in :data:`build_logs`.

Every kernel is declared here as a :class:`Kernel`, launched and counted
through it (:data:`launches`) and routed to by :func:`on_card`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Per-source flags: whether nvcc may contract a*b+c into one FMA.
SOURCE_FLAGS = {
    "nn": ("-fmad=false",),
    "icp_step": ("-fmad=false",),
    "raycast": ("-fmad=false",),
    "gn_step": ("-fmad=false",),
    "tsdf_fuse": ("-fmad=false",),
    "calib": ("-fmad=true",),
}
SOURCES = tuple(SOURCE_FLAGS)

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


def nvcc_flags(name: str) -> tuple[str, ...]:
    """The full nvcc flag tuple of ``csrc/<name>.cu``."""
    return NVCC_FLAGS + SOURCE_FLAGS[name]


def lib_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built: named by a hash of its
    source, the shared headers and its flags."""
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def load(*names: str) -> list[ctypes.CDLL]:
    """Build (if needed, all in parallel) and load the named kernel libraries."""
    with _lock:
        todo = {n: lib_path(n) for n in names if n not in _libs}
        procs = {}
        for n, path in todo.items():
            if path.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *nvcc_flags(n), "-o", str(tmp), str(CSRC / f"{n}.cu")]
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


_scratch: dict[torch.device, torch.Tensor] = {}
_counters: dict[torch.device, torch.Tensor] = {}


def _cached(cache: dict, device: torch.device, n: int, dtype, make) -> torch.Tensor:
    buf = cache.get(device)
    if buf is None or buf.numel() < n:
        buf = cache[device] = make(max(n, 1), dtype=dtype, device=device)
    return buf


def scratch(device: torch.device, floats: int) -> torch.Tensor:
    """At least ``floats`` f32 of uninitialised device scratch, kept per device
    and grown on demand. Kernels of one device share it, so their launches must
    stay on one stream, where they run one after the other."""
    return _cached(_scratch, device, floats, torch.float32, torch.empty)


def counters(device: torch.device, ints: int) -> torch.Tensor:
    """At least ``ints`` int32 ticket counters, all zero, kept per device. A
    kernel that counts arrivals on them sets each back to 0 before it ends."""
    return _cached(_counters, device, ints, torch.int32, torch.zeros)


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def bind(lib: ctypes.CDLL, symbol: str, argtypes: list):
    """``lib.<symbol>`` with its ``argtypes`` and an ``int`` return declared."""
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


# Launches since the last reset_launches(): by kernel name, and by name and shape.
launches: dict[str, int] = {}
launches_by_shape: dict[str, dict[tuple, int]] = {}


def reset_launches() -> None:
    """Zero every count in place (the dicts stay the same objects)."""
    for name in launches:
        launches[name] = 0
    for shapes in launches_by_shape.values():
        shapes.clear()


class Kernel:
    """The launch function ``er_<name>`` of ``csrc/<source>.cu``, declared once.

    ``argtypes`` are the C types of its arguments but the last, the CUDA
    stream. Nothing is built before the first launch (or :attr:`lib`), which
    loads the library, runs ``on_load(lib)`` once and binds the function. A
    launch raises through :func:`check` on a non-zero return and is counted
    under ``name`` in :data:`launches`, and under ``shape`` too, when given,
    in :data:`launches_by_shape`.
    """

    def __init__(self, source: str, name: str, argtypes: list, *, on_load=None):
        self.source, self.name, self.argtypes, self.on_load = source, name, argtypes, on_load
        self._lib = self._fn = None
        launches.setdefault(name, 0)
        self.by_shape = launches_by_shape.setdefault(name, {})

    def _bind(self):
        (lib,) = load(self.source)
        if self.on_load is not None:
            self.on_load(lib)
        self._lib, self._fn = lib, bind(lib, f"er_{self.name}", [*self.argtypes, ctypes.c_void_p])
        return self._fn

    @property
    def lib(self) -> ctypes.CDLL:
        """The loaded library, for its helper symbols that are not launches."""
        if self._fn is None:
            self._bind()
        return self._lib

    def __call__(self, device: torch.device, *args, shape: tuple | None = None) -> None:
        """Launch with ``args`` on the current stream of ``device``."""
        self.launch(*args, torch.cuda.current_stream(device).cuda_stream, shape=shape)

    def launch(self, *args, shape: tuple | None = None) -> None:
        """Launch with ``args``, the stream last among them."""
        fn = self._fn or self._bind()
        check(fn(*args), self.name)
        launches[self.name] += 1
        if shape is not None:
            self.by_shape[shape] = self.by_shape.get(shape, 0) + 1


def on_card(t: torch.Tensor, op: str) -> bool:
    """The route rule: ``False`` for a CPU tensor (run the plain version),
    ``True`` for a CUDA tensor (launch the kernel); any other device raises."""
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{op}: unsupported device {t.device}")
    return kind == "cuda"


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
