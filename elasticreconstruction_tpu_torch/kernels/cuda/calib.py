"""Calibration microkernels: CUDA kernels ``csrc/calib.cu`` and their plain versions.

Counterparts of the three Pallas kernels that ``kernels_bench.py::calibrate``
builds to measure the vector unit's rates. Each takes a float32 tensor of any
shape, carries :data:`CHAINS` independent chains per element through ``iters``
iterations and returns the sum of the chains, same shape:

- :func:`fma_chain` (``fma_kernel``, ``kernels_bench.py:162-173``):
  ``a_c <- a_c * (1 + 1e-7 (c + 1)) + 1e-7``. The kernel executes one fused
  multiply-add per step, which rounds once; the plain version multiplies and
  adds, rounding twice, so the two differ by up to ~2^-24 relative per step
  (64 x 2^-24 = 3.8e-6 over a chain; the callers allow 1e-5).
- :func:`where_chain` (``cmp_kernel``, ``:206-220``):
  ``a_c <- where(a_c > 0.5 + 1e-4 k, y, a_c)``: exact selects.
- :func:`threshold_sum_chain` (``ts_kernel``, ``:251-267``):
  ``a_c <- a_c + float((x > 0.2) & (x >= 0.4 + 1e-4 k + 1e-3 c))``: compare,
  and, convert, add. Adding 0 or 1 rounds the same way in both versions.

The last two agree with their plain versions bit for bit. All three are bound
by operations: 8 bytes move per element against ``2 * 8 * iters`` flop
(1024 at ``iters = 64``, against the card's ~20 flop/byte ridge).

CUDA tensors launch the kernel; CPU tensors run the plain version; any other
device raises. ``launches`` counts kernel launches per function.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from . import build

CHAINS = 8
UNROLL = 4  # iterations per loop body in csrc/calib.cu; iters must be a multiple

# f32 lane-instructions the arithmetic of each function needs, counted from the
# source and not from the compiler's output (loop counters and branches are
# overhead, not work). Per chain step: one fused multiply-add; a compare and a
# select; or the chain's threshold offset (add), compare (the ``and`` with the
# loop-invariant mask rides on its predicate), 0/1 select and add.
STEP_INSTRUCTIONS = {"fma_chain": 1, "where_chain": 2, "threshold_sum_chain": 4}
# Per iteration, shared by the chains: the threshold ``t_k`` (convert k,
# multiply, add). The FMA chain's constants do not depend on k.
SHARED_INSTRUCTIONS = {"fma_chain": 0, "where_chain": 3, "threshold_sum_chain": 3}


def lane_instructions(name: str, iters: int = 64) -> int:
    """f32 lane-instructions one element of ``name`` needs over ``iters`` iterations."""
    return (CHAINS * STEP_INSTRUCTIONS[name] + SHARED_INSTRUCTIONS[name]) * iters


# Kernel launches since the last reset, per wrapper (set an entry to 0 to reset).
launches = {"fma_chain": 0, "where_chain": 0, "threshold_sum_chain": 0}

_KERNEL_OF = {
    "fma_chain": "fma_chain_kernel",
    "where_chain": "where_chain_kernel",
    "threshold_sum_chain": "threshold_sum_chain_kernel",
}


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def _start(x: torch.Tensor) -> list[torch.Tensor]:
    return [x + _f32(1e-5 * c).to(x.device) for c in range(CHAINS)]


def _total(chains: list[torch.Tensor]) -> torch.Tensor:
    out = chains[0]
    for a in chains[1:]:
        out = out + a
    return out


def fma_chain_plain(x: torch.Tensor, iters: int = 64) -> torch.Tensor:
    """Plain PyTorch version of :func:`fma_chain`: a multiply and an add per step."""
    chains = _start(x)
    mul = [_f32(1.0 + 1e-7 * (c + 1)).to(x.device) for c in range(CHAINS)]
    add = _f32(1e-7).to(x.device)
    for _ in range(iters):
        chains = [a * mul[c] + add for c, a in enumerate(chains)]
    return _total(chains)


def where_chain_plain(x: torch.Tensor, y: torch.Tensor, iters: int = 64) -> torch.Tensor:
    """Plain PyTorch version of :func:`where_chain`."""
    chains = _start(x)
    for k in range(iters):
        t = float(np.float32(0.5) + np.float32(1e-4) * np.float32(k))
        chains = [torch.where(a > t, y, a) for a in chains]
    return _total(chains)


def threshold_sum_chain_plain(x: torch.Tensor, iters: int = 64) -> torch.Tensor:
    """Plain PyTorch version of :func:`threshold_sum_chain`."""
    chains = _start(x)
    m = x > 0.2
    for k in range(iters):
        t = np.float32(0.4) + np.float32(1e-4) * np.float32(k)
        chains = [
            a + (m & (x >= float(t + np.float32(1e-3 * c)))).to(torch.float32)
            for c, a in enumerate(chains)
        ]
    return _total(chains)


def _kernel(name: str, pointers: int):
    (lib,) = build.load("calib")
    fn = getattr(lib, f"er_{name}")
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, plain, inputs: dict[str, torch.Tensor], iters: int) -> torch.Tensor:
    x = inputs["x"]
    if iters < 0 or iters % UNROLL:
        raise ValueError(f"{name}: iters must be a non-negative multiple of {UNROLL}, got {iters}")
    if x.device.type == "cpu":
        return plain(*inputs.values(), iters)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    build.check_args(name, inputs, dict.fromkeys(inputs, torch.float32), dict.fromkeys(inputs, x.shape))
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    err = _kernel(name, len(inputs) + 1)(
        *(t.data_ptr() for t in inputs.values()), out.data_ptr(), x.numel(), iters,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, name)
    launches[name] += 1
    return out


def fma_chain(x: torch.Tensor, iters: int = 64) -> torch.Tensor:
    """Eight FMA chains per element of ``x`` (float32, contiguous), summed."""
    return _launch("fma_chain", fma_chain_plain, {"x": x}, iters)


def where_chain(x: torch.Tensor, y: torch.Tensor, iters: int = 64) -> torch.Tensor:
    """Eight compare+select chains per element of ``x``, selecting ``y``, summed."""
    return _launch("where_chain", where_chain_plain, {"x": x, "y": y}, iters)


def threshold_sum_chain(x: torch.Tensor, iters: int = 64) -> torch.Tensor:
    """Eight masked threshold-count chains per element of ``x``, summed."""
    return _launch("threshold_sum_chain", threshold_sum_chain_plain, {"x": x}, iters)


# ---- reading the built library's SASS -------------------------------------

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P(?:\d+|T)\s+)?([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)\s*([^;]*);")
_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)", re.M)


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    beside_nvcc = Path(build._nvcc()).with_name("cuobjdump")
    if beside_nvcc.exists():
        return str(beside_nvcc)
    raise RuntimeError("cuobjdump not found: it ships with the CUDA toolkit beside nvcc")


def loop_body_counts(sass: str) -> dict[str, dict[str, int]]:
    """Per kernel of a ``cuobjdump -sass`` listing: the opcode counts of its loop body.

    The loop body is the span from the target of the kernel's last backward
    branch to that branch. Keys are kernel names as mangled by nvcc; each value
    maps an opcode (``FFMA``, ``FSETP``, ``FSEL``, ...) to its count, with
    ``"total"`` for all instructions of the body.
    """
    out: dict[str, dict[str, int]] = {}
    marks = list(_FUNC.finditer(sass))
    for n, mark in enumerate(marks):
        text = sass[mark.end() : marks[n + 1].start() if n + 1 < len(marks) else len(sass)]
        instrs = [(int(a, 16), op, args) for a, op, _, args in _INSTR.findall(text)]
        span = None
        for addr, op, args in instrs:
            target = re.search(r"0x([0-9a-f]+)", args) if op == "BRA" else None
            if target and int(target.group(1), 16) < addr:
                span = (int(target.group(1), 16), addr)
        if span is None:
            continue
        counts: dict[str, int] = {"total": 0}
        for addr, op, _ in instrs:
            if span[0] <= addr <= span[1]:
                counts[op] = counts.get(op, 0) + 1
                counts["total"] += 1
        out[mark.group(1)] = counts
    return out


def sass_counts() -> dict[str, dict[str, int]]:
    """Opcode counts of each microkernel's loop body (``UNROLL`` iterations of
    ``CHAINS`` chains), read from the built library with ``cuobjdump -sass``.

    Keys are the wrapper names; builds the library if needed.
    """
    build.load("calib")
    proc = subprocess.run(
        [_cuobjdump(), "-sass", str(build.lib_path("calib"))],
        capture_output=True, text=True, timeout=120, check=True,
    )
    by_kernel = loop_body_counts(proc.stdout)
    out = {}
    for name, kernel in _KERNEL_OF.items():
        found = [v for k, v in by_kernel.items() if kernel in k]
        if len(found) != 1:
            raise RuntimeError(f"calib SASS: expected one loop in {kernel}, found {len(found)}")
        out[name] = found[0]
    return out
