"""What bounds the nearest-neighbour scan of ``csrc/nn.cuh`` on one NVIDIA GPU.

    python -m elasticreconstruction_tpu_torch.tools.nn_probe

Two measurements, one JSON line each, CUDA-event device times of launches
queued back to back behind a spinning kernel:

1. ``occupancy``: ``nearest_batch`` with one batch, 2048 refs (one block per
   query tile, no ref split) and as many query tiles as give 1, 2, 4, 8 and 16
   blocks per SM. Reports the pairs per clock and SM and, from the
   ``INSTRUCTIONS_PER_PAIR`` of the compiled loop, the instructions executed per
   clock and scheduler. If the rate stops rising with the blocks per SM, the
   scan is bound by its instruction stream, not by latency.
2. ``ffma_operands``: the probe kernel ``ffma_operands.cu``, built here with
   nvcc: FFMAs per clock and scheduler when an FFMA reads one, about two, or
   three registers that the instruction before it did not read in the same
   operand slot.

Needs one CUDA card and nvcc; without a card it raises.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..core.types import resolve_device
from ..kernels.cuda import build, nn

# The compiled ref scan: 560 instructions per 128 pairs (cuobjdump -sass, as
# chip_smoke.py prints it).
INSTRUCTIONS_PER_PAIR = 4.375
BLOCKER_CYCLES = 10_000_000  # a spinning kernel of about 5 ms ahead of each timed run
SCHEDULERS_PER_SM = 4


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one ``fn()`` in ms: ``reps`` calls queued behind a spinning kernel."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(BLOCKER_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def sm_clock_hz(dev: torch.device) -> float:
    """The SM clock in Hz that nvidia-smi reports right after half a second of
    work: an idle card reports its idle clock."""
    x = torch.rand((4096, 4096), device=dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.5:
        for _ in range(50):
            x = x * 1.0000001
        torch.cuda.synchronize()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return float(smi.stdout.split()[0]) * 1e6


def occupancy(dev: torch.device, clock_hz: float) -> list[dict]:
    sms = nn.sm_count(dev.index)
    rng = np.random.default_rng(0)
    nr = nn.MAX_RANGE
    ref = torch.from_numpy(rng.uniform(-1.5, 1.5, (1, nr, 3)).astype(np.float32)).to(dev)
    mask = torch.ones((1, nr), dtype=torch.bool, device=dev)
    rows = []
    for per_sm in (1, 2, 4, 8, 16):
        nq = nn.QUERIES_PER_BLOCK * sms * per_sm
        geo = nn.plan(1, nq, nr, sms)
        if geo.splits != 1:
            raise RuntimeError(f"nn_probe: expected no ref split at {nr} refs, got {geo}")
        query = torch.from_numpy(rng.uniform(-1.5, 1.5, (1, nq, 3)).astype(np.float32)).to(dev)
        ms = device_ms(lambda: nn.nearest_batch(query, ref, mask))
        pairs_per_clock_sm = nq * nr / sms / (ms * 1e-3 * clock_hz)
        rows.append({
            "blocks_per_sm": per_sm, "ms": ms, "pairs_per_clock_per_sm": pairs_per_clock_sm,
            "instructions_per_clock_per_scheduler": pairs_per_clock_sm * INSTRUCTIONS_PER_PAIR / 32 / SCHEDULERS_PER_SM,
        })
    return rows


def ffma_operands(dev: torch.device, clock_hz: float, blocks_per_sm: int = 8, iters: int = 2000) -> list[dict]:
    src = Path(__file__).with_name("ffma_operands.cu")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = build.BUILD_DIR / "libffma_operands.so"
    subprocess.run(
        [build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
         "-shared", "-Xcompiler", "-fPIC", "-o", str(lib_path), str(src)],
        check=True,
    )
    fn = ctypes.CDLL(str(lib_path)).er_ffma_operands
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = nn.sm_count(dev.index) * blocks_per_sm
    x = torch.rand(1024, device=dev) * 1e-3
    out = torch.empty(blocks * 128, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    warp_ffmas_per_scheduler = blocks_per_sm * 4 / SCHEDULERS_PER_SM * iters * 128
    rows = []
    for mode, reads in enumerate(("one", "one", "about two", "three")):
        def launch(mode=mode):
            build.check(fn(mode, x.data_ptr(), out.data_ptr(), blocks, iters, stream), "ffma_operands")

        ms = device_ms(launch, reps=5)
        rows.append({"mode": mode, "fresh_register_reads": reads, "ms": ms,
                     "ffma_per_clock_per_scheduler": warp_ffmas_per_scheduler / (ms * 1e-3 * clock_hz)})
    return rows


def main() -> int:
    dev = resolve_device("cuda")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    clock_hz = sm_clock_hz(dev)
    print(json.dumps({"sm_clock_hz": clock_hz}))
    print(json.dumps({"occupancy": occupancy(dev, clock_hz)}))
    print(json.dumps({"ffma_operands": ffma_operands(dev, clock_hz)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
