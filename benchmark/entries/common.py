"""What the entries share: seeds, host syncs counted, a profiled region, the program's stdout."""

from __future__ import annotations

import contextlib
import sys
import time
import warnings

import numpy as np
import torch


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed drawn from ``seed`` and ``path`` (any whole numbers)."""
    return int(np.random.SeedSequence([int(seed) % (1 << 64), *path]).generate_state(1, np.uint64)[0] >> 1)


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def program_stdout_to_stderr():
    """The program logs JSON lines on stdout; the benchmark's stdout is its result alone."""
    with contextlib.redirect_stdout(sys.stderr):
        yield


def count_host_syncs(fn, device) -> int:
    """Host synchronisations one call of ``fn`` makes (``set_sync_debug_mode("warn")``)."""
    synchronize(device)
    if torch.device(device).type != "cuda":
        fn()
        return 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


def profiled(fn, device) -> dict:
    """Device operations of one call of ``fn``: its kernels, copies and sets, with the host's
    runtime calls beside them, and the host-clock length of the profiled window."""
    from benchmark import trace

    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        fn()
        return {"events": [], "runtime": [], "window_s": time.perf_counter() - t0}
    from torch.profiler import ProfilerActivity, profile

    synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        synchronize(device)
        window_s = time.perf_counter() - t0
    events, runtime = trace.kineto_events(prof)
    return {"events": events, "runtime": runtime, "window_s": window_s}


def timed(fn, device) -> float:
    """Host seconds of one call of ``fn``, synchronised on both sides."""
    synchronize(device)
    t0 = time.perf_counter()
    fn()
    synchronize(device)
    return time.perf_counter() - t0


def env_threads() -> None:
    """One intra-op thread: one process with steady load, no pool of spinning workers."""
    torch.set_num_threads(1)
