"""Process groups, rank processes and even shards of a leading axis.

Counterpart of ``elasticreconstruction_tpu/dist/mesh.py``. The reference
builds one device mesh over every chip and lets XLA place shards on it; here
each rank is a process with one group handle and one device, and every
distributed function takes both explicitly. Nothing here picks a backend or a
device on its own: NCCL without a card raises, it does not turn into gloo.

NCCL cannot place two ranks on one card, so ranks that share a card (a
one-card machine, the tests' CPU ranks) run under gloo.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import tempfile
import time
from typing import Callable, Sequence

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
DEFAULT_TIMEOUT_S = 600.0


def init_group(backend: str, world_size: int, rank: int, init_method: str,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> dist.ProcessGroup:
    """Join the default process group and return it.

    The counterpart of ``initialize_distributed``, which is a no-op at one
    process in the reference; here world size 1 still builds a real group, so
    that NCCL's collectives run on the card. ``init_method`` is a ``file://``
    or ``tcp://localhost:<port>`` address; collectives that wait longer than
    ``timeout_s`` raise instead of hanging.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is none of {BACKENDS}")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("backend 'nccl' needs a CUDA card but torch.cuda.is_available() is False; "
                           "ask for 'gloo' explicitly to run on the CPU")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.group.WORLD


def group_or_world(group: dist.ProcessGroup | None) -> dist.ProcessGroup:
    return dist.group.WORLD if group is None else group


def _rank_main(fn, rank, world_size, backend, device, init_method, out_path, timeout_s, threads, args):
    if threads is not None:
        torch.set_num_threads(threads)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    group = init_group(backend, world_size, rank, init_method, timeout_s)
    try:
        result = fn(rank, group, dev, *args)
    finally:
        dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(result, f)


def spawn_ranks(fn: Callable, world_size: int, backend: str, device: str | Sequence[str], *args,
                timeout_s: float = DEFAULT_TIMEOUT_S, threads: int | None = None) -> list:
    """Run ``fn(rank, group, device, *args)`` in ``world_size`` new processes
    and return each rank's result, in rank order.

    The processes start with the ``spawn`` method and meet at a ``file://``
    store in a temporary directory. ``device`` is one device for every rank
    (``"cpu"``, or ``"cuda:0"`` for ranks sharing one card) or one per rank.
    ``fn`` must be importable by name and its result picklable; it travels
    back through a file in the same directory. A rank that fails, or a run
    that outlasts ``timeout_s``, raises here after every process has ended.
    ``threads`` sets each rank's intra-op threads (default: torch's own).
    """
    devices = [device] * world_size if isinstance(device, str) else list(device)
    if len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        outs = [os.path.join(tmp, f"result_{r}.pkl") for r in range(world_size)]
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world_size, backend, devices[r], init_method,
                                                      outs[r], timeout_s, threads, args))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            # Until all have ended, the first rank to fail ends the run (the
            # others would wait for it in a collective), or the deadline does.
            while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                time.sleep(0.05)
        finally:
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        failed = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0 and r not in hung]
        if failed:
            raise RuntimeError(f"ranks failed (rank, exit code): {failed}; ranks {hung} were stopped")
        if hung:
            raise TimeoutError(f"ranks {hung} of {world_size} still ran after {timeout_s} s")
        results = []
        for path in outs:
            with open(path, "rb") as f:
                results.append(pickle.load(f))
    return results


def shard_bounds(n: int, group: dist.ProcessGroup | None = None, what: str = "batch") -> tuple[int, int]:
    """``[start, stop)`` of this rank's even block of a leading axis of ``n``
    rows; ``n`` must divide by the world size, as in the reference."""
    group = group_or_world(group)
    d, r = dist.get_world_size(group), dist.get_rank(group)
    if n % d != 0:
        raise ValueError(f"{what} {n} not divisible by world size {d}")
    per = n // d
    return r * per, (r + 1) * per


def shard_rows(x: torch.Tensor, group: dist.ProcessGroup | None = None, what: str = "batch") -> torch.Tensor:
    """This rank's even block of the leading axis of ``x``."""
    a, b = shard_bounds(x.shape[0], group, what)
    return x[a:b]


def pad_to_multiple(x: torch.Tensor, multiple: int, value=0) -> torch.Tensor:
    """``x`` with its leading axis padded by ``value`` rows up to a multiple of ``multiple``."""
    pad = (-x.shape[0]) % multiple
    if pad == 0:
        return x
    return torch.cat([x, x.new_full((pad, *x.shape[1:]), value)])
