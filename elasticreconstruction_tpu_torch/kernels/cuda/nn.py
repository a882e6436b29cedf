"""Batched nearest-neighbour search: CUDA kernel ``csrc/nn.cu`` and its plain version.

Counterpart of ``elasticreconstruction_tpu/kernels/pallas/nn.py``. Contract
of :func:`nearest_batch` (both routes): for each batch ``b`` and query ``q``,
the minimum over refs of ``|q|^2 + (|r|^2 + off) - 2 q.r`` with ``off = 0`` for
valid refs and ``3e38`` for masked ones, clamped at 0, and the FIRST index
attaining it. A query whose refs are all masked gets ``(3e38, 0)``; callers
gate on their own radius, so this and ``kernels/knn.py``'s ``inf`` sentinel
behave the same downstream.

Arithmetic, the same in the kernel and in the plain version. Each ref is
packed once as ``(-2 rx, -2 ry, -2 rz, w)`` with
``w = ((rx*rx + ry*ry) + rz*rz) + off``, every operation rounded to f32 alone
(the scaling by -2 is exact). Per pair the key is three fused multiply-adds,

    key = fma(qx, -2 rx, fma(qy, -2 ry, fma(qz, -2 rz, w)))

the minimum and its first index are taken over the keys, and only then
``d2 = max(((qx*qx + qy*qy) + qz*qz) + key_min, 0)``. Adding ``|q|^2`` and
clamping after the minimum leaves the minimum where it was (both maps are
monotone) and costs nothing per pair. It differs from clamping first, as the
TPU kernel does, only where several keys fall below ``-|q|^2``: there this
contract picks the smallest key, the TPU kernel the first of them.

The plain version has no FMA instruction to call, so it forms each product in
float64, where the product of two f32 values is exact, adds in float64 and
rounds the sum to f32. That is the FMA's single rounding except when the
float64 sum lands exactly on the midpoint of two f32 values (about one
operation in 2^29), where the two can differ by one f32 ulp of the key.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build

BIG = 3.0e38

# Geometry of csrc/nn.cuh (checked against the built library at load).
THREADS = 128  # threads per block
QUERIES_PER_THREAD = 4
QUERIES_PER_BLOCK = THREADS * QUERIES_PER_THREAD
CHUNK = 32  # refs per argmin chunk; a block's ref range is a multiple of it
MAX_RANGE = 2048  # refs one block holds in shared memory (32 KB packed)
MIN_RANGE = 512  # do not split finer than this
# What a block costs beside its scan (set-up, second scan, merge), in refs
# scanned. With it plan() picks, at each shape the paths launch, a split that
# was among the fastest measured on an H100 (PERF.md).
BLOCK_OVERHEAD = 128

launches = 0  # kernel launches since the last reset (set to 0 to reset)
launches_by_shape: dict[tuple[int, int, int], int] = {}  # the same by (B, Nq, Nr); clear() to reset


class Plan(NamedTuple):
    """Launch geometry of one search: grid ``(tiles, splits, B)``."""

    tiles: int  # query tiles of QUERIES_PER_BLOCK per batch
    splits: int  # blocks that share one query tile, each over ``range`` refs
    range: int  # refs per block, a multiple of CHUNK


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def plan(b: int, nq: int, nr: int, sms: int) -> Plan:
    """The ref split under which the busiest SM has the least to do.

    A block serves one tile of ``QUERIES_PER_BLOCK`` queries over ``range``
    refs held in shared memory. With ``s`` splits the busiest SM gets
    ``ceil(B * tiles * s / sms)`` blocks of ``range + BLOCK_OVERHEAD`` refs'
    worth of work each; the split with the smallest such product wins, the
    coarser one on a tie. Many query tiles thus get the longest ranges
    ``MAX_RANGE`` allows, and few (the coarse ICP phase, small batches) a
    finer split that spreads them over the SMs, down to ``MIN_RANGE``. On an
    H100 the scan runs at nearly the same rate from two blocks per SM to
    sixteen (``tools/nn_probe.py``), so nothing is gained by more blocks.
    """
    tiles = _cdiv(nq, QUERIES_PER_BLOCK)
    best = None
    for splits in range(_cdiv(nr, MAX_RANGE), _cdiv(nr, MIN_RANGE) + 1):
        rng = _cdiv(_cdiv(nr, splits), CHUNK) * CHUNK
        load = _cdiv(b * tiles * splits, sms) * (rng + BLOCK_OVERHEAD)
        if best is None or load < best[0]:
            best = (load, Plan(tiles, _cdiv(nr, rng), rng))
    return best[1]


def _sqnorm(x: torch.Tensor) -> torch.Tensor:
    """``(x0*x0 + x1*x1) + x2*x2``: the kernel's order, each op rounded alone."""
    return x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2]


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of f32 tensors rounded once (see the module docstring)."""
    return (a.double() * b.double() + c.double()).float()


def nearest_batch_plain(
    query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor, *, block_q: int = 256
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, rounding for rounding (module docstring).

    Blocked over ``block_q`` queries so the (B, block_q, Nr) tiles stay small.
    """
    b, nq, _ = query.shape
    if ref.shape[1] == 0:
        raise ValueError("nearest_batch needs at least one reference point")
    qq = _sqnorm(query)
    w = (_sqnorm(ref) + (~ref_mask).to(torch.float32) * BIG)[:, None, :]  # (B, 1, Nr)
    r2 = (-2.0 * ref)[:, None, :, :]  # (B, 1, Nr, 3)
    d2 = torch.empty((b, nq), dtype=torch.float32, device=query.device)
    idx = torch.empty((b, nq), dtype=torch.int32, device=query.device)
    for s in range(0, nq, block_q):
        q = query[:, s : s + block_q, None, :]  # (B, bq, 1, 3)
        key = _fma(q[..., 2], r2[..., 2], w)
        key = _fma(q[..., 1], r2[..., 1], key)
        key = _fma(q[..., 0], r2[..., 0], key)
        kmin, imin = key.min(dim=-1)  # first index of the minimum
        d2[:, s : s + block_q] = (qq[:, s : s + block_q] + kmin).clamp_min(0.0)
        idx[:, s : s + block_q] = imin.to(torch.int32)
    return d2, idx


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_geometry(lib: ctypes.CDLL) -> None:
    """Raise unless the built library was compiled with this module's geometry."""
    lib.er_nn_geometry.argtypes = [ctypes.c_int]
    lib.er_nn_geometry.restype = ctypes.c_int
    got = tuple(lib.er_nn_geometry(k) for k in range(4))
    want = (THREADS, QUERIES_PER_THREAD, CHUNK, MAX_RANGE)
    if got != want:
        raise RuntimeError(f"csrc/nn.cuh geometry {got} differs from kernels/cuda/nn.py {want}")


def search_scratch(device: torch.device, b: int, geo: Plan, extra_floats: int = 0, extra_counters: int = 0):
    """Scratch of one launch: per-split partial results (key and index per padded
    query), then ``extra_floats``; and the zeroed ticket counters, one per
    (batch, query tile), then ``extra_counters``."""
    partial = b * geo.splits * geo.tiles * QUERIES_PER_BLOCK
    return (build.scratch(device, 2 * partial + extra_floats),
            build.counters(device, b * geo.tiles + extra_counters))


def _count_launch(shape: tuple[int, int, int]) -> None:
    global launches
    launches += 1
    launches_by_shape[shape] = launches_by_shape.get(shape, 0) + 1


@functools.lru_cache(maxsize=None)
def _kernel():
    (lib,) = build.load("nn")
    check_geometry(lib)
    fn = lib.er_nearest_batch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def nearest_batch(
    query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-batch nearest reference point: ``query (B, Nq, 3)``, ``ref (B, Nr, 3)``,
    ``ref_mask (B, Nr)`` -> (sqdist ``(B, Nq)`` f32, index ``(B, Nq)`` int32).

    CUDA tensors launch ``csrc/nn.cu`` (one launch); CPU tensors run
    :func:`nearest_batch_plain`. Any other device raises. The kernel's scratch
    is cached per device (``build.scratch``): launches of one device must stay
    on one stream.
    """
    if query.device.type == "cpu":
        return nearest_batch_plain(query, ref, ref_mask)
    if query.device.type != "cuda":
        raise ValueError(f"nearest_batch: unsupported device {query.device}")
    b, nq, _ = query.shape
    nr = ref.shape[1]
    build.check_args(
        "nearest_batch",
        {"query": query, "ref": ref, "ref_mask": ref_mask},
        {"query": torch.float32, "ref": torch.float32, "ref_mask": torch.bool},
        {"query": (b, nq, 3), "ref": (b, nr, 3), "ref_mask": (b, nr)},
    )
    if nr == 0:
        raise ValueError("nearest_batch needs at least one reference point")
    d2 = torch.empty((b, nq), dtype=torch.float32, device=query.device)
    idx = torch.empty((b, nq), dtype=torch.int32, device=query.device)
    if b * nq == 0:
        return d2, idx
    fn = _kernel()
    geo = plan(b, nq, nr, sm_count(query.device.index))
    scratch, counters = search_scratch(query.device, b, geo)
    err = fn(
        query.data_ptr(), ref.data_ptr(), ref_mask.data_ptr(), d2.data_ptr(), idx.data_ptr(),
        scratch.data_ptr(), counters.data_ptr(), b, nq, nr, geo.splits, geo.range,
        torch.cuda.current_stream(query.device).cuda_stream,
    )
    build.check(err, "nearest_batch")
    _count_launch((b, nq, nr))
    return d2, idx


def nearest(
    query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Unbatched wrapper over :func:`nearest_batch`."""
    d2, idx = nearest_batch(query[None], ref[None], ref_mask[None])
    return d2[0], idx[0]
