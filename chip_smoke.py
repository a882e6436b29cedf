#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA versions.
2. Build: compiles every hand-written kernel from ``csrc/`` (one nvcc each, in
   parallel).
3. Kernel parity: each kernel against its plain PyTorch version on the card,
   plus CUDA-event times of the kernel, the plain version and, where there is
   one, a library yardstick. The two pipeline kernels are held at every shape
   the paths launch them at (``NN_SHAPES``, ``ICP_SHAPES``, with a partly
   masked ref set) and at ragged ones: sizes that are multiples of nothing,
   fewer refs than one chunk, one batch, refs all masked (which must give
   (3e38, 0)) and duplicated refs (the first index must win). Every call is
   made twice and must give the same bits. Their compiled main loop's opcode
   counts per pair are printed. The compare+select and threshold-sum chains must
   equal their plain versions bit for bit; the FMA chain within 2e-5 relative
   (one rounding per step against the plain version's two, 64 steps).
4. Registration path at full width: 6 fragments of 20 000 points (the registration
   benchmark's scene), ``prep_fragments_batch`` and ``register_prepped_batch``
   with ``RegistrationConfig()`` defaults over all 15 pairs x4 in 4 batches of
   16, ``refine_edges_batch`` on the 5 adjacent pairs and one more batch with
   ``fused_step=True``; every adjacent pair must register within 2 cm / 0.02 rad
   of ground truth and both kernels' launch counts must be > 0. Then the same
   small scene registered on the card and on the CPU (plain versions) must agree,
   and the ``loop.log``/``loop.info`` files must read back.
5. Calibration path: ``kernels_bench_gpu.calibrate`` at full shape (the
   opcode counts of the calibration kernels' SASS loop bodies, FFMA / FSETP /
   FSEL ..., which must show the FMA chain executing one FFMA per step; one JSON
   line of peaks, each with its share of the data sheet; a peak over 105% of
   the data sheet fails) and ``bench_kernels`` for ``nn``, ``icp``, ``fpfh``
   and ``voxel`` (one JSON line of scored entries).
6. Stage path: 24 fragments of 20 000 points written as fragment artifacts,
   then the ``register`` and ``posegraph`` CLI verbs at the default
   configuration; every odometry edge and every accepted loop edge two
   fragments apart within 2 cm / 0.02 rad of ground truth (measured at the
   fragment's centroid), no aliased loop edge kept. ``pose.log`` is held to
   ground truth twice: as the verb writes it, within 2 cm + 1% of the
   distance from fragment 0, and after ``run_posegraph`` with 32 Gauss-Newton
   steps per alternation instead of 8, within 5 cm at every fragment (see
   ``POSE_LOG_*`` below for why the two differ).
7. One JSON line of per-kernel numbers, then the last line
   ``{"ok": true, "device": {...}}``.

Each path runs with every kernel's launch count set to 0 just before it and
read just after; a kernel of a path that was never launched there fails the run.

Imports nothing of JAX or of the JAX package. Needs one CUDA card; without
one, or outside a checkout of the repository, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores
# and HBM3 bandwidth. The bounds below are the larger of ops/peak and bytes/peak.
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# f32 operations per (query, ref) distance evaluation of the NN search:
# 3 mul + 2 add (dot), 1 add (|q|^2 + |r|^2), 1 sub (- 2 dot), 1 min.
NN_OPS_PER_PAIR = 8
# Per-query epilogue of the fused ICP step: gather, residual, J, 29 weighted sums.
ICP_OPS_PER_QUERY = 80

# f32 lane-instructions per second: one per FMA of the f32 peak.
LANE_INSTR_PER_S = FP32_FLOPS / 2

GT_TRANSLATION_M = 0.02
GT_ROTATION_RAD = 0.02
# pose.log against ground truth, aligned at fragment 0, at each fragment's
# centroid. The scene is an open strip (fragment f lies 0.8 f m along it) whose
# aliased loop candidates bend the chain in the first line-process alternation;
# once they are pruned, the default 8 damped Gauss-Newton steps per alternation
# do not bring the chain's weakest mode (its overall bend) all the way back,
# in the reference implementation as here: on the same registration files both
# leave the same centimetres at the far end. With 32 steps the optimisation
# has converged and the result is that of the edges alone. So the verb's
# pose.log gets a bound relative to the distance from fragment 0 (20.4 cm at
# fragment 23, 18.4 m out, where runs of this scene left 3.1 to 13.0 cm), and
# the converged one the absolute bound.
POSE_LOG_DEFAULT_M = 0.02
POSE_LOG_DEFAULT_PER_M = 0.01
FRAGMENT_SPACING_M = 0.8
POSE_LOG_CONVERGED_M = 0.05
CONVERGED_INNER_ITERATIONS = 32
# FMA chain against its plain version: the kernel rounds once per step, the
# plain version twice (multiply, add), each up to 2^-24 relative, over 64
# steps whose multiplier 1 + k ulp rounds the same way every step: up to
# ~3 * 64 * 2^-24 = 1.1e-5.
FMA_CHAIN_RTOL = 2e-5
CALIB_PARITY_SHAPE = (4096, 512)


_T0 = time.perf_counter()


def phase_done(name: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f} s] {name} done", flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


# A kernel that spins this many clock cycles (about 5 ms) is queued ahead of a
# timed run, so that the host queues the whole run while the card is still busy.
BLOCKER_CYCLES = 10_000_000


def cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Device time of one ``fn()`` in ms: ``reps`` calls queued back to back behind
    a spinning kernel, between two CUDA events, after ``warmup`` calls. The
    host's time to queue a call is hidden as long as it is shorter than the
    blocker plus the calls before it."""
    for _ in range(warmup):
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


def call_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median ms of one ``fn()`` on an idle card, between two CUDA events: the
    device time plus the host's time to reach the launch (the wrapper)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(ops: float, nbytes: float, ops_per_s: float = FP32_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = ops / ops_per_s * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def surface(rng: np.random.Generator, shape: tuple) -> tuple[np.ndarray, np.ndarray]:
    """Points and unit normals on the benchmark's height field z = f(x, y)."""
    x = rng.uniform(-1.5, 1.5, shape)
    y = rng.uniform(-1.5, 1.5, shape)
    z = 0.35 * np.sin(2.3 * x) * np.cos(1.7 * y) + 0.2 * np.sin(4.1 * y) + 0.12 * np.cos(5.3 * x)
    fx = 0.35 * 2.3 * np.cos(2.3 * x) * np.cos(1.7 * y) - 0.12 * 5.3 * np.sin(5.3 * x)
    fy = -0.35 * 1.7 * np.sin(2.3 * x) * np.sin(1.7 * y) + 0.2 * 4.1 * np.cos(4.1 * y)
    n = np.stack([-fx, -fy, np.ones_like(x)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return np.stack([x, y, z], -1).astype(np.float32), n.astype(np.float32)


def phase_device() -> dict:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}, "
          f"count {torch.cuda.device_count()}")
    return {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}


def phase_build() -> None:
    """Build every kernel library, one nvcc per source, all started together."""
    from elasticreconstruction_tpu_torch.kernels.cuda import build

    t0 = time.perf_counter()
    build.load(*build.SOURCES)
    print(f"build: {time.perf_counter() - t0:.2f} s for {', '.join(build.SOURCES)}")
    for name, log in build.build_logs.items():
        info = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln or "Compiling entry function" in ln]
        print(f"  ptxas {name}: " + " | ".join(info))


# (B, Nq, Nr) of nearest_batch on the paths: coarse ICP, fine ICP and the
# information-matrix query of a 16-pair batch; coarse and fine of the stage
# path's 8-pair batches. The first of each list is the one the kernels line reports.
NN_SHAPES = [(16, 4096, 8192), (16, 1024, 8192), (16, 8192, 8192), (8, 1024, 8192), (8, 4096, 8192)]
ICP_SHAPES = [(16, 4096, 8192), (16, 1024, 8192), (8, 1024, 8192), (8, 4096, 8192)]
# Multiples of nothing; fewer refs than one chunk; one batch.
RAGGED_SHAPES = [(3, 1000, 5003), (2, 700, 20), (1, 4096, 8192)]
ICP_MAX_DIST = 0.075


def nn_inputs(rng, b: int, nq: int, nr: int, dev):
    ref, _ = surface(rng, (b, nr))
    query, _ = surface(rng, (b, nq))
    query += rng.normal(0.0, 0.01, query.shape).astype(np.float32)
    mask = np.ones((b, nr), bool)
    mask[:, int(nr * 0.9):] = False  # a fixed-capacity cloud's padding rows
    mask &= rng.uniform(size=(b, nr)) > 0.02
    return (torch.from_numpy(query).to(dev), torch.from_numpy(ref).to(dev),
            torch.from_numpy(mask).to(dev))


def twice(what: str, fn) -> tuple:
    """``fn()`` called twice; fails unless both calls return the same bits."""
    first = fn()
    second = fn()
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        if not torch.equal(x, y):
            fail(f"{what}: two calls on the same inputs differ")
    return first


def check_nearest(q, r, m, *, time_plain: bool = False, note: str = "") -> dict:
    from elasticreconstruction_tpu_torch.kernels.cuda import nn

    b, nq, nr = q.shape[0], q.shape[1], r.shape[1]
    name = f"nearest_batch {(b, nq, nr)}{note}"
    d_k, i_k = twice(name, lambda: nn.nearest_batch(q, r, m))
    d_p, i_p = nn.nearest_batch_plain(q, r, m)
    torch.cuda.synchronize()
    bad = (i_k != i_p).nonzero()
    if len(bad):
        # Allowed only where the two candidates are a near-tie in exact arithmetic.
        bq = q[bad[:, 0], bad[:, 1]].double()
        rk = r[bad[:, 0], i_k[bad[:, 0], bad[:, 1]].long()].double()
        rp = r[bad[:, 0], i_p[bad[:, 0], bad[:, 1]].long()].double()
        gap = (((bq - rk) ** 2).sum(-1) - ((bq - rp) ** 2).sum(-1)).abs().max().item()
        if gap >= 1e-6:
            fail(f"{name}: {len(bad)} index mismatches, exact d2 gap {gap:.3g} >= 1e-6")
    err = (d_k - d_p).abs().max().item()
    geo = nn.plan(b, nq, nr, nn.sm_count(q.device.index))
    print(f"{name}: index mismatches {len(bad)}, max |d2 kernel - plain| {err:.3g}, twice the same bits; "
          f"grid {(geo.tiles, geo.splits, b)} of {nn.THREADS} threads, {geo.range} refs = "
          f"{16 * geo.range} bytes of dynamic shared memory a block")
    if not err <= 1e-5:
        fail(f"{name}: max |d2 kernel - plain| {err} > 1e-5")
    r_far = torch.where(m[..., None], r, 1e18)  # masked refs never win the yardstick's min
    ms = cuda_ms(lambda: nn.nearest_batch(q, r, m))
    one_call = call_ms(lambda: nn.nearest_batch(q, r, m))
    plain = cuda_ms(lambda: nn.nearest_batch_plain(q, r, m), reps=3, warmup=1) if time_plain else None
    lib = cuda_ms(lambda: torch.cdist(q, r_far, compute_mode="use_mm_for_euclid_dist").min(dim=-1), reps=5)
    bnd, by = bound_ms(NN_OPS_PER_PAIR * b * nq * nr, 4 * 3 * b * (nq + nr) + b * nr + 8 * b * nq)
    print(f"  ms kernel {ms:.4f} (one call on an idle card, wrapper included: {one_call:.4f}), "
          f"plain {'not timed' if plain is None else f'{plain:.4f}'}, "
          f"cdist+min {lib:.4f}, bound {bnd:.4f} ({by}), time/bound {ms / bnd:.2f}")
    return {"max_abs_err": err, "ms": ms, "call_ms": one_call, "plain_ms": plain, "library_ms": lib,
            "bound_ms": bnd, "bound_by": by, "shape": [b, nq, nr], "index_mismatches": len(bad),
            "d2": d_k, "idx": i_k}


def icp_inputs(rng, b: int, n: int, m: int, dev) -> list:
    dst, nrm = surface(rng, (b, m))
    p, _ = surface(rng, (b, n))
    p += rng.normal(0.0, 0.02, p.shape).astype(np.float32)
    mask = np.ones((b, m), bool)
    mask[:, int(m * 0.9):] = False
    w = (rng.uniform(size=(b, n)) > 0.05).astype(np.float32)
    return [torch.from_numpy(x).to(dev) for x in (p, w, dst, nrm, mask)]


def check_normal_eqs(args: list, *, time_plain: bool = False, note: str = "") -> dict:
    from elasticreconstruction_tpu_torch.kernels.cuda import icp_step

    b, n, m = args[0].shape[0], args[0].shape[1], args[2].shape[1]
    name = f"normal_eqs_batch {(b, n, m)}{note}"
    H1, g1, n1, wrr1 = twice(name, lambda: icp_step.normal_eqs_batch(*args, max_dist=ICP_MAX_DIST))
    H2, g2, n2, wrr2 = icp_step.normal_eqs_batch_plain(*args, max_dist=ICP_MAX_DIST)
    torch.cuda.synchronize()

    def rel(a, c):
        return ((a - c).abs().max() / c.abs().max().clamp_min(1e-9)).item()

    errs = {"H": rel(H1, H2), "g": rel(g1, g2), "wrr": rel(wrr1, wrr2),
            "n_in": (n1 - n2).abs().max().item()}
    print(f"{name}: rel err H {errs['H']:.3g}, g {errs['g']:.3g}, wrr {errs['wrr']:.3g}, "
          f"|n_in diff| {errs['n_in']}, n_in min {n2.min().item():.0f}, twice the same bits")
    if not (errs["H"] < 1e-3 and errs["g"] < 1e-3 and errs["wrr"] < 1e-4 and errs["n_in"] <= 0.5):
        fail(f"{name} disagrees with its plain version: {errs}")
    if not torch.equal(H1, H1.transpose(1, 2)):
        fail(f"{name}: H is not symmetric")
    max_abs = max((H1 - H2).abs().max().item(), (g1 - g2).abs().max().item())
    ms = cuda_ms(lambda: icp_step.normal_eqs_batch(*args, max_dist=ICP_MAX_DIST))
    one_call = call_ms(lambda: icp_step.normal_eqs_batch(*args, max_dist=ICP_MAX_DIST))
    plain = (cuda_ms(lambda: icp_step.normal_eqs_batch_plain(*args, max_dist=ICP_MAX_DIST), reps=3, warmup=1)
             if time_plain else None)
    bnd, by = bound_ms(NN_OPS_PER_PAIR * b * n * m + ICP_OPS_PER_QUERY * b * n,
                       4 * (4 * b * n + 6 * b * m) + b * m + 4 * 29 * b)
    print(f"  ms kernel {ms:.4f} (one call on an idle card, wrapper included: {one_call:.4f}), "
          f"plain {'not timed' if plain is None else f'{plain:.4f}'}, "
          f"bound {bnd:.4f} ({by}), time/bound {ms / bnd:.2f}")
    return {"max_abs_err": max_abs, "rel_err_H": errs["H"], "rel_err_g": errs["g"], "ms": ms,
            "call_ms": one_call,
            "plain_ms": plain, "library_ms": None, "bound_ms": bnd, "bound_by": by,
            "shape": [b, n, m], "n_in": n1}


def check_edge_cases(rng, dev) -> None:
    """Refs all masked, and duplicated refs, through both pipeline kernels."""
    q, r, m = nn_inputs(rng, 2, 300, 777, dev)
    none = torch.zeros_like(m)
    out = check_nearest(q, r, none, note=" all refs masked")
    if not ((out["d2"] == 3e38).all() and (out["idx"] == 0).all()):
        fail("nearest_batch: refs all masked must give (3e38, 0)")
    args = icp_inputs(rng, 2, 300, 777, dev)
    args[4] = torch.zeros_like(args[4])
    if check_normal_eqs(args, note=" all refs masked")["n_in"].abs().max().item() != 0.0:
        fail("normal_eqs_batch: refs all masked must give n_in = 0")
    # 500 distinct refs, each at 4 indices: the nearest is always in the first 500.
    q, r, m = nn_inputs(rng, 2, 1000, 500, dev)
    m = torch.ones_like(m).repeat(1, 4)
    out = check_nearest(q, r.repeat(1, 4, 1), m, note=" refs repeated 4 times")
    if not (out["idx"] < 500).all():
        fail("nearest_batch: the first index of duplicated refs must win")
    args = icp_inputs(rng, 2, 1000, 500, dev)
    args[2], args[3] = args[2].repeat(1, 4, 1), args[3].repeat(1, 4, 1)
    args[4] = torch.ones_like(args[4]).repeat(1, 4)
    check_normal_eqs(args, note=" refs repeated 4 times")


def print_main_loops() -> None:
    """Opcode counts per (query, ref) pair of each pipeline kernel's compiled main loop.

    A diagnostic: the loop with the most FFMA is the ref scan, whose body is one
    chunk of refs against a thread's queries.
    """
    from elasticreconstruction_tpu_torch.kernels.cuda import calib, nn

    pairs = nn.CHUNK * nn.QUERIES_PER_THREAD
    for lib, kernel in (("nn", "nearest_kernel"), ("icp_step", "normal_eqs_kernel")):
        loops = [lp for name, found in calib.loop_bodies(calib.library_sass(lib)).items()
                 if kernel in name for lp in found]
        if not loops:
            fail(f"{kernel}: no loop found in its SASS")
        body = max(loops, key=lambda lp: (lp.get("FFMA", 0), -lp["total"]))  # the innermost such loop
        print(f"  SASS main loop of {kernel} ({pairs} pairs per body): {body['total']} instructions = "
              f"{body['total'] / pairs:.3f} per pair; "
              + ", ".join(f"{op} {n}" for op, n in sorted(body.items()) if op != "total"))


def check_calib_kernels() -> dict:
    """The three calibration kernels against their plain versions, then their times.

    Parity at ``CALIB_PARITY_SHAPE`` and at the calibration's own shape; times
    at the calibration's shape. Bounds: operations over the data-sheet rate,
    the operations being the f32 lane-instructions the function's arithmetic
    needs (``calib.lane_instructions``: per chain step one FMA, or a compare
    and a select, or add + compare + select + add; plus 3 per iteration for a
    shared threshold), whatever the compiler made of them.
    """
    import kernels_bench_gpu as kb
    from elasticreconstruction_tpu_torch.kernels.cuda import calib

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    iters = kb.CALIB_ITERS
    out = {}
    for name in ("fma_chain", "where_chain", "threshold_sum_chain"):
        kernel, plain = getattr(calib, name), getattr(calib, name + "_plain")
        errs = {}
        for shape in (CALIB_PARITY_SHAPE, kb.CALIB_SHAPE):
            x = torch.rand(shape, device=dev, generator=gen)
            args = (x, x * 0.75 + 0.1) if name == "where_chain" else (x,)
            got, want = kernel(*args, iters), plain(*args, iters)
            torch.cuda.synchronize()
            errs[shape] = ((got - want).abs().max().item(),
                           ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item(),
                           torch.equal(got, want))
            del got, want
        print(f"{name}: " + "; ".join(
            f"{shape} max abs err {a:.3g}, rel {r:.3g}, equal {eq}" for shape, (a, r, eq) in errs.items()))
        if name == "fma_chain":
            if not all(r <= FMA_CHAIN_RTOL for _, r, _ in errs.values()):
                fail(f"fma_chain: relative error above {FMA_CHAIN_RTOL}: {errs}")
        elif not all(eq for _, _, eq in errs.values()):
            fail(f"{name} is not bit-equal to its plain version: {errs}")
        ms = cuda_ms(lambda: kernel(*args, iters))
        plain_ms = cuda_ms(lambda: plain(*args, iters), reps=3, warmup=1)
        elems = x.numel()
        lane_instr = calib.lane_instructions(name, iters) * elems
        bnd, by = bound_ms(lane_instr, 4 * (len(args) + 1) * elems, LANE_INSTR_PER_S)
        print(f"  ms kernel {ms:.4f}, plain {plain_ms:.4f}, bound {bnd:.4f} ({by}) at {tuple(x.shape)}")
        full = errs[kb.CALIB_SHAPE]
        out[name] = {"max_abs_err": full[0], "max_rel_err": full[1], "ms": ms, "plain_ms": plain_ms,
                     "library_ms": None, "bound_ms": bnd, "bound_by": by, "shape": list(x.shape),
                     "lane_instructions_per_element": calib.lane_instructions(name, iters)}
    return out


def phase_kernel_parity() -> dict:
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    print_main_loops()
    nn_by_shape = [check_nearest(*nn_inputs(rng, *shape, dev), time_plain=True) for shape in NN_SHAPES]
    icp_by_shape = [check_normal_eqs(icp_inputs(rng, *shape, dev), time_plain=True) for shape in ICP_SHAPES]
    for shape in RAGGED_SHAPES:
        check_nearest(*nn_inputs(rng, *shape, dev))
        check_normal_eqs(icp_inputs(rng, *shape, dev))
    check_edge_cases(rng, dev)

    def numbers(results):
        return [{k: v for k, v in res.items() if not torch.is_tensor(v)} for res in results]

    nn_by_shape, icp_by_shape = numbers(nn_by_shape), numbers(icp_by_shape)
    return {"nearest_batch": dict(nn_by_shape[0], by_shape=nn_by_shape),
            "normal_eqs_batch": dict(icp_by_shape[0], by_shape=icp_by_shape),
            **check_calib_kernels()}


def launch_counts() -> dict:
    from elasticreconstruction_tpu_torch.kernels.cuda import calib, icp_step, nn

    return {"nearest_batch": nn.launches, "normal_eqs_batch": icp_step.launches, **calib.launches}


def launches_by_shape() -> dict:
    """Launches of the two pipeline kernels since the last reset, by (B, Nq, Nr)."""
    from elasticreconstruction_tpu_torch.kernels.cuda import icp_step, nn

    return {name: {str(shape): count for shape, count in sorted(mod.launches_by_shape.items())}
            for name, mod in (("nearest_batch", nn), ("normal_eqs_batch", icp_step))}


def reset_launch_counts() -> None:
    from elasticreconstruction_tpu_torch.kernels.cuda import calib, icp_step, nn

    nn.launches = 0
    icp_step.launches = 0
    nn.launches_by_shape.clear()
    icp_step.launches_by_shape.clear()
    for name in calib.launches:
        calib.launches[name] = 0


def require_launched(path: str, counts: dict, names) -> None:
    for name in names:
        if counts[name] <= 0:
            fail(f"{name} was never launched on the {path} path")


def phase_calibration() -> dict:
    """The calibration path: measure the card's peaks, then score the hot kernels."""
    import kernels_bench_gpu as kb

    from elasticreconstruction_tpu_torch.kernels.cuda import calib

    reset_launch_counts()
    cal = kb.calibrate("cuda")
    for name, counts in cal["sass_loop_body"].items():
        print(f"  SASS loop body of {name} ({calib.UNROLL} iterations x {calib.CHAINS} chains; the source's "
              f"arithmetic needs {calib.lane_instructions(name, calib.UNROLL)}): "
              + ", ".join(f"{op} {n}" for op, n in sorted(counts.items())))
    entries = kb.bench_kernels(cal["peaks"], None, "cuda")
    counts = launch_counts()
    print(json.dumps({"calibration_launches_by_shape": launches_by_shape()}))
    require_launched("calibration", counts, counts)
    print(json.dumps({"calibrated_peaks": {
        k: {"value": v, "share_of_data_sheet": cal["share_of_data_sheet"][k]} for k, v in cal["peaks"].items()}}))
    print(json.dumps({"scored_kernels": entries}))
    return counts


def adjacent_errors(transform, ii, jj, poses) -> list[tuple[int, int, float, float]]:
    """(i, j, translation m, rotation rad) off ground truth for each adjacent pair."""
    from elasticreconstruction_tpu_torch.bench_scene import pose_error

    T = transform.cpu().numpy()
    out = []
    for k in np.nonzero(np.abs(ii - jj) == 1)[0]:
        gt = np.linalg.inv(poses[ii[k]]) @ poses[jj[k]]
        out.append((int(ii[k]), int(jj[k]), *pose_error(T[k], gt)))
    return out


def check_adjacent(name, transform, success, ii, jj, poses) -> None:
    succ = success.cpu().numpy()
    adj = np.abs(ii - jj) == 1
    if not succ[adj].all():
        fail(f"{name}: adjacent pairs failed to register: {list(zip(ii[adj & ~succ], jj[adj & ~succ]))}")
    for i, j, te, re in adjacent_errors(transform, ii, jj, poses):
        if not (te < GT_TRANSLATION_M and re < GT_ROTATION_RAD):
            fail(f"{name}: pair ({i}, {j}) off ground truth by {te:.4f} m / {re:.4f} rad")


def main_path(dev, num_frag: int, n: int, cfg, batch: int, reps: int, seed: int = 0) -> dict:
    """The registration main path, end to end; returns its outputs and the timed pass's wall time.

    The timed pass is prep + every register batch, queued back to back with
    one synchronisation at the end (the ``bench.py`` methodology).
    """
    from elasticreconstruction_tpu_torch.bench_scene import make_fragments
    from elasticreconstruction_tpu_torch.kernels.cuda import icp_step, nn
    from elasticreconstruction_tpu_torch.registration import (
        prep_fragments_batch, refine_edges_batch, register_prepped_batch,
    )

    clouds, poses = make_fragments(num_frag, n=n, seed=seed)
    pairs = [(i, j) for i in range(num_frag) for j in range(i + 1, num_frag)]
    total = ((len(pairs) * reps + batch - 1) // batch) * batch
    plist = (pairs * (total // len(pairs) + 1))[:total]
    ii = np.array([i for i, _ in plist])
    jj = np.array([j for _, j in plist])
    gen = torch.Generator().manual_seed(seed)
    counts = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def count(part):  # kernel launches since the previous part, per kernel
        now = (nn.launches, icp_step.launches)
        counts[part] = [a - b for a, b in zip(now, count.last)]
        count.last = now

    count.last = (nn.launches, icp_step.launches)
    sync()
    t0 = time.perf_counter()
    prepped = prep_fragments_batch(clouds, cfg, device=dev)
    results = [
        register_prepped_batch(prepped, ii[s : s + batch], jj[s : s + batch], gen, cfg, device=dev)
        for s in range(0, total, batch)
    ]
    sync()
    wall = time.perf_counter() - t0
    count(f"prep + {len(results)} register batches")

    # The odometry-chain refinement, initialised from the registered adjacent edges.
    transforms = torch.cat([r.transform for r in results])
    adj_i = np.arange(num_frag - 1)
    first = [int(np.nonzero((ii == i) & (jj == i + 1))[0][0]) for i in adj_i]
    refined, refined_info = refine_edges_batch(prepped, adj_i, adj_i + 1, transforms[first], cfg)
    count("refine_edges_batch")
    fused = register_prepped_batch(prepped, ii[:batch], jj[:batch], gen, cfg, fused_step=True, device=dev)
    count("fused_step register batch")
    sync()
    return {"prepped": prepped, "results": results, "ii": ii, "jj": jj, "poses": poses,
            "refined": refined, "refined_info": refined_info, "adj_i": adj_i, "fused": fused,
            "wall_s": wall, "pairs": total, "launches_by_part": counts}


def check_main_path(out: dict, batch: int) -> None:
    """Every adjacent pair registered within the ground-truth bounds, outputs finite."""
    ii, jj, poses = out["ii"], out["jj"], out["poses"]
    merged = [torch.cat(x) for x in zip(*out["results"])]
    for name, t in zip(out["results"][0]._fields, merged):
        if t.shape[0] != len(ii) or (t.is_floating_point() and not torch.isfinite(t).all()):
            fail(f"register_prepped_batch: {name} has shape {tuple(t.shape)} or non-finite values")
    res = out["results"][0]._make(merged)
    check_adjacent("register_prepped_batch", res.transform, res.success, ii, jj, poses)
    fused = out["fused"]
    check_adjacent("register_prepped_batch(fused_step=True)", fused.transform, fused.success,
                   ii[:batch], jj[:batch], poses)
    adj_i = out["adj_i"]
    refined = out["refined"]
    # ICP has no success flag; adjacent fragments overlap ~73%, so a converged
    # refinement matches well over half its source points.
    check_adjacent("refine_edges_batch", refined.transform, refined.fitness > 0.5, adj_i, adj_i + 1, poses)
    if not torch.isfinite(out["refined_info"]).all():
        fail("refine_edges_batch: non-finite information matrices")


def check_small_cpu_agreement() -> None:
    """A small scene registered on the card and on the CPU (plain versions) agree."""
    from elasticreconstruction_tpu_torch.registration import RegistrationConfig

    cfg = RegistrationConfig(voxel_size=0.15, icp_voxel_size=0.075, coarse_capacity=512,
                             fine_capacity=2048, num_hypotheses=1024, icp_iterations=10,
                             inlier_threshold=0.15)
    gpu = main_path(torch.device("cuda"), 4, 2000, cfg, batch=6, reps=1)
    cpu = main_path(torch.device("cpu"), 4, 2000, cfg, batch=6, reps=1)
    for rg, rc in zip(gpu["results"], cpu["results"]):
        same = torch.equal(rg.success.cpu(), rc.success)
        ok = rc.success  # a rejected pair's transform is arbitrary
        dT = (rg.transform.cpu() - rc.transform)[ok].abs().max().item()
        info_rel = ((rg.information.cpu() - rc.information).abs().amax((1, 2))
                    / rc.information.abs().amax((1, 2)).clamp_min(1e-9))[ok].max().item()
        print(f"small scene card vs CPU: success {rc.success.tolist()} equal {same}, "
              f"max |dT| {dT:.3g}, info rel {info_rel:.3g}")
        # ICP stops at |delta| <= 1e-5 per step, so runs from slightly different
        # preps converge within ~1e-4; a few boundary inliers may differ among ~1000.
        if not (same and dT < 1e-3 and info_rel < 1e-2):
            fail("the card and the CPU disagree on the small scene")


def check_logfiles(out: dict) -> None:
    from elasticreconstruction_tpu_torch.core import io_logfmt

    res = out["results"][0]
    T = res.transform.cpu().numpy().astype(np.float64)
    info = res.information.cpu().numpy().astype(np.float64)
    ii, jj = out["ii"], out["jj"]
    with tempfile.TemporaryDirectory() as tmp:
        log_p, info_p = os.path.join(tmp, "loop.log"), os.path.join(tmp, "loop.info")
        io_logfmt.write_log(log_p, io_logfmt.Trajectory(
            [io_logfmt.TrajectoryEntry(int(ii[k]), int(jj[k]), 6, T[k]) for k in range(len(T))]))
        io_logfmt.write_info(info_p, io_logfmt.InfoFile(
            [io_logfmt.InfoEntry(int(ii[k]), int(jj[k]), 6, info[k]) for k in range(len(T))]))
        T_back = io_logfmt.read_log(log_p).matrices()
        info_back = np.stack([e.info for e in io_logfmt.read_info(info_p).entries])
    if not (np.abs(T_back - T).max() < 1e-7 and np.abs(info_back - info).max() <= 1e-8 * np.abs(info).max() + 1e-7):
        fail("loop.log / loop.info did not read back")
    print(f"loop.log / loop.info: {len(T)} edges written and read back")


def phase_timings(out: dict, cfg, batch: int) -> dict:
    """Per-phase wall ms for one batch of ``batch`` pairs (bench.py's phase split)."""
    from elasticreconstruction_tpu_torch.bench_scene import make_fragments
    from elasticreconstruction_tpu_torch.core import se3
    from elasticreconstruction_tpu_torch.core.types import PointCloud
    from elasticreconstruction_tpu_torch.kernels import knn
    from elasticreconstruction_tpu_torch.registration import features, icp, infomat, ransac
    from elasticreconstruction_tpu_torch.registration import prep_fragments_batch

    dev = torch.device("cuda")
    prepped = out["prepped"]
    bi = torch.as_tensor(out["ii"][:batch], device=dev)
    bj = torch.as_tensor(out["jj"][:batch], device=dev)
    pi, pj = prepped.take(bi), prepped.take(bj)
    gen = torch.Generator().manual_seed(7)
    clouds, _ = make_fragments(int(prepped.features.shape[0]))

    def match_ransac():
        corr, cm = features.match_features(pj.features, pj.coarse.mask, pi.features, pi.coarse.mask)
        return ransac.ransac_alignment(pj.coarse.points, pi.coarse.points, corr, cm, gen,
                                       inlier_threshold=cfg.inlier_threshold,
                                       edge_similarity=cfg.edge_similarity,
                                       num_hypotheses=cfg.num_hypotheses)

    rr = match_ransac()
    src = PointCloud(*(x[:, :: cfg.icp_src_stride] for x in pj.fine))

    def icp_phase():
        return icp.icp_point_to_plane_batch(
            src, pi.fine, rr.transform, max_correspondence_distance=cfg.inlier_threshold,
            iterations=cfg.icp_iterations, coarse_iterations=cfg.icp_coarse_iterations,
            coarse_stride=cfg.icp_coarse_stride, dead=rr.num_inliers < cfg.min_inliers)

    ir = icp_phase()

    def info_phase():
        p = se3.apply(ir.transform, pj.fine.points)
        d2, _ = knn.nearest_auto_batch(p, pi.fine.points, pi.fine.mask)
        return infomat.information_matrix(p, pj.fine.mask & (d2 < cfg.inlier_threshold ** 2))

    def best_of(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return min(ts) * 1e3

    return {
        "prep_all_fragments_ms": best_of(lambda: prep_fragments_batch(clouds, cfg, device=dev)),
        "match_ransac_ms": best_of(match_ransac),
        "icp_ms": best_of(icp_phase),
        "infomat_ms": best_of(info_phase),
    }


def device_profile(name: str, fn, top: int = 6, warm: bool = True) -> dict:
    """Device busy time of one call of ``fn`` (sum of its CUDA kernel and copy
    times under torch.profiler) against its unprofiled wall time, and the
    heaviest device ops by name. ``warm`` runs ``fn`` once more first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    rows.sort(key=dev_us, reverse=True)
    out = {"profile": name, "wall_ms": wall_ms,
           "device_busy_ms": busy_ms if rows else "not measured",
           "busy_share": busy_ms / wall_ms if rows else "not measured",
           "top_device_ops": [[e.key[:60], dev_us(e) / 1e3, e.count] for e in rows[:top]],
           # The two pipeline kernels, wherever they rank: [name, device ms, launches].
           "pipeline_kernels": [[k, dev_us(e) / 1e3, e.count] for e in rows
                                for k in ("nearest_kernel", "normal_eqs_kernel") if k in e.key]}
    print(json.dumps(out))
    return out


def profile_where_time_goes(out: dict, cfg, batch: int) -> None:
    """Device busy share of the main path's layers: prep, and one register batch each way."""
    from elasticreconstruction_tpu_torch.bench_scene import make_fragments
    from elasticreconstruction_tpu_torch.registration import prep_fragments_batch, register_prepped_batch

    dev = torch.device("cuda")
    clouds, _ = make_fragments(int(out["prepped"].features.shape[0]))
    ii, jj = out["ii"][:batch], out["jj"][:batch]
    gen = torch.Generator().manual_seed(11)
    device_profile("prep_fragments_batch", lambda: prep_fragments_batch(clouds, cfg, device=dev))
    for fused in (False, True):
        device_profile(f"register_prepped_batch(fused_step={fused})",
                       lambda: register_prepped_batch(out["prepped"], ii, jj, gen, cfg,
                                                      fused_step=fused, device=dev))


def phase_stages(num_frag: int = 24, n: int = 20000, seed: int = 0) -> dict:
    """The stage path: fragment artifacts -> ``register`` -> ``posegraph``, as a user runs them."""
    import dataclasses

    from elasticreconstruction_tpu_torch.bench_scene import placement_error, write_fragments_dir
    from elasticreconstruction_tpu_torch.core import io_logfmt
    from elasticreconstruction_tpu_torch.pipeline import run, stages

    with tempfile.TemporaryDirectory() as tmp:
        gt, centroids = write_fragments_dir(tmp, num_frag, n=n, seed=seed)
        reset_launch_counts()
        walls = {}
        for verb in ("register", "posegraph"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if run.main([verb, "--out", tmp, "--seed", str(seed)]) != 0:
                fail(f"the {verb} verb returned non-zero")
            torch.cuda.synchronize()
            walls[verb + "_s"] = time.perf_counter() - t0
        counts = launch_counts()
        print(json.dumps({"stage_launches_by_shape": launches_by_shape()}))
        require_launched("stage", counts, ["nearest_batch"])

        reg, pg = os.path.join(tmp, "registration"), os.path.join(tmp, "posegraph")
        odo = io_logfmt.read_log(os.path.join(reg, "odometry.log"))
        odo_info = io_logfmt.read_info(os.path.join(reg, "odometry.info"))
        loop = io_logfmt.read_log(os.path.join(reg, "loop.log"))
        loop_info = io_logfmt.read_info(os.path.join(reg, "loop.info"))
        pose = io_logfmt.read_log(os.path.join(pg, "pose.log")).matrices()
        with open(os.path.join(reg, "odometry_suspect.txt")) as f:
            suspect = f.read().split()
        with open(os.path.join(pg, "kept_edges.txt")) as f:
            kept = [tuple(int(v) for v in line.split()) for line in f if line.strip()]
        phase_done("register and posegraph verbs")
        # The same registration files optimised to convergence.
        cfg = run.config_from_args(run.build_parser().parse_args(["posegraph", "--out", tmp, "--seed", str(seed)]))
        stages.run_posegraph(dataclasses.replace(cfg, posegraph=cfg.posegraph._replace(
            inner_iterations=CONVERGED_INNER_ITERATIONS)), device="cuda")
        pose_converged = io_logfmt.read_log(os.path.join(pg, "pose.log")).matrices()
        # The stage under the profiler, for its device-busy share (a second run of the verb).
        device_profile("register verb", lambda: run.main(["register", "--out", tmp, "--seed", str(seed)]),
                       warm=False)

    def off_gt(e):  # where the edge puts fragment j's centroid, against ground truth
        return placement_error(e.transform, np.linalg.inv(gt[e.i]) @ gt[e.j], centroids[e.j])

    if [(e.i, e.j) for e in odo.entries] != [(f, f + 1) for f in range(num_frag - 1)]:
        fail("odometry.log does not hold every adjacent edge in order")
    if len(odo_info.entries) != len(odo.entries) or len(loop_info.entries) != len(loop.entries):
        fail("the .info files do not match their .log files")
    if suspect:
        fail(f"odometry edges marked suspect on a healthy scene: {suspect}")
    worst = {"odometry": (0.0, 0.0), "loop_2_apart": (0.0, 0.0)}
    faults = []
    for name, entries in (("odometry", odo.entries),
                          ("loop_2_apart", [e for e in loop.entries if e.j - e.i == 2])):
        if not entries:
            faults.append(f"no {name} edge was written")
        for e in entries:
            te, re = off_gt(e)
            worst[name] = (max(worst[name][0], te), max(worst[name][1], re))
            if not (te < GT_TRANSLATION_M and re < GT_ROTATION_RAD):
                faults.append(f"{name} edge ({e.i}, {e.j}) off ground truth by {te:.4f} m / {re:.4f} rad")
    if pose.shape != (num_frag, 4, 4) or not np.isfinite(pose).all():
        fail(f"pose.log holds {pose.shape} poses or non-finite values")

    def anchored_error(p):  # per fragment, aligned at fragment 0, at the fragment's centroid
        rel = np.linalg.inv(p[0]) @ p
        return np.array([placement_error(rel[f], gt[f], centroids[f])[0] for f in range(num_frag)])

    pose_err = anchored_error(pose)
    converged_err = anchored_error(pose_converged)
    chain = [np.eye(4)]  # the odometry edges chained alone
    for e in odo.entries:
        chain.append(chain[-1] @ e.transform)
    chain_err = anchored_error(np.stack(chain))
    print(json.dumps({name: [round(float(v), 4) for v in errs] for name, errs in (
        ("pose_log_m_by_fragment", pose_err), ("pose_log_converged_m_by_fragment", converged_err),
        ("odometry_chain_m_by_fragment", chain_err))}))
    limit = POSE_LOG_DEFAULT_M + POSE_LOG_DEFAULT_PER_M * FRAGMENT_SPACING_M * np.arange(num_frag)
    if not (pose_err < limit).all():
        f = int((pose_err - limit).argmax())
        faults.append(f"pose.log is off ground truth by {pose_err[f]:.4f} m at fragment {f} (limit {limit[f]:.4f})")
    if not converged_err.max() < POSE_LOG_CONVERGED_M:
        faults.append(f"pose.log after {CONVERGED_INNER_ITERATIONS} inner iterations is off ground truth by "
                      f"up to {converged_err.max():.4f} m (fragment {int(converged_err.argmax())})")
    # Loop edges more than 10 cm or 0.1 rad off ground truth: aliased matches
    # (the scene is nearly periodic in x), which the line process must prune.
    false_loops = [(e.i, e.j) for e in loop.entries if max(off_gt(e)) > 0.1]
    false_kept = [e for e in false_loops if e in kept]
    if false_kept:
        faults.append(f"false loop edges survived the line process: {false_kept}")
    out = {"fragments": num_frag, "points_per_fragment": n, **walls,
           "odometry_edges": len(odo.entries), "loop_edges": len(loop.entries),
           "loop_edges_2_apart": sum(e.j - e.i == 2 for e in loop.entries),
           "loop_edges_kept": len(kept), "false_loop_edges_accepted": len(false_loops),
           "false_loop_edges_kept": len(false_kept),
           "worst_odometry_m_rad": worst["odometry"], "worst_loop_2_apart_m_rad": worst["loop_2_apart"],
           "pose_log_max_m": float(pose_err.max()), "pose_log_mean_m": float(pose_err.mean()),
           "pose_log_converged_max_m": float(converged_err.max()),
           "odometry_chain_max_m": float(chain_err.max()),
           "launches": counts}
    print(json.dumps({"stages": out}))
    if faults:
        fail("stage path: " + "; ".join(faults))
    return out


KERNELS = {
    "nearest_batch": {
        "source": "elasticreconstruction_tpu_torch/kernels/cuda/csrc/nn.cu",
        "replaces": "elasticreconstruction_tpu/kernels/pallas/nn.py:87",
    },
    "normal_eqs_batch": {
        "source": "elasticreconstruction_tpu_torch/kernels/cuda/csrc/icp_step.cu",
        "replaces": "elasticreconstruction_tpu/kernels/pallas/icp_step.py:168",
    },
    "fma_chain": {
        "source": "elasticreconstruction_tpu_torch/kernels/cuda/csrc/calib.cu",
        "replaces": "kernels_bench.py:173",
    },
    "where_chain": {
        "source": "elasticreconstruction_tpu_torch/kernels/cuda/csrc/calib.cu",
        "replaces": "kernels_bench.py:220",
    },
    "threshold_sum_chain": {
        "source": "elasticreconstruction_tpu_torch/kernels/cuda/csrc/calib.cu",
        "replaces": "kernels_bench.py:267",
    },
}


def main() -> int:
    device = phase_device()
    from elasticreconstruction_tpu_torch.registration import RegistrationConfig

    phase_build()
    phase_done("build")
    parity = phase_kernel_parity()
    phase_done("kernel parity")

    # Registration path.
    cfg = RegistrationConfig()
    dev = torch.device("cuda")
    batch, num_frag, n, reps = 16, 6, 20000, 4
    main_path(dev, 3, n, cfg, batch=batch, reps=1)  # warm-up: allocator, cuBLAS, cuSOLVER
    reset_launch_counts()
    out = main_path(dev, num_frag, n, cfg, batch=batch, reps=reps)
    by_path = {"registration": launch_counts()}
    print(json.dumps({"registration_launches_by_shape": launches_by_shape()}))
    print(f"main path: {out['pairs']} pairs in {out['wall_s']:.3f} s = "
          f"{out['pairs'] / out['wall_s']:.2f} pairs/s (timed pass: prep + {out['pairs'] // batch} "
          f"batches of {batch}); kernel launches {by_path['registration']}, "
          f"by part [nearest_batch, normal_eqs_batch] {out['launches_by_part']}")
    require_launched("registration", by_path["registration"], ["nearest_batch", "normal_eqs_batch"])
    check_main_path(out, batch)
    errs = adjacent_errors(out["results"][0].transform, out["ii"][:batch], out["jj"][:batch], out["poses"])
    print("adjacent pairs (i, j, m, rad): " + ", ".join(f"({i},{j},{t:.4f},{r:.4f})" for i, j, t, r in errs))
    check_logfiles(out)
    check_small_cpu_agreement()

    rates = [out["pairs"] / out["wall_s"]]
    for _ in range(2):
        rates.append(out["pairs"] / main_path(dev, num_frag, n, cfg, batch=batch, reps=reps)["wall_s"])
    phases = phase_timings(out, cfg, batch)
    profile_where_time_goes(out, cfg, batch)
    print(json.dumps({"registration_pairs_per_second": statistics.median(rates),
                      "pass_rates": rates, "batch": batch, "pairs_timed": out["pairs"],
                      "phase_ms_per_batch": phases}))
    del out
    phase_done("registration path")

    by_path["calibration"] = phase_calibration()
    phase_done("calibration path")
    by_path["stages"] = phase_stages()["launches"]
    phase_done("stage path")

    kernels = []
    for name, meta in KERNELS.items():
        k = parity[name]
        kernels.append({"name": name, "route": "cuda", **meta,
                        "launches": sum(counts[name] for counts in by_path.values()),
                        "launches_by_path": {path: counts[name] for path, counts in by_path.items()},
                        "max_abs_err": k["max_abs_err"], "max_err": k["max_abs_err"],
                        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                        "bound_by": k["bound_by"], "library_ms": k["library_ms"],
                        "shape": k["shape"]})
    print(json.dumps({"pipeline_kernels_by_shape": {
        name: parity[name]["by_shape"] for name in ("nearest_batch", "normal_eqs_batch")}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
