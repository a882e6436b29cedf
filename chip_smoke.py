#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA versions.
2. Build: compiles both hand-written kernels from ``csrc/`` (one nvcc each, in parallel).
3. Kernel parity at main-path shapes: each kernel against its plain PyTorch
   version on the card, with a partly masked ref set, plus CUDA-event times of
   the kernel, the plain version and a library yardstick.
4. Main path at full width: 6 fragments of 20 000 points (the registration
   benchmark's scene), ``prep_fragments_batch`` and ``register_prepped_batch``
   with ``RegistrationConfig()`` defaults over all 15 pairs x4 in 4 batches of
   16, ``refine_edges_batch`` on the 5 adjacent pairs and one more batch with
   ``fused_step=True``; every adjacent pair must register within 2 cm / 0.02 rad
   of ground truth and both kernels' launch counts must be > 0. Then the same
   small scene registered on the card and on the CPU (plain versions) must agree,
   and the ``loop.log``/``loop.info`` files must read back.
5. One JSON line of per-kernel numbers, then the last line
   ``{"ok": true, "device": {...}}``.

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

GT_TRANSLATION_M = 0.02
GT_ROTATION_RAD = 0.02


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` in ms, after ``warmup`` calls."""
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


def bound_ms(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
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
    from elasticreconstruction_tpu_torch.kernels.cuda import build

    t0 = time.perf_counter()
    build.load(*build.SOURCES)
    print(f"build: {time.perf_counter() - t0:.2f} s for {', '.join(build.SOURCES)}")
    for name, log in build.build_logs.items():
        info = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"  ptxas {name}: " + " | ".join(info))


def nn_inputs(rng, b: int, nq: int, nr: int, dev):
    ref, _ = surface(rng, (b, nr))
    query, _ = surface(rng, (b, nq))
    query += rng.normal(0.0, 0.01, query.shape).astype(np.float32)
    mask = np.ones((b, nr), bool)
    mask[:, int(nr * 0.9):] = False  # a fixed-capacity cloud's padding rows
    mask &= rng.uniform(size=(b, nr)) > 0.02
    return (torch.from_numpy(query).to(dev), torch.from_numpy(ref).to(dev),
            torch.from_numpy(mask).to(dev))


def check_nearest(q, r, m) -> dict:
    from elasticreconstruction_tpu_torch.kernels.cuda import nn

    d_k, i_k = nn.nearest_batch(q, r, m)
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
            fail(f"nearest_batch: {len(bad)} index mismatches, exact d2 gap {gap:.3g} >= 1e-6")
    err = (d_k - d_p).abs().max().item()
    print(f"nearest_batch {tuple(q.shape[:2]) + (r.shape[1],)}: index mismatches {len(bad)}, "
          f"max |d2 kernel - plain| {err:.3g}")
    if not err <= 1e-5:
        fail(f"nearest_batch: max |d2 kernel - plain| {err} > 1e-5")
    b, nq, nr = q.shape[0], q.shape[1], r.shape[1]
    r_far = torch.where(m[..., None], r, 1e18)  # masked refs never win the yardstick's min
    ms = cuda_ms(lambda: nn.nearest_batch(q, r, m))
    plain = cuda_ms(lambda: nn.nearest_batch_plain(q, r, m), reps=5, warmup=1)
    lib = cuda_ms(lambda: torch.cdist(q, r_far, compute_mode="use_mm_for_euclid_dist").min(dim=-1), reps=5)
    bnd, by = bound_ms(NN_OPS_PER_PAIR * b * nq * nr, 4 * 3 * b * (nq + nr) + b * nr + 8 * b * nq)
    print(f"  ms kernel {ms:.4f}, plain {plain:.4f}, cdist+min {lib:.4f}, bound {bnd:.4f} ({by})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": bnd, "bound_by": by, "shape": [b, nq, nr], "index_mismatches": len(bad)}


def check_normal_eqs(rng, b: int, n: int, m: int, max_dist: float, dev) -> dict:
    from elasticreconstruction_tpu_torch.kernels.cuda import icp_step

    dst, nrm = surface(rng, (b, m))
    p, _ = surface(rng, (b, n))
    p += rng.normal(0.0, 0.02, p.shape).astype(np.float32)
    mask = np.ones((b, m), bool)
    mask[:, int(m * 0.9):] = False
    w = (rng.uniform(size=(b, n)) > 0.05).astype(np.float32)
    args = [torch.from_numpy(x).to(dev) for x in (p, w, dst, nrm, mask)]
    H1, g1, n1, wrr1 = icp_step.normal_eqs_batch(*args, max_dist=max_dist)
    H2, g2, n2, wrr2 = icp_step.normal_eqs_batch_plain(*args, max_dist=max_dist)
    torch.cuda.synchronize()

    def rel(a, c):
        return ((a - c).abs().max() / c.abs().max().clamp_min(1e-9)).item()

    errs = {"H": rel(H1, H2), "g": rel(g1, g2), "wrr": rel(wrr1, wrr2),
            "n_in": (n1 - n2).abs().max().item()}
    print(f"normal_eqs_batch {(b, n, m)}: rel err H {errs['H']:.3g}, g {errs['g']:.3g}, "
          f"wrr {errs['wrr']:.3g}, |n_in diff| {errs['n_in']}, n_in min {n2.min().item():.0f}")
    if not (errs["H"] < 1e-3 and errs["g"] < 1e-3 and errs["wrr"] < 1e-4 and errs["n_in"] <= 0.5):
        fail(f"normal_eqs_batch disagrees with its plain version: {errs}")
    max_abs = max((H1 - H2).abs().max().item(), (g1 - g2).abs().max().item())
    ms = cuda_ms(lambda: icp_step.normal_eqs_batch(*args, max_dist=max_dist))
    plain = cuda_ms(lambda: icp_step.normal_eqs_batch_plain(*args, max_dist=max_dist), reps=5, warmup=1)
    bnd, by = bound_ms(NN_OPS_PER_PAIR * b * n * m + ICP_OPS_PER_QUERY * b * n,
                       4 * (4 * b * n + 6 * b * m) + b * m + 4 * 29 * b)
    print(f"  ms kernel {ms:.4f}, plain {plain:.4f}, bound {bnd:.4f} ({by})")
    return {"max_abs_err": max_abs, "rel_err_H": errs["H"], "rel_err_g": errs["g"], "ms": ms,
            "plain_ms": plain, "library_ms": None, "bound_ms": bnd, "bound_by": by,
            "shape": [b, n, m]}


def phase_kernel_parity() -> dict:
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    # ICP fine phase (8192-point fine clouds at src stride 2) and the infomat query.
    nn_fine = check_nearest(*nn_inputs(rng, 16, 4096, 8192, dev))
    nn_info = check_nearest(*nn_inputs(rng, 16, 8192, 8192, dev))
    icp = check_normal_eqs(rng, 16, 4096, 8192, 0.075, dev)
    return {"nearest_batch": dict(nn_fine, infomat_shape=nn_info), "normal_eqs_batch": icp}


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


def device_profile(name: str, fn, top: int = 6) -> dict:
    """Device busy time of one call of ``fn`` (sum of its CUDA kernel and copy
    times under torch.profiler) against its unprofiled wall time, and the
    heaviest device ops by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
           "top_device_ops": [[e.key[:60], dev_us(e) / 1e3, e.count] for e in rows[:top]]}
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


KERNELS = {
    "nearest_batch": {
        "source": "elasticreconstruction_tpu_torch/kernels/cuda/csrc/nn.cu",
        "replaces": "elasticreconstruction_tpu/kernels/pallas/nn.py:87",
    },
    "normal_eqs_batch": {
        "source": "elasticreconstruction_tpu_torch/kernels/cuda/csrc/icp_step.cu",
        "replaces": "elasticreconstruction_tpu/kernels/pallas/icp_step.py:168",
    },
}


def main() -> int:
    device = phase_device()
    from elasticreconstruction_tpu_torch.kernels.cuda import icp_step, nn
    from elasticreconstruction_tpu_torch.registration import RegistrationConfig

    phase_build()
    parity = phase_kernel_parity()

    cfg = RegistrationConfig()
    dev = torch.device("cuda")
    batch, num_frag, n, reps = 16, 6, 20000, 4
    main_path(dev, 3, n, cfg, batch=batch, reps=1)  # warm-up: allocator, cuBLAS, cuSOLVER
    nn.launches = 0
    icp_step.launches = 0
    out = main_path(dev, num_frag, n, cfg, batch=batch, reps=reps)
    launches = {"nearest_batch": nn.launches, "normal_eqs_batch": icp_step.launches}
    print(f"main path: {out['pairs']} pairs in {out['wall_s']:.3f} s = "
          f"{out['pairs'] / out['wall_s']:.2f} pairs/s (timed pass: prep + {out['pairs'] // batch} "
          f"batches of {batch}); kernel launches {launches}, "
          f"by part [nearest_batch, normal_eqs_batch] {out['launches_by_part']}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"{name} was never launched on the main path")
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

    kernels = []
    for name, meta in KERNELS.items():
        k = parity[name]
        kernels.append({"name": name, "route": "cuda", **meta, "launches": launches[name],
                        "max_abs_err": k["max_abs_err"], "max_err": k["max_abs_err"],
                        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                        "bound_by": k["bound_by"], "library_ms": k["library_ms"],
                        "shape": k["shape"]})
    print(json.dumps({"nearest_batch_infomat_shape": parity["nearest_batch"]["infomat_shape"]}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
