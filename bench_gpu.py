#!/usr/bin/env python3
"""Registration benchmark of the PyTorch/CUDA port: prints ONE JSON line.

Counterpart of ``bench.py`` for the port, at the same sizes. The headline
metric is pairwise fragment registration throughput on one card: prep every
fragment once (voxel downsample -> radius normals -> FPFH, both scales), then
register pair batches (mutual matching -> 4096-hypothesis RANSAC ->
point-to-plane ICP -> information matrix) on 20 000-point fragments of the
benchmark's synthetic surface (``bench_scene.make_fragments``).

Each measured pass queues the prep and every batch back to back and ends with
``torch.cuda.synchronize()`` and a host readback of one scalar that depends on
every result's ``fitness`` and ``transform``; the line reports the median pass
rate. Beside it: the rate of trivial one-element readbacks, the share of
adjacent pairs that registered (only adjacent fragments overlap), best-of-3
times of the four phases of one batch (prep of all fragments, match+RANSAC,
ICP, information matrix) and the frame rate of one 50-frame
``build_fragment`` at raycast scales 1 and 2.

``vs_baseline`` divides by ``bench.py``'s estimate of the original CPU
pipeline, 0.5 pairs/s.

    python3 bench_gpu.py                 # on the card
    python3 bench_gpu.py --device cpu    # bench.py's CPU sizes, plain versions

Without a card the default device raises: it exits non-zero and prints no
result. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

REFERENCE_PAIRS_PER_SECOND = 0.5  # bench.py's estimate of the original per-core rate
# bench.py:231-238 and :179: the accelerator's sizes, then the CPU's.
CARD_SIZES = dict(num_frag=6, points=20000, batch=16, passes=5, reps=4, odometry_frames=50)
CPU_SIZES = dict(num_frag=3, points=20000, batch=2, passes=1, reps=1, odometry_frames=10)
# bench.py:189: the odometry timing's camera (320x240).
ODOMETRY_INTRINSICS = (262.5, 262.5, 159.5, 119.5, 320, 240)


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def readback(dev: torch.device, *tensors) -> float:
    """Wait for the card, then read back one scalar that depends on every tensor."""
    synchronize(dev)
    return float(sum(t.float().sum() for t in tensors).item())


def leaves(out) -> list[torch.Tensor]:
    """The tensors of a result, through nested tuples (``bench.py``'s ``jax.tree.leaves``)."""
    if torch.is_tensor(out):
        return [out]
    return [t for x in out for t in leaves(x)] if isinstance(out, tuple) else []


def pair_lists(num_frag: int, batch: int, reps: int) -> tuple[np.ndarray, np.ndarray]:
    """All pairs ``reps`` times, padded by repeats to a whole number of batches."""
    pairs = [(i, j) for i in range(num_frag) for j in range(i + 1, num_frag)]
    total = ((len(pairs) * reps + batch - 1) // batch) * batch
    plist = (pairs * (total // len(pairs) + 1))[:total]
    return np.array([i for i, _ in plist]), np.array([j for _, j in plist])


def register_pass(clouds, cfg, ii, jj, batch: int, dev: torch.device):
    """One pass: prep every fragment, then every batch, queued back to back.

    Batch ``s`` draws its RANSAC hypotheses from a generator seeded with its
    start index ``s`` (``bench.py``'s ``fold_in(PRNGKey(0), s)``). Returns
    (prepped fragments, results a batch); nothing here waits for the card.
    """
    from elasticreconstruction_tpu_torch.registration import prep_fragments_batch, register_prepped_batch

    prepped = prep_fragments_batch(clouds, cfg, device=dev)
    results = [
        register_prepped_batch(prepped, ii[s : s + batch], jj[s : s + batch],
                               torch.Generator().manual_seed(s), cfg, device=dev)
        for s in range(0, len(ii), batch)
    ]
    return prepped, results


def timed_passes(clouds, cfg, ii, jj, batch: int, passes: int, dev: torch.device):
    """``passes`` timed passes after one warm prep and batch; returns (pairs/s a pass, the last pass)."""
    from elasticreconstruction_tpu_torch.registration import prep_fragments_batch, register_prepped_batch

    prepped = prep_fragments_batch(clouds, cfg, device=dev)
    res = register_prepped_batch(prepped, ii[:batch], jj[:batch], torch.Generator().manual_seed(0), cfg,
                                 device=dev)
    readback(dev, res.fitness, res.transform)
    rates, last = [], None
    for _ in range(passes):
        t0 = time.perf_counter()
        last = register_pass(clouds, cfg, ii, jj, batch, dev)
        readback(dev, *(t for r in last[1] for t in (r.fitness, r.transform)))
        rates.append(len(ii) / (time.perf_counter() - t0))
    return rates, last


def readback_rtt_ms(dev: torch.device) -> float:
    """Mean ms of a trivial one-element op read back with ``.item()``, over 5 after one warm."""
    x = torch.zeros((), device=dev)
    (x + 1.0).item()
    t0 = time.perf_counter()
    for _ in range(5):
        (x + 1.0).item()
    return (time.perf_counter() - t0) / 5 * 1e3


def phase_timings(prepped, clouds, ii, jj, batch: int, cfg, dev: torch.device) -> dict:
    """Best-of-3 wall ms of each phase of the first batch, after one warm call (``bench.py:76-158``)."""
    from elasticreconstruction_tpu_torch.core import se3
    from elasticreconstruction_tpu_torch.core.types import PointCloud
    from elasticreconstruction_tpu_torch.kernels import knn
    from elasticreconstruction_tpu_torch.registration import (
        features, icp, infomat, prep_fragments_batch, ransac,
    )

    bi = torch.as_tensor(ii[:batch], device=dev)
    bj = torch.as_tensor(jj[:batch], device=dev)
    pi, pj = prepped.take(bi), prepped.take(bj)
    src = PointCloud(*(x[:, :: cfg.icp_src_stride] for x in pj.fine))

    def match_ransac():
        corr, cm = features.match_features(pj.features, pj.coarse.mask, pi.features, pi.coarse.mask)
        return ransac.ransac_alignment(pj.coarse.points, pi.coarse.points, corr, cm,
                                       torch.Generator().manual_seed(7),
                                       inlier_threshold=cfg.inlier_threshold,
                                       edge_similarity=cfg.edge_similarity,
                                       num_hypotheses=cfg.num_hypotheses)

    def icp_phase(init):
        return icp.icp_point_to_plane_batch(
            src, pi.fine, init, max_correspondence_distance=cfg.inlier_threshold,
            iterations=cfg.icp_iterations, coarse_iterations=cfg.icp_coarse_iterations,
            coarse_stride=cfg.icp_coarse_stride)

    def info_phase(T):
        p = se3.apply(T, pj.fine.points)
        d2, _ = knn.nearest_auto_batch(p, pi.fine.points, pi.fine.mask)
        return infomat.information_matrix(p, pj.fine.mask & (d2 < cfg.inlier_threshold ** 2))

    def best_of(fn, *args):
        out = fn(*args)
        readback(dev, *leaves(out))
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            readback(dev, *leaves(fn(*args)))
            ts.append(time.perf_counter() - t0)
        return min(ts) * 1e3, out

    t_prep, _ = best_of(lambda: prep_fragments_batch(clouds, cfg, device=dev))
    t_mr, rr = best_of(match_ransac)
    t_icp, ir = best_of(icp_phase, rr.transform)
    t_info, _ = best_of(info_phase, ir.transform)
    return {"prep_all_fragments_ms": t_prep, "match_ransac_ms": t_mr, "icp_ms": t_icp, "infomat_ms": t_info}


def wavy_wall(num_frames: int, intr) -> np.ndarray:
    """``bench.py:193-202``'s analytic depth: a wavy wall ~2 m away sliding sideways a frame."""
    u = (np.arange(intr.width) - intr.cx) / intr.fx
    v = (np.arange(intr.height) - intr.cy) / intr.fy
    uu, vv = np.meshgrid(u, v)
    frames = []
    for k in range(num_frames):
        z = 2.0 + 0.3 * np.sin(3.0 * (uu + 0.01 * k)) * np.cos(2.0 * vv)
        frames.append((z / np.sqrt(1 + uu**2 + vv**2)).astype(np.float32))
    return np.stack(frames)


def odometry_config(num_frames: int, raycast_scale: int):
    """``bench.py:206-212``: 128^3 volume of 2.4 cm, clouds of 1 << 16, 96 raycast steps."""
    from elasticreconstruction_tpu_torch.odometry import FragmentConfig, OdometryConfig

    return FragmentConfig(frames_per_fragment=num_frames, volume_shape=(128, 128, 128), voxel_size=0.024,
                          cloud_capacity=1 << 16,
                          odometry=OdometryConfig(raycast_steps=96, raycast_scale=raycast_scale))


def odometry_frames_per_second(num_frames: int, dev: torch.device) -> dict:
    """Frames/s of one ``build_fragment`` over ``num_frames + 1`` wall frames at
    raycast scales 1 and 2: one warm call, then the best of 2."""
    from elasticreconstruction_tpu_torch.core import camera as cam
    from elasticreconstruction_tpu_torch.odometry import build_fragment

    intr = cam.Intrinsics(*ODOMETRY_INTRINSICS)
    depths = torch.from_numpy(wavy_wall(num_frames + 1, intr)).to(dev)
    out = {}
    for scale in (1, 2):
        fcfg = odometry_config(num_frames, scale)
        res = build_fragment(depths, intr, fcfg)
        readback(dev, res.local_poses, res.cloud.points[::64])
        ts = []
        for _ in range(2):
            t0 = time.perf_counter()
            res = build_fragment(depths, intr, fcfg)
            readback(dev, res.local_poses, res.cloud.points[::64])
            ts.append(time.perf_counter() - t0)
        out[f"raycast_scale_{scale}"] = num_frames / min(ts)
    return out


def run(device="cuda", *, sizes: dict | None = None, cfg=None) -> dict:
    """The benchmark on ``device``; returns the record ``main`` prints.

    ``sizes`` (keys of ``CARD_SIZES``) and the ``RegistrationConfig`` ``cfg``
    default to the device's sizes and the production defaults (4096/8192 caps);
    tests pass smaller ones.
    """
    import kernels_bench_gpu
    from elasticreconstruction_tpu_torch.bench_scene import make_fragments
    from elasticreconstruction_tpu_torch.core.types import resolve_device
    from elasticreconstruction_tpu_torch.registration import RegistrationConfig

    dev = resolve_device(device)
    size = sizes or (CARD_SIZES if dev.type == "cuda" else CPU_SIZES)
    batch, passes = size["batch"], size["passes"]
    cfg = cfg or RegistrationConfig()
    clouds, _ = make_fragments(size["num_frag"], n=size["points"])
    ii, jj = pair_lists(size["num_frag"], batch, size["reps"])
    rtt = readback_rtt_ms(dev)
    rates, (prepped, results) = timed_passes(clouds, cfg, ii, jj, batch, passes, dev)
    pairs_per_second = statistics.median(rates)
    succ = torch.cat([r.success for r in results]).cpu().numpy()
    adj = succ[np.abs(ii - jj) == 1]
    phases = phase_timings(prepped, clouds, ii, jj, batch, cfg, dev)
    odo = odometry_frames_per_second(size["odometry_frames"], dev)
    return {
        "metric": "registration_pairs_per_second",
        "value": pairs_per_second,
        "unit": "pairs/s/chip",
        "vs_baseline": pairs_per_second / REFERENCE_PAIRS_PER_SECOND,
        "platform": dev.type,
        "batch": batch,
        "num_fragments": size["num_frag"],
        "pairs_timed": len(ii),
        "passes": passes,
        "pass_rates": rates,
        "readback_rtt_ms": rtt,
        "success_rate_adjacent": float(adj.mean()) if len(adj) else None,
        "phase_ms_per_batch": phases,
        "odometry_frames_per_second": odo,
        "device": kernels_bench_gpu.card_line() if dev.type == "cuda" else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device to measure (default: the card)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
