#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA versions.
2. Build: compiles every hand-written kernel from ``csrc/`` (one nvcc each, in
   parallel).
3. Kernel parity: each kernel against its plain PyTorch version on the card,
   plus CUDA-event times of the kernel, the plain version and, where there is
   one, a library yardstick; a kernel's bound counts only the valid refs,
   which is all its function needs to scan. The two pipeline kernels are held at every shape
   the paths launch them at (``NN_SHAPES``, ``ICP_SHAPES``, ``DIST_NN_SHAPES``,
   ``MILESTONE_NN_SHAPES``, with a partly masked ref set) and at ragged ones: sizes that are multiples of nothing,
   fewer refs than one chunk, one batch, refs all masked (which must give
   (3e38, 0)) and duplicated refs (the first index must win). Every call is
   made twice and must give the same bits. Their compiled main loop's opcode
   counts per pair are printed. ``nearest_batch`` is also held at the
   correspondence harvest's shape, (1, 131072, 131072) with 60 000 valid refs:
   on the first 8192 queries against every ref, indices equal and d2 within
   1e-5; 64 or more ref splits and a scratch cache grown to them. The compare+select and threshold-sum chains must
   equal their plain versions bit for bit; the FMA chain within 2e-5 relative
   (one rounding per step against the plain version's two, 64 steps).
4. Registration path at full width: 6 fragments of 20 000 points (the registration
   benchmark's scene), ``prep_fragments_batch`` and ``register_prepped_batch``
   with ``RegistrationConfig()`` defaults over all 15 pairs x4 in 4 batches of
   16, ``refine_edges_batch`` on the 5 adjacent pairs and one more batch with
   ``fused_step=True``; every adjacent pair must register within 2 cm / 0.02 rad
   of ground truth and both kernels' launch counts must be > 0. Then the same
   small scene registered on the card and on the CPU (plain versions) must agree,
   and the ``loop.log``/``loop.info`` files must read back. The timed pass and
   the pair list are ``bench_gpu.py``'s.
5. Benchmark (``phase_bench``): ``bench_gpu.run`` at its card sizes, the
   ``bench.py`` workload (6 fragments, 4 batches of 16 pairs, 5 timed passes,
   the four phase times, 50-frame ``build_fragment`` at raycast scales 1 and 2);
   its JSON line, printed as is, must show every adjacent pair registered, and
   ``nearest_batch`` must have been launched (path ``bench``).
6. Calibration path: ``kernels_bench_gpu.calibrate`` at full shape (the
   opcode counts of the calibration kernels' SASS loop bodies, FFMA / FSETP /
   FSEL ..., which must show the FMA chain executing one FFMA per step; one JSON
   line of peaks, each with its share of the data sheet; a peak over 105% of
   the data sheet fails) and ``bench_kernels`` for ``nn``, ``icp``, ``fpfh``
   and ``voxel`` (one JSON line of scored entries).
7. Stage path: 24 fragments of 20 000 points written as fragment artifacts,
   then the ``register`` and ``posegraph`` CLI verbs at the default
   configuration; every odometry edge and every accepted loop edge two
   fragments apart within 2 cm / 0.02 rad of ground truth (measured at the
   fragment's centroid), no aliased loop edge kept. ``pose.log`` is held to
   ground truth twice: as the verb writes it, within 2 cm + 1% of the
   distance from fragment 0, and after ``run_posegraph`` with 32 Gauss-Newton
   steps per alternation instead of 8, within 5 cm at every fragment (see
   ``POSE_LOG_*`` below for why the two differ).
8. Fragments path: the port renders a synthetic dataset on the card (the
   livingroom, config 3's orbit of radius 1.1 m at 1.3 m, 151 frames at its
   per-frame motion, PrimeSense 640x480, 1 cm depth noise, seed 0, written as
   PNG), then the ``fragments`` (3 fragments of 50 frames, the ``full``
   preset), ``register`` and ``posegraph`` CLI verbs. Every local pose within
   2 cm / 0.02 rad of ground truth, every fragment's tracking fitness above
   0.5, more than 20 000 points per cloud, the clouds on the scene surface
   (mean |SDF| under 3 cm), both odometry edges within 2 cm / 0.02 rad at the
   fragment's centroid, and ``nearest_batch`` launched by ``register``. Printed:
   render and verb seconds, frames/s, per-frame ms of fuse, raycast, the
   Gauss-Newton levels of ``track_frame`` and surface extraction (device time
   by ``cuda_ms``, wall time, profiled device-busy time), host synchronisations
   per frame, peak memory and the device profile of one ``build_fragment``.
9. Scene path, on the fragments path's directory: the ``optimize
   --slac-mode none``, ``integrate`` and ``evaluate`` verbs, each timed with
   its peak memory. ``trajectory.log`` holds every frame of the 3 fragments,
   ``ate.json``'s ATE is under 2 cm, ``mesh.ply`` parses with more than
   10 000 faces whose vertices lie on the scene (aligned at frame 0: mean
   |SDF| under 1 cm, 95% within 2 cm), ``registration_pr.json`` is written,
   and ``nearest_batch`` was launched by the harvest. Then ``run_integrate``
   again on 2 x 1 x 2 blocks must give the one-block mesh (faces within 0.1%,
   99% of the vertices within 0.1 mm), and the per-frame fuse and
   ``extract_mesh`` are profiled at the scene's tile. One JSON line
   ``{"scene_path": ...}`` carries the numbers.
10. Distributed paths (``dist/``) at full width, each against the
   single-device path on the same inputs: pair sharding on the ``bench.py``
   workload (one batch of 16 pairs, again with ``fused_step=True``, and 4
   pairs prepped inline), the ring over its 6 fragments padded to 8, the
   edge-sharded pose graph on the stage path's 24-fragment graph, the
   correspondence-sharded PCG at 696 320 rows in slac and nonrigid mode, and
   the scene path's 240 x 155 x 106 block x-sharded over 16 frames (both
   fuses), then meshed. At world size 1 (NCCL, in this process) every result
   must equal the single-device one bit for bit; at 2 (gloo, two processes
   sharing the card; NCCL cannot put two ranks on one card) within the bounds
   of ``SHARD_*``, the ring's lanes bit-equal to the same lanes batched as it
   ran them, and a second run must give the same bits; one rank a card under
   NCCL where there are two cards or more. Walls, peak memory a rank, the
   kernels' launches by shape and the collectives gloo staged through host
   memory are printed a run.
11. Determinism, on the fragments path's ``fragments/``: ``register`` ->
   ``posegraph`` -> ``optimize --slac-mode none`` -> ``integrate`` run twice
   must write the same bytes, and ``prep_fragments_batch`` give the same bits
   twice (``tools/repeat_check.py``).
12. Elastic path, on the same directory (milestone config 4 cut as config 3
   is): ``optimize`` in ``rigid``, ``slac`` and ``nonrigid``, each followed
   by ``integrate`` and ``evaluate`` and timed with its peak memory; in every
   mode ``rmse_after <= rmse_before``, ``pose_slac.log`` and the lattice files
   read back finite, ATE under 2 cm, the mesh on the surface as in phase 9,
   and ``optimize`` run again writes the same bytes; each mode's ``optimize``
   launched ``nearest_batch`` at the harvest shape. Then config 4d (the
   orbit rendered through an injected depth distortion, ``fragments`` ->
   ``register`` -> ``posegraph``, ``optimize`` rigid and slac with its
   settings, the learned lattice scored against the field) and config 4n
   (the clouds through per-fragment warps, ``register`` -> ``posegraph`` ->
   ``optimize`` rigid and nonrigid, surface error of the corrected clouds),
   both gated on finite numbers only, each with its own launch counts
   (paths ``distorted`` and ``warped``); ``optimize_fragments`` on the slac
   path's correspondences on the card and on the CPU (``CARD_CPU_*``);
   ``nearest_batch`` at a re-association query against its plain version;
   and the optimiser at config 3's full length (``BIG_*``, 696 320 rows) in
   slac and nonrigid mode, timed and profiled.
13. The ``all`` verb on a fresh directory: 21 frames of the same orbit at the
   ``fast`` preset, with ``--slac-mode none`` and at the default mode (slac),
   every artifact written, ATE under 3 cm; then the default mode's
   ``optimize`` on the CPU from the card's upstream, within
   ``CARD_CPU_VERB_ATOL`` of the card's files.
14. The milestone ladder (``tools/milestones.py``) at its full width: config
   3 cut in depth to its first 201 frames (4 fragments; 320x240, 128^3 volumes of 2.4
   cm, 96 raycast steps, clouds of 1 << 16 rows, batches of 16) with ATE
   under 2 cm, then config 4 slac and config 4n on its directory; the
   ``register`` verb under ``--profile``, whose trace must hold CUDA kernel
   events of ``nearest_kernel``; ``tools/ring_scale.py`` at world size 1
   (NCCL) over the 4 fragments (every wanted pair in one lane) and
   ``tools/reg_profile.py``; then ``nearest_batch`` at the ladder's harvest
   shape, (1, 65536, 65536), against its plain version as in phase 3. One
   JSON line ``{"milestones_path": ...}``.
15. One JSON line of per-kernel numbers, then the last line
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
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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
# Fragments path: milestone config 3's scene and orbit (radius 1.1 m, height
# 1.3 m, 1 cm depth noise), cut from 2550 frames to 151 at the same motion
# per frame: 3 fragments of 50 frames at the full preset.
FRAG_FRAMES = 151
FRAG_ORBIT = dict(scene="livingroom", trajectory="orbit", radius=1.1, height=1.3,
                  sweep=2 * np.pi * FRAG_FRAMES / 2550, depth_noise=0.01)
FRAG_MIN_POINTS = 20000
FRAG_MIN_FITNESS = 0.5
FRAG_SURFACE_M = 0.03  # mean |SDF| at the cloud points (tests/test_odometry.py)
# FMA chain against its plain version: the kernel rounds once per step, the
# plain version twice (multiply, add), each up to 2^-24 relative, over 64
# steps whose multiplier 1 + k ulp rounds the same way every step: up to
# ~3 * 64 * 2^-24 = 1.1e-5.
FMA_CHAIN_RTOL = 2e-5
# Scene path on the fragments path's 3 fragments: the local poses are within
# 6.1 mm of ground truth (PERF.md, PR 4) and the builders' full-length config
# 3 ATE is 18.2 mm (ROADMAP.md); the mesh is held as the clouds are, tighter.
SCENE_ATE_M = 0.02
SCENE_MIN_FACES = 10000
SCENE_MESH_MEAN_M = 0.01
SCENE_MESH_SHARE = 0.95  # of the vertices within 2 cm of the surface
BLOCKS_FACES_RTOL = 1e-3
BLOCKS_VERTEX_M = 1e-4
BLOCKS_SHARED = 0.99  # of the block mesh's vertices within BLOCKS_VERTEX_M of the one-block mesh
# The all verb at a small size: 21 frames (2 fragments) of the same orbit, fast preset.
ALL_FRAMES = 21
ALL_ATE_M = 0.03
ALL_ARTIFACTS = ("fragments/fragments.log", "registration/odometry.log", "registration/loop.log",
                 "posegraph/pose.log", "slac/pose_slac.log", "integrate/mesh.ply", "integrate/trajectory.log",
                 "integrate/ate.json", "registration/gt.log", "registration/gt.info",
                 "registration/registration_pr.json")
CALIB_PARITY_SHAPE = (4096, 512)
# Elastic path: milestone config 4 (milestones.py:315-324) on the fragments
# path's directory, cut as config 3 is (3 fragments, full preset), in each mode.
ELASTIC_MODES = ("rigid", "slac", "nonrigid")
ELASTIC_ATE_M = SCENE_ATE_M
# optimize_fragments on one correspondence set, the card against the CPU
# (poses, displacements in m, final RMSE relative). The pose bound is the one
# tests/test_torch_elastic_slac.py holds the port to against the JAX package;
# the other two are tighter than that test's (1e-4 m; 5e-5 relative + 2 um),
# since card and CPU run the same code with the same fixed-order segment sums
# and differ only in the rounding of the torch ops, where the port and the
# JAX package also sum in different orders.
CARD_CPU_POSE_ATOL = 2e-4
CARD_CPU_DISP_ATOL = 5e-5
CARD_CPU_RMSE_RTOL = 1e-5
# The optimize verb at the default mode, the card against the CPU from one
# upstream (the harvest too): the tolerances of tests/test_torch_elastic_stage.py
# on pose_slac.log and on ctr.txt (m) against the JAX package.
CARD_CPU_VERB_ATOL = {"pose_slac.log": 5e-4, "ctr.txt": 2e-4}
# Config 4d (milestones.py:327-411): the injected distortion and its settings.
DIST_SEED = 42
DIST_FIELD = dict(radial_a=0.015, depth_b=0.004, grid_sigma=0.006)
DIST_SLAC = dict(disp_prior_weight=0.01, arap_weight=1.0, outer_iterations=8)
DIST_PIPELINE = dict(corres_max_distance=0.07, corres_rounds=5, corres_distance_decay=0.7,
                     corres_baseline_weight=4.0)
# Config 4n (milestones.py:414-489): per-fragment warps and their settings.
WARP_SEED = 1000
WARP_AMPLITUDE_M = 0.03
WARP_LATTICE = (8, 3.0, (-1.5, -1.5, 0.0))
WARP_SLAC = dict(disp_prior_weight=0.003, arap_weight=1.0, outer_iterations=10)
WARP_PIPELINE = dict(corres_max_distance=0.06, corres_rounds=3, corres_distance_decay=0.6,
                     corres_reassoc_pair_transforms=True)
# The optimiser at config 3's full length: 51 fragments, 170 edges x 4096 rows
# = 696 320 correspondences (the production count elastic/slac.py cites).
BIG_FRAGMENTS, BIG_EDGES, BIG_ROWS = 51, 170, 4096

# The distributed phase (``dist/``): every path at full width at world size 1
# (NCCL, in this process), 2 (gloo, two processes sharing cuda:0; NCCL cannot
# put two ranks on one card), twice, and one rank a card under NCCL where
# there are two cards or more; each against the single-device path.
SHARD_PAIRS = 16  # one batch of the bench.py workload's pairs
SHARD_INLINE_PAIRS = 4  # register_pairs_sharded preps its clouds inline
SHARD_RING_INDEX = (0, 1, 2, 3, 4, 5, 0, 1)  # the 6 fragments padded to 8 by repeats
SHARD_RING_BASE = 7
SHARD_FRAMES = 16
SHARD_T_ATOL, SHARD_INFO_RTOL, SHARD_INFO_ATOL = 1e-5, 1e-4, 1e-2  # tests/test_ring.py:92-97
# The ring's lanes against the replicated enumeration, a batch of other
# pairs: ICP's batch-wide early exit keeps a converged lane stepping (each
# step under 1e-5) until the last lane of its batch converges, so a lane's
# transform moves with its batch by up to 1e-5 a step, (12 + 30) steps, and
# its information matrix with it: held as two runs whose ICP stops differ are
# (tests/test_torch_slice.py), within 1e-3 of the matrix's largest entry. The
# ring's lanes against the same lanes batched as it ran them: bit for bit.
SHARD_RING_REPLICATED_T_ATOL = 1e-5 * (12 + 30)
SHARD_RING_REPLICATED_INFO_REL = 1e-3
SHARD_PGO_ATOL = 1e-3  # tests/test_dist.py:91-96
SHARD_SLAC_POSE_ATOL, SHARD_SLAC_RMSE_ATOL = 5e-3, 2e-3  # tests/test_dist.py:128-133
SHARD_TSDF_ATOL = 1e-6  # tests/test_dist.py:146-151
SHARD_TIMEOUT_S = 300.0


_T0 = time.perf_counter()


def phase_done(name: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f} s] {name} done", flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


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
# The dist path's other batches: the ring's 64 lanes at world size 1, the
# information query of the 8-pair shards, the 4 pairs prepped inline (2 a
# rank at world size 2); its 16-lane ring steps are among the shapes above.
DIST_NN_SHAPES = [(64, 4096, 8192), (64, 1024, 8192), (64, 8192, 8192), (8, 8192, 8192), (4, 4096, 8192),
                  (4, 1024, 8192), (4, 8192, 8192), (2, 4096, 8192), (2, 1024, 8192), (2, 8192, 8192)]
# The milestones path's other batches: the 4-fragment cut's 3 non-adjacent
# pairs in one batch, and its single-pair queries; its 16-lane ring steps are
# among NN_SHAPES, its harvest is held by check_nearest_at_harvest_shape.
MILESTONE_NN_SHAPES = [(3, 1024, 8192), (3, 2048, 8192), (3, 4096, 8192), (3, 8192, 8192), (1, 8192, 8192)]
# The correspondence harvest's query: fragment clouds padded to the full
# preset's capacity, about as full as config 3's (54-61k points, PERF.md).
HARVEST_CAPACITY = 1 << 17
HARVEST_POINTS = 60000
HARVEST_PLAIN_QUERIES = 8192
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
    valid = int(m.sum())  # the scan needs only the valid refs
    bnd, by = bound_ms(NN_OPS_PER_PAIR * nq * valid, 4 * 3 * (b * nq + valid) + b * nr + 8 * b * nq)
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
    valid = int(args[4].sum())  # the scan needs only the valid refs
    bnd, by = bound_ms(NN_OPS_PER_PAIR * n * valid + ICP_OPS_PER_QUERY * b * n,
                       4 * (4 * b * n + 6 * valid) + b * m + 4 * 29 * b)
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


def check_nearest_at_harvest_shape(rng, dev, capacity: int = HARVEST_CAPACITY, points: int = HARVEST_POINTS,
                                   note: str = "harvest", min_splits: int = 64) -> dict:
    """``nearest_batch`` at a harvest's shape: two padded fragment clouds of
    ``capacity`` rows, ``points`` of them valid (by default the full preset's,
    ``HARVEST_*``). The plain version runs on the first
    ``HARVEST_PLAIN_QUERIES`` queries against every ref; there the indices
    must be equal and d2 within 1e-5. The launch must split the refs
    ``min_splits`` ways or more, and the scratch cache must have grown to its
    partial results."""
    from elasticreconstruction_tpu_torch.kernels.cuda import build, nn

    n, k = capacity, HARVEST_PLAIN_QUERIES
    ref, _ = surface(rng, (1, n))
    query, _ = surface(rng, (1, n))
    query += rng.normal(0.0, 0.01, query.shape).astype(np.float32)
    mask = np.zeros((1, n), bool)
    mask[:, :points] = True
    q, r, m = (torch.from_numpy(x).to(dev) for x in (query, ref, mask))
    name = f"nearest_batch {(1, n, n)} ({note})"
    d_k, i_k = twice(name, lambda: nn.nearest_batch(q, r, m))
    d_p, i_p = nn.nearest_batch_plain(q[:, :k], r, m)
    torch.cuda.synchronize()
    mismatches = int((i_k[:, :k] != i_p).sum())
    err = (d_k[:, :k] - d_p).abs().max().item()
    geo = nn.plan(1, n, n, nn.sm_count(q.device.index))
    floats = 2 * geo.splits * geo.tiles * nn.QUERIES_PER_BLOCK
    cached = build._scratch[q.device].numel()
    print(f"{name}: on the first {k} queries index mismatches {mismatches}, max |d2 kernel - plain| {err:.3g}; "
          f"grid {(geo.tiles, geo.splits, 1)}, {geo.range} refs a block, scratch {4 * floats / 1e6:.1f} MB "
          f"(cache {4 * cached / 1e6:.1f} MB)")
    if mismatches or not err <= 1e-5:
        fail(f"{name}: {mismatches} index mismatches, max |d2 difference| {err} (want 0 and <= 1e-5)")
    if geo.splits < min_splits or cached < floats:
        fail(f"{name}: {geo.splits} ref splits, scratch cache {cached} floats < {floats}")
    ms = cuda_ms(lambda: nn.nearest_batch(q, r, m), reps=10)
    one_call = call_ms(lambda: nn.nearest_batch(q, r, m), reps=10)
    qk, r_far = q[:, :k], torch.where(m[..., None], r, 1e18)
    plain = cuda_ms(lambda: nn.nearest_batch_plain(qk, r, m), reps=2, warmup=1)
    lib = cuda_ms(lambda: torch.cdist(qk, r_far, compute_mode="use_mm_for_euclid_dist").min(dim=-1), reps=3)
    bnd, by = bound_ms(NN_OPS_PER_PAIR * n * points, 4 * 3 * (n + points) + n + 8 * n)
    valid_share = points / n
    print(f"  ms kernel {ms:.4f} (one call {one_call:.4f}), bound {bnd:.4f} ({by}), time/bound {ms / bnd:.2f}; "
          f"over {k} queries: plain {plain:.4f}, cdist+min {lib:.4f}; valid refs {valid_share:.3f} of those scanned")
    return {"max_abs_err": err, "ms": ms, "call_ms": one_call, "plain_ms": None, "library_ms": None,
            "plain_ms_first_queries": plain, "library_ms_first_queries": lib, "first_queries": k,
            "bound_ms": bnd, "bound_by": by, "shape": [1, n, n], "index_mismatches": mismatches,
            "splits": geo.splits, "scratch_mb": 4 * floats / 1e6, "valid_ref_share": valid_share}


def phase_kernel_parity() -> dict:
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    print_main_loops()
    nn_by_shape = [check_nearest(*nn_inputs(rng, *shape, dev), time_plain=True) for shape in NN_SHAPES]
    nn_by_shape += [check_nearest(*nn_inputs(rng, *shape, dev)) for shape in DIST_NN_SHAPES]
    nn_by_shape += [check_nearest(*nn_inputs(rng, *shape, dev), time_plain=True) for shape in MILESTONE_NN_SHAPES]
    nn_by_shape.append(check_nearest_at_harvest_shape(rng, dev))
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


def phase_bench() -> dict:
    """``bench_gpu.py``'s benchmark at its card sizes, counted as path ``bench``:
    its JSON line, every adjacent pair registered, ``nearest_batch`` launched."""
    import bench_gpu

    reset_launch_counts()
    t0 = time.perf_counter()
    rec = bench_gpu.run("cuda")
    counts = launch_counts()
    print(json.dumps(rec))
    print(json.dumps({"bench_launches_by_shape": launches_by_shape(), "bench_seconds": time.perf_counter() - t0}))
    require_launched("bench", counts, ["nearest_batch"])
    if rec["success_rate_adjacent"] != 1.0:
        fail(f"bench: adjacent pairs registered at {rec['success_rate_adjacent']}, not 1.0")
    return counts


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

    The timed pass is ``bench_gpu.register_pass``: prep + every register batch,
    queued back to back, with one synchronisation at the end.
    """
    import bench_gpu
    from elasticreconstruction_tpu_torch.bench_scene import make_fragments
    from elasticreconstruction_tpu_torch.kernels.cuda import icp_step, nn
    from elasticreconstruction_tpu_torch.registration import refine_edges_batch, register_prepped_batch

    clouds, poses = make_fragments(num_frag, n=n, seed=seed)
    ii, jj = bench_gpu.pair_lists(num_frag, batch, reps)
    counts = {}

    def count(part):  # kernel launches since the previous part, per kernel
        now = (nn.launches, icp_step.launches)
        counts[part] = [a - b for a, b in zip(now, count.last)]
        count.last = now

    count.last = (nn.launches, icp_step.launches)
    synchronize(dev)
    t0 = time.perf_counter()
    prepped, results = bench_gpu.register_pass(clouds, cfg, ii, jj, batch, dev)
    synchronize(dev)
    wall = time.perf_counter() - t0
    count(f"prep + {len(results)} register batches")

    # The odometry-chain refinement, initialised from the registered adjacent edges.
    transforms = torch.cat([r.transform for r in results])
    adj_i = np.arange(num_frag - 1)
    first = [int(np.nonzero((ii == i) & (jj == i + 1))[0][0]) for i in adj_i]
    refined, refined_info = refine_edges_batch(prepped, adj_i, adj_i + 1, transforms[first], cfg)
    count("refine_edges_batch")
    fused = register_prepped_batch(prepped, ii[:batch], jj[:batch], torch.Generator().manual_seed(seed), cfg,
                                   fused_step=True, device=dev)
    count("fused_step register batch")
    synchronize(dev)
    return {"prepped": prepped, "results": results, "ii": ii, "jj": jj, "poses": poses,
            "refined": refined, "refined_info": refined_info, "adj_i": adj_i, "fused": fused,
            "wall_s": wall, "pairs": len(ii), "launches_by_part": counts}


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
           "kernels": sum(e.count for e in rows),
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


def posegraph_inputs(out: str) -> dict:
    """The pose graph the ``posegraph`` verb builds from ``out``'s registration
    files (odometry edges, then loop edges; no suspect edges), as numpy arrays
    with the initial poses of ``fragments.log``."""
    from elasticreconstruction_tpu_torch.core import io_logfmt

    reg = os.path.join(out, "registration")
    odo, loop = (io_logfmt.read_log(os.path.join(reg, f"{k}.log")).entries for k in ("odometry", "loop"))
    info = [e.info for k in ("odometry", "loop") for e in io_logfmt.read_info(os.path.join(reg, f"{k}.info")).entries]
    edges = list(odo) + list(loop)
    return {"i": np.array([e.i for e in edges]), "j": np.array([e.j for e in edges]),
            "transform": np.stack([e.transform for e in edges]).astype(np.float32),
            "information": np.stack(info).astype(np.float32),
            "is_odometry": np.array([True] * len(odo) + [False] * len(loop)),
            "init": io_logfmt.read_log(os.path.join(out, "fragments", "fragments.log")).matrices().astype(np.float32)}


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
        graph = posegraph_inputs(tmp)
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
    out["graph"] = graph
    return out


def frame_op_times(vol, depth, pose, intr, cfg) -> dict:
    """Per-frame cost of each op of the fragment loop at full width: device time
    (``cuda_ms``), wall time of one call on an idle card (``call_ms``) and the
    profiled device-busy time with its kernel count."""
    from elasticreconstruction_tpu_torch.kernels import raycast, tsdf
    from elasticreconstruction_tpu_torch.odometry import kinfu

    ocfg = cfg.odometry
    model = raycast.raycast(vol, pose, intr, depth_min=ocfg.depth_min, depth_max=ocfg.depth_max,
                            num_steps=ocfg.raycast_steps)
    depths, intrs = [depth], [intr]
    for _ in range(ocfg.levels - 1):
        depths.append(kinfu.pyramid_down(depths[-1]))
        intrs.append(intrs[-1].scaled(0.5))
    ops = {
        "fuse": lambda: tsdf.fuse(vol, depth, pose, intr, max_weight=cfg.max_weight,
                                  depth_min=cfg.depth_min, depth_max=cfg.depth_max),
        "raycast": lambda: raycast.raycast(vol, pose, intr, depth_min=ocfg.depth_min,
                                           depth_max=ocfg.depth_max, num_steps=ocfg.raycast_steps),
        **{f"track_frame level {lvl} ({ocfg.iterations[lvl]} GN steps)":
           (lambda lvl=lvl: kinfu._gn_level(depths[lvl], intrs[lvl], model, pose, intr, pose, pose,
                                            ocfg.iterations[lvl], ocfg))
           for lvl in range(ocfg.levels)},
        "track_frame (whole)": lambda: kinfu.track_frame(vol, depth, pose, intr, ocfg),
        "extract_surface_points": lambda: tsdf.extract_surface_points(vol, capacity=cfg.cloud_capacity),
    }
    out = {}
    for name, fn in ops.items():
        prof = device_profile(name, fn, top=4)
        out[name] = {"cuda_ms": cuda_ms(fn, reps=5, warmup=1), "call_ms": call_ms(fn, reps=5, warmup=1),
                     "device_busy_ms": prof["device_busy_ms"], "kernels": prof["kernels"]}
    return out


def syncs_per_frame(vol, depth, pose, intr, cfg) -> int:
    """Host synchronisations that one frame of the fragment loop (track + fuse) makes."""
    from elasticreconstruction_tpu_torch.kernels import tsdf
    from elasticreconstruction_tpu_torch.odometry import kinfu

    def frame():
        tr = kinfu.track_frame(vol, depth, pose, intr, cfg.odometry)
        tsdf.fuse(vol, depth, tr.pose, intr, max_weight=cfg.max_weight, depth_min=cfg.depth_min,
                  depth_max=cfg.depth_max)

    syncs, by_line = count_host_syncs(frame)
    print(json.dumps({"host_syncs_one_frame": syncs, "by_line": by_line}))
    return syncs


def fragments_path(dev, tmp: str, intr, num_frames: int, extra_argv=(), seed: int = 0, distortion=None) -> dict:
    """Render the dataset on ``dev`` (through ``distortion`` if given), run the
    ``fragments``, ``register`` and ``posegraph`` verbs there and hold their
    files to ground truth. Returns the record with its ``faults`` (empty when
    every check passed)."""
    from elasticreconstruction_tpu_torch.bench_scene import placement_error, pose_error
    from elasticreconstruction_tpu_torch.core import io_logfmt
    from elasticreconstruction_tpu_torch.pipeline import dataset, run
    from elasticreconstruction_tpu_torch.synthetic import scenes

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    data, out = os.path.join(tmp, "data"), os.path.join(tmp, "out")
    sync()
    t0 = time.perf_counter()
    ds = dataset.generate_synthetic(data, num_frames=num_frames, intr=intr, seed=seed, device=dev,
                                    distortion=distortion, **FRAG_ORBIT)
    rec = {"frames": num_frames, "render_s": time.perf_counter() - t0}
    gt = ds.gt_poses.astype(np.float64)
    argv = ["--data", data, "--out", out, "--seed", str(seed), "--device", str(dev), *extra_argv]
    K = run.config_from_args(run.build_parser().parse_args(["fragments", *argv])).frames_per_fragment
    for verb in ("fragments", "register", "posegraph"):
        sync()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if run.main([verb, *argv]) != 0:
            fail(f"the {verb} verb returned non-zero")
        sync()
        rec[verb + "_s"] = time.perf_counter() - t0
        if dev.type == "cuda":
            rec[verb + "_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    nf = max(1, (num_frames - 1) // K)
    rec.update(fragments=nf, seconds_per_fragment=rec["fragments_s"] / nf,
               frames_per_second=nf * (K + 1) / rec["fragments_s"])

    faults = []
    frag_dir = os.path.join(out, "fragments")
    scene = scenes.livingroom_scene()
    per_fragment, centroids = [], []
    for f in range(nf):
        local = io_logfmt.read_log(os.path.join(frag_dir, f"local_{f}.log")).matrices()
        errs = [pose_error(local[k], np.linalg.inv(gt[f * K]) @ gt[f * K + k]) for k in range(K + 1)]
        te, re = max(e[0] for e in errs), max(e[1] for e in errs)
        with open(os.path.join(frag_dir, f"health_{f}.json")) as hf:
            health = json.load(hf)
        pts, nrm = io_logfmt.read_pcd(os.path.join(frag_dir, f"cloud_bin_{f}.pcd"))
        centroids.append(pts.astype(np.float64).mean(0))
        world = pts.astype(np.float64) @ gt[f * K][:3, :3].T + gt[f * K][:3, 3]
        sdf = scene(torch.from_numpy(world.astype(np.float32)).to(dev)).abs().mean().item()
        per_fragment.append({"fragment": f, "worst_local_pose_m_rad": (te, re), "min_fitness": health["min_fitness"],
                             "min_obs_ratio": health["min_obs_ratio"], "suspect": health["suspect"],
                             "points": len(pts), "mean_abs_sdf_m": sdf})
        if not (te < GT_TRANSLATION_M and re < GT_ROTATION_RAD):
            faults.append(f"fragment {f}: a local pose is off ground truth by {te:.4f} m / {re:.4f} rad")
        if not health["min_fitness"] > FRAG_MIN_FITNESS:
            faults.append(f"fragment {f}: min_fitness {health['min_fitness']:.3f}")
        if not len(pts) > FRAG_MIN_POINTS:
            faults.append(f"fragment {f}: {len(pts)} cloud points")
        if not (sdf < FRAG_SURFACE_M and np.isfinite(pts).all() and np.isfinite(nrm).all()):
            faults.append(f"fragment {f}: cloud off the surface (mean |SDF| {sdf:.4f} m) or not finite")
    odo = io_logfmt.read_log(os.path.join(out, "registration", "odometry.log"))
    if [(e.i, e.j) for e in odo.entries] != [(f, f + 1) for f in range(nf - 1)]:
        faults.append("odometry.log does not hold every adjacent edge")
    edges = []
    for e in odo.entries:
        te, re = placement_error(e.transform, np.linalg.inv(gt[e.i * K]) @ gt[e.j * K], centroids[e.j])
        edges.append((e.i, e.j, te, re))
        if not (te < GT_TRANSLATION_M and re < GT_ROTATION_RAD):
            faults.append(f"odometry edge ({e.i}, {e.j}) off ground truth by {te:.4f} m / {re:.4f} rad")
    pose = io_logfmt.read_log(os.path.join(out, "posegraph", "pose.log")).matrices()
    if pose.shape != (nf, 4, 4) or not np.isfinite(pose).all():
        faults.append(f"pose.log holds {pose.shape} poses or non-finite values")
    rec.update(per_fragment=per_fragment, odometry_edges_m_rad=edges, faults=faults, dataset=ds)
    return rec


def phase_fragments(tmp: str, seed: int = 0) -> dict:
    """The fragments path at full width on the card (dataset and artifacts
    under ``tmp``), then the per-frame costs of its ops. Returns its record,
    the dataset under ``"dataset"``."""
    from elasticreconstruction_tpu_torch.core import se3
    from elasticreconstruction_tpu_torch.core.camera import PRIMESENSE
    from elasticreconstruction_tpu_torch.kernels import tsdf
    from elasticreconstruction_tpu_torch.odometry import build_fragment
    from elasticreconstruction_tpu_torch.odometry.fragments import _volume_origin
    from elasticreconstruction_tpu_torch.pipeline import run

    dev = torch.device("cuda")
    reset_launch_counts()
    rec = fragments_path(dev, tmp, PRIMESENSE, FRAG_FRAMES, seed=seed)
    rec["launches"] = launch_counts()
    print(json.dumps({"fragments_path_launches_by_shape": launches_by_shape()}))
    require_launched("fragments", rec["launches"], ["nearest_batch"])
    phase_done("fragments path: render, fragments, register and posegraph verbs")

    # Per-frame costs at full width: frame 1 against the model of frame 0,
    # at its ground-truth pose.
    ds = rec.pop("dataset")
    cfg = run.config_from_args(run.build_parser().parse_args(["fragments"])).fragment
    frames = torch.from_numpy(ds.depth_chunk(0, 11)).to(dev)
    vol = tsdf.make_volume(cfg.volume_shape, cfg.voxel_size, _volume_origin(cfg), device=dev)
    vol = tsdf.fuse(vol, frames[0], se3.identity(device=dev), ds.intrinsics, max_weight=cfg.max_weight,
                    depth_min=cfg.depth_min, depth_max=cfg.depth_max)
    pose1 = torch.from_numpy(np.linalg.inv(ds.gt_poses[0]) @ ds.gt_poses[1]).float().to(dev)
    rec["per_frame_ms"] = frame_op_times(vol, frames[1], pose1, ds.intrinsics, cfg)
    rec["host_syncs_per_frame"] = syncs_per_frame(vol, frames[1], pose1, ds.intrinsics, cfg)
    prof = device_profile(f"build_fragment ({len(frames)} frames)",
                          lambda: build_fragment(frames, ds.intrinsics, cfg), top=8, warm=False)
    rec["build_fragment_profile"] = {k: prof[k] for k in ("wall_ms", "device_busy_ms", "busy_share", "kernels")}
    faults = rec.pop("faults")
    print(json.dumps({"fragments_path": rec}))
    if faults:
        fail("fragments path: " + "; ".join(faults))
    rec["dataset"] = ds
    return rec


def run_verb(argv: list) -> list[dict]:
    """``run.main(argv)``, failing unless it returns 0; its stage log records
    (one JSON object a line on standard output), printed again as they came."""
    import contextlib
    import io

    from elasticreconstruction_tpu_torch.pipeline import run

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = run.main(argv)
    text = buf.getvalue()
    print(text, end="", flush=True)
    if code != 0:
        fail(f"the {argv[0]} verb returned {code}")
    return [json.loads(line) for line in text.splitlines() if line.startswith('{"stage"')]


def find_log(logs: list[dict], stage: str, msg: str) -> dict:
    for rec in logs:
        if rec["stage"] == stage and rec["msg"] == msg:
            return rec
    fail(f"no {stage!r} log record {msg!r}")


def scene_path(dev, tmp: str, ds, extra_argv=(), seed: int = 0) -> dict:
    """The ``optimize --slac-mode none``, ``integrate`` and ``evaluate`` verbs
    on the fragments path's directory under ``tmp``, each timed with its peak
    memory, and their files held to ground truth. Returns the record with its
    ``faults`` and the verbs' log records under ``"logs"``."""
    from elasticreconstruction_tpu_torch.core import io_logfmt
    from elasticreconstruction_tpu_torch.pipeline import run

    data, out = os.path.join(tmp, "data"), os.path.join(tmp, "out")
    argv = ["--data", data, "--out", out, "--seed", str(seed), "--device", str(dev), "--slac-mode", "none",
            *extra_argv]
    cfg = run.config_from_args(run.build_parser().parse_args(["integrate", *argv]))
    rec, logs = {}, {}
    for verb in ("optimize", "integrate", "evaluate"):
        synchronize(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logs[verb] = run_verb([verb, *argv])
        synchronize(dev)
        rec[verb + "_s"] = time.perf_counter() - t0
        if dev.type == "cuda":
            rec[verb + "_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    harvest = find_log(logs["optimize"], "optimize", "correspondences")
    done = find_log(logs["integrate"], "integrate", "done")
    rec.update(correspondences=harvest["count"], harvest_edges=harvest["edges"],
               harvest_ms_per_edge=1e3 * harvest["seconds"] / max(harvest["edges"], 1),
               # Wall time a frame of the fuse loop, PNG decoding and the copy to the device included.
               fuse_loop_ms_per_frame=1e3 * done["fuse_seconds"] / max(done["frame_fusions"], 1),
               **{k: done[k] for k in ("vertices", "faces", "frames", "blocks", "wanted", "tile",
                                        "extract_seconds", "weld_seconds", "write_seconds")})

    faults = []
    nf = len(io_logfmt.read_log(os.path.join(out, "posegraph", "pose.log")).entries)
    traj = io_logfmt.read_log(os.path.join(out, "integrate", "trajectory.log")).matrices()
    n = min(len(ds), nf * cfg.frames_per_fragment)
    if traj.shape != (n, 4, 4) or not np.isfinite(traj).all():
        faults.append(f"trajectory.log holds {traj.shape} poses (want {n}) or non-finite values")
    with open(os.path.join(out, "integrate", "ate.json")) as f:
        metrics = json.load(f)
    rec["ate"] = metrics
    if not metrics["ate_rmse"] < SCENE_ATE_M:
        faults.append(f"ate_rmse {metrics['ate_rmse']:.4f} m >= {SCENE_ATE_M}")
    faults += mesh_on_surface(dev, ds, out, rec)
    reg = os.path.join(out, "registration")
    if os.path.exists(os.path.join(reg, "loop.log")):
        if not os.path.exists(os.path.join(reg, "registration_pr.json")):
            faults.append("loop.log exists but registration_pr.json was not written")
        else:
            with open(os.path.join(reg, "registration_pr.json")) as f:
                rec["registration_pr"] = json.load(f)
    rec.update(faults=faults, logs=logs)
    return rec


def mesh_on_surface(dev, ds, out: str, rec: dict) -> list[str]:
    """``mesh.ply`` under ``out`` held to the scene: more than ``SCENE_MIN_FACES``
    finite faces, vertices on the surface (``SCENE_MESH_*``). Adds the numbers
    to ``rec``; returns the faults."""
    from elasticreconstruction_tpu_torch.core import io_logfmt
    from elasticreconstruction_tpu_torch.synthetic import scenes

    faults = []
    traj = io_logfmt.read_log(os.path.join(out, "integrate", "trajectory.log")).matrices()
    verts, faces = io_logfmt.read_ply_mesh(os.path.join(out, "integrate", "mesh.ply"))
    rec["faces"] = len(faces)
    if not (len(faces) > SCENE_MIN_FACES and np.isfinite(verts).all()):
        faults.append(f"mesh.ply has {len(faces)} faces or non-finite vertices")
    # Vertices in ground truth's frame, aligned at frame 0 as the cloud check
    # aligns each fragment (the ATE alignment fits positions alone, which an
    # arc of camera centres leaves free to turn).
    align = torch.from_numpy((ds.gt_poses[0].astype(np.float64) @ np.linalg.inv(traj[0])).astype(np.float32))
    v = torch.from_numpy(verts) @ align[:3, :3].T + align[:3, 3]
    sdf = scenes.livingroom_scene()(v.to(dev)).abs()
    rec["mesh_mean_abs_sdf_m"] = sdf.mean().item()
    rec["mesh_share_within_2cm"] = (sdf < 0.02).float().mean().item()
    if not (rec["mesh_mean_abs_sdf_m"] < SCENE_MESH_MEAN_M and rec["mesh_share_within_2cm"] >= SCENE_MESH_SHARE):
        faults.append(f"mesh off the surface: mean |SDF| {rec['mesh_mean_abs_sdf_m']:.4f} m, "
                      f"{rec['mesh_share_within_2cm']:.3f} of vertices within 2 cm")
    return faults


def check_blocks(dev, tmp: str, ds, logs: dict, extra_argv=()) -> dict:
    """``run_integrate`` again with ``scene_max_shape`` cut to tile the scene
    into 2 x 1 x 2 blocks: the stitched mesh must match the one-block mesh,
    faces within ``BLOCKS_FACES_RTOL`` and ``BLOCKS_SHARED`` of its vertices
    within ``BLOCKS_VERTEX_M`` of a one-block vertex. (Welded vertices are rounded to a 10 um grid, and a block's
    origin moves a vertex by an ulp, across a rounding boundary for about 1%
    of them: they cannot be compared as keys.)"""
    import dataclasses

    from elasticreconstruction_tpu_torch.core import io_logfmt
    from elasticreconstruction_tpu_torch.integrate import blocks
    from elasticreconstruction_tpu_torch.pipeline import run, stages

    out = os.path.join(tmp, "out")
    argv = ["--data", os.path.join(tmp, "data"), "--out", out, "--device", str(dev), "--slac-mode", "none",
            *extra_argv]
    cfg = run.config_from_args(run.build_parser().parse_args(["integrate", *argv]))
    want = find_log(logs["integrate"], "integrate", "volume plan")["wanted"]
    ov = cfg.scene_block_overlap
    shape = (want[0] // 2 + 2 * ov + 1, want[1], want[2] // 2 + 2 * ov + 1)
    n_blocks = len(blocks.plan_blocks(tuple(want), shape, overlap=ov).blocks)
    if n_blocks != 4:
        fail(f"scene_max_shape {shape} tiles {want} into {n_blocks} blocks, not 2 x 1 x 2")
    v1, f1 = io_logfmt.read_ply_mesh(os.path.join(out, "integrate", "mesh.ply"))
    synchronize(dev)
    t0 = time.perf_counter()
    stats = stages.run_integrate(ds, dataclasses.replace(cfg, scene_max_shape=shape), device=dev)
    synchronize(dev)
    wall = time.perf_counter() - t0
    v2, f2 = io_logfmt.read_ply_mesh(os.path.join(out, "integrate", "mesh.ply"))
    dist = nearest_distance(v2, v1, dev, BLOCKS_VERTEX_M)
    rec = {"blocks": stats["blocks"], "max_shape": list(shape), "tile": stats["tile"], "seconds": wall,
           "faces_one_block": len(f1), "faces_blocks": len(f2), "vertices_one_block": len(v1),
           "vertices_blocks": len(v2), "shared_vertex_share": float((dist < BLOCKS_VERTEX_M).mean()),
           "vertex_distance_bound_m": float(dist.max()) if len(dist) else 0.0}
    print(json.dumps({"one_block_vs_blocks": rec}))
    if not (abs(len(f2) - len(f1)) <= BLOCKS_FACES_RTOL * len(f1) and rec["shared_vertex_share"] >= BLOCKS_SHARED):
        fail(f"the 2 x 1 x 2 block mesh differs from the one-block mesh: {rec}")
    return rec


def nearest_distance(a: np.ndarray, b: np.ndarray, dev, tol: float) -> np.ndarray:
    """Distance in float64 from each point of ``a`` to its nearest point of
    ``b``, exact below ``tol``: the candidate ``nn.nearest`` finds, and where
    that is ``tol`` or more away (its f32 distance cannot tell points 0.1 mm
    apart at metres from the origin), an exhaustive float64 search."""
    from elasticreconstruction_tpu_torch.kernels.cuda import nn

    ta, tb = (torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev) for x in (a, b))
    _, idx = nn.nearest(ta, tb, torch.ones(len(b), dtype=torch.bool, device=dev))
    a64, b64 = ta.double(), tb.double()
    dist = torch.linalg.norm(a64 - b64[idx.long()], dim=1)
    miss = (dist >= tol).nonzero()[:, 0]
    for s in range(0, len(miss), 256):
        rows = miss[s : s + 256]
        dist[rows] = torch.cdist(a64[rows], b64, compute_mode="donot_use_mm_for_euclid_dist").amin(1)
    return dist.cpu().numpy()


def scene_profile(dev, ds, out: str, logs: dict) -> dict:
    """Per-frame integration and ``extract_mesh`` at the scene's tile, on the
    card: wall and profiled device-busy time with the kernel count."""
    from elasticreconstruction_tpu_torch.core import io_logfmt
    from elasticreconstruction_tpu_torch.integrate import mesh, scene
    from elasticreconstruction_tpu_torch.kernels import tsdf
    from elasticreconstruction_tpu_torch.pipeline import run

    cfg = run.config_from_args(run.build_parser().parse_args(["integrate"]))
    plan = find_log(logs["integrate"], "integrate", "volume plan")
    scfg = scene.SceneConfig(volume_shape=tuple(plan["tile"]), voxel_size=cfg.scene_voxel_size,
                             origin=tuple(plan["origin"]))
    poses = torch.from_numpy(io_logfmt.read_log(os.path.join(out, "integrate", "trajectory.log"))
                             .matrices().astype(np.float32)).to(dev)
    vol = scene.make_scene_volume(scfg, device=dev)
    for s in range(0, len(poses), 16):
        depths = torch.from_numpy(ds.depth_chunk(s, min(16, len(poses) - s))).to(dev)
        vol = scene.integrate_frames_scatter(vol, depths, poses[s : s + len(depths)], ds.intrinsics, scfg)
    depths = torch.from_numpy(ds.depth_chunk(0, 16)).to(dev)
    fuse = device_profile("integrate_frames_scatter (16 frames)",
                          lambda: scene.integrate_frames_scatter(vol, depths, poses[:16], ds.intrinsics, scfg))
    ext = device_profile("extract_mesh", lambda: mesh.extract_mesh(vol, capacity_per_slab=cfg.mesh_capacity_per_slab))
    return {"integrate_frame_wall_ms": fuse["wall_ms"] / 16,
            "integrate_frame_busy_ms": fuse["device_busy_ms"] / 16 if fuse["kernels"] else "not measured",
            "integrate_frame_kernels": fuse["kernels"] / 16,
            "extract_mesh_wall_ms": ext["wall_ms"], "extract_mesh_busy_ms": ext["device_busy_ms"],
            "extract_mesh_kernels": ext["kernels"], "tile": plan["tile"]}


def phase_scene(tmp: str, frag: dict) -> dict:
    """The scene path on the fragments path's artifacts: ``optimize``,
    ``integrate`` and ``evaluate``, then one block against several and the
    per-frame profile."""
    dev = torch.device("cuda")
    ds = frag["dataset"]
    reset_launch_counts()
    rec = scene_path(dev, tmp, ds)
    rec["launches"] = launch_counts()
    print(json.dumps({"scene_path_launches_by_shape": launches_by_shape()}))
    require_launched("scene", rec["launches"], ["nearest_batch"])
    phase_done("scene path: optimize, integrate and evaluate verbs")
    faults, logs = rec.pop("faults"), rec.pop("logs")
    rec["volume_plan"] = find_log(logs["integrate"], "integrate", "volume plan")
    rec["profile"] = scene_profile(dev, ds, os.path.join(tmp, "out"), logs)
    rec["blocks_check"] = check_blocks(dev, tmp, ds, logs)
    print(json.dumps({"scene_path": rec}))
    if faults:
        fail("scene path: " + "; ".join(faults))
    return rec


def phase_determinism(tmp: str) -> dict:
    """Two runs of ``register`` -> ``posegraph`` -> ``optimize --slac-mode none``
    -> ``integrate`` from the fragments path's ``fragments/`` must write the same
    bytes, and ``prep_fragments_batch`` must give the same bits twice
    (``tools/repeat_check.py``)."""
    from pathlib import Path

    from elasticreconstruction_tpu_torch.tools import repeat_check

    reset_launch_counts()
    out = Path(tmp, "out")
    rec = repeat_check.repeat(out, ["register", "posegraph", "optimize", "integrate"],
                              ["--data", os.path.join(tmp, "data"), "--slac-mode", "none"], "cuda")
    rec["launches"] = launch_counts()
    print(json.dumps({"determinism": {k: v for k, v in rec.items() if k != "launches"}}))
    if not (rec["identical"] and rec["prep_identical"]):
        fail(f"two runs on the same fragments differ: {rec['differences']}, prep identical {rec['prep_identical']}")
    for k in range(2):
        shutil.rmtree(out / f"repeat_{k}")
    return rec


def copy_upstream(src_out: str, dst_out: str) -> None:
    """The fragments, registration and pose-graph directories of one run, for another."""
    for name in ("fragments", "registration", "posegraph"):
        shutil.copytree(os.path.join(src_out, name), os.path.join(dst_out, name))


def read_lattice_files(out: str, mode: str, nf: int) -> np.ndarray:
    """``ctr.txt`` (rigid, slac) or ``ctr_<f>.txt`` (nonrigid) read back: ``(L, M, 3)`` positions."""
    from elasticreconstruction_tpu_torch.core import io_logfmt

    names = [f"ctr_{f}.txt" for f in range(nf)] if mode == "nonrigid" else ["ctr.txt"]
    return np.stack([io_logfmt.read_ctr(os.path.join(out, "slac", n))[0] for n in names])


def elastic_mode(dev, ds, data: str, out: str, mode: str, extra_argv=()) -> dict:
    """The ``optimize --slac-mode MODE``, ``integrate`` and ``evaluate`` verbs on
    ``out``, each timed with its peak memory; ``optimize`` again on a copy of
    the upstream, which must write the same bytes."""
    from pathlib import Path

    from elasticreconstruction_tpu_torch.core import io_logfmt
    from elasticreconstruction_tpu_torch.elastic.lattice import Lattice
    from elasticreconstruction_tpu_torch.kernels.cuda import nn
    from elasticreconstruction_tpu_torch.pipeline import run
    from elasticreconstruction_tpu_torch.tools.repeat_check import first_difference

    argv = ["--data", data, "--out", out, "--device", str(dev), "--slac-mode", mode, *extra_argv]
    rec, logs, faults = {"mode": mode}, {}, []
    for verb in ("optimize", "integrate", "evaluate"):
        by_shape = dict(nn.launches_by_shape)
        launched = nn.launches
        synchronize(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logs[verb] = run_verb([verb, *argv])
        synchronize(dev)
        rec[verb + "_s"] = time.perf_counter() - t0
        if dev.type == "cuda":
            rec[verb + "_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        if verb == "optimize":
            rec["nearest_batch_launches"] = nn.launches - launched
            rec["nearest_batch_shapes"] = {str(k): v - by_shape.get(k, 0) for k, v in nn.launches_by_shape.items()
                                           if v > by_shape.get(k, 0)}
    done = find_log(logs["optimize"], "optimize", "done")
    rec.update({k: done[k] for k in ("rmse_before", "rmse_after", "correspondences", "edges", "rounds")},
               harvest_ms_per_round=[1e3 * t for t in done["harvest_seconds"]],
               optimizer_ms_per_round=[1e3 * t for t in done["optimize_seconds"]],
               lattice_integrated=find_log(logs["integrate"], "integrate", "done")["lattice"])
    with open(os.path.join(out, "integrate", "ate.json")) as f:
        rec["ate_rmse"] = json.load(f)["ate_rmse"]
    faults += mesh_on_surface(dev, ds, out, rec)
    poses = io_logfmt.read_log(os.path.join(out, "slac", "pose_slac.log")).matrices()
    ctr = read_lattice_files(out, mode, len(poses))
    c = run.config_from_args(run.build_parser().parse_args(["optimize", *argv])).slac
    rec["lattice_max_displacement_m"] = float(np.abs(ctr - Lattice(c.resolution, c.length, c.origin)
                                                     .rest_positions().numpy()).max())
    if not (np.isfinite(poses).all() and np.isfinite(ctr).all()):
        faults.append("pose_slac.log or ctr*.txt holds non-finite values")
    if not rec["rmse_after"] <= rec["rmse_before"]:
        faults.append(f"rmse_after {rec['rmse_after']:.6f} > rmse_before {rec['rmse_before']:.6f}")
    if not rec["ate_rmse"] < ELASTIC_ATE_M:
        faults.append(f"ate_rmse {rec['ate_rmse']:.4f} m >= {ELASTIC_ATE_M}")
    if mode != "rigid" and not rec["lattice_integrated"]:
        faults.append("integrate did not take the lattice")
    # optimize again from the same upstream: the same bytes.
    again = out + "_again"
    copy_upstream(out, again)
    run_verb(["optimize", "--data", data, "--out", again, "--device", str(dev), "--slac-mode", mode, *extra_argv])
    names = ["pose_slac.log"] + [os.path.basename(n) for n in sorted(Path(out, "slac").glob("ctr*.txt"))]
    diffs = {n: d for n in names if (d := first_difference(Path(out, "slac", n), Path(again, "slac", n)))}
    rec["optimize_repeats"] = not diffs
    if diffs:
        faults.append(f"optimize run twice wrote different files: {diffs}")
    shutil.rmtree(again)
    rec["faults"] = faults
    return rec


def card_against_cpu(dev, data: str, out: str, extra_argv=()) -> dict:
    """``optimize_fragments`` in slac mode on the correspondences the harvest
    makes on the card from ``out``'s upstream, on the card and on the CPU:
    poses within ``CARD_CPU_POSE_ATOL``, displacements within
    ``CARD_CPU_DISP_ATOL``, final RMSE within ``CARD_CPU_RMSE_RTOL``."""
    from elasticreconstruction_tpu_torch.elastic import CorresSet, build_correspondences, optimize_fragments
    from elasticreconstruction_tpu_torch.pipeline import run, stages

    cfg = run.config_from_args(run.build_parser().parse_args(["optimize", "--data", data, "--out", out,
                                                               *extra_argv]))
    clouds, poses, edges, pair_T, edge_w = stages.load_harvest_inputs(cfg)
    corres = build_correspondences(stages.clouds_to(clouds, dev), torch.from_numpy(poses).to(dev), edges,
                                   max_distance=cfg.corres_max_distance,
                                   capacity_per_edge=cfg.corres_capacity_per_edge, pair_transforms=pair_T,
                                   edge_weights=edge_w)
    res = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        c = CorresSet(*(None if x is None else x.to(d) for x in corres))
        t0 = time.perf_counter()
        r = optimize_fragments(torch.from_numpy(poses).to(d), c, cfg.slac_config(), num_fragments=len(clouds))
        res[name] = [x.cpu() for x in (r.poses, r.displacement, r.final_rmse)]
        res[name + "_s"] = time.perf_counter() - t0
    (pg, dg, rg), (pc, dc, rc) = res["card"], res["cpu"]
    rec = {"correspondences": int(corres.count()), "pose_max_abs_diff": float((pg - pc).abs().max()),
           "displacement_max_abs_diff_m": float((dg - dc).abs().max()),
           "final_rmse_rel_diff": float(abs(rg - rc) / rc), "card_s": res["card_s"], "cpu_s": res["cpu_s"],
           "tolerance": [CARD_CPU_POSE_ATOL, CARD_CPU_DISP_ATOL, CARD_CPU_RMSE_RTOL]}
    print(json.dumps({"optimize_fragments_card_vs_cpu": rec}))
    if not (rec["pose_max_abs_diff"] <= CARD_CPU_POSE_ATOL and rec["displacement_max_abs_diff_m"] <= CARD_CPU_DISP_ATOL
            and rec["final_rmse_rel_diff"] <= CARD_CPU_RMSE_RTOL):
        fail(f"optimize_fragments on the card and on the CPU disagree: {rec}")
    return rec


def check_nearest_at_reassociation(dev, out: str, extra_argv=()) -> dict:
    """``nearest_batch`` on a re-association query of the slac path: fragment 1's
    cloud through the learned lattice, posed, against fragment 0's; the kernel
    against its plain version on the first ``HARVEST_PLAIN_QUERIES`` queries,
    indices equal and d2 within 1e-5."""
    from elasticreconstruction_tpu_torch.core import io_logfmt, se3
    from elasticreconstruction_tpu_torch.elastic.lattice import Lattice, deform
    from elasticreconstruction_tpu_torch.kernels.cuda import nn
    from elasticreconstruction_tpu_torch.pipeline import run, stages

    cfg = run.config_from_args(run.build_parser().parse_args(["optimize", "--out", out, *extra_argv]))
    clouds = stages.clouds_to(stages.load_fragment_clouds(cfg)[:2], dev)
    poses = torch.from_numpy(io_logfmt.read_log(os.path.join(out, "slac", "pose_slac.log"))
                             .matrices().astype(np.float32)).to(dev)
    c = cfg.slac
    lat = Lattice(c.resolution, c.length, c.origin)
    disp = torch.from_numpy((read_lattice_files(out, "slac", 2)[0] - lat.rest_positions().numpy())
                            .astype(np.float32)).to(dev)
    q = se3.apply(poses[1], deform(lat, disp, clouds[1].points))[None]
    r = se3.apply(poses[0], deform(lat, disp, clouds[0].points))[None]
    m = clouds[0].mask[None]
    k = HARVEST_PLAIN_QUERIES
    d_k, i_k = nn.nearest_batch(q, r, m)
    d_p, i_p = nn.nearest_batch_plain(q[:, :k], r, m)
    rec = {"shape": list(q.shape[:2]) + [r.shape[1]], "index_mismatches": int((i_k[:, :k] != i_p).sum()),
           "max_abs_d2_diff": float((d_k[:, :k] - d_p).abs().max())}
    if dev.type == "cuda":
        rec["ms"] = cuda_ms(lambda: nn.nearest_batch(q, r, m), reps=10)
    print(json.dumps({"nearest_batch_at_reassociation": rec}))
    if rec["index_mismatches"] or not rec["max_abs_d2_diff"] <= 1e-5:
        fail(f"nearest_batch at the re-association shape: {rec}")
    return rec


def distorted_path(dev, tmp: str, intr=None, num_frames: int = FRAG_FRAMES, extra_argv=()) -> dict:
    """Config 4d cut as the fragments path is: the orbit rendered through
    ``make_distortion(DIST_SEED, **DIST_FIELD)``, ``fragments`` -> ``register``
    -> ``posegraph``, then ``optimize`` rigid and slac with config 4d's
    settings, each followed by ``integrate`` and ``evaluate``; the learned
    lattice scored against the injected field. Gated on finite numbers only."""
    import dataclasses

    from elasticreconstruction_tpu_torch.core import io_logfmt
    from elasticreconstruction_tpu_torch.core.camera import PRIMESENSE
    from elasticreconstruction_tpu_torch.elastic.lattice import Lattice
    from elasticreconstruction_tpu_torch.eval.lattice_recovery import lattice_recovery
    from elasticreconstruction_tpu_torch.pipeline import run, stages
    from elasticreconstruction_tpu_torch.synthetic.distortion import make_distortion

    root = os.path.join(tmp, "distorted")
    dist = make_distortion(DIST_SEED, **DIST_FIELD)
    frag = fragments_path(dev, root, intr or PRIMESENSE, num_frames, extra_argv, distortion=dist)
    ds = frag.pop("dataset")
    rec = {"fragments_s": frag["fragments_s"], "register_s": frag["register_s"], "posegraph_s": frag["posegraph_s"],
           "fragments_path_faults": frag["faults"]}
    base = run.config_from_args(run.build_parser().parse_args(
        ["optimize", "--data", os.path.join(root, "data"), "--out", os.path.join(root, "out"), *extra_argv]))
    cfg = dataclasses.replace(base, slac=base.slac._replace(**DIST_SLAC), **DIST_PIPELINE)
    for mode in ("rigid", "slac"):
        c = dataclasses.replace(cfg, slac_mode=mode)
        synchronize(dev)
        t0 = time.perf_counter()
        opt = stages.run_optimize(c, device=dev)
        synchronize(dev)
        t1 = time.perf_counter()
        stages.run_integrate(ds, c, device=dev)
        m = stages.run_evaluate(ds, c, device=dev)
        rec[mode] = {"ate_rmse": m["ate_rmse"], "rmse_before": opt["rmse_before"], "rmse_after": opt["rmse_after"],
                     "optimize_s": t1 - t0, "integrate_evaluate_s": time.perf_counter() - t1,
                     "harvest_ms_per_round": [1e3 * t for t in opt["harvest_seconds"]]}
    lat = Lattice(cfg.slac.resolution, cfg.slac.length, cfg.slac.origin)
    pos, _, _ = io_logfmt.read_ctr(os.path.join(root, "out", "slac", "ctr.txt"))
    disp = (pos - lat.rest_positions().numpy()).astype(np.float32)
    clouds = stages.load_fragment_clouds(cfg)
    got = lattice_recovery(lat, disp, clouds, dist, ds.intrinsics, device=dev)
    zero = lattice_recovery(lat, np.zeros_like(disp), clouds, dist, ds.intrinsics, device=dev)
    rec.update(lattice_recovery=got, recovery_vs_zero=1.0 - got["residual_rms_aligned"]
               / max(zero["residual_rms_aligned"], 1e-12))
    print(json.dumps({"distorted_path": rec}))
    numbers = [rec[m][k] for m in ("rigid", "slac") for k in ("ate_rmse", "rmse_after")] + [rec["recovery_vs_zero"]]
    if not np.isfinite(numbers).all():
        fail(f"distorted path: non-finite numbers {numbers}")
    return rec


def fragment_pose_ate(dev, out: str, gt: np.ndarray, K: int) -> float:
    """ATE of ``pose_slac.log`` against the ground-truth poses of the fragments' first frames."""
    from elasticreconstruction_tpu_torch.core import io_logfmt
    from elasticreconstruction_tpu_torch.eval import ate

    est = io_logfmt.read_log(os.path.join(out, "slac", "pose_slac.log")).matrices().astype(np.float32)
    ref = gt[::K][: len(est)]
    return float(ate.absolute_trajectory_error(torch.from_numpy(est[: len(ref)]).to(dev),
                                               torch.from_numpy(ref).to(dev)).rmse)


def corrected_cloud_error(dev, cfg, mode: str, gt: np.ndarray) -> dict:
    """Surface error of the posed fragment clouds, through their learned lattices
    in nonrigid mode, with the trajectory aligned to ground truth at fragment 0:
    the shape, not the placement. (Config 4n aligns the fragment translations
    by Kabsch, which three fragments on a 21 degree arc leave free to turn
    about their chord.)"""
    from elasticreconstruction_tpu_torch.core import io_logfmt
    from elasticreconstruction_tpu_torch.elastic.lattice import Lattice, deform
    from elasticreconstruction_tpu_torch.eval.surface_error import surface_error
    from elasticreconstruction_tpu_torch.pipeline import stages
    from elasticreconstruction_tpu_torch.synthetic import scenes

    slac_dir = os.path.join(cfg.out_dir, "slac")
    poses = io_logfmt.read_log(os.path.join(slac_dir, "pose_slac.log")).matrices()
    poses = np.einsum("ij,njk->nik", gt[0].astype(np.float64) @ np.linalg.inv(poses[0]), poses).astype(np.float32)
    lat = Lattice(cfg.slac.resolution, cfg.slac.length, cfg.slac.origin)
    rng = np.random.default_rng(0)
    pts_w = []
    for f, c in enumerate(stages.load_fragment_clouds(cfg)):
        p = c.points[c.mask]
        if len(p) > 20000:
            p = p[rng.choice(len(p), 20000, replace=False)]
        if mode == "nonrigid":
            pos, _, _ = io_logfmt.read_ctr(os.path.join(slac_dir, f"ctr_{f}.txt"))
            disp = torch.from_numpy((pos - lat.rest_positions().numpy()).astype(np.float32)).to(dev)
            p = deform(lat, disp, torch.from_numpy(p).to(dev)).cpu().numpy()
        pts_w.append(p @ poses[f][:3, :3].T + poses[f][:3, 3])
    return surface_error(scenes.livingroom_scene(), np.concatenate(pts_w), device=dev)


def nonrigid_path(dev, tmp: str, ds, extra_argv=()) -> dict:
    """Config 4n cut as the fragments path is: its clouds through
    ``make_fragment_warp(WARP_SEED + f, ...)`` into a new ``fragments/``, then
    ``register`` -> ``posegraph`` -> ``optimize`` rigid and nonrigid with
    config 4n's settings; surface error of the corrected clouds. Gated on
    finite numbers only."""
    import dataclasses

    from elasticreconstruction_tpu_torch.core import io_logfmt
    from elasticreconstruction_tpu_torch.elastic.lattice import Lattice
    from elasticreconstruction_tpu_torch.pipeline import run, stages
    from elasticreconstruction_tpu_torch.synthetic.warps import make_fragment_warp, warp_points

    src, root = os.path.join(tmp, "out", "fragments"), os.path.join(tmp, "warped")
    dst = os.path.join(root, "fragments")
    os.makedirs(dst)
    lat = Lattice(*WARP_LATTICE)
    f = 0
    while os.path.exists(os.path.join(src, f"cloud_bin_{f}.pcd")):
        pts, nrm = io_logfmt.read_pcd(os.path.join(src, f"cloud_bin_{f}.pcd"))
        w = make_fragment_warp(WARP_SEED + f, lat, amplitude=WARP_AMPLITUDE_M)
        warped = warp_points(lat, w, torch.from_numpy(pts.astype(np.float32)).to(dev)).cpu().numpy()
        io_logfmt.write_pcd(os.path.join(dst, f"cloud_bin_{f}.pcd"), warped, nrm)
        for name in (f"local_{f}.log", f"health_{f}.json"):
            shutil.copy(os.path.join(src, name), dst)
        f += 1
    shutil.copy(os.path.join(src, "fragments.log"), dst)
    base = run.config_from_args(run.build_parser().parse_args(["optimize", "--out", root, *extra_argv]))
    cfg = dataclasses.replace(base, slac=base.slac._replace(**WARP_SLAC), **WARP_PIPELINE)
    t0 = time.perf_counter()
    stages.run_registration(cfg, device=dev)
    stages.run_posegraph(cfg, device=dev)
    rec = {"fragments": f, "register_posegraph_s": time.perf_counter() - t0}
    for mode in ("rigid", "nonrigid"):
        c = dataclasses.replace(cfg, slac_mode=mode)
        synchronize(dev)
        t0 = time.perf_counter()
        opt = stages.run_optimize(c, device=dev)
        synchronize(dev)
        err = corrected_cloud_error(dev, c, mode, ds.gt_poses)
        rec[mode] = {"data_rmse": opt["rmse_after"], "optimize_s": time.perf_counter() - t0,
                     "frag_ate_rmse": fragment_pose_ate(dev, root, ds.gt_poses, cfg.frames_per_fragment),
                     "surface_rmse": err["rmse"], "surface_mean": err["mean"]}
    rec["surface_improvement"] = rec["rigid"]["surface_rmse"] / max(rec["nonrigid"]["surface_rmse"], 1e-9)
    print(json.dumps({"nonrigid_path": rec}))
    numbers = [rec[m][k] for m in ("rigid", "nonrigid") for k in ("data_rmse", "surface_rmse", "frag_ate_rmse")]
    if not np.isfinite(numbers).all():
        fail(f"nonrigid path: non-finite numbers {numbers}")
    return rec


def large_problem(dev, seed: int = 0):
    """A correspondence set of config 3's full length from a seed: ``BIG_EDGES``
    edges of ``BIG_ROWS`` rows among ``BIG_FRAGMENTS`` fragments on one orbit,
    points in both frustums with their (perturbed) partners and unit normals;
    the poses it was drawn at, and starting poses 1 cm / 0.01 rad off them."""
    from elasticreconstruction_tpu_torch.core import se3
    from elasticreconstruction_tpu_torch.core.camera import PRIMESENSE as intr
    from elasticreconstruction_tpu_torch.elastic import CorresSet
    from elasticreconstruction_tpu_torch.synthetic.scenes import orbit_trajectory

    rng = np.random.default_rng(seed)
    nf, cap = BIG_FRAGMENTS, BIG_ROWS
    gt = orbit_trajectory(nf, radius=1.1, height=1.3, sweep=2 * np.pi).astype(np.float64)
    edges = [(f, f + d) for d in (1, 2, 3, 4) for f in range(nf - d)][:BIG_EDGES]
    cols = {k: [] for k in ("fi", "fj", "p", "q", "n", "m")}
    for i, j in edges:
        z = rng.uniform(0.8, 2.8, cap)
        p = np.stack([z * rng.uniform(-0.55, 0.55, cap), z * rng.uniform(-0.42, 0.42, cap), z], 1)
        rel = np.linalg.inv(gt[j]) @ gt[i]
        q = p @ rel[:3, :3].T + rel[:3, 3] + rng.normal(0, 0.002, (cap, 3))
        n = rng.normal(size=(cap, 3))
        u, v = q[:, 0] / q[:, 2] * intr.fx + intr.cx, q[:, 1] / q[:, 2] * intr.fy + intr.cy
        ok = (q[:, 2] > 0.5) & (u >= 0) & (u < intr.width) & (v >= 0) & (v < intr.height)
        for k, x in (("fi", np.full(cap, i)), ("fj", np.full(cap, j)), ("p", p), ("q", q),
                     ("n", n / np.linalg.norm(n, axis=1, keepdims=True)), ("m", ok)):
            cols[k].append(x)
    c = {k: np.concatenate(v) for k, v in cols.items()}
    f32 = lambda x: torch.from_numpy(x.astype(np.float32)).to(dev)  # noqa: E731
    i32 = lambda x: torch.from_numpy(x.astype(np.int32)).to(dev)  # noqa: E731
    m = c["m"][:, None]
    corres = CorresSet(i32(c["fi"]), i32(c["fj"]), f32(np.where(m, c["p"], 0.0)), f32(np.where(m, c["q"], 0.0)),
                       torch.from_numpy(c["m"]).to(dev), f32(c["n"]), f32(np.ones(len(c["m"]))))
    noise = torch.from_numpy(rng.normal(0, 0.01, (nf, 6)).astype(np.float32))
    noise[0] = 0
    init = (se3.exp(noise) @ torch.from_numpy(gt.astype(np.float32))).to(dev)
    return init, corres


def count_host_syncs(fn) -> tuple[int, dict]:
    """Host synchronisations one call of ``fn`` makes, by the Python line that made them."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    return len(syncs), {line: syncs.count(line) for line in sorted(set(syncs))}


def optimizer_at_scale(dev) -> dict:
    """``optimize_fragments`` on :func:`large_problem` with ``SlacConfig()``'s
    defaults (5 outer x 48 CG), in slac (L = 1) and nonrigid (L = 51) mode:
    wall ms a solve and an outer step, ms and kernels a CG iteration (an outer
    step with 48 CG iterations against one with none), host synchronisations
    an outer step, peak memory and the device busy share of an outer step."""
    from elasticreconstruction_tpu_torch.elastic import slac
    from elasticreconstruction_tpu_torch.elastic.lattice import Lattice

    init, corres = large_problem(dev)
    out = {"rows": int(corres.mask.numel()), "valid_rows": int(corres.count()), "fragments": BIG_FRAGMENTS}
    for mode in (slac.SlacMode.SLAC, slac.SlacMode.NONRIGID):
        cfg = slac.SlacConfig(mode=mode)
        slac.optimize_fragments(init, corres, cfg._replace(outer_iterations=1))  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = slac.optimize_fragments(init, corres, cfg)
        torch.cuda.synchronize()
        solve_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        lat = Lattice(cfg.resolution, cfg.length, cfg.origin)
        L = slac._num_lattices(mode, BIG_FRAGMENTS)
        prob = slac._precompute(lat, corres, mode, BIG_FRAGMENTS)
        state = slac.SlacState(init, torch.zeros((L, lat.num_vertices, 3), device=dev))

        def step(cg):
            return lambda: slac._gn_outer_step(state, corres, cfg._replace(cg_iterations=cg), BIG_FRAGMENTS, prob)

        prof = {cg: device_profile(f"_gn_outer_step {mode.value} cg {cg}", step(cg), top=8) for cg in (48, 0)}
        syncs, by_line = count_host_syncs(step(48))
        rmse = res.data_rmse.cpu().numpy()
        out[mode.value] = {
            "lattices": L, "unknowns": 6 * BIG_FRAGMENTS + 3 * L * lat.num_vertices,
            "solve_ms": solve_ms, "outer_step_wall_ms": prof[48]["wall_ms"],
            "cg_iteration_wall_ms": (prof[48]["wall_ms"] - prof[0]["wall_ms"]) / 48,
            "cg_iteration_busy_ms": (prof[48]["device_busy_ms"] - prof[0]["device_busy_ms"]) / 48
            if prof[0]["kernels"] else "not measured",
            "kernels_per_cg_iteration": (prof[48]["kernels"] - prof[0]["kernels"]) / 48,
            "kernels_outside_cg": prof[0]["kernels"], "outer_step_busy_share": prof[48]["busy_share"],
            "host_syncs_per_outer_step": syncs, "host_syncs_by_line": by_line, "peak_gib": peak,
            "data_rmse": rmse.tolist(), "final_rmse": float(res.final_rmse)}
        if not (np.isfinite(rmse).all() and torch.isfinite(res.poses).all() and torch.isfinite(res.displacement).all()):
            fail(f"optimize_fragments at scale ({mode.value}): non-finite results")
    print(json.dumps({"optimizer_at_scale": out}))
    return out


def phase_elastic(tmp: str, frag: dict) -> dict:
    """The elastic path on the fragments path's directory: each ``--slac-mode``
    through ``optimize`` -> ``integrate`` -> ``evaluate``, the card against the
    CPU, ``nearest_batch`` at a re-association query; then the distorted and
    the warped paths and the optimiser at production size. The launches of
    the three modes, of the distorted path and of the warped path are counted
    apart (``launches``, ``launches_distorted``, ``launches_warped``)."""
    dev = torch.device("cuda")
    ds = frag["dataset"]
    data, out = os.path.join(tmp, "data"), os.path.join(tmp, "out")
    harvest = str((1, HARVEST_CAPACITY, HARVEST_CAPACITY))
    reset_launch_counts()
    modes, faults = {}, []
    for mode in ELASTIC_MODES:
        mode_out = os.path.join(tmp, f"out_{mode}")
        copy_upstream(out, mode_out)
        modes[mode] = elastic_mode(dev, ds, data, mode_out, mode)
        faults += [f"{mode}: {x}" for x in modes[mode].pop("faults")]
        print(json.dumps({"elastic_mode": modes[mode]}))
    rec = {"modes": modes, "launches": launch_counts()}
    print(json.dumps({"elastic_path_launches_by_shape": launches_by_shape()}))
    require_launched("elastic", rec["launches"], ["nearest_batch"])
    for mode, m in modes.items():
        if not m["nearest_batch_shapes"].get(harvest):
            fail(f"elastic path: optimize --slac-mode {mode} launched nearest_batch at no harvest shape "
                 f"{harvest}: {m['nearest_batch_shapes']}")
    phase_done("elastic path: rigid, slac and nonrigid through optimize, integrate and evaluate")
    for key, name, path in (("distorted", "distorted orbit (config 4d)", lambda: distorted_path(dev, tmp)),
                            ("warped", "warped fragments (config 4n)", lambda: nonrigid_path(dev, tmp, ds))):
        reset_launch_counts()
        rec[key] = path()
        rec["launches_" + key] = launch_counts()
        print(json.dumps({key + "_path_launches_by_shape": launches_by_shape()}))
        require_launched(key, rec["launches_" + key], ["nearest_batch"])
        phase_done(f"elastic path: the {name}")
    rec["card_vs_cpu"] = card_against_cpu(dev, data, os.path.join(tmp, "out_slac"))
    rec["nearest_at_reassociation"] = check_nearest_at_reassociation(dev, os.path.join(tmp, "out_slac"))
    rec["at_scale"] = optimizer_at_scale(dev)
    phase_done("elastic path: card against CPU, re-association NN, the optimiser at scale")
    if faults:
        fail("elastic path: " + "; ".join(faults))
    return rec


def phase_all(seed: int = 0) -> dict:
    """The ``all`` verb on a fresh directory: ``ALL_FRAMES`` frames of the
    fragments path's orbit at the ``fast`` preset, with ``--slac-mode none``
    and at the default mode (slac); every artifact written, ATE under
    ``ALL_ATE_M``. Then ``optimize`` at the default mode on the CPU from the
    card's upstream: ``pose_slac.log`` and ``ctr.txt`` within
    ``CARD_CPU_VERB_ATOL`` of the card's."""
    from elasticreconstruction_tpu_torch.core import io_logfmt
    from elasticreconstruction_tpu_torch.core.camera import PRIMESENSE
    from elasticreconstruction_tpu_torch.pipeline import dataset

    dev = torch.device("cuda")
    rec, faults = {"frames": ALL_FRAMES}, []
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        dataset.generate_synthetic(data, num_frames=ALL_FRAMES, intr=PRIMESENSE, seed=seed, device=dev,
                                   **FRAG_ORBIT)
        reset_launch_counts()
        for mode in ("none", None):  # None: the CLI's default
            out = os.path.join(tmp, f"out_{mode or 'default'}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logs = run_verb(["all", "--data", data, "--out", out, "--preset", "fast", "--frames-per-fragment", "10",
                             "--seed", str(seed), *(["--slac-mode", mode] if mode else [])])
            torch.cuda.synchronize()
            r = {"seconds": time.perf_counter() - t0, "ate": find_log(logs, "evaluate", "done")}
            names = ALL_ARTIFACTS + (() if mode else ("slac/ctr.txt",))
            missing = [name for name in names if not os.path.exists(os.path.join(out, name))]
            if missing or not r["ate"]["ate_rmse"] < ALL_ATE_M:
                faults.append(f"the all verb (--slac-mode {mode or 'default'}): missing {missing}, "
                              f"ate_rmse {r['ate']['ate_rmse']:.4f} m (limit {ALL_ATE_M})")
            rec[f"slac_mode_{mode or 'default'}"] = r
        rec["launches"] = launch_counts()
        require_launched("all", rec["launches"], ["nearest_batch"])
        # The default mode's optimize on the CPU from the card's upstream.
        out, cpu = os.path.join(tmp, "out_default"), os.path.join(tmp, "out_cpu")
        copy_upstream(out, cpu)
        t0 = time.perf_counter()
        run_verb(["optimize", "--data", data, "--out", cpu, "--preset", "fast", "--frames-per-fragment", "10",
                  "--device", "cpu"])
        diffs = {"seconds": time.perf_counter() - t0}
        for name in ("pose_slac.log", "ctr.txt"):
            a, b = (io_logfmt.read_log(os.path.join(d, "slac", name)).matrices() if name.endswith(".log")
                    else io_logfmt.read_ctr(os.path.join(d, "slac", name))[0] for d in (out, cpu))
            diffs[name] = float(np.abs(a - b).max())
            if not diffs[name] <= CARD_CPU_VERB_ATOL[name]:
                faults.append(f"optimize on the card and on the CPU: {name} differs by {diffs[name]}")
        rec["optimize_card_vs_cpu_max_abs_diff"] = diffs
    print(json.dumps({"all_verb": rec}))
    if faults:
        fail("; ".join(faults))
    return rec


# The milestone ladder's config 3 at its full width (320x240, 128^3 volumes of
# 2.4 cm, 96 raycast steps, clouds of 1 << 16 rows, batches of 16), cut in depth
# to 4 fragments of K = 50: the first 201 frames of its 2550-frame orbit.
MILESTONE_FRAMES = 201
MILESTONE_SWEEP = 2 * np.pi * MILESTONE_FRAMES / 2550  # the first 201 frames of the full orbit
MILESTONE_ATE_M = SCENE_ATE_M
MILESTONE_CAPACITY = 1 << 16


def milestones_path(dev, tmp: str, frames: int = MILESTONE_FRAMES, argv=(), overrides=None) -> dict:
    """``tools/milestones.py``'s config 3, config 4 slac and config 4n functions
    under ``tmp`` (``frames`` frames; ``argv``: more of its flags; ``overrides``:
    attributes set on its parsed arguments), then on config 3's directory the
    ``register`` verb once under ``--profile``, ``tools/ring_scale.py`` at world
    size 1 over every fragment and ``tools/reg_profile.py``. Returns the records,
    the walls, the trace's event counts and the launches by shape of all of it."""
    from elasticreconstruction_tpu_torch.tools import milestones as ms
    from elasticreconstruction_tpu_torch.tools import reg_profile, ring_scale

    root = os.path.join(tmp, "ladder")
    args = ms.build_parser().parse_args(["--frames", str(frames), "--device", str(dev), "--out", root,
                                         "--results", os.path.join(tmp, "milestones.json"), *argv])
    for key, value in (overrides or {}).items():
        setattr(args, key, value)
    rec = {}
    t0 = time.perf_counter()
    ms.main_dataset(Path(root), args, dev)
    rec["generate_s"] = time.perf_counter() - t0
    reset_launch_counts()
    configs = (("config3_full_rigid", ms.run_config3),
               ("config4_slac", lambda r, a, d: ms.run_config4(r, a, d, "slac")),
               ("config4_nonrigid_deformed", ms.run_deformed))
    for name, fn in configs:
        synchronize(dev)
        t0 = time.perf_counter()
        rec[name] = fn(Path(root), args, dev)
        synchronize(dev)
        rec[name]["seconds"] = time.perf_counter() - t0
    out_full = os.path.join(root, "out_full")
    trace_dir = os.path.join(tmp, "trace")
    t0 = time.perf_counter()
    run_verb(["register", "--out", out_full, "--profile", trace_dir, "--device", str(dev)])
    rec["register_profiled_s"] = time.perf_counter() - t0
    traces = sorted(Path(trace_dir, "register").glob("*.json"))
    if len(traces) != 1:
        fail(f"register --profile wrote {len(traces)} trace files under {trace_dir}/register, want 1")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    rec["trace"] = {"mb": traces[0].stat().st_size / 1e6, "events": len(events), "kernel_events": len(kernels),
                    "nearest_kernel_events": sum("nearest_kernel" in e.get("name", "") for e in kernels)}
    t0 = time.perf_counter()
    rec["ring_scale"] = ring_scale.run([os.path.join(out_full, "fragments")], stride=1, ranks=1,
                                       backend="nccl" if dev.type == "cuda" else "gloo", device=dev)
    rec["ring_scale_s"] = time.perf_counter() - t0
    prof = reg_profile.profile(out_full, 16, dev)
    rec["reg_profile"] = {run: {k: prof[run][k] for k in ("pairs", "seconds", "prep_seconds", "dispatch_seconds",
                                                         "drain_seconds", "io_seconds", "pairs_per_second")}
                          for run in ("cold", "warm")}
    rec["launches"] = launch_counts()
    rec["launches_by_shape"] = launches_by_shape()
    from elasticreconstruction_tpu_torch.pipeline.stages import load_fragment_clouds

    clouds = load_fragment_clouds(ms.base_cfg(Path(root), args))
    rec["cloud_points"] = [int(c.mask.sum()) for c in clouds]
    return rec


def phase_milestones() -> dict:
    """The milestone ladder's main path (``milestones_path``) on the card:
    config 3's ATE under ``MILESTONE_ATE_M``, the trace holding CUDA kernel
    events with ``nearest_kernel`` among them, every wanted pair of the ring in
    a lane; then ``nearest_batch`` at the ladder's harvest shape, (1, 65536,
    65536) with as many valid refs as its clouds hold, against its plain version.
    One JSON line ``{"milestones_path": ...}``."""
    from elasticreconstruction_tpu_torch.kernels.cuda import nn

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        rec = milestones_path(dev, tmp, overrides={"sweep": MILESTONE_SWEEP})
    require_launched("milestones", rec["launches"], ["nearest_batch"])
    points = int(np.mean(rec["cloud_points"]))
    rec["nearest_ladder_shape"] = check_nearest_at_harvest_shape(
        np.random.default_rng(2), dev, MILESTONE_CAPACITY, points, "ladder harvest",
        -(-MILESTONE_CAPACITY // nn.MAX_RANGE))
    c3 = rec["config3_full_rigid"]
    summary = {
        "frames": MILESTONE_FRAMES, "cloud_points": rec["cloud_points"], "generate_s": rec["generate_s"],
        **{name: rec[name] for name in ("config3_full_rigid", "config4_slac", "config4_nonrigid_deformed")},
        "register_profiled_s": rec["register_profiled_s"], "trace": rec["trace"],
        "ring_scale": {k: v for k, v in rec["ring_scale"].items() if k != "success_pairs"},
        "ring_scale_s": rec["ring_scale_s"], "reg_profile": rec["reg_profile"],
        "launches": rec["launches"], "launches_by_shape": rec["launches_by_shape"],
        "nearest_ladder_shape": rec["nearest_ladder_shape"],
    }
    print(json.dumps({"milestones_path": summary}))
    faults = []
    if not c3["ate_rmse"] < MILESTONE_ATE_M:
        faults.append(f"config 3 cut to {MILESTONE_FRAMES} frames: ATE {c3['ate_rmse']:.4f} m >= {MILESTONE_ATE_M}")
    if not (rec["trace"]["kernel_events"] > 0 and rec["trace"]["nearest_kernel_events"] > 0):
        faults.append(f"the register trace holds no CUDA kernel events of nearest_kernel: {rec['trace']}")
    if rec["ring_scale"]["pairs_missing"] or rec["ring_scale"]["pairs_in_two_lanes"]:
        faults.append(f"ring_scale: {rec['ring_scale']['pairs_missing']} pairs missing, "
                      f"{rec['ring_scale']['pairs_in_two_lanes']} in two lanes")
    numbers = [c3["ate_rmse"], rec["config4_slac"]["ate_rmse"],
               rec["config4_nonrigid_deformed"]["surface_improvement"]]
    if not np.isfinite(np.asarray(numbers, float)).all():
        faults.append(f"non-finite ladder numbers {numbers}")
    if faults:
        fail("milestones path: " + "; ".join(faults))
    return rec


def shard_inputs(tmp: str, frag: dict, scene: dict, graph: dict) -> dict:
    """The distributed phase's inputs, on the host: the ``bench.py`` workload
    (6 fragments of 20 000 points, prepped on the card) with one batch of
    ``SHARD_PAIRS`` pairs and their RANSAC draws; the stage path's 24-fragment
    pose graph; :func:`large_problem`'s 696 320 rows; the scene path's volume
    block with its first ``SHARD_FRAMES`` frames and poses."""
    from elasticreconstruction_tpu_torch.bench_scene import make_fragments
    from elasticreconstruction_tpu_torch.core import io_logfmt
    from elasticreconstruction_tpu_torch.pipeline import run
    from elasticreconstruction_tpu_torch.registration import RegistrationConfig, prep_fragments_batch, ransac

    cfg = RegistrationConfig()
    clouds, _ = make_fragments(6, n=20000, seed=0)
    prepped = prep_fragments_batch(clouds, cfg, device="cuda")
    pairs = [(i, j) for i in range(6) for j in range(i + 1, 6)]
    pairs = (pairs * 2)[:SHARD_PAIRS]
    init, corres = large_problem(torch.device("cpu"))
    ds = frag["dataset"]
    plan = scene["volume_plan"]
    scfg = run.config_from_args(run.build_parser().parse_args(["integrate"]))
    poses = io_logfmt.read_log(os.path.join(tmp, "out", "integrate", "trajectory.log")).matrices()
    return {
        "clouds": type(clouds)(*(torch.from_numpy(x) for x in clouds)),
        "prepped": type(prepped)(prepped.coarse.to("cpu"), prepped.features.cpu(), prepped.fine.to("cpu")),
        "ii": np.array([i for i, _ in pairs]), "jj": np.array([j for _, j in pairs]),
        "draws": ransac.draw_hypotheses(SHARD_PAIRS, cfg.num_hypotheses, torch.Generator().manual_seed(0), "cpu"),
        "graph": graph, "slac_init": init, "corres": corres,
        "depths": torch.from_numpy(ds.depth_chunk(0, SHARD_FRAMES)),
        "poses": torch.from_numpy(poses[:SHARD_FRAMES].astype(np.float32)), "intr": ds.intrinsics,
        "scene": dict(volume_shape=tuple(plan["tile"]), voxel_size=scfg.scene_voxel_size,
                      origin=tuple(plan["origin"])),
        "mesh_capacity": scfg.mesh_capacity_per_slab,
    }


def shard_case(inp: dict, dev: torch.device) -> dict:
    """``inp``'s tensors on ``dev`` as the paths take them."""
    from elasticreconstruction_tpu_torch.elastic import CorresSet
    from elasticreconstruction_tpu_torch.integrate.scene import SceneConfig
    from elasticreconstruction_tpu_torch.posegraph import EdgeList
    from elasticreconstruction_tpu_torch.registration import PreppedFragments

    p, g = inp["prepped"], inp["graph"]
    prepped = PreppedFragments(p.coarse.to(dev), p.features.to(dev), p.fine.to(dev))
    ii4, jj4 = inp["ii"][:SHARD_INLINE_PAIRS], inp["jj"][:SHARD_INLINE_PAIRS]
    return {
        "prepped": prepped, "prepped8": prepped.take(torch.tensor(SHARD_RING_INDEX, device=dev)),
        "ci": inp["clouds"].take(ii4).to(dev), "cj": inp["clouds"].take(jj4).to(dev), "ii4": ii4, "jj4": jj4,
        "edges": EdgeList.build(g["i"], g["j"], g["transform"], g["information"], g["is_odometry"], device=dev),
        "pgo_init": torch.from_numpy(g["init"]).to(dev), "slac_init": inp["slac_init"].to(dev),
        "corres": CorresSet(*(None if x is None else x.to(dev) for x in inp["corres"])),
        "depths": inp["depths"].to(dev), "poses": inp["poses"].to(dev),
        "scene": SceneConfig(**inp["scene"]),
    }


def _host(res) -> dict:
    return {k: v.cpu().numpy() for k, v in res._asdict().items() if torch.is_tensor(v)}


def shard_paths(group, dev: torch.device, inp: dict) -> dict:
    """Every distributed path once on this rank, each timed (wall and peak
    memory) with its results on the host; and the rank's kernel launches (by
    shape) and the collectives gloo staged through host memory."""
    import torch.distributed as dist

    from elasticreconstruction_tpu_torch.dist import comm, pair_sharding, pgo_dist, ring, slac_dist, volume_sharding
    from elasticreconstruction_tpu_torch.elastic import SlacConfig, SlacMode
    from elasticreconstruction_tpu_torch.integrate.scene import make_scene_volume
    from elasticreconstruction_tpu_torch.posegraph import PGOConfig
    from elasticreconstruction_tpu_torch.registration import RegistrationConfig

    c, cfg, draws = shard_case(inp, dev), RegistrationConfig(), inp["draws"]
    reset_launch_counts()
    comm.host_staged.clear()
    results, walls, peaks = {}, {}, {}

    def run(name, fn, host=_host):
        synchronize(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = fn()
        synchronize(dev)
        walls[name] = time.perf_counter() - t0
        peaks[name] = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0
        results[name] = host(out)
        return out

    for name, fused in (("pairs", False), ("pairs_fused", True)):
        run(name, lambda: pair_sharding.register_prepped_sharded(
            c["prepped"], inp["ii"], inp["jj"], None, cfg, draws=draws, fused_step=fused, group=group, device=dev))
    run("pairs_inline", lambda: pair_sharding.register_pairs_sharded(
        c["ci"], c["cj"], None, cfg, (c["ii4"], c["jj4"]), draws=draws[:SHARD_INLINE_PAIRS], group=group, device=dev))
    run("ring", lambda: ring.register_all_pairs_ring(c["prepped8"], SHARD_RING_BASE, cfg, group=group, device=dev))
    run("pgo", lambda: pgo_dist.optimize_pose_graph_sharded(c["pgo_init"], c["edges"], PGOConfig(), group=group))
    for mode in (SlacMode.SLAC, SlacMode.NONRIGID):
        run(mode.value, lambda: slac_dist.optimize_fragments_sharded(c["slac_init"], c["corres"], SlacConfig(mode=mode),
                                                                     group=group))

    def whole(slab):
        vol = volume_sharding.gather_volume(slab, group)
        return {"tsdf": vol.tsdf.cpu().numpy(), "weight": vol.weight.cpu().numpy()}

    for scatter in (False, True):
        slab = run("fuse_scatter" if scatter else "fuse", lambda: volume_sharding.fuse_sharded(
            volume_sharding.shard_volume(make_scene_volume(c["scene"], device=dev), group),
            c["depths"], c["poses"], inp["intr"], c["scene"], scatter=scatter), whole)
    run("mesh", lambda: volume_sharding.extract_mesh_sharded(slab, group, capacity_per_slab=inp["mesh_capacity"]),
        lambda t: t.cpu().numpy())
    return {"results": results, "walls_s": walls, "peak_gib": peaks, "launches": launch_counts(),
            "launches_by_shape": launches_by_shape(), "host_staged": dict(comm.host_staged),
            "backend": dist.get_backend(group), "device": str(dev)}


def shard_rank(rank: int, group, dev: torch.device, path: str) -> dict:
    """One rank of a spawned run: the inputs from ``path``, every path."""
    return shard_paths(group, dev, torch.load(path, weights_only=False))


def shard_single(inp: dict, dev: torch.device) -> dict:
    """The single-device path on the same inputs."""
    from elasticreconstruction_tpu_torch.dist import ring
    from elasticreconstruction_tpu_torch.elastic import SlacConfig, SlacMode, optimize_fragments
    from elasticreconstruction_tpu_torch.integrate import extract_mesh
    from elasticreconstruction_tpu_torch.integrate.scene import (
        integrate_frames, integrate_frames_scatter, make_scene_volume,
    )
    from elasticreconstruction_tpu_torch.posegraph import PGOConfig, optimize_pose_graph
    from elasticreconstruction_tpu_torch.registration import (
        RegistrationConfig, register_pairs_batch, register_prepped_batch,
    )

    c, cfg, draws = shard_case(inp, dev), RegistrationConfig(), inp["draws"]
    out = {name: _host(register_prepped_batch(c["prepped"], inp["ii"], inp["jj"], None, cfg, draws=draws,
                                              fused_step=fused, device=dev))
           for name, fused in (("pairs", False), ("pairs_fused", True))}
    out["pairs_inline"] = _host(register_pairs_batch(c["ci"], c["cj"], None, cfg, (c["ii4"], c["jj4"]),
                                                     draws=draws[:SHARD_INLINE_PAIRS], device=dev))
    wanted = [(i, j) for i in range(6) for j in range(i + 2, 6)]  # the real fragments' pairs
    out["ring"] = _host(register_prepped_batch(
        c["prepped8"], [i for i, _ in wanted], [j for _, j in wanted], None, cfg,
        draws=torch.stack([ring.pair_key(SHARD_RING_BASE, i, j, cfg.num_hypotheses) for i, j in wanted]),
        device=dev))
    out["ring"]["pairs"] = wanted
    out["pgo"] = _host(optimize_pose_graph(c["pgo_init"], c["edges"], PGOConfig()))
    for mode in (SlacMode.SLAC, SlacMode.NONRIGID):
        out[mode.value] = _host(optimize_fragments(c["slac_init"], c["corres"], SlacConfig(mode=mode)))
    for name, fn in (("fuse", integrate_frames), ("fuse_scatter", integrate_frames_scatter)):
        vol = fn(make_scene_volume(c["scene"], device=dev), c["depths"], c["poses"], inp["intr"], c["scene"])
        out[name] = {"tsdf": vol.tsdf.cpu().numpy(), "weight": vol.weight.cpu().numpy()}
    tris, mask = extract_mesh(vol, capacity_per_slab=inp["mesh_capacity"])
    out["mesh"] = tris[mask].cpu().numpy()
    out["mesh_slab_fill"] = int(mask.sum(1).max())
    return out


def ring_lanes_single(inp: dict, ring_res: dict, world: int, dev: torch.device) -> dict:
    """``register_prepped_batch`` on the ring's lanes, batched as the ring
    ran them (each (rank, step) in batches of ``ring.LANE_BATCH``), with the
    same per-pair draws and masked by ``ring.lanes_wanted``: the ring must
    give these bits whatever its world size."""
    from elasticreconstruction_tpu_torch.dist import ring
    from elasticreconstruction_tpu_torch.registration import RegistrationConfig, register_prepped_batch

    cfg, f = RegistrationConfig(), len(SHARD_RING_INDEX)
    per = (f // world) ** 2
    prepped8 = shard_case(inp, dev)["prepped8"]
    parts = []
    for step in range(0, len(ring_res["i"]), per):
        for a in range(step, step + per, ring.LANE_BATCH):
            b = min(a + ring.LANE_BATCH, step + per)
            lo, hi = ring_res["i"][a:b], ring_res["j"][a:b]
            parts.append(_host(register_prepped_batch(
                prepped8, lo, hi, None, cfg, device=dev,
                draws=torch.stack([ring.pair_key(SHARD_RING_BASE, int(x), int(y), cfg.num_hypotheses)
                                   for x, y in zip(lo, hi)]))))
    res = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    res["success"] &= ring.lanes_wanted(world, f)
    return res


def _sorted_rows(tris: np.ndarray) -> np.ndarray:
    flat = tris.reshape(-1, 9)
    return flat[np.lexsort(flat.T[::-1])]


def _max_diff(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return float("inf")
    return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max()) if a.size else 0.0


def check_shard(world: int, got: dict, want: dict, lanes: dict) -> tuple[dict, list[str]]:
    """``got`` (a rank's results) against the single-device ``want``: bit for
    bit at world size 1, else within the bounds above; the ring's lanes
    against ``lanes``, the same lanes batched as the ring ran them on one
    device, bit for bit. Returns the largest differences and the faults."""
    exact = world == 1
    diffs, faults = {}, []

    def close(name, field, a, b, atol=0.0, rtol=0.0):
        d = _max_diff(a, b)
        diffs[f"{name}.{field}"] = d
        if exact or atol == rtol == 0.0:
            ok = np.array_equal(a, b)
        else:
            ok = np.shape(a) == np.shape(b) and np.allclose(a, b, rtol=rtol, atol=atol)
        if not ok:
            faults.append(f"world size {world}: {name}.{field} differs by {d}")

    for name in ("pairs", "pairs_fused", "pairs_inline"):
        g, w = got[name], want[name]
        for field in ("i", "j", "success"):
            close(name, field, g[field], w[field])
        if exact:
            close(name, "num_inliers", g["num_inliers"], w["num_inliers"])
        else:
            diffs[f"{name}.num_inliers"] = _max_diff(g["num_inliers"], w["num_inliers"])
        # A rejected pair's transform is arbitrary (ICP's dead lanes run as long as the batch does).
        ok = w["success"] if not exact else slice(None)
        close(name, "transform", g["transform"][ok], w["transform"][ok], atol=SHARD_T_ATOL)
        close(name, "information", g["information"][ok], w["information"][ok], SHARD_INFO_ATOL, SHARD_INFO_RTOL)
    g = got["ring"]
    succ = [(int(a), int(b)) for a, b, ok in zip(g["i"], g["j"], g["success"]) if ok]
    lanes_want = {(i, j) for i in range(len(SHARD_RING_INDEX)) for j in range(i + 2, len(SHARD_RING_INDEX))}
    if len(succ) != len(set(succ)) or {(int(a), int(b)) for a, b in zip(g["i"], g["j"]) if b > a + 1} != lanes_want:
        faults.append(f"world size {world}: the ring's lanes miss or repeat a pair")
    w = want["ring"]
    by_pair = {p: k for k, p in enumerate(zip(g["i"].tolist(), g["j"].tolist())) if g["success"][k]}
    for b, pair in enumerate(w["pairs"]):
        k = by_pair.get(pair)
        if (k is not None) != bool(w["success"][b]):
            faults.append(f"world size {world}: ring pair {pair} success {k is not None}, replicated {w['success'][b]}")
        elif k is not None:
            dt = _max_diff(g["transform"][k], w["transform"][b])
            info_rel = _max_diff(g["information"][k], w["information"][b]) / float(np.abs(w["information"][b]).max())
            diffs["ring_vs_replicated.transform"] = max(diffs.get("ring_vs_replicated.transform", 0.0), dt)
            diffs["ring_vs_replicated.information_rel"] = max(
                diffs.get("ring_vs_replicated.information_rel", 0.0), info_rel)
            if not (dt <= SHARD_RING_REPLICATED_T_ATOL and info_rel <= SHARD_RING_REPLICATED_INFO_REL):
                faults.append(f"world size {world}: ring pair {pair} off the replicated enumeration by "
                              f"{dt} (transform), {info_rel} (information, relative)")
    # The same lanes in the same batches on one device: the same bits.
    for field in lanes:
        d = _max_diff(g[field], lanes[field])
        diffs[f"ring_lanes.{field}"] = d
        if not np.array_equal(g[field], lanes[field]):
            faults.append(f"world size {world}: ring_lanes.{field} differs by {d}")
    g, w = got["pgo"], want["pgo"]
    close("pgo", "poses", g["poses"], w["poses"], atol=SHARD_PGO_ATOL)
    close("pgo", "kept", g["kept"], w["kept"])
    for mode in ("slac", "nonrigid"):
        g, w = got[mode], want[mode]
        close(mode, "poses", g["poses"], w["poses"], atol=SHARD_SLAC_POSE_ATOL)
        close(mode, "final_rmse", g["final_rmse"], w["final_rmse"], atol=SHARD_SLAC_RMSE_ATOL)
        if exact:
            close(mode, "displacement", g["displacement"], w["displacement"])
            close(mode, "data_rmse", g["data_rmse"], w["data_rmse"])
    for name in ("fuse", "fuse_scatter"):
        close(name, "weight", got[name]["weight"], want[name]["weight"])
        close(name, "tsdf", got[name]["tsdf"], want[name]["tsdf"], atol=SHARD_TSDF_ATOL)
    if exact:
        close("mesh", "triangles", got["mesh"], want["mesh"])
    else:
        close("mesh", "sorted_triangles", _sorted_rows(got["mesh"]), _sorted_rows(want["mesh"]))
    return diffs, faults


def _same_bits(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_bits(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_bits(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def report_shard_run(name: str, ranks: list[dict], want: dict, inp: dict, dev: torch.device) -> list[str]:
    """One run's numbers on a line of its own; every rank's results must be
    the same, and rank 0's within the bounds. Returns the faults."""
    world = len(ranks)
    lanes = ring_lanes_single(inp, ranks[0]["results"]["ring"], world, dev)
    diffs, faults = check_shard(world, ranks[0]["results"], want, lanes)
    faults += [f"{name}: rank {r} differs from rank 0" for r in range(1, world)
               if not _same_bits(ranks[r]["results"], ranks[0]["results"])]
    print(json.dumps({f"dist_{name}": {
        "backend": ranks[0]["backend"], "devices": [r["device"] for r in ranks],
        "walls_s": {k: max(r["walls_s"][k] for r in ranks) for k in ranks[0]["walls_s"]},
        "peak_gib_by_rank": [max(r["peak_gib"].values()) for r in ranks],
        "peak_gib_by_path": {k: max(r["peak_gib"][k] for r in ranks) for k in ranks[0]["peak_gib"]},
        "host_staged_by_rank": [r["host_staged"] for r in ranks],
        "launches_by_shape_by_rank": [r["launches_by_shape"] for r in ranks],
        "max_abs_diff_vs_single": diffs}}))
    return faults


def phase_dist(tmp: str, frag: dict, scene: dict, graph: dict) -> dict:
    """Every path of ``dist/`` at full width against the single-device path,
    at world size 1 (NCCL, in this process), 2 (gloo on cuda:0, two spawned
    processes) twice, and ``device_count`` (NCCL, a process a card) where
    there are two cards or more. The launches of the world-size-1 run and the
    first world-size-2 run are the path's ``launches``."""
    import torch.distributed as dist

    from elasticreconstruction_tpu_torch.dist import mesh

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    inp = shard_inputs(tmp, frag, scene, graph)
    path = os.path.join(tmp, "dist_inputs.pt")
    torch.save(inp, path)
    want = shard_single(inp, dev)
    rec = {"inputs_s": time.perf_counter() - t0, "mesh_slab_fill": want["mesh_slab_fill"],
           "mesh_capacity": inp["mesh_capacity"], "triangles": len(want["mesh"])}
    if want["mesh_slab_fill"] >= inp["mesh_capacity"]:
        fail(f"dist: a z-slab of the single volume holds {want['mesh_slab_fill']} triangles, its capacity "
             f"{inp['mesh_capacity']}: the sharded mesh cannot equal it")
    faults = []

    # World size 1, NCCL, in this process.
    t0 = time.perf_counter()
    mesh.init_group("nccl", 1, 0, "file://" + os.path.join(tmp, "nccl_store"))
    try:
        one = shard_paths(dist.group.WORLD, dev, inp)
    finally:
        dist.destroy_process_group()
    rec["world_1_s"] = time.perf_counter() - t0
    launches = dict(one["launches"])
    faults += report_shard_run("world_1_nccl", [one], want, inp, dev)

    # World size 2, gloo, two processes on cuda:0; twice.
    runs = []
    for k in range(2):
        t0 = time.perf_counter()
        runs.append(mesh.spawn_ranks(shard_rank, 2, "gloo", "cuda:0", path, timeout_s=SHARD_TIMEOUT_S))
        rec[f"world_2_run_{k}_s"] = time.perf_counter() - t0
        faults += report_shard_run(f"world_2_gloo_run_{k}", runs[-1], want, inp, dev)
    for r in runs[0]:
        for name, n in r["launches"].items():
            launches[name] += n
    rec["world_2_repeats_bits"] = all(_same_bits(a["results"], b["results"]) for a, b in zip(*runs))
    if not rec["world_2_repeats_bits"]:
        faults.append("two runs at world size 2 gave different bits")
    staged = runs[0][0]["host_staged"]
    print(f"dist: under gloo with CUDA tensors these went through host memory: {staged or 'nothing'}; "
          "all_reduce, all_gather and broadcast took CUDA tensors natively")

    n = torch.cuda.device_count()
    if n >= 2:
        t0 = time.perf_counter()
        ranks = mesh.spawn_ranks(shard_rank, n, "nccl", [f"cuda:{r}" for r in range(n)], path,
                                 timeout_s=SHARD_TIMEOUT_S)
        rec[f"world_{n}_nccl_s"] = time.perf_counter() - t0
        faults += report_shard_run(f"world_{n}_nccl", ranks, want, inp, dev)
    else:
        print(f"dist: NCCL with one rank a card was not run: torch.cuda.device_count() is {n}, and NCCL "
              "cannot put two ranks on one card")
    rec["launches"] = launches
    print(json.dumps({"dist": {k: v for k, v in rec.items() if k != "launches"}}))
    require_launched("dist", launches, ["nearest_batch", "normal_eqs_batch"])
    if faults:
        fail("dist: " + "; ".join(faults))
    return rec


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
    import bench_gpu
    from elasticreconstruction_tpu_torch.registration import RegistrationConfig

    phase_build()
    phase_done("build")
    parity = phase_kernel_parity()
    phase_done("kernel parity")

    # Registration path.
    cfg = RegistrationConfig()
    dev = torch.device("cuda")
    size = bench_gpu.CARD_SIZES
    batch, num_frag, n, reps = size["batch"], size["num_frag"], size["points"], size["reps"]
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
    profile_where_time_goes(out, cfg, batch)
    del out
    phase_done("registration path")
    by_path["bench"] = phase_bench()
    phase_done("bench")

    by_path["calibration"] = phase_calibration()
    phase_done("calibration path")
    stages = phase_stages()
    by_path["stages"] = stages["launches"]
    phase_done("stage path")
    with tempfile.TemporaryDirectory() as tmp:
        frag = phase_fragments(tmp)
        by_path["fragments"] = frag["launches"]
        phase_done("fragments path")
        scene = phase_scene(tmp, frag)
        by_path["scene"] = scene["launches"]
        phase_done("scene path")
        by_path["dist"] = phase_dist(tmp, frag, scene, stages["graph"])["launches"]
        phase_done("dist paths")
        by_path["determinism"] = phase_determinism(tmp)["launches"]
        phase_done("determinism: register, posegraph, optimize and integrate twice")
        elastic = phase_elastic(tmp, frag)
        for key in ("elastic", "distorted", "warped"):
            by_path[key] = elastic["launches" if key == "elastic" else "launches_" + key]
        phase_done("elastic path")
    by_path["all"] = phase_all()["launches"]
    phase_done("all verb")
    ladder = phase_milestones()
    by_path["milestones"] = ladder["launches"]
    parity["nearest_batch"]["by_shape"].append(ladder["nearest_ladder_shape"])
    phase_done("milestones path")

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
