#!/usr/bin/env python3
"""Per-kernel speed-of-light microbench of the PyTorch/CUDA port on one NVIDIA GPU.

Counterpart of ``kernels_bench.py`` for the port. It first calibrates the card
(``calibrate``): the rates the card reaches on streaming, matrix products,
three hand-written chain kernels whose instruction stream is known
(``elasticreconstruction_tpu_torch/kernels/cuda/csrc/calib.cu``), random
gathers and a random scatter-add. Then it times each hot kernel the port has
at production shapes (``bench_kernels``) and scores it against a roofline
built from those measured peaks (``_sol``): ``sol_ms = max_r(cost_r / peak_r)``
and ``achieved_frac = sol_ms / time_ms``. An achieved fraction outside
``[0.05, 1.2]`` marks the entry suspect: the measurement or the cost model is
broken.

All times are CUDA-event times over many launches after a warm-up. Each
measured peak is reported with its share of the H100 SXM data-sheet figure;
a peak above 105% of the data sheet is a fault of the measurement and raises.

    python3 kernels_bench_gpu.py --section all --out kernels_bench_gpu.json

Needs one CUDA card and ``nvcc``/``cuobjdump``; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

# NVIDIA H100 SXM data sheet: dense rates at the full 700 W power limit.
DATA_SHEET = {
    "bw_gbs": 3350.0,
    "fp32_tflops": 67.0,  # f32 outside the tensor cores, 2 flop per FMA
    "bf16_tflops": 989.0,
}
# f32 lane-instructions per second: one per FMA of the f32 figure.
LANE_GIPS = DATA_SHEET["fp32_tflops"] * 1e3 / 2
MAX_SHARE = 1.05
KERNEL_SECTIONS = ("nn", "icp", "fuse", "raycast", "fpfh", "voxel")
# Sections of kernels_bench.py whose kernels the port does not have yet.
UNPORTED_SECTIONS = ()

CALIB_SHAPE = (32768, 512)
CALIB_ITERS = 64
CALIB_CHAINED_LAUNCHES = 8


def _progress(msg: str) -> None:
    print(json.dumps({"kernels_bench_gpu": msg}), flush=True)


def event_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean ms of one ``fn()`` over ``reps`` back-to-back calls between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return smi.stdout.strip().splitlines()[0]


def _require_card(device) -> torch.device:
    from elasticreconstruction_tpu_torch.core.types import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"kernels_bench_gpu measures a CUDA card, not {dev}")
    return dev


def calibrate(device="cuda") -> dict:
    """Measure the card's peaks; returns ``{"peaks", "share_of_data_sheet", "sass_loop_body"}``.

    ``share_of_data_sheet`` holds, per peak, measured over data-sheet figure
    (``None`` where the data sheet gives none). Raises if a share exceeds 1.05.
    ``sass_loop_body`` holds the opcode counts of each chain kernel's compiled
    loop body, a diagnostic; raises unless the FMA chain's is one FFMA per
    chain step and no FMUL, the instruction its peak is named after.
    """
    from elasticreconstruction_tpu_torch.kernels.cuda import calib

    dev = _require_card(device)
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("calibrate: TF32 must be off for the f32 matmul peak")
    sass = calib.sass_counts()
    per_loop = calib.UNROLL * calib.CHAINS
    if sass["fma_chain"].get("FFMA", 0) != per_loop or sass["fma_chain"].get("FMUL", 0):
        raise RuntimeError(f"calibrate: the FMA chain's loop body is not {per_loop} FFMA: {sass['fma_chain']}")
    gen = torch.Generator(device=dev).manual_seed(0)
    peaks: dict[str, float] = {}

    # Streaming bandwidth: an elementwise pass over 1 GiB, read once, written once.
    _progress("calibrate: bandwidth")
    n = 1 << 28
    x = torch.rand(n, device=dev, generator=gen)
    y = torch.empty_like(x)
    dt = event_ms(lambda: torch.add(x, 1e-7, out=y), reps=16)
    peaks["peak_bw_gbs"] = 2 * n * 4 / (dt * 1e-3) / 1e9
    del x, y

    # Matrix products at 4096^3, each consuming the previous output. These are
    # plain products outside any hand kernel: torch.matmul (cuBLAS).
    _progress("calibrate: matmul")
    m = 4096
    a32 = torch.rand((m, m), device=dev, generator=gen) * 1e-3
    for label, a in (("peak_matmul_f32_tflops", a32), ("peak_matmul_bf16_tflops", a32.to(torch.bfloat16))):
        bufs = [a.clone(), torch.empty_like(a)]

        def chained(a=a, bufs=bufs):
            torch.matmul(bufs[0], a, out=bufs[1])
            bufs.reverse()

        reps = 32
        dt = event_ms(chained, reps=reps, warmup=2)
        if not torch.isfinite(bufs[0].float()).all():
            raise RuntimeError(f"calibrate: {label} chain left non-finite values")
        peaks[label] = 2 * m**3 / (dt * 1e-3) / 1e12
    del a32, bufs

    # The three chain kernels: K chained launches, each on the last output.
    _progress("calibrate: chain kernels")
    xb = torch.rand(CALIB_SHAPE, device=dev, generator=gen)
    yb = xb * 0.75 + 0.1  # the select's other operand, computed once
    elems = xb.numel()

    def chain(fn, *extra):
        def run():
            c = xb
            for _ in range(CALIB_CHAINED_LAUNCHES):
                c = fn(c, *extra, CALIB_ITERS)
            return c

        return run

    per_iter = {}
    for name, run in (
        ("fma_chain", chain(calib.fma_chain)),
        ("where_chain", chain(calib.where_chain, yb)),
        ("threshold_sum_chain", chain(calib.threshold_sum_chain)),
    ):
        per_iter[name] = event_ms(run) * 1e-3 / (CALIB_CHAINED_LAUNCHES * CALIB_ITERS)
    chain_ops = calib.CHAINS * elems
    peaks["peak_fp32_fma_tflops"] = 2 * chain_ops / per_iter["fma_chain"] / 1e12
    # One where-op = one compare + one select; one threshold-sum op = compare,
    # and, convert, add.
    peaks["peak_where_gops"] = chain_ops / per_iter["where_chain"] / 1e9
    peaks["peak_threshold_sum_gops"] = chain_ops / per_iter["threshold_sum_chain"] / 1e9
    del xb, yb

    # Random 32-bit gathers from a table beyond the L2 cache (64 MB) and one
    # inside it (1 MB), and a random scatter-add into 64 MB.
    _progress("calibrate: gather, scatter")
    ng = 1 << 23
    out = torch.empty(ng, device=dev)
    for label, tbits in (("peak_gather_hbm_geps", 24), ("peak_gather_l2_geps", 18)):
        table = torch.rand(1 << tbits, device=dev, generator=gen)
        idx = torch.randint(0, 1 << tbits, (ng,), device=dev, generator=gen)
        dt = event_ms(lambda: torch.index_select(table, 0, idx, out=out), reps=16)
        peaks[label] = ng / (dt * 1e-3) / 1e9
    acc = torch.zeros(1 << 24, device=dev)
    idx = torch.randint(0, 1 << 24, (ng,), device=dev, generator=gen)
    ones = torch.ones(ng, device=dev)
    dt = event_ms(lambda: acc.index_add_(0, idx, ones), reps=16)
    peaks["peak_scatter_hbm_geps"] = ng / (dt * 1e-3) / 1e9

    # Shares of the data sheet. The compare/select and threshold-sum chains
    # have no data-sheet rate of their own: theirs is the f32 lane-instruction
    # rate over the instructions one op needs by the source's arithmetic
    # (calib.lane_instructions), whatever the compiler made of it.
    per_op = {name: calib.lane_instructions(name, 1) / calib.CHAINS
              for name in ("where_chain", "threshold_sum_chain")}
    share = {
        "peak_bw_gbs": peaks["peak_bw_gbs"] / DATA_SHEET["bw_gbs"],
        "peak_matmul_f32_tflops": peaks["peak_matmul_f32_tflops"] / DATA_SHEET["fp32_tflops"],
        "peak_matmul_bf16_tflops": peaks["peak_matmul_bf16_tflops"] / DATA_SHEET["bf16_tflops"],
        "peak_fp32_fma_tflops": peaks["peak_fp32_fma_tflops"] / DATA_SHEET["fp32_tflops"],
        "peak_where_gops": peaks["peak_where_gops"] * per_op["where_chain"] / LANE_GIPS,
        "peak_threshold_sum_gops": peaks["peak_threshold_sum_gops"] * per_op["threshold_sum_chain"] / LANE_GIPS,
        "peak_gather_hbm_geps": None,
        "peak_gather_l2_geps": None,
        "peak_scatter_hbm_geps": None,
    }
    for key, value in peaks.items():
        s = share[key]
        print(f"  {key} = {value:.2f}" + ("" if s is None else f" ({100 * s:.1f}% of the data sheet)"), flush=True)
    over = {k: s for k, s in share.items() if s is not None and s > MAX_SHARE}
    if over:
        raise RuntimeError(f"calibrate: measured peaks above {MAX_SHARE:.0%} of the data sheet: {over}")
    return {"peaks": peaks, "share_of_data_sheet": share, "sass_loop_body": sass}


# cost-model key -> (peak key, unit scale to per-second, key of the time in the breakdown)
_RESOURCES = {
    "hbm_bytes": ("peak_bw_gbs", 1e9, "hbm_ms"),
    "fp32_ops": ("peak_fp32_fma_tflops", 1e12, "fp32_ms"),
    "where_ops": ("peak_where_gops", 1e9, "where_ms"),
    "matmul_flops": ("peak_matmul_f32_tflops", 1e12, "matmul_ms"),
    "matmul_bf16_flops": ("peak_matmul_bf16_tflops", 1e12, "matmul_bf16_ms"),
    "gathers_hbm": ("peak_gather_hbm_geps", 1e9, "gather_hbm_ms"),
    "gathers_l2": ("peak_gather_l2_geps", 1e9, "gather_l2_ms"),
    "scatters_hbm": ("peak_scatter_hbm_geps", 1e9, "scatter_hbm_ms"),
    "threshold_sum_ops": ("peak_threshold_sum_gops", 1e9, "threshold_sum_ms"),
}


def _sol(entry: dict, peaks: dict) -> dict:
    """Score ``entry`` (``time_ms`` and a per-resource cost ``model``) against ``peaks``."""
    model = entry["model"]
    times = {}
    for cost_key, (peak_key, scale, time_key) in _RESOURCES.items():
        times[time_key] = model.get(cost_key, 0) / (peaks[peak_key] * scale) * 1e3
    entry["sol_breakdown_ms"] = {k: round(v, 4) for k, v in times.items()}
    entry["sol_ms"] = round(max(times.values()), 4)
    entry["bound_by"] = max(times, key=times.get).replace("_ms", "")
    entry["achieved_frac"] = round(entry["sol_ms"] / entry["time_ms"], 3) if entry["time_ms"] else 0.0
    # A kernel cannot beat its own speed of light, and one 20x under it was
    # mis-timed or mis-modelled: flag instead of reporting it as a result.
    if not (0.05 <= entry["achieved_frac"] <= 1.2):
        entry["suspect"] = True
        entry["suspect_note"] = (
            "achieved_frac outside [0.05, 1.2]: measurement or cost model "
            "invalid — do not cite this entry"
        )
    return entry


def raycast_march_voxels(vol, pose, intr, steps: int, depth_min: float = 0.1,
                         depth_max: float = 6.0) -> tuple[int, float]:
    """Distinct voxels the raycast's march reads, each ray stopped at its first
    crossing (the march of ``kernels/raycast.py::raycast_plain``, its indices
    kept), and the mean steps a ray marches: what ``csrc/raycast.cu`` has to
    read of the volume."""
    from elasticreconstruction_tpu_torch.core import camera as cam
    from elasticreconstruction_tpu_torch.core import se3
    from elasticreconstruction_tpu_torch.core.types import f32_reciprocal, fma
    from elasticreconstruction_tpu_torch.kernels.tsdf import _nearest, make_sampling_volume

    dev = vol.tsdf.device
    dirs = se3.rotate(pose, cam.ray_directions(intr, device=dev).reshape(-1, 3)).unbind(-1)
    origin = [pose[k, 3] for k in range(3)]
    dz = np.float32((depth_max - depth_min) / steps)
    sval = make_sampling_volume(vol)
    inv = f32_reciprocal(vol.voxel_size)
    _, ny, nz = vol.shape
    n = dirs[0].numel()
    active = torch.ones(n, dtype=torch.bool, device=dev)
    prev_val = torch.zeros(n, device=dev)
    prev_valid = torch.zeros(n, dtype=torch.bool, device=dev)
    seen, marched = [], torch.zeros((), dtype=torch.int64, device=dev)
    for step in range(steps):
        z = float(np.float32(depth_min) + (np.float32(step) + np.float32(1.0)) * dz)
        p = [fma(d, z, o) for o, d in zip(origin, dirs)]
        ic = [torch.clip(torch.round((c - o) * inv).to(torch.int64), 0, m - 1)
              for c, o, m in zip(p, vol.origin, vol.shape)]
        seen.append(((ic[0] * ny + ic[1]) * nz + ic[2])[active])
        marched += active.sum()
        val, valid = _nearest(sval, vol.origin, vol.voxel_size, p)
        active &= ~(prev_valid & valid & (prev_val > 0) & (val <= 0))
        prev_val, prev_valid = val, valid
    return int(torch.unique(torch.cat(seen)).numel()), marched.item() / n


def bench_kernels(peaks: dict, want=None, device="cuda") -> list[dict]:
    """Time the port's hot kernels at production shapes and score each with :func:`_sol`.

    ``want``: a set of section names out of ``KERNEL_SECTIONS``, or None for all.
    """
    from elasticreconstruction_tpu_torch.core.camera import PRIMESENSE
    from elasticreconstruction_tpu_torch.core.types import PointCloud
    from elasticreconstruction_tpu_torch.kernels import fpfh as _fpfh
    from elasticreconstruction_tpu_torch.kernels import raycast as _raycast
    from elasticreconstruction_tpu_torch.kernels import tsdf as _tsdf
    from elasticreconstruction_tpu_torch.kernels import voxel_grid as _voxel
    from elasticreconstruction_tpu_torch.kernels.cuda import icp_step as _cicp
    from elasticreconstruction_tpu_torch.kernels.cuda import nn as _cnn
    from elasticreconstruction_tpu_torch.registration import icp as _icp

    want = set(KERNEL_SECTIONS) if want is None else set(want)
    unknown = want - set(KERNEL_SECTIONS)
    if unknown:
        raise ValueError(f"bench_kernels: no such section(s) {sorted(unknown)}; the port has {KERNEL_SECTIONS}")
    dev = _require_card(device)
    rng = np.random.default_rng(0)
    entries = []

    def on_card(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    def unit(shape):
        v = rng.normal(size=shape).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    B, NQ, NR = 16, 4096, 8192
    el = B * NQ * NR
    q = on_card(rng.uniform(-1.5, 1.5, (B, NQ, 3)))
    r = on_card(rng.uniform(-1.5, 1.5, (B, NR, 3)))
    msk = torch.ones((B, NR), dtype=torch.bool, device=dev)
    shape = f"B={B} NQ={NQ} NR={NR}"
    # Per (query, ref) pair: 3 multiplies and 2 adds of the dot product, 2 adds for
    # the norms, 1 min (csrc/nn.cuh does them as 3 FMA and a min, the norms per point).
    nn_ops = el * 8
    nn_bytes = B * (NQ * 12 + NR * 13 + NQ * 8)  # q, r + 1-byte mask, (d2, idx) out

    if "nn" in want:
        _progress("kernel: cuda nn")
        dt = event_ms(lambda: _cnn.nearest_batch(q, r, msk), reps=32)
        entries.append(_sol({
            "kernel": "cuda_nn.nearest_batch",
            "shape": shape,
            "time_ms": round(dt, 4),
            "gpairs_per_s": round(el / (dt * 1e-3) / 1e9, 2),
            "model": {"hbm_bytes": nn_bytes, "fp32_ops": nn_ops},
            "model_note": "8 f32 operations per pair on the CUDA cores; no matrix-unit term",
        }, peaks))

    if "icp" in want:
        _progress("kernel: cuda icp")
        dnrm = on_card(unit((B, NR, 3)))
        w = torch.ones((B, NQ), device=dev)
        dt = event_ms(lambda: _cicp.normal_eqs_batch(q, w, r, dnrm, msk, max_dist=0.075), reps=32)
        entries.append(_sol({
            "kernel": "cuda_icp.normal_eqs_batch",
            "shape": shape,
            "time_ms": round(dt, 4),
            "model": {
                "hbm_bytes": B * (NQ * 16 + NR * 25 + 4 * 44),  # p, w; dst, normals, mask; H, g, n_in, sse
                "fp32_ops": nn_ops + B * NQ * 80,  # NN + per-query gather, residual, J, 29 sums
            },
            "model_note": "rows are gathered directly: no one-hot gather term",
        }, peaks))

        # The step registration/icp.py runs by default: the NN kernel, torch
        # row gathers and masked einsums, the 6x6 solve and the pose update.
        dst = PointCloud(r, dnrm, msk)
        src_mask = torch.ones((B, NQ), dtype=torch.bool, device=dev)
        T = torch.eye(4, device=dev).expand(B, 4, 4).contiguous()
        dt = event_ms(lambda: _icp._step_batch(q, src_mask, dst, T, 0.075, 1e-6, False), reps=16)
        entries.append(_sol({
            "kernel": "icp.step_production",
            "shape": f"{shape} (NN kernel + torch gather path)",
            "time_ms": round(dt, 4),
            "model": {
                "hbm_bytes": nn_bytes + B * NR * 12,
                "fp32_ops": nn_ops,
                # dst point and normal rows: a contiguous 12-byte row costs ~2
                # random-access units, not 6 independent 32-bit loads.
                "gathers_hbm": B * NQ * 2 * 2,
            },
            "model_note": "per GN iteration; the J/H/g einsums and the solve are O(B*NQ), negligible",
        }, peaks))

    # A 640 x 480 depth map about 2 m away, and the identity pose (kernels_bench.py's inputs).
    intr = PRIMESENSE
    depth = on_card((2.0 + 0.5 * rng.standard_normal((480, 640))).clip(0.5, 5.0))
    pose = torch.eye(4, device=dev)

    if "fuse" in want:
        # The volume is the carry: each call fuses into the previous call's volume.
        for name, vshape, vs in (("fragment", (256, 256, 256), 0.012), ("scene", (448, 256, 448), 0.015)):
            nvox = int(np.prod(vshape))
            ns = 640 * 480 * 9  # pixels x band samples
            for kernel, fn, model in (
                ("fuse", _tsdf.fuse, {
                    "hbm_bytes": nvox * 16,  # read + write tsdf and weight
                    "fp32_ops": nvox * 25,  # project + update epilogue (estimate)
                    "gathers_l2": nvox,  # depth-map lookup (1.2 MB table)
                }),
                ("fuse_scatter", _tsdf.fuse_scatter, {
                    "hbm_bytes": nvox * 24,  # dense merge read-modify-write
                    "fp32_ops": ns * 40,  # project center + observation epilogue (estimate)
                    "gathers_l2": ns,  # depth lookup per sample
                    "scatters_hbm": ns,  # one random read-modify-write per sample
                }),
            ):
                _progress(f"kernel: tsdf.{kernel}[{name}]")
                vol = [_tsdf.make_volume(vshape, vs, (-1.5, -1.5, 0.3), device=dev)]

                def step(fn=fn, vol=vol):
                    vol[0] = fn(vol[0], depth, pose, intr)

                dt = event_ms(step, reps=8, warmup=1)
                entries.append(_sol({
                    "kernel": f"tsdf.{kernel}[{name}]",
                    "shape": f"{vshape} vox, 640x480 depth" + (" x 9 samples" if kernel == "fuse_scatter" else ""),
                    "time_ms": round(dt, 4),
                    "gvoxels_per_s": round(nvox / (dt * 1e-3) / 1e9, 2),
                    "model": model,
                    "model_note": ("fuse: the hand-written kernel csrc/tsdf_fuse.cu, in place; fuse_scatter: plain "
                                   "torch ops (the reference's fuse is plain jnp); op counts are estimates"),
                }, peaks))
                del vol

    if "raycast" in want:
        # One launch of csrc/raycast.cu: a ray a thread, stopped at its first
        # crossing, each step a read that waits on the one before. Its bytes
        # bound counts the distinct voxels the march reads (tsdf and weight),
        # the ray directions and the outputs; the chain of dependent reads,
        # which no measured peak models, keeps it far above that bound.
        vol = _tsdf.fuse(_tsdf.make_volume((256, 256, 256), 0.012, (-1.5, -1.5, 0.3), device=dev),
                         depth, pose, intr)
        nray = intr.width * intr.height
        for steps in (96, 192):
            _progress(f"kernel: raycast[{steps}steps]")
            dt = event_ms(lambda steps=steps: _raycast.raycast(vol, pose, intr, num_steps=steps), reps=4, warmup=1)
            voxels, marched = raycast_march_voxels(vol, pose, intr, steps)
            nbytes = 8 * voxels + 37 * nray
            entries.append({
                "kernel": f"raycast.raycast[{steps}steps]",
                "shape": f"640x480 rays x {steps} steps, 256^3 vol",
                "time_ms": round(dt, 4),
                "mrays_per_s": round(nray / (dt * 1e-3) / 1e6, 2),
                "steps_marched_mean": round(marched, 2),
                "bytes": nbytes,
                "bytes_bound_ms": round(nbytes / (peaks["peak_bw_gbs"] * 1e9) * 1e3, 4),
                "model": {},
                "note": "latency-bound: one chain of dependent reads a ray; no analytic roofline",
            })
        del vol

    if "fpfh" in want:
        _progress("kernel: fpfh")
        cloud = PointCloud.from_points(rng.uniform(-1.5, 1.5, (4096, 3)).astype(np.float32),
                                       unit((4096, 3)), device=dev)
        dt = event_ms(lambda: _fpfh.fpfh_radius(cloud, 0.25), reps=8, warmup=1)
        n2 = 4096 * 4096
        # Per pair (kernels/fpfh.py): the pair frame (~66 FMA-class ops), the
        # theta half-plane rotations (30) and the mix epilogue (~6); 33
        # threshold-sum indicator accumulations; two d2 passes and the SPFH mix
        # as f32 matrix products.
        entries.append(_sol({
            "kernel": "fpfh.fpfh_radius",
            "shape": "N=4096, radius 0.25",
            "time_ms": round(dt, 4),
            "model": {
                "fp32_ops": n2 * 100,
                "threshold_sum_ops": n2 * 33,
                "matmul_flops": n2 * (12 + 66),
            },
            "model_note": "plain torch ops in blocks of 256 queries; op counts per pair are estimates",
        }, peaks))

    if "voxel" in want:
        _progress("kernel: voxel_downsample")
        big = PointCloud.from_points(rng.uniform(-1.5, 1.5, (131072, 3)).astype(np.float32), device=dev)
        dt = event_ms(lambda: _voxel.voxel_downsample(big, 0.05, 8192), reps=16)
        entries.append({
            "kernel": "voxel_grid.voxel_downsample",
            "shape": "131072 -> 8192",
            "time_ms": round(dt, 4),
            "mpoints_per_s": round(131072 / (dt * 1e-3) / 1e6, 2),
            "model": {},
            "note": "sort-bound; no analytic roofline",
        })
    return entries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--section", default="all",
                    choices=["all", "calibrate", "kernels", *KERNEL_SECTIONS],
                    help="calibrate only, or calibrate and score all kernels or one section")
    ap.add_argument("--out", default=None, metavar="PATH", help="also write the JSON here")
    args = ap.parse_args(argv)

    dev = _require_card("cuda")
    out = {
        "platform": "gpu",
        "device_kind": torch.cuda.get_device_name(dev),
        "card_and_power_limit": card_line(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "timing_note": "CUDA-event times over back-to-back launches after a warm-up",
    }
    cal = calibrate(dev)
    out["calibration"] = {k: round(v, 2) for k, v in cal["peaks"].items()}
    out["calibration_share_of_data_sheet"] = {
        k: None if v is None else round(v, 4) for k, v in cal["share_of_data_sheet"].items()
    }
    out["calibration_sass_loop_body"] = cal["sass_loop_body"]
    if args.section != "calibrate":
        want = None if args.section in ("all", "kernels") else {args.section}
        out["kernels"] = bench_kernels(cal["peaks"], want, dev)
    text = json.dumps(out, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
