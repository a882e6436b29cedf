"""The card's side of the stage-parity trace of the ladder's configs.

Runs the port only (no JAX), on the card, and packs what
``tests/stage_diagnosis.py`` reads on the CPU under a directory that comes
back from the card (``chiprun_out/`` there is 64 MiB a call):

    python tests/ladder_card.py ladder --root R --results F [--trace T] [--configs K,...]
    python tests/ladder_card.py seeds --root R --seeds 0,1,2,3,4 --out F [--configs K,...]
    python tests/ladder_card.py pack --root R --dest D --part odometry|render|odometry,render [--budget-mb N]
    python tests/ladder_card.py register --root R --draws NPZ --dest D [--configs K,...]
    python tests/ladder_card.py optimize --root R --stages-from S --dest D [--configs K,...]

``--configs`` names the configs by their keys in ``CONFIGS`` (default: all):
``full`` (config 3), ``bare`` (3d), ``deformed`` (4n, config 3's clouds
through known warps), ``dist2`` (4d), ``office`` and ``livingroom2`` (5).
``--data NAME`` (``seeds``, ``register``, ``pack``) runs them on another
dataset under ``--root``, such as the JAX package's render of the same
sequence, with their artifacts under ``<artifact directory>_on_NAME``.

``ladder``: ``tools/milestones.py`` for the configs named, in this process
(4n brings config 3 with it, whose clouds it warps), with each fragment's
odometry recorded as it is built: the velocity it starts from (the previous
fragment's ``final_velocity``, which no artifact keeps), its final velocity
and the per-frame fitness, RMSE and observability (``--trace``, one JSON
file keyed by artifact directory).

``seeds``: the draw sensitivity. For each seed, a copy of each config's
``fragments/`` through ``register`` -> ``posegraph`` -> ``optimize`` ->
``integrate`` -> ``evaluate`` at the config's settings with ``cfg.seed`` set,
which seeds only the per-batch RANSAC generator
(``pipeline/stages.py::_batch_generator``); one JSON line a run (ATE, the
healthy-frame ATE for 3d, P/R, the gate's sets, the MD5 of ``loop.log``) on
stdout and in ``--out``. Renders the datasets and builds the fragments first
where they are missing. The stage functions are called at the ladder's
configuration: the CLI verbs cannot set its ``registration_batch`` (16) or
cloud capacity. 4n's runs stop at ``optimize`` in rigid and nonrigid mode,
scored as the ladder scores them; they read its warped ``fragments/`` and
the dataset's ``gt.log`` and ``intrinsics.json``, no frames.

``pack``: the small files of each config (fragment logs and health,
``registration/``, ``posegraph/``, ``slac/``, ``integrate/trajectory.log``,
the seed runs' logs, ``gt.log``, the MD5 of every depth PNG), then
``--part odometry``: the fragment clouds and every frame of the fragments
``stage_diagnosis.py fragments`` rebuilds (``ODOMETRY_FRAGMENTS``), and
``--part render``: the render sample (``RENDER_SAMPLE``). Frames are packed as
16-bit millimetres, the bytes the PNGs decode to, split into high and low
byte planes and compressed with LZMA (75 KB a 320x240 frame against 110 KB as
PNG): ``frames_<config>_<part>.xz`` with ``frames_<config>_<part>.json``
listing the frame indices. Packing stops before ``--budget-mb`` and says
what it left out. With ``--md5 FILE`` (an earlier call's ``depth_md5.json``),
``pack`` first checks that this call's render has the same bytes.

``register``: the port's ``run_registration`` at the config's settings on a
copy of each config's ``fragments/`` (as the ladder wrote them in this call,
or as an earlier call brought them back, placed under ``R/<out_*>/fragments``),
each batch on the RANSAC draws the JAX stage makes for it, read from
``--draws`` (written on the CPU by ``tests/stage_diagnosis.py draws``), then
``run_posegraph``; for 4n then ``run_optimize`` in rigid and nonrigid mode, and
for 4d in rigid mode, scored as the ladder scores them (``optimize.json``). Writes under
``D/<config>/`` what the drift gate chose and every pair's result
(``register_capture.json`` and ``.npz``, :func:`save_capture`) and the
stages' small files.

``optimize``: the port's ``run_optimize`` of 4n and 4d, scored as ``register``
scores it, on a copy of each config's ``fragments/`` with the registration and
pose graph of another run (``S/<config>/registration`` and ``posegraph``, such
as the JAX stages' written on the CPU by ``tests/stage_diagnosis.py register
--save``), so that the optimiser alone is held against the JAX stage's.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import lzma
import shutil
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from elasticreconstruction_tpu_torch.core import io_logfmt  # noqa: E402
from elasticreconstruction_tpu_torch.eval import ate as ate_mod  # noqa: E402
from elasticreconstruction_tpu_torch.native.depth_png import read_depth_u16  # noqa: E402
from elasticreconstruction_tpu_torch.pipeline import stages  # noqa: E402
from elasticreconstruction_tpu_torch.pipeline.dataset import Dataset  # noqa: E402
from elasticreconstruction_tpu_torch.tools import milestones  # noqa: E402

K = 50
# config key -> (ladder config, dataset directory, artifact directory)
CONFIGS = {
    "full": ("config3_full_rigid", "data", "out_full"),
    "bare": ("config3_degenerate", "data_bare", "out_bare"),
    "deformed": ("config4_nonrigid_deformed", "data", "out_deformed"),
    "dist2": ("config4_slac_distorted", "data_dist2", "out_dist2"),
    "office": ("config5_office", "data_office", "out_office"),
    "livingroom2": ("config5_livingroom2", "data_livingroom2", "out_livingroom2"),
}
# 4n warps config 3's clouds, so its ladder run needs config 3's.
NEEDS = {"deformed": "full"}
# Fragments whose every frame (f*K .. f*K + K) ``stage_diagnosis.py fragments``
# rebuilds: config 3's first and a mid-orbit one; config 3d's first, the last
# healthy one before the blind wall (32), the first suspect one (33) and one
# after the suspect stretch 33-41; config 5's first and a mid-orbit one.
ODOMETRY_FRAGMENTS = {"full": (0, 25), "bare": (0, 32, 33, 43), "office": (0, 10), "livingroom2": (0, 10)}
# The render sample: every n-th frame, and for 3d every frame of fragments 31-34
# and of the other fragments ``ODOMETRY_FRAGMENTS`` names.
RENDER_SAMPLE = {"full": (10, ()), "bare": (10, (0, 31, 32, 33, 34, 43)), "office": (20, ()),
                 "livingroom2": (20, ())}


def with_needs(keys) -> set[str]:
    return {*keys, *(NEEDS[k] for k in keys if k in NEEDS)}


def ladder_args(root: Path, results: Path, keys=tuple(CONFIGS)):
    names = [CONFIGS[k][0] for k in sorted(with_needs(keys))]
    return milestones.build_parser().parse_args(
        ["--only", ",".join(names), "--out", str(root), "--results", str(results)])


def stage_cfg(key: str, args, root: Path, out: Path):
    """The configuration the ladder runs config ``key``'s stages at, writing under ``out``."""
    cfg = milestones.make_cfg(args, root / CONFIGS[key][1], out)
    if key == "deformed":
        return milestones.deformed_cfg(cfg, out)
    return milestones.distorted_cfg(cfg) if key == "dist2" else cfg


def render_dataset(key: str, root: Path, args, device) -> Dataset:
    """Config ``key``'s dataset under ``root`` as the ladder renders it (a no-op where present)."""
    data = root / CONFIGS[key][1]
    if key in ("full", "deformed"):
        return milestones.main_dataset(root, args, device)
    if key == "bare":
        return milestones.gen(args, data, device, frames=args.frames, scene="livingroom_bare", radius=1.1)
    if key == "dist2":
        return milestones.gen(args, data, device, frames=args.frames, scene="livingroom", radius=1.1,
                              distortion=milestones.distortion())
    return milestones.gen(args, data, device, frames=args.frames_scenes, scene=key,
                          radius=milestones.SCENE_RADII[key])


def run_ladder(root: Path, results: Path, trace: Path | None, keys) -> None:
    """The configs through ``tools/milestones.py``, each fragment's odometry recorded."""
    record: dict = {}
    current = {"out": None}
    real_fragments, real_build = stages.run_fragments, stages.build_fragment

    def run_fragments(ds, cfg, device="cuda"):
        current["out"] = Path(cfg.out_dir).name
        record[current["out"]] = []
        return real_fragments(ds, cfg, device=device)

    def build_fragment(depths, intr, cfg, init_velocity=None):
        res = real_build(depths, intr, cfg, init_velocity=init_velocity)
        record[current["out"]].append({
            "init_velocity": init_velocity.cpu().tolist(), "final_velocity": res.final_velocity.cpu().tolist(),
            "fitness": res.fitness.cpu().tolist(), "rmse": res.rmse.cpu().tolist(),
            "obs_ratio": res.obs_ratio.cpu().tolist(),
        })
        return res

    patch = Patch()
    patch(stages, "run_fragments", run_fragments)
    patch(stages, "build_fragment", build_fragment)
    args = ladder_args(root, results, keys)
    results.parent.mkdir(parents=True, exist_ok=True)
    if "data" not in {CONFIGS[k][1] for k in with_needs(keys)}:
        # The ladder renders config 3's dataset first; none of these configs reads it.
        patch(milestones, "main_dataset", lambda root, args, device: None)
    try:
        milestones.run_ladder(args)
    finally:
        patch.undo()
    if trace is not None:
        trace.parent.mkdir(parents=True, exist_ok=True)
        trace.write_text(json.dumps(record))


def healthy_ate(cfg, ds: Dataset, device) -> dict:
    """``tools/milestones.py::run_degenerate``'s ATE over the healthy fragments' frames."""
    nf = len(io_logfmt.read_log(cfg.p_fragments() / "fragments.log").entries)
    health = stages.load_fragment_health(cfg, nf)
    est = io_logfmt.read_log(Path(cfg.out_dir) / "integrate" / "trajectory.log").matrices()
    n = min(len(est), len(ds.gt_poses))
    ok = np.ones(n, bool)
    for h in health:
        if h.get("suspect", False):
            ok[h["fragment"] * K:(h["fragment"] + 1) * K] = False
    res = ate_mod.absolute_trajectory_error(torch.from_numpy(est[:n][ok].astype(np.float32)).to(device),
                                            torch.from_numpy(ds.gt_poses[:n][ok]).to(device))
    return {"ate_rmse_healthy": float(res.rmse), "healthy_frames": int(ok.sum())}


def md5(path: Path) -> str:
    return hashlib.md5(path.read_bytes()).hexdigest()


def seed_scores(key: str, cfg, ds: Dataset, dev) -> dict:
    """One seed run's figures after its pose graph: 4n's as the ladder scores it
    (``score_deformed``: rigid and nonrigid ``optimize`` on the clouds), the
    others' through ``optimize`` -> ``integrate`` -> ``evaluate``."""
    if key == "deformed":
        m = milestones.score_deformed(cfg, ds, dev)
        return {"surface_improvement": m["surface_improvement"],
                **{f"{mode}_{k}": m[mode][k] for mode in ("rigid", "nonrigid")
                   for k in ("surface_rmse", "frag_ate_rmse", "frag_ate_max")}}
    stages.run_optimize(cfg, device=dev)
    stages.run_integrate(ds, cfg, device=dev)
    m = stages.run_evaluate(ds, cfg, device=dev)
    (Path(cfg.out_dir) / "integrate" / "mesh.ply").unlink(missing_ok=True)
    return {**{k: m[k] for k in ("ate_rmse", "registration_precision", "registration_recall")},
            **(healthy_ate(cfg, ds, dev) if key == "bare" else {})}


def run_seeds(root: Path, seeds: list[int], out: Path, device: str, keys) -> None:
    args = ladder_args(root, root / "unused.json", keys)
    dev = torch.device(device)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        for key in keys:
            _, data, art = CONFIGS[key]
            if key == "deformed":
                # Config 3's clouds, warped: no frames of its own; scored on
                # the clouds against the dataset's gt.log, so it needs no render.
                ds = Dataset(root / data)
            else:
                ds = render_dataset(key, root, args, device)
            if not (root / art / "fragments" / "fragments.log").exists():
                t0 = time.time()
                stages.run_fragments(ds, stage_cfg(key, args, root, root / art), device=dev)
                print(json.dumps({"fragments": key, "seconds": round(time.time() - t0, 1)}), flush=True)
            for seed in seeds:
                run_dir = root / "seeds" / f"{key}_s{seed}"
                if run_dir.exists():
                    shutil.rmtree(run_dir)
                shutil.copytree(root / art / "fragments", run_dir / "fragments")
                cfg = replace(stage_cfg(key, args, root, run_dir), seed=seed)
                t0 = time.time()
                reg = stages.run_registration(cfg, all_pairs=True, device=dev)
                stages.run_posegraph(cfg, device=dev)
                rec = {"config": key, "seed": seed, **seed_scores(key, cfg, ds, dev),
                       "seconds": round(time.time() - t0, 1),
                       **{k: reg[k] for k in ("pairs", "accepted", "gate_admitted", "gate_suspect_path",
                                              "gate_content_admitted") if k in reg},
                       "loop_log_md5": md5(run_dir / "registration" / "loop.log")}
                line = json.dumps(rec)
                print(line, flush=True)
                f.write(line + "\n")


def frame_sets(key: str, part: str, n_frames: int) -> list[int]:
    if part == "odometry":
        frames = {k for f in ODOMETRY_FRAGMENTS.get(key, ()) for k in range(f * K, f * K + K + 1)}
    elif key in RENDER_SAMPLE:
        every, whole = RENDER_SAMPLE[key]
        frames = set(range(0, n_frames, every)) | {k for f in whole for k in range(f * K, f * K + K + 1)}
    else:
        frames = set()
    return sorted(k for k in frames if k < n_frames)


def write_frames(paths: list[Path], dest: Path) -> int:
    """Frames as 16-bit millimetres, high and low byte planes, LZMA-compressed; returns bytes written."""
    mm = np.stack([read_depth_u16(p) for p in paths]).astype(np.uint16)
    planes = np.concatenate([(mm >> 8).astype(np.uint8).ravel(), (mm & 0xFF).astype(np.uint8).ravel()])
    dest.write_bytes(lzma.compress(planes.tobytes(), preset=6))
    return dest.stat().st_size


def read_frames(xz: Path) -> tuple[list[int], np.ndarray]:
    """What :func:`write_frames` packed: the frame indices and ``(N, H, W)`` uint16 millimetres."""
    meta = json.loads(xz.with_suffix(".json").read_text())
    n, h, w = meta["shape"]
    planes = np.frombuffer(lzma.decompress(xz.read_bytes()), np.uint8).reshape(2, n, h, w)
    return meta["frames"], (planes[0].astype(np.uint16) << 8) | planes[1]


class Patch:
    """Attribute patches, undone in reverse order."""

    def __init__(self):
        self.done = []

    def __call__(self, obj, name, value):
        self.done.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        for obj, name, value in reversed(self.done):
            setattr(obj, name, value)
        self.done.clear()


def capture_topk(seen: dict, real):
    """``mutual_topk_pairs`` that records the drift gate's suspect-path candidates and its content set."""

    def call(dist, k, *, candidates=None):
        got = real(dist, k, candidates=candidates)
        seen.update(suspect_path=set(candidates or ()), content=set(got))
        return got

    return call


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


FIELDS = ("success", "fitness", "transform", "information")


def collect(calls: list, seen: dict, stats: dict) -> dict:
    """Every pair the stage registered, in order, with its result; the
    padding of a last batch (the JAX stage pads to the batch size) dropped."""
    n = stats["pairs"]
    pairs = [(int(i), int(j)) for ii, jj, _ in calls for i, j in zip(_np(ii).tolist(), _np(jj).tolist())][:n]
    res = {k: np.concatenate([_np(getattr(r, k)) for _, _, r in calls])[:n] if calls else np.zeros((0,))
           for k in FIELDS}
    return {"admitted": pairs[: stats.get("gate_admitted", 0)], "suspect_path": seen["suspect_path"],
            "content": seen["content"], "pairs": pairs, "stats": stats, **res}


def port_registration(cfg, device, draws_for) -> dict:
    """The port's ``run_registration`` with each batch's RANSAC draws from
    ``draws_for(start, n)``: what its drift gate chose and every pair's result."""
    seen: dict = {"suspect_path": set(), "content": set()}
    calls: list = []
    real = stages.register_prepped_batch

    def batch(prepped, ii, jj, start, rcfg, **kw):
        res = real(prepped, ii, jj, None, rcfg, draws=draws_for(start, len(ii)), **kw)
        calls.append((ii, jj, res))
        return res

    patch = Patch()
    patch(stages, "_batch_generator", lambda seed, start: start)
    patch(stages, "register_prepped_batch", batch)
    patch(stages, "mutual_topk_pairs", capture_topk(seen, stages.mutual_topk_pairs))
    try:
        stats = stages.run_registration(cfg, all_pairs=True, device=device)
    finally:
        patch.undo()
    return collect(calls, seen, stats)


def save_capture(cap: dict, dest: Path) -> None:
    dest.mkdir(parents=True, exist_ok=True)
    np.savez(dest / "register_capture.npz", pairs=np.array(cap["pairs"], np.int64).reshape(-1, 2),
             **{k: cap[k] for k in FIELDS})
    (dest / "register_capture.json").write_text(json.dumps({
        "stats": cap["stats"], "admitted": cap["admitted"], "suspect_path": sorted(cap["suspect_path"]),
        "content": sorted(cap["content"])}))


def load_capture(src: Path) -> dict:
    meta = json.loads((src / "register_capture.json").read_text())
    arr = np.load(src / "register_capture.npz")
    return {"admitted": [tuple(p) for p in meta["admitted"]], "suspect_path": {tuple(p) for p in meta["suspect_path"]},
            "content": {tuple(p) for p in meta["content"]}, "pairs": [tuple(p) for p in arr["pairs"].tolist()],
            "stats": meta["stats"], **{k: arr[k] for k in FIELDS}}


def run_register(root: Path, draws_file: Path, dest: Path, device: str, keys) -> None:
    args = ladder_args(root, root / "unused.json", keys)
    draws = np.load(draws_file)

    def draws_for(start, n):
        key = f"start_{start}"
        if key not in draws:
            raise ValueError(f"{draws_file} has no draws for the batch at pair {start}")
        return torch.from_numpy(draws[key][:n])

    for key in keys:
        _, data, art = CONFIGS[key]
        run_dir = root / "jax_draws" / key
        if run_dir.exists():
            shutil.rmtree(run_dir)
        shutil.copytree(root / art / "fragments", run_dir / "fragments")
        cfg = stage_cfg(key, args, root, run_dir)
        t0 = time.time()
        cap = port_registration(cfg, torch.device(device), draws_for)
        t_reg = time.time() - t0
        stages.run_posegraph(cfg, device=device)
        save_capture(cap, dest / key)
        for sub in ("registration", "posegraph"):
            shutil.copytree(run_dir / sub, dest / key / sub, dirs_exist_ok=True)
        print(json.dumps({"register_jax_draws": key, "seconds": round(t_reg, 1), **cap["stats"]}), flush=True)
        write_optimize(key, cfg, Dataset(root / data), torch.device(device), dest / key, "optimize_jax_draws")


def run_optimize_from(root: Path, stages_from: Path, dest: Path, device: str, keys) -> None:
    args = ladder_args(root, root / "unused.json", keys)
    for key in keys:
        if key not in ("deformed", "dist2"):
            raise SystemExit(f"optimize: {key} has no optimize score")
        _, data, art = CONFIGS[key]
        run_dir = root / "stages_from" / key
        if run_dir.exists():
            shutil.rmtree(run_dir)
        shutil.copytree(root / art / "fragments", run_dir / "fragments")
        for sub in ("registration", "posegraph"):
            shutil.copytree(stages_from / key / sub, run_dir / sub)
        cfg = stage_cfg(key, args, root, run_dir)
        write_optimize(key, cfg, Dataset(root / data), torch.device(device), dest / key, "optimize_stages_from")


def write_optimize(key: str, cfg, ds: Dataset, dev, dest: Path, tag: str) -> None:
    """:func:`score_optimize` into ``dest/optimize.json`` and one JSON line, with the optimised poses."""
    scores = score_optimize(key, cfg, ds, dev)
    if scores is None:
        return
    (dest / "slac").mkdir(parents=True, exist_ok=True)
    (dest / "optimize.json").write_text(json.dumps(scores, indent=1))
    shutil.copy(Path(cfg.out_dir) / "slac" / "pose_slac.log", dest / "slac" / "pose_slac.log")
    print(json.dumps({tag: key, **scores}), flush=True)


def score_optimize(key: str, cfg, ds: Dataset, dev) -> dict | None:
    """The ladder's figures after ``optimize`` on the registration ``cfg`` points
    at: 4n's (``score_deformed``) and 4d's rigid mode (the optimised fragment
    poses' ATE and the posed clouds' surface error; its frame ATE needs the
    frames, which ``register`` does not read)."""
    if key == "deformed":
        return milestones.score_deformed(cfg, ds, dev)
    if key != "dist2":
        return None
    stages.run_optimize(cfg, device=dev)  # distorted_cfg: rigid mode
    return {"rigid": {**milestones.frag_pose_ate(cfg, ds, dev),
                      **milestones.cloud_surface_error(cfg, milestones.scenes_mod.livingroom_scene(), "rigid", ds, dev)}}


def du(path: Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def pack(root: Path, dest: Path, parts: list[str], budget_mb: float, md5_file: Path | None, device: str,
         keys) -> None:
    budget = budget_mb * (1 << 20)
    dest.mkdir(parents=True, exist_ok=True)
    left_out = []
    if md5_file is not None:
        # A later call renders the datasets again: hold its bytes to the earlier call's.
        want = json.loads(md5_file.read_text())
        args = ladder_args(root, root / "unused.json", keys)
        for key in keys:
            render_dataset(key, root, args, device)
            data = CONFIGS[key][1]
            got = {p.name: md5(p) for p in sorted((root / data / "depth").glob("*.png"))}
            same = sum(got.get(k) == v for k, v in want[key].items())
            print(json.dumps({"render_again": key, "frames": len(got), "same_bytes": same,
                              "of": len(want[key])}), flush=True)
            if same != len(want[key]):
                raise SystemExit(f"{key}: the render differs from the earlier call's")
    digests = {}
    for key in keys:
        _, data, art = CONFIGS[key]
        src, dst = root / art, dest / key
        dst.mkdir(parents=True, exist_ok=True)
        for sub in ("fragments", "registration", "posegraph", "integrate", "slac"):
            if not (src / sub).exists():
                continue
            for p in (src / sub).iterdir():
                small = p.suffix in (".log", ".info", ".json", ".txt") and p.stat().st_size < (1 << 20)
                if p.is_file() and small:
                    (dst / sub).mkdir(parents=True, exist_ok=True)
                    shutil.copy(p, dst / sub / p.name)
        for p in (root / "seeds").glob(f"{key}_s*"):
            for sub, name in (("registration", "loop.log"), ("registration", "loop.info"),
                              ("registration", "odometry.log"), ("registration", "odometry_suspect.txt"),
                              ("registration", "registration_pr.json"), ("posegraph", "pose.log"),
                              ("posegraph", "kept_edges.txt"), ("integrate", "trajectory.log")):
                if (p / sub / name).exists():
                    (dst / "seeds" / p.name / sub).mkdir(parents=True, exist_ok=True)
                    shutil.copy(p / sub / name, dst / "seeds" / p.name / sub / name)
        for name in ("gt.log", "intrinsics.json"):
            shutil.copy(root / data / name, dst / name)
        digests[key] = {p.name: md5(p) for p in sorted((root / data / "depth").glob("*.png"))}
    (dest / "depth_md5.json").write_text(json.dumps(digests))
    for key in keys if "odometry" in parts else ():
        for p in sorted((root / CONFIGS[key][2] / "fragments").glob("cloud_bin_*.pcd")):
            if du(dest) + p.stat().st_size > budget:
                left_out.append(str(p.relative_to(root)))
                continue
            shutil.copy(p, dest / key / "fragments" / p.name)
    for part in parts:
        for key in keys:
            paths = sorted((root / CONFIGS[key][1] / "depth").glob("*.png"))
            frames = frame_sets(key, part, len(paths))
            if not frames:
                continue
            xz = dest / f"frames_{key}_{part}.xz"
            size = write_frames([paths[k] for k in frames], xz)
            h, w = read_depth_u16(paths[0]).shape
            xz.with_suffix(".json").write_text(json.dumps({"frames": frames, "shape": [len(frames), h, w]}))
            if du(dest) > budget:
                xz.unlink()
                xz.with_suffix(".json").unlink()
                left_out.append(f"frames_{key}_{part} ({size} bytes)")
    print(json.dumps({"packed": str(dest), "bytes": du(dest), "left_out": left_out}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("verb", choices=["ladder", "seeds", "pack", "register", "optimize"])
    ap.add_argument("--root", type=Path, default=Path("milestone_runs_gpu"))
    ap.add_argument("--results", type=Path, default=Path("milestones_gpu.json"))
    ap.add_argument("--trace", type=Path, default=None)
    ap.add_argument("--seeds", default="0,1,2,3,4")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--dest", type=Path, default=None)
    ap.add_argument("--part", default="odometry", help="odometry, render or both, comma-separated")
    ap.add_argument("--configs", default=",".join(CONFIGS), help="comma list of CONFIGS keys")
    ap.add_argument("--data", default=None,
                    help="a dataset directory under --root rendered elsewhere (the JAX package's render) in place of "
                         "the configs' own; their artifacts go to <artifact directory>_on_<data>")
    ap.add_argument("--budget-mb", type=float, default=62.0)
    ap.add_argument("--md5", type=Path, default=None)
    ap.add_argument("--draws", type=Path, default=None)
    ap.add_argument("--stages-from", type=Path, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    keys = [k for k in args.configs.split(",") if k]
    unknown = set(keys) - set(CONFIGS)
    parts = args.part.split(",")
    if unknown or not set(parts) <= {"odometry", "render"}:
        ap.error(f"unknown configs {sorted(unknown)} or parts {parts}")
    if args.data is not None:
        if args.verb == "ladder" or "deformed" in keys:
            ap.error("--data: the stage verbs of configs that read frames")
        for k in keys:  # this invocation reads the configs' frames from --data
            name, _, art = CONFIGS[k]
            CONFIGS[k] = (name, args.data, f"{art}_on_{args.data}")
    if args.verb == "ladder":
        run_ladder(args.root, args.results, args.trace, keys)
    elif args.verb == "seeds":
        run_seeds(args.root, [int(s) for s in args.seeds.split(",")], args.out, args.device, keys)
    elif args.verb == "pack":
        pack(args.root, args.dest, parts, args.budget_mb, args.md5, args.device, keys)
    elif args.verb == "register":
        run_register(args.root, args.draws, args.dest, args.device, keys)
    else:
        run_optimize_from(args.root, args.stages_from, args.dest, args.device, keys)
    return 0


if __name__ == "__main__":
    sys.exit(main())
