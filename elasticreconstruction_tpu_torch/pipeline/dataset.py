"""Dataset IO: depth PNG sequences + ground truth, reference-compatible.

Counterpart of ``elasticreconstruction_tpu/pipeline/dataset.py``: the
augmented ICL-NUIM layout (16-bit depth PNGs in millimetres + ``gt.log`` +
``intrinsics.json``, or one ``stream.erts`` container) and the synthetic
generator, which renders a procedural scene into that layout on ``device``.
Depth distortion (``synthetic/distortion.py``) is not ported yet: a dataset's
``distortion.json`` is kept as text and reading ``Dataset.distortion`` raises.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch

from ..core import camera as cam
from ..core import io_logfmt
from ..core.types import resolve_device
from ..native import depth_png

DEPTH_SCALE = 1000.0  # mm per meter (PrimeSense/ICL-NUIM convention)
_NO_DISTORTION = "synthetic/distortion.py is not ported to the PyTorch package yet"


def write_depth_png(path, depth_m: np.ndarray) -> None:
    depth_png.write_depth(path, depth_m)


def read_depth_png(path) -> np.ndarray:
    return depth_png.read_depth(path)


def write_intrinsics(path, intr: cam.Intrinsics) -> None:
    with open(path, "w") as f:
        json.dump(intr._asdict(), f, indent=2)


def read_intrinsics(path) -> cam.Intrinsics:
    with open(path) as f:
        d = json.load(f)
    return cam.Intrinsics(**d)


class Dataset:
    """Depth frames + intrinsics (+ optional gt trajectory).

    Two layouts: a directory of 16-bit depth PNGs with a side-car
    ``intrinsics.json``, or a single self-describing ``stream.erts``
    container (``core/stream.py``). The stream wins when both are present.
    """

    def __init__(self, root: str | os.PathLike):
        self.root = Path(root)
        stream_path = self.root / "stream.erts"
        if stream_path.exists():
            from ..core.stream import StreamReader

            self.stream = StreamReader(stream_path)
            self.depth_paths = []
            self.intrinsics = cam.Intrinsics(**self.stream.header["intrinsics"])
        else:
            self.stream = None
            self.depth_paths = sorted((self.root / "depth").glob("*.png"))
            self.intrinsics = read_intrinsics(self.root / "intrinsics.json")
        gt = self.root / "gt.log"
        self.gt_poses = io_logfmt.read_log(gt).matrices().astype(np.float32) if gt.exists() else None
        dp = self.root / "distortion.json"
        self.distortion_json = dp.read_text() if dp.exists() else None

    @property
    def distortion(self):
        """The injected depth distortion: None without ``distortion.json``;
        with one, raises until ``synthetic/distortion.py`` is ported."""
        if self.distortion_json is None:
            return None
        raise NotImplementedError(f"{self.root / 'distortion.json'}: {_NO_DISTORTION}")

    def __len__(self) -> int:
        if self.stream is not None:
            return len(self.stream)
        return len(self.depth_paths)

    def depth(self, k: int) -> np.ndarray:
        if self.stream is not None:
            return self.stream.depth(k)
        return read_depth_png(self.depth_paths[k])

    def depth_chunk(self, start: int, count: int) -> np.ndarray:
        """Frames ``start .. start + count - 1`` (fewer at the end), decoded on host threads."""
        if self.stream is not None:
            return self.stream.depth_chunk(start, count)
        paths = self.depth_paths[start : min(start + count, len(self))]
        return depth_png.read_depth_batch(paths, self.intrinsics.width, self.intrinsics.height)


def generate_synthetic(
    root: str | os.PathLike,
    *,
    num_frames: int = 100,
    intr: cam.Intrinsics | None = None,
    scene: str = "livingroom",
    trajectory: str = "pendulum",
    radius: float = 1.2,
    height: float = 1.3,
    sweep: float = 2 * np.pi,
    amplitude: float = 0.8,
    start_angle: float = 0.0,
    seed: int = 0,
    depth_noise: float = 0.0,
    distortion=None,
    device="cuda",
) -> Dataset:
    """Render a synthetic sequence on ``device`` to the reference dataset layout.

    The sensor noise takes the reference's numpy draws from ``seed``, chunk by
    chunk of 16 frames. ``distortion`` must be None until
    ``synthetic/distortion.py`` is ported.
    """
    from ..synthetic import render, scenes

    if distortion is not None:
        raise NotImplementedError(f"generate_synthetic(distortion=...): {_NO_DISTORTION}")
    dev = resolve_device(device)
    if intr is None:
        intr = cam.Intrinsics(fx=160.0, fy=160.0, cx=79.5, cy=59.5, width=160, height=120)
    root = Path(root)
    scene_fns = {
        "livingroom": scenes.livingroom_scene,
        "livingroom_bare": lambda: scenes.livingroom_scene(bare_minus_z=True),
        "livingroom2": scenes.livingroom2_scene,
        "office": scenes.office_scene,
    }
    if scene not in scene_fns:
        raise ValueError(f"unknown synthetic scene {scene!r}")
    if trajectory == "pendulum":
        poses = scenes.pendulum_trajectory(
            num_frames, radius=radius, height=height, amplitude=amplitude, start_angle=start_angle
        )
    elif trajectory == "orbit":
        poses = scenes.orbit_trajectory(
            num_frames, radius=radius, height=height, sweep=sweep, start_angle=start_angle
        )
    elif trajectory == "survey":
        poses = scenes.survey_trajectory(
            num_frames, radius=radius, height=height, sweep=sweep, start_angle=start_angle
        )
    else:
        raise ValueError(f"unknown trajectory {trajectory!r}")
    (root / "depth").mkdir(parents=True, exist_ok=True)
    sdf_scene = scene_fns[scene]()
    rng = np.random.default_rng(seed)
    chunk = 16
    for s in range(0, num_frames, chunk):
        ps = torch.from_numpy(poses[s : s + chunk]).to(dev)
        depths = render.render_batch(sdf_scene, ps, intr, max_depth=6.0).cpu().numpy()
        if depth_noise > 0:
            noise = rng.normal(0, depth_noise, size=depths.shape).astype(np.float32)
            depths = np.where(depths > 0, np.maximum(depths + noise * depths, 0.05), 0.0)
        for k in range(depths.shape[0]):
            write_depth_png(root / "depth" / f"{s + k:06d}.png", depths[k])
    write_intrinsics(root / "intrinsics.json", intr)
    io_logfmt.write_log(root / "gt.log", io_logfmt.Trajectory.from_matrices(poses))
    return Dataset(root)
