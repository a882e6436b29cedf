"""The synthetic livingroom and its orbit, rendered into the dataset layout the program reads.

Frozen copies of the port's ``synthetic/sdf.py``, ``synthetic/scenes.py``
(``livingroom_scene``, ``look_at_pose``, ``orbit_trajectory``),
``synthetic/render.py`` (``render_batch``), the multiplicative depth noise of
``pipeline/dataset.py::generate_synthetic`` and the 16-bit millimetre PNG
writer of ``native/depth_png.py``, at the commit that introduced the
benchmark. The layout is the one ``pipeline/dataset.py::Dataset`` reads:
``depth/<frame:06d>.png``, ``intrinsics.json`` and ``gt.log``.
"""

from __future__ import annotations

import json
import struct
import zlib
from pathlib import Path

import numpy as np
import torch

from ..reference import files
from ..reference.geometry import Intrinsics, ray_directions

# ------------------------------------------------------------------ SDFs


def _norm(*comps):
    acc = comps[0] * comps[0]
    for c in comps[1:]:
        acc = acc + c * c
    return torch.sqrt(acc)


def sphere(center, radius):
    c = tuple(float(x) for x in center)
    return lambda p: _norm(*(p[..., k] - c[k] for k in range(3))) - radius


def box(center, half):
    c, h = tuple(float(x) for x in center), tuple(float(x) for x in half)

    def f(p):
        q = [torch.abs(p[..., k] - c[k]) - h[k] for k in range(3)]
        outside = _norm(*(torch.clamp_min(x, 0.0) for x in q))
        return outside + torch.clamp_max(torch.maximum(torch.maximum(q[0], q[1]), q[2]), 0.0)

    return f


def rounded_box(center, half, radius):
    base = box(center, half)
    return lambda p: base(p) - radius


def cylinder_y(center, radius, half_height):
    c = tuple(float(x) for x in center)

    def f(p):
        d_xy = _norm(p[..., 0] - c[0], p[..., 2] - c[2]) - radius
        d_y = torch.abs(p[..., 1] - c[1]) - half_height
        outside = _norm(torch.clamp_min(d_xy, 0.0), torch.clamp_min(d_y, 0.0))
        return outside + torch.clamp_max(torch.maximum(d_xy, d_y), 0.0)

    return f


def invert(s):
    return lambda p: -s(p)


def union(*sdfs):
    def f(p):
        d = sdfs[0](p)
        for s in sdfs[1:]:
            d = torch.minimum(d, s(p))
        return d

    return f


def subtract(a, b):
    return lambda p: torch.maximum(a(p), -b(p))


def livingroom_scene():
    """A furnished 6 x 3 x 5 m room with relief on every wall (the ICL-NUIM livingroom stand-in)."""
    return union(
        invert(box((0.0, 1.5, 0.0), (3.0, 1.5, 2.5))),
        rounded_box((-2.2, 0.35, 0.0), (0.45, 0.3, 1.0), 0.05),
        rounded_box((-2.65, 0.8, 0.0), (0.15, 0.5, 1.0), 0.05),
        box((0.0, 0.45, 0.0), (0.6, 0.05, 0.4)),
        cylinder_y((0.0, 0.2, 0.0), 0.08, 0.2),
        sphere((2.3, 1.0, -1.8), 0.35),
        cylinder_y((2.3, 0.35, -1.8), 0.05, 0.35),
        box((0.0, 1.0, 2.3), (1.2, 0.05, 0.18)),
        box((0.0, 1.6, 2.3), (1.2, 0.05, 0.18)),
        rounded_box((-0.4, 1.2, 2.3), (0.3, 0.14, 0.12), 0.02),
        rounded_box((1.8, 0.45, 1.6), (0.3, 0.45, 0.3), 0.08),
        rounded_box((-0.9, 0.25, -1.6), (0.35, 0.25, 0.35), 0.06),
        box((2.95, 1.6, 0.5), (0.04, 0.4, 0.6)),
        subtract(box((-2.97, 1.05, -1.5), (0.06, 1.05, 0.5)), box((-2.95, 1.0, -1.5), (0.08, 0.95, 0.4))),
        box((-2.96, 1.7, 1.3), (0.04, 0.35, 0.45)),
        subtract(box((0.2, 1.6, -2.46), (0.8, 0.75, 0.05)), box((0.2, 1.6, -2.44), (0.7, 0.65, 0.08))),
        box((0.2, 0.82, -2.42), (0.9, 0.03, 0.09)),
        rounded_box((0.2, 0.35, -2.4), (0.7, 0.3, 0.06), 0.03),
        box((-1.7, 1.5, -2.46), (0.35, 0.45, 0.05)),
        box((1.9, 1.45, -2.46), (0.3, 0.4, 0.05)),
        rounded_box((-1.8, 0.35, -2.2), (0.5, 0.35, 0.25), 0.03),
        box((2.85, 0.9, -0.6), (0.15, 0.9, 0.45)),
        cylinder_y((2.6, 0.15, 1.6), 0.18, 0.15),
        sphere((2.6, 0.75, 1.6), 0.4),
        box((1.9, 0.5, 2.3), (0.45, 0.5, 0.18)),
        box((-1.9, 1.5, 2.46), (0.4, 0.4, 0.05)),
        subtract(box((0.0, 0.04, 0.0), (3.0, 0.08, 2.5)), box((0.0, 0.05, 0.0), (2.96, 0.12, 2.46))),
    )


# ---------------------------------------------------------- trajectory


def look_at_pose(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    eye = np.asarray(eye, dtype=np.float64)
    fwd = np.asarray(target, dtype=np.float64) - eye
    fwd = fwd / np.linalg.norm(fwd)
    x = np.cross(fwd, np.asarray(up, dtype=np.float64))
    if np.linalg.norm(x) < 1e-6:
        x = np.cross(fwd, (1.0, 0.0, 0.0))
    x /= np.linalg.norm(x)
    T = np.eye(4)
    T[:3, :3] = np.stack([x, np.cross(fwd, x), fwd], axis=1)
    T[:3, 3] = eye
    return T


def orbit(num_frames: int, *, radius: float, height: float, sweep: float, start_angle: float,
          look_radius: float = 10.0, bob: float = 0.08) -> np.ndarray:
    """``(T, 4, 4)`` float32 camera-to-world poses orbiting the room centre, looking outward."""
    poses = []
    for k in range(num_frames):
        a = start_angle + sweep * k / max(num_frames, 1)
        eye = (radius * np.cos(a), height + bob * np.sin(3.1 * a), radius * np.sin(a))
        target = (look_radius * np.cos(a), height * 0.7, look_radius * np.sin(a))
        poses.append(look_at_pose(eye, target))
    return np.stack(poses).astype(np.float32)


# --------------------------------------------------------------- render


def render_batch(scene, poses: torch.Tensor, intr: Intrinsics, *, max_depth: float = 6.0, num_steps: int = 96,
                 hit_threshold: float = 1e-3) -> torch.Tensor:
    """Sphere-traced depth ``(B, H, W)`` (camera z of the first hit, 0 where the ray escapes)."""
    dev = poses.device
    dirs_cam = ray_directions(intr, device=dev)
    norm = torch.linalg.vector_norm(dirs_cam, dim=-1, keepdim=True)
    dirs_unit = dirs_cam * (torch.scalar_tensor(1.0) / norm)
    dz = dirs_unit[..., 2]
    R = poses[:, None, :3, :3]
    dirs_world = dirs_unit.reshape(1, -1, 3) @ R[:, 0].transpose(-1, -2)
    b = poses.shape[0]
    h, w = dz.shape
    dirs_world = dirs_world.reshape(b, h, w, 3).permute(3, 0, 1, 2).contiguous()
    origin = poses[:, :3, 3].T.reshape(3, b, 1, 1)
    escape = torch.scalar_tensor(max_depth) / torch.clamp_max(dz, 1.0)

    def points(t):
        return (origin + dirs_world * t).permute(1, 2, 3, 0)

    t = torch.full((b, h, w), 0.05, dtype=torch.float32, device=dev)
    done = torch.zeros((b, h, w), dtype=torch.bool, device=dev)
    for _ in range(num_steps):
        d = scene(points(t))
        done = done | (d < hit_threshold) | (t > escape)
        t = torch.where(done, t, t + torch.clamp_min(d * 0.9, hit_threshold * 0.5))
    converged = (scene(points(t)) < 10 * hit_threshold) & (t * dz <= max_depth)
    return torch.where(converged, t * dz, 0.0)


# ----------------------------------------------------- sensor and files


def to_millimetres(depth_m: np.ndarray) -> np.ndarray:
    return np.clip(np.round(np.asarray(depth_m) * 1000.0), 0, 65535).astype(np.uint16)


def from_millimetres(mm: np.ndarray) -> np.ndarray:
    """What a reader of the PNGs gets: float32 metres."""
    return mm.astype(np.float32) / 1000.0


def encode_png_u16(mm: np.ndarray) -> bytes:
    """16-bit grayscale PNG, every row filter 0, zlib level 6."""
    h, w = mm.shape
    rows = np.zeros((h, 1 + 2 * w), np.uint8)
    rows[:, 1:] = np.ascontiguousarray(mm, ">u2").view(np.uint8).reshape(h, 2 * w)

    def chunk(ctype: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + ctype + data + struct.pack(">I", zlib.crc32(ctype + data))

    sig = b"\x89PNG\r\n\x1a\n"
    ihdr = struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 0)
    return sig + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b"")


def write_dataset(root: Path, mm: np.ndarray, poses: np.ndarray, intr: Intrinsics) -> None:
    """``mm (T, H, W)`` uint16 frames, ``poses (T, 4, 4)`` ground truth, in the dataset layout."""
    (root / "depth").mkdir(parents=True, exist_ok=True)
    for k in range(mm.shape[0]):
        (root / "depth" / f"{k:06d}.png").write_bytes(encode_png_u16(mm[k]))
    (root / "intrinsics.json").write_text(json.dumps(intr._asdict(), indent=2))
    files.write_log(root / "gt.log", poses)


def orbit_frames(params: dict, intr: Intrinsics, seed: int, device) -> tuple[np.ndarray, np.ndarray]:
    """``(mm (T, H, W) uint16, poses (T, 4, 4))`` of the orbit the traffic file describes.

    The start angle is drawn from ``seed``; the 1% multiplicative noise takes
    numpy draws from ``seed`` chunk by chunk, as the port's dataset generator
    does. Every seed renders the same number of frames at the same motion a
    frame, so the work is the same; only the part of the room differs. With
    ``stride`` (default 1) only every ``stride``-th frame of the orbit is rendered.
    """
    rng = np.random.default_rng([seed, 0])
    start = float(rng.uniform(0.0, 2.0 * np.pi))
    n = params["frames"]
    poses = orbit(n, radius=params["radius"], height=params["height"],
                  sweep=2.0 * np.pi * n / params["frames_per_orbit"], start_angle=start)
    poses = np.ascontiguousarray(poses[:: params.get("stride", 1)])
    scene = livingroom_scene()
    noise_rng = np.random.default_rng([seed, 1])
    out = []
    chunk = params["render_batch"]
    for s in range(0, poses.shape[0], chunk):
        depth = render_batch(scene, torch.from_numpy(poses[s : s + chunk]).to(device), intr).cpu().numpy()
        noise = noise_rng.normal(0, params["depth_noise"], size=depth.shape).astype(np.float32)
        depth = np.where(depth > 0, np.maximum(depth + noise * depth, 0.05), 0.0)
        out.append(to_millimetres(depth))
    return np.concatenate(out), poses
