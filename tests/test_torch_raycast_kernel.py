"""The raycast's CUDA kernel against its plain version, and the routing between them.

On the card (tests marked ``card``, which skip without one): ``raycast`` on
CUDA tensors launches ``kernels/cuda/csrc/raycast.cu`` once a call, and its
``valid`` equals ``raycast_plain``'s on every pixel and its vertices and
normals equal them bit for bit, on

- a 512^3 volume of 7.8125 mm voxels placed as ``build_fragment`` places it,
  fused from four frames of the livingroom orbit, raycast at 640x480 with 295
  steps from a fused pose, from a pose moved off it, and at half the
  resolution (``raycast_scale=2``);
- small volumes that the rays leave, with unobserved voxels and pixels with
  no crossing: one fused from a single frame, one of random values.

Run them there without the JAX conftest:
``python -m pytest tests/test_torch_raycast_kernel.py --noconftest -p no:cacheprovider -m card``.

On the CPU: ``raycast`` runs the plain version and never builds a kernel.
"""

import math

import numpy as np
import pytest
import torch

from elasticreconstruction_tpu_torch.core import camera as cam
from elasticreconstruction_tpu_torch.core import se3
from elasticreconstruction_tpu_torch.kernels import raycast as rc
from elasticreconstruction_tpu_torch.kernels import tsdf
from elasticreconstruction_tpu_torch.kernels.cuda import build
from elasticreconstruction_tpu_torch.odometry.fragments import FragmentConfig, _volume_origin
from elasticreconstruction_tpu_torch.synthetic import render, scenes

FULL = FragmentConfig(volume_shape=(512, 512, 512), voxel_size=0.0078125, volume_min_z=0.3)
FUSE_KW = dict(max_weight=64.0, depth_min=0.1, depth_max=6.0)
FULL_STEPS = 295
SMALL_INTR = cam.Intrinsics(fx=100.0, fy=100.0, cx=59.5, cy=44.5, width=120, height=90)
NO_CARD = ("needs a CUDA card: run on the card with python -m pytest "
           "tests/test_torch_raycast_kernel.py --noconftest -m card")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    return torch.device("cuda")


def _orbit(n: int, intr, dev, start: float = 0.7):
    """``n`` consecutive frames of the livingroom orbit (2 pi over 2550 frames):
    depths and camera-to-fragment poses (frame 0 at the identity)."""
    world = scenes.orbit_trajectory(n, radius=1.1, height=1.3, sweep=2 * math.pi * n / 2550, start_angle=start)
    depths = render.render_sequence(scenes.livingroom_scene(), torch.from_numpy(world).to(dev), intr)
    local = np.linalg.inv(world[0].astype(np.float64)) @ world.astype(np.float64)
    return depths, torch.from_numpy(local.astype(np.float32)).to(dev)


def _fused(cfg: FragmentConfig, intr, frames: int, dev):
    depths, poses = _orbit(frames, intr, dev)
    vol = tsdf.make_volume(cfg.volume_shape, cfg.voxel_size, _volume_origin(cfg), device=dev)
    for d, T in zip(depths, poses):
        vol = tsdf.fuse(vol, d, T, intr, **FUSE_KW)
    return vol, poses


def _moved(pose: torch.Tensor) -> torch.Tensor:
    xi = torch.tensor([0.02, -0.01, 0.015, 0.01, -0.02, 0.005], device=pose.device)
    return se3.exp(xi) @ pose


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _check(vol, pose, intr, steps: int, min_valid: float, max_valid: float = 1.0) -> None:
    kw = dict(depth_min=0.1, depth_max=6.0, num_steps=steps)
    want = rc.raycast_plain(vol, pose, intr, **kw)
    before = build.launches["raycast"]
    got = rc.raycast(vol, pose, intr, **kw)
    torch.cuda.synchronize()
    assert build.launches["raycast"] == before + 1
    assert got.valid.shape == (intr.height, intr.width) and got.vertices.shape == (intr.height, intr.width, 3)
    assert torch.equal(got.valid, want.valid), f"{int((got.valid != want.valid).sum())} pixels differ in valid"
    for name in ("vertices", "normals"):
        g, w = getattr(got, name), getattr(want, name)
        differ = (_bits(g) != _bits(w)).any(-1)
        assert not differ.any(), f"{name}: {int(differ.sum())} pixels differ in their bits"
    share = got.valid.float().mean().item()
    assert min_valid <= share <= max_valid, f"valid share {share}"


@pytest.fixture(scope="module")
def livingroom_512():
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    return _fused(FULL, cam.PRIMESENSE, 4, torch.device("cuda"))


@pytest.mark.card
@pytest.mark.parametrize("case", ["fused_pose", "moved_pose", "raycast_scale_2"])
def test_kernel_bitwise_on_a_512_volume(card, livingroom_512, case):
    vol, poses = livingroom_512
    pose = _moved(poses[2]) if case == "moved_pose" else poses[3]
    intr = cam.PRIMESENSE.scaled(0.5) if case == "raycast_scale_2" else cam.PRIMESENSE
    _check(vol, pose, intr, FULL_STEPS, min_valid=0.5)


@pytest.mark.card
def test_kernel_bitwise_where_rays_leave_a_partly_observed_volume(card):
    # 32^3 of 5 cm voxels (1.6 m) fused from one frame: the rays leave it on
    # every side, the space behind the surface and beside the frustum is
    # unobserved (56% of the voxels), and most of the image finds no crossing
    # (27% does).
    cfg = FragmentConfig(volume_shape=(32, 32, 32), voxel_size=0.05, volume_min_z=0.3)
    vol, poses = _fused(cfg, SMALL_INTR, 1, card)
    assert 0.2 < (vol.weight == 0).float().mean().item() < 0.9
    for pose in (poses[0], _moved(poses[0])):
        _check(vol, pose, SMALL_INTR, 192, min_valid=0.1, max_valid=0.6)


@pytest.mark.card
def test_kernel_bitwise_on_random_values(card):
    # Random tsdf with a fifth of the voxels unobserved: crossings on almost
    # every ray, sentinel corners in the refinement, and a camera whose rays
    # start inside the volume and leave it.
    g = torch.Generator(device="cpu").manual_seed(5)
    shape = (40, 48, 56)
    t = (torch.rand(shape, generator=g) * 2 - 1).to(card)
    w = torch.where(torch.rand(shape, generator=g) < 0.2, 0.0, torch.rand(shape, generator=g) * 64).to(card)
    vol = tsdf.make_volume(shape, 0.05, (-1.0, -1.2, 0.1), device=card)._replace(tsdf=t, weight=w)
    pose = se3.identity(device=card)
    for p in (pose, _moved(pose)):
        _check(vol, p, SMALL_INTR, 96, min_valid=0.9)
    # A pose that tracking lost: every point NaN, every index cast from NaN.
    lost = pose.clone()
    lost[0, 3] = float("nan")
    _check(vol, lost, SMALL_INTR, 96, min_valid=0.0, max_valid=0.0)


def test_cpu_runs_the_plain_version_and_builds_nothing(monkeypatch):
    def refuse(*names):
        raise AssertionError(f"build.load{names} called for CPU tensors")

    monkeypatch.setattr(build, "load", refuse)
    cfg = FragmentConfig(volume_shape=(48, 48, 48), voxel_size=0.05, volume_min_z=0.3)
    torch.manual_seed(0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        vol, poses = _fused(cfg, SMALL_INTR, 2, torch.device("cpu"))
        before = build.launches["raycast"]
        for pose in (poses[1], _moved(poses[1])):
            got = rc.raycast(vol, pose, SMALL_INTR, num_steps=96)
            want = rc.raycast_plain(vol, pose, SMALL_INTR, num_steps=96)
            assert got.valid.any()
            for g, w in zip(got, want):
                assert torch.equal(g, w)
        assert build.launches["raycast"] == before
    finally:
        torch.set_num_threads(threads)
