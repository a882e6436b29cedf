"""The TSDF fuse's CUDA kernel against its plain version, and the routing between them.

On the card (tests marked ``card``, which skip without one): ``fuse`` on CUDA
tensors launches ``kernels/cuda/csrc/tsdf_fuse.cu`` once a frame and updates
the volume in place, and its tsdf and weight equal ``fuse_plain``'s bit for
bit (the plain version given a clone of the volume first), on

- a 512^3 volume of 7.8125 mm voxels placed as ``build_fragment`` places it,
  fused from four frames of the livingroom orbit, the fifth frame fused at
  its pose and at a pose moved off it;
- a random volume whose weights are zero on a fifth of the voxels and above
  ``max_weight`` on a third, with negative zeros among the weights;
- a pose that tracking lost (NaN): nothing observed, every weight clamped;
- an x-slab of a non-cubic volume (``x_offset``), which also equals the
  same planes of the whole volume fused by the kernel;

and ``build_fragment`` over 51 frames at 512^3 launches it 51 times, makes no
more host synchronisations than with the plain fuse, and gives the same
poses and cloud bit for bit.

Run them there without the JAX conftest:
``python -m pytest tests/test_torch_tsdf_fuse_kernel.py --noconftest -p no:cacheprovider -m card``.

On the CPU: ``fuse`` runs the plain version and never builds a kernel, and
every caller of ``fuse`` (``build_fragment``, ``integrate_frames``,
``fuse_sharded``) gives the same bits when ``fuse`` updates the volume in
place as it does on the card, so none of them reads a volume it has passed
to ``fuse``.
"""

import math
import warnings

import numpy as np
import pytest
import torch

from elasticreconstruction_tpu_torch.core import camera as cam
from elasticreconstruction_tpu_torch.core import se3
from elasticreconstruction_tpu_torch.dist import volume_sharding
from elasticreconstruction_tpu_torch.integrate import scene
from elasticreconstruction_tpu_torch.kernels import tsdf
from elasticreconstruction_tpu_torch.kernels.cuda import build
from elasticreconstruction_tpu_torch.odometry import fragments
from elasticreconstruction_tpu_torch.odometry.fragments import FragmentConfig, _volume_origin
from elasticreconstruction_tpu_torch.synthetic import render, scenes

FULL = FragmentConfig(volume_shape=(512, 512, 512), voxel_size=0.0078125, volume_min_z=0.3)
FUSE_KW = dict(max_weight=64.0, depth_min=0.1, depth_max=6.0)
SMALL_INTR = cam.Intrinsics(fx=100.0, fy=100.0, cx=59.5, cy=44.5, width=120, height=90)
NO_CARD = ("needs a CUDA card: run on the card with python -m pytest "
           "tests/test_torch_tsdf_fuse_kernel.py --noconftest -m card")


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


def _moved(pose: torch.Tensor) -> torch.Tensor:
    xi = torch.tensor([0.02, -0.01, 0.015, 0.01, -0.02, 0.005], device=pose.device)
    return se3.exp(xi) @ pose


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _clone(vol: tsdf.TSDFVolume) -> tsdf.TSDFVolume:
    return vol._replace(tsdf=vol.tsdf.clone(), weight=vol.weight.clone())


def _check(vol, depth, pose, intr, *, x_offset: int = 0, observed: tuple[float, float] = (0.0, 1.0)):
    """The kernel on a clone of ``vol`` against ``fuse_plain`` on ``vol``:
    in place, one launch, bit for bit. Returns the kernel's volume."""
    kw = dict(FUSE_KW, x_offset=x_offset)
    want = tsdf.fuse_plain(vol, depth, pose, intr, **kw)
    mine = _clone(vol)
    before = build.launches["tsdf_fuse"]
    got = tsdf.fuse(mine, depth, pose, intr, **kw)
    torch.cuda.synchronize()
    assert build.launches["tsdf_fuse"] == before + 1
    assert got.tsdf is mine.tsdf and got.weight is mine.weight  # in place
    for name in ("tsdf", "weight"):
        differ = _bits(getattr(got, name)) != _bits(getattr(want, name))
        assert not differ.any(), f"{name}: {int(differ.sum())} voxels differ in their bits"
    share = (want.weight != torch.clamp_max(vol.weight, FUSE_KW["max_weight"])).float().mean().item()
    print(f"\n{tuple(vol.shape)}, x_offset {x_offset}: {share:.6f} of the voxels observed")
    assert observed[0] <= share <= observed[1], f"share of voxels observed {share}"
    return got


@pytest.fixture(scope="module")
def livingroom_512():
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)
    dev = torch.device("cuda")
    depths, poses = _orbit(5, cam.PRIMESENSE, dev)
    vol = tsdf.make_volume(FULL.volume_shape, FULL.voxel_size, _volume_origin(FULL), device=dev)
    for d, T in zip(depths[:4], poses[:4]):
        vol = tsdf.fuse_plain(vol, d, T, cam.PRIMESENSE, **FUSE_KW)
    return vol, depths[4], poses[4]


def _random_volume(dev, shape=(40, 48, 56), seed: int = 7) -> tsdf.TSDFVolume:
    """Random tsdf; weights 0 on a fifth of the voxels (negative zero on a
    tenth of those), up to 100 elsewhere: above ``max_weight`` on a third."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    t = torch.rand(shape, generator=g) * 2 - 1
    r = torch.rand(shape, generator=g)
    w = torch.where(r < 0.2, torch.where(r < 0.02, -0.0, 0.0), torch.rand(shape, generator=g) * 100)
    vol = tsdf.make_volume(shape, 0.05, (-1.0, -1.2, 0.1), device=dev)
    return vol._replace(tsdf=t.to(dev), weight=w.to(dev))


@pytest.mark.card
@pytest.mark.parametrize("case", ["livingroom_fused_pose", "livingroom_moved_pose", "random_volume",
                                  "lost_pose", "x_slab"])
def test_kernel_bitwise(card, request, case):
    if case.startswith("livingroom"):
        vol, depth, pose = request.getfixturevalue("livingroom_512")
        pose = _moved(pose) if case == "livingroom_moved_pose" else pose
        _check(vol, depth, pose, cam.PRIMESENSE, observed=(0.02, 0.3))
        return
    depths, poses = _orbit(2, SMALL_INTR, card)
    if case == "random_volume":
        vol = _random_volume(card)
        assert (vol.weight > FUSE_KW["max_weight"]).float().mean().item() > 0.25
        for pose in (poses[1], _moved(poses[1])):
            _check(vol, depths[1], pose, SMALL_INTR, observed=(0.05, 0.9))
    elif case == "lost_pose":
        lost = poses[1].clone()
        lost[0, 3] = float("nan")
        got = _check(_random_volume(card), depths[1], lost, SMALL_INTR, observed=(0.0, 0.0))
        assert got.weight.max().item() == FUSE_KW["max_weight"]
    else:
        # A (24, 40, 56) volume of 5 cm voxels cut into x-slabs of 8 planes:
        # each slab fused with its x_offset equals the same planes of the
        # whole volume fused by the kernel.
        shape = (24, 40, 56)
        whole = tsdf.make_volume(shape, 0.05, (-0.6, -1.0, 0.2), device=card)
        for d, T in zip(depths, poses):
            whole = tsdf.fuse(whole, d, T, SMALL_INTR, **FUSE_KW)
        for x0 in range(0, shape[0], 8):
            slab = tsdf.make_volume((8, *shape[1:]), 0.05, (-0.6, -1.0, 0.2), device=card)
            slab = tsdf.fuse(slab, depths[0], poses[0], SMALL_INTR, **FUSE_KW, x_offset=x0)
            got = _check(slab, depths[1], poses[1], SMALL_INTR, x_offset=x0)
            for name in ("tsdf", "weight"):
                assert torch.equal(_bits(getattr(got, name)), _bits(getattr(whole, name)[x0:x0 + 8]))


def _host_syncs(fn):
    """``(host synchronisations one call of fn makes, its result)``."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught), out


def _fragment_tensors(fr: fragments.FragmentResult) -> list[torch.Tensor]:
    return [fr.cloud.points, fr.cloud.normals, fr.cloud.mask.float(), fr.local_poses, fr.fitness, fr.rmse,
            fr.obs_ratio, fr.final_velocity]


@pytest.mark.card
def test_build_fragment_launches_once_a_frame_and_never_synchronises(card, monkeypatch):
    depths, poses = _orbit(51, cam.PRIMESENSE, card)
    vol = tsdf.make_volume(FULL.volume_shape, FULL.voxel_size, _volume_origin(FULL), device=card)
    tsdf.fuse(vol, depths[0], poses[0], cam.PRIMESENSE, **FUSE_KW)  # warm: the library's handle
    torch.cuda.synchronize()
    syncs, _ = _host_syncs(lambda: tsdf.fuse(vol, depths[1], poses[1], cam.PRIMESENSE, **FUSE_KW))
    assert syncs == 0
    before = build.launches["tsdf_fuse"]
    syncs, got = _host_syncs(lambda: fragments.build_fragment(depths, cam.PRIMESENSE, FULL))
    assert build.launches["tsdf_fuse"] == before + 51
    monkeypatch.setattr(tsdf, "fuse", tsdf.fuse_plain)
    plain_syncs, want = _host_syncs(lambda: fragments.build_fragment(depths, cam.PRIMESENSE, FULL))
    assert build.launches["tsdf_fuse"] == before + 51
    assert syncs == plain_syncs, (syncs, plain_syncs)
    assert got.cloud.mask.sum().item() > 10000
    for g, w in zip(_fragment_tensors(got), _fragment_tensors(want)):
        assert torch.equal(_bits(g), _bits(w))


def test_cpu_runs_the_plain_version_and_builds_nothing(monkeypatch):
    def refuse(*names):
        raise AssertionError(f"build.load{names} called for CPU tensors")

    monkeypatch.setattr(build, "load", refuse)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        dev = torch.device("cpu")
        depths, poses = _orbit(2, SMALL_INTR, dev)
        before = build.launches["tsdf_fuse"]
        for x_offset, vol in ((0, _random_volume(dev)), (8, _random_volume(dev, (16, 48, 56)))):
            for pose in (poses[1], _moved(poses[1])):
                got = tsdf.fuse(vol, depths[1], pose, SMALL_INTR, **FUSE_KW, x_offset=x_offset)
                want = tsdf.fuse_plain(vol, depths[1], pose, SMALL_INTR, **FUSE_KW, x_offset=x_offset)
                assert (got.weight != vol.weight).any()  # observed voxels, and new tensors
                for g, w in zip(got, want):
                    assert torch.equal(g, w) if isinstance(g, torch.Tensor) else g == w
        assert build.launches["tsdf_fuse"] == before
    finally:
        torch.set_num_threads(threads)


def test_the_fuse_kernel_metric_reads_its_events_a_frame():
    from benchmark import harness

    reader = harness.load_reader("odometry.fuse_kernel_ms_per_frame")
    by_name = {"(anonymous namespace)::tsdf_fuse_kernel(float*, float*, float const*, float const*, "
               "(anonymous namespace)::Params)": 0.0102, "void at::native::vectorized_elementwise_kernel": 1.0}
    obs = {"odometry": {"frames": 51}, "device": {"device_s_by_name": by_name}}
    assert reader.read(obs) == pytest.approx(1e3 * 0.0102 / 51, rel=1e-12)
    # A program without the kernel (the plain fuse's elementwise launches alone) reads nothing.
    del by_name[next(iter(by_name))]
    assert reader.read(obs) is None
    assert reader.read({"device": {"device_s_by_name": {}}}) is None


def _fuse_in_place(vol, depth, pose, intr, **kw):
    """``fuse`` as the card runs it, on the CPU: ``fuse_plain``'s bits written
    into the volume passed in, which is returned."""
    new = tsdf.fuse_plain(vol, depth, pose, intr, **kw)
    vol.tsdf.copy_(new.tsdf)
    vol.weight.copy_(new.weight)
    return vol


@pytest.mark.parametrize("caller", ["build_fragment", "integrate_frames", "fuse_sharded"])
def test_callers_keep_no_volume_they_passed_to_fuse(monkeypatch, caller):
    dev = torch.device("cpu")
    depths, poses = _orbit(4, SMALL_INTR, dev)
    shape, voxel, origin = (24, 40, 56), 0.05, (-0.6, -1.0, 0.2)
    scfg = scene.SceneConfig(volume_shape=shape, voxel_size=voxel, origin=origin, max_weight=3.0)

    def run() -> list[torch.Tensor]:
        if caller == "build_fragment":
            cfg = FragmentConfig(volume_shape=(48, 48, 48), voxel_size=0.05, volume_min_z=0.3, max_weight=3.0)
            return _fragment_tensors(fragments.build_fragment(depths, SMALL_INTR, cfg))
        vol = scene.make_scene_volume(scfg, device=dev)
        if caller == "integrate_frames":
            vol = scene.integrate_frames(vol, depths, poses, SMALL_INTR, scfg)
            return [vol.tsdf, vol.weight]
        part = vol._replace(tsdf=vol.tsdf[8:16].clone(), weight=vol.weight[8:16].clone())
        slab = volume_sharding.VolumeSlab(part, 8)
        slab = volume_sharding.fuse_sharded(slab, depths, poses, SMALL_INTR, scfg)
        return [slab.vol.tsdf, slab.vol.weight]

    want = run()
    monkeypatch.setattr(tsdf, "fuse", _fuse_in_place)
    got = run()
    assert (want[1] > 0).any()
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))
