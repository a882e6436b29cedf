"""PyTorch port, frame-to-model odometry vs the JAX package on the CPU.

The fixtures of ``tests/test_odometry.py`` (120 x 90 pixels, two pyramid
levels of 6 and 8 Gauss-Newton steps, 160 raycast steps, a 96^3 fragment
volume of 5 cm voxels), with depth maps rendered by the JAX package.

Tolerances, each stated beside its assertion:

- ``pyramid_down``: bit-equal;
- ``track_frame`` from one volume the JAX package fused: pose within 1e-4 m and
  1e-4 rad of the JAX pose, fitness within 1e-3, rmse within 1e-4 m;
- ``build_fragment`` on 8 frames: every local pose within 1e-3 of the JAX one
  (element-wise), and both within 2 cm / 0.02 rad of ground truth, the bound
  of ``tests/test_odometry.py``. The two builders see volumes that differ on
  a few voxels (the 3x3 products round differently), and one frame's pose
  moves by up to ~8e-4 with them: the JAX package's own fragment builder and
  a jitted track of the same first frame differ by as much (8.2e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticreconstruction_tpu.core import camera as j_cam
from elasticreconstruction_tpu.core import se3 as j_se3
from elasticreconstruction_tpu.kernels import tsdf as j_tsdf
from elasticreconstruction_tpu.odometry import FragmentConfig as JFragmentConfig
from elasticreconstruction_tpu.odometry import OdometryConfig as JOdometryConfig
from elasticreconstruction_tpu.odometry import build_fragment as j_build_fragment
from elasticreconstruction_tpu.odometry import kinfu as j_kinfu
from elasticreconstruction_tpu.synthetic import render as j_render
from elasticreconstruction_tpu.synthetic import scenes as j_scenes
from elasticreconstruction_tpu_torch import interop
from elasticreconstruction_tpu_torch.bench_scene import pose_error
from elasticreconstruction_tpu_torch.core import se3 as t_se3
from elasticreconstruction_tpu_torch.odometry import FragmentConfig, OdometryConfig, build_fragment, kinfu
from elasticreconstruction_tpu_torch.synthetic import scenes as t_scenes

INTR = j_cam.Intrinsics(fx=100.0, fy=100.0, cx=59.5, cy=44.5, width=120, height=90)
T_INTR = interop.intrinsics_from(INTR)
SMALL_ODOM = JOdometryConfig(levels=2, iterations=(6, 8), raycast_steps=160, depth_max=5.0)
SMALL_FRAG = JFragmentConfig(volume_shape=(96, 96, 96), voxel_size=0.05, volume_min_z=0.2,
                             cloud_capacity=16384, depth_max=5.0, odometry=SMALL_ODOM)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once, and
    torch's thread pool spinning against the other workers' slows these small
    ops by two orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_cfg(cfg: JFragmentConfig) -> FragmentConfig:
    return FragmentConfig(**{**cfg._asdict(), "odometry": OdometryConfig(**cfg.odometry._asdict())})


def test_configs_match_jax():
    assert tuple(OdometryConfig()) == tuple(JOdometryConfig())
    assert OdometryConfig._fields == JOdometryConfig._fields
    assert FragmentConfig._fields == JFragmentConfig._fields
    assert tuple(FragmentConfig())[:-1] == tuple(JFragmentConfig())[:-1]


@pytest.mark.parametrize("shape", [(90, 120), (7, 11), (4, 4)])
def test_pyramid_down_bit_equal(shape):
    rng = np.random.default_rng(sum(shape))
    d = rng.uniform(0.3, 5.0, shape).astype(np.float32)
    d[rng.uniform(size=shape) < 0.3] = 0.0  # invalid samples, whole invalid blocks among them
    d[: shape[0] // 2, : shape[1] // 2] *= rng.uniform(size=(shape[0] // 2, shape[1] // 2)) > 0.6
    want = np.array(jax.jit(j_kinfu.pyramid_down)(jnp.asarray(d)))
    got = kinfu.pyramid_down(torch.from_numpy(d)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))  # tolerance: bit-equal


@pytest.fixture(scope="module")
def tracked():
    """One frame tracked against a volume fused from another, by both packages."""
    scene = j_scenes.livingroom_scene()
    T0 = jnp.array(j_scenes.look_at_pose((0.5, 1.3, 0.0), (3.0, 1.0, 0.5)), jnp.float32)
    rng = np.random.default_rng(7)
    xi = np.concatenate([rng.uniform(-0.025, 0.025, 3), rng.uniform(-0.02, 0.02, 3)]).astype(np.float32)
    T1 = j_se3.exp(jnp.asarray(xi)) @ T0
    d0 = j_render.render_depth(scene, T0, INTR)
    d1 = j_render.render_depth(scene, T1, INTR)
    vol = j_tsdf.fuse(j_tsdf.make_volume((128, 128, 128), 0.04, origin=(-2.0, 0.0, -2.2)), d0, T0, INTR,
                      depth_max=5.0)
    want = j_kinfu.track_frame(vol, d1, T0, INTR, SMALL_ODOM)
    tv = interop.volume_from_numpy(np.array(vol.tsdf), np.array(vol.weight), np.array(vol.origin),
                                   float(vol.voxel_size), float(vol.truncation), "cpu")
    got = kinfu.track_frame(tv, _t(d1), _t(T0), T_INTR, OdometryConfig(**SMALL_ODOM._asdict()))
    return want, got, np.array(T1)


def test_track_frame_matches_jax(tracked):
    want, got, T1 = tracked
    te, re = pose_error(got.pose.numpy(), np.array(want.pose))
    assert te < 1e-4 and re < 1e-4, (te, re)  # tolerance: 1e-4 m / 1e-4 rad
    assert abs(float(got.fitness) - float(want.fitness)) < 1e-3  # tolerance: 1e-3
    assert abs(float(got.rmse) - float(want.rmse)) < 1e-4  # tolerance: 1e-4 m
    assert abs(float(got.obs_ratio) - float(want.obs_ratio)) < 1e-3
    te, re = pose_error(got.pose.numpy(), T1)
    assert te < 1e-2 and re < 1e-2 and float(got.fitness) > 0.7  # test_odometry.py's bounds


def test_track_frame_freezes_without_support():
    """No valid depth: no support, so the pose stays at the seed and fitness is 0."""
    vol = interop.volume_from_numpy(np.zeros((16, 16, 16)), np.zeros((16, 16, 16)), (-0.4, -0.4, 0.2),
                                    0.05, 0.2, "cpu")
    seed = t_se3.exp(torch.tensor([0.01, 0.0, 0.02, 0.0, 0.01, 0.0]))
    res = kinfu.track_frame(vol, torch.zeros((90, 120)), seed, T_INTR, OdometryConfig(**SMALL_ODOM._asdict()))
    assert torch.equal(res.pose, seed) and float(res.fitness) == 0.0
    assert all(torch.isfinite(x).all() for x in res)


@pytest.fixture(scope="module")
def fragment():
    scene = j_scenes.livingroom_scene()
    n = 8
    gt = j_scenes.orbit_trajectory(n, radius=1.0, height=1.3, sweep=0.35, start_angle=0.7)
    depths = j_render.render_sequence(scene, jnp.array(gt), INTR, max_depth=6.0)
    want = j_build_fragment(depths, INTR, SMALL_FRAG)
    got = build_fragment(_t(depths), T_INTR, _port_cfg(SMALL_FRAG))
    return want, got, gt


def test_build_fragment_matches_jax(fragment):
    want, got, gt = fragment
    wp, gp = np.array(want.local_poses), got.local_poses.numpy()
    assert gp.shape == wp.shape == (8, 4, 4)
    np.testing.assert_allclose(gp, wp, atol=1e-3)  # tolerance: 1e-3
    np.testing.assert_array_equal(gp[0], np.eye(4))
    for k in range(8):
        rel = (np.linalg.inv(gt[0]) @ gt[k]).astype(np.float32)
        for poses in (wp, gp):
            te, re = pose_error(poses[k], rel)
            assert te < 0.02 and re < 0.02, (k, te, re)  # tolerance: test_odometry.py's 2 cm / 0.02 rad
    for field in ("fitness", "rmse", "obs_ratio", "final_velocity"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.array(getattr(want, field)), atol=1e-2)
    assert float(got.fitness[1:].min()) > 0.5


def test_build_fragment_cloud(fragment):
    want, got, gt = fragment
    n_want, n_got = int(np.array(want.cloud.mask).sum()), int(got.cloud.mask.sum())
    assert abs(n_got - n_want) <= 0.01 * n_want  # tolerance: counts within 1%
    pts = got.cloud.points.numpy()[got.cloud.mask.numpy()]
    assert len(pts) > 1000
    world = pts @ gt[0][:3, :3].T + gt[0][:3, 3]
    sd = t_scenes.livingroom_scene()(torch.from_numpy(world.astype(np.float32))).numpy()
    assert np.abs(sd).mean() < 0.03  # test_odometry.py's bound
    nrm = got.cloud.normals.numpy()[got.cloud.mask.numpy()]
    np.testing.assert_allclose(np.linalg.norm(nrm, axis=1), 1.0, atol=1e-4)


def test_build_fragment_carries_velocity(fragment):
    """A fragment seeded with the previous one's final velocity tracks its first frame from it."""
    want, got, gt = fragment
    assert got.final_velocity.shape == (6,) and torch.isfinite(got.final_velocity).all()
    assert float(got.final_velocity.abs().max()) > 1e-3  # the orbit moves every frame
