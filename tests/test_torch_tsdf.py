"""PyTorch port, camera + TSDF + raycast vs the JAX package on the CPU.

Depth maps are rendered by the JAX package from the livingroom scene at poses
drawn from a numpy seed (120 x 90 pixels, a 96^3 volume of 5 cm voxels: the
small configuration of ``tests/test_odometry.py``). The JAX functions run
jitted with the intrinsics static and, where the production path has them so,
the volume's scalars as constants (``build_fragment`` makes its volume inside
its jit), so XLA computes the forms the port mirrors: division by a constant
as a multiply by its float32 reciprocal, multiply-adds fused (``core/types.py``).

Tolerances, each stated beside its assertion:

- camera functions: within 1e-5 (pixel indices equal);
- ``fuse``: weights equal on all but 1e-4 of the voxels (a voxel center that
  projects within an ulp of a pixel edge picks either pixel: the reference's
  3x3 product is Eigen's, whose rounding the port does not reproduce); tsdf
  within 1e-5 wherever the weights agree; at the identity pose (frame 0 of
  every fragment) weights equal exactly;
- ``fuse_scatter``: the same bounds; and on the port alone, its hit voxels
  carry exactly the gather ``fuse``'s values (max of duplicates == mean);
- samplers: values within 1e-5, validity equal on all but 1e-4 of the points;
- ``raycast``: ``valid`` equal on all but 1e-3 of the pixels, vertices within
  1e-4 m and normals within 1e-3 where both are valid;
- ``extract_surface_points``: the same row count and mask, points within 1e-5 m,
  normals within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticreconstruction_tpu.core import camera as j_cam
from elasticreconstruction_tpu.core import se3 as j_se3
from elasticreconstruction_tpu.kernels import raycast as j_rc
from elasticreconstruction_tpu.kernels import tsdf as j_tsdf
from elasticreconstruction_tpu.synthetic import render as j_render
from elasticreconstruction_tpu.synthetic import scenes as j_scenes
from elasticreconstruction_tpu_torch import interop
from elasticreconstruction_tpu_torch.core import camera as t_cam
from elasticreconstruction_tpu_torch.kernels import raycast as t_rc
from elasticreconstruction_tpu_torch.kernels import tsdf as t_tsdf

INTR = j_cam.Intrinsics(fx=100.0, fy=100.0, cx=59.5, cy=44.5, width=120, height=90)
T_INTR = interop.intrinsics_from(INTR)
SHAPE, VOXEL, ORIGIN = (96, 96, 96), 0.05, (-2.4, -2.4, 0.2)
FUSE_KW = dict(max_weight=64.0, depth_min=0.1, depth_max=5.0)


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


def _jax_volume_fn(fn):
    """``fn(vol, *args)`` jitted on a volume made inside the jit (constant scalars)."""
    return jax.jit(lambda tsdf, weight, *args: fn(
        j_tsdf.make_volume(SHAPE, VOXEL, ORIGIN)._replace(tsdf=tsdf, weight=weight), *args))


@pytest.fixture(scope="module")
def frames():
    """Two depth maps of the livingroom and their poses: a seeded small motion apart."""
    rng = np.random.default_rng(4)
    scene = j_scenes.livingroom_scene()
    T0 = j_scenes.look_at_pose((0.5, 1.3, 0.0), (3.0, 1.0, 0.5)).astype(np.float32)
    xi = np.concatenate([rng.uniform(-0.03, 0.03, 3), rng.uniform(-0.03, 0.03, 3)]).astype(np.float32)
    T1 = np.array(j_se3.exp(jnp.asarray(xi))) @ T0
    poses = np.stack([T0, T1]).astype(np.float32)
    depths = np.array(j_render.render_sequence(scene, jnp.asarray(poses), INTR, max_depth=6.0))
    # The fragment frame: camera 0 at the identity.
    local = np.linalg.inv(poses[0]) @ poses
    return depths, local.astype(np.float32)


@pytest.fixture(scope="module")
def fused(frames):
    """Both frames fused by both packages into a fresh volume."""
    depths, poses = frames
    jfuse = jax.jit(lambda tsdf, weight, d, T: j_tsdf.fuse(
        j_tsdf.make_volume(SHAPE, VOXEL, ORIGIN)._replace(tsdf=tsdf, weight=weight), d, T, INTR, **FUSE_KW))
    jv = j_tsdf.make_volume(SHAPE, VOXEL, ORIGIN)
    tv = t_tsdf.make_volume(SHAPE, VOXEL, ORIGIN, device="cpu")
    steps = []
    for d, T in zip(depths, poses):
        jv = jfuse(jv.tsdf, jv.weight, jnp.asarray(d), jnp.asarray(T))
        tv = t_tsdf.fuse(tv, _t(d), _t(T), T_INTR, **FUSE_KW)
        steps.append((jv, tv))
    return steps


def _volume_agreement(jv, tv):
    jw, tw = np.array(jv.weight), tv.weight.numpy()
    same = jw == tw
    dt = np.abs(np.array(jv.tsdf) - tv.tsdf.numpy())[same]
    return 1.0 - same.mean(), dt.max()


def test_camera_functions_match_jax(frames):
    depths, _ = frames
    rng = np.random.default_rng(0)
    d = depths[0]
    pts = rng.uniform([-1, -1, 0.5], [1, 1, 4], (5000, 3)).astype(np.float32)
    uv = rng.uniform(-2, 125, (3000, 2)).astype(np.float32)
    img3 = rng.normal(size=(90, 120, 3)).astype(np.float32)
    want = jax.jit(lambda d, p, uv, img: (
        j_cam.pixel_grid(INTR), j_cam.unproject(d, INTR), *j_cam.project(p, INTR),
        j_cam.bilinear_sample(d, uv), j_cam.bilinear_sample(img, uv), j_cam.nearest_sample(d, uv),
        j_cam.depth_to_normals(d, INTR)))(d, pts, uv, img3)
    got = (t_cam.pixel_grid(T_INTR, device="cpu"), t_cam.unproject(_t(d), T_INTR), *t_cam.project(_t(pts), T_INTR),
           t_cam.bilinear_sample(_t(d), _t(uv)), t_cam.bilinear_sample(_t(img3), _t(uv)),
           t_cam.nearest_sample(_t(d), _t(uv)), t_cam.depth_to_normals(_t(d), T_INTR))
    for w, g in zip(want, got):
        w = np.array(w)
        assert g.shape == w.shape
        if w.dtype == bool:
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, atol=1e-5)  # tolerance: 1e-5
    # Pixel indices picked by the projection are equal.
    (u, v), _ = t_cam.project_uv(*_t(pts).unbind(-1), T_INTR)
    pix = t_cam.pixel_index(u, v, T_INTR).numpy()
    juv = np.array(want[2])
    ju = np.clip(np.round(juv[:, 0]), 0, 119).astype(np.int64)
    jv_ = np.clip(np.round(juv[:, 1]), 0, 89).astype(np.int64)
    np.testing.assert_array_equal(pix, jv_ * 120 + ju)
    for f in (0.5, 0.25, 2.0):
        assert tuple(T_INTR.scaled(f)) == tuple(INTR.scaled(f))
    assert tuple(t_cam.PRIMESENSE) == tuple(j_cam.PRIMESENSE)


@pytest.mark.parametrize("step", [0, 1], ids=["identity_pose", "moved_pose"])
def test_fuse_matches_jax(fused, step):
    jv, tv = fused[step]
    mismatch, dt = _volume_agreement(jv, tv)
    limit = 0.0 if step == 0 else 1e-4  # tolerance: weights exact at the identity, else 1e-4 of voxels
    assert mismatch <= limit, mismatch
    assert dt <= 1e-5, dt  # tolerance: tsdf within 1e-5 where weights agree
    assert float(tv.weight.max()) == step + 1 and (tv.weight > 0).float().mean() > 0.05
    cen = t_tsdf.voxel_centers(tv).numpy()
    np.testing.assert_array_equal(cen, np.array(jax.jit(
        lambda: j_tsdf.voxel_centers(j_tsdf.make_volume(SHAPE, VOXEL, ORIGIN)))()))


def test_fuse_at_camera_points_matches_jax_and_fuse(frames, fused):
    """Given the same camera-frame voxel centers both packages fuse the same
    volume (weights equal, tsdf within 1e-5); the port's rigid warp of the
    centers reproduces its own ``fuse`` to the bit."""
    depths, poses = frames
    jv0, tv0 = fused[0]
    p_cam = t_tsdf.rigid_world_to_cam(_t(poses[1]))(t_tsdf.voxel_centers(tv0))
    got = t_tsdf.fuse_at_camera_points(tv0, _t(depths[1]), p_cam, T_INTR, **FUSE_KW)
    want = _jax_volume_fn(lambda vol, d, p: j_tsdf.fuse_at_camera_points(vol, d, p, INTR, **FUSE_KW))(
        jv0.tsdf, jv0.weight, jnp.asarray(depths[1]), jnp.asarray(p_cam.numpy()))
    mismatch, dt = _volume_agreement(want, got)
    assert mismatch == 0.0 and dt <= 1e-5, (mismatch, dt)  # tolerance: weights equal, tsdf 1e-5
    ref = t_tsdf.fuse(tv0, _t(depths[1]), _t(poses[1]), T_INTR, **FUSE_KW)
    assert torch.equal(got.tsdf, ref.tsdf) and torch.equal(got.weight, ref.weight)


def test_fuse_caps_weight_and_keeps_volume_fields():
    vol = t_tsdf.make_volume((8, 8, 8), 0.1, (-0.35, -0.35, 0.5), device="cpu")
    assert vol.truncation == np.float32(0.4) and vol.voxel_size == np.float32(0.1)
    d = torch.full((90, 120), 0.8)
    v1 = t_tsdf.fuse(vol, d, torch.eye(4), T_INTR)
    v2 = t_tsdf.fuse(v1, d, torch.eye(4), T_INTR, max_weight=1.5)
    assert float(v1.weight.max()) == 1.0 and float(v2.weight.max()) == 1.5
    assert v2.origin == vol.origin and v2.shape == (8, 8, 8)


def test_fuse_scatter_matches_jax_and_gather(frames, fused):
    depths, poses = frames
    jfs = _jax_volume_fn(lambda vol, d, T: j_tsdf.fuse_scatter(vol, d, T, INTR, **FUSE_KW))
    jv0, tv0 = fused[0]
    jv = jfs(jv0.tsdf, jv0.weight, jnp.asarray(depths[1]), jnp.asarray(poses[1]))
    tv = t_tsdf.fuse_scatter(tv0, _t(depths[1]), _t(poses[1]), T_INTR, **FUSE_KW)
    mismatch, dt = _volume_agreement(jv, tv)
    assert mismatch <= 1e-4 and dt <= 1e-5, (mismatch, dt)  # tolerance: as fuse
    # On a fresh volume every voxel the scatter hits holds the gather's value.
    fresh = t_tsdf.make_volume(SHAPE, VOXEL, ORIGIN, device="cpu")
    sc = t_tsdf.fuse_scatter(fresh, _t(depths[1]), _t(poses[1]), T_INTR, **FUSE_KW)
    ga = t_tsdf.fuse(fresh, _t(depths[1]), _t(poses[1]), T_INTR, **FUSE_KW)
    hit = sc.weight > 0
    assert hit.sum() > 1000
    assert torch.equal(sc.tsdf[hit], ga.tsdf[hit]) and bool((ga.weight[hit] == 1).all())


@pytest.fixture(scope="module")
def sampled(fused):
    """Samplers of both packages on one volume at seeded points in and around it."""
    jv, _ = fused[1]
    tv = interop.volume_from_numpy(np.array(jv.tsdf), np.array(jv.weight), np.array(jv.origin),
                                   float(jv.voxel_size), float(jv.truncation), "cpu")
    rng = np.random.default_rng(2)
    pts = rng.uniform(-2.6, 2.6, (20000, 3)).astype(np.float32)
    pts[:, 2] += 2.8
    # Half the points near observed voxels, where the values are not the sentinel.
    obs = np.argwhere(np.array(jv.weight) > 0)[rng.integers(0, int((np.array(jv.weight) > 0).sum()), 10000)]
    pts[:10000] = (np.array(ORIGIN) + obs * VOXEL + rng.uniform(-0.5, 0.5, (10000, 3)) * VOXEL).astype(np.float32)

    def j_all(tsdf, weight, p):
        vol = j_tsdf.make_volume(SHAPE, VOXEL, ORIGIN)._replace(tsdf=tsdf, weight=weight)
        sval = j_tsdf.make_sampling_volume(vol)
        return (*j_tsdf.sample_values(sval, vol.origin, vol.voxel_size, p),
                *j_tsdf.sample_nearest(sval, vol.origin, vol.voxel_size, p),
                j_tsdf.sample_gradient(vol, p), *j_tsdf.sample_trilinear(vol, p))

    want = [np.array(x) for x in jax.jit(j_all)(jv.tsdf, jv.weight, jnp.asarray(pts))]
    sval = t_tsdf.make_sampling_volume(tv)
    p = _t(pts)
    got = [*t_tsdf.sample_values(sval, tv.origin, tv.voxel_size, p),
           *t_tsdf.sample_nearest(sval, tv.origin, tv.voxel_size, p),
           t_tsdf.sample_gradient(tv, p), *t_tsdf.sample_trilinear(tv, p)]
    return want, [g.numpy() for g in got]


@pytest.mark.parametrize("which", ["sample_values", "sample_nearest", "sample_trilinear"])
def test_samplers_match_jax(sampled, which):
    want, got = sampled
    k = {"sample_values": 0, "sample_nearest": 2, "sample_trilinear": 5}[which]
    (wv, wok), (gv, gok) = want[k : k + 2], got[k : k + 2]
    assert (wok != gok).mean() <= 1e-4  # tolerance: validity on all but 1e-4 of the points
    both = wok & gok
    assert both.sum() > 5000
    np.testing.assert_allclose(gv[both], wv[both], atol=1e-5)  # tolerance: 1e-5


def test_sample_gradient_matches_jax(sampled):
    want, got = sampled
    np.testing.assert_allclose(got[4], want[4], atol=1e-4)  # tolerance: unit normals within 1e-4


def test_raycast_matches_jax(fused, frames):
    _, poses = frames
    jv, _ = fused[1]
    tv = interop.volume_from_numpy(np.array(jv.tsdf), np.array(jv.weight), np.array(jv.origin),
                                   float(jv.voxel_size), float(jv.truncation), "cpu")
    jray = _jax_volume_fn(lambda vol, T: j_rc.raycast(vol, T, INTR, depth_max=5.0, num_steps=160))
    for T in (poses[1], np.array(j_se3.exp(jnp.asarray([0.03, 0.0, -0.02, 0.0, 0.02, 0.01]))) @ poses[1]):
        want = jray(jv.tsdf, jv.weight, jnp.asarray(T))
        got = t_rc.raycast(tv, _t(T), T_INTR, depth_max=5.0, num_steps=160)
        wv, gv = np.array(want.valid), got.valid.numpy()
        assert (wv != gv).mean() <= 1e-3  # tolerance: valid on all but 1e-3 of the pixels
        assert gv.mean() > 0.8
        both = wv & gv
        np.testing.assert_allclose(got.vertices.numpy()[both], np.array(want.vertices)[both], atol=1e-4)
        np.testing.assert_allclose(got.normals.numpy()[both], np.array(want.normals)[both], atol=1e-3)
        assert not got.vertices[~got.valid].any() and torch.isfinite(got.normals).all()


@pytest.mark.parametrize("capacity", [1500, 30000])
def test_extract_surface_points_matches_jax(fused, capacity):
    jv, _ = fused[1]
    tv = interop.volume_from_numpy(np.array(jv.tsdf), np.array(jv.weight), np.array(jv.origin),
                                   float(jv.voxel_size), float(jv.truncation), "cpu")
    want = j_tsdf.extract_surface_points(jv, capacity=capacity)
    got = t_tsdf.extract_surface_points(tv, capacity=capacity)
    np.testing.assert_array_equal(got.mask.numpy(), np.array(want.mask))
    assert 0 < int(got.mask.sum()) <= capacity
    np.testing.assert_allclose(got.points.numpy(), np.array(want.points), atol=1e-5)  # tolerance: 1e-5 m
    np.testing.assert_allclose(got.normals.numpy(), np.array(want.normals), atol=1e-4)  # tolerance: 1e-4
