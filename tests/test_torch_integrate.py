"""PyTorch port: scene integration, marching tetrahedra and block tiling vs the JAX package.

The scene of ``tests/test_blocks.py``: a sphere seen from four viewpoints (the
first at the identity), 80 x 60 depth maps rendered by the JAX package, a
60 x 60 x 56 volume of 3 cm voxels. Tolerances, each beside its assertion:

- ``integrate_frames`` / ``integrate_frames_scatter``: after frame 0 (the
  identity pose) weights equal and tsdf within 1e-5; after all four, weights
  equal on all but 1e-4 of the voxels (a voxel center within an ulp of a pixel
  edge picks either pixel: the reference's 3x3 product is Eigen's) and tsdf
  within 1e-5 where they agree;
- ``extract_mesh`` on one JAX volume: masks equal, vertices within 1e-5
  voxel, triangles compared as vertex sets so that a reversed one (a
  near-zero normal-gradient product on the other side of 0) counts apart, at
  most 0.1% of them; ``weld_mesh`` vertex and face counts within 0.1%;
- ``integrate/blocks.py`` (a numpy copy): equal plans, culls and filters; the
  port's stitched 2x1x2 block mesh equals its one-block mesh as the
  reference's does (``tests/test_blocks.py``: the same triangle count, the
  triangles within 2e-4, the welded counts within 2), with the gather fuse
  and with the scatter fuse (``run_integrate``'s default).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticreconstruction_tpu.core import camera as j_cam
from elasticreconstruction_tpu.core import se3 as j_se3
from elasticreconstruction_tpu.integrate import blocks as j_blocks
from elasticreconstruction_tpu.integrate import mesh as j_mesh
from elasticreconstruction_tpu.integrate import scene as j_scene
from elasticreconstruction_tpu.kernels import tsdf as j_tsdf
from elasticreconstruction_tpu.synthetic import render as j_render
from elasticreconstruction_tpu.synthetic import sdf as j_sdf
from elasticreconstruction_tpu_torch import interop
from elasticreconstruction_tpu_torch.elastic.lattice import Lattice
from elasticreconstruction_tpu_torch.integrate import blocks as t_blocks
from elasticreconstruction_tpu_torch.integrate import mesh as t_mesh
from elasticreconstruction_tpu_torch.integrate import scene as t_scene
from elasticreconstruction_tpu_torch.kernels import tsdf as t_tsdf

INTR = j_cam.Intrinsics(fx=80.0, fy=80.0, cx=39.5, cy=29.5, width=80, height=60)
T_INTR = interop.intrinsics_from(INTR)
VS, LO, WANT = 0.03, np.array([-0.9, -0.9, 1.0]), (60, 60, 56)
CFG = j_scene.SceneConfig(volume_shape=WANT, voxel_size=VS, origin=tuple(LO))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once, and
    torch's thread pool spinning against the other workers' slows these small
    ops by two orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def frames():
    scene = j_sdf.sphere((0.0, 0.0, 1.8), 0.6)
    poses = np.stack([np.array(j_se3.exp(jnp.array([0.05 * k, -0.02 * k, 0.01 * k, 0.02 * k, 0.01 * k, 0.0])),
                               np.float32) for k in range(4)])
    depths = np.array(j_render.render_sequence(scene, jnp.asarray(poses), INTR, max_depth=4.0))
    return depths, poses


def _jax_volume(fn, depths, poses):
    vol = j_tsdf.make_volume(WANT, VS, tuple(LO))
    return fn(vol, jnp.asarray(depths), jnp.asarray(poses), INTR, CFG)


def _port_volume(fn, depths, poses, shape=WANT, origin=tuple(LO)):
    cfg = interop.scene_config_from(CFG)._replace(volume_shape=shape, origin=origin)
    vol = t_scene.make_scene_volume(cfg, device="cpu")
    return fn(vol, torch.from_numpy(depths), torch.from_numpy(poses), T_INTR, cfg)


@pytest.mark.parametrize("name", ["integrate_frames", "integrate_frames_scatter"])
def test_integrate_frames_matches_jax(frames, name):
    depths, poses = frames
    for count, max_weight_diff in ((1, 0), (4, 1e-4)):
        want = _jax_volume(getattr(j_scene, name), depths[:count], poses[:count])
        got = _port_volume(getattr(t_scene, name), depths[:count], poses[:count])
        ww, gw = np.asarray(want.weight), got.weight.numpy()
        agree = ww == gw
        assert (~agree).mean() <= max_weight_diff, (count, (~agree).mean())  # tolerance: 0 / 1e-4 of voxels
        assert ww.max() == count and (ww > 0).mean() > 0.02
        np.testing.assert_allclose(got.tsdf.numpy()[agree], np.asarray(want.tsdf)[agree], atol=1e-5)


def test_scene_helpers_match_jax():
    rng = np.random.default_rng(1)
    frag = rng.normal(0, 1, (3, 4, 4)).astype(np.float32)
    local = rng.normal(0, 1, (3, 5, 4, 4)).astype(np.float32)
    np.testing.assert_allclose(
        t_scene.compose_frame_poses(torch.from_numpy(frag), torch.from_numpy(local)).numpy(),
        np.asarray(j_scene.compose_frame_poses(jnp.asarray(frag), jnp.asarray(local))), rtol=1e-5, atol=1e-5)
    assert t_scene.SceneConfig() == interop.scene_config_from(j_scene.SceneConfig())
    vol = t_scene.make_scene_volume(t_scene.SceneConfig(volume_shape=(4, 5, 6)), device="cpu")
    assert vol.shape == (4, 5, 6) and vol.truncation == pytest.approx(4 * 0.012)
    # Through a lattice at rest, with the identity as fragment pose, the
    # lattice-corrected fuses give the rigid ones' weights.
    lat = Lattice(2, 4.0, (-2.0, -2.0, 0.0))
    vol = t_scene.make_scene_volume(t_scene.SceneConfig(volume_shape=(8, 8, 8), voxel_size=0.05,
                                                        origin=(-0.2, -0.2, 0.9)), device="cpu")
    depth = torch.full((1, 60, 80), 1.1)
    eye = torch.eye(4)[None]
    for slac_fn, rigid_fn in ((t_scene.integrate_frames_slac, t_scene.integrate_frames),
                              (t_scene.integrate_frames_slac_scatter, t_scene.integrate_frames_scatter)):
        a = slac_fn(vol, depth, eye, eye, torch.zeros(1, lat.num_vertices, 3), lat, T_INTR)
        b = rigid_fn(vol, depth, eye, T_INTR)
        assert torch.equal(a.weight, b.weight) and a.weight.sum() > 0


def _as_sets(tris):
    """Triangles as vertex sets: each triangle's vertices sorted lexicographically."""
    order = np.lexsort(tris.transpose(2, 0, 1)[::-1], axis=-1)
    return np.take_along_axis(tris, order[..., None], axis=-2)


@pytest.mark.parametrize("capacity", [4096, 128])
def test_extract_mesh_matches_jax(frames, capacity):
    depths, poses = frames
    jvol = _jax_volume(j_scene.integrate_frames, depths, poses)
    want, wmask = (np.asarray(x) for x in j_mesh.extract_mesh(jvol, capacity_per_slab=capacity))
    got, gmask = (x.numpy() for x in t_mesh.extract_mesh(interop.volume_from(jvol, "cpu"), capacity_per_slab=capacity))
    assert got.shape == want.shape == (WANT[2] - 1, capacity, 3, 3)
    np.testing.assert_array_equal(gmask, wmask)
    assert wmask.sum() > 1000 and (capacity > 1000 or wmask.all(1).any())
    g, w = got[gmask], want[wmask]
    np.testing.assert_allclose(_as_sets(g), _as_sets(w), atol=1e-5 * VS)  # tolerance: 1e-5 voxel
    flipped = np.abs(g - w).max((1, 2)) > 1e-5 * VS
    assert flipped.mean() <= 1e-3, flipped.sum()  # tolerance: 0.1% reversed
    assert (got[~gmask] == 0).all()
    vt, ft = t_mesh.weld_mesh(got, gmask)
    vj, fj = j_mesh.weld_mesh(want, wmask)
    assert abs(len(vt) - len(vj)) <= 1e-3 * len(vj) and abs(len(ft) - len(fj)) <= 1e-3 * len(fj)


def test_extract_mesh_of_an_unobserved_volume_is_empty():
    vol = t_tsdf.make_volume((16, 16, 16), 0.05, (0, 0, 0), device="cpu")
    tris, mask = t_mesh.extract_mesh(vol, capacity_per_slab=128)
    assert tris.shape == (15, 128, 3, 3) and not mask.any() and (tris == 0).all()


def test_extract_mesh_does_not_depend_on_its_slab_groups(frames, monkeypatch):
    depths, poses = frames
    vol = _port_volume(t_scene.integrate_frames, depths, poses)
    whole = t_mesh.extract_mesh(vol, capacity_per_slab=512)
    monkeypatch.setattr(t_mesh, "GROUP_BYTES", 7 * t_mesh.BYTES_PER_CANDIDATE * 12 * 59 * 59)
    grouped = t_mesh.extract_mesh(vol, capacity_per_slab=512)
    for a, b in zip(whole, grouped):
        assert torch.equal(a, b)


def test_blocks_match_jax():
    for want, max_shape, overlap in (((200, 64, 150), (96, 96, 96), 4), ((100, 80, 90), (128, 128, 128), 4),
                                     ((60, 60, 56), (40, 60, 40), 3)):
        jp = j_blocks.plan_blocks(want, max_shape, overlap=overlap)
        tp = t_blocks.plan_blocks(want, max_shape, overlap=overlap)
        assert tuple(tp) == tuple(jp)
    plan = t_blocks.plan_blocks((200, 64, 64), (96, 96, 96), overlap=4)
    f_lo = np.array([[0.0, 0, 0], [8.0, 0, 0], [4.0, 0.5, 0.5]])
    f_hi = np.array([[1.0, 1, 1], [9.0, 1, 1], [5.0, 2.0, 2.0]])
    rng = np.random.default_rng(2)
    tris = rng.uniform(0, 10, (500, 3, 3)).astype(np.float32)
    mask = rng.uniform(size=500) > 0.2
    lo = np.zeros(3)
    for blk in plan.blocks:
        np.testing.assert_array_equal(t_blocks.cull_frames(blk, plan, lo, 0.05, f_lo, f_hi, margin=0.1),
                                      j_blocks.cull_frames(blk, plan, lo, 0.05, f_lo, f_hi, margin=0.1))
        for got, want in zip(t_blocks.block_world_aabb(blk, plan, lo, 0.05),
                             j_blocks.block_world_aabb(blk, plan, lo, 0.05)):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(t_blocks.filter_owned_triangles(tris, mask, blk, plan, lo, 0.05),
                             j_blocks.filter_owned_triangles(tris, mask, blk, plan, lo, 0.05)):
            np.testing.assert_array_equal(got, want)


def _stitched(fn, depths, poses, overlap):
    plan = t_blocks.plan_blocks(WANT, (40, 60, 40), overlap=overlap)
    assert len(plan.blocks) == 4
    soup = []
    for blk in plan.blocks:
        vol = _port_volume(fn, depths, poses, shape=plan.tile_shape, origin=blk.world_origin(LO, VS))
        t, m = t_mesh.extract_mesh(vol, capacity_per_slab=4096)
        soup.append(t_blocks.filter_owned_triangles(t[m].numpy(), np.ones(int(m.sum()), bool),
                                                    blk, plan, LO, VS)[0])
    return np.concatenate(soup)


def _fingerprint(tr):
    f = np.round(tr.reshape(len(tr), -1), 4)
    return f[np.lexsort(f.T[::-1])]


@pytest.mark.parametrize("overlap", [3, 5])
def test_block_mesh_matches_one_block(frames, overlap):
    depths, poses = frames
    for fn in (t_scene.integrate_frames, t_scene.integrate_frames_scatter):
        t, m = t_mesh.extract_mesh(_port_volume(fn, depths, poses), capacity_per_slab=4096)
        ref = t[m].numpy()
        got = _stitched(fn, depths, poses, overlap)
        assert len(got) == len(ref)
        np.testing.assert_allclose(_fingerprint(got), _fingerprint(ref), atol=2e-4)
        v1, f1 = t_mesh.weld_mesh(ref, np.ones(len(ref), bool))
        v2, f2 = t_mesh.weld_mesh(got, np.ones(len(got), bool))
        assert abs(len(v1) - len(v2)) <= 2 and abs(len(f1) - len(f2)) <= 2
