"""PyTorch port: scene integration through a control lattice, and distorted
synthetic depth, vs the JAX package on the CPU.

- ``integrate_frames_slac`` / ``integrate_frames_slac_scatter``: the scene of
  ``tests/test_torch_integrate.py`` (a sphere seen from four viewpoints, a
  60 x 60 x 56 volume of 3 cm voxels), the frames split over two fragments,
  the second one moved, each with its own smooth lattice warp of up to
  ~2 cm. The port forms voxel centres with ``fma`` and warps with the
  reference's jitted ``deform`` to the bit; the rigid 3x3 products are
  Eigen's in the reference (ROADMAP.md, Queue 3). The bar
  ``tests/test_torch_integrate.py`` holds the rigid fuse to: after frame 0
  weights equal and tsdf within 1e-5; after all four, weights equal on all
  but 1e-4 of the voxels (a voxel centre within an ulp of a pixel edge picks
  either pixel; none differed when this was written) and tsdf within 1e-5
  where they agree.
- ``generate_synthetic(distortion=...)``: ``apply_depth`` is bit-equal to the
  reference's jitted form (``tests/test_torch_elastic.py``), so the distorted
  PNGs differ from the JAX package's only where the rendered depths do
  (``tests/test_torch_synthetic.py``'s bar: all but 0.1% of the pixels equal,
  every one within 1 mm, plus the field's 2%); one depth map through both
  packages' distortion writes the same PNG bytes. ``distortion.json`` is
  written and read back by both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticreconstruction_tpu.core import camera as j_cam
from elasticreconstruction_tpu.core import se3 as j_se3
from elasticreconstruction_tpu.elastic import lattice as j_lat
from elasticreconstruction_tpu.integrate import scene as j_scene
from elasticreconstruction_tpu.kernels import tsdf as j_tsdf
from elasticreconstruction_tpu.pipeline import dataset as j_dataset
from elasticreconstruction_tpu.synthetic import distortion as j_dist
from elasticreconstruction_tpu.synthetic import render as j_render
from elasticreconstruction_tpu.synthetic import sdf as j_sdf
from elasticreconstruction_tpu.synthetic import warps as j_warps
from elasticreconstruction_tpu_torch import interop
from elasticreconstruction_tpu_torch.integrate import scene as t_scene
from elasticreconstruction_tpu_torch.native import depth_png
from elasticreconstruction_tpu_torch.pipeline import dataset as t_dataset
from elasticreconstruction_tpu_torch.synthetic import distortion as t_dist

INTR = j_cam.Intrinsics(fx=80.0, fy=80.0, cx=39.5, cy=29.5, width=80, height=60)
T_INTR = interop.intrinsics_from(INTR)
VS, LO, WANT = 0.03, (-0.9, -0.9, 1.0), (60, 60, 56)
CFG = j_scene.SceneConfig(volume_shape=WANT, voxel_size=VS, origin=LO)
LAT = j_lat.Lattice(4, 2.0, (-1.0, -1.0, 0.8))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
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
    # Frames 0-1 in fragment 0 (at the identity), 2-3 in fragment 1 (moved).
    frag = np.stack([np.eye(4), np.eye(4)] + [np.array(j_se3.exp(jnp.array([0.03, 0.0, -0.02, 0.0, 0.02, 0.01])))] * 2)
    frag = frag.astype(np.float32)
    local = np.einsum("kij,kjl->kil", np.linalg.inv(frag), poses).astype(np.float32)
    warp = [j_warps.make_fragment_warp(7 + f, LAT, amplitude=0.01) for f in range(2)]
    disp = np.stack([warp[0], warp[0], warp[1], warp[1]]).astype(np.float32)
    return depths, frag, local, disp


@pytest.mark.parametrize("name", ["integrate_frames_slac", "integrate_frames_slac_scatter"])
def test_integrate_frames_slac_matches_jax(frames, name):
    depths, frag, local, disp = frames
    for count, max_weight_diff in ((1, 0), (4, 1e-4)):
        vol = j_tsdf.make_volume(WANT, VS, LO)
        want = getattr(j_scene, name)(vol, *(jnp.asarray(x[:count]) for x in (depths, frag, local, disp)), LAT,
                                      INTR, CFG)
        tcfg = interop.scene_config_from(CFG)
        got = getattr(t_scene, name)(t_scene.make_scene_volume(tcfg, device="cpu"),
                                     *(torch.from_numpy(x[:count]) for x in (depths, frag, local, disp)),
                                     interop.lattice_from(LAT), T_INTR, tcfg)
        ww, gw = np.asarray(want.weight), got.weight.numpy()
        agree = ww == gw
        assert (~agree).mean() <= max_weight_diff, (count, (~agree).mean())  # tolerance: 0 / 1e-4 of voxels
        assert ww.max() == count and (ww > 0).mean() > 0.02
        np.testing.assert_allclose(got.tsdf.numpy()[agree], np.asarray(want.tsdf)[agree], atol=1e-5)
    # The warp moved the surface: the rigid fuse of the same frames differs.
    rigid = t_scene.integrate_frames_scatter(t_scene.make_scene_volume(tcfg, device="cpu"), torch.from_numpy(depths),
                                             torch.from_numpy(np.einsum("kij,kjl->kil", frag, local)), T_INTR, tcfg)
    assert (rigid.weight != got.weight).float().mean() > 1e-3


def test_distorted_dataset_matches_jax(tmp_path):
    jd = j_dist.make_distortion(42, radial_a=0.015, depth_b=0.004, grid_sigma=0.006)
    intr = j_cam.Intrinsics(fx=50.0, fy=50.0, cx=29.5, cy=22.5, width=60, height=45)
    kw = dict(num_frames=6, scene="livingroom", trajectory="orbit", radius=1.1, sweep=0.3, seed=2, depth_noise=0.01)
    j_dataset.generate_synthetic(tmp_path / "jax", intr=intr, distortion=jd, **kw)
    t_dataset.generate_synthetic(tmp_path / "torch", intr=interop.intrinsics_from(intr),
                                 distortion=interop.distortion_from(jd), device="cpu", **kw)
    a = t_dataset.Dataset(tmp_path / "torch").depth_chunk(0, 6)
    b = j_dataset.Dataset(tmp_path / "jax").depth_chunk(0, 6)
    assert (a != b).mean() <= 1e-3 and np.abs(a - b).max() <= 1e-3 * 1.02 + 1e-6  # tolerance: 0.1% / 1 mm + 2%
    assert (tmp_path / "torch" / "distortion.json").read_text() == (tmp_path / "jax" / "distortion.json").read_text()
    td = t_dataset.Dataset(tmp_path / "torch")
    assert td.distortion.to_json() == jd.to_json()
    assert j_dataset.Dataset(tmp_path / "torch").distortion.to_json() == jd.to_json()
    # One rendered map through both packages' distortion: the same PNG bytes.
    want = np.asarray(jax.jit(lambda d: j_dist.apply_depth(jd, d, intr))(jnp.asarray(a[0])))
    got = t_dist.apply_depth(interop.distortion_from(jd), torch.from_numpy(a[0]), interop.intrinsics_from(intr))
    depth_png.write_depth(tmp_path / "j.png", want)
    depth_png.write_depth(tmp_path / "t.png", got.numpy())
    assert (tmp_path / "j.png").read_bytes() == (tmp_path / "t.png").read_bytes()
