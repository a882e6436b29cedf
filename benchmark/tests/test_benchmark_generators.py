"""The frozen input generators: the same seed gives the same inputs, and they are the port's generators' copies."""

import numpy as np
import torch

from benchmark.reference.geometry import Intrinsics
from benchmark.tests import toy
from benchmark.traffic import fragments, livingroom

INTR = Intrinsics(60.0, 60.0, 39.5, 29.5, 80, 60)
ORBIT = {"frames": 5, "radius": 1.1, "height": 1.3, "frames_per_orbit": 2550, "depth_noise": 0.01, "render_batch": 16}


def test_orbit_frames_repeat_for_a_seed_and_differ_between_seeds():
    a = livingroom.orbit_frames(ORBIT, INTR, toy.SEED, "cpu")
    b = livingroom.orbit_frames(ORBIT, INTR, toy.SEED, "cpu")
    c = livingroom.orbit_frames(ORBIT, INTR, toy.SEED + 1, "cpu")
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert a[0].shape == c[0].shape == (5, 60, 80) and a[0].dtype == np.uint16
    assert not np.array_equal(a[1], c[1])
    assert (a[0] > 0).mean() > 0.9  # a room seen from inside: nearly every pixel hits


def test_fragment_clouds_repeat_for_a_seed_and_cover_their_stride():
    params = dict(ORBIT, **toy.REGISTER["traffic"])
    cfg = dict(toy.REGISTER["config"])
    a = fragments.fragment_clouds(params, cfg, INTR, toy.SEED, "cpu")
    b = fragments.fragment_clouds(params, cfg, INTR, toy.SEED, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    pts, nrm, mask = a
    cap = cfg["fragment"]["cloud_capacity"]
    assert pts.shape == nrm.shape == (4, cap, 3) and mask.shape == (4, cap)
    assert 500 < mask.sum(1).min() and mask.sum(1).max() < cap  # a surface, and room left in the capacity
    assert not pts[~mask].any() and np.allclose(np.linalg.norm(nrm[mask], axis=-1), 1.0, atol=1e-4)
    c = fragments.fragment_clouds(params, cfg, INTR, toy.SEED + 1, "cpu")
    assert not np.array_equal(pts, c[0])
    # every fragment's cloud is in its own first camera's frame: in front of it, inside the volume
    z = pts[..., 2][mask]
    assert z.min() >= cfg["fragment"]["volume_min_z"] - 1e-6


def test_the_frozen_renderer_and_orbit_match_the_port():
    from elasticreconstruction_tpu_torch.core import camera
    from elasticreconstruction_tpu_torch.synthetic import render, scenes

    P = livingroom.orbit(3, radius=1.1, height=1.3, sweep=2 * np.pi * 3 / 2550, start_angle=2.0)
    assert np.array_equal(P, scenes.orbit_trajectory(3, radius=1.1, height=1.3, sweep=2 * np.pi * 3 / 2550,
                                                       start_angle=2.0))
    mine = livingroom.render_batch(livingroom.livingroom_scene(), torch.from_numpy(P), INTR)
    port = render.render_batch(scenes.livingroom_scene(), torch.from_numpy(P), camera.Intrinsics(*INTR), max_depth=6.0)
    assert torch.equal(mine, port)


def test_the_png_writer_writes_what_the_port_reads(tmp_path):
    from elasticreconstruction_tpu_torch.pipeline.dataset import Dataset

    mm, poses = livingroom.orbit_frames(ORBIT, INTR, toy.SEED, "cpu")
    livingroom.write_dataset(tmp_path, mm, poses, INTR)
    ds = Dataset(tmp_path)
    assert len(ds) == 5 and tuple(ds.intrinsics) == tuple(INTR)
    assert np.array_equal(ds.depth_chunk(0, 5), livingroom.from_millimetres(mm))
    assert np.allclose(ds.gt_poses, poses, atol=1e-7)
