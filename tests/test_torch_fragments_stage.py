"""PyTorch port, the ``fragments`` stage and the ``synth``/``fragments`` verbs vs the JAX package.

One dataset written by the JAX ``generate_synthetic`` (livingroom, orbit,
120 x 90 pixels, 17 frames with 5 mm depth noise) goes through the JAX
``run_fragments`` and the port's, at the small fragment configuration of
``tests/test_odometry.py`` with 8 frames per fragment (two fragments; the
second starts on the first one's last frame and takes over its velocity).
The artifacts, file by file:

- ``local_<f>.log``: the same (i, j, k) records, poses within 2e-3 and their
  errors against ground truth within 2 mm / 2 mrad of the JAX ones (the
  noisy frames move a pose by up to 1.1e-3 where ``tests/test_torch_odometry.py``
  sees 8e-4 on clean ones);
- ``fragments.log``: the chained bases within 2e-3 (two fragments' worth);
- ``health_<f>.json``: the same keys, ``suspect`` and ``frames_unhealthy``
  equal, ``min_fitness`` within 1e-2, ``max_rmse`` within 1e-3,
  ``min_obs_ratio`` within 1e-2;
- ``cloud_bin_<f>.pcd``: point counts within 1%, 98% of the port's points
  within 1 cm of a JAX point and the mean distance under 2 mm (the volumes
  differ on a few voxels at the edge of what was seen, where one package
  finds a crossing that the other does not); unit normals.

The CLI verbs write byte-identical files to the function calls they stand for.
"""

import filecmp
import json
import shutil

import numpy as np
import pytest
import torch

from elasticreconstruction_tpu.core import camera as j_cam
from elasticreconstruction_tpu.odometry import FragmentConfig as JFragmentConfig
from elasticreconstruction_tpu.odometry import OdometryConfig as JOdometryConfig
from elasticreconstruction_tpu.pipeline import dataset as j_dataset
from elasticreconstruction_tpu.pipeline import stages as j_stages
from elasticreconstruction_tpu.pipeline.config import PipelineConfig as JPipelineConfig
from elasticreconstruction_tpu_torch import interop
from elasticreconstruction_tpu_torch.bench_scene import pose_error
from elasticreconstruction_tpu_torch.core import io_logfmt as t_io
from elasticreconstruction_tpu_torch.pipeline import dataset as t_dataset
from elasticreconstruction_tpu_torch.pipeline import run as t_run
from elasticreconstruction_tpu_torch.pipeline import stages as t_stages

INTR = j_cam.Intrinsics(fx=100.0, fy=100.0, cx=59.5, cy=44.5, width=120, height=90)
K = 8
NUM_FRAMES = 2 * K + 1


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once, and
    torch's thread pool spinning against the other workers' slows these small
    ops by two orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jcfg(out) -> JPipelineConfig:
    odom = JOdometryConfig(levels=2, iterations=(6, 8), raycast_steps=160, depth_max=5.0)
    frag = JFragmentConfig(frames_per_fragment=K, volume_shape=(96, 96, 96), voxel_size=0.05,
                           volume_min_z=0.2, cloud_capacity=16384, depth_max=5.0, odometry=odom)
    return JPipelineConfig(out_dir=str(out), frames_per_fragment=K, fragment=frag)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("fragments")
    j_dataset.generate_synthetic(root / "data", num_frames=NUM_FRAMES, intr=INTR, scene="livingroom",
                                 trajectory="orbit", radius=1.0, sweep=0.7, start_angle=0.7, seed=0,
                                 depth_noise=0.005)
    j_stages.run_fragments(j_dataset.Dataset(root / "data"), _jcfg(root / "jax"))
    t_stages.run_fragments(t_dataset.Dataset(root / "data"), interop.pipeline_config_from(_jcfg(root / "torch")),
                           device="cpu")
    return root


def test_local_logs_match_jax(runs):
    gt = t_io.read_log(runs / "data" / "gt.log").matrices()
    for f in range(2):
        want = t_io.read_log(runs / "jax" / "fragments" / f"local_{f}.log")
        got = t_io.read_log(runs / "torch" / "fragments" / f"local_{f}.log")
        assert [(e.i, e.j, e.k) for e in got.entries] == [(e.i, e.j, e.k) for e in want.entries]
        assert len(got.entries) == K + 1
        np.testing.assert_allclose(got.matrices(), want.matrices(), atol=2e-3)  # tolerance: 2e-3
        for k, (T, W) in enumerate(zip(got.matrices(), want.matrices())):
            truth = np.linalg.inv(gt[f * K]) @ gt[f * K + k]
            te, re = pose_error(T, truth)
            wte, wre = pose_error(W, truth)
            assert abs(te - wte) < 2e-3 and abs(re - wre) < 2e-3 and te < 0.03, (f, k, te, wte)


def test_fragments_log_matches_jax(runs):
    want = t_io.read_log(runs / "jax" / "fragments" / "fragments.log").matrices()
    got = t_io.read_log(runs / "torch" / "fragments" / "fragments.log").matrices()
    assert got.shape == want.shape == (2, 4, 4)
    np.testing.assert_array_equal(got[0], np.eye(4))
    np.testing.assert_allclose(got, want, atol=2e-3)  # tolerance: 2e-3


@pytest.mark.parametrize("f", [0, 1])
def test_health_matches_jax(runs, f):
    want = json.loads((runs / "jax" / "fragments" / f"health_{f}.json").read_text())
    got = json.loads((runs / "torch" / "fragments" / f"health_{f}.json").read_text())
    assert list(got) == list(want)
    assert got["fragment"] == f and got["suspect"] == want["suspect"]
    assert got["frames_unhealthy"] == want["frames_unhealthy"]
    assert abs(got["min_fitness"] - want["min_fitness"]) < 1e-2  # tolerance: 1e-2
    assert abs(got["max_rmse"] - want["max_rmse"]) < 1e-3  # tolerance: 1e-3 m
    assert abs(got["min_obs_ratio"] - want["min_obs_ratio"]) < 1e-2  # tolerance: 1e-2


@pytest.mark.parametrize("f", [0, 1])
def test_clouds_match_jax(runs, f):
    want, _ = t_io.read_pcd(runs / "jax" / "fragments" / f"cloud_bin_{f}.pcd")
    got, nrm = t_io.read_pcd(runs / "torch" / "fragments" / f"cloud_bin_{f}.pcd")
    assert abs(len(got) - len(want)) <= 0.01 * len(want) and len(got) > 1000  # tolerance: 1%
    d2 = ((got[:, None, :] - want[None, :, :]) ** 2).sum(-1).min(1)
    dist = np.sqrt(d2)
    assert (dist < 0.01).mean() >= 0.98 and dist.mean() < 0.002, ((dist < 0.01).mean(), dist.mean())
    np.testing.assert_allclose(np.linalg.norm(nrm, axis=1), 1.0, atol=1e-4)
    # The files read back in both packages the same way.
    cfg = interop.pipeline_config_from(_jcfg(runs / "torch"))
    clouds = t_stages.load_fragment_clouds(cfg)
    assert len(clouds) == 2 and clouds[f].mask.sum() == len(got)


def test_short_dataset_is_padded(tmp_path, runs):
    """Fewer frames than one fragment: the fragment is padded with zero-depth
    frames, which are lost (their pose is the constant-velocity prediction,
    the trusted velocity frozen) and count as unhealthy."""
    data = tmp_path / "data"
    shutil.copytree(runs / "data", data)
    for k in range(6, NUM_FRAMES):
        (data / "depth" / f"{k:06d}.png").unlink()
    cfg = interop.pipeline_config_from(_jcfg(tmp_path / "out"))
    t_stages.run_fragments(t_dataset.Dataset(data), cfg, device="cpu")
    local = t_io.read_log(tmp_path / "out" / "fragments" / "local_0.log").matrices()
    assert local.shape == (K + 1, 4, 4)
    steps = np.linalg.inv(local[5:-1]) @ local[6:]
    np.testing.assert_allclose(steps, np.broadcast_to(steps[0], steps.shape), atol=1e-5)
    assert np.abs(steps[0] - np.eye(4)).max() > 1e-3
    health = json.loads((tmp_path / "out" / "fragments" / "health_0.json").read_text())
    assert health["min_fitness"] == 0.0 and health["suspect"] and health["frames_unhealthy"] == K + 1 - 6
    assert not (tmp_path / "out" / "fragments" / "cloud_bin_1.pcd").exists()


def test_cli_verbs_write_what_the_functions_write(tmp_path):
    argv = ["--device", "cpu", "--seed", "2"]
    synth = ["--num-frames", "5", "--size", "48x36", "--depth-noise", "0.01"]
    assert t_run.main(["synth", "--data", str(tmp_path / "cli"), *argv, *synth]) == 0
    t_dataset.generate_synthetic(tmp_path / "fn", num_frames=5, intr=t_run.synth_intrinsics("48x36"),
                                 depth_noise=0.01, seed=2, device="cpu")
    names = ["intrinsics.json", "gt.log"] + [f"depth/{k:06d}.png" for k in range(5)]
    match, mismatch, errors = filecmp.cmpfiles(tmp_path / "cli", tmp_path / "fn", names, shallow=False)
    assert sorted(match) == sorted(names), (mismatch, errors)
    intr = t_dataset.read_intrinsics(tmp_path / "cli" / "intrinsics.json")
    assert (intr.width, intr.height, intr.fx, intr.cx) == (48, 36, 60.0, 23.5)

    frag = ["--frames-per-fragment", "2", "--fragment-volume", "32", "--fragment-voxel", "0.1", "--preset", "fast"]
    assert t_run.main(["fragments", "--data", str(tmp_path / "cli"), "--out", str(tmp_path / "out_cli"),
                       *argv, *frag]) == 0
    cfg = t_run.config_from_args(t_run.build_parser().parse_args(
        ["fragments", "--out", str(tmp_path / "out_fn"), *argv, *frag]))
    assert cfg.fragment.volume_shape == (32, 32, 32) and cfg.fragment.voxel_size == 0.1
    t_stages.run_fragments(t_dataset.Dataset(tmp_path / "fn"), cfg, device="cpu")
    names = [f"fragments/{n}_{f}.{ext}" for f in range(2) for n, ext in
             (("cloud_bin", "pcd"), ("local", "log"), ("health", "json"))] + ["fragments/fragments.log"]
    match, mismatch, errors = filecmp.cmpfiles(tmp_path / "out_cli", tmp_path / "out_fn", names, shallow=False)
    assert sorted(match) == sorted(names), (mismatch, errors)
    # The CLI's default --slac-mode is the reference's, slac, and the port runs it.
    cfg = t_run.config_from_args(t_run.build_parser().parse_args(["all", "--out", str(tmp_path / "x"), *argv]))
    assert cfg.slac_mode == "slac" and cfg.slac_config().mode.value == "slac"
