"""PyTorch port: the ``optimize``, ``integrate`` and ``evaluate`` stages and the
``all`` verb vs the JAX package.

One dataset written by the JAX ``generate_synthetic`` (the one of
``tests/test_torch_fragments_stage.py``: livingroom, orbit, 120 x 90 pixels,
17 frames with 5 mm depth noise) goes through the JAX ``run_all`` with
``slac_mode="none"``, at the configuration the CLI builds for
``--preset fast --frames-per-fragment 8 --fragment-volume 96
--fragment-voxel 0.05`` (two fragments). Then:

- the port's ``run_optimize``, ``run_integrate`` and ``run_evaluate`` start
  from a copy of the JAX run's ``fragments``, ``registration`` and
  ``posegraph`` directories: ``pose_slac.log``, ``trajectory.log`` and
  ``gt.log`` byte-identical; ``mesh.ply`` face and vertex counts within
  0.5% and 99% of its vertices (every fifth) within 1 mm of a JAX vertex
  (none beyond 1 cm); ``ate.json`` within 1e-5 m; ``registration_pr.json`` equal;
- the ``optimize`` and ``integrate`` verbs on another copy write the same
  bytes as those function calls (``--spill-corres`` too);
- the port's ``all`` verb on the dataset writes every artifact, and its ATE
  is within max(2 mm, 10%) of the JAX run's;
- ``optimize`` and ``all`` refuse every other ``--slac-mode`` before any
  stage runs.
"""

import filecmp
import json
import shutil

import numpy as np
import pytest
import torch

from elasticreconstruction_tpu.core import camera as j_cam
from elasticreconstruction_tpu.pipeline import dataset as j_dataset
from elasticreconstruction_tpu.pipeline import run as j_run
from elasticreconstruction_tpu.pipeline import stages as j_stages
from elasticreconstruction_tpu_torch.core import io_logfmt as t_io
from elasticreconstruction_tpu_torch.pipeline import dataset as t_dataset
from elasticreconstruction_tpu_torch.pipeline import run as t_run
from elasticreconstruction_tpu_torch.pipeline import stages as t_stages

INTR = j_cam.Intrinsics(fx=100.0, fy=100.0, cx=59.5, cy=44.5, width=120, height=90)
FLAGS = ["--preset", "fast", "--frames-per-fragment", "8", "--fragment-volume", "96",
         "--fragment-voxel", "0.05", "--slac-mode", "none"]
UPSTREAM = ("fragments", "registration", "posegraph")
# What the evaluation adds to the registration directory.
EVALUATION = ("gt.log", "gt.info", "gt_benchmark_health.json", "registration_pr.json")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once, and
    torch's thread pool spinning against the other workers' slows these small
    ops by two orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _argv(verb, root, out):
    return [verb, "--data", str(root / "data"), "--out", str(root / out), *FLAGS]


def _copy_upstream(root, out):
    for name in UPSTREAM:
        shutil.copytree(root / "jax" / name, root / out / name,
                        ignore=shutil.ignore_patterns(*EVALUATION))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    j_dataset.generate_synthetic(root / "data", num_frames=17, intr=INTR, scene="livingroom",
                                 trajectory="orbit", radius=1.0, sweep=0.7, start_angle=0.7, seed=0,
                                 depth_noise=0.005)
    jcfg = j_run.config_from_args(j_run.build_parser().parse_args(_argv("all", root, "jax")))
    j_stages.run_all(j_dataset.Dataset(root / "data"), jcfg)
    _copy_upstream(root, "torch")
    cfg = t_run.config_from_args(t_run.build_parser().parse_args(_argv("optimize", root, "torch")))
    ds = t_dataset.Dataset(root / "data")
    stats = t_stages.run_optimize(cfg, spill_corres=True, device="cpu")
    t_stages.run_integrate(ds, cfg, device="cpu")
    t_stages.run_evaluate(ds, cfg, device="cpu")
    (root / "harvest.json").write_text(json.dumps(stats))
    return root


def _same(root, a, b, names):
    match, mismatch, errors = filecmp.cmpfiles(root / a, root / b, names, shallow=False)
    assert sorted(match) == sorted(names), (mismatch, errors)


def test_optimize_and_integrate_write_what_jax_writes(root):
    _same(root, "jax", "torch", ["slac/pose_slac.log", "integrate/trajectory.log", "registration/gt.log"])
    traj = t_io.read_log(root / "torch" / "integrate" / "trajectory.log")
    assert len(traj.entries) == 16
    count = json.loads((root / "harvest.json").read_text())["correspondences"]
    pq = np.loadtxt(root / "torch" / "corres" / "corres_0_1.txt")
    assert pq.shape == (count, 6) and count > 500


def _nearest_distance(a, b):
    """Distance from each row of ``a`` to the nearest row of ``b``, exact in float64."""
    a, b = torch.from_numpy(a).double(), torch.from_numpy(b).double()
    return torch.cat([torch.cdist(a[s : s + 512], b, compute_mode="donot_use_mm_for_euclid_dist").amin(1)
                      for s in range(0, len(a), 512)]).numpy()


def test_mesh_matches_jax(root):
    wv, wf = t_io.read_ply_mesh(root / "jax" / "integrate" / "mesh.ply")
    gv, gf = t_io.read_ply_mesh(root / "torch" / "integrate" / "mesh.ply")
    assert len(wf) > 3000
    assert abs(len(gf) - len(wf)) <= 5e-3 * len(wf) and abs(len(gv) - len(wv)) <= 5e-3 * len(wv)  # tolerance: 0.5%
    d = _nearest_distance(gv[::5], wv)  # every fifth vertex
    assert (d < 1e-3).mean() >= 0.99 and d.max() < 1e-2, ((d < 1e-3).mean(), d.max())  # tolerance: 1 mm
    assert gf.min() >= 0 and gf.max() < len(gv)


def test_evaluation_matches_jax(root):
    want = json.loads((root / "jax" / "integrate" / "ate.json").read_text())
    got = json.loads((root / "torch" / "integrate" / "ate.json").read_text())
    assert list(got) == list(want) and got["frames"] == want["frames"] == 16
    for k in ("ate_rmse", "ate_mean", "ate_median", "ate_max"):
        assert abs(got[k] - want[k]) < 1e-5, k  # tolerance: 1e-5 m
    _same(root, "jax", "torch", ["registration/gt_benchmark_health.json"])
    assert json.loads((root / "torch" / "registration" / "registration_pr.json").read_text()) == \
        json.loads((root / "jax" / "registration" / "registration_pr.json").read_text())


def test_cli_verbs_write_what_the_functions_write(root):
    _copy_upstream(root, "cli")
    device = ["--device", "cpu"]
    assert t_run.main([*_argv("optimize", root, "cli"), "--spill-corres", "--spill-deformed", *device]) == 0
    assert t_run.main([*_argv("integrate", root, "cli"), *device]) == 0
    _same(root, "torch", "cli", ["slac/pose_slac.log", "corres/corres_0_1.txt", "integrate/mesh.ply",
                                 "integrate/trajectory.log"])
    assert not list((root / "cli" / "slac").glob("deformed_*"))  # no lattice under mode none
    assert t_run.main([*_argv("evaluate", root, "cli"), *device]) == 0
    _same(root, "torch", "cli", ["integrate/ate.json", "registration/gt.log", "registration/registration_pr.json"])


def test_all_verb_lands_on_the_jax_ate(root):
    assert t_run.main([*_argv("all", root, "all"), "--device", "cpu"]) == 0
    out = root / "all"
    for name in ("fragments/cloud_bin_1.pcd", "fragments/local_1.log", "fragments/fragments.log",
                 "registration/odometry.log", "registration/loop.log", "posegraph/pose.log",
                 "slac/pose_slac.log", "integrate/mesh.ply", "integrate/trajectory.log", "integrate/ate.json",
                 "registration/gt.log", "registration/gt.info", "registration/registration_pr.json"):
        assert (out / name).exists(), name
    want = json.loads((root / "jax" / "integrate" / "ate.json").read_text())["ate_rmse"]
    got = json.loads((out / "integrate" / "ate.json").read_text())["ate_rmse"]
    assert abs(got - want) <= max(2e-3, 0.1 * want), (got, want)  # tolerance: max(2 mm, 10%)
    assert got < 0.05


@pytest.mark.parametrize("mode", ["rigid", "slac", "nonrigid"])
def test_unported_modes_fail_before_any_stage(tmp_path, mode):
    for verb in ("optimize", "all"):
        argv = [verb, "--data", str(tmp_path / "data"), "--out", str(tmp_path / "out"), "--slac-mode", mode,
                "--device", "cpu"]
        with pytest.raises(NotImplementedError, match="item 9"):
            t_run.main(argv)
    assert not (tmp_path / "out").exists()
    cfg = t_run.config_from_args(t_run.build_parser().parse_args(argv))
    with pytest.raises(NotImplementedError, match="elastic"):
        t_stages.run_optimize(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="elastic"):
        t_stages.run_all(None, cfg, device="cpu")
    assert not (tmp_path / "out").exists()
