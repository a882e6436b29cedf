"""PyTorch port: the ``optimize`` and ``integrate`` stages in the elastic modes vs
the JAX package, and the ``optimize`` and ``all`` verbs at the default mode.

The dataset of ``tests/test_torch_scene_stage.py`` (livingroom, orbit,
120 x 90 pixels, 17 frames with 5 mm depth noise, two fragments) goes
through the JAX ``run_all`` with ``slac_mode="none"`` at the configuration
the CLI builds for ``--preset fast --frames-per-fragment 8
--fragment-volume 96 --fragment-voxel 0.05``, its clouds cut to 4096 points
(so that the port's plain-version harvest stays quick on the CPU). On copies
of that upstream, in ``slac`` and ``nonrigid`` mode with two
correspondence/optimise rounds, the JAX ``run_optimize``, ``run_integrate``
and ``run_evaluate`` and then the port's:

- ``pose_slac.log`` within 5e-4 and the control lattices (``ctr.txt``,
  ``ctr_<f>.txt``) within 2e-4 m: the optimiser's parity bar
  (``tests/test_torch_elastic_slac.py``) after a second harvest at the
  refined state, whose matches may differ by a near-tie of the NN contracts;
- the stats record's RMSE before and after within 1e-4 m;
- ``mesh.ply`` faces within 0.5%, ATE within 1 mm.

Then, on the dataset, the port's ``optimize`` and ``all`` verbs at the CLI's
default ``--slac-mode`` (slac) with ``--device cpu`` write every artifact,
``ctr.txt`` included.
"""

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from elasticreconstruction_tpu.core import camera as j_cam
from elasticreconstruction_tpu.pipeline import dataset as j_dataset
from elasticreconstruction_tpu.pipeline import run as j_run
from elasticreconstruction_tpu.pipeline import stages as j_stages
from elasticreconstruction_tpu_torch import interop
from elasticreconstruction_tpu_torch.core import io_logfmt as t_io
from elasticreconstruction_tpu_torch.pipeline import dataset as t_dataset
from elasticreconstruction_tpu_torch.pipeline import run as t_run
from elasticreconstruction_tpu_torch.pipeline import stages as t_stages

INTR = j_cam.Intrinsics(fx=100.0, fy=100.0, cx=59.5, cy=44.5, width=120, height=90)
FLAGS = ["--preset", "fast", "--frames-per-fragment", "8", "--fragment-volume", "96", "--fragment-voxel", "0.05"]
UPSTREAM = ("fragments", "registration", "posegraph")
CLOUD_CAPACITY = 4096


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_cfg(root, out, mode):
    cfg = j_run.config_from_args(j_run.build_parser().parse_args(
        ["optimize", "--data", str(root / "data"), "--out", str(root / out), "--slac-mode", mode, *FLAGS]))
    return dataclasses.replace(cfg, fragment=cfg.fragment._replace(cloud_capacity=CLOUD_CAPACITY), corres_rounds=2)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic_stage")
    j_dataset.generate_synthetic(root / "data", num_frames=17, intr=INTR, scene="livingroom",
                                 trajectory="orbit", radius=1.0, sweep=0.7, start_angle=0.7, seed=0,
                                 depth_noise=0.005)
    j_stages.run_all(j_dataset.Dataset(root / "data"), _jax_cfg(root, "upstream", "none"))
    return root


@pytest.fixture(scope="module", params=["slac", "nonrigid"])
def mode_runs(root, request):
    mode = request.param
    jds, tds = j_dataset.Dataset(root / "data"), t_dataset.Dataset(root / "data")
    runs = {}
    for pkg in ("jax", "torch"):
        out = f"{pkg}_{mode}"
        for name in UPSTREAM:
            shutil.copytree(root / "upstream" / name, root / out / name,
                            ignore=shutil.ignore_patterns("gt.*", "gt_benchmark_health.json", "registration_pr.json"))
        jcfg = _jax_cfg(root, out, mode)
        if pkg == "jax":
            stats = j_stages.run_optimize(jcfg)
            j_stages.run_integrate(jds, jcfg)
            j_stages.run_evaluate(jds, jcfg)
        else:
            cfg = interop.pipeline_config_from(jcfg)
            stats = t_stages.run_optimize(cfg, device="cpu")
            t_stages.run_integrate(tds, cfg, device="cpu")
            t_stages.run_evaluate(tds, cfg, device="cpu")
        runs[pkg] = (root / out, stats)
    return mode, runs


def _ctr(out, mode):
    names = ["ctr_0.txt", "ctr_1.txt"] if mode == "nonrigid" else ["ctr.txt"]
    return np.stack([t_io.read_ctr(out / "slac" / n)[0] for n in names])


def test_optimize_matches_jax(mode_runs):
    mode, runs = mode_runs
    (jout, jstats), (tout, tstats) = runs["jax"], runs["torch"]
    want = t_io.read_log(jout / "slac" / "pose_slac.log").matrices()
    got = t_io.read_log(tout / "slac" / "pose_slac.log").matrices()
    assert got.shape == want.shape == (2, 4, 4)
    np.testing.assert_allclose(got, want, atol=5e-4)  # tolerance: 5e-4
    cw, cg = _ctr(jout, mode), _ctr(tout, mode)
    assert np.abs(cw - cg).max() <= 2e-4, np.abs(cw - cg).max()  # tolerance: 2e-4 m
    assert not (tout / "slac" / ("ctr.txt" if mode == "nonrigid" else "ctr_0.txt")).exists()
    assert tstats["mode"] == mode and tstats["rounds"] == 2
    for k in ("rmse_before", "rmse_after"):
        assert abs(tstats[k] - jstats[k]) <= 1e-4, (k, tstats[k], jstats[k])  # tolerance: 0.1 mm


def test_integrate_and_evaluate_match_jax(mode_runs):
    mode, runs = mode_runs
    (jout, _), (tout, _) = runs["jax"], runs["torch"]
    _, wf = t_io.read_ply_mesh(jout / "integrate" / "mesh.ply")
    _, gf = t_io.read_ply_mesh(tout / "integrate" / "mesh.ply")
    assert len(wf) > 3000 and abs(len(gf) - len(wf)) <= 5e-3 * len(wf), (len(gf), len(wf))  # tolerance: 0.5%
    want = json.loads((jout / "integrate" / "ate.json").read_text())["ate_rmse"]
    got = json.loads((tout / "integrate" / "ate.json").read_text())["ate_rmse"]
    assert abs(got - want) <= 1e-3, (got, want)  # tolerance: 1 mm


def test_optimize_and_all_verbs_at_the_default_mode(root):
    for name in UPSTREAM:
        shutil.copytree(root / "upstream" / name, root / "verb" / name)
    device = ["--device", "cpu"]
    assert t_run.main(["optimize", "--out", str(root / "verb"), *FLAGS, "--spill-deformed", *device]) == 0
    for name in ("pose_slac.log", "ctr.txt", "deformed_0.xyzn", "deformed_1.xyzn"):
        assert (root / "verb" / "slac" / name).exists(), name
    assert t_run.main(["all", "--data", str(root / "data"), "--out", str(root / "all"), *FLAGS, *device]) == 0
    for name in ("fragments/fragments.log", "registration/loop.log", "posegraph/pose.log", "slac/pose_slac.log",
                 "slac/ctr.txt", "integrate/mesh.ply", "integrate/trajectory.log", "integrate/ate.json",
                 "registration/registration_pr.json"):
        assert (root / "all" / name).exists(), name
    assert json.loads((root / "all" / "integrate" / "ate.json").read_text())["ate_rmse"] < 0.05
