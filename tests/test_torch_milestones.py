"""PyTorch port, the milestone ladder (``tools/milestones.py``) on the CPU.

- ``frag_pose_ate`` and ``cloud_surface_error`` on one artifact directory
  against the reference ladder's arithmetic (``milestones.py:189-240``) done
  through the JAX package's ``eval.ate``, ``eval.surface_error`` and
  ``elastic.lattice.deform``, in rigid, slac and nonrigid mode: within 1e-5
  relative (f32 Kabsch and lattice weights formed in another order).
- The ladder's config 3 -> config 4 slac -> config 4n functions through
  ``run_ladder`` at toy size (120x90, the first 21 frames of the orbit,
  K = 10, clouds of 4096 rows, the ``fast`` preset): every record carries the keys of the reference's
  ``milestones.json`` entry of the same name, the results file too, and a
  second run with ``--resume`` runs nothing again.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticreconstruction_tpu.elastic.lattice import Lattice as JLattice
from elasticreconstruction_tpu.elastic.lattice import deform as j_deform
from elasticreconstruction_tpu.eval import ate as j_ate
from elasticreconstruction_tpu.eval.surface_error import surface_error as j_surface_error
from elasticreconstruction_tpu.synthetic import scenes as j_scenes
from elasticreconstruction_tpu_torch.core import io_logfmt
from elasticreconstruction_tpu_torch.elastic.slac import SlacConfig
from elasticreconstruction_tpu_torch.odometry.fragments import FragmentConfig
from elasticreconstruction_tpu_torch.pipeline import dataset, run
from elasticreconstruction_tpu_torch.pipeline.config import PipelineConfig
from elasticreconstruction_tpu_torch.synthetic import scenes as t_scenes
from elasticreconstruction_tpu_torch.tools import milestones as ms

REPO = Path(__file__).resolve().parents[1]
K = 10
NF = 3
POINTS = 24000  # over the 20 000 the surface error subsamples each fragment to
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A dataset's gt.log and an ``out/`` with fragment clouds near the
    livingroom's surfaces, a perturbed ``pose_slac.log``, ``ctr.txt`` and
    ``ctr_<f>.txt`` lattices of a few cm."""
    root = tmp_path_factory.mktemp("ladder_artifacts")
    rng = np.random.default_rng(81)
    gt = t_scenes.orbit_trajectory(NF * K + 1, radius=1.1, height=1.3, sweep=0.6).astype(np.float32)
    data = root / "data"
    (data / "depth").mkdir(parents=True)
    dataset.write_intrinsics(data / "intrinsics.json", run.synth_intrinsics("120x90"))
    io_logfmt.write_log(data / "gt.log", io_logfmt.Trajectory.from_matrices(gt.astype(np.float64)))
    frag, slac = root / "out" / "fragments", root / "out" / "slac"
    frag.mkdir(parents=True)
    slac.mkdir()
    for f in range(NF):
        pts = rng.uniform((-1.2, -0.9, 0.4), (1.2, 0.9, 2.6), (POINTS, 3)).astype(np.float32)
        nrm = rng.normal(size=(POINTS, 3)).astype(np.float32)
        io_logfmt.write_pcd(frag / f"cloud_bin_{f}.pcd", pts, nrm / np.linalg.norm(nrm, axis=1, keepdims=True))
    est = gt[::K][:NF].astype(np.float64).copy()
    est[:, :3, 3] += rng.normal(0.0, 0.01, (NF, 3))
    io_logfmt.write_log(slac / "pose_slac.log", io_logfmt.Trajectory.from_matrices(est))
    lat = SlacConfig()
    rest = np.asarray(JLattice(lat.resolution, lat.length, lat.origin).rest_positions())
    for name in ["ctr.txt"] + [f"ctr_{f}.txt" for f in range(NF)]:
        disp = rng.normal(0.0, 0.02, rest.shape).astype(np.float32)
        io_logfmt.write_ctr(slac / name, rest + disp, lat.resolution, lat.length)
    return root


def _cfg(root: Path, mode: str) -> PipelineConfig:
    return PipelineConfig(data_dir=str(root / "data"), out_dir=str(root / "out"), frames_per_fragment=K,
                          fragment=FragmentConfig(frames_per_fragment=K, cloud_capacity=1 << 15), slac_mode=mode)


def _reference(root: Path, mode: str) -> dict:
    """``milestones.py``'s frag_pose_ate and cloud_surface_error on the JAX package."""
    slac_dir = root / "out" / "slac"
    gt_all = io_logfmt.read_log(root / "data" / "gt.log").matrices().astype(np.float32)
    est = io_logfmt.read_log(slac_dir / "pose_slac.log").matrices()
    gt = gt_all[::K][: len(est)]
    res = j_ate.absolute_trajectory_error(jnp.asarray(est[: len(gt)].astype(np.float32)), jnp.asarray(gt))
    out = {"frag_ate_rmse": float(res.rmse), "frag_ate_max": float(res.max)}
    poses = est.astype(np.float32)
    est_t, gt_t = poses[: len(gt), :3, 3], gt[:, :3, 3]
    mu_e, mu_g = est_t.mean(0), gt_t.mean(0)
    U, _, Vt = np.linalg.svd((est_t - mu_e).T @ (gt_t - mu_g))
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R_a = (U @ S @ Vt).T
    A = np.eye(4, dtype=np.float32)
    A[:3, :3] = R_a
    A[:3, 3] = mu_g - R_a @ mu_e
    poses = np.einsum("ij,njk->nik", A, poses).astype(np.float32)
    scfg = SlacConfig()
    pts_w = []
    rng = np.random.default_rng(0)
    for f in range(NF):
        p, _ = io_logfmt.read_pcd(root / "out" / "fragments" / f"cloud_bin_{f}.pcd")
        if len(p) > 20000:
            p = p[rng.choice(len(p), 20000, replace=False)]
        ctr = {"slac": slac_dir / "ctr.txt", "nonrigid": slac_dir / f"ctr_{f}.txt"}.get(mode)
        if ctr is not None:
            lat = JLattice(scfg.resolution, scfg.length, scfg.origin)
            pos, _, _ = io_logfmt.read_ctr(ctr)
            disp = jnp.asarray((pos - np.asarray(lat.rest_positions())).astype(np.float32))
            p = np.asarray(j_deform(lat, disp, jnp.asarray(p)))
        T = poses[f]
        pts_w.append(p @ T[:3, :3].T + T[:3, 3])
    err = j_surface_error(j_scenes.livingroom_scene(), np.concatenate(pts_w))
    out.update(surface_mean=err["mean"], surface_rmse=err["rmse"], surface_p95=err["p95"])
    return out


@pytest.mark.parametrize("mode", ["rigid", "slac", "nonrigid"])
def test_frag_pose_ate_and_cloud_surface_error_match_the_reference(artifacts, mode):
    cfg = _cfg(artifacts, mode)
    ds = dataset.Dataset(artifacts / "data")
    got = {**ms.frag_pose_ate(cfg, ds, "cpu"),
           **ms.cloud_surface_error(cfg, t_scenes.livingroom_scene(), mode, ds, "cpu")}
    want = _reference(artifacts, mode)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=key)
    assert 0.0 < want["frag_ate_rmse"] < 0.05 and want["surface_mean"] > 0.0


def _keys(rec) -> dict:
    """A record's keys, and those of its nested records, by path."""
    out = {"": set(rec)}
    for k, v in rec.items():
        if isinstance(v, dict):
            out.update({f"{k}/{p}": ks for p, ks in _keys(v).items()})
    return out


def test_ladder_config3_4_4n_carry_the_reference_keys(tmp_path, capsys):
    reference = json.loads((REPO / "milestones.json").read_text())
    names = ["config3_full_rigid", "config4_slac", "config4_nonrigid_deformed"]
    results = tmp_path / "milestones_gpu.json"
    argv = ["--frames", "21", "--device", "cpu", "--out", str(tmp_path / "runs"), "--results", str(results),
            "--fragment-volume", "96", "--fragment-voxel", "0.05", "--only", ",".join(names)]
    args = ms.build_parser().parse_args(argv)
    args.intr, args.frames_per_fragment, args.preset = run.synth_intrinsics("120x90"), K, "fast"
    args.cloud_capacity, args.sweep = 1 << 12, 2 * np.pi * 21 / 2550
    got = ms.run_ladder(args)
    assert json.loads(results.read_text()) == got
    for name in names:
        assert "error" not in got[name], got[name]
        assert _keys(got[name]) == _keys(reference[name]), name
    assert {"frames", "noise", "generate_seconds"} <= set(got) and got["device"] == {"platform": "cpu"}
    assert got["config3_full_rigid"]["frames"] == 20
    assert np.isfinite(got["config4_nonrigid_deformed"]["surface_improvement"])
    # --resume: every config is done, so none runs again.
    capsys.readouterr()
    args.resume = True
    again = ms.run_ladder(args)
    assert all(again[name] == got[name] for name in names)
    assert '"stage": "fragments"' not in capsys.readouterr().out


def test_attempt_records_a_failure_and_goes_on(tmp_path):
    results, path = {}, tmp_path / "r.json"

    def broken(root, args, device):
        raise ValueError("no such thing")

    args = ms.build_parser().parse_args(["--device", "cpu"])
    for _ in range(3):
        ms.attempt("config_x", broken, tmp_path, args, "cpu", results, path, reexec=False)
    assert results["config_x"]["error"] == "ValueError: no such thing"
    assert results["config_x"]["attempts"] == 2  # the third call did not run it again
    assert json.loads(path.read_text()) == results
    assert ms.crashed_context("RuntimeError: CUDA error: an illegal memory access was encountered")
    assert ms.crashed_context("RuntimeError: nearest_batch: CUDA launch failed with cudaError 719")
    assert not ms.crashed_context("ValueError: no such thing")
    with pytest.raises(ValueError, match="unknown configs"):
        ms.run_ladder(ms.build_parser().parse_args(["--device", "cpu", "--only", "config9"]))
