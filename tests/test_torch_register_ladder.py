"""PyTorch port, the ``register`` stage vs the JAX package on milestone configs 3d's and 4n's card fragments.

Two windows of seven fragments, each as the port wrote them on the card at full
length (``tests/ladder_card.py ladder``), cut and renumbered 0-6 by ``python
tests/stage_diagnosis.py cut RUN DST --window A-B --no-normals`` with their
health files, ``local_<f>.log``, the ``fragments.log`` rows the drift gate reads
and ``gt_bases.log``, the ground-truth poses of their first frames. The clouds
carry no normals: registration recomputes them (``estimate_normals_radius``), so
the stage reads the same inputs either way at half the size.

- ``tests/data/config3d_register/``: fragments 30-36 of config 3d, the last
  three healthy fragments before the bare wall and the first four suspect ones.
- ``tests/data/config4n_register/``: fragments 40-46 of config 4n, config 3's
  healthy clouds through 4n's known per-fragment warps (3 cm on an 8^3 lattice).
  No fragment is suspect, so the drift gate admits by radius alone and its
  suspect-path and content sets are empty.

Both packages' ``run_registration`` runs on its own copy at the ladder's
configuration, but with smaller clouds and fewer hypotheses than the ladder's
4096 / 8192 / 4096, which take minutes on the CPU, and clouds padded to 20 480
rows (the padding is masked), the port on the JAX stage's own RANSAC draws (as
in ``tests/test_torch_stages.py``; torch cannot reproduce ``jax.random``). Each
window's sizes are ones at which neither package flips a success flag when its
input clouds move by one f32 ulp (``nudge_clouds``), so that every flag is
pinned by the data and not by rounding:

- 3d at 1024 / 2048-point clouds and 1024 hypotheses;
- 4n at 2048 / 4096 and 2048. A warp leaves no rigid transform that fits a
  pair exactly, so ICP's optimum is flat. At 1024 / 2048 / 1024 the one-ulp
  nudge flipped 1-3 of the 15 flags of windows 0-6 and 22-28 in each package.
  At 2048 / 4096 / 2048 on this window it flipped none, and moved the
  transforms by 1.0e-3 (JAX) and 8.5e-4 (port).

Then:

- the drift gate's admitted pairs, its suspect-path candidates, the content set
  that mutual top-k retrieval picks among them, the list of pairs registered
  and ``odometry_suspect.txt`` are equal;
- every pair's success flag is equal, and the transforms of the pairs both
  accept agree within 1e-3 (measured: 1.3e-4 on 3d, 6.5e-4 on 4n);
- ``odometry.log`` agrees within 2e-3, ``tests/test_torch_stages.py``'s bound
  for the same ICP refinement, where a near-tie correspondence can settle an
  edge on a neighbouring fixed point (measured: 1.5e-3 on one edge of 3d,
  2.1e-4 on 4n).

At the ladder's sizes the flags are not all equal: RANSAC on a pair with no
true optimum (an aliased view across the wall, a warped overlap) lands where
f32 rounding sends it. At full length under the JAX draws 53 of 353 flags of
3d flipped, 52 of them on pairs neither package registers within 10 cm of
ground truth, and the JAX stage itself flipped 62 when its input clouds moved
by one ulp; 4n's figures sit beside them in PERF.md §6. At these sizes every
flag of each window agrees.
"""

import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import elasticreconstruction_tpu.registration as j_reg
import elasticreconstruction_tpu.registration.retrieval as j_retrieval
from elasticreconstruction_tpu.core import io_logfmt as j_io
from elasticreconstruction_tpu.odometry.fragments import FragmentConfig as JFragmentConfig
from elasticreconstruction_tpu.odometry.kinfu import OdometryConfig as JOdometryConfig
from elasticreconstruction_tpu.pipeline import stages as j_stages
from elasticreconstruction_tpu.pipeline.config import PipelineConfig as JPipelineConfig
from elasticreconstruction_tpu.registration.pair import RegistrationConfig as JRegistrationConfig
from elasticreconstruction_tpu_torch import interop
from elasticreconstruction_tpu_torch.core import io_logfmt as t_io

import ladder_card

DATA = Path(__file__).resolve().parent / "data"
FIXTURE = DATA / "config3d_register"
NUM_FRAGMENTS = 7
SUSPECT = [False, False, False, True, True, True, True]  # fragments 33-36 of the full run
# Each window: whether its drift gate has suspect-path candidates (3d's blind
# wall) or admits by radius alone (4n), and its coarse / fine cloud sizes and
# RANSAC hypotheses (the docstring says why).
WINDOWS = {"config3d_register": (True, (1024, 2048, 1024)), "config4n_register": (False, (2048, 4096, 2048))}
CAPACITY = 20480
TRANSFORM_TOL = 1e-3
ODOMETRY_TOL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(out: Path, sizes: tuple[int, int, int]) -> JPipelineConfig:
    """The ladder's configuration (``tests/stage_diagnosis.py::ladder_cfg``) at the
    registration ``sizes`` (coarse cloud, fine cloud, hypotheses)."""
    coarse, fine, hypotheses = sizes
    return JPipelineConfig(
        out_dir=str(out), frames_per_fragment=50,
        fragment=JFragmentConfig(frames_per_fragment=50, volume_shape=(128, 128, 128), voxel_size=0.024,
                                 cloud_capacity=CAPACITY, odometry=JOdometryConfig(raycast_steps=96)),
        registration=JRegistrationConfig(coarse_capacity=coarse, fine_capacity=fine, num_hypotheses=hypotheses),
        slac_mode="none", scene_voxel_size=0.03, registration_batch=16,
    )


def _jax_draws(seed: int, batch: int, hypotheses: int):
    """The JAX stage's draws for the batch starting at pair ``start`` (``pipeline/stages.py:352,360``)."""

    def draws_for(start, n):
        keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), start), batch)[:n]
        draws = jax.vmap(lambda k: jax.random.randint(k, (hypotheses, 3), 0, 1 << 30))(keys)
        return torch.from_numpy(np.array(draws))

    return draws_for


@pytest.fixture(scope="module", params=sorted(WINDOWS))
def runs(request, tmp_path_factory):
    root = tmp_path_factory.mktemp("register_ladder")
    suspect_path, sizes = WINDOWS[request.param]
    got = {}
    for pkg in ("jax", "torch"):
        out = root / pkg
        shutil.copytree(DATA / request.param / "fragments", out / "fragments")
        cfg = _cfg(out, sizes)
        if pkg == "torch":
            got[pkg] = ladder_card.port_registration(
                interop.pipeline_config_from(cfg), "cpu",
                _jax_draws(cfg.seed, cfg.registration_batch, cfg.registration.num_hypotheses))
            continue
        seen, calls = {"suspect_path": set(), "content": set()}, []
        real = j_reg.register_prepped_batch

        def batch(prepped, ii, jj, keys, rcfg):
            res = real(prepped, ii, jj, keys, rcfg)
            calls.append((ii, jj, res))
            return res

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(j_reg, "register_prepped_batch", batch)
            mp.setattr(j_retrieval, "mutual_topk_pairs", ladder_card.capture_topk(seen, j_retrieval.mutual_topk_pairs))
            stats = j_stages.run_registration(cfg)
        got[pkg] = ladder_card.collect(calls, seen, stats)
    return {"root": root, "suspect_path": suspect_path, **got}


def test_fixture_is_config3d_around_the_blind_wall():
    frag = FIXTURE / "fragments"
    assert len(t_io.read_log(frag / "fragments.log").entries) == NUM_FRAGMENTS
    assert [json.loads((frag / f"health_{f}.json").read_text())["suspect"] for f in range(NUM_FRAGMENTS)] == SUSPECT
    for f in range(NUM_FRAGMENTS):
        pts, nrm = t_io.read_pcd(frag / f"cloud_bin_{f}.pcd")
        assert nrm is None and 2000 < len(pts) <= CAPACITY
    assert len(t_io.read_log(FIXTURE / "gt_bases.log").entries) == NUM_FRAGMENTS
    assert sum(p.stat().st_size for p in FIXTURE.rglob("*") if p.is_file()) < 2 << 20


def test_fixture_is_config4n_warped_clouds():
    """Fragments 40-46 of 4n: healthy, without normals, with the ground-truth edges among them."""
    fixture = DATA / "config4n_register"
    frag = fixture / "fragments"
    assert len(t_io.read_log(frag / "fragments.log").entries) == NUM_FRAGMENTS
    assert not any(json.loads((frag / f"health_{f}.json").read_text())["suspect"] for f in range(NUM_FRAGMENTS))
    for f in range(NUM_FRAGMENTS):
        pts, nrm = t_io.read_pcd(frag / f"cloud_bin_{f}.pcd")
        assert nrm is None and 2000 < len(pts) <= CAPACITY
    assert len(t_io.read_log(fixture / "gt_bases.log").entries) == NUM_FRAGMENTS
    assert len(t_io.read_log(fixture / "registration" / "gt.log").entries) > 0
    assert sum(p.stat().st_size for p in fixture.rglob("*") if p.is_file()) < 1.5 * (1 << 20)


def test_gate_sets_match_jax(runs):
    j, t = runs["jax"], runs["torch"]
    assert t["admitted"] == j["admitted"] and len(j["admitted"]) > 0
    assert t["suspect_path"] == j["suspect_path"] and (len(j["suspect_path"]) > 0) == runs["suspect_path"]
    assert t["content"] == j["content"] and (len(j["content"]) > 0) == runs["suspect_path"]
    assert t["pairs"] == j["pairs"]
    name = "odometry_suspect.txt"
    assert (runs["root"] / "torch" / "registration" / name).read_text() == \
        (runs["root"] / "jax" / "registration" / name).read_text()


def test_success_flags_and_transforms_match_jax(runs):
    j, t = runs["jax"], runs["torch"]
    np.testing.assert_array_equal(t["success"], j["success"])
    both = j["success"].astype(bool)
    assert both.sum() >= 2
    diff = np.abs(t["transform"] - j["transform"]).max((1, 2))[both]
    assert diff.max() <= TRANSFORM_TOL, diff  # tolerance: 1e-3


def test_odometry_edges_match_jax(runs):
    j_log = j_io.read_log(runs["root"] / "jax" / "registration" / "odometry.log")
    t_log = t_io.read_log(runs["root"] / "torch" / "registration" / "odometry.log")
    assert [(e.i, e.j) for e in t_log.entries] == [(e.i, e.j) for e in j_log.entries]
    assert len(t_log.entries) == NUM_FRAGMENTS - 1
    np.testing.assert_allclose(t_log.matrices(), j_log.matrices(), atol=ODOMETRY_TOL)  # tolerance: 2e-3
