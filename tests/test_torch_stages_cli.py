"""PyTorch port, the ``register`` and ``posegraph`` verbs and their configuration vs the JAX package.

The tests of ``tests/test_torch_stages.py`` that need none of its two-package
fragment directory: the CLI's configuration against the JAX CLI's for each
preset, ``PipelineConfig``'s defaults, the stage seed's choice of RANSAC
draws, and the CLI verbs against the stage functions on one fragment
directory (``bench_scene.write_fragments_dir``: 4 fragments of 1500 points at
the ``fast`` preset), which must write the same bytes.

They sit in a file of their own so that the suite's workers (``--dist
loadfile`` hands out whole files) run them beside ``test_torch_stages.py``'s
module fixture, not after it. torch runs on one intra-op thread here: under
several workers its spinning pool made the verbs test take 429 s, against 25 s
alone.
"""

import dataclasses
import filecmp
import shutil

import numpy as np
import pytest
import torch

from elasticreconstruction_tpu.pipeline import run as j_run
from elasticreconstruction_tpu.pipeline.config import PipelineConfig as JPipelineConfig
from elasticreconstruction_tpu_torch import interop
from elasticreconstruction_tpu_torch.bench_scene import write_fragments_dir
from elasticreconstruction_tpu_torch.core import io_logfmt as t_io
from elasticreconstruction_tpu_torch.pipeline import run as t_run
from elasticreconstruction_tpu_torch.pipeline import stages as t_stages
from elasticreconstruction_tpu_torch.pipeline.config import PipelineConfig


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: under several test workers torch's spinning
    thread pools slow every test many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_stage_seed_selects_the_draws():
    """``cfg.seed`` (the CLI's ``--seed``) picks every batch's RANSAC stream.
    The CPU generator keeps only the low 32 bits of its seed, so a stage seed
    shifted above them drew the same hypotheses under every seed. Seed 0 keeps
    the stream of the batch's start alone, the one the recorded ladder runs drew."""

    def first(gen):
        return torch.randint(0, 1 << 30, (16,), generator=gen)

    starts = (0, 16, 336)
    streams = {(seed, start): first(t_stages._batch_generator(seed, start)) for seed in range(5) for start in starts}
    assert len({tuple(v.tolist()) for v in streams.values()}) == len(streams)
    for start in starts:
        assert torch.equal(streams[(0, start)], first(torch.Generator().manual_seed(start)))


@pytest.mark.parametrize("preset,flags", [
    ("full", []), ("fast", []),
    ("full", ["--fragment-volume", "192", "--fragment-voxel", "0.02", "--scene-voxel", "0.01",
              "--slac-mode", "none", "--spill-corres", "--spill-deformed"]),
    ("fast", ["--fragment-volume", "64", "--slac-mode", "rigid", "--num-frames", "30", "--depth-noise", "0.01",
              "--size", "320x240"]),
])
def test_cli_config_matches_jax(preset, flags):
    argv = ["register", "--out", "o", "--data", "d", "--preset", preset, "--seed", "3",
            "--frames-per-fragment", "40", *flags]
    t_args = t_run.build_parser().parse_args(argv + ["--device", "cpu"])
    want = interop.pipeline_config_from(j_run.config_from_args(j_run.build_parser().parse_args(argv)))
    assert t_run.config_from_args(t_args) == want
    assert t_args.device == "cpu" and t_run.build_parser().parse_args(argv).device == "cuda"
    j_args = j_run.build_parser().parse_args(argv)
    for name in ("num_frames", "depth_noise", "size", "slac_mode", "spill_corres", "spill_deformed"):
        assert getattr(t_args, name) == getattr(j_args, name)


def test_pipeline_config_defaults_match_jax():
    assert interop.pipeline_config_from(JPipelineConfig()) == PipelineConfig()
    j_fields = [f.name for f in dataclasses.fields(JPipelineConfig)]
    assert [f.name for f in dataclasses.fields(PipelineConfig)] == j_fields
    cfg = PipelineConfig(out_dir="x")
    assert str(cfg.p_registration()) == "x/registration" and str(cfg.p_posegraph()) == "x/posegraph"
    assert cfg.slac_config().mode.value == JPipelineConfig().slac_config().mode.value


def test_cli_verbs_write_the_same_files_as_the_functions(tmp_path):
    a, b = tmp_path / "cli", tmp_path / "fn"
    write_fragments_dir(a, 4, n=1500, seed=1)
    shutil.copytree(a, b)
    argv = ["--preset", "fast", "--device", "cpu", "--seed", "5"]
    assert t_run.main(["register", "--out", str(a), *argv]) == 0
    assert t_run.main(["posegraph", "--out", str(a), *argv]) == 0
    cfg = t_run.config_from_args(t_run.build_parser().parse_args(["register", "--out", str(b), *argv]))
    t_stages.run_registration(cfg, device="cpu")
    t_stages.run_posegraph(cfg, device="cpu")
    names = ["registration/odometry.log", "registration/odometry.info", "registration/odometry_suspect.txt",
             "registration/loop.log", "registration/loop.info", "posegraph/pose.log", "posegraph/kept_edges.txt"]
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert sorted(match) == sorted(names), (mismatch, errors)
    # The default --slac-mode, slac: the pose-graph poses refined, the lattice written.
    assert t_run.main(["optimize", "--out", str(a), *argv]) == 0
    refined = t_io.read_log(a / "slac" / "pose_slac.log").matrices()
    assert refined.shape == (4, 4, 4) and np.isfinite(refined).all()
    assert (a / "slac" / "ctr.txt").exists()
