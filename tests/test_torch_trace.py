"""PyTorch port, ``core/trace.py``: the spans and counters of the odometry and registration paths.

With no profiler recording, a toy ``run_fragments`` and a toy prep plus
batches leave no record. Under a CPU ``torch.profiler`` the same runs give the
span tree of the fixed names (parents, one root id a top-level call), the
counters (`frames`, `fragments`, `pairs`, `icp_steps`) equal independent
counts, a counter takes host integers alone, profiled or not, and every span
lands in the profiler's own trace as a ``user_annotation`` event, which the
stored span encloses on the same clock. ``run fragments --profile`` writes a
Chrome trace that holds every odometry span name.
"""

import json
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from elasticreconstruction_tpu_torch.bench_scene import make_fragments
from elasticreconstruction_tpu_torch.core import camera as cam
from elasticreconstruction_tpu_torch.core import trace
from elasticreconstruction_tpu_torch.odometry import FragmentConfig, OdometryConfig
from elasticreconstruction_tpu_torch.pipeline import run
from elasticreconstruction_tpu_torch.pipeline.config import PipelineConfig
from elasticreconstruction_tpu_torch.pipeline.dataset import Dataset, generate_synthetic
from elasticreconstruction_tpu_torch.pipeline.stages import run_fragments
from elasticreconstruction_tpu_torch.registration import icp as icp_mod
from elasticreconstruction_tpu_torch.registration import (
    RegistrationConfig,
    prep_fragments_batch,
    register_pairs_batch,
    register_prepped_batch,
)

INTR = cam.Intrinsics(fx=65.0, fy=65.0, cx=39.5, cy=29.5, width=80, height=60)
K = 4
NUM_FRAMES = 2 * K + 2  # two fragments; the last frame is decoded by neither
ODOM = OdometryConfig(levels=2, iterations=(3, 2), raycast_steps=48, depth_max=5.0)
FRAG = FragmentConfig(frames_per_fragment=K, volume_shape=(48, 48, 48), voxel_size=0.08, volume_min_z=0.2,
                      cloud_capacity=4096, depth_max=5.0, odometry=ODOM)
REG = RegistrationConfig(voxel_size=0.15, icp_voxel_size=0.075, coarse_capacity=512, fine_capacity=1024,
                         num_hypotheses=256, icp_iterations=10, inlier_threshold=0.15)
ODOMETRY_PARENTS = {"fragments": None, "fragments.decode": "fragments", "fragments.output": "fragments",
                    "odometry.fuse": "fragments", "odometry.track": "fragments", "odometry.extract": "fragments",
                    "odometry.raycast": "odometry.track", "odometry.gn_level": "odometry.track"}
PREP_PARENTS = {"registration.prep": None, "registration.voxel": "registration.prep",
                "registration.normals": "registration.prep", "registration.fpfh": "registration.prep"}
BATCH_PARENTS = {"registration.batch": None, "registration.match": "registration.batch",
                 "registration.ransac": "registration.batch", "registration.icp": "registration.batch",
                 "registration.infomat": "registration.batch"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def empty_store():
    trace.clear()
    yield
    trace.clear()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("trace") / "data"
    generate_synthetic(root, num_frames=NUM_FRAMES, intr=INTR, trajectory="orbit", radius=1.0, sweep=0.3,
                       start_angle=0.7, device="cpu")
    return root


@pytest.fixture(scope="module")
def clouds():
    return make_fragments(3, n=3000, seed=1)[0]


def _fragments(data, out):
    run_fragments(Dataset(data), PipelineConfig(out_dir=str(out), frames_per_fragment=K, fragment=FRAG),
                  device="cpu")


PAIRS = (np.array([0, 0, 1]), np.array([1, 2, 2]))


def _registration(clouds):
    """A prep, one batch of three pairs, and one batch that preps its pair inline."""
    prepped = prep_fragments_batch(clouds, REG, device="cpu")
    register_prepped_batch(prepped, *PAIRS, torch.Generator().manual_seed(3), REG, device="cpu")
    one = type(clouds)(*(x[:1] for x in clouds))
    two = type(clouds)(*(x[1:2] for x in clouds))
    register_pairs_batch(one, two, torch.Generator().manual_seed(4), REG, device="cpu")


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def _check_tree(spans, parents):
    """Every span's name is known, its parent has the expected name, and it shares its root's id."""
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.name in parents, s.name
        want = parents[s.name]
        if want is None:
            assert s.parent is None and s.root == s.id
        else:
            assert by_id[s.parent].name == want and s.root == by_id[s.parent].root
        assert s.start_ns <= s.end_ns


def test_with_no_profiler_nothing_is_recorded(data, clouds, tmp_path):
    _fragments(data, tmp_path / "out")
    _registration(clouds)
    assert trace.records() == []
    assert trace.span("a") is trace.span("b")  # the one shared no-op context
    trace.count("frames", 3)  # no open span: nothing to add to
    assert trace.records() == []


def test_fragments_span_tree_and_counters(data, tmp_path):
    _profiled(lambda: _fragments(data, tmp_path / "out"))
    spans = trace.records()
    _check_tree(spans, ODOMETRY_PARENTS)
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["fragments"]
    n = Counter(s.name for s in spans)
    nf = (NUM_FRAMES - 1) // K
    assert n == {"fragments": 1, "fragments.decode": nf, "fragments.output": nf + 1, "odometry.fuse": nf * (K + 1),
                 "odometry.track": nf * K, "odometry.raycast": nf * K, "odometry.gn_level": nf * K * ODOM.levels,
                 "odometry.extract": nf}
    assert roots[0].counters == {"frames": nf * (K + 1)}
    assert all(s.counters == {} for s in spans if s.name != "fragments")


def test_registration_span_tree_and_counters(clouds, monkeypatch):
    calls = []
    step = icp_mod._step_batch

    def counted(*args):
        calls.append(1)
        return step(*args)

    monkeypatch.setattr(icp_mod, "_step_batch", counted)
    _profiled(lambda: _registration(clouds))
    spans = trace.records()
    _check_tree(spans, {**PREP_PARENTS, **BATCH_PARENTS})
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["registration.prep", "registration.batch", "registration.prep",
                                       "registration.batch"]
    assert [r.counters for r in roots] == [{"fragments": 3}, {"pairs": 3}, {"fragments": 2}, {"pairs": 1}]
    n = Counter(s.name for s in spans)
    # prep of 3 clouds at two scales, then one pair's two clouds inline (the j side's fine cloud has no normals)
    assert (n["registration.voxel"], n["registration.normals"], n["registration.fpfh"]) == (6 + 4, 6 + 3, 3 + 2)
    assert all(n[name] == 2 for name in BATCH_PARENTS)
    steps = [s.counters.get("icp_steps", 0) for s in spans]
    assert sum(steps) == len(calls) > 0
    assert all(s.name == "registration.icp" for s, k in zip(spans, steps) if k)


def test_counters_add_host_integers_only():
    with pytest.raises(TypeError):  # unprofiled too, so a profiled run fails nowhere an unprofiled one passes
        trace.count("n", torch.tensor(1))
    with pytest.raises(TypeError):
        trace.count("n", 1.0)
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("outer"):
            trace.count("n", 2)
            with trace.span("inner"):
                trace.count("n")
                trace.count("m", np.int64(4))
                with pytest.raises(TypeError):
                    trace.count("n", torch.tensor(1))
            trace.count("n", 3)
    outer, inner = trace.records()
    assert (outer.name, outer.counters, inner.name, inner.counters) == ("outer", {"n": 5}, "inner", {"n": 1, "m": 4})
    assert type(inner.counters["m"]) is int
    assert inner.parent == outer.id and inner.root == outer.id
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_spans_are_user_annotations_on_the_profilers_clock(data, tmp_path):
    """Each stored span encloses its own ``user_annotation`` event, to within a few microseconds (one clock);
    how close it lies is the card's test (``benchmark/tests/test_benchmark_span_metrics.py``): a shared CPU
    host only bounds it loosely."""
    prof = _profiled(lambda: _fragments(data, tmp_path / "out"))
    events = sorted(((e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                     if e.name() in ODOMETRY_PARENTS), key=lambda e: e[1])
    spans = trace.records()
    assert [e[0] for e in events] == [s.name for s in spans]
    for (name, start, end), s in zip(events, spans):
        assert -5_000 < start - s.start_ns < 5_000_000 and -5_000 < s.end_ns - end < 5_000_000, name


def test_profile_writes_the_span_names_into_the_chrome_trace(data, tmp_path, capsys):
    root = tmp_path / "traces"
    argv = ["fragments", "--data", str(data), "--out", str(tmp_path / "out"), "--device", "cpu", "--preset", "fast",
            "--frames-per-fragment", str(K), "--fragment-volume", "48", "--fragment-voxel", "0.08",
            "--profile", str(root)]
    assert run.main(argv) == 0
    capsys.readouterr()
    (path,) = (root / "fragments").glob("*.json")
    events = json.loads(path.read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert set(ODOMETRY_PARENTS) <= names
    assert {s.name for s in trace.records()} == set(ODOMETRY_PARENTS)
