"""The readers of the port's spans and counters (``metrics/spans.py`` and the ten metrics that use it).

On a hand-built store each reader gives the number its span arithmetic says,
and None on an empty store. On the card (marker ``card``): under the
benchmark's own profiler (``entries/common.py::profiled``, CUDA activity only)
the port records its spans and the reduced device events hold no span name;
under a CPU+CUDA profiler each stored span starts and ends within 50 us of its
``user_annotation`` event, so the store and the profiler share one clock.
"""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark import trace as btrace
from benchmark.entries import common
from elasticreconstruction_tpu_torch.core import trace

MS = 1_000_000  # ns


def _span(name, id_, parent, root, start_ms, end_ms, **counters):
    return trace.Span(name, id_, parent, root, start_ms * MS, end_ms * MS, counters)


# Two run_fragments calls of 51 and 49 frames, then a prep of 7 fragments and two batches of 8 and 7 pairs.
STORE = [
    _span("fragments", 0, None, 0, 0, 1000, frames=51),
    _span("fragments.decode", 1, 0, 0, 0, 50),
    _span("odometry.fuse", 2, 0, 0, 50, 60),
    _span("odometry.track", 3, 0, 0, 60, 400),
    _span("odometry.raycast", 4, 3, 0, 60, 160),
    _span("odometry.gn_level", 5, 3, 0, 170, 270),
    _span("odometry.gn_level", 6, 3, 0, 270, 390),
    _span("fragments.output", 7, 0, 0, 900, 1000),
    _span("fragments", 8, None, 8, 2000, 2500, frames=49),
    _span("fragments.decode", 9, 8, 8, 2000, 2050),
    _span("odometry.fuse", 10, 8, 8, 2050, 2070),
    _span("fragments.output", 11, 8, 8, 2400, 2500),
    _span("registration.prep", 12, None, 12, 3000, 3700, fragments=7),
    _span("registration.normals", 13, 12, 12, 3000, 3140),
    _span("registration.fpfh", 14, 12, 12, 3140, 3490),
    _span("registration.normals", 15, 12, 12, 3490, 3700),
    _span("registration.batch", 16, None, 16, 4000, 4300, pairs=8),
    _span("registration.ransac", 17, 16, 16, 4000, 4030),
    _span("registration.icp", 18, 16, 16, 4030, 4200, icp_steps=21),
    _span("registration.batch", 19, None, 19, 5000, 5200, pairs=7),
    _span("registration.ransac", 20, 19, 19, 5000, 5030),
    _span("registration.icp", 21, 19, 19, 5030, 5100, icp_steps=16),
]
EXPECTED = {
    "odometry.decode_ms_per_frame": 100 / 100,
    "odometry.raycast_ms_per_frame": 100 / 100,
    "odometry.gn_ms_per_frame": 220 / 100,
    "odometry.fuse_ms_per_frame": 30 / 100,
    "odometry.output_ms_per_frame": 200 / 100,
    "registration.normals_ms_per_fragment": 350 / 7,
    "registration.fpfh_ms_per_fragment": 350 / 7,
    "registration.ransac_ms_per_pair": 60 / 15,
    "registration.icp_ms_per_pair": 240 / 15,
    "registration.icp_steps_per_batch": 37 / 2,
}
SPAN_NAMES = {"fragments", "fragments.decode", "fragments.output", "odometry.fuse", "odometry.track",
              "odometry.raycast", "odometry.gn_level", "odometry.extract", "registration.prep",
              "registration.voxel", "registration.normals", "registration.fpfh", "registration.batch",
              "registration.match", "registration.ransac", "registration.icp", "registration.infomat"}


def test_every_span_metric_is_in_the_manifest_with_its_cell():
    man = {m["name"]: m for m in harness.manifest()["per_layer"]}
    for name in EXPECTED:
        cell = "odometry.livingroom_full_640" if name.startswith("odometry.") else "register.livingroom_full_640"
        assert man[name]["workloads"] == [cell]
        assert man[name]["source"] == ("program_counter" if name.endswith("steps_per_batch") else "program_span")


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_a_reader_on_a_hand_built_store(name, monkeypatch):
    reader = harness.load_reader(name)
    monkeypatch.setattr(trace, "records", lambda: list(STORE))
    assert reader.read({}) == pytest.approx(EXPECTED[name], rel=1e-12)
    monkeypatch.setattr(trace, "records", lambda: [])
    assert reader.read({}) is None
    other_cell = STORE[12:] if name.startswith("odometry.") else STORE[:12]
    monkeypatch.setattr(trace, "records", lambda: other_cell)
    assert reader.read({}) is None


def test_a_program_without_the_store_reads_none(monkeypatch):
    import sys

    from elasticreconstruction_tpu_torch import core

    monkeypatch.delattr(core, "trace")
    monkeypatch.setitem(sys.modules, "elasticreconstruction_tpu_torch.core.trace", None)  # its import raises
    assert all(harness.load_reader(name).read({}) is None for name in EXPECTED)


def _toy_runs(dev, root):
    """A two-fragment run_fragments and a prep plus one batch, at toy sizes on ``dev``."""
    from elasticreconstruction_tpu_torch.bench_scene import make_fragments
    from elasticreconstruction_tpu_torch.core import camera as cam
    from elasticreconstruction_tpu_torch.odometry import FragmentConfig, OdometryConfig
    from elasticreconstruction_tpu_torch.pipeline.config import PipelineConfig
    from elasticreconstruction_tpu_torch.pipeline.dataset import Dataset, generate_synthetic
    from elasticreconstruction_tpu_torch.pipeline.stages import run_fragments
    from elasticreconstruction_tpu_torch.registration import (
        RegistrationConfig,
        prep_fragments_batch,
        register_prepped_batch,
    )

    intr = cam.Intrinsics(fx=200.0, fy=200.0, cx=79.5, cy=59.5, width=160, height=120)
    generate_synthetic(root / "data", num_frames=9, intr=intr, trajectory="orbit", sweep=0.3, device=dev)
    frag = FragmentConfig(frames_per_fragment=4, volume_shape=(96, 96, 96), voxel_size=0.05, volume_min_z=0.2,
                          cloud_capacity=8192, odometry=OdometryConfig(raycast_steps=96))
    reg = RegistrationConfig(voxel_size=0.15, icp_voxel_size=0.075, coarse_capacity=512, fine_capacity=2048,
                             num_hypotheses=1024, inlier_threshold=0.15)
    clouds = make_fragments(3, n=4000, seed=2)[0]
    n = [0]

    def runs():
        n[0] += 1
        run_fragments(Dataset(root / "data"),
                      PipelineConfig(out_dir=str(root / f"out{n[0]}"), frames_per_fragment=4, fragment=frag),
                      device=dev)
        prepped = prep_fragments_batch(clouds, reg, device=dev)
        register_prepped_batch(prepped, np.array([0, 0, 1]), np.array([1, 2, 2]), torch.Generator().manual_seed(5),
                               reg, device=dev)

    return runs


@pytest.mark.card
def test_spans_stay_out_of_the_device_events_and_share_the_profilers_clock(card, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    runs = _toy_runs(card, tmp_path)
    runs()  # builds the kernels and warms every shape
    trace.clear()
    obs = common.profiled(runs, card)
    names = {s.name for s in trace.records()}
    assert names == SPAN_NAMES, names ^ SPAN_NAMES
    red = btrace.reduce(obs)
    assert red["kernels"] > 0 and not (set(red["device_s_by_name"]) & names)
    assert not any(e[0] in names for e in obs["events"])

    trace.clear()
    common.synchronize(card)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("set-up"):  # pays the profile's first-event set-up outside the spans
            pass
        runs()
        common.synchronize(card)
    events = sorted(((e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                     if e.name() in names and e.device_type() == torch.autograd.DeviceType.CPU),
                    key=lambda e: e[1])
    spans = trace.records()
    assert [e[0] for e in events] == [s.name for s in spans]
    gaps = np.array([(start - s.start_ns, s.end_ns - end) for (_, start, end), s in zip(events, spans)]) / 1e3
    far = [(s.name, *(round(float(x), 1) for x in g)) for s, g in zip(spans, gaps) if np.abs(g).max() >= 50]
    print(f"spans: {len(spans)}; gaps to their user_annotation events, us: median {np.median(gaps):.1f}, "
          f"95th percentile {np.percentile(gaps, 95):.1f}, largest {gaps.max():.1f}, smallest {gaps.min():.1f}; "
          f"spans 50 us or more away (name, start gap, end gap): {far}")
    assert not far
