"""PyTorch port, ``pipeline/stages.py::run_registration`` against the benchmark's plain reference of the stage.

The fragment files are the benchmark's own traffic (``benchmark/traffic/scene.py``)
at a toy size: six fragments of the livingroom orbit fused at 64^3, chained
with 1 cm and 0.2 degrees of drift an edge. The port runs the stage on the
CPU; ``benchmark/reference/stage.py`` restates it on the reference's
registrar. They compute the same float32 operations here, so every decision
agrees (the admitted candidates, the suspect edges, the accepted pairs) and
the transforms and information matrices differ only by the files' eight
decimals: under 1e-6 m and rad where the points are, and 1e-9 of the largest
information entry. A healthy chain admits pairs by the drift gate alone; a
suspect fragment makes its two edges suspect, re-registered as candidates,
and admits the pairs across them by content retrieval, each twice. Under a
CPU profiler the stage's spans nest under ``registration.stage``, whose
counters equal its stats; unprofiled it records nothing.
"""

import json
import shutil
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.entries.register_stage import program_config
from benchmark.reference import stage as ref
from benchmark.traffic import scene
from elasticreconstruction_tpu_torch.core import trace
from elasticreconstruction_tpu_torch.pipeline.stages import run_registration

CONFIG = {
    "camera": {"fx": 100.0, "fy": 100.0, "cx": 39.5, "cy": 29.5, "width": 80, "height": 60},
    "frames_per_fragment": 6,
    "fragment": {"volume_shape": [64, 64, 64], "voxel_size": 0.05, "volume_min_z": 0.3, "cloud_capacity": 4096,
                 "max_weight": 64.0, "depth_min": 0.1, "depth_max": 6.0},
    "registration": {"voxel_size": 0.2, "icp_voxel_size": 0.1, "coarse_capacity": 256, "fine_capacity": 1024,
                     "normal_radius_factor": 2.0, "fpfh_radius_factor": 5.0, "inlier_threshold": 0.15,
                     "edge_similarity": 0.9, "num_hypotheses": 256, "icp_iterations": 10, "icp_src_stride": 2,
                     "icp_coarse_iterations": 4, "icp_coarse_stride": 4, "min_inliers": 6, "min_fitness": 0.25},
    "registration_batch": 4,
    "loop_gating": "drift", "loop_candidate_radius": None, "drift_per_fragment": 0.05, "drift_suspect": 0.75,
    "gate_margin": 0.3, "gate_near_diagonal": 3, "retrieval_topk": 5, "slac_mode": "none", "seed": 7,
}
TRAFFIC = {"fragments": 6, "stride": 2, "radius": 1.1, "height": 1.3, "frames_per_orbit": 600, "depth_noise": 0.01,
           "render_batch": 16, "drift_m": 0.01, "drift_deg": 0.2}
SEED = 2**31 + 3  # a seed whose toy chain refines every edge within the trust region
SUSPECT = 2  # the fragment the suspect case marks
STAGE_PARENTS = {"registration.stage": None, "registration.load": "registration.stage",
                 "registration.prep": "registration.stage", "registration.odometry_edges": "registration.stage",
                 "registration.gate": "registration.stage", "registration.retrieval": "registration.gate",
                 "registration.dispatch": "registration.stage", "registration.batch": "registration.dispatch",
                 "registration.drain": "registration.stage", "registration.write": "registration.stage",
                 "registration.voxel": "registration.prep", "registration.normals": "registration.prep",
                 "registration.fpfh": "registration.prep", "registration.match": "registration.batch",
                 "registration.ransac": "registration.batch", "registration.icp": "registration.batch",
                 "registration.infomat": "registration.batch"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fragments(tmp_path_factory):
    """The healthy scene's fragment directory and each fragment's centroid in its own frame."""
    root = tmp_path_factory.mktemp("scene") / "fragments"
    return root, scene.write_fragments(root, TRAFFIC, CONFIG, SEED, torch.device("cpu"))


def _case(fragments, tmp_path, suspect: bool, profiled: bool):
    """(the port's outcome, its stats, the reference's outcome, the spans the port recorded)."""
    src, _ = fragments
    shutil.copytree(src, tmp_path / "fragments")
    if suspect:
        path = tmp_path / "fragments" / f"health_{SUSPECT}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), "suspect": True}))
    cfg = program_config(CONFIG, tmp_path)
    trace.clear()
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]):
            stats = run_registration(cfg, device="cpu")
    else:
        stats = run_registration(cfg, device="cpu")
    spans = trace.records()
    trace.clear()
    got = ref.read_outcome(cfg.p_registration(), stats)
    want = ref.stage(tmp_path / "fragments", ref.Settings.of(CONFIG), torch.device("cpu"))
    return got, stats, want, spans


def _assert_agree(got, want, centroids):
    assert got.candidates == want.candidates
    assert got.suspect == want.suspect and sorted(got.loops) == sorted(want.loops)
    gaps = ref.gaps(got, want, centroids)
    assert gaps["admitted_pair_mismatches"] == gaps["suspect_edge_mismatches"] == 0
    assert gaps["accepted_pair_mismatches"] == 0
    # Tolerance: the files carry eight decimals; the two sides compute the same float32 operations on the CPU.
    for k in ("odometry_transform_gap_m", "odometry_transform_gap_rad", "transform_gap_m", "transform_gap_rad"):
        assert gaps[k] < 1e-6, (k, gaps[k])
    for k in ("odometry_information_gap", "information_gap"):
        assert gaps[k] < 1e-9, (k, gaps[k])


def test_a_healthy_chain_agrees_with_the_reference_and_records_no_span(fragments, tmp_path):
    got, stats, want, spans = _case(fragments, tmp_path, suspect=False, profiled=False)
    assert spans == []
    _assert_agree(got, want, fragments[1])
    assert want.suspect == [] and stats["gate_suspect_path"] == stats["content_repeats"] == 0
    n = TRAFFIC["fragments"]
    assert stats["gate_admitted"] == len(want.candidates) == stats["pairs"]
    assert 0 < stats["gate_admitted"] <= (n - 1) * (n - 2) // 2 and len(want.loops) > 0
    assert len(got.odometry_T) == n - 1


def test_a_suspect_fragment_is_reregistered_and_retrieved_alike(fragments, tmp_path):
    got, stats, want, spans = _case(fragments, tmp_path, suspect=True, profiled=True)
    _assert_agree(got, want, fragments[1])
    assert (SUSPECT - 1, SUSPECT) in want.suspect and (SUSPECT, SUSPECT + 1) in want.suspect
    content = stats["gate_content_admitted"]
    assert content > 0 and stats["content_repeats"] == content
    # The content pairs go through the registrar twice, then the suspect edges once.
    assert all(c == 2 for p, c in Counter(want.candidates).items() if p[1] - p[0] > CONFIG["gate_near_diagonal"])
    assert want.candidates[-len(want.suspect):] == want.suspect
    assert stats["pairs"] == stats["gate_admitted"] + 2 * content + len(want.suspect)

    by_id = {s.id: s for s in spans}
    for s in spans:
        want_parent = STAGE_PARENTS[s.name]
        if want_parent is None:
            assert s.parent is None
        else:
            assert by_id[s.parent].name == want_parent, s.name
    (root,) = [s for s in spans if s.parent is None]
    assert all(s.root == root.id for s in spans)
    assert root.counters == {"fragments": TRAFFIC["fragments"], "pairs": stats["pairs"],
                             "odometry_edges": stats["odometry_edges"]}
    n = Counter(s.name for s in spans)
    assert all(n[f"registration.{k}"] == 1 for k in ("stage", "load", "prep", "odometry_edges", "gate", "retrieval",
                                                      "dispatch", "drain", "write"))
    batch = CONFIG["registration_batch"]
    assert n["registration.batch"] == -(-stats["pairs"] // batch)
    assert sum(s.counters.get("pairs", 0) for s in spans if s.name == "registration.batch") == stats["pairs"]
    (retrieval,) = [s for s in spans if s.name == "registration.retrieval"]
    assert retrieval.counters == {"content_pairs": content}
    (edges,) = [s for s in spans if s.name == "registration.odometry_edges"]
    assert edges.counters.get("icp_steps", 0) > 0  # the odometry edges' ICP counts its steps there

