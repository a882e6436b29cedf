"""PyTorch port, the harness: the CLI's ``--profile``, the k-NN kernel variants
off the pipeline's path, and ``tools/ring_scale.py``, on the CPU.

- ``kernels/knn.py::nearest_auto`` against the JAX package's on
  ``tests/test_kernels.py``-style inputs from a numpy seed: indices equal, d2
  within 1e-6; CPU tensors launch nothing.
- ``kernels/normals.py::estimate_normals`` against the JAX package's on the
  inputs of ``tests/test_kernels.py:111,124,180``: normals within 1e-4 up to
  sign, the same zero (degenerate) normals.
- ``kernels/fpfh.py::fpfh`` against the JAX package's on the inputs of
  ``tests/test_kernels.py:193,257,297``: the 0-100 histogram bins within 1e-4
  absolute (the distance matrix is the reference's multiply-adds, so the same
  neighbours drop out as the self pair and no bin edge is crossed).
- ``run register --profile DIR --device cpu`` writes one Chrome trace under
  ``DIR/register/`` that parses as JSON, and prints where.
- ``ring_scale.run`` at world size 2 under gloo, and at 1 with its lanes
  registered in batches of 4, on two sequences' toy fragment directories,
  with the JAX ring's per-pair draws: every wanted pair in exactly one lane,
  and the successful pairs those of the port's replicated enumeration and of
  the JAX ring on ``make_mesh(2)`` over the same prep.
- ``ring.lanes_wanted`` against that JAX ring's mask, wherever its
  ``success`` shows the mask; the port's ring at world size 1 in batches of 4
  against it pair by pair: transforms within 1e-3, information within 1e-3
  relative.
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticreconstruction_tpu.core.types import PointCloud as JCloud
from elasticreconstruction_tpu.kernels import fpfh as j_fpfh
from elasticreconstruction_tpu.kernels import knn as j_knn
from elasticreconstruction_tpu.kernels import normals as j_normals
from elasticreconstruction_tpu_torch.bench_scene import write_fragments_dir
from elasticreconstruction_tpu_torch.core import io_logfmt
from elasticreconstruction_tpu_torch.core.types import PointCloud as TCloud
from elasticreconstruction_tpu_torch.dist import ring as t_ring
from elasticreconstruction_tpu_torch.kernels import fpfh as t_fpfh
from elasticreconstruction_tpu_torch.kernels import knn as t_knn
from elasticreconstruction_tpu_torch.kernels import normals as t_normals
from elasticreconstruction_tpu_torch.kernels.cuda import nn as t_nn
from elasticreconstruction_tpu_torch.pipeline import run
from elasticreconstruction_tpu_torch.registration import RegistrationConfig, prep_fragments_batch, register_prepped_batch
from elasticreconstruction_tpu_torch.tools import ring_scale

NORMAL_ATOL = 1e-4
FPFH_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread (ring_scale's ranks share it): under several test
    workers torch's spinning thread pools slow every test many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(np.asarray(x))) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def test_nearest_auto_matches_jax_and_launches_nothing_on_the_cpu():
    rng = np.random.default_rng(26)
    q = rng.uniform(-2, 2, (700, 3)).astype(np.float32)
    r = rng.uniform(-2, 2, (900, 3)).astype(np.float32)
    m = np.ones(900, bool)
    m[800:] = False
    d_j, i_j = j_knn.nearest_auto(*_j(q, r, m))
    before = t_nn.launches
    d_t, i_t = t_knn.nearest_auto(*_t(q, r, m))
    assert t_nn.launches == before
    assert i_t.dtype == torch.int32 and i_t.shape == (700,)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-6)
    with pytest.raises(ValueError, match="unsupported device"):
        t_knn.nearest_auto(*(x.to("meta") for x in _t(q, r, m)))


def _plane():
    rng = np.random.default_rng(3)
    xy = rng.uniform(-1, 1, size=(256, 2)).astype(np.float32)
    return np.concatenate([xy, np.full((256, 1), 2.0, np.float32)], axis=1)


def _sphere():
    rng = np.random.default_rng(4)
    v = rng.normal(size=(512, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return np.array([0.0, 0.0, 3.0], np.float32) + v


def _wavy(seed: int, n: int):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, n).astype(np.float32)
    y = rng.uniform(-1, 1, n).astype(np.float32)
    z = (0.3 * np.sin(2 * x) * np.cos(2 * y)).astype(np.float32)
    return np.stack([x, y, z + 2.0], 1)


# tests/test_kernels.py:111 (plane, k 12), :124 (sphere, k 16), :180 (surface, k 16),
# and the surface with a radius cap and a masked tail.
NORMAL_CASES = {
    "plane": (_plane, 12, None, 0),
    "sphere": (_sphere, 16, None, 0),
    "surface": (lambda: _wavy(13, 2000), 16, None, 0),
    "surface_radius_masked": (lambda: _wavy(13, 2000), 16, 0.12, 100),
}


@pytest.mark.parametrize("case", sorted(NORMAL_CASES))
def test_estimate_normals_matches_jax(case):
    make, k, radius, tail = NORMAL_CASES[case]
    pts = make()
    mask = np.ones(len(pts), bool)
    mask[len(pts) - tail:] = False
    zeros = np.zeros_like(pts)
    want = np.asarray(j_normals.estimate_normals(JCloud(*_j(pts, zeros, mask)), k=k, radius=radius).normals)
    got = t_normals.estimate_normals(TCloud(*_t(pts, zeros, mask)), k=k, radius=radius)
    a = got.normals.numpy()
    assert torch.equal(got.points, torch.from_numpy(pts)) and torch.equal(got.mask, torch.from_numpy(mask))
    np.testing.assert_array_equal(np.abs(a).sum(1) == 0, np.abs(want).sum(1) == 0)
    err = np.minimum(np.abs(a - want).max(1), np.abs(a + want).max(1))
    assert err.max() < NORMAL_ATOL, err.max()


def _random_unit(seed: int, n: int):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    return pts, nrm / np.linalg.norm(nrm, axis=1, keepdims=True)


def _knn_normals(seed: int, n: int, k: int):
    pts = np.random.default_rng(seed).uniform(-1, 1, size=(n, 3)).astype(np.float32)
    return pts, np.asarray(j_normals.estimate_normals(JCloud.from_points(pts), k=k).normals)


def _radius_normals():
    pts = _wavy(14, 1500)
    return pts, np.asarray(j_normals.estimate_normals_radius(JCloud.from_points(pts), 0.12).normals)


# tests/test_kernels.py:193 (40 random points, k 8), :257 (128 points with k-NN
# normals, k 10), :297 (the radius-normal surface, k 48 capped at 0.25).
FPFH_CASES = {
    "random_k8": (lambda: _random_unit(5, 40), 8, None),
    "knn_normals_k10": (lambda: _knn_normals(6, 128, 10), 10, None),
    "surface_k48_radius": (_radius_normals, 48, 0.25),
}


@pytest.mark.parametrize("case", sorted(FPFH_CASES))
def test_fpfh_matches_jax(case):
    make, k, radius = FPFH_CASES[case]
    pts, nrm = make()
    mask = np.ones(len(pts), bool)
    want = np.asarray(j_fpfh.fpfh(JCloud(*_j(pts, nrm, mask)), k=k, radius=radius))
    got = t_fpfh.fpfh(TCloud(*_t(pts, nrm, mask)), k=k, radius=radius).numpy()
    assert got.shape == (len(pts), 33) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=FPFH_ATOL)
    np.testing.assert_allclose(got.reshape(-1, 3, 11).sum(-1), 100.0, atol=1e-3)


def test_profile_writes_a_chrome_trace_of_the_stage(tmp_path, capsys):
    write_fragments_dir(tmp_path, 3, n=1500)
    trace_root = tmp_path / "traces"
    code = run.main(["register", "--out", str(tmp_path), "--device", "cpu", "--preset", "fast",
                     "--profile", str(trace_root)])
    assert code == 0
    assert f"profiler trace written under {trace_root / 'register'}" in capsys.readouterr().out
    traces = list((trace_root / "register").glob("*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert (tmp_path / "registration" / "loop.log").exists()
    assert "--profile" in run.build_parser().format_help()


# Two sequences of sliding windows over one bumped wavy surface (the
# generator of tests/test_ring.py): windows overlap within a sequence and
# across the two, so the ring registers pairs of both kinds.
RING_REG = dict(coarse_capacity=1024, fine_capacity=1024, num_hypotheses=256, icp_iterations=6)


def _windows(seed: int, f: int, n: int = 1200, slide: float = 0.3) -> list[np.ndarray]:
    rng, brng = np.random.default_rng(seed), np.random.default_rng(99)
    span = -1.5 + slide * f + 1.5
    nb = max(8, int(4 * span))
    bc = np.stack([brng.uniform(-1.5, span, nb), brng.uniform(-1.5, 1.5, nb)], 1).astype(np.float32)
    bh = brng.uniform(0.15, 0.4, nb).astype(np.float32) * brng.choice([-1, 1], nb)
    out = []
    for k in range(f):
        x0 = -1.5 + slide * k
        x = rng.uniform(x0, x0 + 1.5, n).astype(np.float32)
        y = rng.uniform(-1.5, 1.5, n).astype(np.float32)
        z = (0.35 * np.sin(2.3 * x) * np.cos(1.7 * y) + 0.2 * np.sin(4.1 * y)).astype(np.float32)
        d2 = (x[:, None] - bc[None, :, 0]) ** 2 + (y[:, None] - bc[None, :, 1]) ** 2
        z = z + (bh[None, :] * np.exp(-d2 / (2 * 0.18**2))).sum(1).astype(np.float32)
        out.append(np.stack([x, y, z], 1))
    return out


@pytest.fixture(scope="module")
def ring_case(tmp_path_factory):
    """The two sequences' fragment directories; their prep by the port (as
    ``ring_scale.run`` preps them); every (lo <= hi) pair's JAX draws
    (``jax.random.randint`` under the JAX ring's ``pair_key``), as a table
    ``ring_scale.run`` takes; and the JAX ring on ``make_mesh(2)`` over the
    same prep."""
    import jax

    from elasticreconstruction_tpu.dist import make_mesh
    from elasticreconstruction_tpu.dist import ring as j_ring
    from elasticreconstruction_tpu.registration import pair as j_pair

    root = tmp_path_factory.mktemp("ring_scale")
    dirs = []
    for s in range(2):
        d = root / f"seq{s}" / "fragments"
        d.mkdir(parents=True)
        for f, pts in enumerate(_windows(3 + s, 3)):
            io_logfmt.write_pcd(d / f"cloud_bin_{f}.pcd", pts, np.zeros_like(pts))
        dirs.append(str(d))
    cfg = RegistrationConfig(**RING_REG)
    clouds, _ = ring_scale.load_clouds(dirs, 1)
    prepped = prep_fragments_batch(clouds, cfg, device="cpu")
    f = prepped.features.shape[0]
    jcfg = j_pair.RegistrationConfig(**RING_REG)
    jprep = j_pair.PreppedFragments(JCloud(*_j(*(x.numpy() for x in prepped.coarse))),
                                    jnp.asarray(prepped.features.numpy()),
                                    JCloud(*_j(*(x.numpy() for x in prepped.fine))))
    base = jax.random.PRNGKey(ring_scale.BASE_KEY)
    lo, hi = np.triu_indices(f)
    keys = jax.vmap(lambda a, b: j_ring.pair_key(base, a, b))(jnp.asarray(lo), jnp.asarray(hi))
    flat = np.array(jax.vmap(lambda k: jax.random.randint(k, (jcfg.num_hypotheses, 3), 0, 1 << 30))(keys))
    draws = np.zeros((f, f, jcfg.num_hypotheses, 3), np.int64)
    draws[lo, hi] = flat
    jres = j_ring.register_all_pairs_ring(jprep, base, make_mesh(2), jcfg)
    return {"dirs": dirs, "cfg": cfg, "jcfg": jcfg, "prepped": prepped, "f": f, "draws": draws,
            "jax_ring": {k: np.asarray(v) for k, v in jres._asdict().items()}}


def _success_pairs(res: dict) -> list[list[int]]:
    return sorted([int(i), int(j)] for i, j, ok in zip(res["i"], res["j"], res["success"]) if ok)


@pytest.mark.parametrize("ranks,lane_batch", [(2, t_ring.LANE_BATCH), (1, 4)], ids=["D2", "D1_batches_of_4"])
def test_ring_scale_matches_the_replicated_enumeration(ring_case, monkeypatch, ranks, lane_batch):
    """At two spawned gloo ranks, and at one in this process with each step's
    36 lanes registered 4 at a time (``ring.LANE_BATCH``), with the JAX
    ring's draws: the port's replicated enumeration and the JAX ring on
    ``make_mesh(2)`` accept the same pairs."""
    monkeypatch.setattr(t_ring, "LANE_BATCH", lane_batch)
    cfg, dirs, draws = ring_case["cfg"], ring_case["dirs"], ring_case["draws"]
    rep = ring_scale.run(dirs, stride=1, ranks=ranks, backend="gloo", device="cpu", cfg=cfg, draws=draws)
    f = rep["fragments"]
    assert (f, rep["fragments_padded"], rep["devices"]) == (6, 6, ranks)
    assert rep["lanes_per_device"] == {2: 18, 1: 36}[ranks]
    assert rep["pairs_wanted"] == rep["pairs_covered"] == 10
    assert rep["pairs_missing"] == 0 and rep["pairs_in_two_lanes"] == 0
    assert sum(rep["per_device_useful_pairs"]) == 10
    assert rep["memory_ratio_vs_replicated"] == 1.0 and rep["per_device_peak_bytes_ring"] is None
    # The replicated enumeration of the same prep with the same per-pair draws.
    pairs = [(i, j) for i in range(f) for j in range(i + 2, f)]
    lo, hi = torch.tensor([p[0] for p in pairs]), torch.tensor([p[1] for p in pairs])
    res = register_prepped_batch(ring_case["prepped"], lo, hi, None, cfg, device="cpu",
                                 draws=torch.stack([torch.from_numpy(draws[i, j]) for i, j in pairs]))
    want = [list(p) for p, ok in zip(pairs, res.success.tolist()) if ok]
    assert rep["success_pairs"] == want == _success_pairs(ring_case["jax_ring"])
    assert rep["successes"] == len(want) and rep["successes_intra_sequence"] > 0
    assert rep["successes_cross_sequence"] == rep["successes"] - rep["successes_intra_sequence"]


def test_ring_lanes_wanted_is_the_jax_rings_mask(ring_case):
    """``ring.lanes_wanted(2, 6)`` against the JAX ring on ``make_mesh(2)``:
    its unmasked lanes hold every wanted pair once in the JAX ring's lane
    order, and on every lane whose registration passes the success criterion
    (so that the JAX ring's ``success`` shows its mask) the JAX ring reports
    success exactly where ``lanes_wanted`` keeps the lane. Such lanes include
    adjacent pairs, the second ordering of intra-block pairs at step 0 and the
    mutual step's copies on the higher-base rank, each of which must be masked."""
    jr, cfg, f = ring_case["jax_ring"], ring_case["jcfg"], ring_case["f"]
    want = t_ring.lanes_wanted(2, f)
    assert want.shape == jr["i"].shape == (2 * 2 * (f // 2) ** 2,)
    kept = sorted(zip(jr["i"][want].tolist(), jr["j"][want].tolist()))
    assert kept == [(i, j) for i in range(f) for j in range(i + 2, f)]
    passed = ((jr["num_inliers"] >= cfg.min_inliers) & (jr["fitness"] >= cfg.min_fitness)
              & np.isfinite(jr["transform"]).all((1, 2)))
    np.testing.assert_array_equal(jr["success"][passed], want[passed])
    adjacent = np.abs(jr["j"] - jr["i"]) <= 1
    dup = ~want & ~adjacent  # a wanted pair's other lane
    assert (passed & want).any() and (passed & adjacent).any() and (passed & dup).any()
    assert not jr["success"][~want].any()


def test_ring_batches_of_4_match_the_jax_ring(ring_case, monkeypatch, tmp_path):
    """The port's ring at world size 1, each step's 36 lanes registered 4 at a
    time, against the JAX ring on the same prep and draws, pair by pair: the
    same successes, transforms within 1e-3 and information within 1e-3
    relative (the port against JAX, as ``tests/test_torch_ring.py``)."""
    from elasticreconstruction_tpu_torch.dist import mesh as t_mesh

    monkeypatch.setattr(t_ring, "LANE_BATCH", 4)
    draws = ring_case["draws"]
    group = t_mesh.init_group("gloo", 1, 0, "file://" + str(tmp_path / "store"))
    try:
        res = t_ring.register_all_pairs_ring(ring_case["prepped"], ring_scale.BASE_KEY, ring_case["cfg"],
                                             draws_for=lambda i, j: torch.from_numpy(draws[i, j]),
                                             group=group, device="cpu")
    finally:
        torch.distributed.destroy_process_group()
    got = {k: v.numpy() for k, v in res._asdict().items()}
    jr = ring_case["jax_ring"]
    assert _success_pairs(got) == _success_pairs(jr)

    def by_pair(r):
        return {(int(i), int(j)): k for k, (i, j, ok) in enumerate(zip(r["i"], r["j"], r["success"])) if ok}

    jk = by_pair(jr)
    for pair, k in by_pair(got).items():
        np.testing.assert_allclose(got["transform"][k], jr["transform"][jk[pair]], atol=1e-3)  # tolerance: 1e-3
        info = jr["information"][jk[pair]]
        assert np.abs(got["information"][k] - info).max() / np.abs(info).max() < 1e-3  # tolerance: 1e-3 relative
