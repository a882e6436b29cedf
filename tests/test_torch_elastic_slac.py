"""PyTorch port: the FragmentOptimizer (``elastic/slac.py``) vs the JAX package on the CPU.

The fixtures of ``tests/test_distortion_recovery.py`` (24 orbit fragments,
exact correspondences of distorted points) and ``tests/test_nonrigid_recovery.py``
(the same with per-fragment lattice warps), cut to 256 rows an edge, go
through both packages' ``optimize_fragments`` in rigid, slac and nonrigid
mode, point-to-point and point-to-plane (seeded unit normals). The port's
conjugate gradient sums in another order (fixed-order segment sums, its own
reduction trees), so the two agree to float32 rounding carried through 5-10
Gauss-Newton steps of 48 CG iterations (which stop short of convergence,
so their rounding paths part), not to the bit. Tolerances: poses within
2e-4 (matrix entries: 0.2 mm, 0.2 mrad; the largest difference seen is 8e-5,
in rigid mode, whose pose-0 anchor weighs 1e6), displacements within 1e-4 m
(seen: 6e-5 of up to 7 cm), data RMSE per step and final RMSE within 5e-5
relative plus 2 um (seen: 1.3e-5 relative; 1 um where the nonrigid solve
converges to 0.37 mm).

One ``_pcg`` solve is also held against a dense ``torch.linalg.solve`` of the
same normal equations, assembled column by column from ``J``, in float64 at
a toy size: 200 CG iterations reach the solution within 1e-8 relative.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticreconstruction_tpu.elastic import slac as j_slac
from elasticreconstruction_tpu.elastic.correspondence import CorresSet as JCorresSet
from elasticreconstruction_tpu.synthetic import distortion as j_dist
from elasticreconstruction_tpu_torch import interop
from elasticreconstruction_tpu_torch.elastic import slac as t_slac
from elasticreconstruction_tpu_torch.elastic.lattice import Lattice

sys.path.insert(0, str(Path(__file__).parent))
import test_distortion_recovery as fixture_d  # noqa: E402
import test_nonrigid_recovery as fixture_n  # noqa: E402

POSE_ATOL, DISP_ATOL, RMSE_RTOL, RMSE_ATOL = 2e-4, 1e-4, 5e-5, 2e-6
CAP = 256


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cut(corres, cap=CAP):
    """The first ``cap`` rows of each 512-row edge."""
    keep = (np.arange(corres.p.shape[0]) % 512) < cap
    return JCorresSet(*(None if x is None else jnp.asarray(np.asarray(x)[keep]) for x in corres))


@pytest.fixture(scope="module")
def problems():
    dist = j_dist.make_distortion(3, radial_a=0.03, depth_b=0.008, grid_sigma=0.01)
    poses_d, corres_d = fixture_d._make_distorted_problem(dist)
    poses_n, _, corres_n = fixture_n._make_warped_problem()
    rng = np.random.default_rng(5)
    corres_d, corres_n = _cut(corres_d), _cut(corres_n)
    n = rng.normal(size=(corres_d.p.shape[0], 3)).astype(np.float32)
    normals = jnp.asarray(n / np.linalg.norm(n, axis=1, keepdims=True))
    return {"distorted": (poses_d, corres_d), "warped": (poses_n, corres_n), "normals": normals}


CASES = [
    ("distorted", "rigid", {}),
    ("distorted", "slac", dict(disp_prior_weight=0.01, arap_weight=1.0, outer_iterations=8)),
    ("warped", "nonrigid", dict(disp_prior_weight=0.003, arap_weight=0.3, outer_iterations=10)),
]


@pytest.mark.parametrize("point_to_plane", [False, True])
@pytest.mark.parametrize("fixture,mode,kw", CASES)
def test_optimize_fragments_matches_jax(problems, fixture, mode, kw, point_to_plane):
    poses, corres = problems[fixture]
    if point_to_plane:
        corres = corres._replace(n=problems["normals"], w=jnp.linspace(0.5, 2.0, corres.p.shape[0]))
    jcfg = j_slac.SlacConfig(mode=j_slac.SlacMode(mode), **kw)
    want = j_slac.optimize_fragments(poses, corres, jcfg, num_fragments=24)
    tcfg = t_slac.SlacConfig(**{**jcfg._asdict(), "mode": t_slac.SlacMode(mode)})
    got = t_slac.optimize_fragments(torch.from_numpy(np.array(poses)),
                                    interop.corres_from_numpy(corres, device="cpu"), tcfg, num_fragments=24)
    assert got.poses.shape == (24, 4, 4) and got.displacement.shape == np.asarray(want.displacement).shape
    assert got.lattice == interop.lattice_from(want.lattice)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses), atol=POSE_ATOL)  # tolerance: 2e-4
    np.testing.assert_allclose(got.displacement.numpy(), np.asarray(want.displacement),
                               atol=DISP_ATOL)  # tolerance: 1e-4 m
    # tolerance: 5e-5 relative + 2 um
    np.testing.assert_allclose(got.data_rmse.numpy(), np.asarray(want.data_rmse), rtol=RMSE_RTOL, atol=RMSE_ATOL)
    np.testing.assert_allclose(float(got.final_rmse), float(want.final_rmse), rtol=RMSE_RTOL, atol=RMSE_ATOL)
    if mode == "rigid":
        assert float(got.displacement.abs().max()) == 0.0
    else:
        assert float(got.displacement.abs().max()) > 1e-3  # the lattice moved
    res = interop.slac_result_from(want, device="cpu")
    assert res.lattice == got.lattice and torch.equal(res.poses, torch.from_numpy(np.asarray(want.poses)))


def test_pcg_solves_the_normal_equations():
    """``_pcg`` against a dense solve of ``J^T J z = -J^T r`` in float64 at a toy size:
    3 fragments, a 2-cell lattice per fragment (nonrigid), 60 point-to-plane rows."""
    torch.set_default_dtype(torch.float64)
    try:
        rng = np.random.default_rng(0)
        nf, c = 3, 60
        lat = Lattice(2, 2.0, (-1.0, -1.0, -1.0))
        fi = torch.from_numpy(rng.integers(0, nf - 1, c))
        fj = fi + 1
        p = torch.from_numpy(rng.uniform(-0.9, 0.9, (c, 3)))
        q = p + torch.from_numpy(rng.normal(0, 0.01, (c, 3)))
        n = torch.from_numpy(rng.normal(size=(c, 3)))
        corres = t_slac.CorresSet(fi.int(), fj.int(), p, q, torch.ones(c, dtype=torch.bool),
                                  n / n.norm(dim=1, keepdim=True), torch.from_numpy(rng.uniform(0.5, 2.0, c)))
        cfg = t_slac.SlacConfig(mode=t_slac.SlacMode.NONRIGID, resolution=2, length=2.0, origin=(-1.0, -1.0, -1.0),
                                cg_iterations=200)
        L, M = nf, lat.num_vertices
        state = t_slac.SlacState(torch.eye(4).repeat(nf, 1, 1),
                                 torch.from_numpy(rng.normal(0, 0.01, (L, M, 3))))
        prob = t_slac._precompute(lat, corres, cfg.mode, nf)
        J, Jt, diag, residuals, _ = t_slac._make_operators(state, corres, prob, lat, cfg, nf, L, M, True)
        x_xi, x_d = t_slac._pcg(J, Jt, diag, residuals, cfg)

        def flat(xi, d):
            return torch.cat([xi.reshape(-1), d.reshape(-1)])

        def unflat(z):
            return z[: 6 * nf].reshape(nf, 6), z[6 * nf:].reshape(L, M, 3)

        size = 6 * nf + 3 * L * M
        A = torch.stack([flat(*Jt(*J(unflat(e)))) for e in torch.eye(size)], 1)
        b = -flat(*Jt(*residuals))
        z = torch.linalg.solve(A, b)
        got = flat(x_xi, x_d)
        assert torch.linalg.norm(got - z) <= 1e-8 * torch.linalg.norm(z), (
            torch.linalg.norm(got - z) / torch.linalg.norm(z))  # tolerance: 1e-8 relative
    finally:
        torch.set_default_dtype(torch.float32)
