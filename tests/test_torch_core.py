"""PyTorch port, core: SE(3) algebra, containers and reference file formats vs the JAX package.

Inputs are made with numpy from fixed seeds and fed to both packages on the
CPU; tolerances are f32 rounding bounds for the ops compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticreconstruction_tpu.core import io_logfmt as j_io
from elasticreconstruction_tpu.core import se3 as j_se3
from elasticreconstruction_tpu.core import types as j_types
from elasticreconstruction_tpu_torch.core import io_logfmt as t_io
from elasticreconstruction_tpu_torch.core import se3 as t_se3
from elasticreconstruction_tpu_torch.core import types as t_types


def _twists(rng, n=64):
    xi = rng.uniform(-1.0, 1.0, (n, 6)).astype(np.float32)
    xi[:4, 3:] = 0.0  # identity rotation: the small-angle branches
    xi[4:8, 3:] *= 1e-4
    axis = rng.normal(size=(4, 3))
    xi[8:12, 3:] = (axis / np.linalg.norm(axis, axis=1, keepdims=True) * (np.pi - 3e-3)).astype(np.float32)
    return xi


def _poses(rng, n=64):
    return np.asarray(j_se3.exp(jnp.asarray(_twists(rng, n))))


def _cases():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(64, 50, 3)).astype(np.float32)
    return {
        "exp": (lambda m, x: m.exp(x), lambda: (_twists(rng),)),
        "log": (lambda m, T: m.log(T), lambda: (_poses(rng),)),
        "compose": (lambda m, a, b: m.compose(a, b), lambda: (_poses(rng), _poses(rng))),
        "inverse": (lambda m, T: m.inverse(T), lambda: (_poses(rng),)),
        "apply": (lambda m, T, p: m.apply(T, p), lambda: (_poses(rng), pts)),
        "hat": (lambda m, v: m.hat(v), lambda: (pts[0],)),
        "vee": (lambda m, v: m.vee(m.hat(v)), lambda: (pts[0],)),
    }


@pytest.mark.parametrize("op", sorted(_cases()))
def test_se3_matches_jax(op):
    fn, make = _cases()[op]
    args = make()
    want = np.asarray(fn(j_se3, *(jnp.asarray(a) for a in args)))
    got = fn(t_se3, *(torch.from_numpy(np.array(a)) for a in args)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_kabsch_matches_jax():
    """The rotation is unique when the covariance's singular values are
    distinct, so torch's U/V sign convention does not show in the result."""
    rng = np.random.default_rng(1)
    src = rng.normal(size=(8, 40, 3)).astype(np.float32) * np.array([1.0, 0.6, 0.3], np.float32)
    T = _poses(rng)[-8:]
    dst = np.array(j_se3.apply(jnp.asarray(T), jnp.asarray(src)))
    dst += rng.normal(0, 0.01, dst.shape).astype(np.float32)
    w = (rng.uniform(size=(8, 40)) > 0.3).astype(np.float32)
    for weights in (None, w):
        want = np.asarray(j_se3.kabsch(jnp.asarray(src), jnp.asarray(dst), None if weights is None else jnp.asarray(weights)))
        got = t_se3.kabsch(torch.from_numpy(src), torch.from_numpy(dst), None if weights is None else torch.from_numpy(weights)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_allclose(got, T, atol=0.05)


def test_masked_mean_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5, 30, 3)).astype(np.float32)
    m = rng.uniform(size=(5, 30)) > 0.4
    for axis in (None, 1):
        want = np.asarray(j_types.masked_mean(jnp.asarray(x), jnp.asarray(m), axis=axis))
        got = t_types.masked_mean(torch.from_numpy(x), torch.from_numpy(m), dim=axis).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _edges(rng, n=7):
    mats = rng.normal(size=(n, 4, 4)) * 10 ** rng.uniform(-3, 3, (n, 1, 1))
    infos = rng.normal(size=(n, 6, 6)) * 1e3
    return [(int(i), int(i + 1 + k), 11) for k, i in enumerate(rng.integers(0, 50, n))], mats, infos


@pytest.mark.parametrize("kind", ["log", "info"])
def test_writers_byte_identical_to_jax(tmp_path, kind):
    rng = np.random.default_rng(3)
    ids, mats, infos = _edges(rng)
    if kind == "log":
        j_io.write_log(tmp_path / "j.log", j_io.Trajectory([j_io.TrajectoryEntry(*e, m) for e, m in zip(ids, mats)]))
        t_io.write_log(tmp_path / "t.log", t_io.Trajectory([t_io.TrajectoryEntry(*e, m) for e, m in zip(ids, mats)]))
        back = t_io.read_log(tmp_path / "j.log")
        np.testing.assert_allclose(back.matrices(), mats, atol=1e-8)
    else:
        j_io.write_info(tmp_path / "j.info", j_io.InfoFile([j_io.InfoEntry(*e, m) for e, m in zip(ids, infos)]))
        t_io.write_info(tmp_path / "t.info", t_io.InfoFile([t_io.InfoEntry(*e, m) for e, m in zip(ids, infos)]))
        back = t_io.read_info(tmp_path / "j.info")
        np.testing.assert_allclose(np.stack([e.info for e in back.entries]), infos, atol=1e-8)
    assert [(e.i, e.j, e.k) for e in back.entries] == ids
    assert (tmp_path / f"j.{kind}").read_bytes() == (tmp_path / f"t.{kind}").read_bytes()


def test_readers_reject_truncated_records(tmp_path):
    rng = np.random.default_rng(4)
    ids, mats, infos = _edges(rng, 2)
    t_io.write_log(tmp_path / "a.log", t_io.Trajectory([t_io.TrajectoryEntry(*e, m) for e, m in zip(ids, mats)]))
    t_io.write_info(tmp_path / "a.info", t_io.InfoFile([t_io.InfoEntry(*e, m) for e, m in zip(ids, infos)]))
    for name, reader in (("a.log", t_io.read_log), ("a.info", t_io.read_info)):
        text = (tmp_path / name).read_text()
        (tmp_path / name).write_text(text.rsplit("\t", 1)[0])
        with pytest.raises(ValueError):
            reader(tmp_path / name)


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("with_normals", [True, False])
def test_read_pcd_round_trip(tmp_path, binary, with_normals):
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    nrm = rng.normal(size=(300, 3)).astype(np.float32) if with_normals else None
    t_io.write_pcd(tmp_path / "t.pcd", pts, nrm, binary=binary)
    j_io.write_pcd(tmp_path / "j.pcd", pts, nrm, binary=binary)
    assert (tmp_path / "t.pcd").read_bytes() == (tmp_path / "j.pcd").read_bytes()
    for path in ("t.pcd", "j.pcd"):
        p, n = t_io.read_pcd(tmp_path / path)
        atol = 0 if binary else 1e-6
        np.testing.assert_allclose(p, pts, atol=atol)
        if with_normals:
            np.testing.assert_allclose(n, nrm, atol=atol)
        else:
            assert n is None


def test_pointcloud_container():
    c = t_types.PointCloud.from_points(np.zeros((2, 5, 3), np.float32), device="cpu")
    assert c.capacity == 5 and c.count().tolist() == [5, 5]
    assert c.normals.shape == (2, 5, 3) and c.mask.dtype == torch.bool
    assert c.take(1).points.shape == (5, 3)
