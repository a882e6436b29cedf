"""PyTorch port, the registration ring on gloo ranks vs the JAX package's, on the CPU.

The counterparts of ``tests/test_ring.py``, on its first fixture (8 sliding
windows of a bumped wavy surface, 1200 points; its reduced configuration cut
further to 256 hypotheses and 6 ICP steps, which still registers 7 of the 21
pairs), prepped by the JAX package. Every pair's RANSAC draws are the JAX ring's
(``jax.random.randint`` under ``ring.pair_key(base, lo, hi)``), handed to the
port's ring as its per-pair source. The port runs at D = 2 (four fragments a
rank: intra-block pairs at step 0 and the mutual step) and D = 4 (two a rank,
the mutual step at s = 2) in spawned gloo ranks, the JAX side meanwhile in
this process. Tolerances, each beside its assertion:

- against the port's replicated enumeration (``register_prepped_batch`` on
  the wanted pairs with the same draws): success equal, transforms within
  1e-5 and information within rtol 1e-4 / atol 1e-2 (``tests/test_ring.py``);
- against the JAX package's replicated enumeration and its ring on
  ``make_mesh(D)``: success equal, transforms within 1e-3, information within
  1e-3 relative (the port against JAX, as ``tests/test_torch_slice.py``);
- every wanted pair in exactly one unmasked lane, no duplicate among the
  successes, successful intra-block pairs at D = 2.

The ring's lanes at world size 1, and at 2 on the card, equal
``register_prepped_batch`` on the same lanes batched as the ring ran them bit
for bit; ``chip_smoke.py``'s dist phase holds that at full width.

The spawned ranks import this module by name, so it imports JAX inside its
fixtures only.
"""

from __future__ import annotations

import concurrent.futures
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from elasticreconstruction_tpu_torch.core.types import PointCloud
from elasticreconstruction_tpu_torch.dist import mesh as t_mesh
from elasticreconstruction_tpu_torch.dist import ring as t_ring
from elasticreconstruction_tpu_torch.registration import PreppedFragments, RegistrationConfig, register_prepped_batch

TESTS = Path(__file__).resolve().parent
F = 8
RANKS = [2, 4]
BASE = 11
REG = dict(coarse_capacity=1024, fine_capacity=1024, num_hypotheses=256, icp_iterations=6)
WANTED = [(i, j) for i in range(F) for j in range(i + 2, F)]
TIMEOUT_S = 240.0


def _prepped(x: dict) -> PreppedFragments:
    def cloud(key):
        return PointCloud(*(torch.from_numpy(x[f"{key}_{f}"]) for f in PointCloud._fields))

    return PreppedFragments(cloud("coarse"), torch.from_numpy(x["features"]), cloud("fine"))


def _draws_for(x: dict):
    def draws_for(i, j):
        return torch.from_numpy(x["draws"][i, j])

    return draws_for


def _as_numpy(res) -> dict:
    return {k: v.numpy() for k, v in res._asdict().items()}


def run_ring(group, dev: torch.device, x: dict) -> dict:
    res = t_ring.register_all_pairs_ring(_prepped(x), BASE, RegistrationConfig(**REG), draws_for=_draws_for(x),
                                         group=group, device=dev)
    return _as_numpy(res)


def _rank_main(rank: int, group, dev: torch.device, inputs: str) -> dict:
    with np.load(inputs) as f:
        return run_ring(group, dev, dict(f))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The JAX-prepped fixture and every (lo <= hi) pair's JAX draws."""
    import jax
    import jax.numpy as jnp

    from elasticreconstruction_tpu.dist import ring as j_ring
    from elasticreconstruction_tpu.registration import pair as j_pair

    sys.path.insert(0, str(TESTS))
    from test_ring import _fragment_stack

    cfg = j_pair.RegistrationConfig(**REG)
    jprep = j_pair.prep_fragments_batch(_fragment_stack(np.random.default_rng(3), F), cfg)
    x = {f"{side}_{f}": np.array(getattr(getattr(jprep, side), f)) for side in ("coarse", "fine")
         for f in PointCloud._fields}
    x["features"] = np.array(jprep.features)
    base = jax.random.PRNGKey(BASE)
    lo, hi = np.triu_indices(F)
    keys = jax.vmap(lambda a, b: j_ring.pair_key(base, a, b))(jnp.asarray(lo), jnp.asarray(hi))
    flat = np.array(jax.vmap(lambda k: jax.random.randint(k, (cfg.num_hypotheses, 3), 0, 1 << 30))(keys))
    x["draws"] = np.zeros((F, F, cfg.num_hypotheses, 3), np.int64)
    x["draws"][lo, hi] = flat
    path = tmp_path_factory.mktemp("ring_inputs") / "inputs.npz"
    np.savez(path, **x)
    return {"x": x, "path": str(path), "jprep": jprep, "cfg": cfg, "base": base}


@pytest.fixture(scope="module")
def replicated(case):
    """The JAX and port replicated enumerations of the wanted pairs with the
    same per-pair draws."""
    import jax.numpy as jnp

    from elasticreconstruction_tpu.dist import ring as j_ring
    from elasticreconstruction_tpu.registration import pair as j_pair

    x = case["x"]
    ii = np.array([i for i, _ in WANTED], np.int32)
    jj = np.array([j for _, j in WANTED], np.int32)
    keys = jnp.stack([j_ring.pair_key(case["base"], i, j) for i, j in WANTED])
    jax_rep = j_pair.register_prepped_batch(case["jprep"], jnp.asarray(ii), jnp.asarray(jj), keys, case["cfg"])
    port_rep = register_prepped_batch(_prepped(x), ii, jj, None, RegistrationConfig(**REG),
                                      draws=torch.stack([_draws_for(x)(i, j) for i, j in WANTED]), device="cpu")
    return {"jax": {k: np.asarray(v) for k, v in jax_rep._asdict().items()}, "port": _as_numpy(port_rep)}


@pytest.fixture(scope="module", params=RANKS, ids=lambda d: f"D{d}")
def ranks(request, case):
    """The port's ring at D ranks (every rank's result must be the same) and
    the JAX ring on make_mesh(D), computed while the ranks run."""
    from elasticreconstruction_tpu.dist import make_mesh
    from elasticreconstruction_tpu.dist import ring as j_ring

    d = request.param
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        running = pool.submit(t_mesh.spawn_ranks, _rank_main, d, "gloo", "cpu", case["path"],
                              timeout_s=TIMEOUT_S, threads=1)
        jres = j_ring.register_all_pairs_ring(case["jprep"], case["base"], make_mesh(d), case["cfg"])
        jres = {k: np.asarray(v) for k, v in jres._asdict().items()}
        results = running.result()
    for other in results[1:]:
        for k, v in results[0].items():
            np.testing.assert_array_equal(other[k], v)
    return {"d": d, "port": results[0], "jax": jres}


def _by_pair(res: dict) -> dict:
    """(i, j) -> lane of each successful lane; asserts each appears once."""
    succ = [(int(i), int(j)) for i, j, ok in zip(res["i"], res["j"], res["success"]) if ok]
    assert len(succ) == len(set(succ)), "duplicate (i, j) among successful lanes"
    assert all(j > i + 1 for i, j in succ)
    return {p: k for k, p in enumerate(zip(res["i"].tolist(), res["j"].tolist())) if res["success"][k]}


def _agree(got: dict, k: int, want: dict, b: int, port: bool) -> None:
    if port:
        np.testing.assert_allclose(got["transform"][k], want["transform"][b], atol=1e-5)  # tolerance: 1e-5
        np.testing.assert_allclose(got["information"][k], want["information"][b], rtol=1e-4, atol=1e-2)
    else:
        np.testing.assert_allclose(got["transform"][k], want["transform"][b], atol=1e-3)  # tolerance: 1e-3
        info = want["information"][b]
        assert np.abs(got["information"][k] - info).max() / np.abs(info).max() < 1e-3  # tolerance: 1e-3 relative


def test_ring_matches_replicated_all_pairs(ranks, replicated):
    got = ranks["port"]
    by_pair = _by_pair(got)
    n_match = 0
    for b, pair in enumerate(WANTED):
        k = by_pair.get(pair)
        assert (k is not None) == bool(replicated["port"]["success"][b]) == bool(replicated["jax"]["success"][b]), pair
        if k is not None:
            _agree(got, k, replicated["port"], b, port=True)
            _agree(got, k, replicated["jax"], b, port=False)
            n_match += 1
    assert n_match >= 3  # the sliding windows give several true overlaps
    # The JAX ring on make_mesh(D) accepts the same pairs, with the same edges.
    jax_by_pair = _by_pair(ranks["jax"])
    assert set(jax_by_pair) == set(by_pair)
    for pair, k in by_pair.items():
        _agree(got, k, ranks["jax"], jax_by_pair[pair], port=False)


def test_ring_lanes_cover_every_pair_once(ranks):
    got, d = ranks["port"], ranks["d"]
    fl = F // d
    assert got["i"].shape == (d * (d // 2 + 1) * fl * fl,)
    lanes = {(int(a), int(b)) for a, b in zip(got["i"], got["j"]) if b > a + 1}
    assert lanes == set(WANTED)
    succ = _by_pair(got)
    if d == 2:  # four fragments a rank: intra-block pairs, kept once at step 0
        assert [p for p in succ if p[0] // fl == p[1] // fl], "expected successful intra-block pairs"


def test_pair_key_is_fixed_by_the_pair():
    a = t_ring.pair_key(7, 2, 5, 64)
    assert a.shape == (64, 3) and a.dtype == torch.int64 and 0 <= int(a.min()) and int(a.max()) < 1 << 30
    assert torch.equal(a, t_ring.pair_key(7, 2, 5, 64))
    assert not torch.equal(a, t_ring.pair_key(7, 5, 2, 64)) and not torch.equal(a, t_ring.pair_key(8, 2, 5, 64))
