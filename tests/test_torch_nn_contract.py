"""PyTorch port: the contract of the two pipeline kernels, on the CPU.

The plain versions of ``nearest_batch`` and ``normal_eqs_batch`` (which the
CUDA kernels are held to on the card by ``chip_smoke.py``) against the JAX
package at ragged sizes; the tie and sentinel rules; and the Python that
surrounds the kernels: the launch geometry, the scratch caches, the unpacking
of the fused step's one output buffer, the launch counts by shape.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticreconstruction_tpu.kernels.pallas import nn as j_pnn
from elasticreconstruction_tpu.registration.icp import _normal_eqs_xla
from elasticreconstruction_tpu_torch.kernels.cuda import build
from elasticreconstruction_tpu_torch.kernels.cuda import icp_step as t_icp_step
from elasticreconstruction_tpu_torch.kernels.cuda import nn as t_nn
from elasticreconstruction_tpu_torch.tools import nn_probe


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


# (seed, B, Nq, Nr, masked tail): multiples of nothing, one batch, fewer refs
# than one chunk of the kernel (32), a single query.
RAGGED = {
    "multiples_of_nothing": (61, 3, 333, 517, 40),
    "one_batch": (62, 1, 257, 1001, 0),
    "refs_below_one_chunk": (63, 2, 130, 20, 3),
    "one_query": (64, 2, 1, 77, 5),
}


def _cloud_pair(seed, b, nq, nr, tail):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-2, 2, (b, nq, 3)).astype(np.float32)
    r = rng.uniform(-2, 2, (b, nr, 3)).astype(np.float32)
    m = rng.uniform(size=(b, nr)) > 0.05
    m[:, nr - tail:] = False
    return q, r, m


@pytest.mark.parametrize("case", sorted(RAGGED))
def test_nearest_batch_plain_matches_pallas_at_ragged_sizes(case):
    """Indices equal, d2 within 1e-5: the FMA-shaped key and the clamp after
    the minimum move a distance by a few ulp of |r|^2 <= 12 (1e-6)."""
    q, r, m = _cloud_pair(*RAGGED[case])
    d_t, i_t = t_nn.nearest_batch_plain(*_t(q, r, m))
    d_p, i_p = j_pnn.nearest_batch(
        jnp.asarray(q), jnp.asarray(r), jnp.asarray(m), block_q=128, block_r=128, interpret=True
    )
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_p))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_p), atol=1e-5)
    assert (d_t >= 0).all()


@pytest.mark.parametrize("block_q", [1, 7, 256])
def test_nearest_batch_plain_does_not_depend_on_its_blocking(block_q):
    q, r, m = _cloud_pair(65, 2, 100, 300, 10)
    want = t_nn.nearest_batch_plain(*_t(q, r, m))
    got = t_nn.nearest_batch_plain(*_t(q, r, m), block_q=block_q)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_first_index_wins_on_duplicated_refs():
    """150 distinct refs, each at 4 indices: both packages answer inside the first 150."""
    q, r, _ = _cloud_pair(66, 2, 200, 150, 0)
    r4 = np.tile(r, (1, 4, 1))
    m4 = np.ones(r4.shape[:2], bool)
    d_t, i_t = t_nn.nearest_batch_plain(*_t(q, r4, m4))
    _, i_1 = t_nn.nearest_batch_plain(*_t(q, r, m4[:, :150]))
    _, i_p = j_pnn.nearest_batch(
        jnp.asarray(q), jnp.asarray(r4), jnp.asarray(m4), block_q=128, block_r=128, interpret=True
    )
    assert (i_t < 150).all()
    assert torch.equal(i_t, i_1)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_p))
    # With the first copies masked, the second copies win.
    m4[:, :150] = False
    _, i_2 = t_nn.nearest_batch_plain(*_t(q, r4, m4))
    assert torch.equal(i_2, i_t + 150)


def test_all_masked_refs_give_the_sentinel_in_every_batch():
    q, r, m = _cloud_pair(67, 3, 50, 90, 0)
    m[1] = False
    d_t, i_t = t_nn.nearest_batch_plain(*_t(q, r, m))
    d_p, i_p = j_pnn.nearest_batch(
        jnp.asarray(q), jnp.asarray(r), jnp.asarray(m), block_q=128, block_r=128, interpret=True
    )
    assert (d_t[1] == torch.tensor(3e38)).all() and (i_t[1] == 0).all()
    np.testing.assert_array_equal(d_t[1].numpy(), np.asarray(d_p)[1])
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_p))
    assert (d_t[0] < 1e3).all() and (d_t[2] < 1e3).all()


def test_a_query_on_a_ref_gets_zero_not_a_negative_distance():
    """The clamp is taken after the minimum: the expansion's rounding may leave
    |q|^2 + key slightly below 0 where q coincides with a ref."""
    _, r, m = _cloud_pair(68, 1, 1, 400, 0)
    m[:] = True
    q = r[:, 37:137].copy()
    d_t, i_t = t_nn.nearest_batch_plain(*_t(q, r, m))
    assert (d_t >= 0).all() and (d_t <= 1e-5).all()
    np.testing.assert_array_equal(i_t.numpy()[0], np.arange(37, 137))


def test_fma_is_rounded_once():
    """a*b + c where the product's low bit decides: a multiply then an add loses it."""
    a = torch.tensor([1.0 + 2.0**-12])
    c = torch.tensor([-1.0])
    assert t_nn._fma(a, a, c).item() == 2.0**-11 + 2.0**-24
    assert (a * a + c).item() == 2.0**-11
    assert t_nn._fma(a, a, c).dtype == torch.float32


# (seed, B, N, M, masked tail)
ICP_RAGGED = {
    "multiples_of_nothing": (71, 3, 333, 517, 40),
    "one_batch": (72, 1, 257, 1001, 0),
    "dst_below_one_chunk": (73, 2, 130, 20, 3),
}


def _icp_inputs(seed, b, n, m, tail):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    w = (rng.uniform(size=(b, n)) > 0.1).astype(np.float32)
    d = rng.uniform(-1, 1, (b, m, 3)).astype(np.float32)
    nr = rng.normal(size=(b, m, 3))
    nr = (nr / np.linalg.norm(nr, axis=-1, keepdims=True)).astype(np.float32)
    mask = np.ones((b, m), bool)
    mask[:, m - tail:] = False
    return p, w, d, nr, mask


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-9)


@pytest.mark.parametrize("case", sorted(ICP_RAGGED))
def test_normal_eqs_batch_plain_matches_xla_step_at_ragged_sizes(case):
    """Same matches (n_in exact), H, g and wrr within 1e-5 relative: summation order only."""
    args = _icp_inputs(*ICP_RAGGED[case])
    H1, g1, n1, w1 = t_icp_step.normal_eqs_batch_plain(*_t(*args), max_dist=0.5)
    H2, g2, n2, w2 = _normal_eqs_xla(*(jnp.asarray(a) for a in args), 0.5)
    np.testing.assert_array_equal(n1.numpy(), np.asarray(n2))
    assert n1.min() > 0
    for a, b in ((H1, H2), (g1, g2), (w1, w2)):
        assert _rel(a.numpy(), b) < 1e-5


def test_unpack_sums_gives_views_of_the_one_output_buffer():
    """The kernel writes (B, 44): H row-major, g, n_in, wrr. The wrapper returns views."""
    args = _t(*_icp_inputs(74, 3, 200, 300, 20))
    d2, idx = t_nn.nearest_batch_plain(args[0], args[2], args[4])
    H, g, n_in, wrr = t_icp_step.normal_eqs_from_matches(*args[:4], d2, idx, 0.5)
    out = torch.cat([H.reshape(3, 36), g, n_in[:, None], wrr[:, None]], dim=1).contiguous()
    assert out.shape == (3, t_icp_step._OUT_WIDTH)
    H_u, g_u, n_u, w_u = t_icp_step.unpack_sums(out)
    assert H_u.shape == (3, 6, 6) and g_u.shape == (3, 6) and n_u.shape == (3,) and w_u.shape == (3,)
    assert torch.equal(H_u, H) and torch.equal(g_u, g) and torch.equal(n_u, n_in) and torch.equal(w_u, wrr)
    assert torch.equal(H_u, H_u.transpose(1, 2))
    base = out.untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == base for t in (H_u, g_u, n_u, w_u))


def test_empty_source_gives_zeros_on_the_plain_route():
    args = _t(*_icp_inputs(75, 2, 0, 50, 0))
    H, g, n_in, wrr = t_icp_step.normal_eqs_batch(*args, max_dist=0.5)
    assert H.shape == (2, 6, 6) and not H.any() and not g.any() and not n_in.any() and not wrr.any()


# The shapes the paths launch, ragged ones, and extremes.
PLAN_SHAPES = [
    (16, 4096, 8192), (16, 1024, 8192), (16, 8192, 8192), (8, 1024, 8192), (8, 4096, 8192),
    (3, 1000, 5003), (2, 700, 20), (1, 4096, 8192), (1, 1, 1), (1, 100, 100000), (64, 20000, 8192),
]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_plan_covers_the_refs_with_ranges_the_kernel_takes(shape):
    b, nq, nr = shape
    geo = t_nn.plan(b, nq, nr, sms=132)
    assert geo.tiles * t_nn.QUERIES_PER_BLOCK >= nq > (geo.tiles - 1) * t_nn.QUERIES_PER_BLOCK
    assert geo.range % t_nn.CHUNK == 0 and 0 < geo.range <= t_nn.MAX_RANGE
    assert geo.splits * geo.range >= nr > (geo.splits - 1) * geo.range
    # Nearly every SM gets a block (rounding the range up to whole chunks may
    # save a split) unless the ranges are already as short as they may be.
    assert b * geo.tiles * geo.splits >= 0.9 * 132 or geo.range <= t_nn.MIN_RANGE


def test_plan_splits_finer_where_query_tiles_are_few():
    """Many tiles: the longest ranges. Few tiles: shorter ranges, so that the
    blocks reach (nearly) every SM without any SM getting two."""
    assert t_nn.plan(16, 8192, 8192, sms=132).range == t_nn.MAX_RANGE
    assert t_nn.plan(16, 1024, 8192, sms=132) == t_nn.Plan(tiles=2, splits=4, range=2048)
    assert t_nn.plan(8, 1024, 8192, sms=132) == t_nn.Plan(tiles=2, splits=8, range=1024)
    assert t_nn.plan(1, 4096, 8192, sms=132) == t_nn.Plan(tiles=8, splits=16, range=512)


def test_scratch_and_counters_are_cached_and_grow():
    dev = torch.device("cpu")
    build._scratch.pop(dev, None)
    build._counters.pop(dev, None)
    small = build.scratch(dev, 10)
    assert small.dtype == torch.float32 and small.numel() >= 10
    assert build.scratch(dev, 5) is small
    big = build.scratch(dev, 1000)
    assert big.numel() >= 1000 and build.scratch(dev, 10) is big
    tickets = build.counters(dev, 7)
    assert tickets.dtype == torch.int32 and tickets.numel() >= 7 and not tickets.any()
    assert build.counters(dev, 3) is tickets
    assert not build.counters(dev, 100).any()
    geo = t_nn.Plan(tiles=2, splits=3, range=64)
    floats, ints = t_nn.search_scratch(dev, 4, geo, extra_floats=11, extra_counters=4)
    assert floats.numel() >= 2 * 4 * 3 * 2 * t_nn.QUERIES_PER_BLOCK + 11 and ints.numel() >= 4 * 2 + 4


def test_cpu_route_counts_no_launch_by_shape():
    q, r, m = _t(*_cloud_pair(69, 1, 10, 20, 0))
    before = (build.launches["nearest_batch"], dict(build.launches_by_shape["nearest_batch"]),
              build.launches["normal_eqs_batch"], dict(build.launches_by_shape["normal_eqs_batch"]))
    t_nn.nearest_batch(q, r, m)
    t_icp_step.normal_eqs_batch(*_t(*_icp_inputs(76, 1, 10, 20, 0)), max_dist=0.5)
    assert before == (build.launches["nearest_batch"], build.launches_by_shape["nearest_batch"],
                      build.launches["normal_eqs_batch"], build.launches_by_shape["normal_eqs_batch"])


def test_nn_probe_measures_a_card_or_raises():
    """The probe of the scan's instruction rate has no CPU route."""
    with pytest.raises(RuntimeError, match="cuda"):
        nn_probe.main()
