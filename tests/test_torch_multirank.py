"""PyTorch port: the multi-rank dry run on spawned gloo ranks on the CPU.

The counterpart of ``tests/test_multihost.py``: ``dist.dryrun.dryrun_multirank``
starts two ranks (``spawn_ranks``: spawned processes meeting at a ``file://``
store, one intra-op thread each) and runs one step of every distributed path
at ``__graft_entry__.py::dryrun_multichip``'s sizes: both pair-sharding
functions, the 4096-point production-shape batch, the edge-sharded pose
graph, the correspondence-sharded PCG, the ring, the x-sharded fuse and mesh.
A rank that fails or hangs fails the test within its timeout.
"""

import pytest

from elasticreconstruction_tpu_torch.dist import dryrun, mesh

TIMEOUT_S = 300.0


def test_two_rank_dryrun():
    results = dryrun.dryrun_multirank(2, "gloo", "cpu", timeout_s=TIMEOUT_S, threads=1)
    assert len(results) == 2 and results[0] == results[1]
    assert results[0]["production_success"] == [True, True]
    assert results[0]["ring_lanes"] == 2 * 2 * 2 * 2  # D ranks x 2 steps x 2 x 2 lanes
    assert results[0]["triangles"] > 0


def test_a_failing_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="ranks failed"):
        mesh.spawn_ranks(dryrun.dryrun_rank, 1, "gloo", "no-such-device", timeout_s=TIMEOUT_S, threads=1)
