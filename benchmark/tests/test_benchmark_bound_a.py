"""Bound A against the port's PERF.md kernel table at the bench shapes, and the roofline reader on fake readings."""

import pytest

from benchmark import harness
from benchmark.metrics import bound_a

# PERF.md's table of kernels: bound A in ms at the bench shapes, with 88% of a batch's refs valid.
TABLE = [((16, 4096, 8192), 0.0565), ((16, 8192, 8192), 0.1131), ((16, 1024, 8192), 0.0141),
         ((8, 4096, 8192), 0.0283), ((64, 8192, 8192), 0.4522)]


@pytest.mark.parametrize("shape,ms", TABLE)
def test_bound_a_matches_the_kernel_table(shape, ms):
    b, nq, nr = shape
    valid = round(0.88 * b * nr)
    got = bound_a.launch_bound_s(b, nq, nr, valid) * 1e3
    assert got == pytest.approx(ms, rel=0.01)
    ops_s = bound_a.OPS_PER_PAIR * nq * valid / bound_a.PEAK_F32_OPS
    assert got == pytest.approx(ops_s * 1e3)  # operations, not bytes, bound it


def test_the_roofline_reader():
    reader = harness.load_reader("kernels.nearest_batch.roofline_pct")
    launches = [(16, 4096, 8192, 30, 115000), (16, 8192, 8192, 1, 115000)]
    bound = bound_a.total_bound_s(launches)
    obs = {"nearest": {"launches": launches, "kernel_name": "nearest_kernel"},
           "device": {"device_s_by_name": {"nearest_kernel(float const*)": 2 * bound, "other": 1.0}}}
    assert reader.read(obs) == pytest.approx(50.0)
    assert reader.read({"nearest": {"launches": launches, "kernel_name": "nearest_kernel"},
                        "device": {"device_s_by_name": {}}}) is None
    assert reader.read({"device": {"device_s_by_name": {}}}) is None
