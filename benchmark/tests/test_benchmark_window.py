"""The window and the rate on a fake clock, and how the judge's numbers are summed up."""

import math

import pytest

from benchmark import harness


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _window(call_s, seconds, units=51):
    clock = Clock()

    def call():
        clock.t += call_s
        return units

    return harness.run_window(call, seconds, clock)


def test_the_call_in_flight_completes_and_counts():
    calls, units, window = _window(3.0, 10.0)
    assert (calls, units, window) == (4, 204, 12.0)
    assert harness.rate(units, window) == 17.0


def test_a_call_longer_than_the_window_is_the_window():
    assert _window(25.0, 10.0, units=64) == (1, 64, 25.0)


def test_the_window_ends_on_the_call_that_reaches_it():
    assert _window(2.5, 10.0) == (4, 204, 10.0)


def test_the_summary_keeps_the_worst_and_counts_failed_calls():
    limits = {"a": 1.0, "b": 0.5}
    verdicts = [{"a": 0.1, "b": 0.2}, {"a": 2.0, "b": 0.1}, {"a": 0.3, "b": math.inf}]
    attempted, failed, checks = harness.judge_summary(verdicts, limits)
    assert (attempted, failed) == (3, 2)
    assert checks == {"a": {"value": 2.0, "limit": 1.0}, "b": {"value": "inf", "limit": 0.5}}
    assert harness.judge_summary([{"a": math.nan, "b": 0.0}], limits)[1] == 1


@pytest.mark.parametrize("cell,rate", [("odometry.livingroom_full_640", "odometry_frames_per_s"),
                                       ("register.livingroom_full_640", "registration_pairs_per_s")])
def test_each_cell_reports_setup_its_rate_and_per_layer_metrics(cell, rate):
    man = harness.manifest()
    assert harness.end_to_end_names(man, cell) == [rate, "setup_s"]
    layer = harness.per_layer_metrics(man, cell)
    assert layer and all(m["moves"] == rate for m in layer)
