"""Host ms of the `registration.ransac` spans of one profiled registration pass, a registered pair."""

from benchmark.metrics import spans


def read(obs):
    return spans.ms_per("registration.ransac", "registration.batch", "pairs")
