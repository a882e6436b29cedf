"""Host ms of the `registration.fpfh` spans of one profiled registration pass, a prepped fragment."""

from benchmark.metrics import spans


def read(obs):
    return spans.ms_per("registration.fpfh", "registration.prep", "fragments")
