"""Host ms of the `registration.icp` spans of one profiled registration pass, a registered pair (the step exit test's sync pays for work queued before it)."""

from benchmark.metrics import spans


def read(obs):
    return spans.ms_per("registration.icp", "registration.batch", "pairs")
