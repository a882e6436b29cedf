"""Host ms of the `registration.normals` spans (both scales) of one profiled registration pass, a prepped fragment."""

from benchmark.metrics import spans


def read(obs):
    return spans.ms_per("registration.normals", "registration.prep", "fragments")
