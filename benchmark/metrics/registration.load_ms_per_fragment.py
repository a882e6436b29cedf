"""Host ms of the `registration.load` span (the fragment clouds, bases and health read from their files) of one
profiled registration stage, a fragment (the `fragments` counter of the `registration.stage` root)."""

from benchmark.metrics import spans


def read(obs):
    return spans.ms_per("registration.load", "registration.stage", "fragments")
