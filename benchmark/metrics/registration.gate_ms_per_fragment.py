"""Host ms of the `registration.gate` span (the drift gate's posed boxes and admission, and content retrieval on
suspect paths) of one profiled registration stage, a fragment (the `fragments` counter of the
`registration.stage` root)."""

from benchmark.metrics import spans


def read(obs):
    return spans.ms_per("registration.gate", "registration.stage", "fragments")
