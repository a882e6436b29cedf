"""Host ms of the `registration.dispatch` span (the loop that queues every batch through the registrar; ICP's
exit test syncs each step) of one profiled registration stage, a pair sent through the registrar (the `pairs`
counter of the `registration.stage` root)."""

from benchmark.metrics import spans


def read(obs):
    return spans.ms_per("registration.dispatch", "registration.stage", "pairs")
