"""ICP steps (`_step_batch` calls of both phases, the `icp_steps` counter) of one profiled registration pass, a `registration.batch` span."""

from benchmark.metrics import spans


def read(obs):
    return spans.counter_per_span("icp_steps", "registration.batch")
