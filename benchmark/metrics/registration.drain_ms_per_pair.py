"""Host ms of the `registration.drain` span (the stage's one readback of every batch's results, with what the
device still had queued, and their unpacking) of one profiled registration stage, a pair sent through the
registrar (the `pairs` counter of the `registration.stage` root)."""

from benchmark.metrics import spans


def read(obs):
    return spans.ms_per("registration.drain", "registration.stage", "pairs")
