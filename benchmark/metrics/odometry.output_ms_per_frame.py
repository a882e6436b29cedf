"""Host ms of the `fragments.output` spans (the readback, health and file writes) of one profiled `run_fragments` call, a depth frame."""

from benchmark.metrics import spans


def read(obs):
    return spans.ms_per("fragments.output", "fragments", "frames")
