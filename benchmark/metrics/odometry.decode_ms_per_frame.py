"""Host ms of the `fragments.decode` spans (PNG decoding) of one profiled `run_fragments` call, a depth frame."""

from benchmark.metrics import spans


def read(obs):
    return spans.ms_per("fragments.decode", "fragments", "frames")
