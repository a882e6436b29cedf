"""Host ms of the `odometry.gn_level` spans (every Gauss-Newton level of each tracked frame) of one profiled `run_fragments` call, a depth frame."""

from benchmark.metrics import spans


def read(obs):
    return spans.ms_per("odometry.gn_level", "fragments", "frames")
