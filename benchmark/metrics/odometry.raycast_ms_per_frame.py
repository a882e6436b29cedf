"""Host ms of the `odometry.raycast` spans (the model raycast of each tracked frame) of one profiled `run_fragments` call, a depth frame."""

from benchmark.metrics import spans


def read(obs):
    return spans.ms_per("odometry.raycast", "fragments", "frames")
