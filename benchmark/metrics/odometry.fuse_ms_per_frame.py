"""Host ms of the `odometry.fuse` spans (the TSDF fuse of every frame) of one profiled `run_fragments` call, a depth frame."""

from benchmark.metrics import spans


def read(obs):
    return spans.ms_per("odometry.fuse", "fragments", "frames")
