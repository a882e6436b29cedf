"""CUDA kernels a depth frame in one profiled ``run_fragments`` call (kernel events of the trace / its frames)."""


def read(obs):
    odo, dev = obs.get("odometry"), obs.get("device")
    if not odo or not dev or dev["kernels"] == 0:
        return None
    return dev["kernels"] / odo["frames"]
