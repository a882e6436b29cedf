"""Device ms of the TSDF fuse kernel (``csrc/tsdf_fuse.cu``, one launch a frame) in one profiled
``run_fragments`` call, a depth frame: the trace's events whose name holds the kernel's symbol / its frames.
None where no such event ran (a program without the kernel)."""

SYMBOL = "tsdf_fuse_kernel"


def read(obs):
    odo, dev = obs.get("odometry"), obs.get("device")
    if not odo or not dev:
        return None
    device_s = sum(s for name, s in dev["device_s_by_name"].items() if SYMBOL in name)
    if device_s <= 0:
        return None
    return 1e3 * device_s / odo["frames"]
