"""Share of one profiled ``run_fragments`` call in which no device operation ran, in %."""


def read(obs):
    dev = obs.get("device")
    if "odometry" not in obs or not dev or dev["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
