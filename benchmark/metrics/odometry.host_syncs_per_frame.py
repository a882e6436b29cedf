"""Host synchronisations a depth frame in one ``run_fragments`` call (sync debug mode's warnings / its frames)."""


def read(obs):
    odo = obs.get("odometry")
    if not odo or "host_syncs" not in odo:
        return None
    return odo["host_syncs"] / odo["frames"]
