"""Host synchronisations of one whole registration pass (sync debug mode's warnings) a pair."""


def read(obs):
    reg = obs.get("registration")
    if not reg or "host_syncs" not in reg:
        return None
    return reg["host_syncs"] / reg["pairs"]
