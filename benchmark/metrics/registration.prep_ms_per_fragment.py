"""Host ms of one ``prep_fragments_batch`` call, synchronised on both sides, a fragment."""


def read(obs):
    reg = obs.get("registration")
    if not reg or "prep_s" not in reg:
        return None
    return 1e3 * reg["prep_s"] / reg["fragments"]
