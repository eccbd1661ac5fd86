"""Device time (ms) per TPE step of the device loop: the union of the
device intervals in the traced chunks over the TPE graph replays the
loop counted there."""


def read(art):
    if not art.get("events") or not art.get("tpe_steps"):
        return None
    return 1e3 * art["busy_s"] / art["tpe_steps"]
