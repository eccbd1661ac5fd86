"""Share (%) of the traced window in which no operation ran on the
device: 1 - busy / window."""


def read(art):
    if not art.get("events") or not art.get("window_s"):
        return None
    return 100.0 * (1.0 - art["busy_s"] / art["window_s"])
