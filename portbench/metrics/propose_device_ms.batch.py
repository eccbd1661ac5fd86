"""Device time (ms) per TPE generation: the union of the traced search's
device intervals over its TPE generations (the prior generation's draws
and the history folds, under a millisecond, count in it)."""


def read(art):
    if not art.get("events") or not art.get("tpe_steps"):
        return None
    return 1e3 * art["busy_s"] / art["tpe_steps"]
