"""``q_mass_diff``'s share (%) of its roofline over the traced search of a
batch cell, counted from the configuration: ``roofline.q_mass_share``."""


def read(art):
    if not art.get("events"):
        return None
    return art["roofline"].q_mass_share(art["events"], art["cfg"])
