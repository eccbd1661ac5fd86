"""``ei_diff``'s share (%) of its roofline over the traced search of a
batch cell, counted from the configuration: ``roofline.ei_diff_batch_share``."""


def read(art):
    if not art.get("events"):
        return None
    return art["roofline"].ei_diff_batch_share(art["events"], art["cfg"])
